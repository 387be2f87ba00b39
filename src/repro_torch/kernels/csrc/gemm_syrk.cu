// OUT = tril((A·B)(A·B)ᵀ) in IEEE float32 on Hopper (sm_90a), without
// writing the intermediate M1 = A·B to device memory.
//
// Replaces: src/repro/kernels/chain_gemm.py:gemm_syrk_pallas
// (_gemm_syrk_kernel), the TPU kernel that runs SYRK's triangular grid of
// 128x128 output blocks and, in every program, rebuilds both bm x L f32
// M1 row panels it contracts in VMEM (about m/128 times the GEMM's flops
// in recompute), falling back to syrk(gemm(a, b)) above 32 MiB of VMEM.
//
// Bound on the H100 SXM: operations. The paper charges the pair 2mkl
// (gemm) + (m+1)ml (syrk) flops on 4(mk + kl + m²) bytes; 1200·400·800
// is 0.768 + 1.153 = 1.921 GFLOP, ~29 us at 67 TFLOP/s FP32, against
// 8.96 MB, ~2.7 us at 3.35 TB/s.
//
// Design: OUT = sum over l-chunks p of M1[:, p]·M1[:, p]ᵀ, one thread-block
// cluster of C <= 8 CTAs per chunk of BL columns (16, 32 or 64). A
// block's 227 KB cannot hold an m x BL panel of M1 at every m, but the
// cluster's shared memory can: CTA r builds the 64-row pieces M1[i, p] of
// the row tiles i = r, r + C, ... once, with sgemm.cuh's accumulate, and
// parks each k-major (piece[l][row], the layout of the ring's slabs) in
// its own shared memory. After a cluster barrier each CTA multiplies its
// share of the chunk's mt(mt+1)/2 tile pairs (i, j <= i): a contiguous
// range of the pairs in row-major order, so no CTA has more than
// ceil(pairs / C). It copies pieces i and j out of their owners' shared
// memory (distributed shared memory, map_shared_rank) into local staging
// pieces, 16 bytes a thread at a time, and runs slab_fma on them
// directly: piece i is already the A slabs a[l][row] and piece j the B
// slabs b[l][col], so nothing streams through the ring from device
// memory. Piece i changes only with the row of the pairs; piece j of the
// next pair is loaded into registers while the current pair multiplies,
// and stored into the other of two staging buffers, so one barrier a
// pair suffices and the remote reads' latency is hidden. Every element of M1 is computed exactly once and
// never leaves the cluster; the excess over the paper's count is only
// padding to whole 64-row tiles and BL-wide pieces, and the diagonal
// tiles' upper halves. A last cluster barrier keeps every CTA resident
// until its peers have read its pieces.
//
// The chunks' partial sums go into an output zeroed by cudaMemsetAsync
// inside this entry point (and so inside the kernel's time), with
// sgemm.cuh's 16-byte float32 atomics; a diagonal tile adds zeros above
// its diagonal, so the strict upper triangle stays 0. The atomics make
// the summation order over l-chunks vary from run to run, at float32
// rounding level. (BL, C) is chosen per call (kernels/gemm_syrk.py:
// gemm_syrk_config); the wrapper falls back to the gemm and syrk kernels
// where even the narrowest launch cannot hold the panel. A batch (the
// reference's vmap of gemm_syrk_pallas) takes the grid's y axis, free
// beside the (C, 1, 1) clusters: one launch at any batch, a single
// product (batch 1) the launch it always was.
#include <cooperative_groups.h>

#include "sgemm.cuh"

namespace cg = cooperative_groups;
using namespace repro::sgemm;

namespace {

constexpr int BM = 64;               // rows of a piece; side of an output tile
constexpr int PIECE_LD = BM + PAD;   // floats from one l-row of a piece to the next
constexpr int MAX_CLUSTER = 8;       // the portable cluster size
// Least dynamic shared memory of a CTA: more than half of an SM's 228 KB,
// so that no two CTAs share an SM. Two CTAs of one cluster on one SM ran
// no faster at the best launch, and made the time of a launch depend on
// how the card packed its clusters; one CTA an SM, a cluster size C holds
// a fixed number of resident clusters (cudaOccupancyMaxActiveClusters),
// which the launch rule models (kernels/gemm_syrk.py, PERF.md section 6).
constexpr size_t SPREAD_BYTES = 116 * 1024;

template <int BL>
__host__ __device__ constexpr int piece_floats() {
  return BL * PIECE_LD;
}

// Dynamic shared memory of a CTA: the piece build's ring, the pieces it
// owns (slots), and three staging pieces (one for row tile i, two for j);
// at least SPREAD_BYTES.
template <int BL>
size_t smem_bytes(int slots) {
  const size_t need = Tile<BM, BL>::smem_bytes +
                      static_cast<size_t>(slots + 3) * piece_floats<BL>() * sizeof(float);
  return need > SPREAD_BYTES ? need : SPREAD_BYTES;
}

// A thread's share of a piece's BL x BM values (not the padding): float4
// u is at offset piece_offset(u) of the piece, for u < PieceRegs<BL>::N.
template <int BL>
struct PieceRegs {
  static constexpr int N = BL * BM / 4 / THREADS;
  float4 v[N];
};
__device__ __forceinline__ int piece_offset(int u) {
  const int q = u * THREADS + threadIdx.x;
  return (q / (BM / 4)) * PIECE_LD + (q % (BM / 4)) * 4;
}

// Load piece i of the chunk (slot i / C of cluster rank i % C) into r.
template <int BL>
__device__ __forceinline__ void load_piece(cg::cluster_group& cluster, float* pieces, int i, int c,
                                           PieceRegs<BL>& r) {
  const float* src = cluster.map_shared_rank(pieces + (i / c) * piece_floats<BL>(), i % c);
#pragma unroll
  for (int u = 0; u < PieceRegs<BL>::N; ++u)
    r.v[u] = *reinterpret_cast<const float4*>(src + piece_offset(u));
}

template <int BL>
__device__ __forceinline__ void store_piece(const PieceRegs<BL>& r, float* dst) {
#pragma unroll
  for (int u = 0; u < PieceRegs<BL>::N; ++u)
    *reinterpret_cast<float4*>(dst + piece_offset(u)) = r.v[u];
}

// out += tril(M1[:, p]·M1[:, p]ᵀ) for l-chunk p = blockIdx.x / C of one
// product, C the cluster's size. Returns with every CTA of the cluster
// done building its pieces, but a peer may still read them.
template <int BL>
__device__ __forceinline__ void gemm_syrk_chunk(cg::cluster_group& cluster, const Operand& a,
                                                const Operand& b, float* out, int m, int k,
                                                int l, float* smem) {
  using T = Tile<BM, BL>;
  const int c = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int l0 = static_cast<int>(blockIdx.x) / c * BL;
  const int l1 = min(l, l0 + BL);
  const int mt = (m + BM - 1) / BM;
  const int slots = (mt + c - 1) / c;
  float* const pieces = smem + STAGES * (T::SA + T::SB);
  float* const sa = pieces + slots * piece_floats<BL>();   // piece i
  float* const sb = sa + piece_floats<BL>();                // piece j, two buffers
  const int ty = thread_ty(), tx = thread_tx();

  // Build this CTA's pieces. A thread's four rows h·64 + ty·4 + {0..3} of
  // piece column j are one 16-byte store.
  for (int i = rank; i < mt; i += c) {
    float acc[T::TM][T::TN] = {};
    accumulate<BM, BL>(a, b, i * BM, l0, 0, k, smem, acc);
    float* const piece = pieces + (i / c) * piece_floats<BL>();
#pragma unroll
    for (int j = 0; j < T::TN; ++j) {
      const int col = tile_col<BL>(tx, j);
#pragma unroll
      for (int h = 0; h < T::TM / 4; ++h)
        *reinterpret_cast<float4*>(piece + col * PIECE_LD + h * 64 + ty * 4) =
            make_float4(acc[h * 4][j], acc[h * 4 + 1][j], acc[h * 4 + 2][j], acc[h * 4 + 3][j]);
    }
  }
  cluster.sync();   // every piece of the chunk is complete and visible to the cluster

  // This CTA's pairs t0 <= t < t1 in row-major order t = i(i+1)/2 + j.
  const int pairs = mt * (mt + 1) / 2;
  const int t0 = static_cast<int>(static_cast<long long>(rank) * pairs / c);
  const int t1 = static_cast<int>(static_cast<long long>(rank + 1) * pairs / c);
  const int nl = (l1 - l0 + BK - 1) / BK;
  PieceRegs<BL> next;   // piece j of pair t, loaded during pair t - 1
  int i, j;
  if (t0 < t1) {
    tri_decode(t0, i, j);
    if (j != i) load_piece<BL>(cluster, pieces, j, c, next);
  }
  int held = -1;   // the row tile whose piece sa holds
  for (int t = t0; t < t1; ++t) {
    float* const buf = sb + (t & 1) * piece_floats<BL>();
    // buf was last read by pair t - 2, which every thread finished before
    // the barrier of pair t - 1.
    if (j != i) store_piece<BL>(next, buf);
    if (i != held) {
      PieceRegs<BL> row;
      load_piece<BL>(cluster, pieces, i, c, row);
      store_piece<BL>(row, sa);
      held = i;
    }
    __syncthreads();   // the staging pieces of pair t are complete
    const int ti = i, tj = j;
    if (t + 1 < t1) {   // in flight while pair t multiplies
      tri_decode(t + 1, i, j);
      if (j != i) load_piece<BL>(cluster, pieces, j, c, next);
    }
    const float* const pb = tj == ti ? sa : buf;
    float acc[BM / 16][BM / 16] = {};
    for (int s = 0; s < nl; ++s)
      slab_fma<BM, BM>(sa + s * BK * PIECE_LD, pb + s * BK * PIECE_LD, ty, tx, acc);
    if (ti == tj) mask_upper<BM, BM>(acc, ti * BM, tj * BM);
    store<BM, BM, true>(acc, out, m, ti * BM, tj * BM, m, m);
    if (t + 1 < t1 && i != ti) __syncthreads();   // done reading sa before it changes
  }
}

// One product (BATCHED false), or a batch: y walks the instances (the
// cluster is (C, 1, 1), so all its CTAs share y), then y + gridDim.y, ...
// past the grid's y; sab and sbb step A and B from one instance to the
// next, and out holds batch results of m·m floats.
template <int BL, bool BATCHED>
__global__ void __launch_bounds__(THREADS, 2)
gemm_syrk_kernel(Operand a, Operand b, float* out, int m, int k, int l, long long sab,
                 long long sbb, long long batch) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  if constexpr (!BATCHED) {
    gemm_syrk_chunk<BL>(cluster, a, b, out, m, k, l, smem);
  } else {
    for (long long inst = blockIdx.y; inst < batch; inst += gridDim.y) {
      Operand ai = a, bi = b;
      ai.p += inst * sab;
      bi.p += inst * sbb;
      gemm_syrk_chunk<BL>(cluster, ai, bi, out + inst * m * m, m, k, l, smem);
      // The next instance's pieces overwrite this one's only once every
      // peer is done reading them.
      if (inst + gridDim.y < batch) cluster.sync();
    }
  }
  cluster.sync();   // no CTA leaves while a peer may still read its pieces
}

// The launch of chunks·cluster CTAs in clusters of `cluster`.
template <int BL>
cudaLaunchConfig_t launch_config(int m, int l, int cluster, long long batch, cudaStream_t st,
                                 cudaLaunchAttribute* attr) {
  const int mt = (m + BM - 1) / BM;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(((l + BL - 1) / BL) * cluster, grid_yz(batch));
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem_bytes<BL>((mt + cluster - 1) / cluster);
  cfg.stream = st;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <int BL>
cudaError_t launch(const Operand& a, long long sab, const Operand& b, long long sbb, float* out,
                   long long batch, int m, int k, int l, int cluster, cudaStream_t st) {
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config<BL>(m, l, cluster, batch, st, &attr);
  const auto kernel =
      batch > 1 ? gemm_syrk_kernel<BL, true> : gemm_syrk_kernel<BL, false>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(cfg.dynamicSmemBytes));
  if (err != cudaSuccess) return err;
  err = cudaLaunchKernelEx(&cfg, kernel, a, b, out, m, k, l, sab, sbb, batch);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// A launch of one chunk, one cluster: what the occupancy query takes.
template <int BL>
cudaError_t max_clusters(int m, int cluster, int* count) {
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config<BL>(m, BL, cluster, 1, nullptr, &attr);
  const cudaError_t err = cudaFuncSetAttribute(gemm_syrk_kernel<BL, false>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(cfg.dynamicSmemBytes));
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveClusters(count, gemm_syrk_kernel<BL, false>, &cfg);
}

}  // namespace

// out (batch x m x m, row-major, contiguous) = tril((a (m x k) · b (k x
// l)) · (a · b)ᵀ) per instance, a and b strided, sab and sbb the strides
// from one instance to the next (batch 1 for one product), in l-chunks of
// bl (16, 32 or 64) columns, one cluster of `cluster` (1 to 8) CTAs per
// chunk and instance; out is zeroed here for the whole batch.
extern "C" int repro_gemm_syrk_f32(const float* a, long long sab, long long sa0, long long sa1,
                                   const float* b, long long sbb, long long sb0, long long sb1,
                                   float* out, long long batch, int m, int k, int l, int bl,
                                   int cluster, void* stream) {
  if (cluster < 1 || cluster > MAX_CLUSTER || batch < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      cudaMemsetAsync(out, 0, sizeof(float) * static_cast<size_t>(batch) * m * m, st);
  if (err != cudaSuccess || l == 0) return static_cast<int>(err);
  const Operand A{a, sa0, sa1, m, copy_mode(a, sa0, sa1, sab)};
  const Operand B{b, sb1, sb0, l, copy_mode(b, sb1, sb0, sbb)};
  switch (bl) {
    case 16: err = launch<16>(A, sab, B, sbb, out, batch, m, k, l, cluster, st); break;
    case 32: err = launch<32>(A, sab, B, sbb, out, batch, m, k, l, cluster, st); break;
    case 64: err = launch<64>(A, sab, B, sbb, out, batch, m, k, l, cluster, st); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// *count = cudaOccupancyMaxActiveClusters of the launches
// repro_gemm_syrk_f32 makes for (m, bl, cluster), whatever l.
extern "C" int repro_gemm_syrk_max_clusters(int m, int bl, int cluster, int* count) {
  if (cluster < 1 || cluster > MAX_CLUSTER) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  switch (bl) {
    case 16: err = max_clusters<16>(m, cluster, count); break;
    case 32: err = max_clusters<32>(m, cluster, count); break;
    case 64: err = max_clusters<64>(m, cluster, count); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
