// OUT = (A·B)·C in IEEE float32 on Hopper (sm_90a), without writing the
// intermediate M1 = A·B to device memory.
//
// Replaces: src/repro/kernels/chain_gemm.py:chain_gemm_pallas
// (_chain_kernel), the TPU kernel that builds a bm x L f32 M1 row panel
// in VMEM once per row block (at j == 0) and reuses it across the
// sequential j axis, falling back to two GEMMs above 32 MiB of VMEM.
//
// Bound on the H100 SXM: operations. The chain does 2mkl + 2mln flops on
// 4(mk + kl + ln + mn) bytes; 1200·800·1200·400 is 3.46 GFLOP, ~52 us at
// 67 TFLOP/s FP32, against ~15 MB, ~5 us at 3.35 TB/s.
//
// Design: an L-split on the routine of sgemm.cuh (256-thread blocks,
// 8x8 / 8x4 / 4x4 register tiles, a 3-slab cp.async ring). On Hopper
// blocks run in parallel and in no order, so nothing persists across a j
// axis, and a bm x L panel of M1 does not fit a block's 227 KB of shared
// memory at the paper's sizes. Instead block (l-chunk p, row tile i)
// builds its own BM x BL piece M1[i, p] = A[i, :]·B[:, p] once with the
// routine's accumulate, parks it in shared memory k-major (m1t[l][i],
// the layout of the ring's A slabs), and multiplies it by C[p, :]: the
// second product reads its A slabs as 16-byte loads straight from the
// resident piece, and only C streams through the ring, one sequence of
// (n-tile, l-slab) pairs so that the ring never drains between output
// tiles. The second product reuses the first one's accumulator. Every
// piece of M1 is computed exactly once, so the fusion costs no extra
// flops and M1 never leaves the SM; shared memory per block is fixed
// (ring plus BL x (BM + 4) floats), so no size bound and no fallback
// remain. The tile (BM, BL) is chosen per call (kernels/chain_gemm.py:
// chain_config).
//
// The price is the reduction over the ceil(L / BL) l-chunks: each output
// element receives one partial sum from each. With one chunk the block
// stores its tile. Otherwise the launch zeroes the output
// (cudaMemsetAsync, inside this entry point and so inside the kernel's
// time) and the blocks add their partial sums with float32 atomics, 16
// bytes at a time, in an order that varies from run to run, so the chain
// is not bitwise deterministic. Each chunk's partials written to a
// workspace and summed in chunk order (ceil(L / BL)·m·n floats) was
// slower over the sweep's shapes (PERF.md, section 6).
//
// A batch (the reference's vmap of chain_gemm_pallas) takes the grid's z
// axis: one launch at any batch, a single chain (batch 1) the launch it
// always was.
#include "sgemm.cuh"

using namespace repro::sgemm;

namespace {

// Shared memory beyond the ring: the resident piece m1t[BL][BM + PAD].
template <int BM, int BL>
constexpr int piece_bytes() {
  return BL * (BM + PAD) * static_cast<int>(sizeof(float));
}

// out += (A·B)[row0:, l0:l1] · C[l0:l1, :] for l-chunk blockIdx.x and row
// tile blockIdx.y of one chain: atomically added (atomic) or stored (one
// l-chunk).
template <int BM, int BL>
__device__ __forceinline__ void chain_piece(const Operand& a, const Operand& b, const Operand& c,
                                            float* out, int m, int k, int l, int n, int atomic,
                                            float* smem) {
  using T = Tile<BM, BL>;
  float* const m1t = smem + STAGES * (T::SA + T::SB);
  float* const cs = smem + STAGES * T::SA;   // C slabs, in the ring's B part
  const int row0 = blockIdx.y * BM;
  const int l0 = blockIdx.x * BL;
  const int l1 = min(l, l0 + BL);
  const int ty = thread_ty(), tx = thread_tx();

  float acc[BM / 16][BL / 16] = {};
  accumulate<BM, BL>(a, b, row0, l0, 0, k, smem, acc);
  // Park the piece k-major: m1t[j][i] = M1[row0 + i, l0 + j]; a thread's
  // four rows h·64 + ty·4 + {0..3} of column j are one 16-byte store.
#pragma unroll
  for (int j = 0; j < T::TN; ++j) {
    const int col = (j / 4) * 64 + tx * 4 + (j % 4);
#pragma unroll
    for (int h = 0; h < T::TM / 4; ++h) {
      *reinterpret_cast<float4*>(m1t + col * (BM + PAD) + h * 64 + ty * 4) =
          make_float4(acc[h * 4][j], acc[h * 4 + 1][j], acc[h * 4 + 2][j], acc[h * 4 + 3][j]);
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[h * 4 + i][j] = 0.f;
    }
  }
  // The ring is free (accumulate's last barrier); the piece is complete at
  // the first barrier of the loop below, before any thread reads it.

  // (n-tile, l-slab) pairs u = tile·nl + t, with C's slabs copied
  // STAGES - 1 pairs ahead, across tile boundaries.
  const int nl = (l1 - l0 + BK - 1) / BK;
  const int total = nl * ((n + BL - 1) / BL);
  SlabCopier<BL> cc(c, 0, l0);
  int pt = 0, pcol = 0;   // slab and column of the next copy
  auto copy_next = [&](int slot) {
    cc.copy(cs + slot * T::SB, l0 + pt * BK, l1);
    if (++pt == nl) {
      pt = 0;
      pcol += BL;
      cc = SlabCopier<BL>(c, pcol, l0);
    }
  };
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < total) copy_next(st);
    cp_async_commit();
  }
  int t = 0, col0 = 0;
  for (int u = 0; u < total; ++u) {
    cp_async_wait<STAGES - 2>();   // pair u's slab has landed
    __syncthreads();               // ... for every thread; pair u-1's is free
    if (u + STAGES - 1 < total) copy_next((u + STAGES - 1) % STAGES);
    cp_async_commit();
    slab_fma<BM, BL>(m1t + t * BK * (BM + PAD), cs + (u % STAGES) * T::SB, ty, tx, acc);
    if (++t == nl) {   // output tile [row0, +BM) x [col0, +BL) complete
      if (atomic)
        store<BM, BL, true>(acc, out, n, row0, col0, m, n);
      else
        store<BM, BL>(acc, out, n, row0, col0, m, n);
#pragma unroll
      for (int i = 0; i < T::TM; ++i)
#pragma unroll
        for (int j = 0; j < T::TN; ++j) acc[i][j] = 0.f;
      t = 0;
      col0 += BL;
    }
  }
  cp_async_wait<0>();
}

// One chain (BATCHED false), or a batch: z walks the instances, then
// z + gridDim.z, ... past the grid's z; sab, sbb and scb step A, B and C
// from one instance to the next, and out holds batch results of m·n
// floats.
template <int BM, int BL, int MIN_BLOCKS, bool BATCHED>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
chain_kernel(Operand a, Operand b, Operand c, float* out, int m, int k, int l, int n,
             int atomic, long long sab, long long sbb, long long scb, long long batch) {
  extern __shared__ __align__(16) float smem[];
  if constexpr (!BATCHED) {
    chain_piece<BM, BL>(a, b, c, out, m, k, l, n, atomic, smem);
  } else {
    for (long long inst = blockIdx.z; inst < batch; inst += gridDim.z) {
      Operand ai = a, bi = b, ci = c;
      ai.p += inst * sab;
      bi.p += inst * sbb;
      ci.p += inst * scb;
      chain_piece<BM, BL>(ai, bi, ci, out + inst * m * n, m, k, l, n, atomic, smem);
      __syncthreads();   // the next instance refills the ring
    }
  }
}

template <int BM, int BL, int MIN_BLOCKS>
cudaError_t launch(const Operand& a, long long sab, const Operand& b, long long sbb,
                   const Operand& c, long long scb, float* out, long long batch, int m, int k,
                   int l, int n, cudaStream_t st) {
  const int chunks = (l + BL - 1) / BL;
  const bool atomic = chunks > 1;
  if (atomic) {
    const cudaError_t err =
        cudaMemsetAsync(out, 0, sizeof(float) * static_cast<size_t>(batch) * m * n, st);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(chunks, (m + BM - 1) / BM, grid_yz(batch));
  return launch_tile<BM, BL>(batch > 1 ? chain_kernel<BM, BL, MIN_BLOCKS, true>
                                       : chain_kernel<BM, BL, MIN_BLOCKS, false>,
                             grid, piece_bytes<BM, BL>(), st, a, b, c, out, m, k, l, n,
                             atomic ? 1 : 0, sab, sbb, scb, batch);
}

}  // namespace

// out (batch x m x n, row-major, contiguous) = (a (m x k) · b (k x l)) · c
// (l x n) per instance, all inputs strided, sab, sbb and scb the strides
// from one instance to the next (batch 1 for one chain). config picks the
// piece (BM, BL) (0: 128x128, 1: 128x64, 2: 64x64, the order of
// kernels/chain_gemm.py: TILES). With more than one l-chunk, the chunks'
// partial sums are added into out, zeroed here for the whole batch, with
// atomics.
extern "C" int repro_chain_gemm_f32(const float* a, long long sab, long long sa0, long long sa1,
                                    const float* b, long long sbb, long long sb0, long long sb1,
                                    const float* c, long long scb, long long sc0, long long sc1,
                                    float* out, long long batch, int m, int k, int l, int n,
                                    int config, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (batch < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (l == 0)
    return static_cast<int>(
        cudaMemsetAsync(out, 0, sizeof(float) * static_cast<size_t>(batch) * m * n, st));
  const Operand A{a, sa0, sa1, m, copy_mode(a, sa0, sa1, sab)};
  const Operand B{b, sb1, sb0, l, copy_mode(b, sb1, sb0, sbb)};
  const Operand C{c, sc1, sc0, n, copy_mode(c, sc1, sc0, scb)};
  cudaError_t err;
  switch (config) {
    case 0: err = launch<128, 128, 1>(A, sab, B, sbb, C, scb, out, batch, m, k, l, n, st); break;
    case 1: err = launch<128, 64, 2>(A, sab, B, sbb, C, scb, out, batch, m, k, l, n, st); break;
    case 2: err = launch<64, 64, 3>(A, sab, B, sbb, C, scb, out, batch, m, k, l, n, st); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
