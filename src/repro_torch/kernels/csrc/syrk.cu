// C = tril(A·Aᵀ) in IEEE float32 on Hopper (sm_90a).
//
// Replaces: src/repro/kernels/syrk.py:syrk_pallas (_syrk_kernel), the TPU
// SYRK that runs only the mt(mt+1)/2 lower-triangular 128x128 blocks,
// indexed through scalar-prefetched np.tril_indices vectors.
//
// Bound on the H100 SXM: operations. SYRK does (m+1)·m·k flops (the
// paper's count) on 4(mk + m²) bytes; 1200x800 is 1.15 GFLOP, ~17 us at
// 67 TFLOP/s FP32, against ~9.6 MB, ~3 us at 3.35 TB/s.
//
// Design: the GEMM routine of sgemm.cuh (256-thread blocks, 8x8 or 4x4
// register tiles, a 3-slab cp.async ring) on square 128x128 or 64x64
// tiles, launched over the T = mt(mt+1)/2 lower-triangular tiles only —
// the half grid is the SYRK-vs-GEMM FLOP asymmetry the paper's anomalies
// hinge on. Each block decodes its tile (bi, bj), bj <= bi, from its
// linear index (no index table). The B operand is A itself: B's
// output-side index (a column of C) is a row of A, so one Operand serves
// both sides and A is read in place through its strides.
//
// At these sizes the time is set by how evenly T blocks fall over the
// SMs, so the contraction may be cut into split slices (T·split blocks;
// kernels/syrk.py: syrk_config picks tile and split by the GEMM's cost
// model). The slices go to a workspace that a second pass sums in slice
// order, writing 0 above the diagonal without reading the workspace
// there: no atomics, two calls are bitwise equal, and the output needs no
// zeroing pass of its own. With one slice the blocks store into C
// directly: a diagonal tile stores 0 above its diagonal and an
// off-diagonal tile (bi, bj) also stores the zero tile at (bj, bi).
//
// A batch shares the y axis with the split: block y takes (instance,
// slice) pairs y, y + gridDim.y, ..., so a batch is one launch at any
// size, and one product (batch 1) is the launch it always was.
#include "sgemm.cuh"

using namespace repro::sgemm;

namespace {

// Tile (bi, bj) of blockIdx.x over the contraction slice [k0, k1) of one
// product. Its slice u of the workspace is c + u·m·m where split; else c
// (one product) or c + u·m·m (a batch, u the instance) is its output.
template <int BM, bool BATCHED>
__device__ __forceinline__ void syrk_tile(const Operand& a, float* c, int m, int k0, int k1,
                                          long long u, bool split, float* smem) {
  int bi, bj;
  tri_decode(blockIdx.x, bi, bj);
  const int row0 = bi * BM;
  const int col0 = bj * BM;
  float acc[BM / 16][BM / 16] = {};
  accumulate<BM, BM>(a, a, row0, col0, k0, k1, smem, acc);
  if (split) {   // the summing pass masks the upper triangle
    store<BM, BM>(acc, c + u * m * m, m, row0, col0, m, m);
    return;
  }
  float* const out = BATCHED ? c + u * m * m : c;
  if (bi == bj) mask_upper<BM, BM>(acc, row0, col0);
  store<BM, BM>(acc, out, m, row0, col0, m, m);
  if (bi != bj) {   // the mirror tile is strictly upper
#pragma unroll
    for (int i = 0; i < BM / 16; ++i)
#pragma unroll
      for (int j = 0; j < BM / 16; ++j) acc[i][j] = 0.f;
    store<BM, BM>(acc, out, m, col0, row0, m, m);
  }
}

// Grid (T tiles, y). One product (BATCHED false): y is the contraction
// slice, and c the output (one slice) or the workspace (gridDim.y slices
// of m·m floats). A batch: y walks the batch·split (instance, slice)
// pairs u = instance·split + slice, then u + gridDim.y, ... past the
// grid's y; sab steps A from one instance to the next, and c holds batch
// results (one slice) or batch·split slices.
template <int BM, int MIN_BLOCKS, bool BATCHED>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
syrk_kernel(Operand a, float* c, int m, int k, int kchunk, int split, long long sab,
            long long batch) {
  extern __shared__ __align__(16) float smem[];
  if constexpr (!BATCHED) {
    const int k0 = blockIdx.y * kchunk;
    syrk_tile<BM, false>(a, c, m, k0, min(k, k0 + kchunk), blockIdx.y, gridDim.y > 1, smem);
  } else {
    for (long long u = blockIdx.y; u < batch * split; u += gridDim.y) {
      const long long inst = u / split;
      const int k0 = static_cast<int>(u - inst * split) * kchunk;
      Operand ai = a;
      ai.p += inst * sab;
      syrk_tile<BM, true>(ai, c, m, k0, min(k, k0 + kchunk), u, split > 1, smem);
    }
  }
}

template <int BM, int MIN_BLOCKS>
cudaError_t launch(const Operand& a, long long sab, float* c, float* ws, long long batch, int m,
                   int k, int split, int kchunk, cudaStream_t st) {
  const int mt = (m + BM - 1) / BM;
  const dim3 grid(mt * (mt + 1) / 2, grid_yz(batch * split));
  const cudaError_t err = launch_tile<BM, BM>(
      batch > 1 ? syrk_kernel<BM, MIN_BLOCKS, true> : syrk_kernel<BM, MIN_BLOCKS, false>, grid,
      0, st, a, split > 1 ? ws : c, m, k, kchunk, split, sab, batch);
  if (err != cudaSuccess || split == 1) return err;
  return sum_slices_tril(ws, c, m, split, batch, st);
}

}  // namespace

// c (batch x m x m, row-major, contiguous) = tril(a · aᵀ) per instance, a
// (batch x m x k) strided, sab the stride from one instance to the next
// (batch 1 for one product). config picks the tile in the order of
// kernels/gemm.py: TILES (0: 128x128, 2: 64x64; the rectangular 1 is
// refused); the contraction is cut into split slices of kchunk (a multiple
// of 16), which go to ws (batch·split·m·m floats) and are summed into c
// when split > 1.
extern "C" int repro_syrk_f32(const float* a, long long sab, long long sa0, long long sa1,
                              float* c, float* ws, long long batch, int m, int k, int config,
                              int split, int kchunk, void* stream) {
  if (!valid_split(k, split, kchunk, ws) || batch < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Operand A{a, sa0, sa1, m, copy_mode(a, sa0, sa1, sab)};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (config) {
    case 0: err = launch<128, 1>(A, sab, c, ws, batch, m, k, split, kchunk, st); break;
    case 2: err = launch<64, 2>(A, sab, c, ws, batch, m, k, split, kchunk, st); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
