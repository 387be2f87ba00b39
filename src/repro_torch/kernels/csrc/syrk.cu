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
#include "sgemm.cuh"

using namespace repro::sgemm;

namespace {

// Tile (bi, bj) of blockIdx.x over contraction slice blockIdx.y; c is the
// output (one slice) or the workspace (gridDim.y slices of m·m floats).
template <int BM, int MIN_BLOCKS>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
syrk_kernel(Operand a, float* c, int m, int k, int kchunk) {
  extern __shared__ __align__(16) float smem[];
  int bi, bj;
  tri_decode(blockIdx.x, bi, bj);
  const int row0 = bi * BM;
  const int col0 = bj * BM;
  const int k0 = blockIdx.y * kchunk;
  const int k1 = min(k, k0 + kchunk);
  float acc[BM / 16][BM / 16] = {};
  accumulate<BM, BM>(a, a, row0, col0, k0, k1, smem, acc);
  if (gridDim.y > 1) {   // the summing pass masks the upper triangle
    store<BM, BM>(acc, c + static_cast<long long>(blockIdx.y) * m * m, m, row0, col0, m, m);
    return;
  }
  if (bi == bj) mask_upper<BM, BM>(acc, row0, col0);
  store<BM, BM>(acc, c, m, row0, col0, m, m);
  if (bi != bj) {   // the mirror tile is strictly upper
#pragma unroll
    for (int i = 0; i < BM / 16; ++i)
#pragma unroll
      for (int j = 0; j < BM / 16; ++j) acc[i][j] = 0.f;
    store<BM, BM>(acc, c, m, col0, row0, m, m);
  }
}

template <int BM, int MIN_BLOCKS>
cudaError_t launch(const Operand& a, float* c, float* ws, int m, int k, int split, int kchunk,
                   cudaStream_t st) {
  const int mt = (m + BM - 1) / BM;
  const dim3 grid(mt * (mt + 1) / 2, split);
  const cudaError_t err = launch_tile<BM, BM>(syrk_kernel<BM, MIN_BLOCKS>, grid, 0, st, a,
                                              split > 1 ? ws : c, m, k, kchunk);
  if (err != cudaSuccess || split == 1) return err;
  return sum_slices_tril(ws, c, m, split, st);
}

}  // namespace

// c (m x m, row-major, contiguous) = tril(a · aᵀ), a (m x k) strided.
// config picks the tile in the order of kernels/gemm.py: TILES (0:
// 128x128, 2: 64x64; the rectangular 1 is refused); the contraction is
// cut into split slices of kchunk (a multiple of 16), which go to ws
// (split·m·m floats) and are summed into c when split > 1.
extern "C" int repro_syrk_f32(const float* a, long long sa0, long long sa1, float* c,
                              float* ws, int m, int k, int config, int split, int kchunk,
                              void* stream) {
  if (!valid_split(k, split, kchunk, ws)) return static_cast<int>(cudaErrorInvalidValue);
  const Operand A{a, sa0, sa1, m, copy_mode(a, sa0, sa1)};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (config) {
    case 0: err = launch<128, 1>(A, c, ws, m, k, split, kchunk, st); break;
    case 2: err = launch<64, 2>(A, c, ws, m, k, split, kchunk, st); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
