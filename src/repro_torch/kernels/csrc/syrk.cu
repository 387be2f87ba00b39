// C = tril(A·Aᵀ) in IEEE float32 on Hopper (sm_90a).
//
// Replaces: src/repro/kernels/syrk.py:syrk_pallas (_syrk_kernel), the TPU
// SYRK that runs only the mt(mt+1)/2 lower-triangular 128x128 blocks,
// indexed through scalar-prefetched np.tril_indices vectors.
//
// Bound on the H100 SXM: compute. SYRK does (m+1)·m·k flops (the paper's
// count) on 4(mk + m²) bytes; 1200x800 is 1.15 GFLOP, ~17 us at 67
// TFLOP/s FP32, against ~9.6 MB, ~3 us at 3.35 TB/s.
//
// Design: the grid is only the lower-triangular 64x64 tiles, T =
// mt(mt+1)/2 blocks for mt = ceil(m/64) — the half grid is the SYRK-vs-GEMM
// FLOP asymmetry the paper's anomalies hinge on. Each block decodes its
// tile (bi, bj), bj <= bi, from its linear index t = bi(bi+1)/2 + bj (no
// index table). It multiplies A's row panel bi by the transpose of row
// panel bj, read in place through A's strides (tile.cuh, TransposedB).
// The strictly-upper output is written by the kernel itself: a diagonal
// tile stores zeros above its diagonal, and an off-diagonal tile (bi, bj)
// also stores the zero tile at (bj, bi). So the output needs no separate
// zeroing pass, and those zero stores are part of the kernel's time.
#include "tile.cuh"

using namespace repro;

static_assert(BM == BN, "syrk tiles are square");

__global__ void __launch_bounds__(THREADS)
syrk_kernel(View a, float* c, int m, int k) {
  __shared__ Slabs sm;
  const int t = blockIdx.x;
  int bi = static_cast<int>((sqrtf(8.f * t + 1.f) - 1.f) * 0.5f);
  while (bi * (bi + 1) / 2 > t) --bi;            // float rounding, either way
  while ((bi + 1) * (bi + 2) / 2 <= t) ++bi;
  const int bj = t - bi * (bi + 1) / 2;
  const int row0 = bi * BM;
  const int col0 = bj * BN;

  float acc[TM][TN] = {};
  accumulate_tile(DenseA{a}, TransposedB{a}, row0, col0, 0, k, sm, acc);

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = row0 + tile_row(i);
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int col = col0 + tile_col(j);
      if (r < m && col < m) c[static_cast<long long>(r) * m + col] = r >= col ? acc[i][j] : 0.f;
      // The mirror position of an off-diagonal tile is strictly upper.
      const int mr = col0 + tile_row(i);
      const int mc = row0 + tile_col(j);
      if (bi != bj && mr < m && mc < m) c[static_cast<long long>(mr) * m + mc] = 0.f;
    }
  }
}

// c (m x m, row-major, contiguous) = tril(a · aᵀ), a (m x k) strided.
extern "C" int repro_syrk_f32(const float* a, long long sa0, long long sa1,
                              float* c, int m, int k, void* stream) {
  const int mt = cdiv(m, BM);
  const int tiles = mt * (mt + 1) / 2;
  syrk_kernel<<<tiles, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      View{a, sa0, sa1, m, k}, c, m, k);
  return static_cast<int>(cudaGetLastError());
}
