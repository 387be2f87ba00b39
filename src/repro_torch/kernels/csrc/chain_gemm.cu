// OUT = (A·B)·C in IEEE float32 on Hopper (sm_90a), without writing the
// intermediate M1 = A·B to device memory.
//
// Replaces: src/repro/kernels/chain_gemm.py:chain_gemm_pallas
// (_chain_kernel), the TPU kernel that builds a bm x L f32 M1 row panel
// in VMEM once per row block (at j == 0) and reuses it across the
// sequential j axis, falling back to two GEMMs above 32 MiB of VMEM.
//
// Bound on the H100 SXM: compute. The chain does 2mkl + 2mln flops on
// 4(mk + kl + ln + mn) bytes; 1200·800·1200·400 is 3.46 GFLOP, ~52 us at
// 67 TFLOP/s FP32, against ~15 MB, ~5 us at 3.35 TB/s.
//
// Design: an L-split. On Hopper blocks run in parallel and in no order,
// so nothing persists across a j axis, and a bm x L panel of M1 does not
// fit a block's 227 KB of shared memory at the paper's sizes (64 x 1200
// f32 is 307 KB). Instead block (l-chunk p, row block i) computes its own
// 64x64 piece M1[i, p] = A[i, :]·B[:, p] once, parks it in shared memory
// (17 KB), and multiplies it by C[p, :], walking the output row panel in
// 64-wide tiles. Every piece of M1 is computed exactly once, so the fusion
// costs no extra flops and M1 never leaves the SM; shared memory per block
// is fixed, so no size bound and no fallback remain. The price is the
// reduction over l-chunks: each output element receives ceil(L/64)
// partial sums, added with float32 atomics into an output the launcher
// zeroes first (cudaMemsetAsync, inside this entry point and so inside
// the kernel's time). The atomics make the summation order vary from run
// to run, at float32 rounding level.
#include "tile.cuh"

using namespace repro;

// The block's M1 piece, read from shared memory as the A operand.
struct ShmemA {
  const float (*m1)[BN + PAD];
  int row0, l0;
  __device__ __forceinline__ float at(int i, int l) const { return m1[i - row0][l - l0]; }
  __device__ __forceinline__ bool k_fastest(int, int) const { return true; }
};

__global__ void __launch_bounds__(THREADS)
chain_gemm_kernel(View a, View b, View cm, float* out, int m, int k, int l,
                  int n) {
  __shared__ Slabs sm;
  __shared__ __align__(16) float m1[BM][BN + PAD];
  const int row0 = blockIdx.y * BM;
  const int l0 = blockIdx.x * BN;
  const int l1 = min(l0 + BN, l);

  float acc[TM][TN] = {};
  accumulate_tile(DenseA{a}, DenseB{b}, row0, l0, 0, k, sm, acc);
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) m1[tile_row(i)][tile_col(j)] = acc[i][j];
  __syncthreads();   // M1 piece complete before any thread reads it

  const ShmemA piece{m1, row0, l0};
  for (int col0 = 0; col0 < n; col0 += BN) {
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
    accumulate_tile(piece, DenseB{cm}, row0, col0, l0, l1, sm, acc);
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int r = row0 + tile_row(i);
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int col = col0 + tile_col(j);
        if (r < m && col < n) atomicAdd(out + static_cast<long long>(r) * n + col, acc[i][j]);
      }
    }
  }
}

// out (m x n, row-major, contiguous) = (a (m x k) · b (k x l)) · c (l x n),
// all inputs strided.
extern "C" int repro_chain_gemm_f32(const float* a, long long sa0, long long sa1,
                                    const float* b, long long sb0, long long sb1,
                                    const float* c, long long sc0, long long sc1,
                                    float* out, int m, int k, int l, int n,
                                    void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(out, 0, sizeof(float) * static_cast<size_t>(m) * n, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (l == 0) return static_cast<int>(cudaGetLastError());
  const dim3 grid(cdiv(l, BN), cdiv(m, BM));
  chain_gemm_kernel<<<grid, THREADS, 0, st>>>(
      View{a, sa0, sa1, m, k}, View{b, sb0, sb1, k, l}, View{c, sc0, sc1, l, n},
      out, m, k, l, n);
  return static_cast<int>(cudaGetLastError());
}
