// C = A·B in IEEE float32 on Hopper (sm_90a).
//
// Replaces: src/repro/kernels/gemm.py:gemm_pallas (_gemm_kernel), the TPU
// GEMM with an f32 VMEM accumulator over a (M/bm, N/bn, K/bk) grid whose
// wrapper pads every operand to 128-multiples.
//
// Bound on the H100 SXM: compute. At the paper's sizes (dims 20..1200) a
// GEMM does 2mnk flops on 4(mk + kn + mn) bytes; 1200x1200x800 is 2.30
// GFLOP, ~34 us at the 67 TFLOP/s FP32 (non-tensor-core) peak, against
// ~13 MB, ~4 us at 3.35 TB/s.
//
// Design: one 64-thread block per 64x64 output tile (tile.cuh): 8x8
// register sub-tiles fed by 16-byte shared-memory loads, so each FMA costs
// a quarter of a shared-memory load, and a register-prefetched slab
// pipeline that overlaps device-memory latency with the multiply. Small
// tiles keep the grid at hundreds of blocks at these sizes (361 at
// 1200x1200), so all 132 SMs get work. The contraction loop inside the
// block replaces the TPU's sequential k grid axis. Ragged edges are masked
// in the loads and stores, so nothing is padded or sliced, and both
// operands are read through their strides, so a transposed view costs no
// copy. Not yet used: wgmma/TMA (they would need a TF32/bf16 label).
#include "tile.cuh"

using namespace repro;

__global__ void __launch_bounds__(THREADS)
gemm_kernel(View a, View b, float* c, int m, int n, int k) {
  __shared__ Slabs sm;
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  float acc[TM][TN] = {};
  accumulate_tile(DenseA{a}, DenseB{b}, row0, col0, 0, k, sm, acc);
  store_tile(acc, c, n, row0, col0, m, n);
}

// c (m x n, row-major, contiguous) = a (m x k) · b (k x n), both strided.
extern "C" int repro_gemm_f32(const float* a, long long sa0, long long sa1,
                              const float* b, long long sb0, long long sb1,
                              float* c, int m, int n, int k, void* stream) {
  const dim3 grid(cdiv(n, BN), cdiv(m, BM));
  gemm_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      View{a, sa0, sa1, m, k}, View{b, sb0, sb1, k, n}, c, m, n, k);
  return static_cast<int>(cudaGetLastError());
}
