// C = A·B in IEEE float32 on Hopper (sm_90a).
//
// Replaces: src/repro/kernels/gemm.py:gemm_pallas (_gemm_kernel), the TPU
// GEMM with an f32 VMEM accumulator over a (M/bm, N/bn, K/bk) grid whose
// wrapper pads every operand to 128-multiples.
//
// Bound on the H100 SXM: operations. At the paper's sizes (dims 20..1200)
// a GEMM does 2mnk flops on 4(mk + kn + mn) bytes; 1200x400x1200 is 1.15
// GFLOP, 17.2 us at the 67 TFLOP/s FP32 (non-tensor-core) peak, against
// 9.6 MB, 2.9 us at 3.35 TB/s.
//
// Design (sgemm.cuh): 256-thread blocks on a 128x128, 128x64 or 64x64
// tile, 8x8 / 8x4 / 4x4 register tiles fed by conflict-free 16-byte
// shared-memory reads, and a 3-slab cp.async ring. At these sizes the
// time is set by how evenly the grid's blocks fall over the SMs, so the
// wrapper picks the tile and a split of the contraction per call
// (kernels/gemm.py: gemm_config) by a cost model fitted on the card: the
// busiest SM's multiply-adds at the tile's rate. Split slices write a
// workspace that a second pass sums in slice order, so the result does
// not depend on the order blocks finish (no atomics): two calls are
// bitwise equal. The contraction loop inside the block replaces the TPU's
// sequential k grid axis; ragged edges are masked in the copies and the
// stores, and both operands are read through their strides.
#include "sgemm.cuh"

using namespace repro::sgemm;

namespace {

template <int BM, int BN, int MIN_BLOCKS>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
gemm_kernel(Operand a, Operand b, float* c, int m, int n, int k, int kchunk) {
  extern __shared__ __align__(16) float smem[];
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  const int k0 = blockIdx.z * kchunk;
  const int k1 = min(k, k0 + kchunk);
  float acc[BM / 16][BN / 16] = {};
  accumulate<BM, BN>(a, b, row0, col0, k0, k1, smem, acc);
  store<BM, BN>(acc, c + static_cast<long long>(blockIdx.z) * m * n, n, row0, col0, m, n);
}

// c = sum over p of ws[p], in order p = 0, 1, ...
__global__ void __launch_bounds__(256) split_sum_kernel(const float* ws, float* c, long long mn,
                                                        int split) {
  for (long long i = blockIdx.x * 256ll + threadIdx.x; i < mn; i += gridDim.x * 256ll) {
    float s = ws[i];
    for (int p = 1; p < split; ++p) s += ws[p * mn + i];
    c[i] = s;
  }
}

template <int BM, int BN, int MIN_BLOCKS>
cudaError_t launch(const Operand& a, const Operand& b, float* c, float* ws, int m, int n, int k,
                   int split, int kchunk, cudaStream_t st) {
  constexpr int smem = Tile<BM, BN>::smem_bytes;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        gemm_kernel<BM, BN, MIN_BLOCKS>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM, split);
  gemm_kernel<BM, BN, MIN_BLOCKS><<<grid, THREADS, smem, st>>>(a, b, split > 1 ? ws : c, m, n,
                                                               k, kchunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || split == 1) return err;
  const long long mn = static_cast<long long>(m) * n;
  const long long want = (mn + 255) / 256;
  const int blocks = static_cast<int>(want < 132 * 16 ? want : 132 * 16);
  split_sum_kernel<<<blocks, 256, 0, st>>>(ws, c, mn, split);
  return cudaGetLastError();
}

}  // namespace

// c (m x n, row-major, contiguous) = a (m x k) · b (k x n), both strided.
// config picks the tile (0: 128x128, 1: 128x64, 2: 64x64, the order of
// kernels/gemm.py: TILES); the contraction is cut into split slices of
// kchunk (a multiple of 16), which go to ws (split·m·n floats) and are
// summed into c when split > 1.
extern "C" int repro_gemm_f32(const float* a, long long sa0, long long sa1,
                              const float* b, long long sb0, long long sb1,
                              float* c, float* ws, int m, int n, int k, int config, int split,
                              int kchunk, void* stream) {
  if (split < 1 || kchunk < BK || kchunk % BK != 0 ||
      static_cast<long long>(split - 1) * kchunk >= (k > 0 ? k : 1) ||
      (split > 1 && ws == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const Operand A{a, sa0, sa1, m, copy_mode(a, sa0, sa1)};
  const Operand B{b, sb1, sb0, n, copy_mode(b, sb1, sb0)};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (config) {
    case 0: err = launch<128, 128, 1>(A, B, c, ws, m, n, k, split, kchunk, st); break;
    case 1: err = launch<128, 64, 2>(A, B, c, ws, m, n, k, split, kchunk, st); break;
    case 2: err = launch<64, 64, 3>(A, B, c, ws, m, n, k, split, kchunk, st); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
