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
//
// A batch (the reference's vmap of gemm_pallas, one grid axis more) shares
// the z axis with the split: block z takes (instance, slice) pairs z,
// z + gridDim.z, ..., so a batch is one launch at any size, and a single
// product (batch 1) is the launch it always was.
#include "sgemm.cuh"

using namespace repro::sgemm;

namespace {

// c[row0:, col0:] = a[row0:, k0:k1] · b[k0:k1, col0:] for the tile of
// block (x, y): the work of one block on one product.
template <int BM, int BN>
__device__ __forceinline__ void gemm_tile(const Operand& a, const Operand& b, float* c, int m,
                                          int n, int k0, int k1, float* smem) {
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  float acc[BM / 16][BN / 16] = {};
  accumulate<BM, BN>(a, b, row0, col0, k0, k1, smem, acc);
  store<BM, BN>(acc, c, n, row0, col0, m, n);
}

// Grid (n tiles, m tiles, z). One product (BATCHED false): z is the
// contraction slice, and c the output (one slice) or the workspace
// (gridDim.z slices of m·n floats). A batch: z walks the batch·split
// (instance, slice) pairs u = instance·split + slice, then u + gridDim.z,
// ... past the grid's z; sab and sbb step a and b from one instance to
// the next, and c holds batch results (one slice) or batch·split slices.
template <int BM, int BN, int MIN_BLOCKS, bool BATCHED>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
gemm_kernel(Operand a, Operand b, float* c, int m, int n, int k, int kchunk, int split,
            long long sab, long long sbb, long long batch) {
  extern __shared__ __align__(16) float smem[];
  if constexpr (!BATCHED) {
    const int k0 = blockIdx.z * kchunk;
    gemm_tile<BM, BN>(a, b, c + static_cast<long long>(blockIdx.z) * m * n, m, n, k0,
                      min(k, k0 + kchunk), smem);
  } else {
    for (long long u = blockIdx.z; u < batch * split; u += gridDim.z) {
      const long long inst = u / split;
      const int k0 = static_cast<int>(u - inst * split) * kchunk;
      Operand ai = a, bi = b;
      ai.p += inst * sab;
      bi.p += inst * sbb;
      gemm_tile<BM, BN>(ai, bi, c + u * m * n, m, n, k0, min(k, k0 + kchunk), smem);
    }
  }
}

template <int BM, int BN, int MIN_BLOCKS>
cudaError_t launch(const Operand& a, long long sab, const Operand& b, long long sbb, float* c,
                   float* ws, long long batch, int m, int n, int k, int split, int kchunk,
                   cudaStream_t st) {
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM, grid_yz(batch * split));
  const cudaError_t err = launch_tile<BM, BN>(
      batch > 1 ? gemm_kernel<BM, BN, MIN_BLOCKS, true> : gemm_kernel<BM, BN, MIN_BLOCKS, false>,
      grid, 0, st, a, b, split > 1 ? ws : c, m, n, k, kchunk, split, sab, sbb, batch);
  if (err != cudaSuccess || split == 1) return err;
  return sum_slices(ws, c, static_cast<long long>(m) * n, split, batch, st);
}

}  // namespace

// c (batch x m x n, row-major, contiguous) = a (batch x m x k) · b (batch
// x k x n), both strided, sab and sbb the strides from one instance to the
// next (batch 1 for one product). config picks the tile (0: 128x128,
// 1: 128x64, 2: 64x64, the order of kernels/gemm.py: TILES); the
// contraction is cut into split slices of kchunk (a multiple of 16), which
// go to ws (batch·split·m·n floats) and are summed into c when split > 1.
extern "C" int repro_gemm_f32(const float* a, long long sab, long long sa0, long long sa1,
                              const float* b, long long sbb, long long sb0, long long sb1,
                              float* c, float* ws, long long batch, int m, int n, int k,
                              int config, int split, int kchunk, void* stream) {
  if (!valid_split(k, split, kchunk, ws) || batch < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Operand A{a, sa0, sa1, m, copy_mode(a, sa0, sa1, sab)};
  const Operand B{b, sb1, sb0, n, copy_mode(b, sb1, sb0, sbb)};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (config) {
    case 0: err = launch<128, 128, 1>(A, sab, B, sbb, c, ws, batch, m, n, k, split, kchunk, st); break;
    case 1: err = launch<128, 64, 2>(A, sab, B, sbb, c, ws, batch, m, n, k, split, kchunk, st); break;
    case 2: err = launch<64, 64, 3>(A, sab, B, sbb, c, ws, batch, m, n, k, split, kchunk, st); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
