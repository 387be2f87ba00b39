// C = sym(S)·B in IEEE float32 on Hopper (sm_90a), S stored as its lower
// triangle.
//
// Replaces: src/repro/kernels/symm.py:symm_pallas (_symm_kernel), the TPU
// SYMM that fetches S block (max(i,l), min(i,l)), transposes it above the
// diagonal and symmetrises the diagonal block, never reading S's strict
// upper triangle.
//
// Bound on the H100 SXM: operations. SYMM does 2m²n flops on
// 4(m(m+1)/2 + 2mn) bytes; 1200x400 is 1.15 GFLOP, ~17 us at 67 TFLOP/s
// FP32, against ~6.7 MB, ~2 us at 3.35 TB/s.
//
// Design: the GEMM of sgemm.cuh (256-thread blocks, 8x8 / 8x4 / 4x4
// register tiles, a 3-slab cp.async ring) with the tile and a contraction
// split chosen per call (kernels/symm.py: symm_config). The symmetric
// operand's triangle is a matter of copy modes, not of a branch on each
// load: block rows [row0, row0 + BM) cut the contraction at the diagonal
// into three segments, accumulated one after the other by the routine
// into one accumulator, each with its own operand —
//   k < row0          reads S(i, k): S as stored (k-fastest 4-byte copies
//                     for a row-major S);
//   k >= row0 + BM    reads S(k, i): S transposed through its strides
//                     (16-byte copies for a row-major, aligned S);
//   the BM-wide band  straddles the diagonal and reads S(max(i,k),
//                     min(i,k)) with 4-byte copies (kSymLower).
// row0 and the split's slices are multiples of 16, so the segments fall
// on slab boundaries. Only the lower triangle is ever read, so whatever
// the upper triangle holds cannot leak into C. Split slices are summed in
// slice order by a second pass, so two calls are bitwise equal. Side R
// (B·S) runs this kernel on (S·Bᵀ)ᵀ through strides, with no copy. A batch
// shares z with the split, as in gemm.cu: one launch at any batch.
#include "sgemm.cuh"

using namespace repro::sgemm;

namespace {

// C[row0:, col0:] = sym(S)[row0:, k0:k1] · B[k0:k1, col0:] for the tile
// of block (x, y): the work of one block on one product. Segment seg (0
// below, 1 band, 2 above) of block rows [row0, row0 + BM) is [lo, hi) of
// the contraction; S is read through s with strides ss0, ss1, copied in
// below_mode / kSymLower / above_mode.
template <int BM, int BN>
__device__ __forceinline__ void symm_tile(const float* s, long long ss0, long long ss1,
                                          int below_mode, int above_mode, const Operand& b,
                                          float* c, int m, int n, int k0, int k1, float* smem) {
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  float acc[BM / 16][BN / 16] = {};
#pragma unroll 1
  for (int seg = 0; seg < 3; ++seg) {
    const int lo = max(k0, seg == 0 ? 0 : seg == 1 ? row0 : row0 + BM);
    const int hi = min(k1, seg == 0 ? row0 : seg == 1 ? row0 + BM : m);
    if (lo >= hi) continue;
    const Operand a{s, seg == 2 ? ss1 : ss0, seg == 2 ? ss0 : ss1, m,
                    seg == 0 ? below_mode : seg == 1 ? kSymLower : above_mode};
    if (seg == 1)   // the band: its own call site, its copier fixed at kSymLower
      accumulate<BM, BN, true>(a, b, row0, col0, lo, hi, smem, acc);
    else
      accumulate<BM, BN>(a, b, row0, col0, lo, hi, smem, acc);
  }
  store<BM, BN>(acc, c, n, row0, col0, m, n);
}

// Grid (n tiles, m tiles, z), z as in gemm.cu: the contraction slice of
// one product, or (BATCHED) the batch·split (instance, slice) pairs; ssb
// and sbb step S and B from one instance to the next.
template <int BM, int BN, int MIN_BLOCKS, bool BATCHED>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
symm_kernel(const float* s, long long ss0, long long ss1, int below_mode, int above_mode,
            Operand b, float* c, int m, int n, int kchunk, int split, long long ssb,
            long long sbb, long long batch) {
  extern __shared__ __align__(16) float smem[];
  if constexpr (!BATCHED) {
    const int k0 = blockIdx.z * kchunk;
    symm_tile<BM, BN>(s, ss0, ss1, below_mode, above_mode, b,
                      c + static_cast<long long>(blockIdx.z) * m * n, m, n, k0,
                      min(m, k0 + kchunk), smem);
  } else {
    for (long long u = blockIdx.z; u < batch * split; u += gridDim.z) {
      const long long inst = u / split;
      const int k0 = static_cast<int>(u - inst * split) * kchunk;
      Operand bi = b;
      bi.p += inst * sbb;
      symm_tile<BM, BN>(s + inst * ssb, ss0, ss1, below_mode, above_mode, bi, c + u * m * n, m,
                        n, k0, min(m, k0 + kchunk), smem);
    }
  }
}

template <int BM, int BN, int MIN_BLOCKS>
cudaError_t launch(const float* s, long long ssb, long long ss0, long long ss1, const Operand& b,
                   long long sbb, float* c, float* ws, long long batch, int m, int n, int split,
                   int kchunk, cudaStream_t st) {
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM, grid_yz(batch * split));
  const cudaError_t err = launch_tile<BM, BN>(
      batch > 1 ? symm_kernel<BM, BN, MIN_BLOCKS, true> : symm_kernel<BM, BN, MIN_BLOCKS, false>,
      grid, 0, st, s, ss0, ss1, copy_mode(s, ss0, ss1, ssb), copy_mode(s, ss1, ss0, ssb), b,
      split > 1 ? ws : c, m, n, kchunk, split, ssb, sbb, batch);
  if (err != cudaSuccess || split == 1) return err;
  return sum_slices(ws, c, static_cast<long long>(m) * n, split, batch, st);
}

}  // namespace

// c (batch x m x n, row-major, contiguous) = sym(s) · b per instance; s
// (batch x m x m) lower-stored and strided, b (batch x m x n) strided, ssb
// and sbb the strides from one instance to the next (batch 1 for one
// product). config, split and kchunk as for repro_gemm_f32 (the tile
// order of kernels/gemm.py: TILES): the contraction over m is cut into
// split slices of kchunk, which go to ws (batch·split·m·n floats) and are
// summed into c when split > 1.
extern "C" int repro_symm_f32(const float* s, long long ssb, long long ss0, long long ss1,
                              const float* b, long long sbb, long long sb0, long long sb1,
                              float* c, float* ws, long long batch, int m, int n, int config,
                              int split, int kchunk, void* stream) {
  if (!valid_split(m, split, kchunk, ws) || batch < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Operand B{b, sb1, sb0, n, copy_mode(b, sb1, sb0, sbb)};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (config) {
    case 0:
      err = launch<128, 128, 1>(s, ssb, ss0, ss1, B, sbb, c, ws, batch, m, n, split, kchunk, st);
      break;
    case 1:
      err = launch<128, 64, 2>(s, ssb, ss0, ss1, B, sbb, c, ws, batch, m, n, split, kchunk, st);
      break;
    case 2:
      err = launch<64, 64, 3>(s, ssb, ss0, ss1, B, sbb, c, ws, batch, m, n, split, kchunk, st);
      break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
