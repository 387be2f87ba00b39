// C = sym(S)·B in IEEE float32 on Hopper (sm_90a), S stored as its lower
// triangle.
//
// Replaces: src/repro/kernels/symm.py:symm_pallas (_symm_kernel), the TPU
// SYMM that fetches S block (max(i,l), min(i,l)), transposes it above the
// diagonal and symmetrises the diagonal block, never reading S's strict
// upper triangle.
//
// Bound on the H100 SXM: compute. SYMM does 2m²n flops on
// 4(m(m+1)/2 + 2mn) bytes; 1200x400 is 1.15 GFLOP, ~17 us at 67 TFLOP/s
// FP32, against ~6.7 MB, ~2 us at 3.35 TB/s.
//
// Design: the GEMM tile of tile.cuh with the symmetric operand read
// through SymLowerA: element (i, k) is S(i, k) when i >= k and S(k, i)
// otherwise, so only the lower triangle is ever loaded and whatever the
// upper triangle holds cannot leak into C. The slab-load mapping follows
// whichever of the two reads dominates the slab (below the diagonal the
// contraction index walks S's columns, above it S's rows), so the loads
// stay coalesced on both sides. Side R (B·S) runs this kernel on
// (S·Bᵀ)ᵀ through strides, with no copy.
#include "tile.cuh"

using namespace repro;

// sym(S)(i, k) from the lower triangle of S.
struct SymLowerA {
  View s;
  __device__ __forceinline__ float at(int i, int k) const {
    return i >= k ? s.at(i, k) : s.at(k, i);
  }
  __device__ __forceinline__ bool k_fastest(int row0, int k0) const {
    const bool below = k0 < row0 + BM / 2;   // most of the slab reads S(i, k)
    const long long sk = below ? s.s1 : s.s0;
    const long long si = below ? s.s0 : s.s1;
    return sk <= si;
  }
};

__global__ void __launch_bounds__(THREADS)
symm_kernel(View s, View b, float* c, int m, int n) {
  __shared__ Slabs sm;
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  float acc[TM][TN] = {};
  accumulate_tile(SymLowerA{s}, DenseB{b}, row0, col0, 0, m, sm, acc);
  store_tile(acc, c, n, row0, col0, m, n);
}

// c (m x n, row-major, contiguous) = sym(s) · b; s (m x m) lower-stored
// and strided, b (m x n) strided.
extern "C" int repro_symm_f32(const float* s, long long ss0, long long ss1,
                              const float* b, long long sb0, long long sb1,
                              float* c, int m, int n, void* stream) {
  const dim3 grid(cdiv(n, BN), cdiv(m, BM));
  symm_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      View{s, ss0, ss1, m, m}, View{b, sb0, sb1, m, n}, c, m, n);
  return static_cast<int>(cudaGetLastError());
}
