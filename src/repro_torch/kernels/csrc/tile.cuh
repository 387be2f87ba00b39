// Shared building block of the port's float32 matrix kernels.
//
// One thread block of 64 threads owns a 64x64 output tile; each thread
// owns an 8x8 sub-tile held in registers (rows ty*4+{0..3} and
// 32+ty*4+{0..3}, columns likewise from tx), so per step of the
// contraction a thread reads 8 A values and 8 B values from shared
// memory (four 16-byte loads, conflict-free) for 64 fused multiply-adds.
// The contraction walks 16-deep slabs: while the block multiplies slab
// s out of shared memory, each thread already holds slab s+1 in
// registers (loaded from device memory before the multiply), so the
// load latency overlaps the arithmetic.
//
// Arithmetic is IEEE float32 on the CUDA cores (fmaf), with a float32
// accumulator: the backend's dtype label is "float32", and TF32 tensor
// cores would be a different result under that label.
//
// Operands are read through small fetcher structs with
//   float at(int row, int col)  -- element with the ragged edge masked
//                                  to zero, so no operand is padded;
//   bool  k_fastest / n_fastest -- whether the contraction index (for
//                                  A) or the column index (for B) has the
//                                  smaller stride in the current slab,
//                                  so neighbouring threads load
//                                  neighbouring addresses.
// Every operand carries a row and a column stride, so a transposed view
// is read in place, without a copy.
#pragma once

#include <cuda_runtime.h>

namespace repro {

constexpr int BM = 64;                           // tile rows
constexpr int BN = 64;                           // tile columns
constexpr int BK = 16;                           // contraction slab depth
constexpr int TM = 8;                            // rows per thread
constexpr int TN = 8;                            // columns per thread
constexpr int THREADS = (BM / TM) * (BN / TN);   // 64
constexpr int PAD = 4;                           // keeps rows 16-byte aligned
constexpr int A_LOADS = BM * BK / THREADS;       // 16 per thread per slab
constexpr int B_LOADS = BK * BN / THREADS;       // 16 per thread per slab

static_assert(THREADS == BM && THREADS == BN,
              "slab load mappings assume one thread per tile row/column");

inline int cdiv(int a, int b) { return (a + b - 1) / b; }

struct __align__(16) Slabs {
  float a[BK][BM + PAD];   // A slab, contraction-major: a[k][i]
  float b[BK][BN + PAD];   // B slab: b[k][j]
};

// A strided, bounds-masked matrix view in device memory.
struct View {
  const float* p;
  long long s0, s1;   // row and column strides, in elements
  int rows, cols;
  __device__ __forceinline__ float at(int r, int c) const {
    return (r < rows && c < cols) ? __ldg(p + r * s0 + c * s1) : 0.f;
  }
};

// A as stored: A(i, k).
struct DenseA {
  View v;
  __device__ __forceinline__ float at(int i, int k) const { return v.at(i, k); }
  __device__ __forceinline__ bool k_fastest(int, int) const { return v.s1 <= v.s0; }
};

// B as stored: B(k, j).
struct DenseB {
  View v;
  __device__ __forceinline__ float at(int k, int j) const { return v.at(k, j); }
  __device__ __forceinline__ bool n_fastest(int, int) const { return v.s1 <= v.s0; }
};

// B = Vᵀ read from V in place: B(k, j) = V(j, k).
struct TransposedB {
  View v;
  __device__ __forceinline__ float at(int k, int j) const { return v.at(j, k); }
  __device__ __forceinline__ bool n_fastest(int, int) const { return v.s0 <= v.s1; }
};

// Row and column (within the tile) of a thread's register (i, j).
__device__ __forceinline__ int tile_row(int i) {
  return (i < 4 ? 0 : BM / 2) + (threadIdx.x / (BN / TN)) * 4 + (i & 3);
}
__device__ __forceinline__ int tile_col(int j) {
  return (j < 4 ? 0 : BN / 2) + (threadIdx.x % (BN / TN)) * 4 + (j & 3);
}

// acc += A[row0:row0+BM, k0:k1] · B[k0:k1, col0:col0+BN].
// Entered and left by all threads of the block together.
template <class FA, class FB>
__device__ __forceinline__ void accumulate_tile(
    const FA& fa, const FB& fb, int row0, int col0, int k0, int k1,
    Slabs& sm, float (&acc)[TM][TN]) {
  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);
  float ra[A_LOADS], rb[B_LOADS];
  if (k0 >= k1) return;

  // Slab element q of this thread: with k fastest, 16 neighbouring
  // threads share a row and walk k; otherwise thread tid owns row tid.
  bool akf = fa.k_fastest(row0, k0);
  bool bnf = fb.n_fastest(k0, col0);
  auto a_ik = [&](int q, bool kf, int& i, int& k) {
    if (kf) { k = tid % BK; i = tid / BK + q * (THREADS / BK); }
    else    { i = tid;      k = q; }
  };
  auto b_kj = [&](int q, bool nf, int& k, int& j) {
    if (nf) { j = tid;      k = q; }
    else    { k = tid % BK; j = tid / BK + q * (THREADS / BK); }
  };
  auto load = [&](int kt) {
#pragma unroll
    for (int q = 0; q < A_LOADS; ++q) {
      int i, k;
      a_ik(q, akf, i, k);
      ra[q] = (kt + k < k1) ? fa.at(row0 + i, kt + k) : 0.f;
    }
#pragma unroll
    for (int q = 0; q < B_LOADS; ++q) {
      int k, j;
      b_kj(q, bnf, k, j);
      rb[q] = (kt + k < k1) ? fb.at(kt + k, col0 + j) : 0.f;
    }
  };

  load(k0);
  for (int kt = k0; kt < k1; kt += BK) {
    __syncthreads();   // every thread is done reading the previous slab
#pragma unroll
    for (int q = 0; q < A_LOADS; ++q) {
      int i, k;
      a_ik(q, akf, i, k);
      sm.a[k][i] = ra[q];
    }
#pragma unroll
    for (int q = 0; q < B_LOADS; ++q) {
      int k, j;
      b_kj(q, bnf, k, j);
      sm.b[k][j] = rb[q];
    }
    __syncthreads();
    if (kt + BK < k1) {   // next slab's loads in flight during the multiply
      akf = fa.k_fastest(row0, kt + BK);
      bnf = fb.n_fastest(kt + BK, col0);
      load(kt + BK);
    }
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&sm.a[k][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&sm.a[k][BM / 2 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&sm.b[k][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&sm.b[k][BN / 2 + tx * 4]);
      const float av[TM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[TN] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
}

// Write a thread's sub-tile into a row-major (ld) output, masked to m x n.
__device__ __forceinline__ void store_tile(const float (&acc)[TM][TN], float* c,
                                           long long ld, int row0, int col0,
                                           int m, int n) {
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = row0 + tile_row(i);
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int col = col0 + tile_col(j);
      if (r < m && col < n) c[r * ld + col] = acc[i][j];
    }
  }
}

}  // namespace repro
