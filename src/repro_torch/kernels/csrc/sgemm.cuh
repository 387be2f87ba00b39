// IEEE float32 matrix-product routine for Hopper's CUDA cores: 256-thread
// blocks, a cp.async ring of shared-memory slabs, and a tile shape chosen
// at launch. Used by gemm.cu; built to be reused by the other float32
// matrix kernels (which still use tile.cuh).
//
// Block tile BM x BN (128x128, 128x64 or 64x64), 8 warps. The 256 threads
// form a 16 x 16 grid, thread (ty, tx) owning rows h·64 + ty·4 + {0..3}
// for h < BM/64 and columns likewise from tx: a thread tile of 8x8, 8x4
// or 4x4 held in registers. A warp covers a 4 x 8 patch of that grid
// (warp tile 32x64 at 128x128), so each 16-byte shared-memory read of a
// warp touches 4 distinct A addresses and 8 distinct B addresses, all in
// one 128-byte row: one wavefront, conflict-free and broadcast.
//
// The contraction walks 16-deep slabs through a ring of STAGES slabs of
// A (k-major: a[k][i]) and B (b[k][j]) in shared memory, filled with
// cp.async so that slabs t+1 and t+2 are in flight while slab t is
// multiplied. An operand whose output-side index (rows of A, columns of
// B) is contiguous, with 16-byte aligned rows, is copied 16 bytes at a
// time; any other (A row-major, transposed views, leading dims such as
// 333) 4 bytes at a time, neighbouring threads on neighbouring addresses.
// Ragged edges are zero-filled by the copies' src-size, so nothing is
// padded, and a transposed view is read in place.
//
// Arithmetic is fmaf with a float32 accumulator: the backend's dtype label
// is "float32", and TF32 tensor cores would be a different result.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace repro {
namespace sgemm {

constexpr int THREADS = 256;
constexpr int BK = 16;       // contraction slab depth
constexpr int STAGES = 3;    // slabs in the ring
constexpr int PAD = 4;       // floats; keeps slab rows 16-byte aligned

// How an operand's slab is copied.
enum CopyMode : int {
  kVec16 = 0,    // 16-byte copies along the output-side index
  kWFast = 1,    // 4-byte copies, output-side index fastest
  kKFast = 2,    // 4-byte copies, contraction index fastest
};

// Operand X(w, kk): w the output-side index (row of A, column of B), kk
// the contraction index; element at p + w·sw + kk·sk.
struct Operand {
  const float* p;
  long long sw, sk;
  int w_len;
  int mode;
};

// Copy mode of an operand, decided on the host.
inline int copy_mode(const float* p, long long sw, long long sk) {
  if (sw == 1 && sk % 4 == 0 && (reinterpret_cast<uintptr_t>(p) & 15u) == 0) return kVec16;
  return sw <= sk ? kWFast : kKFast;
}

template <int BM, int BN>
struct Tile {
  static constexpr int TM = BM / 16;   // rows per thread
  static constexpr int TN = BN / 16;   // columns per thread
  static constexpr int SA = BK * (BM + PAD);   // floats per A slab
  static constexpr int SB = BK * (BN + PAD);   // floats per B slab
  static constexpr int smem_bytes = STAGES * (SA + SB) * static_cast<int>(sizeof(float));
  static_assert(BM % 64 == 0 && BN % 64 == 0, "thread tiles are built of 64-wide halves");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One thread's share of the copies that fill an operand's BK x BW slabs,
// s[kk][w - w0] = X(w, kt0 + kk), zero outside w < w_len and kt0 + kk < k1.
// Copy q of a slab is element (w_first + q·w_step, kt0 + kk_first +
// q·kk_step); its addresses are set up once, so a slab costs one add.
template <int BW>
struct SlabCopier {
  static constexpr int VEC_COPIES = BK * BW / 4 / THREADS;   // 16-byte
  static constexpr int SCALAR_COPIES = BK * BW / THREADS;    // 4-byte
  const float* base;    // any valid address: the source of empty copies
  const float* src;     // element of copy 0 in the next slab (read only
                        // where in bounds)
  long long q_step;     // elements from copy q to copy q + 1
  long long slab_step;  // elements from one slab to the next
  int w_first, w_step, kk_first, kk_step, dst_first, dst_step, w_len, mode;

  __device__ __forceinline__ SlabCopier(const Operand& x, int w0, int k0) {
    const int tid = threadIdx.x;
    base = x.p;
    mode = x.mode;
    w_len = x.w_len;
    slab_step = BK * x.sk;
    if (mode == kVec16) {        // chunks of 4 along w, 16-byte rows
      constexpr int CH = BW / 4;
      w_first = w0 + (tid % CH) * 4;
      w_step = 0;
      kk_first = tid / CH;
      kk_step = THREADS / CH;
    } else if (mode == kWFast) {  // neighbouring threads along w
      w_first = w0 + tid % BW;
      w_step = 0;
      kk_first = tid / BW;
      kk_step = THREADS / BW;
    } else {                      // neighbouring threads along k
      w_first = w0 + tid / BK;
      w_step = THREADS / BK;
      kk_first = tid % BK;
      kk_step = 0;
    }
    src = x.p + static_cast<long long>(w_first) * x.sw +
          static_cast<long long>(k0 + kk_first) * x.sk;
    q_step = w_step * x.sw + kk_step * x.sk;
    dst_first = kk_first * (BW + PAD) + (w_first - w0);
    dst_step = kk_step * (BW + PAD) + w_step;
  }

  // Copy the slab that starts at contraction index kt0 into s, then step
  // to the next slab.
  __device__ __forceinline__ void copy(float* s, int kt0, int k1) {
    const uint32_t dst = smem_u32(s + dst_first);
    if (mode == kVec16) {
      const int n = min(4, max(0, w_len - w_first));
#pragma unroll
      for (int q = 0; q < VEC_COPIES; ++q) {
        const bool in = kt0 + kk_first + q * kk_step < k1 && n > 0;
        cp_async16(dst + q * dst_step * 4, in ? src + q * q_step : base, in ? n * 4 : 0);
      }
    } else {
#pragma unroll
      for (int q = 0; q < SCALAR_COPIES; ++q) {
        const bool in = w_first + q * w_step < w_len && kt0 + kk_first + q * kk_step < k1;
        cp_async4(dst + q * dst_step * 4, in ? src + q * q_step : base, in ? 4 : 0);
      }
    }
    src += slab_step;
  }
};

// This thread's position in the block's 16 x 16 thread grid.
__device__ __forceinline__ int thread_ty() {
  return (threadIdx.x >> 6) * 4 + ((threadIdx.x & 31) >> 3);
}
__device__ __forceinline__ int thread_tx() {
  return ((threadIdx.x >> 5) & 1) * 8 + (threadIdx.x & 7);
}

// acc += A[row0:row0+BM, k0:k1] · B[k0:k1, col0:col0+BN]. Entered and left
// by all threads of the block together; smem holds Tile::smem_bytes.
template <int BM, int BN>
__device__ __forceinline__ void accumulate(const Operand& A, const Operand& B, int row0,
                                           int col0, int k0, int k1, float* smem,
                                           float (&acc)[BM / 16][BN / 16]) {
  using T = Tile<BM, BN>;
  const int ty = thread_ty(), tx = thread_tx();
  const int nslab = k1 > k0 ? (k1 - k0 + BK - 1) / BK : 0;
  float* sa = smem;
  float* sb = smem + STAGES * T::SA;
  SlabCopier<BM> ca(A, row0, k0);
  SlabCopier<BN> cb(B, col0, k0);
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < nslab) {
      ca.copy(sa + st * T::SA, k0 + st * BK, k1);
      cb.copy(sb + st * T::SB, k0 + st * BK, k1);
    }
    cp_async_commit();
  }
  for (int t = 0; t < nslab; ++t) {
    cp_async_wait<STAGES - 2>();   // slab t has landed
    __syncthreads();               // ... for every thread; slab t-1 is free
    const int pre = t + STAGES - 1;
    if (pre < nslab) {
      ca.copy(sa + (pre % STAGES) * T::SA, k0 + pre * BK, k1);
      cb.copy(sb + (pre % STAGES) * T::SB, k0 + pre * BK, k1);
    }
    cp_async_commit();
    const float* a = sa + (t % STAGES) * T::SA;
    const float* b = sb + (t % STAGES) * T::SB;
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float av[T::TM], bv[T::TN];
#pragma unroll
      for (int hh = 0; hh < T::TM / 4; ++hh) {
        const float4 x = *reinterpret_cast<const float4*>(a + kk * (BM + PAD) + hh * 64 + ty * 4);
        av[hh * 4] = x.x; av[hh * 4 + 1] = x.y; av[hh * 4 + 2] = x.z; av[hh * 4 + 3] = x.w;
      }
#pragma unroll
      for (int hh = 0; hh < T::TN / 4; ++hh) {
        const float4 x = *reinterpret_cast<const float4*>(b + kk * (BN + PAD) + hh * 64 + tx * 4);
        bv[hh * 4] = x.x; bv[hh * 4 + 1] = x.y; bv[hh * 4 + 2] = x.z; bv[hh * 4 + 3] = x.w;
      }
#pragma unroll
      for (int i = 0; i < T::TM; ++i)
#pragma unroll
        for (int j = 0; j < T::TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();   // the ring may be reused by the caller
}

// Write a thread's tile into a row-major (ld) output, masked to m x n;
// 16-byte stores where the row is aligned and the 4 columns are inside.
template <int BM, int BN>
__device__ __forceinline__ void store(const float (&acc)[BM / 16][BN / 16], float* c,
                                      long long ld, int row0, int col0, int m, int n) {
  using T = Tile<BM, BN>;
  const int ty = thread_ty(), tx = thread_tx();
  const bool vec = ((reinterpret_cast<uintptr_t>(c) | static_cast<uintptr_t>(ld * 4)) & 15u) == 0;
#pragma unroll
  for (int i = 0; i < T::TM; ++i) {
    const int r = row0 + (i / 4) * 64 + ty * 4 + (i % 4);
    if (r >= m) continue;
    float* crow = c + r * ld;
#pragma unroll
    for (int hh = 0; hh < T::TN / 4; ++hh) {
      const int col = col0 + hh * 64 + tx * 4;
      if (vec && col + 3 < n) {
        *reinterpret_cast<float4*>(crow + col) =
            make_float4(acc[i][hh * 4], acc[i][hh * 4 + 1], acc[i][hh * 4 + 2], acc[i][hh * 4 + 3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (col + j < n) crow[col + j] = acc[i][hh * 4 + j];
      }
    }
  }
}

}  // namespace sgemm
}  // namespace repro
