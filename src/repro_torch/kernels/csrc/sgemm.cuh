// IEEE float32 matrix-product routine for Hopper's CUDA cores: 256-thread
// blocks, a cp.async ring of shared-memory slabs, and a tile shape chosen
// at launch. Used by gemm.cu, syrk.cu, symm.cu, chain_gemm.cu and
// gemm_syrk.cu.
//
// Block tile BM x BN (128x128, 128x64 or 64x64), 8 warps. The 256 threads
// form a 16 x 16 grid, thread (ty, tx) owning rows h·64 + ty·4 + {0..3}
// for h < BM/64 and columns likewise from tx: a thread tile of 8x8, 8x4
// or 4x4 held in registers. A warp covers a 4 x 8 patch of that grid
// (warp tile 32x64 at 128x128), so each 16-byte shared-memory read of a
// warp touches 4 distinct A addresses and 8 distinct B addresses, all in
// one 128-byte row: one wavefront, conflict-free and broadcast. A narrow
// tile (BN 16 or 32: gemm_syrk's M1 pieces) gives thread column tx the
// BN/16 adjacent columns tx·BN/16 + j.
//
// The contraction walks 16-deep slabs through a ring of STAGES slabs of
// A (k-major: a[k][i]) and B (b[k][j]) in shared memory, filled with
// cp.async so that slabs t+1 and t+2 are in flight while slab t is
// multiplied. An operand whose output-side index (rows of A, columns of
// B) is contiguous, with 16-byte aligned rows, is copied 16 bytes at a
// time; any other (A row-major, transposed views, leading dims such as
// 333) 4 bytes at a time, neighbouring threads on neighbouring addresses.
// A symmetric operand stored as its lower triangle has a copy mode of its
// own (kSymLower), so a kernel reads the triangle without a branch in the
// multiply. Ragged edges are zero-filled by the copies' src-size, so
// nothing is padded, and a transposed view is read in place.
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
  kSymLower = 3, // 4-byte copies of S(max(w, kk), min(w, kk)), w fastest:
                 // a symmetric S stored as its lower triangle, sw and sk
                 // its row and column strides (SlabCopier<BW, true>)
};

// Operand X(w, kk): w the output-side index (row of A, column of B), kk
// the contraction index; element at p + w·sw + kk·sk.
struct Operand {
  const float* p;
  long long sw, sk;
  int w_len;
  int mode;
};

// Copy mode of an operand, decided on the host. sb is the stride from
// one instance of a batch to the next (0 for one instance): every
// instance's rows must be 16-byte aligned for the 16-byte copies.
inline int copy_mode(const float* p, long long sw, long long sk, long long sb = 0) {
  if (sw == 1 && sk % 4 == 0 && sb % 4 == 0 && (reinterpret_cast<uintptr_t>(p) & 15u) == 0)
    return kVec16;
  return sw <= sk ? kWFast : kKFast;
}

// The largest grid dimension y or z (x goes to 2^31 - 1): a batch axis
// longer than this is walked by a loop inside the kernel.
constexpr long long MAX_GRID_YZ = 65535;

inline unsigned grid_yz(long long n) {
  return static_cast<unsigned>(n < MAX_GRID_YZ ? n : MAX_GRID_YZ);
}

// Each matrix kernel keeps its work on one product in a device function
// and comes in two instances, by a template flag BATCHED: false for one
// product (batch 1), which runs that function once on the kernel's own
// parameters; true for a batch, whose units (instances, or (instance,
// slice) pairs) a block takes from its grid index u, then u + gridDim,
// ... past the grid's extent, each on operands stepped to its instance.

template <int BM, int BN>
struct Tile {
  static constexpr int TM = BM / 16;   // rows per thread
  static constexpr int TN = BN / 16;   // columns per thread
  static constexpr int SA = BK * (BM + PAD);   // floats per A slab
  static constexpr int SB = BK * (BN + PAD);   // floats per B slab
  static constexpr int smem_bytes = STAGES * (SA + SB) * static_cast<int>(sizeof(float));
  static_assert(BM % 64 == 0 && (BN % 64 == 0 || BN == 16 || BN == 32),
                "thread tiles are built of 64-wide halves, or are 16 or 32 wide");
};

// Column, within a BN-wide tile, of accumulator column j of thread column
// tx: four adjacent columns in each 64-wide half, or BN/16 adjacent
// columns in a narrow tile.
template <int BN>
__device__ __forceinline__ int tile_col(int tx, int j) {
  return BN >= 64 ? (j / 4) * 64 + tx * 4 + (j % 4) : tx * (BN / 16) + j;
}

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
// SlabCopier<BW, true> copies in mode kSymLower, whatever the operand's
// mode, computing each address from (w, kk): the band of a symmetric
// operand that straddles the diagonal, a few slabs of a product. (Fixed at
// compile time: with a run-time test in the copier of every segment, symm
// ran 7.9 % slower summed over the launches its rule picks at the sweep's
// shapes; ab_bench.py --symm-variant, PERF.md section 6.)
template <int BW, bool SYM = false>
struct SlabCopier {
  static constexpr int VEC_COPIES = BK * BW / 4 / THREADS;   // 16-byte
  static constexpr int SCALAR_COPIES = BK * BW / THREADS;    // 4-byte
  const float* base;    // any valid address: the source of empty copies
  const float* src;     // element of copy 0 in the next slab (read only
                        // where in bounds)
  long long q_step;     // elements from copy q to copy q + 1
  long long slab_step;  // elements from one slab to the next
  long long sw, sk;     // strides (SYM only)
  int w_base;           // first output-side index of the slab (SYM only)
  int w_first, w_step, kk_first, kk_step, dst_first, dst_step, w_len, mode;

  __device__ __forceinline__ SlabCopier(const Operand& x, int w0, int k0) {
    const int tid = threadIdx.x;
    w_base = w0;
    base = x.p;
    // A narrow slab row is too short for every thread to hold a 16-byte
    // chunk: copy it 4 bytes at a time.
    mode = BW < 64 && x.mode == kVec16 ? kWFast : x.mode;
    w_len = x.w_len;
    slab_step = BK * x.sk;
    sw = x.sw;
    sk = x.sk;
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
    if (SYM) {   // neighbouring threads along w
      const int tid = threadIdx.x;
      const uint32_t s0 = smem_u32(s);
#pragma unroll
      for (int q = 0; q < SCALAR_COPIES; ++q) {
        const int dw = tid % BW, dk = tid / BW + q * (THREADS / BW);
        const int w = w_base + dw, kk = kt0 + dk;
        const bool in = w < w_len && kk < k1;
        const float* p = base + static_cast<long long>(max(w, kk)) * sw +
                         static_cast<long long>(min(w, kk)) * sk;
        cp_async4(s0 + (dk * (BW + PAD) + dw) * 4, in ? p : base, in ? 4 : 0);
      }
      return;
    }
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

// acc += a · b for one slab in shared memory: a[kk][i] (rows BM + PAD
// apart), b[kk][j] (BN + PAD apart), kk < BK.
template <int BM, int BN>
__device__ __forceinline__ void slab_fma(const float* a, const float* b, int ty, int tx,
                                         float (&acc)[BM / 16][BN / 16]) {
  using T = Tile<BM, BN>;
#pragma unroll
  for (int kk = 0; kk < BK; ++kk) {
    float av[T::TM], bv[T::TN];
#pragma unroll
    for (int hh = 0; hh < T::TM / 4; ++hh) {
      const float4 x = *reinterpret_cast<const float4*>(a + kk * (BM + PAD) + hh * 64 + ty * 4);
      av[hh * 4] = x.x; av[hh * 4 + 1] = x.y; av[hh * 4 + 2] = x.z; av[hh * 4 + 3] = x.w;
    }
    if constexpr (T::TN >= 4) {
#pragma unroll
      for (int hh = 0; hh < T::TN / 4; ++hh) {
        const float4 x = *reinterpret_cast<const float4*>(b + kk * (BN + PAD) + hh * 64 + tx * 4);
        bv[hh * 4] = x.x; bv[hh * 4 + 1] = x.y; bv[hh * 4 + 2] = x.z; bv[hh * 4 + 3] = x.w;
      }
    } else if constexpr (T::TN == 2) {
      const float2 x = *reinterpret_cast<const float2*>(b + kk * (BN + PAD) + tx * 2);
      bv[0] = x.x; bv[1] = x.y;
    } else {
      bv[0] = b[kk * (BN + PAD) + tx];
    }
#pragma unroll
    for (int i = 0; i < T::TM; ++i)
#pragma unroll
      for (int j = 0; j < T::TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// acc += A[row0:row0+BM, k0:k1] · B[k0:k1, col0:col0+BN]. Entered and left
// by all threads of the block together; smem holds Tile::smem_bytes. SYM_A:
// A is copied in mode kSymLower.
template <int BM, int BN, bool SYM_A = false>
__device__ __forceinline__ void accumulate(const Operand& A, const Operand& B, int row0,
                                           int col0, int k0, int k1, float* smem,
                                           float (&acc)[BM / 16][BN / 16]) {
  using T = Tile<BM, BN>;
  const int ty = thread_ty(), tx = thread_tx();
  const int nslab = k1 > k0 ? (k1 - k0 + BK - 1) / BK : 0;
  float* sa = smem;
  float* sb = smem + STAGES * T::SA;
  SlabCopier<BM, SYM_A> ca(A, row0, k0);
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
    slab_fma<BM, BN>(sa + (t % STAGES) * T::SA, sb + (t % STAGES) * T::SB, ty, tx, acc);
  }
  cp_async_wait<0>();
  __syncthreads();   // the ring may be reused by the caller
}

// Write a thread's tile into a row-major (ld) output, masked to m x n;
// 16-byte stores where the row is aligned and the 4 columns are inside.
// ADD: add it with float32 atomics instead (red.global.add, 16 bytes at
// a time where the row is aligned), in an order that varies from run to
// run.
template <int BM, int BN, bool ADD = false>
__device__ __forceinline__ void store(const float (&acc)[BM / 16][BN / 16], float* c,
                                      long long ld, int row0, int col0, int m, int n) {
  using T = Tile<BM, BN>;
  static_assert(BN % 64 == 0, "store writes tiles built of 64-wide halves");
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
      if (ADD && vec && col + 3 < n) {
        atomicAdd(reinterpret_cast<float4*>(crow + col),
                  make_float4(acc[i][hh * 4], acc[i][hh * 4 + 1], acc[i][hh * 4 + 2], acc[i][hh * 4 + 3]));
      } else if (ADD) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (col + j < n) atomicAdd(crow + col + j, acc[i][hh * 4 + j]);
      } else if (vec && col + 3 < n) {
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

// Zero a thread's accumulator entries that lie above the output's
// diagonal (column > row): the tile at (row0, col0) of a lower-triangular
// result.
template <int BM, int BN>
__device__ __forceinline__ void mask_upper(float (&acc)[BM / 16][BN / 16], int row0, int col0) {
  using T = Tile<BM, BN>;
  const int ty = thread_ty(), tx = thread_tx();
#pragma unroll
  for (int i = 0; i < T::TM; ++i) {
    const int r = row0 + (i / 4) * 64 + ty * 4 + (i % 4);
#pragma unroll
    for (int j = 0; j < T::TN; ++j)
      if (col0 + tile_col<BN>(tx, j) > r) acc[i][j] = 0.f;
  }
}

// (i, j), j <= i, of lower-triangular tile t in row-major order, t =
// i(i+1)/2 + j: no index table.
__device__ __forceinline__ void tri_decode(int t, int& i, int& j) {
  int r = static_cast<int>((sqrtf(8.f * t + 1.f) - 1.f) * 0.5f);
  while (r * (r + 1) / 2 > t) --r;   // float rounding, either way
  while ((r + 1) * (r + 2) / 2 <= t) ++r;
  i = r;
  j = t - r * (r + 1) / 2;
}

// c = sum over p of ws[p] (split slices of mn floats), in order p = 0, 1,
// ...: the result does not depend on the order blocks finished in.
template <int NT>
__device__ __forceinline__ void split_sum(const float* ws, float* c, long long mn, int split) {
  for (long long i = blockIdx.x * static_cast<long long>(NT) + threadIdx.x; i < mn;
       i += gridDim.x * static_cast<long long>(NT)) {
    float s = ws[i];
    for (int p = 1; p < split; ++p) s += ws[p * mn + i];
    c[i] = s;
  }
}

// The same for a lower-triangular m x m c: rows over blocks, columns over
// threads; an entry above the diagonal is written 0 without reading the
// slices there.
template <int NT>
__device__ __forceinline__ void tril_sum(const float* ws, float* c, int m, int split) {
  const long long mn = static_cast<long long>(m) * m;
  for (int r = blockIdx.x; r < m; r += gridDim.x) {
    for (int col = threadIdx.x; col < m; col += NT) {
      const long long i = static_cast<long long>(r) * m + col;
      float s = 0.f;
      if (col <= r) {
        s = ws[i];
        for (int p = 1; p < split; ++p) s += ws[p * mn + i];
      }
      c[i] = s;
    }
  }
}

// The summing passes of one product (BATCHED false) or of a batch, its
// instances over y: c[b] from ws[b]'s split slices, ws holding batch·split
// slices and c batch results. (Templates, so that every source including
// this header may launch them.)
template <int NT, bool BATCHED>
__global__ void __launch_bounds__(NT) split_sum_kernel(const float* ws, float* c, long long mn,
                                                       int split, long long batch) {
  if constexpr (!BATCHED) {
    split_sum<NT>(ws, c, mn, split);
  } else {
    for (long long b = blockIdx.y; b < batch; b += gridDim.y)
      split_sum<NT>(ws + b * split * mn, c + b * mn, mn, split);
  }
}

template <int NT, bool BATCHED>
__global__ void __launch_bounds__(NT) tril_sum_kernel(const float* ws, float* c, int m, int split,
                                                      long long batch) {
  if constexpr (!BATCHED) {
    tril_sum<NT>(ws, c, m, split);
  } else {
    const long long mn = static_cast<long long>(m) * m;
    for (long long b = blockIdx.y; b < batch; b += gridDim.y)
      tril_sum<NT>(ws + b * split * mn, c + b * mn, m, split);
  }
}

// Blocks along x of a summing pass over `want` units per instance, the
// batch's instances along y: at most 16 blocks an SM in all (at least
// one an instance row).
inline int sum_blocks_x(long long want, long long batch) {
  const long long budget = 132 * 16;
  const long long per = (budget + grid_yz(batch) - 1) / grid_yz(batch);
  return static_cast<int>(want < per ? want : per);
}

// c = the sums of split slices of ws per instance, on st.
inline cudaError_t sum_slices(const float* ws, float* c, long long mn, int split, long long batch,
                              cudaStream_t st) {
  const dim3 grid(sum_blocks_x((mn + 255) / 256, batch), grid_yz(batch));
  const auto kernel = batch > 1 ? split_sum_kernel<256, true> : split_sum_kernel<256, false>;
  kernel<<<grid, 256, 0, st>>>(ws, c, mn, split, batch);
  return cudaGetLastError();
}

// c = tril(the sums of split slices of ws) per instance, c m x m, on st.
inline cudaError_t sum_slices_tril(const float* ws, float* c, int m, int split, long long batch,
                                   cudaStream_t st) {
  const dim3 grid(sum_blocks_x(m, batch), grid_yz(batch));
  const auto kernel = batch > 1 ? tril_sum_kernel<256, true> : tril_sum_kernel<256, false>;
  kernel<<<grid, 256, 0, st>>>(ws, c, m, split, batch);
  return cudaGetLastError();
}

// Launch a kernel of Tile<BM, BN>'s dynamic shared memory plus extra
// bytes, raising the kernel's limit above 48 KB where it needs it.
template <int BM, int BN, class... P, class... A>
cudaError_t launch_tile(void (*kernel)(P...), dim3 grid, int extra, cudaStream_t st,
                        A... args) {
  const int smem = Tile<BM, BN>::smem_bytes + extra;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, THREADS, smem, st>>>(args...);
  return cudaGetLastError();
}

// Whether a contraction of k cut into split slices of kchunk is a valid
// launch: kchunk a positive multiple of BK, no slice empty, a workspace
// where split > 1.
inline bool valid_split(int k, int split, int kchunk, const float* ws) {
  return split >= 1 && kchunk >= BK && kchunk % BK == 0 &&
         static_cast<long long>(split - 1) * kchunk < (k > 0 ? k : 1) &&
         (split == 1 || ws != nullptr);
}

}  // namespace sgemm
}  // namespace repro
