// Forward attention with an online softmax on Hopper (sm_90a): the float32
// kernel on the CUDA cores, and the C entry point, which sends bfloat16 to
// the tensor-core kernel of flash_attention_tc.cu.
//
// Replaces: src/repro/kernels/flash_attention.py:flash_attention_pallas
// (_flash_kernel), the TPU kernel whose grid (b·h, q block, kv block) runs
// the kv blocks in order on one core and carries m, l and acc from one
// grid step to the next in VMEM scratch; GQA goes through the K/V index
// map, whole causal or out-of-window kv blocks are skipped, logits are
// soft-capped, masked with -1e30, and p is cast to v's dtype before P·V.
//
// Bound on the H100 SXM, float32: operations, 2·D·S(S+1)·B·H flops at the
// 67 TFLOP/s FP32 peak. Float32 stays on the CUDA cores: TF32 tensor cores
// would be a different result under the float32 label (as in sgemm.cuh).
//
// Design. Blocks run in parallel in no order, so the kv walk becomes a
// loop inside the block: one block of 256 threads owns one (b·h, 64-row
// query tile); it keeps its Q tile in shared memory and streams 64-row K
// and V tiles through shared memory, with m and l per row in registers
// and the 64 x D float32 accumulator spread over the threads' registers.
// A tile of keys that causal or window masking hides from every query of
// the block is never loaded, by the reference's predicate. Query tiles
// launch from the end of the sequence back, so under a causal mask the
// longest kv walks start first. K/V heads are never repeated in memory:
// query head h reads kv head h / (H / Hkv) of its batch. q, k, v are read
// through four element strides each and the output is written through
// four strides, so (B, S, H, D) views of the projections cost no copy.
// Rows and keys past S are masked here (loads zero-filled, keys set to
// -1e30), so S need not divide the tile and there is no fallback.
//
// CUDA-core float32 FMAs, scalar shared-memory loads (rows padded by one
// 32-bit word against bank conflicts). Shared memory per block is 2·64
// floats + (2·64·(D+1) + 64·D + 64·(64+1)) floats: 214 KB at D = 256,
// above the 48 KB default, so every launch opts in to its size first.
#include <cuda_runtime.h>

#include "flash_args.cuh"

namespace {

using repro_flash::Args;
using repro_flash::Strides;

constexpr int BQ = 64;
constexpr int BKV = 64;
constexpr int THREADS = 256;
constexpr float NEG_INF = -1e30f;

template <int D>
struct Layout {
  static constexpr int PAD = 1;          // one 32-bit word
  static constexpr int QLD = D + PAD;    // row stride of the Q and K tiles
  static constexpr int PLD = BKV + PAD;  // row stride of the P tile
  // Accumulator: thread (ax, ay) owns rows ay·RM .. ay·RM+RM-1 and columns
  // ax, ax+TX, ..., so a warp reads consecutive V columns.
  static constexpr int TX = D < 32 ? D : 32;
  static constexpr int TY = THREADS / TX;
  static constexpr int RM = BQ / TY;
  static constexpr int DC = D / TX;
  static constexpr size_t bytes =
      2 * BQ * sizeof(float) +
      sizeof(float) * (static_cast<size_t>(BQ) * QLD + static_cast<size_t>(BKV) * QLD +
                   static_cast<size_t>(BKV) * D + static_cast<size_t>(BQ) * PLD);
  static_assert(D % TX == 0 && BQ % TY == 0, "head_dim does not fit the thread layout");
};

// dst[r][c] = src[start + r][c] for the 64 rows of a tile, zero past seq.
template <int D, int LD>
__device__ __forceinline__ void load_tile(float* dst, const float* src, long long ss, long long sd,
                                          int start, int seq) {
  for (int i = threadIdx.x; i < 64 * D; i += THREADS) {
    const int r = i / D, c = i % D;
    const int pos = start + r;
    dst[r * LD + c] = pos < seq ? src[pos * ss + c * sd] : 0.f;
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS) flash_kernel(Args a) {
  using L = Layout<D>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* alpha_s = reinterpret_cast<float*>(smem);   // per-row rescale of this tile
  float* l_s = alpha_s + BQ;                         // per-row denominators at the end
  float* qs = reinterpret_cast<float*>(l_s + BQ);
  float* ks = qs + BQ * L::QLD;
  float* vs = ks + BKV * L::QLD;
  float* ps = vs + BKV * D;

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int q_start = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int b = bh / a.heads, h = bh % a.heads;
  const int hk = h / (a.heads / a.kv_heads);
  const float* q = static_cast<const float*>(a.q) + b * a.sq.b + h * a.sq.h;
  const float* k = static_cast<const float*>(a.k) + b * a.sk.b + hk * a.sk.h;
  const float* v = static_cast<const float*>(a.v) + b * a.sv.b + hk * a.sv.h;
  float* o = static_cast<float*>(a.o) + b * a.so.b + h * a.so.h;

  load_tile<D, L::QLD>(qs, q, a.sq.s, a.sq.d, q_start, a.seq);

  // Scores: thread (sx, sy) owns rows sy·4 .. sy·4+3 and columns sx + 16j;
  // the 16 threads of one row group are one half-warp.
  const int sx = tid % 16, sy = tid / 16;
  float m_run[4], l_run[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_run[i] = NEG_INF;
    l_run[i] = 0.f;
  }
  const int ax = tid % L::TX, ay = tid / L::TX;
  float acc[L::RM][L::DC];
#pragma unroll
  for (int i = 0; i < L::RM; ++i)
#pragma unroll
    for (int j = 0; j < L::DC; ++j) acc[i][j] = 0.f;

  const int n_kv = (a.seq + BKV - 1) / BKV;
  for (int kt = 0; kt < n_kv; ++kt) {
    const int k_start = kt * BKV;
    // Skip tiles no query of this block sees (uniform over the block).
    if (a.causal && k_start > q_start + BQ - 1) break;
    if (a.window > 0 && !(k_start + BKV > q_start - a.window + 1)) continue;
    __syncthreads();   // Q is in place; nobody still reads the last K, V, P
    load_tile<D, L::QLD>(ks, k, a.sk.s, a.sk.d, k_start, a.seq);
    load_tile<D, D>(vs, v, a.sv.s, a.sv.d, k_start, a.seq);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(sy * 4 + i) * L::QLD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = ks[(sx + 16 * j) * L::QLD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = sy * 4 + i;
      const int qpos = q_start + row;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k_start + sx + 16 * j;
        float x = s[i][j] * a.scale;
        if (a.softcap > 0.f) x = a.softcap * tanhf(x / a.softcap);
        bool visible = kpos < a.seq;
        if (a.causal) visible = visible && qpos >= kpos;
        if (a.window > 0) visible = visible && qpos - kpos < a.window;
        s[i][j] = visible ? x : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_run[i], mx);
      const float alpha = expf(m_run[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        ps[row * L::PLD + sx + 16 * j] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l_run[i] = l_run[i] * alpha + sum;
      m_run[i] = m_new;
      if (sx == 0) alpha_s[row] = alpha;
    }
    __syncthreads();   // P and alpha complete

#pragma unroll
    for (int i = 0; i < L::RM; ++i) {
      const float al = alpha_s[ay * L::RM + i];
#pragma unroll
      for (int j = 0; j < L::DC; ++j) acc[i][j] *= al;
    }
#pragma unroll 4
    for (int kk = 0; kk < BKV; ++kk) {
      float pv[L::RM], vv[L::DC];
#pragma unroll
      for (int i = 0; i < L::RM; ++i) pv[i] = ps[(ay * L::RM + i) * L::PLD + kk];
#pragma unroll
      for (int j = 0; j < L::DC; ++j) vv[j] = vs[kk * D + ax + L::TX * j];
#pragma unroll
      for (int i = 0; i < L::RM; ++i)
#pragma unroll
        for (int j = 0; j < L::DC; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

  if (sx == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) l_s[sy * 4 + i] = l_run[i];
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < L::RM; ++i) {
    const int row = ay * L::RM + i;
    const int qpos = q_start + row;
    if (qpos >= a.seq) continue;
    const float denom = fmaxf(l_s[row], 1e-30f);
#pragma unroll
    for (int j = 0; j < L::DC; ++j)
      o[qpos * a.so.s + (ax + L::TX * j) * a.so.d] = acc[i][j] / denom;
  }
}

template <int D>
cudaError_t launch(const Args& a, int batch, cudaStream_t st) {
  using L = Layout<D>;
  const int smem = static_cast<int>(L::bytes);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(batch * a.heads, (a.seq + BQ - 1) / BQ);
  flash_kernel<D><<<grid, THREADS, smem, st>>>(a);
  return cudaGetLastError();
}

cudaError_t dispatch_f32(int head_dim, const Args& a, int batch, cudaStream_t st) {
  switch (head_dim) {
    case 16: return launch<16>(a, batch, st);
    case 32: return launch<32>(a, batch, st);
    case 64: return launch<64>(a, batch, st);
    case 96: return launch<96>(a, batch, st);
    case 128: return launch<128>(a, batch, st);
    case 256: return launch<256>(a, batch, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// o (B, H, S, D) = softmax(mask(softcap(scale · q kᵀ))) v per head, with
// q (B, H, S, D), k and v (B, Hkv, S, D), each tensor given by its data
// pointer and four element strides. dtype 0 is float32 (CUDA cores, this
// file), 1 is bfloat16 (tensor cores, flash_attention_tc.cu, which needs
// 16-byte-aligned rows with D contiguous).
extern "C" int repro_flash_attention(int dtype, int head_dim,
                                     const void* q, long long sqb, long long sqh, long long sqs,
                                     long long sqd,
                                     const void* k, long long skb, long long skh, long long sks,
                                     long long skd,
                                     const void* v, long long svb, long long svh, long long svs,
                                     long long svd,
                                     void* o, long long sob, long long soh, long long sos,
                                     long long sod,
                                     int batch, int heads, int kv_heads, int seq, float scale,
                                     float softcap, int causal, int window, void* stream) {
  if (batch == 0 || heads == 0 || seq == 0) return static_cast<int>(cudaGetLastError());
  if (kv_heads <= 0 || heads % kv_heads != 0) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, o,
               Strides{sqb, sqh, sqs, sqd}, Strides{skb, skh, sks, skd},
               Strides{svb, svh, svs, svd}, Strides{sob, soh, sos, sod},
               heads, kv_heads, seq, scale, softcap, causal, window};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = dispatch_f32(head_dim, a, batch, st);
  } else if (dtype == 1) {
    err = repro_flash::flash_bf16_tc(head_dim, a, batch, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
