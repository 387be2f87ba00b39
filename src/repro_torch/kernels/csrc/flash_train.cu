// Causal (or full), windowed, soft-capped attention for training on Hopper
// (sm_90a): the forward with its float32 output and log-sum-exp, and the
// backward's dq, dk and dv, on bf16 tensor cores with float32 accumulators.
//
// Replaces no kernel of the reference package: its training attention,
// src/repro/models/attention.py: _chunked_core, is plain jnp with a custom
// VJP, which XLA fuses on the TPU. The port's plain version,
// models/attention.py: _ChunkedCore, computes it in float32 ATen over
// 512-key blocks, forward and backward, with (B, H, S, 512) float32 score,
// probability, dP and dS tensors in device memory, every masked block in
// full. This computes the same function:
//   P = softmax(softcap(scale · q·kᵀ)) under the causal and window masks,
//   O = P·v, LSE = log Σ exp (float32), and from (q, k, v, O32, LSE, dO):
//   D_i = Σ_d dO·O32, dS = P ⊙ (dO·vᵀ − D_i) (⊙ 1 − t² soft-capped) · scale,
//   dv = Pᵀ·dO, dq = dS·k, dk = dSᵀ·q.
//
// Precision is the plain version's. q, k, v and dO are bf16, so their
// products on the tensor cores (bf16 in, float32 accumulator) are exact up
// to the order of summation. P and dS are float32 there: where they enter
// a product (P·v, Pᵀ·dO, dS·k, dSᵀ·q) each goes in as three bf16 parts
// hi + mid + lo, which hold all 24 bits, each part's product added into the
// float32 accumulator, smallest first (as csrc/ssd_chunk.cu does). Neither
// is ever rounded once to bf16 (the prefill kernel, csrc/flash_attention_tc.cu,
// does round P, as the reference's flash kernel does). dk and dv sum every
// query that sees a key, over the group's query heads too, in float32 and
// are rounded to bf16 once.
//
// Bound on the H100 SXM: operations. Zamba2-1.2B's shared attention (B 1,
// H 32/32, S 2048, D 128, causal) needs 4·B·H·D·S(S+1)/2 = 34.4 GFLOP
// forward and 68.7 backward (dv, dP, dq, dk), 0.104 ms an application at
// the 989 TFLOP/s bf16 peak, on 134 MB (q, k, v, O, dO, dq, dk, dv in bf16
// and the LSE, once each: 0.04 ms at 3.35 TB/s). The kernels execute more:
// the three-part products and the backward's recomputed q·kᵀ, in both of
// its kernels, and dO·vᵀ make 17 products of a visible pair where the
// count has 6.
//
// Design (FlashAttention-2's, on mma.sync m16n8k16; the prefill kernel's
// feeds). Operands are read through their (B, S, H, D) strides, D
// contiguous; GQA maps query head h to kv head h / (H / Hkv) with no
// repeated K/V. Four launches:
//   fwd   (b·h, 128-query tile), 8 warps of 16 rows: S = Q·Kᵀ and the
//         online softmax in registers, O += P·V with P from the registers
//         that held S (the accumulator layout of two n8 tiles is the A
//         layout of one k16 step), V by ldmatrix.trans; K/V tiles through
//         a 2-stage cp.async ring. Writes O in bf16 and float32, and LSE.
//   delta (one warp a row): D_i from dO and the float32 O.
//   dkdv  (b·hkv, 64-key tile), 4 warps of 16 keys: over the group's query
//         heads and the query tiles that see the key tile, Sᵀ = K·Qᵀ and
//         dPᵀ = V·dOᵀ, Pᵀ and dSᵀ in registers, dV += Pᵀ·dO, dK += dSᵀ·Q;
//         Q, dO, LSE and D tiles through the ring.
//   dq    (b·h, 128-query tile), 8 warps: S, dP = dO·Vᵀ, dS, dQ += dS·K over
//         the key tiles the query tile sees.
// Masks: a tile pair no query sees is never visited (key_tiles,
// query_tiles: exact for any tile sizes, the schedule that
// kernels/flash_train.py:schedule mirrors for the CPU tests); inside, a
// warp skips a tile its 16 rows cannot see and masks element by element
// only a tile that is not fully visible. No atomics: every output element
// has one writer and sums in a fixed order, so a run's bits repeat.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace repro_flash_train {
namespace {

using bf16 = __nv_bfloat16;

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// Rows of a block: query rows of fwd and dq (8 warps), key rows of dkdv
// (4 warps); the wrapper's TILES.
constexpr int ROW_WARPS = 8;
constexpr int BQ = 16 * ROW_WARPS;
constexpr int KEY_WARPS = 4;
constexpr int BKC = 16 * KEY_WARPS;
constexpr int STAGES = 2;

template <int D>
struct Tiles {
  static constexpr int LD = D + 8;              // smem row pitch: 16 bytes of pad
  static constexpr int BKV = D >= 128 ? 32 : 64;  // keys a step of fwd and dq
  static constexpr int BQB = D >= 128 ? 32 : 64;  // queries a step of dkdv
  static constexpr size_t fwd_bytes = sizeof(bf16) * LD * (BQ + STAGES * 2 * BKV);
  static constexpr size_t dq_bytes = sizeof(bf16) * LD * (2 * BQ + STAGES * 2 * BKV);
  static constexpr size_t dkdv_bytes =
      sizeof(bf16) * LD * (2 * BKC + STAGES * 2 * BQB) + sizeof(float) * STAGES * 2 * BQB;
  static_assert(D % 16 == 0 && BKV % 16 == 0 && BQB % 16 == 0, "k16 steps");
};

struct Args {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  long long qs[3], ks[3], vs[3];   // batch, position and head strides, in elements
  bf16* o;                         // (B, S, H, D) contiguous
  float* o32;                      // (B, S, H, D) contiguous
  float* lse;                      // (B, H, S)
  const bf16* dout;
  long long dos[3];
  float* delta;                    // (B, H, S)
  bf16* dq;                        // (B, S, H, D) contiguous
  bf16* dk;                        // (B, S, Hkv, D) contiguous
  bf16* dv;
  int batch, heads, kv_heads, seq;
  float scale, softcap;
  int causal, window;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm(uint32_t addr, uint32_t& r0, uint32_t& r1, uint32_t& r2,
                                     uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_t(uint32_t addr, uint32_t& r0, uint32_t& r1, uint32_t& r2,
                                       uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr));
}

// c += a·b, one m16n8k16 tile, bf16 operands, float32 accumulator.
__device__ __forceinline__ void mma(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                    uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// Two floats as three bf16 pairs hi + mid + lo (x0 in the low halves);
// each remainder is exact in float32, so the parts hold all 24 bits.
__device__ __forceinline__ void split_pair(float x0, float x1, uint32_t& hi, uint32_t& mid,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  x0 -= __low2float(h);
  x1 -= __high2float(h);
  const __nv_bfloat162 m = __floats2bfloat162_rn(x0, x1);
  x0 -= __low2float(m);
  x1 -= __high2float(m);
  hi = bits(h);
  mid = bits(m);
  lo = bits(__floats2bfloat162_rn(x0, x1));
}

// The A fragment of one k16 step, from the float32 accumulators of two n8
// tiles, as three bf16 parts a[part][reg].
__device__ __forceinline__ void a_parts(const float (&c0)[4], const float (&c1)[4],
                                        uint32_t (&a)[3][4]) {
  split_pair(c0[0], c0[1], a[0][0], a[1][0], a[2][0]);
  split_pair(c0[2], c0[3], a[0][1], a[1][1], a[2][1]);
  split_pair(c1[0], c1[1], a[0][2], a[1][2], a[2][2]);
  split_pair(c1[2], c1[3], a[0][3], a[1][3], a[2][3]);
}

// Two n8 tiles c0, c1 += A·B, A in three parts, lo first.
__device__ __forceinline__ void mma3(float (&c0)[4], float (&c1)[4], const uint32_t (&a)[3][4],
                                     uint32_t b0, uint32_t b1, uint32_t b2, uint32_t b3) {
#pragma unroll
  for (int p = 2; p >= 0; --p) {
    mma(c0, a[p][0], a[p][1], a[p][2], a[p][3], b0, b1);
    mma(c1, a[p][0], a[p][1], a[p][2], a[p][3], b2, b3);
  }
}

// dst[r][:] = src[(start + r)·rs][:] for ROWS rows of D elements.
template <int ROWS, int D, int LD, int THREADS>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, long long rs, int start) {
  constexpr int CHUNKS = D / 8;   // 16-byte chunks a row
  constexpr int TOTAL = ROWS * CHUNKS;
  static_assert(TOTAL % THREADS == 0, "whole rounds of chunks");
#pragma unroll
  for (int it = 0; it < TOTAL / THREADS; ++it) {
    const int i = it * THREADS + static_cast<int>(threadIdx.x);
    const int r = i / CHUNKS, c = i % CHUNKS;
    cp_async16(smem_u32(dst + r * LD + c * 8), src + static_cast<long long>(start + r) * rs + c * 8);
  }
}

// dst[0:N] = src[0:N], N floats (a multiple of 4).
template <int N>
__device__ __forceinline__ void load_floats(float* dst, const float* src) {
  const int i = static_cast<int>(threadIdx.x);
  if (i < N / 4) cp_async16(smem_u32(dst + 4 * i), src + 4 * i);
}

// The key tiles [first, last) of size bk that the query tile [q0, q0 + bq)
// sees (some pair visible): causal ends at the tile of its last query; a
// window begins at the tile of its first query's first key.
__device__ __forceinline__ int2 key_tiles(int q0, int bq, int bk, int n_k, int causal,
                                          int window) {
  const int last = causal ? min(n_k, (q0 + bq - 1) / bk + 1) : n_k;
  const int lo = q0 - window + 1;
  return make_int2(window > 0 && lo > 0 ? lo / bk : 0, last);
}

// The query tiles [first, last) of size bq that see the key tile
// [k0, k0 + bk): causal begins at the tile of its first key; a window ends
// at the tile of the last query that sees its last key.
__device__ __forceinline__ int2 query_tiles(int k0, int bk, int bq, int n_q, int causal,
                                            int window) {
  const int first = causal ? k0 / bq : 0;
  const int last = window > 0 ? min(n_q, (k0 + bk + window - 2) / bq + 1) : n_q;
  return make_int2(first, last);
}

__device__ __forceinline__ bool visible(const Args& a, int qpos, int kpos) {
  return !(a.causal && qpos < kpos) && !(a.window > 0 && qpos - kpos >= a.window);
}

// x = log2(e)·softcap(scale·s): the log2 domain, so exp(x_nat − m) is
// exp2f(x − m). t: tanh of the capped argument (for the backward's 1 − t²).
struct Logits {
  bool capped;
  float pre, post;
  __device__ explicit Logits(const Args& a)
      : capped(a.softcap > 0.f),
        pre(a.softcap > 0.f ? a.scale / a.softcap : a.scale * LOG2E),
        post(a.softcap * LOG2E) {}
  __device__ __forceinline__ float operator()(float s, float& t) const {
    float x = s * pre;
    if (capped) {
      t = tanhf(x);
      x = post * t;
    }
    return x;
  }
};

// ldmatrix lane offsets (elements) within a tile of pitch LD: A operand
// (rows m, k contiguous), B operand stored [n][k], and B stored [k][n]
// read through .trans; see the fragment layouts of mma.m16n8k16.
template <int LD>
struct Lanes {
  int a, b, bt;
  __device__ explicit Lanes(int lane) {
    const int mat = lane >> 3, r = lane & 7;
    a = (r + (mat & 1) * 8) * LD + (mat >> 1) * 8;
    b = (r + (mat >> 1) * 8) * LD + (mat & 1) * 8;
    bt = (r + (mat & 1) * 8) * LD + (mat >> 1) * 8;
  }
};

// acc[NT] (a warp's 16 x 8·NT tile) = A·Bᵀ over D, A the warp's 16 rows
// at a_addr (pitch LD), B's 8·NT rows at b_addr, both [row][d].
template <int D, int LD, int NT>
__device__ __forceinline__ void qk(float (&acc)[NT][4], uint32_t a_addr, uint32_t b_addr) {
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) {
    uint32_t a0, a1, a2, a3;
    ldsm(a_addr + kc * 32, a0, a1, a2, a3);
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t b0, b1, b2, b3;
      ldsm(b_addr + (np * 16 * LD + kc * 16) * 2, b0, b1, b2, b3);
      mma(acc[2 * np], a0, a1, a2, a3, b0, b1);
      mma(acc[2 * np + 1], a0, a1, a2, a3, b2, b3);
    }
  }
}

// acc[D/8] += P·B, P the float32 accumulators of KT n8 tiles (the k
// dim) in three parts, B's 8·KT rows at bt_addr stored [k][d].
template <int D, int LD, int KT>
__device__ __forceinline__ void pv(float (&acc)[D / 8][4], const float (&p)[KT][4],
                                   uint32_t bt_addr) {
#pragma unroll
  for (int kc = 0; kc < KT / 2; ++kc) {
    uint32_t a[3][4];
    a_parts(p[2 * kc], p[2 * kc + 1], a);
#pragma unroll
    for (int np = 0; np < D / 16; ++np) {
      uint32_t b0, b1, b2, b3;
      ldsm_t(bt_addr + (kc * 16 * LD + np * 16) * 2, b0, b1, b2, b3);
      mma3(acc[2 * np], acc[2 * np + 1], a, b0, b1, b2, b3);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(32 * ROW_WARPS, 1) fwd_kernel(Args a) {
  using Tr = Tiles<D>;
  constexpr int BKV = Tr::BKV, LD = Tr::LD, THREADS = 32 * ROW_WARPS;
  constexpr int NT_S = BKV / 8, NT_O = D / 8;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* ring = qs + BQ * LD;   // stage s: K at ring + s·2·BKV·LD, V after it

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane >> 2, t4 = lane & 3;
  const int b = blockIdx.x / a.heads, h = blockIdx.x % a.heads;
  const int hk = h / (a.heads / a.kv_heads);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;   // longest walks first
  const bf16* q = a.q + b * a.qs[0] + h * a.qs[2];
  const bf16* k = a.k + b * a.ks[0] + hk * a.ks[2];
  const bf16* v = a.v + b * a.vs[0] + hk * a.vs[2];
  const int2 kt = key_tiles(q0, BQ, BKV, a.seq / BKV, a.causal, a.window);

  load_rows<BQ, D, LD, THREADS>(qs, q, a.qs[1], q0);
  if (kt.x < kt.y) {
    load_rows<BKV, D, LD, THREADS>(ring, k, a.ks[1], kt.x * BKV);
    load_rows<BKV, D, LD, THREADS>(ring + BKV * LD, v, a.vs[1], kt.x * BKV);
  }
  cp_async_commit();

  const Lanes<LD> ln(lane);
  const uint32_t q_addr = smem_u32(qs + warp * 16 * LD + ln.a);
  const Logits logits(a);
  const int wq0 = q0 + warp * 16;   // this warp's first query
  const int row0 = wq0 + g, row1 = row0 + 8;
  float m_run[2] = {NEG_INF, NEG_INF};
  float l_run[2] = {0.f, 0.f};   // this thread's partial row sums
  float acc[NT_O][4];
#pragma unroll
  for (int n = 0; n < NT_O; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int t = kt.x, it = 0; t < kt.y; ++t, ++it) {
    const int stage = it & 1;
    if (t + 1 < kt.y) {
      bf16* nxt = ring + (stage ^ 1) * 2 * BKV * LD;
      load_rows<BKV, D, LD, THREADS>(nxt, k, a.ks[1], (t + 1) * BKV);
      load_rows<BKV, D, LD, THREADS>(nxt + BKV * LD, v, a.vs[1], (t + 1) * BKV);
    }
    cp_async_commit();
    cp_async_wait<1>();   // everything but the tile just requested has landed
    __syncthreads();

    const int k0 = t * BKV;
    const bool sees = !(a.causal && k0 > wq0 + 15) &&
                      !(a.window > 0 && wq0 - (k0 + BKV - 1) >= a.window);
    if (sees) {
      const bf16* ks = ring + stage * 2 * BKV * LD;
      float s[NT_S][4];
      qk<D, LD, NT_S>(s, q_addr, smem_u32(ks + ln.b));
      const bool full = !(a.causal && k0 + BKV - 1 > wq0) &&
                        !(a.window > 0 && wq0 + 15 - k0 >= a.window);
      float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
      for (int n = 0; n < NT_S; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float th = 0.f;
          float x = logits(s[n][e], th);
          if (!full && !visible(a, e < 2 ? row0 : row1, k0 + n * 8 + 2 * t4 + (e & 1)))
            x = NEG_INF;
          s[n][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m_run[r], mx[r]);
        alpha[r] = exp2f(m_run[r] - m_new);
        m_run[r] = m_new;
        l_run[r] *= alpha[r];
      }
#pragma unroll
      for (int n = 0; n < NT_S; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = exp2f(s[n][e] - m_run[e >> 1]);
          l_run[e >> 1] += p;
          s[n][e] = p;
        }
#pragma unroll
      for (int n = 0; n < NT_O; ++n) {
        acc[n][0] *= alpha[0];
        acc[n][1] *= alpha[0];
        acc[n][2] *= alpha[1];
        acc[n][3] *= alpha[1];
      }
      pv<D, LD, NT_S>(acc, s, smem_u32(ks + BKV * LD + ln.bt));
    }
    __syncthreads();   // nobody reads this stage any more: it may be refilled
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    l = fmaxf(l, 1e-30f);
    const int qpos = r == 0 ? row0 : row1;
    const long long row = (static_cast<long long>(b) * a.seq + qpos) * a.heads + h;
    if (t4 == 0)
      a.lse[(static_cast<long long>(b) * a.heads + h) * a.seq + qpos] = m_run[r] * LN2 + logf(l);
#pragma unroll
    for (int n = 0; n < NT_O; ++n) {
      const int col = n * 8 + 2 * t4;
      const float x0 = acc[n][2 * r] / l, x1 = acc[n][2 * r + 1] / l;
      *reinterpret_cast<float2*>(a.o32 + row * D + col) = make_float2(x0, x1);
      *reinterpret_cast<__nv_bfloat162*>(a.o + row * D + col) = __floats2bfloat162_rn(x0, x1);
    }
  }
}

// D_i = Σ_d dO·O32 of one (b, position, head) row a warp, 8 rows a block.
template <int D>
__global__ void __launch_bounds__(256) delta_kernel(Args a) {
  const int lane = threadIdx.x % 32;
  const long long row = static_cast<long long>(blockIdx.x) * 8 + threadIdx.x / 32;
  if (row >= static_cast<long long>(a.batch) * a.seq * a.heads) return;
  const int h = static_cast<int>(row % a.heads);
  const int pos = static_cast<int>((row / a.heads) % a.seq);
  const int b = static_cast<int>(row / (static_cast<long long>(a.heads) * a.seq));
  const bf16* g = a.dout + b * a.dos[0] + pos * a.dos[1] + h * a.dos[2];
  const float* o = a.o32 + row * D;
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < D / 32; ++j) {
    const int d = lane * (D / 32) + j;
    sum += __bfloat162float(g[d]) * o[d];
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (lane == 0) a.delta[(static_cast<long long>(b) * a.heads + h) * a.seq + pos] = sum;
}

template <int D>
__global__ void __launch_bounds__(32 * KEY_WARPS, 2) dkdv_kernel(Args a) {
  using Tr = Tiles<D>;
  constexpr int BQB = Tr::BQB, LD = Tr::LD, THREADS = 32 * KEY_WARPS;
  constexpr int NT_Q = BQB / 8, NT_O = D / 8;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* vs = ks + BKC * LD;
  bf16* ring = vs + BKC * LD;   // stage s: Q at ring + s·2·BQB·LD, dO after it
  float* stats = reinterpret_cast<float*>(ring + STAGES * 2 * BQB * LD);   // stage s: LSE, D

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane >> 2, t4 = lane & 3;
  const int b = blockIdx.x / a.kv_heads, hk = blockIdx.x % a.kv_heads;
  const int group = a.heads / a.kv_heads;
  const int k0 = blockIdx.y * BKC;   // the first key tiles have the longest walks
  const int2 qt = query_tiles(k0, BKC, BQB, a.seq / BQB, a.causal, a.window);
  const int nq = qt.y - qt.x, n_it = group * nq;

  // Step i: query head hk·group + i / nq, query tile qt.x + i % nq.
  auto load_step = [&](int i, int stage) {
    const int h = hk * group + i / nq, q0 = (qt.x + i % nq) * BQB;
    bf16* dst = ring + stage * 2 * BQB * LD;
    load_rows<BQB, D, LD, THREADS>(dst, a.q + b * a.qs[0] + h * a.qs[2], a.qs[1], q0);
    load_rows<BQB, D, LD, THREADS>(dst + BQB * LD, a.dout + b * a.dos[0] + h * a.dos[2],
                                   a.dos[1], q0);
    const long long st = (static_cast<long long>(b) * a.heads + h) * a.seq + q0;
    load_floats<BQB>(stats + stage * 2 * BQB, a.lse + st);
    load_floats<BQB>(stats + stage * 2 * BQB + BQB, a.delta + st);
  };

  load_rows<BKC, D, LD, THREADS>(ks, a.k + b * a.ks[0] + hk * a.ks[2], a.ks[1], k0);
  load_rows<BKC, D, LD, THREADS>(vs, a.v + b * a.vs[0] + hk * a.vs[2], a.vs[1], k0);
  if (n_it > 0) load_step(0, 0);
  cp_async_commit();

  const Lanes<LD> ln(lane);
  const uint32_t k_addr = smem_u32(ks + warp * 16 * LD + ln.a);
  const uint32_t v_addr = smem_u32(vs + warp * 16 * LD + ln.a);
  const Logits logits(a);
  const int wk0 = k0 + warp * 16;   // this warp's first key
  const int key0 = wk0 + g, key1 = key0 + 8;
  float dk[NT_O][4], dv[NT_O][4];
#pragma unroll
  for (int n = 0; n < NT_O; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

  for (int i = 0; i < n_it; ++i) {
    const int stage = i & 1;
    if (i + 1 < n_it) load_step(i + 1, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    const int q0 = (qt.x + i % nq) * BQB;
    const bool sees = !(a.causal && wk0 > q0 + BQB - 1) &&
                      !(a.window > 0 && q0 - (wk0 + 15) >= a.window);
    if (sees) {
      const bf16* qtile = ring + stage * 2 * BQB * LD;
      const bf16* dotile = qtile + BQB * LD;
      const float* lse = stats + stage * 2 * BQB;
      const float* dl = lse + BQB;
      float st[NT_Q][4], dpt[NT_Q][4];   // Sᵀ and dPᵀ: the warp's 16 keys x BQB queries
      qk<D, LD, NT_Q>(st, k_addr, smem_u32(qtile + ln.b));
      qk<D, LD, NT_Q>(dpt, v_addr, smem_u32(dotile + ln.b));
      const bool full = !(a.causal && wk0 + 15 > q0) &&
                        !(a.window > 0 && q0 + BQB - 1 - wk0 >= a.window);
#pragma unroll
      for (int n = 0; n < NT_Q; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qc = n * 8 + 2 * t4 + (e & 1);
          float th = 0.f;
          float x = logits(st[n][e], th);
          if (!full && !visible(a, q0 + qc, e < 2 ? key0 : key1)) x = NEG_INF;
          const float p = exp2f(x - lse[qc] * LOG2E);
          float ds = p * (dpt[n][e] - dl[qc]);
          if (logits.capped) ds *= 1.f - th * th;
          st[n][e] = p;
          dpt[n][e] = ds * a.scale;
        }
      pv<D, LD, NT_Q>(dv, st, smem_u32(dotile + ln.bt));
      pv<D, LD, NT_Q>(dk, dpt, smem_u32(qtile + ln.bt));
    }
    __syncthreads();
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const long long row =
        (static_cast<long long>(b) * a.seq + (r == 0 ? key0 : key1)) * a.kv_heads + hk;
#pragma unroll
    for (int n = 0; n < NT_O; ++n) {
      const int col = n * 8 + 2 * t4;
      *reinterpret_cast<__nv_bfloat162*>(a.dk + row * D + col) =
          __floats2bfloat162_rn(dk[n][2 * r], dk[n][2 * r + 1]);
      *reinterpret_cast<__nv_bfloat162*>(a.dv + row * D + col) =
          __floats2bfloat162_rn(dv[n][2 * r], dv[n][2 * r + 1]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(32 * ROW_WARPS, 1) dq_kernel(Args a) {
  using Tr = Tiles<D>;
  constexpr int BKV = Tr::BKV, LD = Tr::LD, THREADS = 32 * ROW_WARPS;
  constexpr int NT_S = BKV / 8, NT_O = D / 8;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* dos = qs + BQ * LD;
  bf16* ring = dos + BQ * LD;   // stage s: K at ring + s·2·BKV·LD, V after it

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane >> 2, t4 = lane & 3;
  const int b = blockIdx.x / a.heads, h = blockIdx.x % a.heads;
  const int hk = h / (a.heads / a.kv_heads);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const bf16* k = a.k + b * a.ks[0] + hk * a.ks[2];
  const bf16* v = a.v + b * a.vs[0] + hk * a.vs[2];
  const int2 kt = key_tiles(q0, BQ, BKV, a.seq / BKV, a.causal, a.window);

  load_rows<BQ, D, LD, THREADS>(qs, a.q + b * a.qs[0] + h * a.qs[2], a.qs[1], q0);
  load_rows<BQ, D, LD, THREADS>(dos, a.dout + b * a.dos[0] + h * a.dos[2], a.dos[1], q0);
  if (kt.x < kt.y) {
    load_rows<BKV, D, LD, THREADS>(ring, k, a.ks[1], kt.x * BKV);
    load_rows<BKV, D, LD, THREADS>(ring + BKV * LD, v, a.vs[1], kt.x * BKV);
  }
  cp_async_commit();

  const Lanes<LD> ln(lane);
  const uint32_t q_addr = smem_u32(qs + warp * 16 * LD + ln.a);
  const uint32_t do_addr = smem_u32(dos + warp * 16 * LD + ln.a);
  const Logits logits(a);
  const int wq0 = q0 + warp * 16;
  const int row0 = wq0 + g, row1 = row0 + 8;
  const long long st = (static_cast<long long>(b) * a.heads + h) * a.seq;
  const float lse2[2] = {a.lse[st + row0] * LOG2E, a.lse[st + row1] * LOG2E};
  const float dl[2] = {a.delta[st + row0], a.delta[st + row1]};
  float dq[NT_O][4];
#pragma unroll
  for (int n = 0; n < NT_O; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[n][e] = 0.f;

  for (int t = kt.x, it = 0; t < kt.y; ++t, ++it) {
    const int stage = it & 1;
    if (t + 1 < kt.y) {
      bf16* nxt = ring + (stage ^ 1) * 2 * BKV * LD;
      load_rows<BKV, D, LD, THREADS>(nxt, k, a.ks[1], (t + 1) * BKV);
      load_rows<BKV, D, LD, THREADS>(nxt + BKV * LD, v, a.vs[1], (t + 1) * BKV);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    const int k0 = t * BKV;
    const bool sees = !(a.causal && k0 > wq0 + 15) &&
                      !(a.window > 0 && wq0 - (k0 + BKV - 1) >= a.window);
    if (sees) {
      const bf16* ktile = ring + stage * 2 * BKV * LD;
      float s[NT_S][4], dp[NT_S][4];
      qk<D, LD, NT_S>(s, q_addr, smem_u32(ktile + ln.b));
      qk<D, LD, NT_S>(dp, do_addr, smem_u32(ktile + BKV * LD + ln.b));
      const bool full = !(a.causal && k0 + BKV - 1 > wq0) &&
                        !(a.window > 0 && wq0 + 15 - k0 >= a.window);
#pragma unroll
      for (int n = 0; n < NT_S; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float th = 0.f;
          float x = logits(s[n][e], th);
          if (!full && !visible(a, e < 2 ? row0 : row1, k0 + n * 8 + 2 * t4 + (e & 1)))
            x = NEG_INF;
          const float p = exp2f(x - lse2[e >> 1]);
          float ds = p * (dp[n][e] - dl[e >> 1]);
          if (logits.capped) ds *= 1.f - th * th;
          s[n][e] = ds * a.scale;
        }
      pv<D, LD, NT_S>(dq, s, smem_u32(ktile + ln.bt));
    }
    __syncthreads();
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const long long row =
        (static_cast<long long>(b) * a.seq + (r == 0 ? row0 : row1)) * a.heads + h;
#pragma unroll
    for (int n = 0; n < NT_O; ++n)
      *reinterpret_cast<__nv_bfloat162*>(a.dq + row * D + n * 8 + 2 * t4) =
          __floats2bfloat162_rn(dq[n][2 * r], dq[n][2 * r + 1]);
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <int D>
cudaError_t forward(const Args& a, cudaStream_t st) {
  using Tr = Tiles<D>;
  static const cudaError_t attr = allow_smem(fwd_kernel<D>, Tr::fwd_bytes);
  if (attr != cudaSuccess) return attr;
  fwd_kernel<D><<<dim3(a.batch * a.heads, a.seq / BQ), 32 * ROW_WARPS, Tr::fwd_bytes, st>>>(a);
  return cudaGetLastError();
}

template <int D>
cudaError_t backward(const Args& a, cudaStream_t st) {
  using Tr = Tiles<D>;
  static const cudaError_t attr = [] {
    const cudaError_t e = allow_smem(dkdv_kernel<D>, Tr::dkdv_bytes);
    return e == cudaSuccess ? allow_smem(dq_kernel<D>, Tr::dq_bytes) : e;
  }();
  if (attr != cudaSuccess) return attr;
  cudaError_t err;
  const long long rows = static_cast<long long>(a.batch) * a.seq * a.heads;
  delta_kernel<D><<<static_cast<unsigned>((rows + 7) / 8), 256, 0, st>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  dkdv_kernel<D><<<dim3(a.batch * a.kv_heads, a.seq / BKC), 32 * KEY_WARPS, Tr::dkdv_bytes,
                   st>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  dq_kernel<D><<<dim3(a.batch * a.heads, a.seq / BQ), 32 * ROW_WARPS, Tr::dq_bytes, st>>>(a);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

// 16-byte rows in place: D contiguous (the wrapper's), steps of 8 elements
// along every dim longer than 1.
bool rows16(const void* p, const long long (&s)[3], int batch, int seq, int heads) {
  return aligned16(p) && (batch == 1 || s[0] % 8 == 0) && (seq == 1 || s[1] % 8 == 0) &&
         (heads == 1 || s[2] % 8 == 0);
}

Args make_args(const void* q, long long qb, long long qs, long long qh, const void* k,
               long long kb, long long ks, long long kh, const void* v, long long vb,
               long long vs, long long vh, int batch, int heads, int kv_heads, int seq,
               float scale, float softcap, int causal, int window) {
  Args a{};
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.qs[0] = qb, a.qs[1] = qs, a.qs[2] = qh;
  a.ks[0] = kb, a.ks[1] = ks, a.ks[2] = kh;
  a.vs[0] = vb, a.vs[1] = vs, a.vs[2] = vh;
  a.batch = batch, a.heads = heads, a.kv_heads = kv_heads, a.seq = seq;
  a.scale = scale, a.softcap = softcap, a.causal = causal, a.window = window;
  return a;
}

// The shapes the wrapper's check admits: S a multiple of the 128-row tile,
// H a multiple of Hkv, operands readable in place.
bool shapes_ok(const Args& a) {
  return a.batch > 0 && a.heads > 0 && a.kv_heads > 0 && a.heads % a.kv_heads == 0 &&
         a.seq > 0 && a.seq % BQ == 0 && a.window >= 0 &&
         rows16(a.q, a.qs, a.batch, a.seq, a.heads) &&
         rows16(a.k, a.ks, a.batch, a.seq, a.kv_heads) &&
         rows16(a.v, a.vs, a.batch, a.seq, a.kv_heads);
}

}  // namespace
}  // namespace repro_flash_train

using repro_flash_train::Args;

// q (B, S, H, D), k and v (B, S, Hkv, D), bf16, each a pointer and its
// batch, position and head strides (D contiguous); o (bf16), o32 (float32)
// (B, S, H, D) and lse (B, H, S) contiguous outputs.
extern "C" int repro_flash_train_fwd(int head_dim, const void* q, long long qb, long long qs,
                                     long long qh, const void* k, long long kb, long long ks,
                                     long long kh, const void* v, long long vb, long long vs,
                                     long long vh, void* o, float* o32, float* lse, int batch,
                                     int heads, int kv_heads, int seq, float scale,
                                     float softcap, int causal, int window, void* stream) {
  Args a = repro_flash_train::make_args(q, qb, qs, qh, k, kb, ks, kh, v, vb, vs, vh, batch,
                                        heads, kv_heads, seq, scale, softcap, causal, window);
  if (!repro_flash_train::shapes_ok(a)) return static_cast<int>(cudaErrorInvalidValue);
  a.o = static_cast<__nv_bfloat16*>(o);
  a.o32 = o32;
  a.lse = lse;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 64: return static_cast<int>(repro_flash_train::forward<64>(a, st));
    case 128: return static_cast<int>(repro_flash_train::forward<128>(a, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The forward's operands, its o32 and lse, and dO (strided as q); delta
// (B, H, S) float32 scratch; dq (B, S, H, D), dk and dv (B, S, Hkv, D)
// contiguous bf16 outputs.
extern "C" int repro_flash_train_bwd(int head_dim, const void* q, long long qb, long long qs,
                                     long long qh, const void* k, long long kb, long long ks,
                                     long long kh, const void* v, long long vb, long long vs,
                                     long long vh, const float* o32, const float* lse,
                                     const void* dout, long long db, long long ds, long long dh,
                                     float* delta, void* dq, void* dk, void* dv, int batch,
                                     int heads, int kv_heads, int seq, float scale,
                                     float softcap, int causal, int window, void* stream) {
  Args a = repro_flash_train::make_args(q, qb, qs, qh, k, kb, ks, kh, v, vb, vs, vh, batch,
                                        heads, kv_heads, seq, scale, softcap, causal, window);
  a.dos[0] = db, a.dos[1] = ds, a.dos[2] = dh;
  if (!repro_flash_train::shapes_ok(a) ||
      !repro_flash_train::rows16(dout, a.dos, batch, seq, heads))
    return static_cast<int>(cudaErrorInvalidValue);
  a.o32 = const_cast<float*>(o32);
  a.lse = const_cast<float*>(lse);
  a.dout = static_cast<const __nv_bfloat16*>(dout);
  a.delta = delta;
  a.dq = static_cast<__nv_bfloat16*>(dq);
  a.dk = static_cast<__nv_bfloat16*>(dk);
  a.dv = static_cast<__nv_bfloat16*>(dv);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 64: return static_cast<int>(repro_flash_train::backward<64>(a, st));
    case 128: return static_cast<int>(repro_flash_train::backward<128>(a, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
