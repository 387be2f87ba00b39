// Forward attention with an online softmax on Hopper (sm_90a), bfloat16
// inputs on the tensor cores, float32 scores, statistics and accumulator.
//
// Replaces, for bfloat16: src/repro/kernels/flash_attention.py:
// flash_attention_pallas (_flash_kernel). The reference computes
// jnp.dot(q, k.T, preferred_element_type=f32) and
// jnp.dot(p.astype(v.dtype), v, preferred_element_type=f32) on bf16
// operands: exactly what a bf16 tensor-core product with a float32
// accumulator computes, up to the order of summation.
//
// Bound on the H100 SXM: operations. Yi-9B prefill (B 2, H 32/4, S 2048,
// D 128, causal) needs 4·D·S(S+1)/2·B·H = 68.7 GFLOP, 69.5 us at the
// 989 TFLOP/s bf16 tensor-core peak, on 37.7 MB (11 us at 3.35 TB/s).
//
// Design (FlashAttention-2's, on mma.sync). One block of 8 warps owns one
// (b·h, 128-row query tile); each warp owns 16 query rows, so m, l and its
// 16 x D slice of the output accumulator live in registers in the
// m16n8k16 accumulator layout. Per K/V tile:
//   S = Q·Kᵀ  mma.sync.m16n8k16 bf16 -> f32, Q and K fed from shared memory
//             by ldmatrix (K rows are keys with D contiguous, which is the
//             "col" B operand as stored);
//   softcap, mask and the online softmax act on S in registers, one row
//             pair per thread, row max and sum over the 4 lanes of a row;
//   O += P·V  P is converted to bf16 in the registers that held S (the
//             accumulator layout of two n8 tiles is the A layout of one k16
//             chunk) and V is fed by ldmatrix.trans, so P never goes to
//             shared memory.
// K/V tiles come through a 2-stage ring filled with cp.async (16-byte
// copies, src-size 0 past S zero-fills ragged rows): tile t+1 is in
// flight while tile t is multiplied. Rows are padded by 16 bytes, so the
// 8 row addresses of every ldmatrix fall in 8 distinct bank groups.
//
// Masks: tiles no query of the block sees are never loaded, by the
// reference's predicates (exact for any tile sizes: a tile is needed iff
// its last key reaches the first query's window start, and, causal, its
// first key is at or before the last query). Inside, a warp skips a tile
// its 16 rows cannot see, and applies the per-element mask only on a tile
// that is not fully visible to all its rows. A row whose first visited
// tile is fully masked sums exp(0) terms until its first visible key
// resets them through alpha = exp(-1e30 - m) = 0, as in the reference.
//
// Operands are read in place through (B, H, S, D) strides, which must be
// 16-byte aligned with D contiguous (the wrapper guarantees it, copying
// only a view that breaks it); GQA maps query head h to kv head
// h / (H / Hkv) without repeating K/V.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "flash_args.cuh"

namespace repro_flash {
namespace {

using bf16 = __nv_bfloat16;

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int BQ = 16 * WARPS;   // query rows per block
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
struct Traits {
  // Keys per tile: 32 from D = 96 up keeps the S tile (16 floats a
  // thread) beside the accumulator within the two-block register budget.
  static constexpr int BKV = D >= 96 ? 32 : 64;
  static constexpr int LD = D + 8;                 // smem row stride, elements
  static constexpr int STAGES = 2;
  // D <= 128 keeps the accumulator small enough for two blocks an SM.
  static constexpr int MIN_BLOCKS = D <= 128 ? 2 : 1;
  static constexpr size_t bytes =
      sizeof(bf16) * static_cast<size_t>(LD) * (BQ + 2 * STAGES * BKV);
  static_assert(D % 16 == 0 && BKV % 16 == 0, "tile shapes must be k16 multiples");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
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

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t& r0, uint32_t& r1,
                                        uint32_t& r2, uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t& r0, uint32_t& r1,
                                          uint32_t& r2, uint32_t& r3) {
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

// Two floats rounded to nearest-even bf16, lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// dst[r][:] = src[start + r][:] for ROWS rows of D elements, zero past seq.
template <int ROWS, int D, int LD>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, long long ss, int start,
                                          int seq) {
  constexpr int CHUNKS = D / 8;   // 16-byte chunks per row
  constexpr int TOTAL = ROWS * CHUNKS;
#pragma unroll
  for (int it = 0; it < (TOTAL + THREADS - 1) / THREADS; ++it) {
    const int i = it * THREADS + static_cast<int>(threadIdx.x);
    if (TOTAL % THREADS == 0 || i < TOTAL) {
      const int r = i / CHUNKS, c = i % CHUNKS;
      const int pos = start + r;
      const bool in = pos < seq;
      const bf16* g = src + static_cast<long long>(in ? pos : 0) * ss + c * 8;
      cp_async16(smem_u32(dst + r * LD + c * 8), g, in ? 16 : 0);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS, Traits<D>::MIN_BLOCKS) flash_tc_kernel(Args a) {
  using Tr = Traits<D>;
  constexpr int BKV = Tr::BKV, LD = Tr::LD;
  constexpr int NT_S = BKV / 8;   // n8 tiles of a warp's S
  constexpr int NT_O = D / 8;     // n8 tiles of a warp's O
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* ring = qs + BQ * LD;   // stage s: K at ring + s·2·BKV·LD, V after it

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const int bh = blockIdx.x;
  const int q_start = (gridDim.y - 1 - blockIdx.y) * BQ;   // longest walks first
  const int b = bh / a.heads, h = bh % a.heads;
  const int hk = h / (a.heads / a.kv_heads);
  const bf16* q = static_cast<const bf16*>(a.q) + b * a.sq.b + h * a.sq.h;
  const bf16* k = static_cast<const bf16*>(a.k) + b * a.sk.b + hk * a.sk.h;
  const bf16* v = static_cast<const bf16*>(a.v) + b * a.sv.b + hk * a.sv.h;
  bf16* o = static_cast<bf16*>(a.o) + b * a.so.b + h * a.so.h;
  const int seq = a.seq;

  // The kv tiles some query of the block sees (the reference's predicates).
  const int n_kv = (seq + BKV - 1) / BKV;
  const int kt_end = a.causal ? min(n_kv, (q_start + BQ - 1) / BKV + 1) : n_kv;
  const int win_lo = q_start - a.window + 1;
  const int kt_begin = (a.window > 0 && win_lo > 0) ? win_lo / BKV : 0;

  load_rows<BQ, D, LD>(qs, q, a.sq.s, q_start, seq);
  if (kt_begin < kt_end) {
    load_rows<BKV, D, LD>(ring, k, a.sk.s, kt_begin * BKV, seq);
    load_rows<BKV, D, LD>(ring + BKV * LD, v, a.sv.s, kt_begin * BKV, seq);
  }
  cp_async_commit();

  // ldmatrix row addresses of this lane (see the fragment layouts of
  // mma.m16n8k16): Q as the row-major A operand, K as the "col" B operand
  // (keys x D as stored), V through .trans (keys x D as stored, read as
  // its transpose).
  const int mat = lane >> 3, mrow = lane & 7;
  const uint32_t q_addr =
      smem_u32(qs + (warp * 16 + mrow + (mat & 1) * 8) * LD + (mat >> 1) * 8);
  const int k_off = (mrow + (mat >> 1) * 8) * LD + (mat & 1) * 8;
  const int v_off = (mrow + (mat & 1) * 8) * LD + (mat >> 1) * 8;

  // Scores live in the log2 domain, x = log2(e)·softcap(scale·s), so that
  // exp(x_nat - m_nat) is one exp2f(x - m).
  const bool capped = a.softcap > 0.f;
  const float pre = capped ? a.scale / a.softcap : a.scale * LOG2E;
  const float post = a.softcap * LOG2E;

  const int wq0 = q_start + warp * 16;   // this warp's first query row
  const int row0 = wq0 + g;              // rows of accumulator elements 0,1 and 2,3
  const int row1 = row0 + 8;
  float m_run[2] = {NEG_INF, NEG_INF};
  float l_run[2] = {0.f, 0.f};   // this thread's partial row sums
  float acc[NT_O][4];
#pragma unroll
  for (int n = 0; n < NT_O; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int kt = kt_begin, it = 0; kt < kt_end; ++kt, ++it) {
    const int stage = it & 1;
    if (kt + 1 < kt_end) {
      bf16* nxt = ring + (stage ^ 1) * 2 * BKV * LD;
      load_rows<BKV, D, LD>(nxt, k, a.sk.s, (kt + 1) * BKV, seq);
      load_rows<BKV, D, LD>(nxt + BKV * LD, v, a.sv.s, (kt + 1) * BKV, seq);
    }
    cp_async_commit();
    cp_async_wait<1>();   // everything but the tile just requested has landed
    __syncthreads();

    const int k_start = kt * BKV;
    // Warp-uniform: does any of this warp's 16 rows see a key of the tile,
    // and does every one of them see all of it?
    const bool warp_sees = wq0 < seq && !(a.causal && k_start > wq0 + 15) &&
                           !(a.window > 0 && k_start + BKV - 1 < wq0 - a.window + 1);
    if (warp_sees) {
      const bf16* ks = ring + stage * 2 * BKV * LD;
      const uint32_t k_addr = smem_u32(ks + k_off);
      const uint32_t v_addr = smem_u32(ks + BKV * LD + v_off);
      float s[NT_S][4];
#pragma unroll
      for (int n = 0; n < NT_S; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
      for (int kc = 0; kc < D / 16; ++kc) {
        uint32_t a0, a1, a2, a3;
        ldsm_x4(q_addr + kc * 32, a0, a1, a2, a3);
#pragma unroll
        for (int np = 0; np < NT_S / 2; ++np) {
          uint32_t b0, b1, b2, b3;
          ldsm_x4(k_addr + (np * 16 * LD + kc * 16) * 2, b0, b1, b2, b3);
          mma(s[2 * np], a0, a1, a2, a3, b0, b1);
          mma(s[2 * np + 1], a0, a1, a2, a3, b2, b3);
        }
      }

      const bool full = k_start + BKV <= seq && !(a.causal && k_start + BKV - 1 > wq0) &&
                        !(a.window > 0 && wq0 + 15 - k_start >= a.window);
      float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
      for (int n = 0; n < NT_S; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[n][e] * pre;
          if (capped) x = post * tanhf(x);
          if (!full) {
            const int qpos = e < 2 ? row0 : row1;
            const int kpos = k_start + n * 8 + 2 * t4 + (e & 1);
            bool visible = kpos < seq;
            if (a.causal) visible = visible && qpos >= kpos;
            if (a.window > 0) visible = visible && qpos - kpos < a.window;
            if (!visible) x = NEG_INF;
          }
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
      // P·V with p rounded to bf16, as the reference's p.astype(v.dtype).
#pragma unroll
      for (int kc = 0; kc < BKV / 16; ++kc) {
        const uint32_t a0 = pack_bf16(s[2 * kc][0], s[2 * kc][1]);
        const uint32_t a1 = pack_bf16(s[2 * kc][2], s[2 * kc][3]);
        const uint32_t a2 = pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]);
        const uint32_t a3 = pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3]);
#pragma unroll
        for (int np = 0; np < NT_O / 2; ++np) {
          uint32_t b0, b1, b2, b3;
          ldsm_x4_t(v_addr + (kc * 16 * LD + np * 16) * 2, b0, b1, b2, b3);
          mma(acc[2 * np], a0, a1, a2, a3, b0, b1);
          mma(acc[2 * np + 1], a0, a1, a2, a3, b2, b3);
        }
      }
    }
    __syncthreads();   // nobody reads this stage any more: it may be refilled
  }
  cp_async_wait<0>();

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    inv[r] = 1.f / fmaxf(l, 1e-30f);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qpos = r == 0 ? row0 : row1;
    if (qpos >= seq) continue;
    bf16* orow = o + qpos * a.so.s;
#pragma unroll
    for (int n = 0; n < NT_O; ++n) {
      const int col = n * 8 + 2 * t4;
      *reinterpret_cast<uint32_t*>(orow + col) =
          pack_bf16(acc[n][2 * r] * inv[r], acc[n][2 * r + 1] * inv[r]);
    }
  }
}

template <int D>
cudaError_t launch(const Args& a, int batch, cudaStream_t st) {
  const int smem = static_cast<int>(Traits<D>::bytes);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(batch * a.heads, (a.seq + BQ - 1) / BQ);
  flash_tc_kernel<D><<<grid, THREADS, smem, st>>>(a);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

// D contiguous and 16-byte steps along every dim longer than 1 (the
// stride of a dim of size 1 is never used).
bool rows16(const Strides& s, int batch, int heads, int seq) {
  return s.d == 1 && (seq == 1 || s.s % 8 == 0) && (heads == 1 || s.h % 8 == 0) &&
         (batch == 1 || s.b % 8 == 0);
}

}  // namespace

cudaError_t flash_bf16_tc(int head_dim, const Args& a, int batch, cudaStream_t st) {
  // cp.async copies 16-byte rows in place; the output is written as bf16
  // pairs.
  if (!aligned16(a.q) || !aligned16(a.k) || !aligned16(a.v) ||
      !rows16(a.sq, batch, a.heads, a.seq) || !rows16(a.sk, batch, a.kv_heads, a.seq) ||
      !rows16(a.sv, batch, a.kv_heads, a.seq) || a.so.d != 1 ||
      (a.so.s | a.so.h | a.so.b) % 2 != 0 || (reinterpret_cast<uintptr_t>(a.o) & 3u) != 0)
    return cudaErrorInvalidValue;
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

}  // namespace repro_flash
