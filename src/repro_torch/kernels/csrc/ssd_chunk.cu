// The SSD's intra-chunk stage, forward and backward, on Hopper (sm_90a)
// tensor cores, with no (B, nc, Q, Q, H) tensor in device memory.
//
// Replaces no kernel of the reference package: its SSD is plain jnp
// (src/repro/models/ssm.py: _ssd_chunked), which XLA fuses on the TPU. The
// port's plain version (models/ssm.py: _intra_chunks) writes every per-head
// chunk-local quadratic form, a (B, nc, Q, Q, H) float32 tensor, to device
// memory several times a layer and lets autograd keep some of them; at the
// Mamba2-370M training shapes that stage took half of a train step.
//
// Per (batch, chunk) and head h of group g, with chunk length Q, state
// width N and head width P, the stage computes
//   K[i,j]  = (C·Bᵀ)[i,j] · exp(cum_i − cum_j) · dt_j      (j <= i)
//   y_intra = K·X                                           (Q x P)
//   s_c     = Bᵀ·(w ⊙ X),  w = exp(total − cum)·dt (given)  (N x P)
// and its gradients; dt, cum and w come in as float32 (B, nc, Q, H).
//
// Bound on the H100 SXM at Mamba2-370M's training shapes (B 2, nc 8,
// Q 256, H 32, P 64, N 128, G 1, 48 layers): C·Bᵀ once a group is 0.27
// GFLOP a layer, K·X and the chunk states 4.3 GFLOP each; ~0.43 TFLOP a
// step forward and ~1.3 forward and backward, ~1.3 ms at the 989 TFLOP/s
// bf16 peak (~4 ms with the three-part operands below, ~19 ms on the
// float32 FMA units); ~70 MB a layer forward, ~3.4 GB a step, ~1 ms at
// 3.35 TB/s. So about 5 ms with tensor cores.
//
// Design. Every product is an mma.sync.m16n8k16 (bf16 in, float32
// accumulator) of 64-row tiles, four warps of 16 rows a block, operands in
// shared memory read by ldmatrix (.trans where the contraction runs along
// the stored rows). The Q x Q forms live only in registers: a tile of C·Bᵀ
// is scaled by its decays in the accumulator and fed back as the A operand
// of the next product (the accumulator layout of two n8 tiles is the A
// layout of one k16 step). x, B and C read in bfloat16 are exact in one
// bf16 operand. Every float32 operand (dt, the decays, K, w ⊙ x, dy, ds and
// the head-summed d(C·Bᵀ)) is split into three bf16 parts hi + mid + lo,
// which hold its 24 bits; a product takes the part pairs whose orders sum
// to at most 2 (three products against an exact operand, six against
// another split one), smallest first. A sum over several tiles adds each
// tile's float32 accumulator in float32 (add_to). float32 x, B and C take
// the same split.
//
// Kernels (one launch forward, three backward):
//   fwd     (b·c·h, Q tiles + N chunks): a y_intra row tile, or an N chunk
//           of s_c;
//   bwd_dx  (b·c·h, Q tiles): for a column tile j, U = Σ_i (C·Bᵀ ⊙ L)ᵀ dy_i
//           and T = B_j·ds; dx = dt·U + w·T, ddt = x·U, dw = x·T and
//           dcum = dy·y − dt·(x·U), rowwise (the row and column sums of
//           dK ⊙ K reduce to those two dot products);
//   bwd_ds  (b·c·g, S head slices x (tile pairs j <= i + Q tiles x N
//           chunks)): over a slice of the group's heads, in order, a tile
//           of d(C·Bᵀ) = Σ_h dK_h ⊙ L_h ⊙ dt_j, or of dB's state part
//           Σ_h w_h ⊙ (x_h·ds_hᵀ), into float32 scratch;
//   bwd_dbc (b·c·g, Q tiles x N chunks, twice): dC = dS·B and
//           dB = dSᵀ·C + the state part, dS and the state part summed over
//           the S slices in order.
// The slices (S = 4 where a group's heads allow) give the head sums four
// times the blocks; a group's 32 heads in one block left most of the card
// idle.
// No atomics: every output element has one writer, so a run's bits repeat.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace repro_ssd {
namespace {

using bf16 = __nv_bfloat16;

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int T = 16 * WARPS;     // rows of a tile, and the width of an N or P chunk
constexpr int LD = T + 8;         // shared row pitch: 16 bytes of pad, conflict-free ldmatrix
constexpr int PLANE = T * LD;     // elements of one bf16 part of a tile

struct Args {
  const void* x;   // (B, nc, Q, H, P), p contiguous
  const void* b;   // (B, nc, Q, G, N), n contiguous
  const void* c;
  long long xs[4], bs[4], cs[4];   // batch, chunk, position, head (group) strides
  const float* dt;   // (B, nc, Q, H) contiguous, as cum and w
  const float* cum;
  const float* w;
  float* y;          // (B, nc, Q, H, P)
  float* s;          // (B, nc, H, N, P)
  const float* yin;  // backward: the forward's y, its gradient dy, s's gradient ds
  const float* dy;
  const float* ds;
  void* dx;          // contiguous, x's dtype (db, dc: B's)
  void* db;
  void* dc;
  float* ddt;        // (B, nc, Q, H)
  float* dcum;
  float* dw;
  float* dsg;        // scratch (B, nc, G, S, Qp, Qp): d(C·Bᵀ) by head slice
  float* dst;        // scratch (B, nc, G, S, Qp, N): dB's state part by head slice
  int batch, chunks, q, heads, groups, n, p;
  int slices;        // S: a group's heads in S slices of H / G / S
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_t(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c += a·b, one m16n8k16 tile, bf16 operands, float32 accumulator.
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// Two floats as three bf16 pairs, hi + mid + lo (x0 in the low halves).
// Each remainder is exact in float32, so the parts hold all 24 bits.
__device__ __forceinline__ void split_pair(float x0, float x1, uint32_t (&out)[3]) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  x0 -= __low2float(h);
  x1 -= __high2float(h);
  const __nv_bfloat162 m = __floats2bfloat162_rn(x0, x1);
  x0 -= __low2float(m);
  x1 -= __high2float(m);
  out[0] = bits(h);
  out[1] = bits(m);
  out[2] = bits(__floats2bfloat162_rn(x0, x1));
}

// Both n8 tiles of c0/c1 += A·B over the part pairs (i, j), i + j <= 2,
// the smallest orders first.
template <int PA, int PB>
__device__ __forceinline__ void mma_parts(float (&c0)[4], float (&c1)[4],
                                          const uint32_t (&a)[PA][4],
                                          const uint32_t (&b)[PB][4]) {
#pragma unroll
  for (int s = 2; s >= 0; --s)
#pragma unroll
    for (int i = 0; i < PA; ++i) {
      const int j = s - i;
      if (j >= 0 && j < PB) {
        mma(c0, a[i], b[j][0], b[j][1]);
        mma(c1, a[i], b[j][2], b[j][3]);
      }
    }
}

// acc (this warp's 16 x 64 tile) += A·B over k in [0, 16·ks) and the n8
// tile pairs [0, np2). A: rows m0.. of a tile stored [m][k], or [k][m] if
// AT; B: stored [n][k], or [k][n] if BT. PA, PB parts each, PLANE apart.
template <int PA, int PB, bool AT, bool BT>
__device__ __forceinline__ void gemm(float (&acc)[8][4], const bf16* a, const bf16* b, int m0,
                                     int ks, int np2) {
  const int lane = threadIdx.x & 31, mat = lane >> 3, r = lane & 7;
#pragma unroll
  for (int kc = 0; kc < T / 16; ++kc) {
    if (kc >= ks) break;
    const int k0 = kc * 16;
    uint32_t af[PA][4];
#pragma unroll
    for (int p = 0; p < PA; ++p) {
      if (AT)
        ldsm_t(smem_u32(a + p * PLANE + (k0 + r + (mat >> 1) * 8) * LD + m0 + (mat & 1) * 8),
               af[p]);
      else
        ldsm(smem_u32(a + p * PLANE + (m0 + r + (mat & 1) * 8) * LD + k0 + (mat >> 1) * 8),
             af[p]);
    }
#pragma unroll
    for (int nb = 0; nb < T / 16; ++nb) {
      if (nb < np2) {
        const int n0 = nb * 16;
        uint32_t bf[PB][4];
#pragma unroll
        for (int p = 0; p < PB; ++p) {
          if (BT)
            ldsm_t(smem_u32(b + p * PLANE + (k0 + r + (mat & 1) * 8) * LD + n0 + (mat >> 1) * 8),
                   bf[p]);
          else
            ldsm(smem_u32(b + p * PLANE + (n0 + r + (mat >> 1) * 8) * LD + k0 + (mat & 1) * 8),
                 bf[p]);
        }
        mma_parts<PA, PB>(acc[2 * nb], acc[2 * nb + 1], af, bf);
      }
    }
  }
}

// The warp's 16 x 64 float32 tile s as three-part A fragments, kf[k16 step][part].
__device__ __forceinline__ void to_parts(const float (&s)[8][4], uint32_t (&kf)[T / 16][3][4]) {
#pragma unroll
  for (int kc = 0; kc < T / 16; ++kc) {
    uint32_t p[3];
#pragma unroll
    for (int q = 0; q < 4; ++q) {   // a0..a3: rows g, g + 8 of n8 tiles 2kc, 2kc + 1
      split_pair(s[2 * kc + (q >> 1)][(q & 1) * 2], s[2 * kc + (q >> 1)][(q & 1) * 2 + 1], p);
#pragma unroll
      for (int part = 0; part < 3; ++part) kf[kc][part][q] = p[part];
    }
  }
}

// acc += K·B, K this warp's 16 x 64 tile from to_parts, B stored [k][n].
template <int PB>
__device__ __forceinline__ void gemm_ra(float (&acc)[8][4], const uint32_t (&kf)[T / 16][3][4],
                                        const bf16* b, int np2) {
  const int lane = threadIdx.x & 31, mat = lane >> 3, r = lane & 7;
#pragma unroll
  for (int kc = 0; kc < T / 16; ++kc)
#pragma unroll
    for (int nb = 0; nb < T / 16; ++nb) {
      if (nb < np2) {
        uint32_t bf[PB][4];
#pragma unroll
        for (int p = 0; p < PB; ++p)
          ldsm_t(smem_u32(b + p * PLANE + (kc * 16 + r + (mat & 1) * 8) * LD + nb * 16 +
                          (mat >> 1) * 8),
                 bf[p]);
        mma_parts<3, PB>(acc[2 * nb], acc[2 * nb + 1], kf[kc], bf);
      }
    }
}

// Global reads go through the read-only path (__ldg): nothing a kernel
// reads is written in the same launch, and the compiler may then start a
// thread's reads together instead of each after the last shared store.
__device__ __forceinline__ void load8(const bf16* p, float (&v)[8]) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = __bfloat1622float2(h[k]);
    v[2 * k] = f.x;
    v[2 * k + 1] = f.y;
  }
}
__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
  v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}

// dst, NP parts of a T x LD tile, = src[r·rs + c] for r < rows and
// c < cols (a multiple of 8), summed over src + t·ts for t < terms in
// order, times scale[r] if given; zero elsewhere. One part copies bf16
// data exactly. A thread reads all its pieces before it stores any.
template <int NP, typename E>
__device__ __forceinline__ void stage(bf16* dst, const E* src, long long rs, int rows, int cols,
                                      const float* scale, int terms = 1, long long ts = 0) {
  constexpr int PER = T * (T / 8) / THREADS;   // 8-element pieces a thread
  int off[PER];
  bool in[PER];
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int i = threadIdx.x + k * THREADS, r = i / (T / 8), c = (i % (T / 8)) * 8;
    off[k] = r * LD + c;
    in[k] = r < rows && c < cols;
  }
  if constexpr (NP == 1) {
    static_assert(std::is_same<E, bf16>::value, "one part holds bf16 data only");
    uint4 u[PER];
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int r = off[k] / LD, c = off[k] % LD;
      u[k] = in[k] ? __ldg(reinterpret_cast<const uint4*>(src + r * rs + c))
                   : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int k = 0; k < PER; ++k) *reinterpret_cast<uint4*>(dst + off[k]) = u[k];
  } else {   // float32 is split: two pieces at a time keep the registers down
    constexpr int ROUND = 2;
#pragma unroll
    for (int k0 = 0; k0 < PER; k0 += ROUND) {
      float v[ROUND][8];
#pragma unroll
      for (int kk = 0; kk < ROUND; ++kk) {
        const int k = k0 + kk, r = off[k] / LD, c = off[k] % LD;
        if (in[k]) {
          load8(src + r * rs + c, v[kk]);
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e) v[kk][e] = 0.f;
        }
      }
      for (int t = 1; t < terms; ++t) {
#pragma unroll
        for (int kk = 0; kk < ROUND; ++kk) {
          const int k = k0 + kk, r = off[k] / LD, c = off[k] % LD;
          if (!in[k]) continue;
          float u[8];
          load8(src + t * ts + r * rs + c, u);
#pragma unroll
          for (int e = 0; e < 8; ++e) v[kk][e] += u[e];
        }
      }
#pragma unroll
      for (int kk = 0; kk < ROUND; ++kk) {
        const int k = k0 + kk;
        if (scale != nullptr) {
          const float f = scale[off[k] / LD];
#pragma unroll
          for (int e = 0; e < 8; ++e) v[kk][e] *= f;
        }
        uint32_t parts[3][4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          uint32_t pr[3];
          split_pair(v[kk][2 * e], v[kk][2 * e + 1], pr);
#pragma unroll
          for (int p = 0; p < 3; ++p) parts[p][e] = pr[p];
        }
#pragma unroll
        for (int p = 0; p < NP; ++p)
          *reinterpret_cast<uint4*>(dst + off[k] + p * PLANE) =
              make_uint4(parts[p][0], parts[p][1], parts[p][2], parts[p][3]);
      }
    }
  }
}

// dst[r] = src[r·stride] for r < rows, zero up to T.
__device__ __forceinline__ void stage_vec(float* dst, const float* src, int stride, int rows) {
  const int r = threadIdx.x;
  if (r < T) dst[r] = r < rows ? __ldg(src + static_cast<long long>(r) * stride) : 0.f;
}

// Epilogue reads, one pair at a time (read-only loads here would be
// hoisted together and spill bwd_dx's registers).
__device__ __forceinline__ float2 load2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// Stores rows [0, rows) of the warp's tile acc to out + row·rs + col,
// cols [0, cols), cols a multiple of 16.
template <typename O>
__device__ __forceinline__ void store_tile(O* out, long long rs, const float (&acc)[8][4],
                                           int rows, int cols) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int r2 = 0; r2 < 2; ++r2) {
    const int r = warp * 16 + g + r2 * 8;
    if (r >= rows) continue;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int col = n * 8 + 2 * t4;
      if (col < cols) store2(out + r * rs + col, acc[n][2 * r2], acc[n][2 * r2 + 1]);
    }
  }
}

__device__ __forceinline__ void zero(float (&acc)[8][4]) {
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
}

// acc += t in float32, rounded to nearest. A sum over several tiles takes
// each tile's products in a fresh accumulator t and adds it here: the
// tensor cores' own adds truncate, and ~50 of them into one large sum
// (3 parts x 4 k16 steps x 4 tiles) lose ~5x float32's accuracy.
__device__ __forceinline__ void add_to(float (&acc)[8][4], const float (&t)[8][4]) {
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] += t[n][e];
}

// Decay-weights the warp's 16 x 64 tile of a product in place: entry
// (row r, col c) of the tile whose rows start at position r0 and columns
// at c0 becomes v · exp(vr[r] − vc[c])·f[c] where position r0 + r >= c0 + c
// (ROWS_LATER, rows are i) or c0 + c >= r0 + r (otherwise, rows are j),
// r < rows and c < cols; zero elsewhere. f null reads as 1; the exponent
// is vr − vc for i rows and vc − vr for j rows, so always cum_i − cum_j.
template <bool ROWS_LATER>
__device__ __forceinline__ void decay(float (&s)[8][4], int r0, int c0, int rows, int cols,
                                      const float* vr, const float* vc, const float* f) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = warp * 16 + g + (e >> 1) * 8, c = n * 8 + 2 * t4 + (e & 1);
      const bool seen = ROWS_LATER ? r0 + r >= c0 + c : c0 + c >= r0 + r;
      float v = 0.f;
      if (seen && r < rows && c < cols) {
        const float ex = ROWS_LATER ? vr[r] - vc[c] : vc[c] - vr[r];
        v = s[n][e] * expf(ex);
        if (f != nullptr) v *= f[c];
      }
      s[n][e] = v;
    }
}

// Where a block's (b·c, h or g) data starts.
struct Chunk {
  long long bc;   // b·nc + c
  int bi, ci;
};
__device__ __forceinline__ Chunk chunk_of(const Args& a, long long bc) {
  return {bc, static_cast<int>(bc / a.chunks), static_cast<int>(bc % a.chunks)};
}
template <typename E>
__device__ __forceinline__ const E* at(const void* base, const long long (&st)[4], const Chunk& k,
                                      int hg) {
  return static_cast<const E*>(base) + k.bi * st[0] + k.ci * st[1] + hg * st[3];
}

// Shared memory: parts of tiles A, B and X, then four vectors of T floats.
// fwd and bwd_dx keep a whole C_i (B_j) tile, every N chunk, in A.
__host__ __device__ constexpr size_t smem_bytes(int pa, int pb, int px) {
  return static_cast<size_t>(pa + pb + px) * PLANE * sizeof(bf16) + 4 * T * sizeof(float);
}

template <typename E, int NP>
__global__ void __launch_bounds__(THREADS) fwd_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int nt = (a.q + T - 1) / T, ncn = (a.n + T - 1) / T, H = a.heads;
  bf16* ta = reinterpret_cast<bf16*>(smem);   // C_i: ncn chunks of NP parts
  bf16* tb = ta + ncn * NP * PLANE;
  bf16* tx = tb + NP * PLANE;   // three parts
  float* vi = reinterpret_cast<float*>(tx + 3 * PLANE);
  float* vj = vi + T;
  float* vd = vj + T;

  const int m0 = (threadIdx.x >> 5) * 16;
  const int h = blockIdx.x % H;
  const Chunk k = chunk_of(a, blockIdx.x / H);
  const int grp = h / (H / a.groups);
  const E* x = at<E>(a.x, a.xs, k, h);
  const E* bm = at<E>(a.b, a.bs, k, grp);
  const E* cm = at<E>(a.c, a.cs, k, grp);
  const long long v0 = k.bc * a.q * H + h;   // (q = 0, h) of a (B, nc, Q, H) tensor

  if (static_cast<int>(blockIdx.y) < nt) {   // y_intra, rows of tile it
    const int it = blockIdx.y, i0 = it * T, qi = min(T, a.q - i0);
    stage_vec(vi, a.cum + v0 + static_cast<long long>(i0) * H, H, qi);
    for (int n0 = 0; n0 < a.n; n0 += T)
      stage<NP>(ta + (n0 / T) * NP * PLANE, cm + i0 * a.cs[2] + n0, a.cs[2], qi,
                min(T, a.n - n0), nullptr);
    for (int p0 = 0; p0 < a.p; p0 += T) {
      const int pw = min(T, a.p - p0);
      float yacc[8][4];
      zero(yacc);
      for (int jt = 0; jt <= it; ++jt) {
        const int j0 = jt * T, qj = min(T, a.q - j0);
        float s[8][4];
        zero(s);
        for (int n0 = 0; n0 < a.n; n0 += T) {   // s = C_i·B_jᵀ
          const int nw = min(T, a.n - n0);
          __syncthreads();
          stage<NP>(tb, bm + j0 * a.bs[2] + n0, a.bs[2], qj, nw, nullptr);
          if (n0 == 0) {
            stage_vec(vj, a.cum + v0 + static_cast<long long>(j0) * H, H, qj);
            stage_vec(vd, a.dt + v0 + static_cast<long long>(j0) * H, H, qj);
          }
          __syncthreads();
          gemm<NP, NP, false, false>(s, ta + (n0 / T) * NP * PLANE, tb, m0, nw / 16, T / 16);
        }
        decay<true>(s, i0, j0, qi, qj, vi, vj, vd);   // K
        uint32_t kf[T / 16][3][4];
        to_parts(s, kf);
        __syncthreads();
        stage<NP>(tx, x + j0 * a.xs[2] + p0, a.xs[2], qj, pw, nullptr);
        __syncthreads();
        zero(s);
        gemm_ra<NP>(s, kf, tx, pw / 16);   // y_i += K·X_j
        add_to(yacc, s);
      }
      store_tile(a.y + (v0 + static_cast<long long>(i0) * H) * a.p + p0,
                 static_cast<long long>(H) * a.p, yacc, qi, pw);
    }
  } else {   // s_c, rows n0.. of an N chunk
    const int n0 = (blockIdx.y - nt) * T, nw = min(T, a.n - n0);
    for (int p0 = 0; p0 < a.p; p0 += T) {
      const int pw = min(T, a.p - p0);
      float acc[8][4];
      zero(acc);
      for (int jt = 0; jt < nt; ++jt) {   // acc += B_jᵀ·(w ⊙ X_j)
        const int j0 = jt * T, qj = min(T, a.q - j0);
        __syncthreads();
        stage_vec(vd, a.w + v0 + static_cast<long long>(j0) * H, H, qj);
        __syncthreads();
        stage<NP>(ta, bm + j0 * a.bs[2] + n0, a.bs[2], qj, nw, nullptr);
        stage<3>(tx, x + j0 * a.xs[2] + p0, a.xs[2], qj, pw, vd);
        __syncthreads();
        float t[8][4];
        zero(t);
        gemm<NP, 3, true, true>(t, ta, tx, m0, T / 16, pw / 16);
        add_to(acc, t);
      }
      store_tile(a.s + (static_cast<long long>(blockIdx.x) * a.n + n0) * a.p + p0, a.p, acc, nw,
                 pw);
    }
  }
}

template <typename E, int NP>
__global__ void __launch_bounds__(THREADS, 4) bwd_dx_kernel(Args a) {   // 128 registers
  extern __shared__ __align__(16) unsigned char smem[];
  const int nt = (a.q + T - 1) / T, ncn = (a.n + T - 1) / T, H = a.heads;
  bf16* ta = reinterpret_cast<bf16*>(smem);   // B_j: ncn chunks of NP parts
  bf16* tb = ta + ncn * NP * PLANE;
  bf16* tx = tb + NP * PLANE;   // three parts
  float* vi = reinterpret_cast<float*>(tx + 3 * PLANE);
  float* vj = vi + T;
  float* vd = vj + T;
  float* vw = vd + T;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const int m0 = warp * 16;
  const int h = blockIdx.x % H;
  const Chunk k = chunk_of(a, blockIdx.x / H);
  const int grp = h / (H / a.groups);
  const E* x = at<E>(a.x, a.xs, k, h);
  const E* bm = at<E>(a.b, a.bs, k, grp);
  const E* cm = at<E>(a.c, a.cs, k, grp);
  const long long v0 = k.bc * a.q * H + h;
  const int jt = blockIdx.y, j0 = jt * T, qj = min(T, a.q - j0);
  const long long vj0 = v0 + static_cast<long long>(j0) * H;
  stage_vec(vj, a.cum + vj0, H, qj);
  stage_vec(vd, a.dt + vj0, H, qj);
  stage_vec(vw, a.w + vj0, H, qj);
  for (int n0 = 0; n0 < a.n; n0 += T)
    stage<NP>(ta + (n0 / T) * NP * PLANE, bm + j0 * a.bs[2] + n0, a.bs[2], qj, min(T, a.n - n0),
              nullptr);
  const long long prow = static_cast<long long>(H) * a.p;   // position stride of y, dy, dx

  float xu[2] = {0.f, 0.f}, xt[2] = {0.f, 0.f}, yd[2] = {0.f, 0.f};
  for (int p0 = 0; p0 < a.p; p0 += T) {
    const int pw = min(T, a.p - p0);
    float u[8][4];
    zero(u);
    for (int it = jt; it < nt; ++it) {
      const int i0 = it * T, qi = min(T, a.q - i0);
      float s[8][4];
      zero(s);
      for (int n0 = 0; n0 < a.n; n0 += T) {   // s = (C_i·B_jᵀ)ᵀ = B_j·C_iᵀ
        const int nw = min(T, a.n - n0);
        __syncthreads();
        stage<NP>(tb, cm + i0 * a.cs[2] + n0, a.cs[2], qi, nw, nullptr);
        if (n0 == 0) stage_vec(vi, a.cum + v0 + static_cast<long long>(i0) * H, H, qi);
        __syncthreads();
        gemm<NP, NP, false, false>(s, ta + (n0 / T) * NP * PLANE, tb, m0, nw / 16, T / 16);
      }
      decay<false>(s, j0, i0, qj, qi, vj, vi, nullptr);   // (C·Bᵀ ⊙ L)ᵀ
      uint32_t kf[T / 16][3][4];
      to_parts(s, kf);
      __syncthreads();
      stage<3>(tx, a.dy + (v0 + static_cast<long long>(i0) * H) * a.p + p0, prow, qi, pw,
               nullptr);
      __syncthreads();
      zero(s);
      gemm_ra<3>(s, kf, tx, pw / 16);   // U_j += (C·Bᵀ ⊙ L)ᵀ·dy_i
      add_to(u, s);
    }
    float t[8][4];
    zero(t);
    for (int n0 = 0; n0 < a.n; n0 += T) {   // T_j = B_j·ds
      const int nw = min(T, a.n - n0);
      __syncthreads();
      stage<3>(tx, a.ds + (static_cast<long long>(blockIdx.x) * a.n + n0) * a.p + p0, a.p, nw, pw,
               nullptr);
      __syncthreads();
      float tt[8][4];
      zero(tt);
      gemm<NP, 3, false, true>(tt, ta + (n0 / T) * NP * PLANE, tx, m0, nw / 16, pw / 16);
      add_to(t, tt);
    }
    E* dx = static_cast<E*>(a.dx);
#pragma unroll
    for (int r2 = 0; r2 < 2; ++r2) {
      const int r = m0 + g + r2 * 8;
      if (r >= qj) continue;
      const long long row = (vj0 + static_cast<long long>(r) * H) * a.p + p0;
      const E* xr = x + (j0 + r) * a.xs[2] + p0;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int col = n * 8 + 2 * t4;
        if (col >= pw) continue;
        const float2 xv = load2(xr + col), dyv = load2(a.dy + row + col),
                     yv = load2(a.yin + row + col);
        const float u0 = u[n][2 * r2], u1 = u[n][2 * r2 + 1];
        const float t0 = t[n][2 * r2], t1 = t[n][2 * r2 + 1];
        xu[r2] += xv.x * u0 + xv.y * u1;
        xt[r2] += xv.x * t0 + xv.y * t1;
        yd[r2] += dyv.x * yv.x + dyv.y * yv.y;
        store2(dx + row + col, vd[r] * u0 + vw[r] * t0, vd[r] * u1 + vw[r] * t1);
      }
    }
  }
#pragma unroll
  for (int r2 = 0; r2 < 2; ++r2)
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      xu[r2] += __shfl_xor_sync(0xffffffffu, xu[r2], o);
      xt[r2] += __shfl_xor_sync(0xffffffffu, xt[r2], o);
      yd[r2] += __shfl_xor_sync(0xffffffffu, yd[r2], o);
    }
  if (t4 == 0) {
#pragma unroll
    for (int r2 = 0; r2 < 2; ++r2) {
      const int r = m0 + g + r2 * 8;
      if (r >= qj) continue;
      const long long idx = vj0 + static_cast<long long>(r) * H;
      a.ddt[idx] = xu[r2];
      a.dw[idx] = xt[r2];
      a.dcum[idx] = yd[r2] - vd[r] * xu[r2];
    }
  }
}

template <typename E, int NP>
__global__ void __launch_bounds__(THREADS) bwd_ds_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ta = reinterpret_cast<bf16*>(smem);   // three parts
  bf16* tb = ta + 3 * PLANE;
  float* vi = reinterpret_cast<float*>(tb + NP * PLANE);
  float* vj = vi + T;
  float* vd = vj + T;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2;
  const int m0 = warp * 16;
  const int G = a.groups, H = a.heads, S = a.slices, RS = H / G / S;
  const int nt = (a.q + T - 1) / T, ncn = (a.n + T - 1) / T, qp = nt * T;
  const int grp = blockIdx.x % G;
  const Chunk k = chunk_of(a, blockIdx.x / G);
  const int slice = blockIdx.y % S, job = blockIdx.y / S;
  const int h0 = grp * (H / G) + slice * RS;                          // the slice's heads, in order
  const long long part = static_cast<long long>(blockIdx.x) * S + slice;   // (b·c·g, slice)
  const long long prow = static_cast<long long>(H) * a.p;

  float d[8][4];
  zero(d);
  if (job < nt * (nt + 1) / 2) {   // d(C·Bᵀ) tile (it, jt), jt <= it: Σ_h dK_h ⊙ L_h ⊙ dt_j
    int it = 0;
    while ((it + 1) * (it + 2) / 2 <= job) ++it;
    const int jt = job - it * (it + 1) / 2;
    const int i0 = it * T, qi = min(T, a.q - i0), j0 = jt * T, qj = min(T, a.q - j0);
    for (int h = h0; h < h0 + RS; ++h) {
      const E* x = at<E>(a.x, a.xs, k, h);
      const long long v0 = k.bc * a.q * H + h;
      float dk[8][4];
      zero(dk);
      for (int p0 = 0; p0 < a.p; p0 += T) {   // dK = dy_i·X_jᵀ
        const int pw = min(T, a.p - p0);
        __syncthreads();
        stage<3>(ta, a.dy + (v0 + static_cast<long long>(i0) * H) * a.p + p0, prow, qi, pw,
                 nullptr);
        stage<NP>(tb, x + j0 * a.xs[2] + p0, a.xs[2], qj, pw, nullptr);
        if (p0 == 0) {
          stage_vec(vi, a.cum + v0 + static_cast<long long>(i0) * H, H, qi);
          stage_vec(vj, a.cum + v0 + static_cast<long long>(j0) * H, H, qj);
          stage_vec(vd, a.dt + v0 + static_cast<long long>(j0) * H, H, qj);
        }
        __syncthreads();
        gemm<3, NP, false, false>(dk, ta, tb, m0, pw / 16, T / 16);
      }
      decay<true>(dk, i0, j0, qi, qj, vi, vj, vd);
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) d[n][e] += dk[n][e];
    }
    store_tile(a.dsg + (part * qp + i0) * qp + j0, qp, d, T, T);
  } else {   // dB's state part, rows of tile jt, an N chunk: Σ_h w_h ⊙ (X_h·ds_hᵀ)
    const int rest = job - nt * (nt + 1) / 2;
    const int n0 = (rest % ncn) * T, nw = min(T, a.n - n0);
    const int r0 = (rest / ncn) * T, rows = min(T, a.q - r0);
    for (int h = h0; h < h0 + RS; ++h) {
      const E* x = at<E>(a.x, a.xs, k, h);
      const long long v0 = k.bc * a.q * H + h;
      float t[8][4];
      zero(t);
      for (int p0 = 0; p0 < a.p; p0 += T) {
        const int pw = min(T, a.p - p0);
        __syncthreads();
        stage<3>(ta, a.ds + ((k.bc * H + h) * a.n + n0) * static_cast<long long>(a.p) + p0, a.p,
                 nw, pw, nullptr);
        stage<NP>(tb, x + r0 * a.xs[2] + p0, a.xs[2], rows, pw, nullptr);
        if (p0 == 0) stage_vec(vd, a.w + v0 + static_cast<long long>(r0) * H, H, rows);
        __syncthreads();
        gemm<NP, 3, false, false>(t, tb, ta, m0, pw / 16, nw / 16);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float f = vd[m0 + g + (e >> 1) * 8];
#pragma unroll
        for (int n = 0; n < 8; ++n) d[n][e] += f * t[n][e];
      }
    }
    store_tile(a.dst + (part * qp + r0) * a.n + n0, a.n, d, rows, nw);
  }
}

template <typename E, int NP>
__global__ void __launch_bounds__(THREADS) bwd_dbc_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ta = reinterpret_cast<bf16*>(smem);   // three parts
  bf16* tb = ta + 3 * PLANE;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const int m0 = warp * 16;
  const int G = a.groups, S = a.slices;
  const int nt = (a.q + T - 1) / T, ncn = (a.n + T - 1) / T, qp = nt * T;
  const int grp = blockIdx.x % G;
  const Chunk k = chunk_of(a, blockIdx.x / G);
  const bool is_db = static_cast<int>(blockIdx.y) >= nt * ncn;
  const int rest = blockIdx.y % (nt * ncn), tile = rest / ncn;
  const int n0 = (rest % ncn) * T, nw = min(T, a.n - n0);
  const int r0 = tile * T, rows = min(T, a.q - r0);
  const E* bm = at<E>(a.b, a.bs, k, grp);
  const E* cm = at<E>(a.c, a.cs, k, grp);
  const long long part0 = static_cast<long long>(blockIdx.x) * S;   // slice 0 of (b·c·g)
  const long long ts = static_cast<long long>(qp) * qp;              // dS slice stride
  const float* dsg = a.dsg + part0 * ts;
  // dB and dC (B, nc, Q, G, N), contiguous
  E* out = static_cast<E*>(is_db ? a.db : a.dc) +
           ((k.bc * a.q + r0) * G + grp) * static_cast<long long>(a.n) + n0;

  float acc[8][4];
  zero(acc);
  if (!is_db) {   // dC_i = Σ_j dS[i][j]·B_j, dS the slices' sum
    for (int jt = 0; jt <= tile; ++jt) {
      const int j0 = jt * T, qj = min(T, a.q - j0);
      __syncthreads();
      stage<3>(ta, dsg + static_cast<long long>(r0) * qp + j0, qp, T, T, nullptr, S, ts);
      stage<NP>(tb, bm + j0 * a.bs[2] + n0, a.bs[2], qj, nw, nullptr);
      __syncthreads();
      float t[8][4];
      zero(t);
      gemm<3, NP, false, true>(t, ta, tb, m0, T / 16, nw / 16);
      add_to(acc, t);
    }
  } else {   // dB_j = Σ_i dS[i][j]ᵀ·C_i + the slices' state parts, in order
    for (int it = tile; it < nt; ++it) {
      const int i0 = it * T, qi = min(T, a.q - i0);
      __syncthreads();
      stage<3>(ta, dsg + static_cast<long long>(i0) * qp + r0, qp, T, T, nullptr, S, ts);
      stage<NP>(tb, cm + i0 * a.cs[2] + n0, a.cs[2], qi, nw, nullptr);
      __syncthreads();
      float t[8][4];
      zero(t);
      gemm<3, NP, true, true>(t, ta, tb, m0, T / 16, nw / 16);
      add_to(acc, t);
    }
    const float* st = a.dst + (part0 * qp + r0) * a.n + n0;
    const long long sst = static_cast<long long>(qp) * a.n;   // state slice stride
#pragma unroll
    for (int r2 = 0; r2 < 2; ++r2) {
      const int r = m0 + g + r2 * 8;
      if (r >= rows) continue;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int col = n * 8 + 2 * t4;
        if (col >= nw) continue;
        float2 v = load2(st + static_cast<long long>(r) * a.n + col);
        for (int sl = 1; sl < S; ++sl) {
          const float2 u = load2(st + sl * sst + static_cast<long long>(r) * a.n + col);
          v.x += u.x;
          v.y += u.y;
        }
        acc[n][2 * r2] += v.x;
        acc[n][2 * r2 + 1] += v.y;
      }
    }
  }
  store_tile(out, static_cast<long long>(G) * a.n, acc, rows, nw);
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

// Rows read as 16-byte pieces: aligned base, and every stride of a dim
// longer than 1 a multiple of 16 bytes.
template <typename E>
bool rows16(const void* p, const long long (&st)[4], const int (&sizes)[4]) {
  constexpr long long per = 16 / sizeof(E);
  if (!aligned16(p)) return false;
  for (int d = 0; d < 4; ++d)
    if (sizes[d] > 1 && st[d] % per != 0) return false;
  return true;
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename E>
bool readable(const Args& a) {
  const int xsz[4] = {a.batch, a.chunks, a.q, a.heads};
  const int gsz[4] = {a.batch, a.chunks, a.q, a.groups};
  return rows16<E>(a.x, a.xs, xsz) && rows16<E>(a.b, a.bs, gsz) && rows16<E>(a.c, a.cs, gsz);
}

// The most shared memory a launch asks for (N = 256) is allowed once.
template <typename E, int NP>
cudaError_t forward(const Args& a, cudaStream_t st) {
  if (!readable<E>(a)) return cudaErrorInvalidValue;
  const int nt = (a.q + T - 1) / T, ncn = (a.n + T - 1) / T;
  static const cudaError_t attr = allow_smem(fwd_kernel<E, NP>, smem_bytes(4 * NP, NP, 3));
  if (attr != cudaSuccess) return attr;
  fwd_kernel<E, NP><<<dim3(a.batch * a.chunks * a.heads, nt + ncn), THREADS,
                      smem_bytes(ncn * NP, NP, 3), st>>>(a);
  return cudaGetLastError();
}

template <typename E, int NP>
cudaError_t backward(const Args& a, cudaStream_t st) {
  if (!readable<E>(a)) return cudaErrorInvalidValue;
  const int nt = (a.q + T - 1) / T, ncn = (a.n + T - 1) / T;
  const int bc = a.batch * a.chunks;
  constexpr size_t ds_bytes = smem_bytes(3, NP, 0), dbc_bytes = smem_bytes(3, NP, 0);
  static const cudaError_t attr = [] {
    cudaError_t e = allow_smem(bwd_dx_kernel<E, NP>, smem_bytes(4 * NP, NP, 3));
    if (e == cudaSuccess) e = allow_smem(bwd_ds_kernel<E, NP>, smem_bytes(3, NP, 0));
    if (e == cudaSuccess) e = allow_smem(bwd_dbc_kernel<E, NP>, smem_bytes(3, NP, 0));
    return e;
  }();
  if (attr != cudaSuccess) return attr;
  bwd_dx_kernel<E, NP><<<dim3(bc * a.heads, nt), THREADS, smem_bytes(ncn * NP, NP, 3), st>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  bwd_ds_kernel<E, NP><<<dim3(bc * a.groups, a.slices * (nt * (nt + 1) / 2 + nt * ncn)),
                         THREADS, ds_bytes, st>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  bwd_dbc_kernel<E, NP><<<dim3(bc * a.groups, 2 * nt * ncn), THREADS, dbc_bytes, st>>>(a);
  return cudaGetLastError();
}

bool shapes_ok(const Args& a) {
  return a.batch > 0 && a.chunks > 0 && a.q > 0 && a.heads > 0 && a.groups > 0 &&
         a.heads % a.groups == 0 && a.n > 0 && a.n % 16 == 0 && a.n <= 256 && a.p > 0 &&
         a.p % 16 == 0 && a.p <= 256;
}

Args make_args(const void* x, const long long* xs, const void* b, const long long* bs,
               const void* c, const long long* cs, const float* dt, const float* cum,
               const float* w, int batch, int chunks, int q, int heads, int groups, int n,
               int p) {
  Args a{};
  a.x = x;
  a.b = b;
  a.c = c;
  for (int d = 0; d < 4; ++d) a.xs[d] = xs[d], a.bs[d] = bs[d], a.cs[d] = cs[d];
  a.dt = dt;
  a.cum = cum;
  a.w = w;
  a.batch = batch, a.chunks = chunks, a.q = q, a.heads = heads, a.groups = groups;
  a.n = n, a.p = p;
  return a;
}

}  // namespace
}  // namespace repro_ssd

using repro_ssd::Args;

// dtype 0: float32 x, B, C (three parts each); 1: bfloat16 (exact, one
// part). Strides are in elements: batch, chunk, position, head (group).
extern "C" int repro_ssd_chunk_fwd(int dtype, const void* x, long long xs0, long long xs1,
                                   long long xs2, long long xs3, const void* b, long long bs0,
                                   long long bs1, long long bs2, long long bs3, const void* c,
                                   long long cs0, long long cs1, long long cs2, long long cs3,
                                   const float* dt, const float* cum, const float* w, float* y,
                                   float* s, int batch, int chunks, int q, int heads, int groups,
                                   int n, int p, void* stream) {
  const long long xs[4] = {xs0, xs1, xs2, xs3}, bs[4] = {bs0, bs1, bs2, bs3},
                  cs[4] = {cs0, cs1, cs2, cs3};
  Args a = repro_ssd::make_args(x, xs, b, bs, c, cs, dt, cum, w, batch, chunks, q, heads, groups,
                                n, p);
  if (!repro_ssd::shapes_ok(a)) return static_cast<int>(cudaErrorInvalidValue);
  a.y = y;
  a.s = s;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return static_cast<int>(repro_ssd::forward<__nv_bfloat16, 1>(a, st));
  if (dtype == 0) return static_cast<int>(repro_ssd::forward<float, 3>(a, st));
  return static_cast<int>(cudaErrorInvalidValue);
}

// dsg, dst: float32 scratch of B·nc·G·S·Qp·Qp and B·nc·G·S·Qp·N floats,
// Qp = q rounded up to 64, S = slices, which divides the heads of a group.
extern "C" int repro_ssd_chunk_bwd(int dtype, const void* x, long long xs0, long long xs1,
                                   long long xs2, long long xs3, const void* b, long long bs0,
                                   long long bs1, long long bs2, long long bs3, const void* c,
                                   long long cs0, long long cs1, long long cs2, long long cs3,
                                   const float* dt, const float* cum, const float* w,
                                   const float* y, const float* dy, const float* ds, void* dx,
                                   void* db, void* dc, float* ddt, float* dcum, float* dw,
                                   float* dsg, float* dst, int batch, int chunks, int q,
                                   int heads, int groups, int n, int p, int slices,
                                   void* stream) {
  const long long xs[4] = {xs0, xs1, xs2, xs3}, bs[4] = {bs0, bs1, bs2, bs3},
                  cs[4] = {cs0, cs1, cs2, cs3};
  Args a = repro_ssd::make_args(x, xs, b, bs, c, cs, dt, cum, w, batch, chunks, q, heads, groups,
                                n, p);
  if (!repro_ssd::shapes_ok(a) || slices < 1 || (heads / groups) % slices != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  a.slices = slices;
  a.dst = dst;
  a.yin = y;
  a.dy = dy;
  a.ds = ds;
  a.dx = dx;
  a.db = db;
  a.dc = dc;
  a.ddt = ddt;
  a.dcum = dcum;
  a.dw = dw;
  a.dsg = dsg;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return static_cast<int>(repro_ssd::backward<__nv_bfloat16, 1>(a, st));
  if (dtype == 0) return static_cast<int>(repro_ssd::backward<float, 3>(a, st));
  return static_cast<int>(cudaErrorInvalidValue);
}
