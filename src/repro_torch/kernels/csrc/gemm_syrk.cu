// OUT = tril((A·B)(A·B)ᵀ) in IEEE float32 on Hopper (sm_90a), without
// writing the intermediate M1 = A·B to device memory.
//
// Replaces: src/repro/kernels/chain_gemm.py:gemm_syrk_pallas
// (_gemm_syrk_kernel), the TPU kernel that runs SYRK's triangular grid of
// 128x128 output blocks and, in every program, rebuilds both bm x L f32
// M1 row panels it contracts in VMEM (about m/128 times the GEMM's flops
// in recompute), falling back to syrk(gemm(a, b)) above 32 MiB of VMEM.
//
// Bound on the H100 SXM: compute. The paper charges the pair 2mkl (gemm)
// + (m+1)ml (syrk) flops on 4(mk + kl + m²) bytes; 1200·400·800 is
// 0.768 + 1.153 = 1.921 GFLOP, ~29 us at 67 TFLOP/s FP32, against
// 8.96 MB, ~2.7 us at 3.35 TB/s.
//
// Design: an L-split, as in chain_gemm.cu. A 64 x m panel of M1 does not
// fit a block's 227 KB at the paper's sizes (64 x 1200 f32 is 307 KB) and
// blocks share nothing, so block (l-chunk p, row tile i) works on one
// 64-wide column chunk of M1: it builds its own piece M1[i, p] =
// A[i, :]·B[:, p] once into shared memory, then for every j < i builds
// M1[j, p] into a second buffer (j = i reuses the first), and adds
// M1[i, p]·M1[j, p]ᵀ into OUT[i, j] with float32 atomics, above the
// diagonal masked away when j = i. The output is zeroed first by
// cudaMemsetAsync inside this entry point, and so inside the kernel's
// time; its strict upper triangle is never touched again.
//
// The price is recompute: every block rebuilds the i pieces of rows
// above its own, so the GEMM part runs mt(mt+1)/2 times per chunk instead
// of mt times (mt = ceil(m/64)). At 1200·400·800 the kernel executes
// about 8.1 GFLOP of M1 pieces and 1.2 GFLOP of products, 9.3 GFLOP in
// all: 4.9x the paper's count, the same order as the TPU kernel's
// recompute. Shared memory per block is fixed (43.5 KB), so there is no
// size bound and no fallback. Rows run from the bottom of the grid up:
// the blocks of the last row tiles rebuild the most pieces, and launching
// them first evens out the tail. The atomics make the summation order
// over l-chunks vary from run to run, at float32 rounding level.
#include "tile.cuh"

using namespace repro;

static_assert(BM == BN, "gemm_syrk tiles are square");

// A 64x64 piece of M1 in shared memory, indexed by global (row, l).
using Piece = float[BM][BN + PAD];

// M1[i, p] as the A operand: A(r, l) = piece[r - row0][l - l0].
struct PieceA {
  const Piece* p;
  int row0, l0;
  __device__ __forceinline__ float at(int r, int l) const { return (*p)[r - row0][l - l0]; }
  __device__ __forceinline__ bool k_fastest(int, int) const { return true; }
};

// M1[j, p]ᵀ as the B operand: B(l, c) = piece[c - col0][l - l0]. Threads
// walk l (the piece's rows are contiguous in l), which keeps the shared
// memory reads free of bank conflicts.
struct PieceBT {
  const Piece* p;
  int col0, l0;
  __device__ __forceinline__ float at(int l, int c) const { return (*p)[c - col0][l - l0]; }
  __device__ __forceinline__ bool n_fastest(int, int) const { return false; }
};

__device__ __forceinline__ void zero(float (&acc)[TM][TN]) {
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
}

// piece = A[row0:row0+64, :]·B[:, l0:l0+64], zero outside m x l.
__device__ __forceinline__ void build_piece(const View& a, const View& b, int row0,
                                            int l0, int k, Slabs& sm, Piece& piece,
                                            float (&acc)[TM][TN]) {
  zero(acc);
  accumulate_tile(DenseA{a}, DenseB{b}, row0, l0, 0, k, sm, acc);
  __syncthreads();   // every thread is done reading the piece's last use
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) piece[tile_row(i)][tile_col(j)] = acc[i][j];
  __syncthreads();   // piece complete before any thread reads it
}

__global__ void __launch_bounds__(THREADS)
gemm_syrk_kernel(View a, View b, float* out, int m, int k, int l) {
  __shared__ Slabs sm;
  __shared__ __align__(16) Piece mi;
  __shared__ __align__(16) Piece mj;
  const int bi = gridDim.y - 1 - blockIdx.y;
  const int row0 = bi * BM;
  const int l0 = blockIdx.x * BN;
  const int l1 = min(l0 + BN, l);

  float acc[TM][TN];
  build_piece(a, b, row0, l0, k, sm, mi, acc);
  const PieceA lhs{&mi, row0, l0};
  for (int bj = 0; bj <= bi; ++bj) {
    const int col0 = bj * BM;
    if (bj != bi) build_piece(a, b, col0, l0, k, sm, mj, acc);
    const PieceBT rhs{bj == bi ? &mi : &mj, col0, l0};
    zero(acc);
    accumulate_tile(lhs, rhs, row0, col0, l0, l1, sm, acc);
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int r = row0 + tile_row(i);
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int c = col0 + tile_col(j);
        if (r < m && c <= r) atomicAdd(out + static_cast<long long>(r) * m + c, acc[i][j]);
      }
    }
  }
}

// out (m x m, row-major, contiguous) = tril((a (m x k) · b (k x l)) ·
// (a · b)ᵀ), a and b strided.
extern "C" int repro_gemm_syrk_f32(const float* a, long long sa0, long long sa1,
                                   const float* b, long long sb0, long long sb1,
                                   float* out, int m, int k, int l, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(out, 0, sizeof(float) * static_cast<size_t>(m) * m, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (l == 0) return static_cast<int>(cudaGetLastError());
  const dim3 grid(cdiv(l, BN), cdiv(m, BM));
  gemm_syrk_kernel<<<grid, THREADS, 0, st>>>(View{a, sa0, sa1, m, k}, View{b, sb0, sb1, k, l},
                                             out, m, k, l);
  return static_cast<int>(cudaGetLastError());
}
