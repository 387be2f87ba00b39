// Arguments of the flash-attention kernels (flash_attention.cu: float32 on
// the CUDA cores; flash_attention_tc.cu: bfloat16 on the tensor cores).
#pragma once

#include <cuda_runtime.h>

namespace repro_flash {

// Element strides of a (B, H, S, D) view.
struct Strides {
  long long b, h, s, d;
};

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  Strides sq, sk, sv, so;
  int heads, kv_heads, seq;
  float scale, softcap;
  int causal, window;
};

// bfloat16 attention on the tensor cores, every head_dim of the wrapper's
// HEAD_DIMS; cudaErrorInvalidValue for another head_dim or for operands the
// kernel cannot read in place (see flash_attention_tc.cu).
cudaError_t flash_bf16_tc(int head_dim, const Args& a, int batch, cudaStream_t st);

}  // namespace repro_flash
