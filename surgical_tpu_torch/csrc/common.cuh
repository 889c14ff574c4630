// Shared device helpers for the hand-written Hopper kernels (sm_90a).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

#define FULL_MASK 0xffffffffu

// Every LayerNorm of the fused MiT graph uses eps 1e-6 and the biased
// variance (surgical_tpu/kernels/mit_block.py::_layernorm).
constexpr float LN_EPS = 1e-6f;

__device__ __forceinline__ float bf2f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ bf16 f2bf(float v) { return __float2bfloat16(v); }

// tanh-form GELU, as jax.nn.gelu(approximate=True) computes it.
__device__ __forceinline__ float gelu_tanh(float x) {
  const float c = 0.7978845608028654f;  // sqrt(2 / pi)
  return 0.5f * x * (1.f + tanhf(c * (x + 0.044715f * x * x * x)));
}

// Its derivative, in the order of mit_block.py::_gelu_tanh_grad.
__device__ __forceinline__ float gelu_tanh_grad(float x) {
  const float c = 0.7978845608028654f;
  const float t = tanhf(c * (x + 0.044715f * x * x * x));
  const float dinner = c * (1.f + 0.134145f * x * x);  // 3 * 0.044715
  return 0.5f * (1.f + t) + 0.5f * x * (1.f - t * t) * dinner;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL_MASK, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL_MASK, v, o));
  return v;
}

// 8 bf16 values move as one 16-byte word: callers guarantee 16-byte
// alignment (row strides and column offsets are multiples of 8).
__device__ __forceinline__ uint4 load8(const bf16* p) {
  return *reinterpret_cast<const uint4*>(p);
}
__device__ __forceinline__ void store8(bf16* p, uint4 v) {
  *reinterpret_cast<uint4*>(p) = v;
}
__device__ __forceinline__ bf16* lanes8(uint4& v) { return reinterpret_cast<bf16*>(&v); }
