// Shared helpers of the port's kernels: f32 <-> storage-type conversions.
//
// Every kernel computes in f32 and stores in the tensor's type; the bf16
// store rounds to nearest even (__float2bfloat16_rn), as PyTorch's
// `.to(torch.bfloat16)` and JAX's `astype(bfloat16)` do.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro_torch {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

constexpr int kThreads = 256;
// enough blocks to fill 132 SMs many times over; grid-stride loops cover the rest
constexpr int64_t kMaxBlocks = 132 * 32;

inline int64_t grid_for(int64_t n) {
  int64_t blocks = (n + kThreads - 1) / kThreads;
  return blocks < kMaxBlocks ? blocks : kMaxBlocks;
}

}  // namespace repro_torch
