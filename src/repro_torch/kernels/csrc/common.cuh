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

// max that lets NaN win, like torch.amax and jnp.max
__device__ __forceinline__ float nan_max(float m, float v) {
  return (v > m || v != v) ? v : m;
}

// NaN-propagating max of `v` over the whole block, returned to every
// thread; `smem` holds one float per warp. Safe to call repeatedly.
__device__ __forceinline__ float block_nan_max(float v, float* smem) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = nan_max(v, __shfl_xor_sync(0xffffffffu, v, o));
  __syncthreads();  // every warp is done reading smem from an earlier call
  if ((threadIdx.x & 31) == 0) smem[threadIdx.x >> 5] = v;
  __syncthreads();
  float m = smem[0];
  for (int w = 1; w < (int)(blockDim.x >> 5); ++w) m = nan_max(m, smem[w]);
  return m;
}

constexpr int kThreads = 256;
// enough blocks to fill 132 SMs many times over; grid-stride loops cover the rest
constexpr int64_t kMaxBlocks = 132 * 32;

inline int64_t grid_for(int64_t n) {
  int64_t blocks = (n + kThreads - 1) / kThreads;
  return blocks < kMaxBlocks ? blocks : kMaxBlocks;
}

// kernels that give one block to each row: rows past this many are walked
// by a grid-stride loop
constexpr int64_t kMaxRowBlocks = int64_t(1) << 20;

inline unsigned row_grid(int64_t rows) {
  return (unsigned)(rows < kMaxRowBlocks ? rows : kMaxRowBlocks);
}

}  // namespace repro_torch
