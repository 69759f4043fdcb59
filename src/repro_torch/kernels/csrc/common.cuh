// Shared helpers of the port's kernels: f32 <-> storage-type conversions.
//
// Every kernel computes in f32 and stores in the tensor's type; the bf16
// store rounds to nearest even (__float2bfloat16_rn), as PyTorch's
// `.to(torch.bfloat16)` and JAX's `astype(bfloat16)` do.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

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

constexpr int kThreads = 256;

// kernels that give one block to each row: rows past this many are walked
// by a grid-stride loop
constexpr int64_t kMaxRowBlocks = int64_t(1) << 20;

inline unsigned row_grid(int64_t rows) {
  return (unsigned)(rows < kMaxRowBlocks ? rows : kMaxRowBlocks);
}

// flat kernels: one block for each kThreads * per_thread units, with a
// grid-stride loop past 2^20 blocks. A grid of many short blocks leaves no
// partly filled last wave, as a small capped grid walking a large array
// would.
inline unsigned flat_grid(int64_t units, int per_thread) {
  const int64_t per_block = int64_t(kThreads) * per_thread;
  const int64_t blocks = (units + per_block - 1) / per_block;
  return (unsigned)(blocks < kMaxRowBlocks ? blocks : kMaxRowBlocks);
}

__device__ __forceinline__ uint32_t mul_hi(uint32_t a, uint32_t b) { return __umulhi(a, b); }
__device__ __forceinline__ uint64_t mul_hi(uint64_t a, uint64_t b) { return __umul64hi(a, b); }

// n / d for a divisor fixed at launch, as one high multiply and a shift
// (Granlund and Montgomery's round-up method): with l = ceil(log2 d) and
// m = ceil(2^(B - 1 + l) / d), which fits B bits, n / d = mulhi(n, m) >> (l - 1)
// exactly for every n < 2^(B - 1), B the width of I. Flat kernels use it to
// split an index into its coordinates without a division instruction.
template <typename I>
struct Divider {
  I d, m;
  int shift;
  __device__ __forceinline__ I div(I n) const {
    return d == 1 ? n : mul_hi(n, m) >> shift;
  }
};

template <typename I>
inline Divider<I> make_divider(I d) {
  constexpr int kBits = 8 * sizeof(I);
  int l = 0;
  while ((uint64_t(1) << l) < (uint64_t)d) ++l;
  // m = ceil(2^(kBits - 1 + l) / d) by long division of a one and zeros
  uint64_t q = 0, r = 0;
  for (int bit = kBits - 1 + l; bit >= 0; --bit) {
    r = 2 * r + (bit == kBits - 1 + l ? 1 : 0);
    q = 2 * q + (r >= (uint64_t)d ? 1 : 0);
    if (r >= (uint64_t)d) r -= d;
  }
  if (r) ++q;
  return Divider<I>{d, (I)q, l > 0 ? l - 1 : 0};
}

// flat kernels index in 32 bits while every index stays below 2^31
constexpr int64_t kIndex32 = int64_t(1) << 31;

// A lane of V values of T moves as one load or store of V * sizeof(T)
// bytes (16 at most); it converts to V floats and back.
template <int Bytes> struct RawOf;
template <> struct RawOf<16> { using type = uint4; };
template <> struct RawOf<8> { using type = uint2; };
template <> struct RawOf<4> { using type = uint32_t; };
template <> struct RawOf<2> { using type = uint16_t; };
template <typename T, int V>
using Lane = typename RawOf<V * (int)sizeof(T)>::type;

template <typename T, int V>
__device__ __forceinline__ void lane_to_f32(Lane<T, V> raw, float (&f)[V]) {
  T e[V];
  memcpy(e, &raw, sizeof(raw));
#pragma unroll
  for (int j = 0; j < V; ++j) f[j] = to_f32(e[j]);
}

template <typename T, int V>
__device__ __forceinline__ Lane<T, V> lane_from_f32(const float (&f)[V]) {
  T e[V];
#pragma unroll
  for (int j = 0; j < V; ++j) e[j] = from_f32<T>(f[j]);
  Lane<T, V> raw;
  memcpy(&raw, e, sizeof(raw));
  return raw;
}

}  // namespace repro_torch
