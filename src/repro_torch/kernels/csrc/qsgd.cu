// Blockwise QSGD: quantize and dequantize each 1024-element tile by its own
// max-abs scale, with stochastic rounding from uniforms given as an input.
//
// Replaces the TPU kernel src/repro/kernels/qsgd.py · qsgd_quantize
// (_qsgd_kernel, pl.pallas_call at :50). Per tile:
//   scale = max|x| + 1e-30,  y = |x| / scale * s,  q = floor(y) + [u < y - floor(y)]
//   out   = (sign(x) * q) * (scale / s)
// The tile of 1024 is part of what the operator computes (the span of one
// scale), not a tiling choice, so it stays.
//
// Bound on the H100: bytes. x and u are read once and the output written
// once, (4 + 4 + 4) bytes an f32 element (8 a bf16 one), against about ten
// f32 operations, far below the card's ~20 operations per byte balance
// point. At the simulator's shape (20 tiles) the bound is 0.07 us and a
// launch's fixed cost is the floor.
//
// Design: one block of 256 threads per tile, each thread holding 4
// consecutive elements in registers. A thread issues ALL its loads first,
// x as one 16-byte (f32) or 8-byte (bf16) load and u as one 16-byte load,
// so a block pays one device-memory round trip, not two dependent ones (x,
// then u after the reduction). The tile max is an unsigned max of |x|'s
// bits, one warp-wide instruction, then a max over the 8 warps' partials
// read back from shared memory in two 16-byte loads; the elements never
// leave registers between the reduction and the store, which is one 16-
// (f32) or 8-byte (bf16) store a thread. Where x, u or out lies off that
// grid (a view at an element offset), the wrapper picks the scalar-lane
// variant: the same 4 elements a thread strided by the block (each load
// coalesced across it), still all loaded before the reduction. The
// association of the reference is kept (|x| / scale, then * s; sign * q,
// then * (scale / s)), divisions are IEEE (__fdiv_rn, no fast math, no
// contraction) and sign(0) = 0. The max propagates NaN like torch.amax
// (an unsigned max of the bits of |x| lets every NaN win).
// The uniforms are an input, so the kernel and its plain version draw on
// the same numbers: there is no random generator in the kernel.
#include "common.cuh"

namespace repro_torch {

constexpr int kTile = 1024;
constexpr int kPerThread = kTile / kThreads;  // 4

// V = kPerThread: one lane of 4 consecutive values a thread; V = 1: 4
// values strided by the block, one at a time
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
qsgd_kernel(const T* __restrict__ x, const float* __restrict__ u,
            T* __restrict__ out, float levels) {
  static_assert(V == 1 || V == kPerThread, "a lane is one value or four");
  static_assert(kThreads == 256, "the tile max reads 8 warps' partials");
  __shared__ __align__(16) uint32_t warp_max[kThreads / 32];
  const int64_t tile0 = (int64_t)blockIdx.x * kTile;
  float xv[kPerThread], uv[kPerThread];
  if constexpr (V == kPerThread) {
    const int64_t i = tile0 + kPerThread * threadIdx.x;
    lane_to_f32<T, V>(*reinterpret_cast<const Lane<T, V>*>(x + i), xv);
    const float4 uu = *reinterpret_cast<const float4*>(u + i);
    uv[0] = uu.x;
    uv[1] = uu.y;
    uv[2] = uu.z;
    uv[3] = uu.w;
  } else {
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      const int64_t i = tile0 + threadIdx.x + j * kThreads;
      xv[j] = to_f32(x[i]);
      uv[j] = u[i];
    }
  }
  // the max of |x| on its bits: a non-negative float's bits order as its
  // value, and every NaN (its sign cleared) sorts above +inf, so the
  // unsigned max is the NaN-propagating max (a NaN makes its whole tile
  // NaN, on both sides), one warp-wide instruction
  uint32_t amax = 0;
#pragma unroll
  for (int j = 0; j < kPerThread; ++j)
    amax = max(amax, __float_as_uint(fabsf(xv[j])));
  amax = __reduce_max_sync(0xffffffffu, amax);
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = amax;
  __syncthreads();
  const uint4 lo = reinterpret_cast<const uint4*>(warp_max)[0];
  const uint4 hi = reinterpret_cast<const uint4*>(warp_max)[1];
  const float tile_max = __uint_as_float(
      max(max(max(lo.x, lo.y), max(lo.z, lo.w)),
          max(max(hi.x, hi.y), max(hi.z, hi.w))));

  const float scale = __fadd_rn(tile_max, 1e-30f);
  const float step = __fdiv_rn(scale, levels);
  float o[kPerThread];
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const float y = __fmul_rn(__fdiv_rn(fabsf(xv[j]), scale), levels);
    const float f = floorf(y);
    const float q = __fadd_rn(f, uv[j] < __fsub_rn(y, f) ? 1.0f : 0.0f);
    const float sg = xv[j] > 0.0f ? 1.0f : (xv[j] < 0.0f ? -1.0f : 0.0f);
    o[j] = __fmul_rn(__fmul_rn(sg, q), step);
  }
  if constexpr (V == kPerThread) {
    *reinterpret_cast<Lane<T, V>*>(out + tile0 + kPerThread * threadIdx.x) =
        lane_from_f32<T, V>(o);
  } else {
#pragma unroll
    for (int j = 0; j < kPerThread; ++j)
      out[tile0 + threadIdx.x + j * kThreads] = from_f32<T>(o[j]);
  }
}

template <typename T>
cudaError_t launch_qsgd(const void* x, const void* u, void* out,
                        int64_t n_tiles, float levels, int lane_values,
                        cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  const float* uf = static_cast<const float*>(u);
  T* o = static_cast<T*>(out);
  const dim3 grid((unsigned)n_tiles);
  if (lane_values == kPerThread)
    qsgd_kernel<T, kPerThread><<<grid, kThreads, 0, s>>>(xt, uf, o, levels);
  else if (lane_values == 1)
    qsgd_kernel<T, 1><<<grid, kThreads, 0, s>>>(xt, uf, o, levels);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

}  // namespace repro_torch

// lane_values: 4 where x and out lie on the grid of 4 of their values
// (16 bytes f32, 8 bf16) and u on the 16-byte grid, else 1 (the wrapper's
// `qsgd.py::_qsgd_lane_values`)
extern "C" int qsgd_launch(const void* x, const void* u, void* out,
                           int64_t n_tiles, float levels, int is_bf16,
                           int lane_values, void* stream) {
  using namespace repro_torch;
  if (n_tiles <= 0 || n_tiles >= (int64_t(1) << 31))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return (int)launch_qsgd<__nv_bfloat16>(x, u, out, n_tiles, levels,
                                           lane_values, s);
  return (int)launch_qsgd<float>(x, u, out, n_tiles, levels, lane_values, s);
}
