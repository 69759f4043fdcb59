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
// once, (4 + 4 + 4) bytes an f32 element, against about ten f32 operations,
// far below the card's ~20 operations per byte balance point.
//
// Design: one block of 256 threads per tile, each thread holding 4 elements
// in registers (a strided layout, so each of the 4 loads coalesces across the
// block). The tile max is a warp-shuffle max, then a max over the 8 warps'
// partials in shared memory; the elements never leave registers between the
// reduction and the store. The association of the reference is kept
// (|x| / scale, then * s; sign * q, then * (scale / s)), divisions are IEEE
// (__fdiv_rn, no fast math) and sign(0) = 0. The max propagates NaN like
// torch.amax. The uniforms are an input, so the kernel and its plain version
// draw on the same numbers: there is no random generator in the kernel.
#include "common.cuh"

namespace repro_torch {

constexpr int kTile = 1024;
constexpr int kPerThread = kTile / kThreads;  // 4

template <typename T>
__global__ void __launch_bounds__(kThreads)
qsgd_kernel(const T* __restrict__ x, const float* __restrict__ u,
            T* __restrict__ out, float levels) {
  __shared__ float warp_max[kThreads / 32];
  const int64_t base = (int64_t)blockIdx.x * kTile + threadIdx.x;
  float xv[kPerThread];
  float amax = 0.0f;
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    xv[j] = to_f32(x[base + j * kThreads]);
    amax = nan_max(amax, fabsf(xv[j]));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    amax = nan_max(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = amax;
  __syncthreads();
  float tile_max = warp_max[0];
#pragma unroll
  for (int w = 1; w < kThreads / 32; ++w) tile_max = nan_max(tile_max, warp_max[w]);

  const float scale = __fadd_rn(tile_max, 1e-30f);
  const float step = __fdiv_rn(scale, levels);
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int64_t i = base + j * kThreads;
    const float y = __fmul_rn(__fdiv_rn(fabsf(xv[j]), scale), levels);
    const float f = floorf(y);
    const float q = __fadd_rn(f, u[i] < __fsub_rn(y, f) ? 1.0f : 0.0f);
    const float sg = xv[j] > 0.0f ? 1.0f : (xv[j] < 0.0f ? -1.0f : 0.0f);
    out[i] = from_f32<T>(__fmul_rn(__fmul_rn(sg, q), step));
  }
}

}  // namespace repro_torch

extern "C" int qsgd_launch(const void* x, const void* u, void* out,
                           int64_t n_tiles, float levels, int is_bf16,
                           void* stream) {
  using namespace repro_torch;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((unsigned)n_tiles);
  if (is_bf16) {
    qsgd_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(u),
        static_cast<__nv_bfloat16*>(out), levels);
  } else {
    qsgd_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(u),
        static_cast<float*>(out), levels);
  }
  return (int)cudaGetLastError();
}
