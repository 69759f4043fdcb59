// Dense circular-window Rand-k for M clients in one launch.
//
// Replaces the TPU kernel src/repro/kernels/randk.py · randk_mask
// (_mask_kernel, pl.pallas_call at :158): for client m with window start s_m,
//   Q[m, i] = x[m, i] * f32(d/k)   if (i - s_m) mod d < k and i < d
//   Q[m, i] = 0                    otherwise (padding columns i >= d too).
//
// Bound on the H100: bytes. The output is written whole (M * Dp elements)
// but only the k window values of each row are needed from x, so the pass
// can go no faster than (M * Dp + M * k) * itemsize / 3.35 TB/s; the kernel
// loads x only inside the window. At the main path's shape, (20, 300) f32
// with k = 6 (the simulator passes the matrix unpadded), that is 0.007 us
// and the launch itself dominates.
//
// Design: one thread per element in a grid-stride loop, neighbouring threads
// on neighbouring columns so loads and stores coalesce. blockIdx.y walks the
// clients: every thread of a block reads the same start (a broadcast load,
// the counterpart of the TPU's scalar prefetch). The flat offset m * Dp + i
// is 64-bit: M * Dp passes 2^31 at large widths. A start outside [0, d) is
// first reduced into it (the samplers never draw one, so the common path
// divides nothing); each element's window offset (i - s) mod d is then one
// subtraction and one conditional add, never a 64-bit division per element.
// It equals the plain version's torch.remainder for any start. The scale
// arrives as the f32 the reference computes (np.float32(d / k)), not as d
// and k: x * d / k rounds otherwise.
#include "common.cuh"

namespace repro_torch {

template <typename T>
__global__ void randk_mask_kernel(const T* __restrict__ x,
                                  const int* __restrict__ starts,
                                  T* __restrict__ out, int64_t m, int64_t dp,
                                  int64_t d, int64_t k, float scale) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t row = blockIdx.y; row < m; row += gridDim.y) {
    int64_t start = starts[row];
    if (start < 0 || start >= d) start = (start % d + d) % d;
    const int64_t base = row * dp;
    for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < dp;
         i += stride) {
      float v = 0.0f;
      if (i < d) {
        int64_t off = i - start;  // in (-d, d)
        if (off < 0) off += d;
        if (off < k) v = __fmul_rn(to_f32(x[base + i]), scale);
      }
      out[base + i] = from_f32<T>(v);
    }
  }
}

}  // namespace repro_torch

extern "C" int randk_mask_launch(const void* x, const void* starts, void* out,
                                 int64_t m, int64_t dp, int64_t d, int64_t k,
                                 float scale, int is_bf16, void* stream) {
  using namespace repro_torch;
  int64_t gx = (dp + kThreads - 1) / kThreads;
  if (gx > 65535) gx = 65535;
  const int64_t gy = m < 65535 ? m : 65535;
  const dim3 grid((unsigned)gx, (unsigned)gy);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    randk_mask_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const int*>(starts),
        static_cast<__nv_bfloat16*>(out), m, dp, d, k, scale);
  } else {
    randk_mask_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const int*>(starts),
        static_cast<float*>(out), m, dp, d, k, scale);
  }
  return (int)cudaGetLastError();
}
