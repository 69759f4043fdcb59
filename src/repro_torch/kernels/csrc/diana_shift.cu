// Fused DIANA shift/direction update, 4 inputs and 3 outputs in one pass.
//
// Replaces the TPU kernel src/repro/kernels/diana_shift.py ·
// diana_shift_update (_shift_kernel, pl.pallas_call at :58):
//   direction = H + Q_mean,   h' = h + alpha * Q_own,   H' = H + beta * Q_mean
// with f32 math and every output stored in the inputs' type (f32 or bf16).
//
// Bound on the H100: bytes. Seven arrays of N elements cross memory once
// each for three adds and two multiplies per element, so the pass can go no
// faster than 7 * N * itemsize / 3.35 TB/s. Unfused, the same update is five
// separate element-wise kernels and ten array passes.
//
// Design: one thread per element in a grid-stride loop, coalesced loads and
// stores. The multiply and the add are written as __fmul_rn and __fadd_rn
// (and the library is built with -fmad=false): nvcc would otherwise contract
// h + alpha * q into one fused multiply-add, whose single rounding differs
// from the plain version's and the reference's two roundings.
#include "common.cuh"

namespace repro_torch {

template <typename T>
__global__ void diana_shift_kernel(const T* __restrict__ h,
                                   const T* __restrict__ q_own,
                                   const T* __restrict__ mh,
                                   const T* __restrict__ q_mean,
                                   T* __restrict__ dir, T* __restrict__ h_out,
                                   T* __restrict__ mh_out, int64_t n,
                                   float alpha, float beta) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const float hv = to_f32(h[i]);
    const float qo = to_f32(q_own[i]);
    const float mv = to_f32(mh[i]);
    const float qm = to_f32(q_mean[i]);
    dir[i] = from_f32<T>(__fadd_rn(mv, qm));
    h_out[i] = from_f32<T>(__fadd_rn(hv, __fmul_rn(alpha, qo)));
    mh_out[i] = from_f32<T>(__fadd_rn(mv, __fmul_rn(beta, qm)));
  }
}

}  // namespace repro_torch

extern "C" int diana_shift_launch(const void* h, const void* q_own,
                                  const void* mh, const void* q_mean, void* dir,
                                  void* h_out, void* mh_out, int64_t n,
                                  float alpha, float beta, int is_bf16,
                                  void* stream) {
  using namespace repro_torch;
  const unsigned grid = (unsigned)grid_for(n);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    using T = __nv_bfloat16;
    diana_shift_kernel<T><<<grid, kThreads, 0, s>>>(
        static_cast<const T*>(h), static_cast<const T*>(q_own),
        static_cast<const T*>(mh), static_cast<const T*>(q_mean),
        static_cast<T*>(dir), static_cast<T*>(h_out), static_cast<T*>(mh_out),
        n, alpha, beta);
  } else {
    diana_shift_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(h), static_cast<const float*>(q_own),
        static_cast<const float*>(mh), static_cast<const float*>(q_mean),
        static_cast<float*>(dir), static_cast<float*>(h_out),
        static_cast<float*>(mh_out), n, alpha, beta);
  }
  return (int)cudaGetLastError();
}
