// Fused DIANA shift/direction update, 4 inputs and 3 outputs in one pass.
//
// Replaces the TPU kernel src/repro/kernels/diana_shift.py ·
// diana_shift_update (_shift_kernel, pl.pallas_call at :58):
//   direction = H + Q_mean,   h' = h + alpha * Q_own,   H' = H + beta * Q_mean
// with f32 math; h' and H' are stored in the shifts' type and the direction
// in Q_mean's (f32 or bf16 each: the wire keeps bf16 shift tables beside
// f32 messages). The simulator passes four flat buffers of one length; the
// rank-stacked wire passes the C ranks of G groups as h, Q_own (G, C, n)
// beside each group's one mean H, Q_mean (G, n), and the group's first rank
// writes its direction and H'.
//
// Bound on the H100: bytes. Every array crosses memory once (the h side
// G*C*n elements in and out, the H side G*n), for three adds and two
// multiplies per element. Unfused, the same update is five separate
// element-wise kernels and ten array passes.
//
// Design: one thread per element of a rank's row in a grid-stride loop,
// blockIdx.y over the ranks, coalesced loads and stores. The multiply and
// the add are written as __fmul_rn and __fadd_rn (and the library is built
// with -fmad=false): nvcc would otherwise contract h + alpha * q into one
// fused multiply-add, whose single rounding differs from the plain
// version's and the reference's two roundings.
#include "common.cuh"

namespace repro_torch {

template <typename TH, typename TQ>
__global__ void diana_shift_kernel(const TH* __restrict__ h,
                                   const TQ* __restrict__ q_own,
                                   const TH* __restrict__ mh,
                                   const TQ* __restrict__ q_mean,
                                   TQ* __restrict__ dir, TH* __restrict__ h_out,
                                   TH* __restrict__ mh_out, int64_t ranks,
                                   int64_t per_group, int64_t n, float alpha,
                                   float beta) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t r = blockIdx.y; r < ranks; r += gridDim.y) {
    const int64_t g = r / per_group;
    const bool lead = r == g * per_group;  // writes the group's H side
    const int64_t hb = r * n, mb = g * n;
    for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
         i += stride) {
      const float hv = to_f32(h[hb + i]);
      const float qo = to_f32(q_own[hb + i]);
      h_out[hb + i] = from_f32<TH>(__fadd_rn(hv, __fmul_rn(alpha, qo)));
      if (lead) {
        const float mv = to_f32(mh[mb + i]);
        const float qm = to_f32(q_mean[mb + i]);
        dir[mb + i] = from_f32<TQ>(__fadd_rn(mv, qm));
        mh_out[mb + i] = from_f32<TH>(__fadd_rn(mv, __fmul_rn(beta, qm)));
      }
    }
  }
}

template <typename TH, typename TQ>
void launch(const void* h, const void* q_own, const void* mh, const void* q_mean,
            void* dir, void* h_out, void* mh_out, int64_t ranks,
            int64_t per_group, int64_t n, float alpha, float beta,
            cudaStream_t s) {
  const dim3 grid((unsigned)grid_for(n), (unsigned)(ranks < 65535 ? ranks : 65535));
  diana_shift_kernel<TH, TQ><<<grid, kThreads, 0, s>>>(
      static_cast<const TH*>(h), static_cast<const TQ*>(q_own),
      static_cast<const TH*>(mh), static_cast<const TQ*>(q_mean),
      static_cast<TQ*>(dir), static_cast<TH*>(h_out), static_cast<TH*>(mh_out),
      ranks, per_group, n, alpha, beta);
}

}  // namespace repro_torch

extern "C" int diana_shift_launch(const void* h, const void* q_own,
                                  const void* mh, const void* q_mean, void* dir,
                                  void* h_out, void* mh_out, int64_t ranks,
                                  int64_t per_group, int64_t n, float alpha,
                                  float beta, int h_bf16, int q_bf16,
                                  void* stream) {
  using namespace repro_torch;
  using B = __nv_bfloat16;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (h_bf16 && q_bf16)
    launch<B, B>(h, q_own, mh, q_mean, dir, h_out, mh_out, ranks, per_group, n, alpha, beta, s);
  else if (h_bf16)
    launch<B, float>(h, q_own, mh, q_mean, dir, h_out, mh_out, ranks, per_group, n, alpha, beta, s);
  else if (q_bf16)
    launch<float, B>(h, q_own, mh, q_mean, dir, h_out, mh_out, ranks, per_group, n, alpha, beta, s);
  else
    launch<float, float>(h, q_own, mh, q_mean, dir, h_out, mh_out, ranks, per_group, n, alpha, beta, s);
  return (int)cudaGetLastError();
}
