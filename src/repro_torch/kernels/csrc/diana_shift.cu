// Fused DIANA shift/direction update, 4 inputs and 3 outputs in one pass.
//
// Replaces the TPU kernel src/repro/kernels/diana_shift.py ·
// diana_shift_update (_shift_kernel, pl.pallas_call at :58):
//   direction = H + Q_mean,   h' = h + alpha * Q_own,   H' = H + beta * Q_mean
// with f32 math; h' and H' are stored in the shifts' type and the direction
// in Q_mean's (f32 or bf16 each: the wire keeps bf16 shift tables beside
// f32 messages). The simulator passes four flat buffers of one length; the
// rank-stacked wire passes the C ranks of G groups as h, Q_own (G, C, n)
// beside each group's one mean H, Q_mean (G, n).
//
// Bound on the H100: bytes. Every array crosses memory once (the h side
// G*C*n elements in and out, the H side G*n), for three adds and two
// multiplies per element. Unfused, the same update is five separate
// element-wise kernels and ten array passes.
//
// Design: flat lanes of V values, 16 bytes on the wider side (4 values when
// either side is f32, 8 when both are bf16; one value where the wrapper
// finds n or a pointer off that grid). The lanes form one flat range: the
// h side's G*C*n/V lanes (load h and Q_own, store h'), then the H side's
// G*n/V (load H and Q_mean, store the direction and H'). A rank's row and a
// group's row are contiguous in both layouts, so a lane's index is its
// offset into its side's arrays: no division, and the simulator's flat call
// (G = C = 1) is the same range. Each thread takes kShiftLanes lanes kThreads
// apart, so a warp's accesses stay contiguous, and issues every load before
// its first store; only the one warp that straddles the two sides
// diverges. The grid is sized from the lanes, with a grid-stride loop past
// its cap, and indexes in 32 bits while the lanes stay below 2^31.
//
// Measured against it on the H100 (PERF.md §6): one item a lane of a
// group, loading H, Q_mean and every rank's h and Q_own before its stores,
// was 0.8% slower on the stacked train leaves. The design before both,
// one element a thread in a grid-stride loop over a capped grid with the
// ranks in the grid's y and the group's first rank also doing the H side,
// ran at 1.16-1.29x the bound on every large shape, flat or stacked.
//
// Inputs may alias one another (the simulator's server update passes h as
// H and Q_own as Q_mean): the aliased lanes are then read once for each
// side, at that call's sizes (N = 300 and 6000) from L2. The multiply and
// the add are written as __fmul_rn and __fadd_rn (and the library is built
// with -fmad=false): nvcc would otherwise contract h + alpha * q into one
// fused multiply-add, whose single rounding differs from the plain
// version's and the reference's two roundings.
#include "common.cuh"

namespace repro_torch {

constexpr int kShiftLanes = 2;

template <typename TH, typename TQ, int V, typename I>
__global__ void __launch_bounds__(kThreads)
diana_shift_kernel(const Lane<TH, V>* __restrict__ h,
                   const Lane<TQ, V>* __restrict__ q_own,
                   const Lane<TH, V>* __restrict__ mh,
                   const Lane<TQ, V>* __restrict__ q_mean,
                   Lane<TQ, V>* __restrict__ dir, Lane<TH, V>* __restrict__ h_out,
                   Lane<TH, V>* __restrict__ mh_out, I h_lanes, I lanes,
                   float alpha, float beta) {
  constexpr int kLanes = kShiftLanes;
  const I step = (I)gridDim.x * (kThreads * kLanes);
  for (I base = (I)blockIdx.x * (kThreads * kLanes) + threadIdx.x; base < lanes;
       base += step) {
    Lane<TH, V> a[kLanes];  // h, or H
    Lane<TQ, V> b[kLanes];  // Q_own, or Q_mean
#pragma unroll
    for (int j = 0; j < kLanes; ++j) {
      const I l = base + (I)(j * kThreads);
      if (l < h_lanes) {
        a[j] = h[l];
        b[j] = q_own[l];
      } else if (l < lanes) {
        a[j] = mh[l - h_lanes];
        b[j] = q_mean[l - h_lanes];
      }
    }
#pragma unroll
    for (int j = 0; j < kLanes; ++j) {
      const I l = base + (I)(j * kThreads);
      if (l >= lanes) continue;
      float x[V], q[V], o[V];
      lane_to_f32<TH, V>(a[j], x);
      lane_to_f32<TQ, V>(b[j], q);
      if (l < h_lanes) {
#pragma unroll
        for (int e = 0; e < V; ++e) o[e] = __fadd_rn(x[e], __fmul_rn(alpha, q[e]));
        h_out[l] = lane_from_f32<TH, V>(o);
      } else {
        float d[V];
#pragma unroll
        for (int e = 0; e < V; ++e) {
          d[e] = __fadd_rn(x[e], q[e]);
          o[e] = __fadd_rn(x[e], __fmul_rn(beta, q[e]));
        }
        dir[l - h_lanes] = lane_from_f32<TQ, V>(d);
        mh_out[l - h_lanes] = lane_from_f32<TH, V>(o);
      }
    }
  }
}

template <typename TH, typename TQ, int V>
void launch_lanes(const void* h, const void* q_own, const void* mh,
                  const void* q_mean, void* dir, void* h_out, void* mh_out,
                  int64_t ranks, int64_t per_group, int64_t n, float alpha,
                  float beta, cudaStream_t s) {
  using LH = Lane<TH, V>;
  using LQ = Lane<TQ, V>;
  const int64_t h_lanes = ranks * (n / V);
  const int64_t lanes = h_lanes + ranks / per_group * (n / V);
  const unsigned grid = flat_grid(lanes, kShiftLanes);
  const LH* hp = static_cast<const LH*>(h);
  const LQ* qp = static_cast<const LQ*>(q_own);
  const LH* mp = static_cast<const LH*>(mh);
  const LQ* qmp = static_cast<const LQ*>(q_mean);
  if (lanes < kIndex32)
    diana_shift_kernel<TH, TQ, V, uint32_t><<<grid, kThreads, 0, s>>>(
        hp, qp, mp, qmp, static_cast<LQ*>(dir), static_cast<LH*>(h_out),
        static_cast<LH*>(mh_out), (uint32_t)h_lanes, (uint32_t)lanes, alpha, beta);
  else
    diana_shift_kernel<TH, TQ, V, uint64_t><<<grid, kThreads, 0, s>>>(
        hp, qp, mp, qmp, static_cast<LQ*>(dir), static_cast<LH*>(h_out),
        static_cast<LH*>(mh_out), (uint64_t)h_lanes, (uint64_t)lanes, alpha, beta);
}

template <typename TH, typename TQ>
cudaError_t launch(const void* h, const void* q_own, const void* mh,
                   const void* q_mean, void* dir, void* h_out, void* mh_out,
                   int64_t ranks, int64_t per_group, int64_t n, float alpha,
                   float beta, int lane_values, cudaStream_t s) {
  // 16 bytes a lane on the wider side
  constexpr int kV = 16 / (sizeof(TH) > sizeof(TQ) ? sizeof(TH) : sizeof(TQ));
  if (lane_values == kV && n % kV == 0)
    launch_lanes<TH, TQ, kV>(h, q_own, mh, q_mean, dir, h_out, mh_out, ranks,
                             per_group, n, alpha, beta, s);
  else if (lane_values == 1)
    launch_lanes<TH, TQ, 1>(h, q_own, mh, q_mean, dir, h_out, mh_out, ranks,
                            per_group, n, alpha, beta, s);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

}  // namespace repro_torch

// lane_values: values in one lane, 16 bytes' worth on the wider side (4,
// or 8 when both sides are bf16; n a multiple of it and every pointer on
// the 16-byte grid) or 1
extern "C" int diana_shift_launch(const void* h, const void* q_own,
                                  const void* mh, const void* q_mean, void* dir,
                                  void* h_out, void* mh_out, int64_t ranks,
                                  int64_t per_group, int64_t n, float alpha,
                                  float beta, int h_bf16, int q_bf16,
                                  int lane_values, void* stream) {
  using namespace repro_torch;
  using B = __nv_bfloat16;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (h_bf16 && q_bf16)
    return (int)launch<B, B>(h, q_own, mh, q_mean, dir, h_out, mh_out, ranks,
                             per_group, n, alpha, beta, lane_values, s);
  if (h_bf16)
    return (int)launch<B, float>(h, q_own, mh, q_mean, dir, h_out, mh_out, ranks,
                                 per_group, n, alpha, beta, lane_values, s);
  if (q_bf16)
    return (int)launch<float, B>(h, q_own, mh, q_mean, dir, h_out, mh_out, ranks,
                                 per_group, n, alpha, beta, lane_values, s);
  return (int)launch<float, float>(h, q_own, mh, q_mean, dir, h_out, mh_out,
                                   ranks, per_group, n, alpha, beta, lane_values, s);
}
