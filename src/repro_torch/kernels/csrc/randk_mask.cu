// Dense circular-window Rand-k for M clients in one launch.
//
// Replaces the TPU kernel src/repro/kernels/randk.py · randk_mask
// (_mask_kernel, pl.pallas_call at :158): for client m with window start s_m,
//   Q[m, i] = x[m, i] * f32(d/k)   if (i - s_m) mod d < k and i < d
//   Q[m, i] = 0                    otherwise (padding columns i >= d too).
//
// Bound on the H100: bytes. The output is written whole (M * Dp elements)
// but only the k window values of each row are needed from x, so the pass
// can go no faster than (M * Dp + M * k) * itemsize / 3.35 TB/s. At the
// main path's shape, (20, 300) f32 with k = 6 (the simulator passes the
// matrix unpadded), that is 0.007 us and the launch itself dominates; at
// (20, 2^20) f32 with k/d = 0.02 it is 25.5 us, almost all of it the
// zero-fill of the output.
//
// Design: the kernel is a store stream, so it moves 16 bytes a thread per
// access. A row is cut into lanes of 16 bytes (4 f32 or 8 bf16 values);
// each thread takes kLanesPerThread lanes, neighbouring threads on
// neighbouring lanes, and a block covers kThreads * kLanesPerThread lanes of
// one row (blockIdx.y walks the rows). A row that one block covers in lanes
// of one value (at most 512 values, as the simulator's 300) is a chain of
// latencies rather than a stream: there the wrapper takes one value a lane,
// more threads with less work each. Each lane is classified from its first
// element's window offset alone:
//   - fully outside the window (or in the d..Dp padding): store zeros, load
//     nothing;
//   - fully inside: one vector load of x, __fmul_rn each value, store;
//   - straddling an edge (the window's end, the wrap point s_m, or d): a
//     vector load, then each element's own offset decides.
// All loads of a thread are issued before its first store. In-row indices
// are 32-bit (the wrapper checks Dp < 2^31); only the row base is 64-bit. A
// start outside [0, d) is reduced into it once per row, as torch.remainder
// reduces it, and each element's offset is then one subtraction and one
// conditional add. The 16-byte lanes need Dp * itemsize % 16 == 0 and both
// pointers 16-byte aligned (the wrapper checks); otherwise, and for short
// rows, the same kernel runs with lanes of one element. The scale arrives
// as the f32 the reference computes (np.float32(d / k)), not as d and k:
// x * d / k rounds otherwise.
#include <string.h>

#include "common.cuh"

namespace repro_torch {

constexpr int kLanesPerThread = 2;

// W values of T per lane: 16 / sizeof(T) (one 16-byte access) or 1
template <typename T, int W>
struct MaskLane {
  static_assert(W == 1 || W * sizeof(T) == 16, "a lane is 16 bytes or 1 value");
  T v[W];
  __device__ __forceinline__ void load(const T* p) {
    if constexpr (W == 1) {
      v[0] = *p;
    } else {
      const uint4 raw = *reinterpret_cast<const uint4*>(p);
      memcpy(v, &raw, 16);
    }
  }
  __device__ __forceinline__ void store(T* p) const {
    if constexpr (W == 1) {
      *p = v[0];
    } else {
      uint4 raw;
      memcpy(&raw, v, 16);
      *reinterpret_cast<uint4*>(p) = raw;
    }
  }
};

template <typename T, int W>
__global__ void __launch_bounds__(kThreads)
randk_mask_kernel(const T* __restrict__ x, const int* __restrict__ starts,
                  T* __restrict__ out, int64_t m, int dp, int d, int k,
                  float scale) {
  enum { kOutside, kInside, kEdge };
  const unsigned lanes = (unsigned)(dp / W);  // W divides Dp
  // < 2^32: lanes < 2^31 and a block starts below it
  const unsigned first = blockIdx.x * (unsigned)(kThreads * kLanesPerThread) +
                         threadIdx.x;
  for (int64_t row = blockIdx.y; row < m; row += gridDim.y) {
    int64_t start = starts[row];
    if (start < 0 || start >= d) start = (start % d + d) % d;
    const int s = (int)start;
    const T* src = x + row * dp;
    T* dst = out + row * dp;
    MaskLane<T, W> lane[kLanesPerThread];
    int kind[kLanesPerThread];
#pragma unroll
    for (int j = 0; j < kLanesPerThread; ++j) {
      const unsigned l = first + j * kThreads;
      kind[j] = kOutside;
      if (l >= lanes) continue;
      const int e0 = (int)(l * W);
      if (e0 >= d) continue;  // padding columns
      int o0 = e0 - s;  // the first element's window offset, in [0, d)
      if (o0 < 0) o0 += d;
      // offsets run o0, o0 + 1, ... through the lane unless it holds the
      // wrap point s past its first element or crosses d
      const bool straight = e0 + W <= d && (e0 >= s || e0 + W <= s);
      if (straight && k - o0 >= W) kind[j] = kInside;
      else if (!straight || o0 < k) kind[j] = kEdge;
      if (kind[j] != kOutside) lane[j].load(src + e0);
    }
#pragma unroll
    for (int j = 0; j < kLanesPerThread; ++j) {
      const unsigned l = first + j * kThreads;
      if (l >= lanes) continue;
      const int e0 = (int)(l * W);
#pragma unroll
      for (int i = 0; i < W; ++i) {
        bool keep = kind[j] == kInside;
        if (kind[j] == kEdge) {
          const int e = e0 + i;
          int off = e - s;
          if (off < 0) off += d;
          keep = e < d && off < k;
        }
        lane[j].v[i] = from_f32<T>(keep ? __fmul_rn(to_f32(lane[j].v[i]), scale)
                                        : 0.0f);
      }
      lane[j].store(dst + e0);
    }
  }
}

template <typename T>
cudaError_t launch_mask(const void* x, const void* starts, void* out,
                        int64_t m, int dp, int d, int k, float scale,
                        int lane_values, cudaStream_t s) {
  constexpr int kW = 16 / sizeof(T);
  const int w = lane_values == kW ? kW : 1;
  const int64_t lanes = dp / w;
  const int64_t per_block = (int64_t)kThreads * kLanesPerThread;
  const dim3 grid((unsigned)((lanes + per_block - 1) / per_block),
                  (unsigned)(m < 65535 ? m : 65535));
  const T* xp = static_cast<const T*>(x);
  const int* sp = static_cast<const int*>(starts);
  T* op = static_cast<T*>(out);
  if (w == kW)
    randk_mask_kernel<T, kW><<<grid, kThreads, 0, s>>>(xp, sp, op, m, dp, d, k, scale);
  else
    randk_mask_kernel<T, 1><<<grid, kThreads, 0, s>>>(xp, sp, op, m, dp, d, k, scale);
  return cudaGetLastError();
}

}  // namespace repro_torch

// lane_values: 16 / itemsize for the 16-byte lanes, 1 for the scalar variant
extern "C" int randk_mask_launch(const void* x, const void* starts, void* out,
                                 int64_t m, int64_t dp, int64_t d, int64_t k,
                                 float scale, int is_bf16, int lane_values,
                                 void* stream) {
  using namespace repro_torch;
  if (dp <= 0 || dp >= (int64_t(1) << 31)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return (int)launch_mask<__nv_bfloat16>(x, starts, out, m, (int)dp, (int)d,
                                           (int)k, scale, lane_values, s);
  return (int)launch_mask<float>(x, starts, out, m, (int)dp, (int)d, (int)k,
                                 scale, lane_values, s);
}
