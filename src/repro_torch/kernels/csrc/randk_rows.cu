// Circular row-block gather and scatter of the shared Rand-block wire, over
// a stack of ranks that share one window.
//
// Replaces the TPU kernels src/repro/kernels/randk.py · randk_compress
// (_gather_kernel, pl.pallas_call at :56) and randk_decompress
// (_scatter_kernel, pl.pallas_call at :94). With nb = N / block_rows row
// blocks and a window of kb blocks that starts at block s (s read from
// device memory, so the host never waits for the draw):
//   compress:   out[r, i, :]  = rows[r, ((s + i / 8) mod nb) * 8 + i % 8, :] * f32(nb / kb)
//   decompress: out[g, j, :]  = vals[g, ((j / 8 - s) mod nb) * 8 + j % 8, :]  if that
//               block offset is < kb, else 0
// The multiply is in f32 and rounds once to the rows' type, as the TPU
// kernel's astype(f32) * scale does.
//
// Bound on the H100: bytes, at 3.35 TB/s. Compress reads and writes the
// (R, kb*8, D) slab once; decompress reads it once and writes the whole
// (G, N, D) canvas, which at the main path's widths is 100-1000x the slab:
// the canvas write is the wire's largest device cost. One multiply per
// element at most.
//
// Compress's design: one block per output row (a grid-stride loop past 2^20
// rows). The row's source, (s + i / 8) mod nb, is computed once per row,
// never per element, and the window start is reduced into [0, nb) once per
// block. Where D * itemsize is a multiple of 16 bytes and the pointers are
// 16-byte aligned (the wrapper checks), each thread moves 16 bytes per load
// and store; otherwise one element at a time.
//
// Decompress's design: the row geometry does not matter to it. Canvas rows
// 8b..8b+7 are one contiguous span of 8 * D elements, and so is each block
// of the slab; 8 * D * itemsize is always a multiple of 16 bytes. So each
// group's canvas is nb spans of flat 16-byte lanes, whatever D is (25, 60
// and 33 included, and bf16), and a lane either copies 16 bytes from the
// slab or stores zeros without a load. Lanes are indexed flat over all
// groups, so narrow rows fill whole warps; the grid is sized from the lanes,
// with a grid-stride loop past its cap. A lane's block is found by a
// multiply-and-shift division (common.cuh's Divider), and each thread issues
// both of its lanes' loads before it stores (two lanes a thread measured as
// fast as four on the wide canvases and faster on the narrow ones). Where a
// pointer is off the 16-byte grid (the wrapper checks), a lane is one
// element, still flat.
#include <string.h>

#include "common.cuh"

namespace repro_torch {

// the window's start block in [0, nb), as torch.remainder gives it
__device__ __forceinline__ int64_t window_start(const int* start, int64_t nb) {
  const int64_t s = start[0] % nb;
  return s < 0 ? s + nb : s;
}

template <typename T>
__device__ __forceinline__ uint4 scale16(uint4 v, float scale) {
  constexpr int kN = 16 / sizeof(T);
  T e[kN];
  memcpy(e, &v, 16);
#pragma unroll
  for (int j = 0; j < kN; ++j) e[j] = from_f32<T>(__fmul_rn(to_f32(e[j]), scale));
  memcpy(&v, e, 16);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
randk_compress_kernel(const T* __restrict__ rows, const int* __restrict__ start,
                      T* __restrict__ out, int64_t out_rows, int64_t k_rows,
                      int64_t n_rows, int64_t d, int64_t nb, int block_rows,
                      float scale, int vec) {
  const int64_t s0 = window_start(start, nb);
  for (int64_t orow = blockIdx.x; orow < out_rows; orow += gridDim.x) {
    const int64_t r = orow / k_rows, i = orow - r * k_rows;
    int64_t blk = s0 + i / block_rows;  // < 2 nb: i / block_rows < kb <= nb
    if (blk >= nb) blk -= nb;
    const T* src = rows + (r * n_rows + blk * block_rows + i % block_rows) * d;
    T* dst = out + orow * d;
    if (vec) {
      const uint4* s4 = reinterpret_cast<const uint4*>(src);
      uint4* d4 = reinterpret_cast<uint4*>(dst);
      const int64_t n4 = d / (16 / sizeof(T));
      for (int64_t c = threadIdx.x; c < n4; c += blockDim.x)
        d4[c] = scale16<T>(s4[c], scale);
    } else {
      for (int64_t c = threadIdx.x; c < d; c += blockDim.x)
        dst[c] = from_f32<T>(__fmul_rn(to_f32(src[c]), scale));
    }
  }
}

// One lane is a U: 16 bytes, or one element where the wrapper found the
// pointers or the block span off the 16-byte grid. Lanes are flat over
// (group, canvas block, lane of the block's 8 * D elements); `per_block`
// divides by the lanes of a block, `per_group` by nb. Each thread takes
// kLanes lanes kThreads apart, so a warp's accesses stay contiguous, and
// issues every load before its first store.
constexpr int kDecompressLanes = 2;

template <typename U, typename I>
__global__ void __launch_bounds__(kThreads)
randk_decompress_kernel(const U* __restrict__ vals, const int* __restrict__ start,
                        U* __restrict__ out, I lanes, Divider<I> per_block,
                        Divider<I> per_group, I kb) {
  constexpr int kLanes = kDecompressLanes;
  const I nb = per_group.d, lb = per_block.d;
  const I s0 = (I)window_start(start, (int64_t)nb);
  const I step = (I)gridDim.x * (kThreads * kLanes);
  for (I base = (I)blockIdx.x * (kThreads * kLanes) + threadIdx.x; base < lanes;
       base += step) {
    U v[kLanes];
#pragma unroll
    for (int j = 0; j < kLanes; ++j) {
      const I l = base + (I)(j * kThreads);
      v[j] = U{};
      if (l < lanes) {
        const I blk = per_block.div(l);  // g * nb + canvas block
        const I g = per_group.div(blk);
        const I b = blk - g * nb;
        const I off = b >= s0 ? b - s0 : b + nb - s0;  // offset in the window
        if (off < kb) v[j] = vals[(g * kb + off) * lb + (l - blk * lb)];
      }
    }
#pragma unroll
    for (int j = 0; j < kLanes; ++j) {
      const I l = base + (I)(j * kThreads);
      if (l < lanes) out[l] = v[j];
    }
  }
}

template <typename U>
cudaError_t launch_decompress(const void* vals, const void* start, void* out,
                              int64_t groups, int64_t nb, int64_t kb,
                              int64_t lb, cudaStream_t s) {
  const int64_t lanes = groups * nb * lb;
  const unsigned grid = flat_grid(lanes, kDecompressLanes);
  const U* v = static_cast<const U*>(vals);
  const int* st = static_cast<const int*>(start);
  U* o = static_cast<U*>(out);
  if (lanes < kIndex32)
    randk_decompress_kernel<U, uint32_t><<<grid, kThreads, 0, s>>>(
        v, st, o, (uint32_t)lanes, make_divider<uint32_t>((uint32_t)lb),
        make_divider<uint32_t>((uint32_t)nb), (uint32_t)kb);
  else
    randk_decompress_kernel<U, uint64_t><<<grid, kThreads, 0, s>>>(
        v, st, o, (uint64_t)lanes, make_divider<uint64_t>((uint64_t)lb),
        make_divider<uint64_t>((uint64_t)nb), (uint64_t)kb);
  return cudaGetLastError();
}

}  // namespace repro_torch

extern "C" int randk_compress_launch(const void* rows, const void* start,
                                     void* out, int64_t ranks, int64_t n_rows,
                                     int64_t d, int64_t k_blocks,
                                     int64_t block_rows, float scale,
                                     int is_bf16, int vec, void* stream) {
  using namespace repro_torch;
  const int64_t k_rows = k_blocks * block_rows;
  const int64_t out_rows = ranks * k_rows;
  const int64_t nb = n_rows / block_rows;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned grid = row_grid(out_rows);
  if (is_bf16) {
    using T = __nv_bfloat16;
    randk_compress_kernel<T><<<grid, kThreads, 0, s>>>(
        static_cast<const T*>(rows), static_cast<const int*>(start),
        static_cast<T*>(out), out_rows, k_rows, n_rows, d, nb, (int)block_rows,
        scale, vec);
  } else {
    randk_compress_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(rows), static_cast<const int*>(start),
        static_cast<float*>(out), out_rows, k_rows, n_rows, d, nb,
        (int)block_rows, scale, vec);
  }
  return (int)cudaGetLastError();
}

// lane_values: elements in one lane, 16 / itemsize (the 16-byte lanes: both
// pointers on the 16-byte grid and block_rows * D * itemsize a multiple of
// 16) or 1
extern "C" int randk_decompress_launch(const void* vals, const void* start,
                                       void* out, int64_t groups,
                                       int64_t n_rows, int64_t d,
                                       int64_t k_blocks, int64_t block_rows,
                                       int itemsize, int lane_values,
                                       void* stream) {
  using namespace repro_torch;
  const int64_t nb = n_rows / block_rows;
  const int64_t span = block_rows * d;  // elements of one block
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (lane_values * itemsize == 16 && span % lane_values == 0)
    return (int)launch_decompress<uint4>(vals, start, out, groups, nb, k_blocks,
                                         span / lane_values, s);
  if (lane_values != 1) return (int)cudaErrorInvalidValue;
  if (itemsize == 4)
    return (int)launch_decompress<uint32_t>(vals, start, out, groups, nb,
                                            k_blocks, span, s);
  if (itemsize == 2)
    return (int)launch_decompress<uint16_t>(vals, start, out, groups, nb,
                                            k_blocks, span, s);
  return (int)cudaErrorInvalidValue;
}
