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
// Compress's design: the decompress geometry below, read the other way.
// Window block i of rank r is one contiguous span of 8 * D elements both in
// the source (block (s + i) mod nb of the rank's rows) and in the output,
// and 8 * D * itemsize is always a multiple of 16 bytes. So the output is
// flat 16-byte lanes over (rank, window block, lane of the block), whatever
// D is; each lane loads 16 bytes of its source block, scales them in f32
// (one rounding) and stores them. Lanes are indexed flat over all ranks, so
// narrow rows (D = 25 or 60) fill whole warps instead of leaving most of a
// block a row idle, as an earlier design, one 256-thread block per output
// row, did. Each thread takes four lanes and issues every load before its
// stores; the grid is sized from the lanes. Four lanes measured as fast as
// two on the wide slabs and steadier at qwen2-moe's expert leaf (75.1-75.2
// us against 75.0-78.0 over four runs), two about 0.3 us faster on the
// narrowest slabs (PERF.md §6). Where a pointer is off the 16-byte
// grid (the wrapper checks), a lane is one element, still flat.
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
#include "common.cuh"

namespace repro_torch {

// the window's start block in [0, nb), as torch.remainder gives it
__device__ __forceinline__ int64_t window_start(const int* start, int64_t nb) {
  const int64_t s = start[0] % nb;
  return s < 0 ? s + nb : s;
}

// One lane is V values of T: 16 bytes, or one element where the wrapper
// found a pointer off the 16-byte grid. Lanes are flat over (rank, window
// block, lane of the block's 8 * D elements); `per_block` divides by the
// lanes of a block, `per_rank` by kb. Each thread takes kCompressLanes
// lanes kThreads apart, so a warp's accesses stay contiguous, and issues
// every load before its first store.
constexpr int kCompressLanes = 4;

template <typename T, int V, typename I>
__global__ void __launch_bounds__(kThreads)
randk_compress_kernel(const Lane<T, V>* __restrict__ rows,
                      const int* __restrict__ start, Lane<T, V>* __restrict__ out,
                      I lanes, Divider<I> per_block, Divider<I> per_rank, I nb,
                      float scale) {
  constexpr int kLanes = kCompressLanes;
  const I kb = per_rank.d, lb = per_block.d;
  const I s0 = (I)window_start(start, (int64_t)nb);
  const I step = (I)gridDim.x * (kThreads * kLanes);
  for (I base = (I)blockIdx.x * (kThreads * kLanes) + threadIdx.x; base < lanes;
       base += step) {
    Lane<T, V> v[kLanes];
#pragma unroll
    for (int j = 0; j < kLanes; ++j) {
      const I l = base + (I)(j * kThreads);
      if (l < lanes) {
        const I blk = per_block.div(l);  // r * kb + window block
        const I r = per_rank.div(blk);
        I src = s0 + (blk - r * kb);  // < 2 nb: the window block is < kb <= nb
        if (src >= nb) src -= nb;
        v[j] = rows[(r * nb + src) * lb + (l - blk * lb)];
      }
    }
#pragma unroll
    for (int j = 0; j < kLanes; ++j) {
      const I l = base + (I)(j * kThreads);
      if (l < lanes) {
        float f[V];
        lane_to_f32<T, V>(v[j], f);
#pragma unroll
        for (int e = 0; e < V; ++e) f[e] = __fmul_rn(f[e], scale);
        out[l] = lane_from_f32<T, V>(f);
      }
    }
  }
}

template <typename T, int V>
cudaError_t launch_compress(const void* rows, const void* start, void* out,
                            int64_t ranks, int64_t nb, int64_t kb, int64_t lb,
                            float scale, cudaStream_t s) {
  const int64_t lanes = ranks * kb * lb;
  const unsigned grid = flat_grid(lanes, kCompressLanes);
  const Lane<T, V>* r = static_cast<const Lane<T, V>*>(rows);
  const int* st = static_cast<const int*>(start);
  Lane<T, V>* o = static_cast<Lane<T, V>*>(out);
  if (ranks * nb * lb < kIndex32)  // the rows' lanes: the larger side
    randk_compress_kernel<T, V, uint32_t><<<grid, kThreads, 0, s>>>(
        r, st, o, (uint32_t)lanes, make_divider<uint32_t>((uint32_t)lb),
        make_divider<uint32_t>((uint32_t)kb), (uint32_t)nb, scale);
  else
    randk_compress_kernel<T, V, uint64_t><<<grid, kThreads, 0, s>>>(
        r, st, o, (uint64_t)lanes, make_divider<uint64_t>((uint64_t)lb),
        make_divider<uint64_t>((uint64_t)kb), (uint64_t)nb, scale);
  return cudaGetLastError();
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

// lane_values (both launches): elements in one lane, 16 / itemsize (the
// 16-byte lanes: both pointers on the 16-byte grid and block_rows * D *
// itemsize a multiple of 16) or 1
extern "C" int randk_compress_launch(const void* rows, const void* start,
                                     void* out, int64_t ranks, int64_t n_rows,
                                     int64_t d, int64_t k_blocks,
                                     int64_t block_rows, float scale,
                                     int is_bf16, int lane_values,
                                     void* stream) {
  using namespace repro_torch;
  using B = __nv_bfloat16;
  const int64_t nb = n_rows / block_rows;
  const int64_t span = block_rows * d;  // elements of one block
  const int itemsize = is_bf16 ? 2 : 4;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (lane_values * itemsize == 16 && span % lane_values == 0)
    return (int)(is_bf16
        ? launch_compress<B, 8>(rows, start, out, ranks, nb, k_blocks, span / 8, scale, s)
        : launch_compress<float, 4>(rows, start, out, ranks, nb, k_blocks, span / 4, scale, s));
  if (lane_values != 1) return (int)cudaErrorInvalidValue;
  return (int)(is_bf16
      ? launch_compress<B, 1>(rows, start, out, ranks, nb, k_blocks, span, scale, s)
      : launch_compress<float, 1>(rows, start, out, ranks, nb, k_blocks, span, scale, s));
}

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
