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
// Bound on the H100: bytes. Compress reads and writes the (R, kb*8, D) slab
// once; decompress reads it once and writes the whole (G, N, D) canvas,
// which at the main path's widths is 100-1000x the slab: the canvas write is
// the wire's largest device cost. One multiply per element at most.
//
// Design: one block per output row (a grid-stride loop past 2^20 rows). The
// row's source, (s + i / 8) mod nb, is computed once per row, never per
// element, and the window start is reduced into [0, nb) once per block.
// Where D * itemsize is a multiple of 16 bytes and the pointers are 16-byte
// aligned (the wrapper checks), each thread moves 16 bytes per load and
// store; otherwise one element at a time.
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

template <typename T>
__global__ void __launch_bounds__(kThreads)
randk_decompress_kernel(const T* __restrict__ vals, const int* __restrict__ start,
                        T* __restrict__ out, int64_t out_rows, int64_t n_rows,
                        int64_t d, int64_t nb, int64_t kb, int block_rows,
                        int vec) {
  const int64_t s0 = window_start(start, nb);
  const int64_t k_rows = kb * block_rows;
  for (int64_t orow = blockIdx.x; orow < out_rows; orow += gridDim.x) {
    const int64_t g = orow / n_rows, j = orow - g * n_rows;
    int64_t off = j / block_rows - s0;  // in (-nb, nb)
    if (off < 0) off += nb;
    T* dst = out + orow * d;
    if (off < kb) {
      const T* src = vals + (g * k_rows + off * block_rows + j % block_rows) * d;
      if (vec) {
        const uint4* s4 = reinterpret_cast<const uint4*>(src);
        uint4* d4 = reinterpret_cast<uint4*>(dst);
        const int64_t n4 = d / (16 / sizeof(T));
        for (int64_t c = threadIdx.x; c < n4; c += blockDim.x) d4[c] = s4[c];
      } else {
        for (int64_t c = threadIdx.x; c < d; c += blockDim.x) dst[c] = src[c];
      }
    } else if (vec) {
      uint4* d4 = reinterpret_cast<uint4*>(dst);
      const int64_t n4 = d / (16 / sizeof(T));
      for (int64_t c = threadIdx.x; c < n4; c += blockDim.x)
        d4[c] = make_uint4(0u, 0u, 0u, 0u);
    } else {
      for (int64_t c = threadIdx.x; c < d; c += blockDim.x) dst[c] = from_f32<T>(0.0f);
    }
  }
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

extern "C" int randk_decompress_launch(const void* vals, const void* start,
                                       void* out, int64_t groups,
                                       int64_t n_rows, int64_t d,
                                       int64_t k_blocks, int64_t block_rows,
                                       int is_bf16, int vec, void* stream) {
  using namespace repro_torch;
  const int64_t out_rows = groups * n_rows;
  const int64_t nb = n_rows / block_rows;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned grid = row_grid(out_rows);
  if (is_bf16) {
    using T = __nv_bfloat16;
    randk_decompress_kernel<T><<<grid, kThreads, 0, s>>>(
        static_cast<const T*>(vals), static_cast<const int*>(start),
        static_cast<T*>(out), out_rows, n_rows, d, nb, k_blocks,
        (int)block_rows, vec);
  } else {
    randk_decompress_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(vals), static_cast<const int*>(start),
        static_cast<float*>(out), out_rows, n_rows, d, nb, k_blocks,
        (int)block_rows, vec);
  }
  return (int)cudaGetLastError();
}
