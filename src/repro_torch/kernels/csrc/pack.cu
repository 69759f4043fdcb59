// Quantize + bit-pack wire slabs, decode them back, and reduce a gathered
// stack of them to its mean.
//
// Replaces the TPU kernels src/repro/kernels/pack.py · pack_slab
// (_pack_kernel, pl.pallas_call at :142), unpack_slab (_unpack_kernel,
// pl.pallas_call at :174) and unpack_reduce (_unpack_reduce_kernel,
// pl.pallas_call at :199). For each row of a (K, D) slab, padded with zero
// rows to Kp = K rounded up to 8:
//   amax = max|x| + 1e-30,  y = |x| / amax * L,  f = floor(y)
//   q = min(f + [u < y - f], L),  b = sign(x) * q + L,  scale = amax / L
// (padding rows give b = L, which decodes to 0); nibble mode stores rows 2i
// and 2i + 1 as lo | hi << 4. Decoding is v = (b - L) * scale (pack.cuh).
// A stack of R slabs (one per rank) shares the one (K, D) array of
// uniforms, as the wire's ranks share the rounding draw. unpack_reduce
// takes G groups of C gathered slabs and gives each group's mean
// (sum_r v_r) / C, accumulated in rank order.
//
// Bound on the H100: bytes. Pack reads the slab and the uniforms once and
// writes a byte (or half of one) per element plus a scale per row; unpack
// reads the bytes and scales and writes f32; unpack_reduce reads C bytes
// (or nibbles) and C scales per output element's row and writes one f32.
// About ten f32 operations an element, far below the card's balance point.
//
// Design: one block per row (per pair of rows in nibble mode): a strided
// pass takes the row's max-abs (warp shuffle, then the warps' maxima in
// shared memory, NaN-propagating like jnp.max), a second pass quantizes
// and stores; the row (at most 22 KB at the path's widths) is read twice,
// the second time mostly from L2. The reference's association is kept
// (|x| / amax, then * L), with IEEE division (__fdiv_rn) and no contraction
// (-fmad=false), so the bytes equal the plain version's. Unpack gives one
// block to each output row; the decode is pack.cuh's device function.
// unpack_reduce gives one block to each output row of a group: the block
// reads the row's C scales into shared memory once, and each thread takes
// four columns at a time (one 4-byte load per rank) where D allows, keeping
// the TPU kernel's schedule exactly: acc = v_0, acc += v_r for r = 1..C-1
// (each add rounded), then acc / C by IEEE division; only the n_rows real
// rows are written. Where the TPU kernel carried the sum in its output
// block across a sequential grid over ranks, the rank loop here runs inside
// the thread, in registers.
#include "common.cuh"
#include "pack.cuh"

namespace repro_torch {

__device__ __forceinline__ uint32_t quantize_lattice(float x, float u,
                                                     float amax, float levels) {
  const float y = __fmul_rn(__fdiv_rn(fabsf(x), amax), levels);
  const float f = floorf(y);
  const float q = fminf(__fadd_rn(f, u < __fsub_rn(y, f) ? 1.0f : 0.0f), levels);
  const float sg = x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f);
  return (uint32_t)(int)__fadd_rn(__fmul_rn(sg, q), levels);
}

template <typename T, bool NIBBLE>
__global__ void __launch_bounds__(kThreads)
pack_slab_kernel(const T* __restrict__ vals, const float* __restrict__ u,
                 uint8_t* __restrict__ packed, float* __restrict__ scales,
                 int64_t units, int64_t k, int64_t kp, int64_t d,
                 float levels) {
  constexpr int kRows = NIBBLE ? 2 : 1;  // slab rows per stored byte row
  __shared__ float smem[kThreads / 32];
  const int64_t units_per_slab = kp / kRows;
  for (int64_t unit = blockIdx.x; unit < units; unit += gridDim.x) {
    const int64_t r = unit / units_per_slab;
    const int64_t prow = unit - r * units_per_slab;  // stored byte row
    const int64_t row0 = prow * kRows;               // first padded slab row
    float amax[kRows];
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const int64_t row = row0 + j;
      float m = 0.0f;
      if (row < k) {
        const T* x = vals + (r * k + row) * d;
        for (int64_t c = threadIdx.x; c < d; c += blockDim.x)
          m = nan_max(m, fabsf(to_f32(x[c])));
      }
      amax[j] = __fadd_rn(block_nan_max(m, smem), 1e-30f);
      if (threadIdx.x == 0) scales[r * kp + row] = __fdiv_rn(amax[j], levels);
    }
    uint8_t* dst = packed + (r * units_per_slab + prow) * d;
    for (int64_t c = threadIdx.x; c < d; c += blockDim.x) {
      uint32_t byte = 0;
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        const int64_t row = row0 + j;
        float x = 0.0f, uu = 0.0f;  // padding rows: zero value, zero uniform
        if (row < k) {
          x = to_f32(vals[(r * k + row) * d + c]);
          uu = u[row * d + c];
        }
        byte |= quantize_lattice(x, uu, amax[j], levels) << (4 * j);
      }
      dst[c] = (uint8_t)byte;
    }
  }
}

template <bool NIBBLE>
__global__ void __launch_bounds__(kThreads)
unpack_slab_kernel(const uint8_t* __restrict__ packed,
                   const float* __restrict__ scales, float* __restrict__ out,
                   int64_t out_rows, int64_t n_rows, int64_t kp, int64_t d,
                   float levels) {
  constexpr int kRows = NIBBLE ? 2 : 1;
  for (int64_t orow = blockIdx.x; orow < out_rows; orow += gridDim.x) {
    const int64_t r = orow / n_rows, i = orow - r * n_rows;
    const float scale = scales[r * kp + i];
    const uint8_t* src = packed + (r * (kp / kRows) + i / kRows) * d;
    float* dst = out + orow * d;
    for (int64_t c = threadIdx.x; c < d; c += blockDim.x)
      dst[c] = decode_lattice(lattice_of<NIBBLE>(src[c], i), levels, scale);
  }
}

template <bool NIBBLE>
__global__ void __launch_bounds__(kThreads)
unpack_reduce_kernel(const uint8_t* __restrict__ packed,
                     const float* __restrict__ scales, float* __restrict__ out,
                     int64_t out_rows, int64_t ranks, int64_t n_rows,
                     int64_t kp, int64_t d, float levels, bool vec) {
  constexpr int kRows = NIBBLE ? 2 : 1;
  extern __shared__ float row_scales[];  // the row's scale of each rank
  const int64_t prows = kp / kRows;
  const float divisor = (float)ranks;
  for (int64_t orow = blockIdx.x; orow < out_rows; orow += gridDim.x) {
    const int64_t g = orow / n_rows, i = orow - g * n_rows;
    __syncthreads();  // the previous row's scales are no longer read
    for (int64_t r = threadIdx.x; r < ranks; r += blockDim.x)
      row_scales[r] = scales[(g * ranks + r) * kp + i];
    __syncthreads();
    // rank r's stored byte row of output row i
    const uint8_t* src = packed + (g * ranks * prows + i / kRows) * d;
    const int64_t rank_stride = prows * d;
    float* dst = out + orow * d;
    if (vec) {  // d % 4 == 0: 4-byte loads, 16-byte stores
      for (int64_t c = 4 * (int64_t)threadIdx.x; c < d; c += 4 * blockDim.x) {
        float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        for (int64_t r = 0; r < ranks; ++r) {
          const uint32_t word =
              *reinterpret_cast<const uint32_t*>(src + r * rank_stride + c);
          const float s = row_scales[r];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float v = decode_lattice(
                lattice_of<NIBBLE>((uint8_t)(word >> (8 * j)), i), levels, s);
            acc[j] = r == 0 ? v : __fadd_rn(acc[j], v);
          }
        }
        *reinterpret_cast<float4*>(dst + c) =
            make_float4(__fdiv_rn(acc[0], divisor), __fdiv_rn(acc[1], divisor),
                        __fdiv_rn(acc[2], divisor), __fdiv_rn(acc[3], divisor));
      }
    } else {
      for (int64_t c = threadIdx.x; c < d; c += blockDim.x) {
        float acc = 0.0f;
        for (int64_t r = 0; r < ranks; ++r) {
          const float v = decode_lattice(
              lattice_of<NIBBLE>(src[r * rank_stride + c], i), levels,
              row_scales[r]);
          acc = r == 0 ? v : __fadd_rn(acc, v);
        }
        dst[c] = __fdiv_rn(acc, divisor);
      }
    }
  }
}

}  // namespace repro_torch

extern "C" int pack_slab_launch(const void* vals, const void* u, void* packed,
                                void* scales, int64_t ranks, int64_t k,
                                int64_t kp, int64_t d, float levels,
                                int nibble, int is_bf16, void* stream) {
  using namespace repro_torch;
  const int64_t units = ranks * (nibble ? kp / 2 : kp);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned grid = row_grid(units);
  const float* uf = static_cast<const float*>(u);
  uint8_t* p = static_cast<uint8_t*>(packed);
  float* sc = static_cast<float*>(scales);
  if (is_bf16) {
    using T = __nv_bfloat16;
    const T* x = static_cast<const T*>(vals);
    if (nibble)
      pack_slab_kernel<T, true><<<grid, kThreads, 0, s>>>(x, uf, p, sc, units, k, kp, d, levels);
    else
      pack_slab_kernel<T, false><<<grid, kThreads, 0, s>>>(x, uf, p, sc, units, k, kp, d, levels);
  } else {
    const float* x = static_cast<const float*>(vals);
    if (nibble)
      pack_slab_kernel<float, true><<<grid, kThreads, 0, s>>>(x, uf, p, sc, units, k, kp, d, levels);
    else
      pack_slab_kernel<float, false><<<grid, kThreads, 0, s>>>(x, uf, p, sc, units, k, kp, d, levels);
  }
  return (int)cudaGetLastError();
}

extern "C" int unpack_slab_launch(const void* packed, const void* scales,
                                  void* out, int64_t ranks, int64_t n_rows,
                                  int64_t kp, int64_t d, float levels,
                                  int nibble, void* stream) {
  using namespace repro_torch;
  const int64_t out_rows = ranks * n_rows;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned grid = row_grid(out_rows);
  const uint8_t* p = static_cast<const uint8_t*>(packed);
  const float* sc = static_cast<const float*>(scales);
  float* o = static_cast<float*>(out);
  if (nibble)
    unpack_slab_kernel<true><<<grid, kThreads, 0, s>>>(p, sc, o, out_rows, n_rows, kp, d, levels);
  else
    unpack_slab_kernel<false><<<grid, kThreads, 0, s>>>(p, sc, o, out_rows, n_rows, kp, d, levels);
  return (int)cudaGetLastError();
}

extern "C" int unpack_reduce_launch(const void* packed, const void* scales,
                                    void* out, int64_t groups, int64_t ranks,
                                    int64_t n_rows, int64_t kp, int64_t d,
                                    float levels, int nibble, int vec,
                                    void* stream) {
  using namespace repro_torch;
  const int64_t out_rows = groups * n_rows;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned grid = row_grid(out_rows);
  const size_t smem = (size_t)ranks * sizeof(float);
  const uint8_t* p = static_cast<const uint8_t*>(packed);
  const float* sc = static_cast<const float*>(scales);
  float* o = static_cast<float*>(out);
  if (nibble)
    unpack_reduce_kernel<true><<<grid, kThreads, smem, s>>>(p, sc, o, out_rows, ranks, n_rows, kp, d, levels, vec != 0);
  else
    unpack_reduce_kernel<false><<<grid, kThreads, smem, s>>>(p, sc, o, out_rows, ranks, n_rows, kp, d, levels, vec != 0);
  return (int)cudaGetLastError();
}
