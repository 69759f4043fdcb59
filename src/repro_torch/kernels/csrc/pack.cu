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
// Bound on the H100: bytes. Pack must read each rank's slab once and the
// shared uniforms once (not once per rank) and write a byte (or half of
// one) per element plus a scale per row: at the train path's (4, 2000,
// 2048) f32 that is 98.3 MB, 29.35 us at 3.35 TB/s. Unpack reads the bytes
// and scales and writes f32 (at (4, 2000, 2048) 81.9 MB, 24.46 us: the f32
// stores are four fifths of it); unpack_reduce reads C bytes (or nibbles) and C
// scales per output element's row and writes one f32: at (4, 2000, 2048)
// that is 32.8 MB, 9.79 us. About ten f32 operations an element, far below
// the card's balance point.
//
// pack_slab's design: one block per stored row (a pair of rows in nibble
// mode) for ALL R ranks of the stack, so the rows' uniforms are read from
// device memory once and kept in registers for every rank. Each rank's
// row is read once, into registers, with 16-byte loads (4 f32 or 8 bf16
// values a unit); the max-abs is a warp shuffle and one exchange through
// shared memory (NaN-propagating like jnp.max; max is exact, so any order
// gives the reference's bits), and the same registers are then quantized
// and stored 4 bytes (f32) or 8 bytes (bf16) a unit. The next rank's loads
// are issued before this rank's reduction, so they are in flight while the
// block synchronises. A thread holds NU units (1, 2, 4 or 8; templated) of
// each row, at most kPackMaxValues values of one rank, with up to
// kPackMaxThreads threads: the wrapper plans NU and the block from D
// (`pack.py::_pack_plan`; f32 rows up to 16384 wide in byte mode and 8192
// in nibble mode). Wider rows take the wide variant, which reads each
// rank's row twice (max-abs, then quantize) and the uniforms once per
// rank, back to back in one block, so the re-reads come from cache. Rows
// whose width is not a multiple of the 16-byte unit, or views that are not
// 16-byte aligned, take both variants with one value a unit and one-byte
// stores. The reference's association is kept (|x| / amax, then * L), with
// IEEE division (__fdiv_rn) and no contraction (-fmad=false), so the bytes
// equal the plain version's; padding rows (row >= K) quantize a zero value
// against a zero uniform to byte L, with the scale 1e-30 / L.
//
// unpack_slab and unpack_reduce share one design, the flat units below
// (`unit_coords`, `store_unit`): unpack_slab is the case of one rank a
// group, a stack of R slabs as R groups of C = 1, where acc = v_0 and the
// rank loop and the division fall away; its unit is at most 4 packed
// bytes (the wrapper's plan, `pack.py::_slab_unit`): 8-byte units put a
// thread's two float4 stores 32 bytes apart, and measured 10% slower.
// unpack_reduce's design: the bound is the C packed bytes (or nibbles) of
// each output value, read once, and the f32 output, written once. The work
// is flat: a thread takes a unit of 8 packed bytes of one stored row (8
// output values, or in nibble mode 8 of each of rows 2p and 2p + 1, so
// every packed byte is read once), and units are indexed over (groups x
// stored rows x D / 8), so narrow rows fill warps and no pass is ragged.
// For each unit the thread issues the loads of a chunk of ranks
// (kReduceRankChunk) and their row scales through the read-only cache (no
// shared memory, no barrier), and only then decodes (pack.cuh's
// decode_lifted: the reference's bits without an integer-to-float
// conversion, which would otherwise bound the kernel) and accumulates,
// keeping the TPU kernel's schedule exactly: acc = v_0, acc += v_r for
// r = 1..C-1 (each add rounded), then acc / C by IEEE division (a multiply
// by 1 / C where C is a power of two: the same bits); outputs go out as
// evict-first float4 stores, and only the n_rows real rows are written.
// 8-byte units measured faster than 16-byte ones (twice the threads in
// flight at half the registers; 4-byte units were slower again). Where D
// is not a multiple of 8 or a pointer is off the 8-byte grid, the unit is
// 4 bytes, and 1 byte below that (the wrapper's `pack.py::_reduce_unit`).
// Where the TPU kernel carried the sum in its output block across a
// sequential grid over ranks, the rank loop here runs inside the thread,
// in registers.
#include <string.h>

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

// pack_slab: values of one rank's row(s) a thread holds in registers, and
// the widest block (128 registers a thread at most); the wide variant's
// blocks are this wide
constexpr int kPackMaxValues = 32;
constexpr int kPackMaxThreads = 512;

// v = the V values of T at p as f32: one 16-byte load, or one value
template <typename T, int V>
__device__ __forceinline__ void load_vals(const T* p, float (&v)[V]) {
  if constexpr (V == 1) {
    v[0] = to_f32(*p);
  } else {
    static_assert(V * sizeof(T) == 16, "the vector variant loads 16 bytes");
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    T e[V];
    memcpy(e, &raw, 16);
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = to_f32(e[i]);
  }
}

// v = the V uniforms at p: V / 4 16-byte loads, or one value
template <int V>
__device__ __forceinline__ void load_uniforms(const float* p, float (&v)[V]) {
  if constexpr (V == 1) {
    v[0] = *p;
  } else {
#pragma unroll
    for (int q = 0; q < V / 4; ++q) {
      const float4 f = reinterpret_cast<const float4*>(p)[q];
      v[4 * q] = f.x;
      v[4 * q + 1] = f.y;
      v[4 * q + 2] = f.z;
      v[4 * q + 3] = f.w;
    }
  }
}

// V bytes to p in one store (4 or 8 bytes), or one byte
template <int V>
__device__ __forceinline__ void store_bytes(uint8_t* p, const uint32_t (&b)[V]) {
  if constexpr (V == 1) {
    *p = (uint8_t)b[0];
  } else {
    uint32_t w[V / 4];
#pragma unroll
    for (int q = 0; q < V / 4; ++q)
      w[q] = b[4 * q] | b[4 * q + 1] << 8 | b[4 * q + 2] << 16 | b[4 * q + 3] << 24;
    if constexpr (V == 4) *reinterpret_cast<uint32_t*>(p) = w[0];
    else *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
  }
}

// the NaN-propagating max of each v[j] over the block, returned to every
// thread; smem holds kPackMaxThreads / 32 floats per row
template <int ROWS>
__device__ __forceinline__ void block_nan_max_rows(float (&v)[ROWS], float* smem) {
  constexpr int kWarps = kPackMaxThreads / 32;
#pragma unroll
  for (int j = 0; j < ROWS; ++j) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      v[j] = nan_max(v[j], __shfl_xor_sync(0xffffffffu, v[j], o));
  }
  __syncthreads();  // every warp is done reading smem from an earlier call
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int j = 0; j < ROWS; ++j) smem[j * kWarps + (threadIdx.x >> 5)] = v[j];
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < ROWS; ++j) {
    float m = smem[j * kWarps];
    for (int w = 1; w < (int)(blockDim.x >> 5); ++w)
      m = nan_max(m, smem[j * kWarps + w]);
    v[j] = m;
  }
}

// rank r's values of the block's ROWS rows, NU units of V a thread (zeros
// past the row's end and in padding rows)
template <typename T, int ROWS, int V, int NU>
__device__ __forceinline__ void load_rank(float (&x)[ROWS][NU][V],
                                          const T* __restrict__ vals,
                                          int64_t r, int64_t row0, int64_t k,
                                          int d, int units) {
#pragma unroll
  for (int j = 0; j < ROWS; ++j) {
    const int64_t row = row0 + j;
    const T* src = vals + (r * k + row) * d;
#pragma unroll
    for (int n = 0; n < NU; ++n) {
      const int unit = threadIdx.x + n * blockDim.x;
      if (row < k && unit < units) {
        load_vals<T, V>(src + unit * V, x[j][n]);
      } else {
#pragma unroll
        for (int i = 0; i < V; ++i) x[j][n][i] = 0.0f;
      }
    }
  }
}

// The register variant: one block per stored row (a pair of rows in nibble
// mode) for all ranks. The rows' uniforms are read once; each rank's values
// once, the next rank's loads issued before this rank's max-abs.
template <typename T, bool NIBBLE, int V, int NU>
__global__ void __launch_bounds__(kPackMaxThreads, 1)
pack_slab_kernel(const T* __restrict__ vals, const float* __restrict__ u,
                 uint8_t* __restrict__ packed, float* __restrict__ scales,
                 int64_t ranks, int64_t k, int64_t kp, int d, float levels) {
  constexpr int kRows = NIBBLE ? 2 : 1;  // slab rows per stored byte row
  static_assert(kRows * NU * V <= kPackMaxValues, "past the register budget");
  __shared__ float smem[kRows * (kPackMaxThreads / 32)];
  const int units = d / V;  // V divides d
  const int64_t prows = kp / kRows;
  for (int64_t prow = blockIdx.x; prow < prows; prow += gridDim.x) {
    const int64_t row0 = prow * kRows;
    float uu[kRows][NU][V], cur[kRows][NU][V], nxt[kRows][NU][V];
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const int64_t row = row0 + j;
#pragma unroll
      for (int n = 0; n < NU; ++n) {
        const int unit = threadIdx.x + n * blockDim.x;
        if (row < k && unit < units) {
          load_uniforms<V>(u + row * d + unit * V, uu[j][n]);
        } else {  // padding rows: zero value, zero uniform
#pragma unroll
          for (int i = 0; i < V; ++i) uu[j][n][i] = 0.0f;
        }
      }
    }
    load_rank<T, kRows, V, NU>(cur, vals, 0, row0, k, d, units);
    for (int64_t r = 0; r < ranks; ++r) {
      if (r + 1 < ranks) load_rank<T, kRows, V, NU>(nxt, vals, r + 1, row0, k, d, units);
      float amax[kRows];
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        amax[j] = 0.0f;
#pragma unroll
        for (int n = 0; n < NU; ++n) {
#pragma unroll
          for (int i = 0; i < V; ++i) amax[j] = nan_max(amax[j], fabsf(cur[j][n][i]));
        }
      }
      block_nan_max_rows<kRows>(amax, smem);
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        amax[j] = __fadd_rn(amax[j], 1e-30f);
        if (threadIdx.x == 0) scales[r * kp + row0 + j] = __fdiv_rn(amax[j], levels);
      }
      uint8_t* dst = packed + (r * prows + prow) * d;
#pragma unroll
      for (int n = 0; n < NU; ++n) {
        const int unit = threadIdx.x + n * blockDim.x;
        if (unit >= units) continue;
        uint32_t b[V];
#pragma unroll
        for (int i = 0; i < V; ++i) {
          b[i] = 0;
#pragma unroll
          for (int j = 0; j < kRows; ++j)
            b[i] |= quantize_lattice(cur[j][n][i], uu[j][n][i], amax[j], levels) << (4 * j);
        }
        store_bytes<V>(dst + unit * V, b);
      }
      if (r + 1 < ranks) {
#pragma unroll
        for (int j = 0; j < kRows; ++j) {
#pragma unroll
          for (int n = 0; n < NU; ++n) {
#pragma unroll
            for (int i = 0; i < V; ++i) cur[j][n][i] = nxt[j][n][i];
          }
        }
      }
    }
  }
}

// The wide variant, for rows past the register budget: the same block per
// stored row for all ranks, two passes over each rank's row (max-abs, then
// quantize: the second read and the uniforms' re-reads for later ranks come
// from cache, as the block reads them back to back).
template <typename T, bool NIBBLE, int V>
__global__ void __launch_bounds__(kPackMaxThreads)
pack_slab_wide_kernel(const T* __restrict__ vals, const float* __restrict__ u,
                      uint8_t* __restrict__ packed, float* __restrict__ scales,
                      int64_t ranks, int64_t k, int64_t kp, int d,
                      float levels) {
  constexpr int kRows = NIBBLE ? 2 : 1;
  __shared__ float smem[kRows * (kPackMaxThreads / 32)];
  const int units = d / V;
  const int64_t prows = kp / kRows;
  for (int64_t prow = blockIdx.x; prow < prows; prow += gridDim.x) {
    const int64_t row0 = prow * kRows;
    for (int64_t r = 0; r < ranks; ++r) {
      float amax[kRows];
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        amax[j] = 0.0f;
        if (row0 + j >= k) continue;
        const T* src = vals + (r * k + row0 + j) * d;
        for (int unit = threadIdx.x; unit < units; unit += blockDim.x) {
          float x[V];
          load_vals<T, V>(src + unit * V, x);
#pragma unroll
          for (int i = 0; i < V; ++i) amax[j] = nan_max(amax[j], fabsf(x[i]));
        }
      }
      block_nan_max_rows<kRows>(amax, smem);
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        amax[j] = __fadd_rn(amax[j], 1e-30f);
        if (threadIdx.x == 0) scales[r * kp + row0 + j] = __fdiv_rn(amax[j], levels);
      }
      uint8_t* dst = packed + (r * prows + prow) * d;
      for (int unit = threadIdx.x; unit < units; unit += blockDim.x) {
        uint32_t b[V];
#pragma unroll
        for (int i = 0; i < V; ++i) b[i] = 0;
#pragma unroll
        for (int j = 0; j < kRows; ++j) {
          const int64_t row = row0 + j;
          float x[V], uu[V];
          if (row < k) {
            load_vals<T, V>(vals + (r * k + row) * d + unit * V, x);
            load_uniforms<V>(u + row * d + unit * V, uu);
          } else {  // padding rows: zero value, zero uniform
#pragma unroll
            for (int i = 0; i < V; ++i) x[i] = uu[i] = 0.0f;
          }
#pragma unroll
          for (int i = 0; i < V; ++i)
            b[i] |= quantize_lattice(x[i], uu[i], amax[j], levels) << (4 * j);
        }
        store_bytes<V>(dst + unit * V, b);
      }
    }
  }
}

template <typename T, bool NIBBLE, int V, int NU>
cudaError_t launch_pack_rows(const T* x, const float* u, uint8_t* p, float* sc,
                             int64_t ranks, int64_t k, int64_t kp, int d,
                             float levels, int threads, cudaStream_t s) {
  if constexpr ((NIBBLE ? 2 : 1) * NU * V > kPackMaxValues) {
    return cudaErrorInvalidValue;  // the wrapper never plans it
  } else {
    if (threads < 32 || threads > kPackMaxThreads || threads % 32 ||
        (int64_t)threads * NU * V < d)
      return cudaErrorInvalidValue;
    const unsigned grid = row_grid(NIBBLE ? kp / 2 : kp);
    pack_slab_kernel<T, NIBBLE, V, NU><<<grid, threads, 0, s>>>(
        x, u, p, sc, ranks, k, kp, d, levels);
    return cudaGetLastError();
  }
}

template <typename T, bool NIBBLE, int V>
cudaError_t launch_pack(const void* vals, const void* u, void* packed,
                        void* scales, int64_t ranks, int64_t k, int64_t kp,
                        int d, float levels, int nu, int threads,
                        cudaStream_t s) {
  const T* x = static_cast<const T*>(vals);
  const float* uf = static_cast<const float*>(u);
  uint8_t* p = static_cast<uint8_t*>(packed);
  float* sc = static_cast<float*>(scales);
  switch (nu) {
    case 0:
      pack_slab_wide_kernel<T, NIBBLE, V><<<row_grid(NIBBLE ? kp / 2 : kp),
                                             kPackMaxThreads, 0, s>>>(
          x, uf, p, sc, ranks, k, kp, d, levels);
      return cudaGetLastError();
    case 1: return launch_pack_rows<T, NIBBLE, V, 1>(x, uf, p, sc, ranks, k, kp, d, levels, threads, s);
    case 2: return launch_pack_rows<T, NIBBLE, V, 2>(x, uf, p, sc, ranks, k, kp, d, levels, threads, s);
    case 4: return launch_pack_rows<T, NIBBLE, V, 4>(x, uf, p, sc, ranks, k, kp, d, levels, threads, s);
    case 8: return launch_pack_rows<T, NIBBLE, V, 8>(x, uf, p, sc, ranks, k, kp, d, levels, threads, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_pack_type(const void* vals, const void* u, void* packed,
                             void* scales, int64_t ranks, int64_t k, int64_t kp,
                             int d, float levels, bool nibble, bool vec,
                             int nu, int threads, cudaStream_t s) {
  constexpr int kV = 16 / sizeof(T);
  if (nibble)
    return vec ? launch_pack<T, true, kV>(vals, u, packed, scales, ranks, k, kp, d, levels, nu, threads, s)
               : launch_pack<T, true, 1>(vals, u, packed, scales, ranks, k, kp, d, levels, nu, threads, s);
  return vec ? launch_pack<T, false, kV>(vals, u, packed, scales, ranks, k, kp, d, levels, nu, threads, s)
             : launch_pack<T, false, 1>(vals, u, packed, scales, ranks, k, kp, d, levels, nu, threads, s);
}

// The W packed bytes of one stored row of one rank at p, W = 8, 4 or 1
template <int W> struct PackedWord;
template <> struct PackedWord<8> { using type = uint2; };
template <> struct PackedWord<4> { using type = uint32_t; };
template <> struct PackedWord<1> { using type = uint8_t; };

// unpack_reduce: ranks whose loads one thread keeps in flight at once
constexpr int kReduceRankChunk = 4;

// A unit is W packed bytes of one stored row p of one group: W output
// values of row p in byte mode, W of each of rows 2p and 2p + 1 in nibble
// mode (the second only where it is < n_rows). Units are flat over (group,
// stored row, W-column unit); `per_row` divides by the units of a row,
// `per_group` by the stored rows that hold output rows. Both decoders index
// and store their units here.
template <int W, typename I>
__device__ __forceinline__ void unit_coords(I unit, Divider<I> per_row,
                                            Divider<I> per_group, I& g, I& p,
                                            I& c) {
  const I row = per_row.div(unit);  // g * srows + p
  c = (unit - row * per_row.d) * W;
  g = per_group.div(row);
  p = row - g * per_group.d;
}

// a unit's values to its output rows of group g, float4 stores (W >= 4),
// marked evict-first (`__stcs`): the f32 output is written once and read
// by a later kernel, and streaming it through the cache without keeping it
// leaves the packed inputs there (measured 7% faster for unpack_slab at
// (4, 2000, 2048), 23% for unpack_reduce at (4, 976, 5632))
template <int ROWS, int W, typename I>
__device__ __forceinline__ void store_unit(float* __restrict__ out,
                                           const float (&v)[ROWS][W], I g,
                                           I p, I c, I n_rows, I d) {
  float* dst = out + (g * n_rows + p * ROWS) * d + c;
#pragma unroll
  for (int h = 0; h < ROWS; ++h) {
    if (p * ROWS + h >= n_rows) break;
    float* o = dst + (I)h * d;
    if (W == 1) {
      __stcs(o, v[h][0]);
    } else {
#pragma unroll
      for (int j = 0; j < W; j += 4)
        __stcs(reinterpret_cast<float4*>(o + j),
               make_float4(v[h][j], v[h][j + 1], v[h][j + 2], v[h][j + 3]));
    }
  }
}

// unpack_slab: a stack of R slabs as R groups of one rank. A thread takes
// one unit of at most 4 packed bytes (the wrapper's plan), so that each
// float4 store of a warp covers 512 contiguous bytes: the stores are four
// fifths of the bytes moved. acc = v_0, no rank loop, no division.
template <bool NIBBLE, int W, typename I>
__global__ void __launch_bounds__(kThreads)
unpack_slab_kernel(const uint8_t* __restrict__ packed,
                   const float* __restrict__ scales, float* __restrict__ out,
                   I units, Divider<I> per_row, Divider<I> per_group,
                   I n_rows, I kp, I d, float levels) {
  using Word = typename PackedWord<W>::type;
  constexpr int kRows = NIBBLE ? 2 : 1;
  const I prows = kp / kRows;  // stored rows of one slab
  const float lifted_levels = __fadd_rn(8388608.0f, levels);  // 2^23 + L, exact
  for (I unit = (I)blockIdx.x * kThreads + threadIdx.x; unit < units;
       unit += (I)gridDim.x * kThreads) {
    I g, p, c;
    unit_coords<W>(unit, per_row, per_group, g, p, c);
    const Word word = __ldg(reinterpret_cast<const Word*>(
        packed + (g * prows + p) * d + c));
    float scale[kRows];
#pragma unroll
    for (int h = 0; h < kRows; ++h)
      scale[h] = __ldg(scales + g * kp + p * kRows + h);
    uint8_t b[W];
    memcpy(b, &word, W);
    float v[kRows][W];
#pragma unroll
    for (int h = 0; h < kRows; ++h)
#pragma unroll
      for (int j = 0; j < W; ++j)
        v[h][j] = decode_lifted(lattice_of<NIBBLE>(b[j], h), lifted_levels,
                                scale[h]);
    store_unit<kRows, W>(out, v, g, p, c, n_rows, d);
  }
}

// unpack_reduce: for each unit the group's C ranks in chunks, every load of
// a chunk (bytes and row scales) first, then decode and add in rank order,
// then acc / C.
template <bool NIBBLE, int W, typename I>
__global__ void __launch_bounds__(kThreads)
unpack_reduce_kernel(const uint8_t* __restrict__ packed,
                     const float* __restrict__ scales, float* __restrict__ out,
                     I units, Divider<I> per_row, Divider<I> per_group,
                     int ranks, I n_rows, I kp, I d, float levels) {
  using Word = typename PackedWord<W>::type;
  constexpr int kRows = NIBBLE ? 2 : 1;
  constexpr int kChunk = kReduceRankChunk;
  const I prows = kp / kRows;  // stored rows of one rank
  const I rank_stride = prows * d;
  // acc / C; for C a power of two, acc * (1 / C) is the same correctly
  // rounded quotient (subnormals included) in one instruction
  const float divisor = (float)ranks, inverse = 1.0f / divisor;
  const bool pow2 = (ranks & (ranks - 1)) == 0;
  const float lifted_levels = __fadd_rn(8388608.0f, levels);  // 2^23 + L, exact
  for (I unit = (I)blockIdx.x * kThreads + threadIdx.x; unit < units;
       unit += (I)gridDim.x * kThreads) {
    I g, p, c;
    unit_coords<W>(unit, per_row, per_group, g, p, c);
    const uint8_t* src = packed + (g * ranks * prows + p) * d + c;
    const float* sc = scales + g * ranks * kp + p * kRows;
    float acc[kRows][W];
#pragma unroll
    for (int h = 0; h < kRows; ++h)
#pragma unroll
      for (int j = 0; j < W; ++j) acc[h][j] = 0.0f;
    for (int r0 = 0; r0 < ranks; r0 += kChunk) {
      // every load of the chunk first: the bytes and the row scales
      Word word[kChunk];
      float scale[kChunk][kRows];
#pragma unroll
      for (int k = 0; k < kChunk; ++k) {
        if (r0 + k < ranks) {
          word[k] = __ldg(reinterpret_cast<const Word*>(src + (I)(r0 + k) * rank_stride));
#pragma unroll
          for (int h = 0; h < kRows; ++h)
            scale[k][h] = __ldg(sc + (I)(r0 + k) * kp + h);
        }
      }
      // then decode and add in rank order: acc = v_0, acc += v_r
#pragma unroll
      for (int k = 0; k < kChunk; ++k) {
        if (r0 + k < ranks) {
          uint8_t b[W];
          memcpy(b, &word[k], W);
#pragma unroll
          for (int h = 0; h < kRows; ++h)
#pragma unroll
            for (int j = 0; j < W; ++j) {
              const float v = decode_lifted(lattice_of<NIBBLE>(b[j], h),
                                            lifted_levels, scale[k][h]);
              acc[h][j] = r0 + k == 0 ? v : __fadd_rn(acc[h][j], v);
            }
        }
      }
    }
#pragma unroll
    for (int h = 0; h < kRows; ++h)
#pragma unroll
      for (int j = 0; j < W; ++j)
        acc[h][j] = pow2 ? __fmul_rn(acc[h][j], inverse) : __fdiv_rn(acc[h][j], divisor);
    store_unit<kRows, W>(out, acc, g, p, c, n_rows, d);
  }
}

template <bool SLAB, bool NIBBLE, int W, typename I>
void launch_units(cudaStream_t s, const uint8_t* p, const float* sc, float* o,
                  int64_t units, int64_t srows, int64_t ranks, int64_t n_rows,
                  int64_t kp, int64_t d, float levels) {
  const Divider<I> per_row = make_divider<I>((I)(d / W));
  const Divider<I> per_group = make_divider<I>((I)srows);
  const unsigned grid = flat_grid(units, 1);
  if constexpr (SLAB)
    unpack_slab_kernel<NIBBLE, W, I><<<grid, kThreads, 0, s>>>(
        p, sc, o, (I)units, per_row, per_group, (I)n_rows, (I)kp, (I)d, levels);
  else
    unpack_reduce_kernel<NIBBLE, W, I><<<grid, kThreads, 0, s>>>(
        p, sc, o, (I)units, per_row, per_group, (int)ranks, (I)n_rows, (I)kp,
        (I)d, levels);
}

template <bool SLAB, bool NIBBLE, int W>
cudaError_t launch_unpack(const void* packed, const void* scales, void* out,
                          int64_t groups, int64_t ranks, int64_t n_rows,
                          int64_t kp, int64_t d, float levels, cudaStream_t s) {
  constexpr int kRows = NIBBLE ? 2 : 1;
  const int64_t srows = (n_rows + kRows - 1) / kRows;  // rows that hold output
  const int64_t units = groups * srows * (d / W);
  const uint8_t* p = static_cast<const uint8_t*>(packed);
  const float* sc = static_cast<const float*>(scales);
  float* o = static_cast<float*>(out);
  // every index the kernel forms is below groups * C * Kp * D
  if (groups * ranks * kp * d < kIndex32)
    launch_units<SLAB, NIBBLE, W, uint32_t>(s, p, sc, o, units, srows, ranks,
                                            n_rows, kp, d, levels);
  else
    launch_units<SLAB, NIBBLE, W, uint64_t>(s, p, sc, o, units, srows, ranks,
                                            n_rows, kp, d, levels);
  return cudaGetLastError();
}

// unit: packed bytes of one stored row a thread takes, 8 (unpack_reduce
// only), 4 or 1: the wrapper's plan from D and the pointers' alignment
template <bool SLAB, bool NIBBLE>
cudaError_t launch_unpack_width(const void* packed, const void* scales,
                                void* out, int64_t groups, int64_t ranks,
                                int64_t n_rows, int64_t kp, int64_t d,
                                float levels, int unit, cudaStream_t s) {
  if constexpr (!SLAB) {
    if (unit == 8 && d % 8 == 0)
      return launch_unpack<SLAB, NIBBLE, 8>(packed, scales, out, groups, ranks, n_rows, kp, d, levels, s);
  }
  if (unit == 4 && d % 4 == 0)
    return launch_unpack<SLAB, NIBBLE, 4>(packed, scales, out, groups, ranks, n_rows, kp, d, levels, s);
  if (unit == 1)
    return launch_unpack<SLAB, NIBBLE, 1>(packed, scales, out, groups, ranks, n_rows, kp, d, levels, s);
  return cudaErrorInvalidValue;
}

}  // namespace repro_torch

// vec: 1 for the 16-byte variant (16 / itemsize values a unit: D a multiple
// of it, vals and u 16-byte aligned), 0 for one value a unit; nu: units a
// thread holds (1, 2, 4 or 8) with `threads` threads a block, or 0 for the
// wide variant
extern "C" int pack_slab_launch(const void* vals, const void* u, void* packed,
                                void* scales, int64_t ranks, int64_t k,
                                int64_t kp, int64_t d, float levels,
                                int nibble, int is_bf16, int vec, int nu,
                                int threads, void* stream) {
  using namespace repro_torch;
  if (d <= 0 || d >= (int64_t(1) << 31)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return (int)launch_pack_type<__nv_bfloat16>(vals, u, packed, scales, ranks, k, kp, (int)d,
                                                levels, nibble != 0, vec != 0, nu, threads, s);
  return (int)launch_pack_type<float>(vals, u, packed, scales, ranks, k, kp, (int)d, levels,
                                      nibble != 0, vec != 0, nu, threads, s);
}

extern "C" int unpack_slab_launch(const void* packed, const void* scales,
                                  void* out, int64_t ranks, int64_t n_rows,
                                  int64_t kp, int64_t d, float levels,
                                  int nibble, int unit, void* stream) {
  using namespace repro_torch;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // a stack of R slabs is R groups of one rank
  if (nibble)
    return (int)launch_unpack_width<true, true>(packed, scales, out, ranks, 1, n_rows, kp, d, levels,
                                                unit, s);
  return (int)launch_unpack_width<true, false>(packed, scales, out, ranks, 1, n_rows, kp, d, levels,
                                               unit, s);
}

extern "C" int unpack_reduce_launch(const void* packed, const void* scales,
                                    void* out, int64_t groups, int64_t ranks,
                                    int64_t n_rows, int64_t kp, int64_t d,
                                    float levels, int nibble, int unit,
                                    void* stream) {
  using namespace repro_torch;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nibble)
    return (int)launch_unpack_width<false, true>(packed, scales, out, groups, ranks, n_rows, kp, d,
                                                 levels, unit, s);
  return (int)launch_unpack_width<false, false>(packed, scales, out, groups, ranks, n_rows, kp, d,
                                                levels, unit, s);
}
