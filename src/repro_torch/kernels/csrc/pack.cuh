// The packed wire's byte lattice, shared by every kernel that reads it
// (pack.cu's unpack_slab and unpack_reduce).
//
// A slab row quantizes to integers q in [-L, L] stored biased as the byte
// b = q + L; in nibble mode two consecutive ROWS share one byte, row 2i in
// the low and row 2i + 1 in the high four bits.
#pragma once

#include <stdint.h>

namespace repro_torch {

// the lattice value of padded row `row` from its stored byte
template <bool NIBBLE>
__device__ __forceinline__ uint32_t lattice_of(uint8_t byte, int64_t row) {
  if (NIBBLE) return (row & 1) ? (uint32_t)(byte >> 4) : (uint32_t)(byte & 15u);
  return byte;
}

// the repository's only dequantization: v = (b - L) * scale, two roundings
// as the reference's (b.astype(f32) - L) * scale (the first is exact),
// without an integer-to-float conversion (a slow instruction, which bound
// the decode): 0x4B000000 | b is the float 2^23 + b for b < 2^23, and
// subtracting 2^23 + L from it is exact, so this gives the reference's
// bits. `lifted_levels` is 2^23 + L.
__device__ __forceinline__ float decode_lifted(uint32_t b, float lifted_levels,
                                              float scale) {
  return __fmul_rn(__fsub_rn(__uint_as_float(0x4B000000u | b), lifted_levels),
                   scale);
}

}  // namespace repro_torch
