// What the three NTT sources share: the two fields they are instantiated
// for (each kernel is a template on the field struct, gl or bb, with one
// exported symbol per field) and the bit reversal of a row index.
#pragma once
#include <cstdint>

#include "bb.cuh"
#include "gl.cuh"

// the low `bits` bits of v in reverse order
__device__ __forceinline__ uint32_t bit_reverse(uint32_t v, int bits) {
  return bits ? (__brev(v) >> (32 - bits)) : 0u;
}
