// Goldilocks field arithmetic (p = 2^64 - 2^32 + 1) on canonical uint64_t.
//
// The device counterpart of ops/field.py: a product is the full 128-bit
// value from a * b and __umul64hi, reduced with 2^64 == 2^32 - 1 and
// 2^96 == -1 (mod p), the identities of ministark_tpu/ops/gl.py::_reduce128.
// Every function takes and returns canonical values (< p). A struct of
// static functions, so that the NTT kernels take the field as a template
// argument (bb.cuh has the same names).
#pragma once
#include <cstdint>

struct gl {
  static constexpr uint64_t P = 0xFFFFFFFF00000001ull;
  static constexpr uint64_t EPS = 0xFFFFFFFFull;  // 2^64 mod p

  static __device__ __forceinline__ uint64_t add(uint64_t a, uint64_t b) {
    uint64_t s = a + b;
    // a carry out of 2^64 is worth EPS; a + b < 2p, so it cannot carry twice
    if (s < a) s += EPS;
    return s >= P ? s - P : s;
  }

  static __device__ __forceinline__ uint64_t sub(uint64_t a, uint64_t b) {
    uint64_t d = a - b;
    // a borrow wrapped by 2^64: subtracting EPS makes it a - b + p
    return a < b ? d - EPS : d;
  }

  static __device__ __forceinline__ uint64_t reduce128(uint64_t lo, uint64_t hi) {
    const uint64_t hi_hi = hi >> 32;  // weight 2^96 == -1
    const uint64_t hi_lo = hi & EPS;  // weight 2^64 == EPS
    uint64_t t = lo - hi_hi;
    if (lo < hi_hi) t -= EPS;         // borrow; t >= 2^64 - 2^32 cannot underflow
    const uint64_t m = hi_lo * EPS;   // < 2^64
    uint64_t r = t + m;
    if (r < m) r += EPS;              // carry; cannot carry twice
    return r >= P ? r - P : r;
  }

  static __device__ __forceinline__ uint64_t mul(uint64_t a, uint64_t b) {
    return reduce128(a * b, __umul64hi(a, b));
  }

  // s^e as the product over the set bits b of e of sq[b] = s^(2^b): a coset
  // offset's power from a table of its squares
  static __device__ __forceinline__ uint64_t pow_bits(const uint64_t* sq,
                                                      uint32_t e) {
    uint64_t r = 1;
    for (int b = 0; e; ++b, e >>= 1) {
      if (e & 1) r = mul(r, sq[b]);
    }
    return r;
  }
};
