// BabyBear field arithmetic (p = 15 * 2^27 + 1 = 2013265921) on canonical
// values held in uint64_t: the storage of gl.cuh, since the port keeps both
// fields in int64 tensors.
//
// The device counterpart of ops/bb.py, with gl.cuh's names. A product of two
// canonical values is below 2^62 and is reduced with one Barrett step:
// q = umulhi64(x, M) with M = floor(2^64 / p) is floor(x / p) or one less,
// so x - q p lies in [0, 2p) and one conditional subtraction makes it
// canonical. That remainder is below 2^32, so it is formed in 32 bits. No
// 64-bit division (the card emulates it in software) and no Montgomery form:
// the twiddle, coset and 1/n tables stay canonical, the same tensors the
// plain versions read. Add and subtract run on 32 bits (a + b < 2p < 2^32).
#pragma once
#include <cstdint>

struct bb {
  static constexpr uint64_t P = 2013265921ull;
  static constexpr uint32_t P32 = 2013265921u;
  static constexpr uint64_t M = 0xFFFFFFFFFFFFFFFFull / P;  // floor(2^64 / p)

  static __device__ __forceinline__ uint64_t add(uint64_t a, uint64_t b) {
    const uint32_t s = (uint32_t)a + (uint32_t)b;
    return s >= P32 ? s - P32 : s;
  }

  static __device__ __forceinline__ uint64_t sub(uint64_t a, uint64_t b) {
    const uint32_t x = (uint32_t)a, y = (uint32_t)b;
    return x >= y ? x - y : x + P32 - y;
  }

  static __device__ __forceinline__ uint64_t mul(uint64_t a, uint64_t b) {
    const uint64_t x = (uint64_t)(uint32_t)a * (uint32_t)b;  // < 2^62
    const uint64_t q = __umul64hi(x, M);
    const uint32_t r = (uint32_t)x - (uint32_t)q * P32;     // x - q p < 2p
    return r >= P32 ? r - P32 : r;
  }

  // s^e from a table of s^(2^b), as gl::pow_bits
  static __device__ __forceinline__ uint64_t pow_bits(const uint64_t* sq,
                                                      uint32_t e) {
    uint64_t r = 1;
    for (int b = 0; e; ++b, e >>= 1) {
      if (e & 1) r = mul(r, sq[b]);
    }
    return r;
  }
};
