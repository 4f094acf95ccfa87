// BabyBear field arithmetic (p = 15 * 2^27 + 1 = 2013265921) on canonical
// values. The tensors hold a value in 32 bits (bb::word, int32 tensors, as
// the JAX package holds it in one u32 lane); the kernels load a word into a
// uint64_t register, run the same arithmetic as Goldilocks' kernels do on
// gl.cuh, and store the low 32 bits. word_t<F> names a field's storage word:
// bb::word, or uint64_t for a field that names none (gl.cuh).
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
#include <type_traits>

struct bb {
  using word = uint32_t;  // a value's storage in the tensors
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
};

template <class F, class = void>
struct word_of {
  using type = uint64_t;
};

template <class F>
struct word_of<F, std::void_t<typename F::word>> {
  using type = typename F::word;
};

// the storage word of field (or extension) F's tensors
template <class F>
using word_t = typename word_of<F>::type;
