// The extension fields the provers' FRI and STIR rounds work in, on
// canonical components held in uint64_t registers (bb4's tensors store them
// as 32-bit words, bb4::word; gl2's as 64-bit ones, word_t's default): Goldilocks Fp2 = Fp[u] / (u^2 - 7) (gl2)
// and the BabyBear tower Fp4 = Fp2[v] / (v^2 - (2013265910 + u)) over
// Fp2 = Fp[u] / (u^2 - 11) (bb4), the tower of ops/bb.py (reference
// src/field.rs:64-109). An element is a struct of K components in the
// tensors' order: (c0, c1) for gl2, (c00, c01, c10, c11) for bb4. Every
// function takes and returns canonical components.
//
// gl2's product is the Karatsuba form of ministark_tpu/ops/gl.py::ext_mul
// (:215), which gl_mul.cu's ms_gl_ext_mul launches; bb4's is ops/bb.py's
// fp4_mul, Karatsuba over Fp2, which the port otherwise runs in torch ops.
#pragma once
#include <cstdint>

#include "bb.cuh"
#include "gl.cuh"

struct gl2 {
  static constexpr int K = 2;
  struct V {
    uint64_t c[2];
  };

  static __device__ __forceinline__ V zero() { return V{{0, 0}}; }
  static __device__ __forceinline__ V one() { return V{{1, 0}}; }

  static __device__ __forceinline__ V add(const V& a, const V& b) {
    return V{{gl::add(a.c[0], b.c[0]), gl::add(a.c[1], b.c[1])}};
  }

  static __device__ __forceinline__ V sub(const V& a, const V& b) {
    return V{{gl::sub(a.c[0], b.c[0]), gl::sub(a.c[1], b.c[1])}};
  }

  // v0 = a0 b0, v1 = a1 b1, c0 = v0 + 7 v1, c1 = (a0 + a1)(b0 + b1) - v0 - v1
  static __device__ __forceinline__ V mul(const V& a, const V& b) {
    const uint64_t v0 = gl::mul(a.c[0], b.c[0]);
    const uint64_t v1 = gl::mul(a.c[1], b.c[1]);
    const uint64_t s = gl::mul(gl::add(a.c[0], a.c[1]), gl::add(b.c[0], b.c[1]));
    return V{{gl::add(v0, gl::mul(v1, 7)), gl::sub(gl::sub(s, v0), v1)}};
  }
};

struct bb4 {
  using word = uint32_t;  // a component's storage in the tensors
  static constexpr int K = 4;
  static constexpr uint64_t NR_FP2 = 11;            // u^2 = 11
  static constexpr uint64_t NR_FP4_C0 = 2013265910;  // v^2 = 2013265910 + u
  struct V {
    uint64_t c[4];
  };

  static __device__ __forceinline__ V zero() { return V{{0, 0, 0, 0}}; }
  static __device__ __forceinline__ V one() { return V{{1, 0, 0, 0}}; }

  static __device__ __forceinline__ V add(const V& a, const V& b) {
    V r;
#pragma unroll
    for (int i = 0; i < K; ++i) r.c[i] = bb::add(a.c[i], b.c[i]);
    return r;
  }

  static __device__ __forceinline__ V sub(const V& a, const V& b) {
    V r;
#pragma unroll
    for (int i = 0; i < K; ++i) r.c[i] = bb::sub(a.c[i], b.c[i]);
    return r;
  }

  // Fp2 product (ops/bb.py::fp2_mul): c0 = v0 + 11 v1, c1 = (a0 + a1)(b0 + b1) - v0 - v1
  static __device__ __forceinline__ void fp2_mul(uint64_t a0, uint64_t a1, uint64_t b0,
                                                 uint64_t b1, uint64_t& c0, uint64_t& c1) {
    const uint64_t v0 = bb::mul(a0, b0);
    const uint64_t v1 = bb::mul(a1, b1);
    c0 = bb::add(v0, bb::mul(v1, NR_FP2));
    c1 = bb::sub(bb::mul(bb::add(a0, a1), bb::add(b0, b1)), bb::add(v0, v1));
  }

  // Karatsuba over Fp2 (ops/bb.py::fp4_mul): c0 = v0 + nr v1 with
  // nr (x0 + x1 u) = (k x0 + 11 x1) + (k x1 + x0) u, k = 2013265910 = p - 11,
  // so k x = -11 x and nr (x0 + x1 u) = (11 x1 - 11 x0) + (x0 - 11 x1) u: two
  // products by 11; c1 = (a0 + a1)(b0 + b1) - v0 - v1
  static __device__ __forceinline__ V mul(const V& a, const V& b) {
    static_assert(NR_FP4_C0 == bb::P - NR_FP2, "the Fp4 nonresidue's c0 is -11");
    uint64_t v00, v01, v10, v11, s0, s1;
    fp2_mul(a.c[0], a.c[1], b.c[0], b.c[1], v00, v01);
    fp2_mul(a.c[2], a.c[3], b.c[2], b.c[3], v10, v11);
    fp2_mul(bb::add(a.c[0], a.c[2]), bb::add(a.c[1], a.c[3]), bb::add(b.c[0], b.c[2]),
            bb::add(b.c[1], b.c[3]), s0, s1);
    const uint64_t t = bb::mul(v11, NR_FP2);
    const uint64_t nr0 = bb::sub(t, bb::mul(v10, NR_FP2));
    const uint64_t nr1 = bb::sub(v10, t);
    return V{{bb::add(v00, nr0), bb::add(v01, nr1), bb::sub(s0, bb::add(v00, v10)),
              bb::sub(s1, bb::add(v01, v11))}};
  }
};
