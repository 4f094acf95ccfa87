// What the shared-memory NTT passes share (csrc/ntt.cu, csrc/ntt_four_step.cu
// and csrc/ntt_pipe.cu): the tile's padded rows, the coset power from two
// tables, and the radix-8 stages a thread runs in registers.
//
// A tile holds 2^L positions of 2^log_c adjacent columns; an address map
// gives the word of position m, column c. RowMajor puts it at
// s[(rows(m) << log_c) + c]: PadRows adds one padding row every 8, so that a
// warp whose lanes take C columns of 32 / C consecutive positions, or the 8
// groups of a stage round, meets no bank conflict.
#pragma once
#include <cstdint>
#include <type_traits>

#include "ntt_common.cuh"

// the shared-memory row of tile position m: one padding row every 8
__device__ __forceinline__ uint32_t srow(uint32_t m) { return m + (m >> 3); }

struct PadRows {
  __device__ __forceinline__ uint32_t operator()(uint32_t m) const {
    return srow(m);
  }
};

// the word of position m, column c: row rows(m) of 2^log_c words
template <class Rows>
struct RowMajor {
  Rows rows;
  int log_c;
  __device__ __forceinline__ uint32_t operator()(uint32_t m, uint32_t c) const {
    return (rows(m) << log_c) + c;
  }
};

// s^i = lo[i mod 2^h] * hi[i >> h] (ops/ntt.py::coset_tables): one product
template <class F>
__device__ __forceinline__ uint64_t coset_pow(const uint64_t* lo,
                                              const uint64_t* hi, uint32_t i,
                                              int h) {
  return F::mul(lo[i & ((1u << h) - 1)], hi[i >> h]);
}

// the values as the tile holds them: no product before the first stage
struct NoPre {
  __device__ __forceinline__ uint64_t operator()(uint64_t v, uint32_t, uint32_t) const {
    return v;
  }
};

// Stages t0 + 1 .. t0 + R of the tile's columns: a group is the 2^R
// positions base + k 2^t0 of one column, in registers. tws holds the
// 2^(L-1) stage roots of a 2^L-point transform; addr(m, c) is the word of
// position m, column c; each value is taken as pre(v, m, c) as it is read.
template <class F, int R, class Addr, class Pre = NoPre>
__device__ __forceinline__ void stages(uint64_t* s, const uint64_t* tws,
                                       int L, int log_c, int t0, Addr addr,
                                       Pre pre = Pre()) {
  const uint32_t groups = (1u << (L + log_c)) >> R;
  const uint32_t cmask = (1u << log_c) - 1;
  for (uint32_t g = threadIdx.x; g < groups; g += blockDim.x) {
    const uint32_t c = g & cmask, rest = g >> log_c;
    const uint32_t jlo = rest & ((1u << t0) - 1);
    const uint32_t base = jlo | ((rest >> t0) << (t0 + R));
    uint64_t v[1 << R];
#pragma unroll
    for (int k = 0; k < (1 << R); ++k) {
      v[k] = pre(s[addr(base + (k << t0), c)], base + (k << t0), c);
    }
#pragma unroll
    for (int q = 0; q < R; ++q) {
      const int u = t0 + 1 + q;  // the stage within the tile
#pragma unroll
      for (int k = 0; k < (1 << R); ++k) {
        if (k & (1 << q)) continue;
        const uint32_t j = jlo + ((uint32_t)(k & ((1 << q) - 1)) << t0);
        const uint64_t a = v[k];
        // the tile's first stage has only w^0 = 1
        const uint64_t b = u == 1 ? v[k + (1 << q)]
                                  : F::mul(v[k + (1 << q)], tws[j << (L - u)]);
        v[k] = F::add(a, b);
        v[k + (1 << q)] = F::sub(a, b);
      }
    }
#pragma unroll
    for (int k = 0; k < (1 << R); ++k) {
      s[addr(base + (k << t0), c)] = v[k];
    }
  }
}

// All L stages of the tile: rounds of 3 in registers, the last round 2 or
// 1, with a barrier after each. With a Pre other than NoPre (L >= 3), the
// first round takes the values through it.
template <class F, class Addr, class Pre = NoPre>
__device__ __forceinline__ void all_stages_at(uint64_t* s, const uint64_t* tws,
                                              int L, int log_c, Addr addr,
                                              Pre pre = Pre()) {
  int t0 = 0;
  if constexpr (!std::is_same<Pre, NoPre>::value) {
    stages<F, 3>(s, tws, L, log_c, 0, addr, pre);
    __syncthreads();
    t0 = 3;
  }
  for (; t0 + 3 <= L; t0 += 3) {
    stages<F, 3>(s, tws, L, log_c, t0, addr);
    __syncthreads();
  }
  if (L - t0 == 2) {
    stages<F, 2>(s, tws, L, log_c, t0, addr);
    __syncthreads();
  } else if (L - t0 == 1) {
    stages<F, 1>(s, tws, L, log_c, t0, addr);
    __syncthreads();
  }
}

// all_stages_at on a tile of rows(m) rows of 2^log_c words
template <class F, class Rows = PadRows>
__device__ __forceinline__ void all_stages(uint64_t* s, const uint64_t* tws,
                                           int L, int log_c,
                                           Rows rows = Rows()) {
  all_stages_at<F>(s, tws, L, log_c, RowMajor<Rows>{rows, log_c});
}
