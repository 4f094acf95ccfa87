// The plan of an elementwise launch over broadcast, strided operands, shared
// by gl_mul.cu (the Goldilocks products) and field_ew.cu (add, sub, neg in
// Goldilocks, add, sub, neg, mul in BabyBear, the Fp4 product).
//
// The wrapper (ops/field.py::_plan) hands each launch one int64 plan: the
// output's row-major axes after merging contiguous axes, each operand's
// element strides over them (0 on a broadcast axis), and for each axis size
// a multiply-high magic number, so that a strided or broadcast operand costs
// no copy and no 64-bit divide: with fewer than 2^31 elements and offsets
// the coordinates come from 32-bit __umulhi divisions; only larger calls
// take 64-bit indices and the native divide.
#pragma once
#include <cuda_runtime.h>

#include <cstdint>

namespace ew {

constexpr int MAX_DIMS = 4;
constexpr int THREADS = 256;
constexpr int MAX_BLOCKS = 132 * 16;  // grid-stride beyond 16 blocks per SM

// The plan's int64 layout (ops/field.py::_plan writes the same order).
enum PlanField {
  PL_NUMEL = 0,  // output elements (an extension product: elements, not words)
  PL_NDIM,       // merged axes, 1..4
  PL_VEC,        // 16-byte loads (base: contiguous path; extension: adjacent components)
  PL_WIDE,       // 64-bit indices
  PL_CA,         // extension component strides of a and b (in words of the field)
  PL_CB,
  PL_SIZE,                         // size[4]
  PL_SA = PL_SIZE + MAX_DIMS,      // a's strides[4]
  PL_SB = PL_SA + MAX_DIMS,        // b's strides[4]
  PL_MAGIC = PL_SB + MAX_DIMS,     // magic[4]
  PL_SHIFT = PL_MAGIC + MAX_DIMS,  // shift[4]
};

struct Addr {
  int64_t size[MAX_DIMS];
  int64_t sa[MAX_DIMS];
  int64_t sb[MAX_DIMS];
  uint32_t magic[MAX_DIMS];
  uint32_t shift[MAX_DIMS];
};

// q = i / size[k]: with 32-bit indices (i < 2^31) the round-up multiply-high
// method, (umulhi(i, magic) + i) >> shift; with 64-bit ones the divide
template <typename I>
__device__ __forceinline__ I div_axis(const Addr& d, int k, I i) {
  if constexpr (sizeof(I) == 4) {
    return (__umulhi(i, d.magic[k]) + i) >> d.shift[k];
  } else {
    return i / (I)d.size[k];
  }
}

// element offsets in a and b of output element i (row-major over size[])
template <int NDIM, typename I>
__device__ __forceinline__ void offsets(const Addr& d, I i, I& oa, I& ob) {
  oa = 0;
  ob = 0;
#pragma unroll
  for (int k = NDIM - 1; k > 0; --k) {
    const I q = div_axis<I>(d, k, i);
    const I c = i - q * (I)d.size[k];
    oa += c * (I)d.sa[k];
    ob += c * (I)d.sb[k];
    i = q;
  }
  oa += i * (I)d.sa[0];
  ob += i * (I)d.sb[0];
}

inline Addr read_addr(const int64_t* plan) {
  Addr d;
  for (int k = 0; k < MAX_DIMS; ++k) {
    d.size[k] = plan[PL_SIZE + k];
    d.sa[k] = plan[PL_SA + k];
    d.sb[k] = plan[PL_SB + k];
    d.magic[k] = (uint32_t)plan[PL_MAGIC + k];
    d.shift[k] = (uint32_t)plan[PL_SHIFT + k];
  }
  return d;
}

inline dim3 grid_for(int64_t work) {
  int64_t blocks = (work + THREADS - 1) / THREADS;
  if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
  return dim3((unsigned)(blocks < 1 ? 1 : blocks));
}

inline bool bad_plan(const int64_t* plan) {
  return plan[PL_NUMEL] < 1 || plan[PL_NDIM] < 1 || plan[PL_NDIM] > MAX_DIMS;
}

}  // namespace ew
