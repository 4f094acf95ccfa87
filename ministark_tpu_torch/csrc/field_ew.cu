// Elementwise field ops over broadcast, strided operands, one launch a call:
// Goldilocks add, sub and neg (ms_gl_ew), BabyBear add, sub, neg and mul
// (ms_bb_ew), each chosen by an op code, and the BabyBear Fp4 product
// (ms_bb_fp4_mul). The products of Goldilocks are gl_mul.cu's.
//
// No TPU kernel is replaced: the JAX package computes these in XLA, which
// fuses each expression into one kernel (ministark_tpu/ops/gl.py::add :82,
// sub :103, neg :109, ext_add / ext_sub :207-211; ops/bb.py::add, sub, neg,
// mul :40-53 and the Fp4 tower :95-138). In torch ops a Goldilocks add was
// 15-32 launches on 32-bit halves and an Fp4 product about 80, so the port
// launched dozens of kernels where the TPU ran one. An extension add, sub or
// neg is ms_gl_ew / ms_bb_ew over the whole (..., K) tensors, the component
// axis one more plan axis; a product by a base scalar is a base product by
// the scalar broadcast over that axis.
//
// The operands are addressed through elementwise.cuh's plan. Arithmetic:
// gl.cuh's add and sub on canonical uint64_t, bb.cuh's 32-bit add and sub and
// its Barrett product (no 64-bit division), ext_field.cuh's bb4::mul
// (Karatsuba over Fp2, tower order c00, c01, c10, c11).
//
// Bound on the H100: device-memory bandwidth. A Goldilocks add moves 24
// bytes against ~8 integer operations; BabyBear is held in 32-bit words
// (int32 tensors, as the JAX package's u32 lanes), so its add or product
// moves 12 bytes against ~3 or ~18 operations and an Fp4 product 48 against
// ~333 (0.042 ms of operations at 2^21 against 0.030 ms of bytes). So the
// contiguous path moves 16-byte vectors, two vectors per thread per step:
// four Goldilocks elements, eight BabyBear; an Fp4 operand whose components
// are adjacent and 16-byte aligned is one 16-byte load (Hopper's widest),
// and the Fp4 output one 16-byte store.
#include <cuda_runtime.h>

#include "bb.cuh"
#include "elementwise.cuh"
#include "ext_field.cuh"
#include "gl.cuh"

namespace {

using namespace ew;

// the op codes (ops/field.py::ADD, SUB, NEG, MUL)
enum Op { OP_ADD = 0, OP_SUB = 1, OP_NEG = 2, OP_MUL = 3 };

template <class F, int OP>
__device__ __forceinline__ uint64_t apply(uint64_t a, uint64_t b) {
  if constexpr (OP == OP_ADD) {
    return F::add(a, b);
  } else if constexpr (OP == OP_SUB) {
    return F::sub(a, b);
  } else if constexpr (OP == OP_NEG) {
    return F::sub(0, a);
  } else {
    return F::mul(a, b);
  }
}

// a 16-byte vector of four BabyBear words through apply
template <class F, int OP>
__device__ __forceinline__ uint4 apply4(const uint4& x, const uint4& y) {
  return make_uint4((uint32_t)apply<F, OP>(x.x, y.x), (uint32_t)apply<F, OP>(x.y, y.y),
                    (uint32_t)apply<F, OP>(x.z, y.z), (uint32_t)apply<F, OP>(x.w, y.w));
}

// both operands and the output contiguous and 16-byte aligned: two 16-byte
// vectors (four elements) per thread per step; the odd last element, if
// any, goes to thread 0. NEG reads no b.
template <class F, int OP>
__global__ void field_ew_contig(const ulonglong2* __restrict__ a,
                                const ulonglong2* __restrict__ b,
                                ulonglong2* __restrict__ out, uint32_t n) {
  const uint32_t pairs = n >> 1;
  const uint32_t step = gridDim.x * blockDim.x;
  uint32_t i = blockIdx.x * blockDim.x + threadIdx.x;
  for (; i + step < pairs; i += 2 * step) {
    const ulonglong2 x0 = a[i], x1 = a[i + step];
    ulonglong2 y0 = x0, y1 = x1;
    if constexpr (OP != OP_NEG) {
      y0 = b[i];
      y1 = b[i + step];
    }
    out[i] = make_ulonglong2(apply<F, OP>(x0.x, y0.x), apply<F, OP>(x0.y, y0.y));
    out[i + step] = make_ulonglong2(apply<F, OP>(x1.x, y1.x), apply<F, OP>(x1.y, y1.y));
  }
  if (i < pairs) {
    const ulonglong2 x0 = a[i];
    ulonglong2 y0 = x0;
    if constexpr (OP != OP_NEG) y0 = b[i];
    out[i] = make_ulonglong2(apply<F, OP>(x0.x, y0.x), apply<F, OP>(x0.y, y0.y));
  }
  if ((n & 1) && blockIdx.x == 0 && threadIdx.x == 0) {
    const uint64_t* a1 = reinterpret_cast<const uint64_t*>(a);
    const uint64_t* b1 = reinterpret_cast<const uint64_t*>(b);
    const uint64_t y = OP == OP_NEG ? 0 : b1[n - 1];
    reinterpret_cast<uint64_t*>(out)[n - 1] = apply<F, OP>(a1[n - 1], y);
  }
}

// BabyBear's 32-bit words: the same walk over uint4 vectors, four elements
// a vector; the last n mod 4 elements go to block 0's first threads
template <class F, int OP>
__global__ void field_ew_contig32(const uint4* __restrict__ a, const uint4* __restrict__ b,
                                  uint4* __restrict__ out, uint32_t n) {
  const uint32_t vecs = n >> 2;
  const uint32_t step = gridDim.x * blockDim.x;
  uint32_t i = blockIdx.x * blockDim.x + threadIdx.x;
  for (; i + step < vecs; i += 2 * step) {
    const uint4 x0 = a[i], x1 = a[i + step];
    uint4 y0 = x0, y1 = x1;
    if constexpr (OP != OP_NEG) {
      y0 = b[i];
      y1 = b[i + step];
    }
    out[i] = apply4<F, OP>(x0, y0);
    out[i + step] = apply4<F, OP>(x1, y1);
  }
  if (i < vecs) {
    const uint4 x0 = a[i];
    uint4 y0 = x0;
    if constexpr (OP != OP_NEG) y0 = b[i];
    out[i] = apply4<F, OP>(x0, y0);
  }
  const uint32_t tail = n - (vecs << 2);
  if (blockIdx.x == 0 && threadIdx.x < tail) {
    const uint32_t j = (vecs << 2) + threadIdx.x;
    const uint32_t* a1 = reinterpret_cast<const uint32_t*>(a);
    const uint32_t* b1 = reinterpret_cast<const uint32_t*>(b);
    const uint32_t y = OP == OP_NEG ? 0u : b1[j];
    reinterpret_cast<uint32_t*>(out)[j] = (uint32_t)apply<F, OP>(a1[j], y);
  }
}

template <class F, int OP, int NDIM, typename I, class W>
__global__ void field_ew_strided(const W* __restrict__ a, const W* __restrict__ b,
                                 W* __restrict__ out, Addr d, I n) {
  const I step = (I)gridDim.x * blockDim.x;
  for (I i = (I)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += step) {
    I oa, ob;
    offsets<NDIM, I>(d, i, oa, ob);
    if constexpr (OP == OP_NEG) {
      out[i] = (W)apply<F, OP>(a[oa], 0);
    } else {
      out[i] = (W)apply<F, OP>(a[oa], b[ob]);
    }
  }
}

template <class F, int OP, typename I, class W>
void launch_strided(const W* a, const W* b, W* out, const Addr& d, int ndim, I n,
                    cudaStream_t s) {
  const dim3 grid = grid_for((int64_t)n);
  switch (ndim) {
    case 1: field_ew_strided<F, OP, 1, I, W><<<grid, THREADS, 0, s>>>(a, b, out, d, n); break;
    case 2: field_ew_strided<F, OP, 2, I, W><<<grid, THREADS, 0, s>>>(a, b, out, d, n); break;
    case 3: field_ew_strided<F, OP, 3, I, W><<<grid, THREADS, 0, s>>>(a, b, out, d, n); break;
    default: field_ew_strided<F, OP, 4, I, W><<<grid, THREADS, 0, s>>>(a, b, out, d, n); break;
  }
}

template <class F, int OP, class W = word_t<F>>
int launch_ew(const W* a, const W* b, W* out, const int64_t* plan, cudaStream_t s) {
  const int64_t n = plan[PL_NUMEL];
  const int ndim = (int)plan[PL_NDIM];
  if (plan[PL_VEC]) {
    if (plan[PL_WIDE]) return (int)cudaErrorInvalidValue;
    if constexpr (sizeof(W) == 8) {
      field_ew_contig<F, OP><<<grid_for((n + 3) / 4), THREADS, 0, s>>>(
          reinterpret_cast<const ulonglong2*>(a), reinterpret_cast<const ulonglong2*>(b),
          reinterpret_cast<ulonglong2*>(out), (uint32_t)n);
    } else {
      field_ew_contig32<F, OP><<<grid_for((n + 7) / 8), THREADS, 0, s>>>(
          reinterpret_cast<const uint4*>(a), reinterpret_cast<const uint4*>(b),
          reinterpret_cast<uint4*>(out), (uint32_t)n);
    }
  } else {
    const Addr d = read_addr(plan);
    if (plan[PL_WIDE]) {
      launch_strided<F, OP, uint64_t, W>(a, b, out, d, ndim, (uint64_t)n, s);
    } else {
      launch_strided<F, OP, uint32_t, W>(a, b, out, d, ndim, (uint32_t)n, s);
    }
  }
  return (int)cudaGetLastError();
}

// the op code's launch; MUL only where the field's entry point takes it
template <class F, bool MUL, class W = word_t<F>>
int ew_entry(const W* a, const W* b, W* out, const int64_t* plan, int op, void* stream) {
  if (bad_plan(plan)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (op) {
    case OP_ADD: return launch_ew<F, OP_ADD>(a, b, out, plan, s);
    case OP_SUB: return launch_ew<F, OP_SUB>(a, b, out, plan, s);
    case OP_NEG: return launch_ew<F, OP_NEG>(a, b, out, plan, s);
    case OP_MUL:
      if constexpr (MUL) {
        return launch_ew<F, OP_MUL>(a, b, out, plan, s);
      } else {
        return (int)cudaErrorInvalidValue;
      }
    default: return (int)cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------- Fp4

// an element's 4 components from 32-bit words: one 16-byte load where they
// are adjacent and aligned (VEC), else strided loads
template <bool VEC>
__device__ __forceinline__ bb4::V load4(const uint32_t* p, int64_t cs) {
  bb4::V v;
  if constexpr (VEC) {
    const uint4 e = *reinterpret_cast<const uint4*>(p);
    v.c[0] = e.x;
    v.c[1] = e.y;
    v.c[2] = e.z;
    v.c[3] = e.w;
  } else {
#pragma unroll
    for (int k = 0; k < bb4::K; ++k) v.c[k] = p[k * cs];
  }
  return v;
}

template <int NDIM, bool VEC, typename I>
__global__ void bb_fp4_mul_kernel(const uint32_t* __restrict__ a,
                                  const uint32_t* __restrict__ b,
                                  uint4* __restrict__ out, Addr d, I n,
                                  int64_t ca, int64_t cb) {
  const I step = (I)gridDim.x * blockDim.x;
  for (I i = (I)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += step) {
    I oa, ob;
    offsets<NDIM, I>(d, i, oa, ob);
    const bb4::V r = bb4::mul(load4<VEC>(a + oa, ca), load4<VEC>(b + ob, cb));
    out[i] = make_uint4((uint32_t)r.c[0], (uint32_t)r.c[1], (uint32_t)r.c[2],
                        (uint32_t)r.c[3]);
  }
}

template <bool VEC, typename I>
void launch_fp4(const uint32_t* a, const uint32_t* b, uint4* out,
                const Addr& d, int ndim, I n, int64_t ca, int64_t cb,
                cudaStream_t s) {
  const dim3 grid = grid_for((int64_t)n);
  switch (ndim) {
    case 1: bb_fp4_mul_kernel<1, VEC, I><<<grid, THREADS, 0, s>>>(a, b, out, d, n, ca, cb); break;
    case 2: bb_fp4_mul_kernel<2, VEC, I><<<grid, THREADS, 0, s>>>(a, b, out, d, n, ca, cb); break;
    case 3: bb_fp4_mul_kernel<3, VEC, I><<<grid, THREADS, 0, s>>>(a, b, out, d, n, ca, cb); break;
    default: bb_fp4_mul_kernel<4, VEC, I><<<grid, THREADS, 0, s>>>(a, b, out, d, n, ca, cb); break;
  }
}

}  // namespace

// a, b: operand base pointers (element 0 of each, storage offset included;
// for NEG b is not read); out: numel contiguous outputs; plan: the host
// int64 values of elementwise.cuh's PlanField; op: OP_ADD, OP_SUB or OP_NEG.
extern "C" int ms_gl_ew(const uint64_t* a, const uint64_t* b, uint64_t* out,
                        const int64_t* plan, int op, void* stream) {
  return ew_entry<gl, false>(a, b, out, plan, op, stream);
}

// as ms_gl_ew over BabyBear's 32-bit words, with OP_MUL too
extern "C" int ms_bb_ew(const uint32_t* a, const uint32_t* b, uint32_t* out,
                        const int64_t* plan, int op, void* stream) {
  return ew_entry<bb, true>(a, b, out, plan, op, stream);
}

// a, b: element 0's c00 of each operand, 32-bit words; out: numel
// contiguous (c00, c01, c10, c11) elements, 16-byte aligned; plan: over the
// leading axes, with PL_CA / PL_CB the component strides and PL_VEC set
// when both are 1 and every element of a and b lies on a 16-byte boundary.
extern "C" int ms_bb_fp4_mul(const uint32_t* a, const uint32_t* b, uint32_t* out,
                             const int64_t* plan, void* stream) {
  if (bad_plan(plan)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int64_t n = plan[PL_NUMEL];
  const int ndim = (int)plan[PL_NDIM];
  const int64_t ca = plan[PL_CA], cb = plan[PL_CB];
  const Addr d = read_addr(plan);
  uint4* o = reinterpret_cast<uint4*>(out);
  if (plan[PL_WIDE]) {
    if (plan[PL_VEC]) {
      launch_fp4<true, uint64_t>(a, b, o, d, ndim, (uint64_t)n, ca, cb, s);
    } else {
      launch_fp4<false, uint64_t>(a, b, o, d, ndim, (uint64_t)n, ca, cb, s);
    }
  } else if (plan[PL_VEC]) {
    launch_fp4<true, uint32_t>(a, b, o, d, ndim, (uint32_t)n, ca, cb, s);
  } else {
    launch_fp4<false, uint32_t>(a, b, o, d, ndim, (uint32_t)n, ca, cb, s);
  }
  return (int)cudaGetLastError();
}
