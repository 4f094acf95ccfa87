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
// Bound on the H100: device-memory bandwidth. An add moves 24 bytes against
// ~8 integer operations, a BabyBear product 24 against ~18, an Fp4 product 96
// against ~333 (0.042 ms of operations at 2^21 against 0.060 ms of bytes).
// So the contiguous path moves 16-byte vectors, four elements per thread per
// step, and an Fp4 operand whose components are adjacent and 16-byte aligned
// is two 16-byte loads (Hopper's widest); the Fp4 output is two 16-byte
// stores.
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

template <class F, int OP, int NDIM, typename I>
__global__ void field_ew_strided(const uint64_t* __restrict__ a,
                                 const uint64_t* __restrict__ b,
                                 uint64_t* __restrict__ out, Addr d, I n) {
  const I step = (I)gridDim.x * blockDim.x;
  for (I i = (I)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += step) {
    I oa, ob;
    offsets<NDIM, I>(d, i, oa, ob);
    if constexpr (OP == OP_NEG) {
      out[i] = apply<F, OP>(a[oa], 0);
    } else {
      out[i] = apply<F, OP>(a[oa], b[ob]);
    }
  }
}

template <class F, int OP, typename I>
void launch_strided(const uint64_t* a, const uint64_t* b, uint64_t* out,
                    const Addr& d, int ndim, I n, cudaStream_t s) {
  const dim3 grid = grid_for((int64_t)n);
  switch (ndim) {
    case 1: field_ew_strided<F, OP, 1, I><<<grid, THREADS, 0, s>>>(a, b, out, d, n); break;
    case 2: field_ew_strided<F, OP, 2, I><<<grid, THREADS, 0, s>>>(a, b, out, d, n); break;
    case 3: field_ew_strided<F, OP, 3, I><<<grid, THREADS, 0, s>>>(a, b, out, d, n); break;
    default: field_ew_strided<F, OP, 4, I><<<grid, THREADS, 0, s>>>(a, b, out, d, n); break;
  }
}

template <class F, int OP>
int launch_ew(const uint64_t* a, const uint64_t* b, uint64_t* out,
              const int64_t* plan, cudaStream_t s) {
  const int64_t n = plan[PL_NUMEL];
  const int ndim = (int)plan[PL_NDIM];
  if (plan[PL_VEC]) {
    if (plan[PL_WIDE]) return (int)cudaErrorInvalidValue;
    field_ew_contig<F, OP><<<grid_for((n + 3) / 4), THREADS, 0, s>>>(
        reinterpret_cast<const ulonglong2*>(a), reinterpret_cast<const ulonglong2*>(b),
        reinterpret_cast<ulonglong2*>(out), (uint32_t)n);
  } else {
    const Addr d = read_addr(plan);
    if (plan[PL_WIDE]) {
      launch_strided<F, OP, uint64_t>(a, b, out, d, ndim, (uint64_t)n, s);
    } else {
      launch_strided<F, OP, uint32_t>(a, b, out, d, ndim, (uint32_t)n, s);
    }
  }
  return (int)cudaGetLastError();
}

// the op code's launch; MUL only where the field's entry point takes it
template <class F, bool MUL>
int ew_entry(const uint64_t* a, const uint64_t* b, uint64_t* out,
             const int64_t* plan, int op, void* stream) {
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

template <bool VEC>
__device__ __forceinline__ bb4::V load4(const uint64_t* p, int64_t cs) {
  bb4::V v;
  if constexpr (VEC) {
    const ulonglong2 lo = reinterpret_cast<const ulonglong2*>(p)[0];
    const ulonglong2 hi = reinterpret_cast<const ulonglong2*>(p)[1];
    v.c[0] = lo.x;
    v.c[1] = lo.y;
    v.c[2] = hi.x;
    v.c[3] = hi.y;
  } else {
#pragma unroll
    for (int k = 0; k < bb4::K; ++k) v.c[k] = p[k * cs];
  }
  return v;
}

template <int NDIM, bool VEC, typename I>
__global__ void bb_fp4_mul_kernel(const uint64_t* __restrict__ a,
                                  const uint64_t* __restrict__ b,
                                  ulonglong2* __restrict__ out, Addr d, I n,
                                  int64_t ca, int64_t cb) {
  const I step = (I)gridDim.x * blockDim.x;
  for (I i = (I)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += step) {
    I oa, ob;
    offsets<NDIM, I>(d, i, oa, ob);
    const bb4::V r = bb4::mul(load4<VEC>(a + oa, ca), load4<VEC>(b + ob, cb));
    ulonglong2* o = out + 2 * (size_t)i;
    o[0] = make_ulonglong2(r.c[0], r.c[1]);
    o[1] = make_ulonglong2(r.c[2], r.c[3]);
  }
}

template <bool VEC, typename I>
void launch_fp4(const uint64_t* a, const uint64_t* b, ulonglong2* out,
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

// as ms_gl_ew over BabyBear, with OP_MUL too
extern "C" int ms_bb_ew(const uint64_t* a, const uint64_t* b, uint64_t* out,
                        const int64_t* plan, int op, void* stream) {
  return ew_entry<bb, true>(a, b, out, plan, op, stream);
}

// a, b: element 0's c00 of each operand; out: numel contiguous (c00, c01,
// c10, c11) elements, 16-byte aligned; plan: over the leading axes, with
// PL_CA / PL_CB the component strides and PL_VEC set when both are 1 and
// every element of a and b lies on a 16-byte boundary.
extern "C" int ms_bb_fp4_mul(const uint64_t* a, const uint64_t* b, uint64_t* out,
                             const int64_t* plan, void* stream) {
  if (bad_plan(plan)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int64_t n = plan[PL_NUMEL];
  const int ndim = (int)plan[PL_NDIM];
  const int64_t ca = plan[PL_CA], cb = plan[PL_CB];
  const Addr d = read_addr(plan);
  ulonglong2* o = reinterpret_cast<ulonglong2*>(out);
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
