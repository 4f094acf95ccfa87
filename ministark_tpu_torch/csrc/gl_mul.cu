// Elementwise Goldilocks products over broadcast, strided operands: the base
// product out = a * b mod p (ms_gl_mul) and the product in Fp2 = Fp[u] /
// (u^2 - 7) (ms_gl_ext_mul), each one launch.
//
// ms_gl_mul replaces the Pallas kernel ministark_tpu/ops/pallas_kernels.py::
// _gl_mul_kernel, which multiplies (n, 2) u32 limb pairs one (8, 128) tile
// per grid step. ms_gl_ext_mul replaces ministark_tpu/ops/gl.py::ext_mul
// (:215), the Karatsuba composition that XLA fused into one pass and that
// pallas_kernels.py:12-16 left out of Pallas for the TPU's tile layout. Here
// an element is one canonical uint64_t (an Fp2 element two, c0 and c1) and
// the product is gl.cuh's mul (a native 64x64 -> 128 multiply and the
// 2^64 == 2^32 - 1, 2^96 == -1 folds).
//
// The operands are addressed through elementwise.cuh's plan.
//
// Bound on the H100: device-memory bandwidth, 24 bytes per base product and
// 48 per Fp2 product against ~30 and ~100 integer operations. So the
// contiguous base path moves 16-byte vectors, four products per thread per
// step, and an Fp2 operand whose components are adjacent (component stride
// 1, 16-byte aligned: every prover call) is one 16-byte load; the Fp2 output
// is always one 16-byte store.
#include <cuda_runtime.h>

#include "elementwise.cuh"
#include "ext_field.cuh"
#include "gl.cuh"

namespace {

using namespace ew;

// ---------------------------------------------------------------- base

// both operands and the output contiguous and 16-byte aligned: two 16-byte
// vectors (four products) per thread per step; the odd last element, if
// any, goes to thread 0
__global__ void gl_mul_contig(const ulonglong2* __restrict__ a,
                              const ulonglong2* __restrict__ b,
                              ulonglong2* __restrict__ out, uint32_t n) {
  const uint32_t pairs = n >> 1;
  const uint32_t step = gridDim.x * blockDim.x;
  uint32_t i = blockIdx.x * blockDim.x + threadIdx.x;
  for (; i + step < pairs; i += 2 * step) {
    const ulonglong2 x0 = a[i], y0 = b[i];
    const ulonglong2 x1 = a[i + step], y1 = b[i + step];
    out[i] = make_ulonglong2(gl::mul(x0.x, y0.x), gl::mul(x0.y, y0.y));
    out[i + step] = make_ulonglong2(gl::mul(x1.x, y1.x), gl::mul(x1.y, y1.y));
  }
  if (i < pairs) {
    const ulonglong2 x0 = a[i], y0 = b[i];
    out[i] = make_ulonglong2(gl::mul(x0.x, y0.x), gl::mul(x0.y, y0.y));
  }
  if ((n & 1) && blockIdx.x == 0 && threadIdx.x == 0) {
    const uint64_t* a1 = reinterpret_cast<const uint64_t*>(a);
    const uint64_t* b1 = reinterpret_cast<const uint64_t*>(b);
    reinterpret_cast<uint64_t*>(out)[n - 1] = gl::mul(a1[n - 1], b1[n - 1]);
  }
}

template <int NDIM, typename I>
__global__ void gl_mul_strided(const uint64_t* __restrict__ a,
                               const uint64_t* __restrict__ b,
                               uint64_t* __restrict__ out, Addr d, I n) {
  const I step = (I)gridDim.x * blockDim.x;
  for (I i = (I)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += step) {
    I oa, ob;
    offsets<NDIM, I>(d, i, oa, ob);
    out[i] = gl::mul(a[oa], b[ob]);
  }
}

// ---------------------------------------------------------------- Fp2

// Karatsuba in registers, as ops/gl.py::ext_mul (ext_field.cuh's gl2)
__device__ __forceinline__ ulonglong2 fp2_mul(uint64_t a0, uint64_t a1,
                                              uint64_t b0, uint64_t b1) {
  const gl2::V c = gl2::mul(gl2::V{{a0, a1}}, gl2::V{{b0, b1}});
  return make_ulonglong2(c.c[0], c.c[1]);
}

template <bool VEC>
__device__ __forceinline__ void load2(const uint64_t* p, int64_t cs,
                                      uint64_t& c0, uint64_t& c1) {
  if constexpr (VEC) {
    const ulonglong2 v = *reinterpret_cast<const ulonglong2*>(p);
    c0 = v.x;
    c1 = v.y;
  } else {
    c0 = p[0];
    c1 = p[cs];
  }
}

template <int NDIM, bool VEC, typename I>
__global__ void gl_ext_mul(const uint64_t* __restrict__ a,
                           const uint64_t* __restrict__ b,
                           ulonglong2* __restrict__ out, Addr d, I n,
                           int64_t ca, int64_t cb) {
  const I step = (I)gridDim.x * blockDim.x;
  for (I i = (I)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += step) {
    I oa, ob;
    offsets<NDIM, I>(d, i, oa, ob);
    uint64_t a0, a1, b0, b1;
    load2<VEC>(a + oa, ca, a0, a1);
    load2<VEC>(b + ob, cb, b0, b1);
    out[i] = fp2_mul(a0, a1, b0, b1);
  }
}

template <typename I>
void launch_mul(const uint64_t* a, const uint64_t* b, uint64_t* out,
                const Addr& d, int ndim, I n, cudaStream_t s) {
  const dim3 grid = grid_for((int64_t)n);
  switch (ndim) {
    case 1: gl_mul_strided<1, I><<<grid, THREADS, 0, s>>>(a, b, out, d, n); break;
    case 2: gl_mul_strided<2, I><<<grid, THREADS, 0, s>>>(a, b, out, d, n); break;
    case 3: gl_mul_strided<3, I><<<grid, THREADS, 0, s>>>(a, b, out, d, n); break;
    default: gl_mul_strided<4, I><<<grid, THREADS, 0, s>>>(a, b, out, d, n); break;
  }
}

template <bool VEC, typename I>
void launch_ext(const uint64_t* a, const uint64_t* b, ulonglong2* out,
                const Addr& d, int ndim, I n, int64_t ca, int64_t cb,
                cudaStream_t s) {
  const dim3 grid = grid_for((int64_t)n);
  switch (ndim) {
    case 1: gl_ext_mul<1, VEC, I><<<grid, THREADS, 0, s>>>(a, b, out, d, n, ca, cb); break;
    case 2: gl_ext_mul<2, VEC, I><<<grid, THREADS, 0, s>>>(a, b, out, d, n, ca, cb); break;
    case 3: gl_ext_mul<3, VEC, I><<<grid, THREADS, 0, s>>>(a, b, out, d, n, ca, cb); break;
    default: gl_ext_mul<4, VEC, I><<<grid, THREADS, 0, s>>>(a, b, out, d, n, ca, cb); break;
  }
}

}  // namespace

// a, b: operand base pointers (element 0 of each, storage offset included);
// out: numel contiguous outputs; plan: the host int64 values of
// elementwise.cuh's PlanField.
extern "C" int ms_gl_mul(const uint64_t* a, const uint64_t* b, uint64_t* out,
                         const int64_t* plan, void* stream) {
  if (bad_plan(plan)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int64_t n = plan[PL_NUMEL];
  const int ndim = (int)plan[PL_NDIM];
  if (plan[PL_VEC]) {
    if (plan[PL_WIDE]) return (int)cudaErrorInvalidValue;
    gl_mul_contig<<<grid_for((n + 3) / 4), THREADS, 0, s>>>(
        reinterpret_cast<const ulonglong2*>(a),
        reinterpret_cast<const ulonglong2*>(b),
        reinterpret_cast<ulonglong2*>(out), (uint32_t)n);
  } else {
    const Addr d = read_addr(plan);
    if (plan[PL_WIDE]) {
      launch_mul<uint64_t>(a, b, out, d, ndim, (uint64_t)n, s);
    } else {
      launch_mul<uint32_t>(a, b, out, d, ndim, (uint32_t)n, s);
    }
  }
  return (int)cudaGetLastError();
}

// a, b: element 0's c0 of each operand; out: numel contiguous (c0, c1)
// pairs, 16-byte aligned; plan: as ms_gl_mul's, over the leading axes, with
// PL_CA / PL_CB the component strides and PL_VEC set when both are 1 and
// every element of a and b lies on a 16-byte boundary.
extern "C" int ms_gl_ext_mul(const uint64_t* a, const uint64_t* b, uint64_t* out,
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
      launch_ext<true, uint64_t>(a, b, o, d, ndim, (uint64_t)n, ca, cb, s);
    } else {
      launch_ext<false, uint64_t>(a, b, o, d, ndim, (uint64_t)n, ca, cb, s);
    }
  } else if (plan[PL_VEC]) {
    launch_ext<true, uint32_t>(a, b, o, d, ndim, (uint32_t)n, ca, cb, s);
  } else {
    launch_ext<false, uint32_t>(a, b, o, d, ndim, (uint32_t)n, ca, cb, s);
  }
  return (int)cudaGetLastError();
}
