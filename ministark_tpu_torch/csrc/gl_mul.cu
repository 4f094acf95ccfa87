// Elementwise Goldilocks product out = a * b mod p over broadcast, strided
// operands.
//
// Replaces the Pallas kernel ministark_tpu/ops/pallas_kernels.py::
// _gl_mul_kernel, which multiplies (n, 2) u32 limb pairs one (8, 128) tile
// per grid step. Here an element is one canonical uint64_t and the product is
// gl.cuh's mul (a native 64x64 -> 128 multiply and the 2^64 == 2^32 - 1,
// 2^96 == -1 folds). One thread per output element, grid-stride.
//
// The wrapper (ops/field.py::mul_cuda) passes each operand's element strides
// over the output's shape after merging contiguous axes (0 on a broadcast
// axis, 2 for an Fp2 component view), so a broadcast or a strided view costs
// no copy. Bound on the H100: device-memory bandwidth, 16 bytes read and 8
// written per product against ~30 integer operations.
#include <cuda_runtime.h>

#include "gl.cuh"

namespace {

constexpr int MAX_DIMS = 4;
constexpr int THREADS = 256;

struct Dims {
  int64_t size[MAX_DIMS];
  int64_t sa[MAX_DIMS];
  int64_t sb[MAX_DIMS];
};

template <int NDIM>
__global__ void gl_mul_kernel(const uint64_t* __restrict__ a,
                              const uint64_t* __restrict__ b,
                              uint64_t* __restrict__ out, Dims d,
                              int64_t numel) {
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < numel;
       i += step) {
    int64_t rem = i, oa = 0, ob = 0;
#pragma unroll
    for (int k = NDIM - 1; k > 0; --k) {
      const int64_t c = rem % d.size[k];
      rem /= d.size[k];
      oa += c * d.sa[k];
      ob += c * d.sb[k];
    }
    oa += rem * d.sa[0];
    ob += rem * d.sb[0];
    out[i] = gl::mul(a[oa], b[ob]);
  }
}

}  // namespace

// a, b: operand base pointers; out: numel contiguous outputs; ndim in
// [1, 4]; shape, a_strides, b_strides: ndim host int64 values each (element
// units, the output's row-major axes after merging).
extern "C" int ms_gl_mul(const uint64_t* a, const uint64_t* b, uint64_t* out,
                         int ndim, const int64_t* shape,
                         const int64_t* a_strides, const int64_t* b_strides,
                         int64_t numel, void* stream) {
  if (ndim < 1 || ndim > MAX_DIMS || numel < 1) {
    return (int)cudaErrorInvalidValue;
  }
  Dims d;
  for (int k = 0; k < ndim; ++k) {
    d.size[k] = shape[k];
    d.sa[k] = a_strides[k];
    d.sb[k] = b_strides[k];
  }
  cudaStream_t s = (cudaStream_t)stream;
  int64_t blocks = (numel + THREADS - 1) / THREADS;
  if (blocks > (1 << 20)) blocks = 1 << 20;
  const dim3 grid((unsigned)blocks);
  switch (ndim) {
    case 1: gl_mul_kernel<1><<<grid, THREADS, 0, s>>>(a, b, out, d, numel); break;
    case 2: gl_mul_kernel<2><<<grid, THREADS, 0, s>>>(a, b, out, d, numel); break;
    case 3: gl_mul_kernel<3><<<grid, THREADS, 0, s>>>(a, b, out, d, numel); break;
    default: gl_mul_kernel<4><<<grid, THREADS, 0, s>>>(a, b, out, d, numel); break;
  }
  return (int)cudaGetLastError();
}
