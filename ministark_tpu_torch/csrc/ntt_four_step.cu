// Four-step NTT, n = n1 * n2 (n2 = 2^floor(log n / 2)), in two shared-memory
// passes over (batch, n) rows in natural order, for Goldilocks and for
// BabyBear (templates on the field: ms_ntt_four_step_pass{1,2}_{gl,bb}).
//
// Replaces the Pallas kernels ministark_tpu/ops/ntt_pallas.py::
// _make_pass1_kernel and _make_pass2_kernel (via _make_passes; BabyBear with
// nlimbs = 1). With x[i2 * n1 + i1] read as the (n2, n1) matrix A[i2, i1] and
// w of order n:
//
//   X[k2 + n2 * k1] = sum_i1 w1^(i1 k1) * w^(i1 k2) * sum_i2 A[i2, i1] w2^(i2 k2)
//
// with w1 = w^n2 and w2 = w^n1.
//
//  * pass 1 (grid n1 / TC x batch): a block loads TC columns of all n2 rows
//    into shared memory, the rows in bit-reversed order (the JAX prep gather)
//    and the coset pre-multiply s^idx folded into the load, runs all log2(n2)
//    decimation-in-time stages down the columns, multiplies by w^(i1 k2) from
//    a per-thread ladder (one power of w^i1 per run of rows, then one product
//    per row) and stores C[k2, i1] in rows of TC consecutive columns.
//  * pass 2 (grid n2 / TR x batch): a block loads TR whole rows of C (a row is
//    contiguous, so no transpose), runs all log2(n1) decimation-in-frequency
//    stages along them and writes X[k2 + n2 k1] with the bit-reversed k1 (the
//    JAX finish gather), 1/n and the coset post-multiply folded into the
//    store: TR consecutive k2 per k1, one 64-byte segment per store.
//
// The stage twiddles come from _stage_table_host's (L, m / 2) tables: row
// s - 1 holds root^(j << (L - s)) for the stage of half-width 2^(s - 1).
// Tiles: TC * n2 * 8 and TR * (n1 + 1) * 8 bytes, 128 KB at n = 2^21 (pass 2)
// and up to 128 KB each at n = 2^22, above the 48 KB default: both kernels
// raise their dynamic shared-memory limit. Pass 2 pads its rows by one element
// so the store's column reads fall in different banks. A BabyBear value takes
// the same 8 bytes (the port's int64 storage), so both fields share the tiles.
//
// Bound on the H100: integer throughput (a butterfly is ~40 operations in
// Goldilocks, ~20 in BabyBear, against the 32 bytes each element moves
// through device memory in the two passes).
#include <cuda_runtime.h>

#include "ntt_common.cuh"

namespace {

constexpr int TC = 8;          // pass-1 columns per block
constexpr int TR = 8;          // pass-2 rows per block
constexpr int THREADS = 256;   // a multiple of TC; at most n2 * TC / 4

template <class F>
__device__ __forceinline__ uint64_t pow_u(uint64_t base, uint32_t e) {
  uint64_t r = 1;
  while (e) {
    if (e & 1) r = F::mul(r, base);
    base = F::mul(base, base);
    e >>= 1;
  }
  return r;
}

template <class F>
__global__ void four_step_pass1(const uint64_t* __restrict__ x,
                                uint64_t* __restrict__ c, int log_n1,
                                int log_n2, const uint64_t* __restrict__ tw2,
                                const uint64_t* __restrict__ wpow,
                                const uint64_t* __restrict__ pre) {
  extern __shared__ uint64_t s[];  // s[row * TC + col], n2 rows
  const uint32_t n1 = 1u << log_n1, n2 = 1u << log_n2;
  const size_t n = (size_t)n1 * n2;
  const uint64_t* xb = x + blockIdx.y * n;
  uint64_t* cb = c + blockIdx.y * n;
  const uint32_t i1_base = blockIdx.x * TC;

  for (uint32_t t = threadIdx.x; t < n2 * TC; t += blockDim.x) {
    const uint32_t col = t % TC, i2 = t / TC;
    const uint32_t idx = i2 * n1 + i1_base + col;
    uint64_t v = xb[idx];
    if (pre) v = F::mul(v, F::pow_bits(pre, idx));
    s[bit_reverse(i2, log_n2) * TC + col] = v;
  }
  __syncthreads();

  const uint32_t half_n2 = n2 / 2;
  for (int st = 1; st <= log_n2; ++st) {
    const uint32_t half = 1u << (st - 1);
    const uint64_t* tws = tw2 + (size_t)(st - 1) * half_n2;
    for (uint32_t k = threadIdx.x; k < half_n2 * TC; k += blockDim.x) {
      const uint32_t col = k % TC, bf = k / TC;
      const uint32_t j = bf & (half - 1);
      const uint32_t i0 = ((bf >> (st - 1)) << st) + j;
      const uint32_t a0 = i0 * TC + col, a1 = (i0 + half) * TC + col;
      const uint64_t u = s[a0];
      const uint64_t v = F::mul(s[a1], tws[j]);
      s[a0] = F::add(u, v);
      s[a1] = F::sub(u, v);
    }
    __syncthreads();
  }

  // w^(i1 k2): thread (col, part) walks rows [k0, k0 + run) of its column
  const uint32_t col = threadIdx.x % TC;
  const uint32_t parts = blockDim.x / TC;
  const uint32_t run = n2 / parts;
  const uint32_t k0 = (threadIdx.x / TC) * run;
  const uint64_t base = wpow[i1_base + col];
  uint64_t w = pow_u<F>(base, k0);
  for (uint32_t k2 = k0; k2 < k0 + run; ++k2) {
    cb[(size_t)k2 * n1 + i1_base + col] = F::mul(s[k2 * TC + col], w);
    w = F::mul(w, base);
  }
}

template <class F>
__global__ void four_step_pass2(const uint64_t* __restrict__ c,
                                uint64_t* __restrict__ y, int log_n1,
                                int log_n2, const uint64_t* __restrict__ tw1,
                                const uint64_t* __restrict__ post,
                                uint64_t scale) {
  extern __shared__ uint64_t s[];  // s[r * (n1 + 1) + i1], TR rows
  const uint32_t n1 = 1u << log_n1, n2 = 1u << log_n2;
  const uint32_t stride = n1 + 1;
  const size_t n = (size_t)n1 * n2;
  const uint64_t* cb = c + blockIdx.y * n;
  uint64_t* yb = y + blockIdx.y * n;
  const uint32_t k2_base = blockIdx.x * TR;

  for (uint32_t t = threadIdx.x; t < TR * n1; t += blockDim.x) {
    const uint32_t r = t / n1, i1 = t % n1;
    s[r * stride + i1] = cb[(size_t)(k2_base + r) * n1 + i1];
  }
  __syncthreads();

  const uint32_t half_n1 = n1 / 2;
  for (int st = log_n1; st >= 1; --st) {
    const uint32_t half = 1u << (st - 1);
    const uint64_t* tws = tw1 + (size_t)(st - 1) * half_n1;
    for (uint32_t k = threadIdx.x; k < TR * half_n1; k += blockDim.x) {
      const uint32_t r = k / half_n1, bf = k % half_n1;
      const uint32_t j = bf & (half - 1);
      const uint32_t i0 = ((bf >> (st - 1)) << st) + j;
      const uint32_t a0 = r * stride + i0, a1 = a0 + half;
      const uint64_t u = s[a0], v = s[a1];
      s[a0] = F::add(u, v);
      s[a1] = F::mul(F::sub(u, v), tws[j]);
    }
    __syncthreads();
  }

  for (uint32_t t = threadIdx.x; t < TR * n1; t += blockDim.x) {
    const uint32_t r = t % TR, k1 = t / TR;
    uint64_t v = s[r * stride + bit_reverse(k1, log_n1)];
    const uint32_t idx = k2_base + r + n2 * k1;
    if (scale != 1) v = F::mul(v, scale);
    if (post) v = F::mul(v, F::pow_bits(post, idx));
    yb[idx] = v;
  }
}

template <typename K>
cudaError_t smem_limit(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

bool bad_sizes(int batch, int log_n1, int log_n2) {
  // pass 1 needs n1 % TC == 0 and n2 * TC >= 4 * THREADS; pass 2 n2 % TR == 0
  return batch < 1 || batch > 65535 || log_n2 < 7 || log_n1 < log_n2 ||
         log_n1 > 11;
}

template <class F>
int run_pass1(const uint64_t* x, uint64_t* c, int batch, int log_n1,
              int log_n2, const uint64_t* tw2, const uint64_t* wpow,
              const uint64_t* pre, void* stream) {
  if (bad_sizes(batch, log_n1, log_n2)) return (int)cudaErrorInvalidValue;
  const size_t bytes = ((size_t)TC << log_n2) * sizeof(uint64_t);
  cudaError_t err = smem_limit(four_step_pass1<F>, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((1u << log_n1) / TC, batch);
  four_step_pass1<F><<<grid, THREADS, bytes, (cudaStream_t)stream>>>(
      x, c, log_n1, log_n2, tw2, wpow, pre);
  return (int)cudaGetLastError();
}

template <class F>
int run_pass2(const uint64_t* c, uint64_t* y, int batch, int log_n1,
              int log_n2, const uint64_t* tw1, const uint64_t* post,
              uint64_t scale, void* stream) {
  if (bad_sizes(batch, log_n1, log_n2)) return (int)cudaErrorInvalidValue;
  const size_t bytes = (size_t)TR * ((1u << log_n1) + 1) * sizeof(uint64_t);
  cudaError_t err = smem_limit(four_step_pass2<F>, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((1u << log_n2) / TR, batch);
  four_step_pass2<F><<<grid, THREADS, bytes, (cudaStream_t)stream>>>(
      c, y, log_n1, log_n2, tw1, post, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Pass 1. x: (batch, n1 * n2) natural order; c: (batch, n2, n1) output; tw2:
// the (log_n2, n2 / 2) stage table of w2; wpow: w^i1 for i1 < n1; pre: s^(2^b)
// for b < log n, or null.
extern "C" int ms_ntt_four_step_pass1_gl(const uint64_t* x, uint64_t* c,
                                         int batch, int log_n1, int log_n2,
                                         const uint64_t* tw2, const uint64_t* wpow,
                                         const uint64_t* pre, void* stream) {
  return run_pass1<gl>(x, c, batch, log_n1, log_n2, tw2, wpow, pre, stream);
}

extern "C" int ms_ntt_four_step_pass1_bb(const uint64_t* x, uint64_t* c,
                                         int batch, int log_n1, int log_n2,
                                         const uint64_t* tw2, const uint64_t* wpow,
                                         const uint64_t* pre, void* stream) {
  return run_pass1<bb>(x, c, batch, log_n1, log_n2, tw2, wpow, pre, stream);
}

// Pass 2. c: (batch, n2, n1) from pass 1; y: (batch, n1 * n2) natural order;
// tw1: the (log_n1, n1 / 2) stage table of w1; post: s^(2^b) for b < log n, or
// null; scale: 1/n for an inverse transform, else 1.
extern "C" int ms_ntt_four_step_pass2_gl(const uint64_t* c, uint64_t* y,
                                         int batch, int log_n1, int log_n2,
                                         const uint64_t* tw1, const uint64_t* post,
                                         uint64_t scale, void* stream) {
  return run_pass2<gl>(c, y, batch, log_n1, log_n2, tw1, post, scale, stream);
}

extern "C" int ms_ntt_four_step_pass2_bb(const uint64_t* c, uint64_t* y,
                                         int batch, int log_n1, int log_n2,
                                         const uint64_t* tw1, const uint64_t* post,
                                         uint64_t scale, void* stream) {
  return run_pass2<bb>(c, y, batch, log_n1, log_n2, tw1, post, scale, stream);
}
