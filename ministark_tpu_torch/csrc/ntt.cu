// Batched NTT over (batch, n) rows in natural order, for Goldilocks and for
// BabyBear (a template on the field: ms_ntt_gl and ms_ntt_bb).
//
// Replaces the Pallas kernel ministark_tpu/ops/ntt_mxu.py::_make_fused_kernel
// (one NTT level as an int8 digit matmul on the TPU's MXU; its BabyBear
// branch recombines one digit plane with _recombine_bb). Hopper multiplies
// 64-bit integers natively, so this is a plain radix-2 decimation-in-time
// NTT with the same root of unity, which gives the same canonical outputs:
//
//  * ntt_local: each block loads one TILE-element tile of the bit-reversed
//    row (multiplying in the coset offset s^src on the way, with s^src formed
//    from a table of s^(2^b)), runs the first log2(TILE) butterfly stages in
//    shared memory and stores the tile;
//  * ntt_stage: one launch per remaining stage, one thread per butterfly,
//    in place in device memory.
//
// The last launch applies the 1/n scale of an inverse transform and a coset
// post-multiply. Bound on the H100: integer throughput, in both fields (a
// BabyBear butterfly is about half the operations of a Goldilocks one, still
// above the 16 bytes each element moves through device memory).
#include <cuda_runtime.h>

#include "ntt_common.cuh"

namespace {

constexpr int TILE_LOG = 12;  // 4096 elements = 32 KB of shared memory
constexpr int LOCAL_THREADS = 1024;
constexpr int STAGE_THREADS = 256;

template <class F>
__device__ __forceinline__ uint64_t finish(uint64_t v, uint32_t idx,
                                           const uint64_t* post,
                                           uint64_t scale) {
  if (scale != 1) v = F::mul(v, scale);
  if (post) v = F::mul(v, F::pow_bits(post, idx));
  return v;
}

template <class F>
__global__ void ntt_local(const uint64_t* __restrict__ x,
                          uint64_t* __restrict__ y, int log_n, int tile_log,
                          const uint64_t* __restrict__ tw,
                          const uint64_t* __restrict__ pre,
                          const uint64_t* __restrict__ post, uint64_t scale,
                          int last) {
  extern __shared__ uint64_t s[];
  const uint32_t n = 1u << log_n;
  const uint32_t T = 1u << tile_log;
  const uint64_t* xr = x + (size_t)blockIdx.y * n;
  uint64_t* yr = y + (size_t)blockIdx.y * n;
  const uint32_t base = blockIdx.x * T;

  for (uint32_t t = threadIdx.x; t < T; t += blockDim.x) {
    const uint32_t dst = base + t;
    const uint32_t src = bit_reverse(dst, log_n);
    uint64_t v = xr[src];
    if (pre) v = F::mul(v, F::pow_bits(pre, src));
    s[t] = v;
  }
  __syncthreads();

  for (int st = 1; st <= tile_log; ++st) {
    const uint32_t half = 1u << (st - 1);
    for (uint32_t k = threadIdx.x; k < T / 2; k += blockDim.x) {
      const uint32_t j = k & (half - 1);
      const uint32_t i0 = ((k >> (st - 1)) << st) + j;
      const uint32_t i1 = i0 + half;
      const uint64_t w = tw[(size_t)j << (log_n - st)];
      const uint64_t u = s[i0];
      const uint64_t v = F::mul(s[i1], w);
      s[i0] = F::add(u, v);
      s[i1] = F::sub(u, v);
    }
    __syncthreads();
  }

  for (uint32_t t = threadIdx.x; t < T; t += blockDim.x) {
    uint64_t v = s[t];
    if (last) v = finish<F>(v, base + t, post, scale);
    yr[base + t] = v;
  }
}

template <class F>
__global__ void ntt_stage(uint64_t* __restrict__ y, int log_n, int st,
                          const uint64_t* __restrict__ tw,
                          const uint64_t* __restrict__ post, uint64_t scale,
                          int last) {
  const uint32_t n = 1u << log_n;
  const uint32_t k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= n / 2) return;
  uint64_t* yr = y + (size_t)blockIdx.y * n;
  const uint32_t half = 1u << (st - 1);
  const uint32_t j = k & (half - 1);
  const uint32_t i0 = ((k >> (st - 1)) << st) + j;
  const uint32_t i1 = i0 + half;
  const uint64_t w = tw[(size_t)j << (log_n - st)];
  const uint64_t u = yr[i0];
  const uint64_t v = F::mul(yr[i1], w);
  uint64_t a = F::add(u, v);
  uint64_t b = F::sub(u, v);
  if (last) {
    a = finish<F>(a, i0, post, scale);
    b = finish<F>(b, i1, post, scale);
  }
  yr[i0] = a;
  yr[i1] = b;
}

template <class F>
int run_ntt(const uint64_t* x, uint64_t* y, int batch, int log_n,
            const uint64_t* tw, const uint64_t* pre, const uint64_t* post,
            uint64_t scale, void* stream) {
  if (log_n < 0 || log_n > 30 || batch < 1 || batch > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  const int tile_log = log_n < TILE_LOG ? log_n : TILE_LOG;
  const uint32_t T = 1u << tile_log;
  const uint32_t n = 1u << log_n;
  int threads = (int)(T / 2);
  if (threads < 1) threads = 1;
  if (threads > LOCAL_THREADS) threads = LOCAL_THREADS;
  const dim3 grid(n / T, batch);
  ntt_local<F><<<grid, threads, T * sizeof(uint64_t), s>>>(
      x, y, log_n, tile_log, tw, pre, post, scale, tile_log == log_n);
  for (int st = tile_log + 1; st <= log_n; ++st) {
    const dim3 g((n / 2 + STAGE_THREADS - 1) / STAGE_THREADS, batch);
    ntt_stage<F><<<g, STAGE_THREADS, 0, s>>>(y, log_n, st, tw, post, scale,
                                             st == log_n);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// x, y: (batch, 2^log_n) rows of canonical values; tw: root^j for
// j < max(n/2, 1); pre / post: s^(2^b) for b < log_n, or null; scale: 1/n for
// an inverse transform, else 1.
extern "C" int ms_ntt_gl(const uint64_t* x, uint64_t* y, int batch, int log_n,
                         const uint64_t* tw, const uint64_t* pre,
                         const uint64_t* post, uint64_t scale, void* stream) {
  return run_ntt<gl>(x, y, batch, log_n, tw, pre, post, scale, stream);
}

extern "C" int ms_ntt_bb(const uint64_t* x, uint64_t* y, int batch, int log_n,
                         const uint64_t* tw, const uint64_t* pre,
                         const uint64_t* post, uint64_t scale, void* stream) {
  return run_ntt<bb>(x, y, batch, log_n, tw, pre, post, scale, stream);
}
