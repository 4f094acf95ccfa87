// One level of the factor-walk NTT: a length-F DFT over axis 1 of (B, F, R),
// written as (B, R, F), with the optional coset pre-multiply, inter-level
// twiddle and trailing scalar, as a software pipeline. A template on the
// field: ms_ntt_pipe_level_gl and ms_ntt_pipe_level_bb.
//
// Replaces the Pallas kernel ministark_tpu/ops/ntt_mxu.py::_make_pipe_kernel
// (via _fused_level_pipe; its BabyBear branch recombines one digit plane with
// _recombine_bb): the TPU kernel skews a grid over tiles of
// positions so that the MXU dot of tile t - 1 overlaps the VPU digitize of
// tile t and the recombine of tile t - 2. Hopper multiplies 64-bit integers
// natively, so the DFT is radix-2 butterflies in shared memory with the
// level's root, which gives the same canonical outputs; the skew becomes a
// double buffer. Each block walks tiles t = blockIdx.x, + gridDim.x, ... of
// TP positions (all F values of each): while tile t is transformed and
// stored from one buffer, cp.async copies tile t + gridDim.x into the other.
//
//  * load: F rows of TP consecutive positions (coalesced), each element
//    placed at its bit-reversed row, so the decimation-in-time stages need no
//    permutation; level 0 of a coset transform multiplies in s^(m R + r)
//    (from a table of s^(2^b)) before the stages;
//  * all log2(F) stages down the tile's columns, twiddles from the level's
//    (log2 F, F / 2) stage table (row s - 1 holds root^(j << (log F - s)));
//  * store: out[b, r, k] for the tile's TP positions, F consecutive values
//    each, times the twiddle W[r / K_prod, k] (W is the (M, F) table of
//    root^(i1 k2); the TPU kernel's repeat(W, K_prod) rows are indexed here
//    instead of materialised) and the trailing scalar (1/n on the last level
//    of an inverse transform).
//
// Rows of the tile are padded by one element so the store's column reads fall
// in different banks. Bound on the H100: integer throughput (log2(F)
// butterflies of ~40 operations per element in Goldilocks, ~20 in BabyBear,
// against 16 bytes moved).
#include <cuda_pipeline_primitives.h>
#include <cuda_runtime.h>

#include "ntt_common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int TILE_ELEMS_LOG = 12;  // TP * F = 4096 values per buffer

struct Level {
  int batch, log_f, log_r, log_tp, log_kprod;
  const uint64_t* tw;    // (log_f, F / 2) stage table
  const uint64_t* pre;   // s^(2^b), or null
  const uint64_t* W;     // (R / K_prod, F) twiddles, or null
  uint64_t scale;        // 1 for none
};

__device__ __forceinline__ void load_tile(const uint64_t* __restrict__ x,
                                          uint64_t* buf, uint32_t t,
                                          const Level& L) {
  const uint32_t F = 1u << L.log_f, TP = 1u << L.log_tp;
  const uint32_t tiles_per_row = 1u << (L.log_r - L.log_tp);
  const uint32_t b = t / tiles_per_row;
  const size_t r0 = (size_t)(t % tiles_per_row) << L.log_tp;
  const uint64_t* src = x + ((size_t)b << (L.log_f + L.log_r)) + r0;
  for (uint32_t e = threadIdx.x; e < F * TP; e += blockDim.x) {
    const uint32_t m = e >> L.log_tp, rl = e & (TP - 1);
    __pipeline_memcpy_async(&buf[bit_reverse(m, L.log_f) * (TP + 1) + rl],
                            &src[((size_t)m << L.log_r) + rl], sizeof(uint64_t));
  }
  __pipeline_commit();
}

template <class Field>
__global__ void pipe_level(const uint64_t* __restrict__ x,
                           uint64_t* __restrict__ y, Level L) {
  extern __shared__ uint64_t smem[];
  const uint32_t F = 1u << L.log_f, TP = 1u << L.log_tp;
  const uint32_t stride = TP + 1;
  const uint32_t buf_elems = F * stride;
  const uint32_t tiles_per_row = 1u << (L.log_r - L.log_tp);
  const uint32_t total = (uint32_t)L.batch * tiles_per_row;

  uint32_t t = blockIdx.x;
  if (t >= total) return;
  load_tile(x, smem, t, L);
  for (int i = 0; t < total; ++i) {
    const uint32_t next = t + gridDim.x;
    uint64_t* cur = smem + (i & 1) * buf_elems;
    if (next < total) {
      load_tile(x, smem + ((i + 1) & 1) * buf_elems, next, L);
      __pipeline_wait_prior(1);
    } else {
      __pipeline_wait_prior(0);
    }
    __syncthreads();

    const uint32_t b = t / tiles_per_row;
    const uint32_t r0 = (t % tiles_per_row) << L.log_tp;
    if (L.pre) {
      for (uint32_t e = threadIdx.x; e < F * TP; e += blockDim.x) {
        const uint32_t q = e >> L.log_tp, rl = e & (TP - 1);
        const uint32_t m = bit_reverse(q, L.log_f);
        cur[q * stride + rl] = Field::mul(
            cur[q * stride + rl], Field::pow_bits(L.pre, (m << L.log_r) + r0 + rl));
      }
      __syncthreads();
    }

    const uint32_t half_f = F / 2;
    for (int st = 1; st <= L.log_f; ++st) {
      const uint32_t half = 1u << (st - 1);
      const uint64_t* tws = L.tw + (size_t)(st - 1) * half_f;
      for (uint32_t k = threadIdx.x; k < half_f * TP; k += blockDim.x) {
        const uint32_t col = k & (TP - 1), bf = k >> L.log_tp;
        const uint32_t j = bf & (half - 1);
        const uint32_t i0 = ((bf >> (st - 1)) << st) + j;
        const uint32_t a0 = i0 * stride + col, a1 = (i0 + half) * stride + col;
        const uint64_t u = cur[a0];
        const uint64_t v = Field::mul(cur[a1], tws[j]);
        cur[a0] = Field::add(u, v);
        cur[a1] = Field::sub(u, v);
      }
      __syncthreads();
    }

    uint64_t* dst = y + ((size_t)b << (L.log_f + L.log_r)) + ((size_t)r0 << L.log_f);
    for (uint32_t e = threadIdx.x; e < F * TP; e += blockDim.x) {
      const uint32_t k = e & (F - 1), rl = e >> L.log_f;
      uint64_t v = cur[k * stride + rl];
      if (L.W) v = Field::mul(v, L.W[((size_t)((r0 + rl) >> L.log_kprod) << L.log_f) + k]);
      if (L.scale != 1) v = Field::mul(v, L.scale);
      dst[e] = v;
    }
    __syncthreads();  // the next iteration's load overwrites this buffer
    t = next;
  }
}

template <class Field>
int run_level(const uint64_t* x, uint64_t* y, int batch, int log_f, int log_r,
              const uint64_t* tw, const uint64_t* pre, const uint64_t* W,
              int log_kprod, uint64_t scale, void* stream) {
  if (batch < 1 || log_f < 5 || log_f > 9 || log_r < 0 ||
      log_f + log_r > 30 || log_kprod < 0 || log_kprod > log_r) {
    return (int)cudaErrorInvalidValue;
  }
  Level L;
  L.batch = batch;
  L.log_f = log_f;
  L.log_r = log_r;
  L.log_tp = TILE_ELEMS_LOG - log_f < log_r ? TILE_ELEMS_LOG - log_f : log_r;
  L.log_kprod = log_kprod;
  L.tw = tw;
  L.pre = pre;
  L.W = W;
  L.scale = scale;
  const size_t bytes =
      2 * ((size_t)1 << log_f) * (((size_t)1 << L.log_tp) + 1) * sizeof(uint64_t);
  cudaError_t err = cudaFuncSetAttribute(
      pipe_level<Field>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) !=
      cudaSuccess) {
    return (int)err;
  }
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, pipe_level<Field>,
                                                           THREADS, bytes)) !=
      cudaSuccess) {
    return (int)err;
  }
  const uint64_t total = (uint64_t)batch << (log_r - L.log_tp);
  if (total > 0xFFFFFFFFull) return (int)cudaErrorInvalidValue;
  uint64_t blocks = (uint64_t)sms * (per_sm > 0 ? per_sm : 1);
  if (blocks > total) blocks = total;
  pipe_level<Field><<<(unsigned)blocks, THREADS, bytes, (cudaStream_t)stream>>>(x, y, L);
  return (int)cudaGetLastError();
}

}  // namespace

// x: (batch, F, R) -> y: (batch, R, F), F = 2^log_f in [2^5, 2^9], R = 2^log_r;
// tw: the (log_f, F / 2) stage table of the level's root; pre: s^(2^b) for
// b < log_f + log_r, or null; W: (R / 2^log_kprod, F) twiddles, or null;
// scale: the trailing scalar, 1 for none.
extern "C" int ms_ntt_pipe_level_gl(const uint64_t* x, uint64_t* y, int batch,
                                    int log_f, int log_r, const uint64_t* tw,
                                    const uint64_t* pre, const uint64_t* W,
                                    int log_kprod, uint64_t scale, void* stream) {
  return run_level<gl>(x, y, batch, log_f, log_r, tw, pre, W, log_kprod, scale,
                       stream);
}

extern "C" int ms_ntt_pipe_level_bb(const uint64_t* x, uint64_t* y, int batch,
                                    int log_f, int log_r, const uint64_t* tw,
                                    const uint64_t* pre, const uint64_t* W,
                                    int log_kprod, uint64_t scale, void* stream) {
  return run_level<bb>(x, y, batch, log_f, log_r, tw, pre, W, log_kprod, scale,
                       stream);
}
