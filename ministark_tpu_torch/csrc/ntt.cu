// Batched NTT over (batch, n) rows in natural order, for Goldilocks and for
// BabyBear (a template on the field: ms_ntt_gl and ms_ntt_bb).
//
// Replaces the Pallas kernel ministark_tpu/ops/ntt_mxu.py::_make_fused_kernel
// (one NTT level as an int8 digit matmul on the TPU's MXU; its BabyBear
// branch recombines one digit plane with _recombine_bb). Hopper multiplies
// 64-bit integers natively, so this is a radix-2 decimation-in-time NTT with
// the same root of unity, which gives the same canonical outputs.
//
// Bound on the H100: integer throughput, in both fields (a butterfly is ~42
// operations in Goldilocks, ~24 in BabyBear, against 16 bytes per element
// per trip through device memory). So a transform is a few passes, each one
// trip (ops/ntt.py::pass_plan; transform_passes_plain replays it on the CPU):
//
//  * a pass runs stages s0 + 1 .. s0 + L (L <= 11) on independent 2^L-point
//    columns at stride 2^s0. A block holds C (<= 4) adjacent columns, so
//    every load and store is a run of C * 8 = 32 bytes, a whole sector. The
//    first pass reads column c of the input as x[brev_L(m) 2^(log n - L) + c]
//    (the bit-reversed gather, on whole sectors) and writes it as tile
//    brev(c) of the bit-reversed array, a contiguous run. A later pass first
//    multiplies position m of column lo by w^(lo brev_L(m) 2^(log n - s0 -
//    L)): the part of its stages' twiddles that depends on the column, taken
//    out in front, so that the stages themselves use the 2^(L-1) roots of a
//    2^L-point transform, held in shared memory;
//  * inside a pass, each thread holds 8 elements of one column in registers
//    and runs 3 stages on them between exchanges through shared memory
//    (rows padded by one every 8, so neither the exchanges nor the runs of
//    8 rows that a warp loads and stores meet a bank conflict);
//  * coset powers s^i come from two tables, lo[i mod 2^h] * hi[i >> h]: one
//    product. The last pass applies the post powers (1/n folded into hi by
//    the wrapper) or the 1/n scale alone.
//
// The padded rows, the coset power and the stages are in ntt_stages.cuh,
// which the four-step passes (ntt_four_step.cu) share.
//
// Passes after the first run in place in y: a block reads its whole tile
// before it writes, and no two blocks share an element.
#include <cuda_runtime.h>

#include "ntt_stages.cuh"

namespace {

constexpr int MAX_THREADS = 512;
constexpr int MAX_LOG_N = 30;
constexpr int PLAN_HEAD = 3;    // passes, coset split h, log order of tile_tw
constexpr int PLAN_FIELDS = 6;  // s0, L, log_cols, threads, blocks, smem

template <class F>
__global__ void __launch_bounds__(MAX_THREADS, 2)
    ntt_pass(const uint64_t* x, uint64_t* y, int log_n, int s0, int L,
             int log_c, int tile_log, int h, const uint64_t* __restrict__ tw,
             const uint64_t* __restrict__ tile_tw,
             const uint64_t* __restrict__ pre_lo,
             const uint64_t* __restrict__ pre_hi,
             const uint64_t* __restrict__ post_lo,
             const uint64_t* __restrict__ post_hi, uint64_t scale, int last) {
  extern __shared__ uint64_t s[];
  const uint32_t T = 1u << L, C = 1u << log_c, elems = T << log_c;
  uint64_t* tws = s + ((size_t)(T + (T >> 3)) << log_c);
  const size_t n = (size_t)1 << log_n;
  const uint64_t* xr = x + blockIdx.y * n;
  uint64_t* yr = y + blockIdx.y * n;

  // the stage roots of a 2^L-point transform, w_(2^L)^j for j < 2^(L-1)
  for (uint32_t j = threadIdx.x; j < T / 2; j += blockDim.x) {
    tws[j] = tile_tw[(size_t)j << (tile_log - L)];
  }

  // load: warp lanes take C columns of 32 / C consecutive rows
  const int cb = log_n - L;  // the first pass: log2 of the column count
  const uint32_t c0 = blockIdx.x << log_c;
  size_t origin = 0;         // a later pass: its tile's first element
  uint32_t lo0 = 0;
  if (s0 == 0) {
    for (uint32_t t = threadIdx.x; t < elems; t += blockDim.x) {
      const uint32_t c = t & (C - 1), m = t >> log_c;
      const uint32_t src = (bit_reverse(m, L) << cb) + c0 + c;
      uint64_t v = xr[src];
      if (pre_lo) v = F::mul(v, coset_pow<F>(pre_lo, pre_hi, src, h));
      s[(srow(m) << log_c) + c] = v;
    }
  } else {
    const int lo_bits = s0 - log_c;
    lo0 = (blockIdx.x & ((1u << lo_bits) - 1)) << log_c;
    origin = ((size_t)(blockIdx.x >> lo_bits) << (s0 + L)) + lo0;
    const int shift = log_n - s0 - L;
    const uint32_t half = (uint32_t)(n / 2);
    for (uint32_t t = threadIdx.x; t < elems; t += blockDim.x) {
      const uint32_t c = t & (C - 1), m = t >> log_c;
      uint64_t v = xr[origin + ((size_t)m << s0) + c];
      // w^e, e < n: w^(n/2) = -1
      const uint32_t e = ((lo0 + c) * bit_reverse(m, L)) << shift;
      if (e) {
        const uint64_t w = e < half ? tw[e] : F::sub(0, tw[e - half]);
        v = F::mul(v, w);
      }
      s[(srow(m) << log_c) + c] = v;
    }
  }
  __syncthreads();

  all_stages<F>(s, tws, L, log_c);

  // store: the first pass writes C separate tiles, so a warp takes runs of
  // 8 rows of each column; a later pass writes as it loaded
  const int ml = L < 3 ? L : 3;
  for (uint32_t t = threadIdx.x; t < elems; t += blockDim.x) {
    uint32_t c, m;
    size_t dst;
    if (s0 == 0) {
      c = (t >> ml) & (C - 1);
      m = ((t >> (ml + log_c)) << ml) | (t & ((1u << ml) - 1));
      dst = ((size_t)bit_reverse(c0 + c, cb) << L) + m;
    } else {
      c = t & (C - 1);
      m = t >> log_c;
      dst = origin + ((size_t)m << s0) + c;
    }
    uint64_t v = s[(srow(m) << log_c) + c];
    if (last) {
      if (post_lo) {
        v = F::mul(v, coset_pow<F>(post_lo, post_hi, (uint32_t)dst, h));
      } else if (scale != 1) {
        v = F::mul(v, scale);
      }
    }
    yr[dst] = v;
  }
}

template <class F>
int run_ntt(const uint64_t* x, uint64_t* y, int batch, int log_n,
            const int64_t* plan, const uint64_t* tw, const uint64_t* tile_tw,
            const uint64_t* pre_lo, const uint64_t* pre_hi,
            const uint64_t* post_lo, const uint64_t* post_hi, uint64_t scale,
            int64_t* launched, void* stream) {
  if (log_n < 0 || log_n > MAX_LOG_N || batch < 1 || batch > 65535 ||
      plan[0] < 1 || (pre_lo == nullptr) != (pre_hi == nullptr) ||
      (post_lo == nullptr) != (post_hi == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const int passes = (int)plan[0], h = (int)plan[1], tile_log = (int)plan[2];
  int s0 = 0;
  for (int i = 0; i < passes; ++i) {
    const int64_t* p = plan + PLAN_HEAD + PLAN_FIELDS * i;
    const int L = (int)p[1], log_c = (int)p[2], threads = (int)p[3];
    const size_t smem = (size_t)p[5];
    if (p[0] != s0 || L > tile_log || s0 + L > log_n ||
        log_c > (s0 ? s0 : log_n - L) || threads < 1 || threads > MAX_THREADS ||
        p[4] != ((int64_t)1 << log_n) >> (L + log_c)) {
      return (int)cudaErrorInvalidValue;
    }
    const int last = i == passes - 1;
    if (last && s0 + L != log_n) return (int)cudaErrorInvalidValue;
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          ntt_pass<F>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    ntt_pass<F><<<dim3((unsigned)p[4], batch), threads, smem,
                  (cudaStream_t)stream>>>(
        i == 0 ? x : y, y, log_n, s0, L, log_c, tile_log, h, tw, tile_tw,
        pre_lo, pre_hi, post_lo, post_hi, scale, last);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    ++*launched;
    s0 += L;
  }
  return (int)cudaSuccess;
}

}  // namespace

// x, y: (batch, 2^log_n) rows of canonical values (x is read by the first
// pass only); plan: ops/ntt.py::_plan_array; tw: w^j for j < max(n/2, 1);
// tile_tw: the first pass's stage roots w_(2^L1)^j, j < max(2^(L1-1), 1);
// pre_lo / pre_hi, post_lo / post_hi: ops/ntt.py::coset_tables, or null;
// scale: 1/n for an inverse transform without post, else 1; launched: a
// host counter, plus one for each pass launched.
extern "C" int ms_ntt_gl(const uint64_t* x, uint64_t* y, int batch, int log_n,
                         const int64_t* plan, const uint64_t* tw,
                         const uint64_t* tile_tw, const uint64_t* pre_lo,
                         const uint64_t* pre_hi, const uint64_t* post_lo,
                         const uint64_t* post_hi, uint64_t scale,
                         int64_t* launched, void* stream) {
  return run_ntt<gl>(x, y, batch, log_n, plan, tw, tile_tw, pre_lo, pre_hi,
                     post_lo, post_hi, scale, launched, stream);
}

extern "C" int ms_ntt_bb(const uint64_t* x, uint64_t* y, int batch, int log_n,
                         const int64_t* plan, const uint64_t* tw,
                         const uint64_t* tile_tw, const uint64_t* pre_lo,
                         const uint64_t* pre_hi, const uint64_t* post_lo,
                         const uint64_t* post_hi, uint64_t scale,
                         int64_t* launched, void* stream) {
  return run_ntt<bb>(x, y, batch, log_n, plan, tw, tile_tw, pre_lo, pre_hi,
                     post_lo, post_hi, scale, launched, stream);
}
