// One level of the factor-walk NTT: a length-F DFT over axis 1 of (B, F, R),
// written as (B, R, F), for Goldilocks and for BabyBear (a template on the
// field: ms_ntt_pipe_level_gl and ms_ntt_pipe_level_bb):
//
//   out[b, r, k] = (sum_m x[b, m, r] s^(m R + r) w^(m k)) W[r / K, k] scale
//
// with w of order F, the coset s on level 0 only, the inter-level twiddle W
// (the (R / K, F) table of r_i^(i1 k2); the TPU kernel's repeat(W, K) rows are
// indexed here instead of materialised) absent on the last level, and scale
// 1/n on the last level of an inverse transform.
//
// Replaces the Pallas kernel ministark_tpu/ops/ntt_mxu.py::_make_pipe_kernel
// (:486, via _fused_level_pipe :566; its BabyBear branch recombines one digit
// plane with _recombine_bb). The TPU kernel skews a grid over tiles of
// positions so that the MXU dot of tile t - 1 overlaps the VPU digitize of
// tile t and the recombine of tile t - 2. Hopper multiplies 64-bit integers
// natively, so the DFT is radix-2 butterflies in shared memory with the
// level's root, which gives the same canonical outputs.
//
// Bound on the H100: integer throughput, in both fields (log2(F) stages of
// butterflies, ~42 operations per two values in Goldilocks and ~24 in
// BabyBear, against 16 bytes moved per value: utils/roofline.py::pass_work).
// So a block spends as few operations, barriers and stalls per value as it
// can, with radix-2's tile (ntt_stages.cuh) under another address map:
//
//  * the tile: the F positions of C = max(16, 2^11 / F) adjacent r (fewer
//    only where R is smaller), F C / 8 threads (at most 512): each thread
//    runs the 3 stages of a round on 8 values in registers
//    (ntt_stages.cuh::all_stages_at), so F = 128 takes 3 barriers, not 7.
//    Position m sits in row brev(m), so the decimation-in-time stages give
//    natural k. The F / 2 stage roots sit in shared memory;
//  * the load: cp.async copies of 16 bytes (two adjacent r of one row m), a
//    warp's quarter reading a 128-byte run of x; the coset power of level 0
//    is one product, s^i = lo[i mod 2^h] hi[i >> h] (ops/ntt.py::
//    coset_tables), multiplied into each value as the first stage round
//    reads it into registers (no pass of its own over the tile);
//  * the store: lanes take 8 consecutive k of 4 columns (a 64-byte run of
//    out per column), times at most one product per table: W's row read, or
//    (given its split tables) W's r_i^e from two tables of ~sqrt(F R / K) words as
//    the four-step's pass 1 forms its twiddle, and the scale;
//  * banks: no padding (it would misalign the copies); the 16-byte chunk p
//    of row m is stored at chunk p ^ (m & 7) (for C >= 16), so that the
//    copies, the stage rounds (16 columns of a row a half-warp) and the
//    store (8 consecutive rows of 2 columns a half-warp) each meet 16
//    different bank pairs (tests/torch_pipe_checks.py holds the lane maps);
//  * the grid: one tile a block. The TPU kernel's pipeline (tile t + 1
//    copied while tile t is transformed) comes from the blocks resident on
//    an SM, which overlap one tile's copies with another's work; a
//    persistent double-buffered walk read 2-17% slower on the H100
//    (PERF.md, row 5).
//
// At most 512 threads and 2 blocks an SM asked of the compiler (at most 64
// registers); a tile of 16 KB (F <= 128) to 64 KB (F = 512), so 3 or more
// blocks share an SM's shared memory.
#include <cuda_runtime.h>

#include "ntt_stages.cuh"

namespace {

constexpr int MAX_THREADS = 512;
constexpr int TILE_LOG = 11;   // F C values a tile (C >= 16)
constexpr int MIN_LOG_C = 4;   // 16 columns: a row of the tile is 128 bytes

struct Level {
  int log_f, log_r, log_c, log_kprod;
  int swz_shift;                  // the tile's swizzle: row bits m >> shift,
  uint32_t swz_mask;              // masked, select the chunk's XOR
  uint32_t tiles_per_row;         // R / C
  int pre_h, w_h;                 // the splits of the coset and W tables
  const uint64_t* roots;          // w^j, j < F / 2
  const uint64_t* pre_lo;         // coset tables, or null
  const uint64_t* pre_hi;
  const uint64_t* W;              // (R / K, F) twiddles, or null
  const uint64_t* w_lo;           // W's split tables, or null
  const uint64_t* w_hi;
  uint64_t scale;                 // 1 for none
};

// the word of tile position (row) m, column c: chunk c / 2 XORed by the row
struct Swizzled {
  int log_c, shift;
  uint32_t mask;
  __device__ __forceinline__ uint32_t operator()(uint32_t m, uint32_t c) const {
    return (m << log_c) + (c ^ (((m >> shift) & mask) << 1));
  }
};

__device__ __forceinline__ void copy16(uint64_t* dst, const uint64_t* src) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void copy8(uint64_t* dst, const uint64_t* src) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }

// Copy unit u of tile t (16 bytes: row q, columns c and c + 1; 8 bytes where
// C = 1) goes to the tile's word 2u (u where C = 1), so that a warp's quarter
// fills one 128-byte line; row q holds position m = brev(q), and c is the
// unit's first column before the swizzle.
__device__ __forceinline__ void load_tile(const uint64_t* __restrict__ x,
                                          uint64_t* tile, uint32_t t,
                                          const Level& L) {
  const uint64_t* src = x + ((size_t)(t / L.tiles_per_row) << (L.log_f + L.log_r)) +
                        ((t % L.tiles_per_row) << L.log_c);
  const int log_unit = L.log_c ? 1 : 0;
  const int log_upr = L.log_c - log_unit;  // units a row
  const uint32_t units = (1u << (L.log_f + L.log_c)) >> log_unit;
  for (uint32_t u = threadIdx.x; u < units; u += blockDim.x) {
    const uint32_t q = u >> log_upr;
    const uint32_t c = ((u & ((1u << log_upr) - 1)) << log_unit) ^
                       (((q >> L.swz_shift) & L.swz_mask) << 1);
    const uint64_t* g = src + ((size_t)bit_reverse(q, L.log_f) << L.log_r) + c;
    if (log_unit) {
      copy16(tile + (u << 1), g);
    } else {
      copy8(tile + u, g);
    }
  }
  commit();
}

// level 0 of a coset transform: x[m, r] s^(m R + r) for tile row q (m =
// brev(q)), column c, as the first stage round reads it
template <class F>
struct CosetPre {
  const uint64_t* lo;
  const uint64_t* hi;
  int h, log_f, log_r;
  uint32_t r0;
  __device__ __forceinline__ uint64_t operator()(uint64_t v, uint32_t q, uint32_t c) const {
    const uint32_t i = (bit_reverse(q, log_f) << log_r) + r0 + c;
    return F::mul(v, coset_pow<F>(lo, hi, i, h));
  }
};

// out[b, r0 + c, k] for the tile's columns: lanes take 8 consecutive k of
// up to 4 columns
template <class F>
__device__ __forceinline__ void store_tile(const uint64_t* tile,
                                           uint64_t* __restrict__ y, uint32_t t,
                                           const Level& L, Swizzled addr) {
  const uint32_t b = t / L.tiles_per_row;
  const uint32_t r0 = (t % L.tiles_per_row) << L.log_c;
  const int lc = L.log_c < 2 ? L.log_c : 2;  // columns a warp: 2^lc
  const uint32_t elems = 1u << (L.log_f + L.log_c);
  uint64_t* dst = y + ((((size_t)b << L.log_r) + r0) << L.log_f);
  for (uint32_t e = threadIdx.x; e < elems; e += blockDim.x) {
    const uint32_t k = (e & 7) | (((e >> (3 + lc)) & ((1u << (L.log_f - 3)) - 1)) << 3);
    const uint32_t c = ((e >> 3) & ((1u << lc) - 1)) | ((e >> (L.log_f + lc)) << lc);
    uint64_t v = tile[addr(k, c)];
    if (L.W) {
      const uint32_t row = (r0 + c) >> L.log_kprod;
      v = F::mul(v, L.w_lo ? coset_pow<F>(L.w_lo, L.w_hi, row * k, L.w_h)
                           : L.W[((size_t)row << L.log_f) + k]);
    }
    if (L.scale != 1) v = F::mul(v, L.scale);
    dst[((size_t)c << L.log_f) + k] = v;
  }
}

// kCoset: level 0 of a coset transform (its own instantiation, so that the
// other levels' stage rounds carry nothing of the coset)
template <class F, bool kCoset>
__global__ void __launch_bounds__(MAX_THREADS, 2)
    pipe_level(const uint64_t* __restrict__ x, uint64_t* __restrict__ y, Level L) {
  extern __shared__ __align__(16) uint64_t smem[];
  const uint32_t half_f = 1u << (L.log_f - 1);
  uint64_t* roots = smem;                 // F / 2 >= 16 words: the tile
  uint64_t* tile = smem + half_f;         // starts on a 128-byte line
  const Swizzled addr{L.log_c, L.swz_shift, L.swz_mask};

  const uint32_t t = blockIdx.x;
  load_tile(x, tile, t, L);
  for (uint32_t j = threadIdx.x; j < half_f; j += blockDim.x) roots[j] = L.roots[j];
  wait_all();
  __syncthreads();
  if constexpr (kCoset) {
    const CosetPre<F> pre{L.pre_lo, L.pre_hi, L.pre_h, L.log_f, L.log_r,
                          (t % L.tiles_per_row) << L.log_c};
    all_stages_at<F>(tile, roots, L.log_f, L.log_c, addr, pre);
  } else {
    all_stages_at<F>(tile, roots, L.log_f, L.log_c, addr);
  }
  store_tile<F>(tile, y, t, L, addr);
}

template <class F>
int run_level(const uint64_t* x, uint64_t* y, int batch, int log_f, int log_r,
              const uint64_t* roots, const uint64_t* pre_lo, const uint64_t* pre_hi,
              const uint64_t* W, const uint64_t* w_lo, const uint64_t* w_hi,
              int log_kprod, uint64_t scale, void* stream) {
  if (batch < 1 || log_f < 5 || log_f > 9 || log_r < 0 || log_f + log_r > 30 ||
      log_kprod < 0 || log_kprod > log_r || (pre_lo == nullptr) != (pre_hi == nullptr) ||
      (w_lo == nullptr) != (w_hi == nullptr) || (w_lo != nullptr && W == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  Level L;
  L.log_f = log_f;
  L.log_r = log_r;
  L.log_c = TILE_LOG - log_f;                 // F C = 2^11 values
  if (L.log_c < MIN_LOG_C) L.log_c = MIN_LOG_C;  // at least 16 columns
  if (L.log_c > log_r) L.log_c = log_r;
  L.log_kprod = log_kprod;
  // chunks a row: 2^(log_c - 1); rows a 128-byte line: 2^(4 - log_c)
  L.swz_shift = L.log_c >= 4 ? 0 : 4 - L.log_c;
  L.swz_mask = L.log_c >= 4 ? 7u : L.log_c ? (1u << (L.log_c - 1)) - 1 : 0u;
  L.tiles_per_row = 1u << (log_r - L.log_c);
  const uint64_t blocks = (uint64_t)batch << (log_r - L.log_c);  // one a tile
  if (blocks > 0x7FFFFFFFull) return (int)cudaErrorInvalidValue;
  L.pre_h = (log_f + log_r + 1) / 2;  // ops/ntt.py::coset_split
  L.w_h = (log_f + log_r - log_kprod + 1) / 2;
  L.roots = roots;
  L.pre_lo = pre_lo;
  L.pre_hi = pre_hi;
  L.W = W;
  L.w_lo = w_lo;
  L.w_hi = w_hi;
  L.scale = scale;

  const size_t words = (size_t)1 << (log_f + L.log_c);
  const size_t threads_wanted = words >> 3;  // a thread per group of 8
  const unsigned threads = threads_wanted < 32 ? 32
                           : threads_wanted > MAX_THREADS ? MAX_THREADS
                                                          : (unsigned)threads_wanted;
  const size_t half_f = (size_t)1 << (log_f - 1);
  void (*kernel)(const uint64_t*, uint64_t*, Level) =
      pre_lo ? pipe_level<F, true> : pipe_level<F, false>;
  const size_t bytes = (half_f + words) * sizeof(uint64_t);
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)blocks, threads, bytes, (cudaStream_t)stream>>>(x, y, L);
  return (int)cudaGetLastError();
}

}  // namespace

// x: (batch, F, R) -> y: (batch, R, F), F = 2^log_f in [2^5, 2^9], R = 2^log_r,
// both 16-byte aligned; roots: w^j for j < F / 2 (the last row of the level's
// stage table); pre_lo / pre_hi: ops/ntt.py::coset_tables of the coset offset
// over F R, or null; W: (R / 2^log_kprod, F) twiddles, or null; w_lo / w_hi:
// W's root r as coset tables over F R / 2^log_kprod (W[i1, k] = r^(i1 k)),
// read in place of W's rows, or null; scale: the trailing scalar, 1 for none.
extern "C" int ms_ntt_pipe_level_gl(const uint64_t* x, uint64_t* y, int batch,
                                    int log_f, int log_r, const uint64_t* roots,
                                    const uint64_t* pre_lo, const uint64_t* pre_hi,
                                    const uint64_t* W, const uint64_t* w_lo,
                                    const uint64_t* w_hi, int log_kprod,
                                    uint64_t scale, void* stream) {
  return run_level<gl>(x, y, batch, log_f, log_r, roots, pre_lo, pre_hi, W, w_lo,
                       w_hi, log_kprod, scale, stream);
}

extern "C" int ms_ntt_pipe_level_bb(const uint64_t* x, uint64_t* y, int batch,
                                    int log_f, int log_r, const uint64_t* roots,
                                    const uint64_t* pre_lo, const uint64_t* pre_hi,
                                    const uint64_t* W, const uint64_t* w_lo,
                                    const uint64_t* w_hi, int log_kprod,
                                    uint64_t scale, void* stream) {
  return run_level<bb>(x, y, batch, log_f, log_r, roots, pre_lo, pre_hi, W, w_lo,
                       w_hi, log_kprod, scale, stream);
}
