// Four-step NTT, n = n1 * n2 (n2 = 2^floor(log n / 2), n1 = n2 or 2 n2,
// 2^14 <= n <= 2^22), in two shared-memory passes over (batch, n) rows in
// natural order, for Goldilocks and for BabyBear (templates on the field:
// ms_ntt_four_step_pass{1,2}_{gl,bb}).
//
// Replaces the Pallas kernels ministark_tpu/ops/ntt_pallas.py::
// _make_pass1_kernel (:190) and _make_pass2_kernel (:204), via _make_passes
// (BabyBear with nlimbs = 1). With x[i2 * n1 + i1] read as the (n2, n1)
// matrix A[i2, i1], w of order n, w1 = w^n2 and w2 = w^n1:
//
//   X[k2 + n2 * k1] = sum_i1 w1^(i1 k1) * w^(i1 k2) * sum_i2 A[i2, i1] w2^(i2 k2)
//
// Bound on the H100: integer throughput, in both fields (a pass runs
// log2(n2) or log2(n1) butterflies of ~42 operations in Goldilocks, ~24 in
// BabyBear, per two elements, against 16 bytes an element moves through
// device memory). So each pass spends as few operations, barriers and
// stalls per element as it can, as the tile of ntt.cu's first pass
// (ntt_stages.cuh) with another address map:
//
//  * pass 1 (grid n1 / 4 x batch): a block holds 4 adjacent columns i1 of
//    all n2 positions. Position m is loaded from x[brev(m) n1 + i1] (the JAX
//    prep gather, in 32-byte runs), times s^idx for a coset; all log2(n2)
//    decimation-in-time stages with the roots of order n2 give C[k2, i1] in
//    natural k2; the store multiplies by w^(i1 k2) and writes rows of C in
//    32-byte runs;
//  * pass 2 (grid n2 / 4 x batch): a block holds 4 adjacent rows k2 of C.
//    Element i1 of a row is loaded (8 consecutive i1 of each row a warp, 64
//    bytes) to position brev(i1), so that all log2(n1) decimation-in-time
//    stages with the roots of order n1 give k1 in natural order (no gather
//    after them); the store writes X[k2 + n2 k1] in 32-byte runs of 4 k2,
//    times the post power with 1/n folded in, or 1/n alone.
//
// How each pass keeps its operations down:
//  * coset powers s^i = lo[i mod 2^h] * hi[i >> h] (ops/ntt.py::
//    coset_tables): one product; the wrapper folds 1/n into pass 2's hi, so
//    an element stores with at most one product for coset and scale;
//  * each thread runs 3 stages on 8 elements in registers between
//    exchanges through shared memory (4 barriers for 11 stages);
//  * pass 1's twiddle is w^e, e = i1 k2 < n, split at n1: w^(e mod n1) *
//    w2^(e div n1), with w2^(n2/2) = -1. Both tables are the wrapper's own
//    (w^i1 for i1 < n1, and the stage roots of w2, which the block holds
//    anyway) and sit in shared memory, where the lanes' scattered reads
//    cost a few bank cycles. One read from the n/2-word table of w would
//    save that product, but it is a gather of one 32-byte L2 sector per
//    element, and the wrapper is not given the root that table is of;
//  * tiles of 4 columns (4 rows of C in pass 2) make every load and store
//    a run of whole 32-byte sectors; rows are padded by one every 8 (pass 2
//    also shifts each quarter of the tile by one row: its load writes
//    positions brev(i1), whose bits below 5 come from i1's top bits, and the
//    shift sends 4 consecutive i1 to 4 banks); at most 104 KB a block at
//    n1 or n2 = 2^11 (tile 72 KB, w2 and w^i1 16 KB each), so two blocks of
//    up to 512 threads share an SM (__launch_bounds__(512, 2): at most 64
//    registers).
//
// Storage: x, c, y and the tables are the field's words (word_t<F>: 64 bits
// for Goldilocks, 32 for BabyBear, the port's int32 tensors), widened on
// load and narrowed on store. The tiles keep 64-bit words in both fields,
// as they were laid out (padding, quarter shifts, bank map), so a
// BabyBear run of 4 columns is 16 bytes, half a sector.
#include <cuda_runtime.h>

#include "ntt_stages.cuh"

namespace {

constexpr int LOG_C = 2;          // a block's columns (pass 1) or rows of C (pass 2)
constexpr int MAX_THREADS = 512;
constexpr int MAX_L = 11;         // the most stages a tile holds

// the tile's words: 4 columns of 2^L positions, one padding row every 8
// and the 4 rows of pass 2's quarter shifts
__host__ __device__ constexpr uint32_t tile_words(int L) {
  return ((1u << L) + ((1u << L) >> 3) + 4) << LOG_C;
}

// pass 2's rows: PadRows, shifted by one row a quarter of the tile. A
// half-warp of a stage round or of the store touches positions in one
// quarter, where the shift is constant.
struct QuarterRows {
  int sh;  // L - 2
  __device__ __forceinline__ uint32_t operator()(uint32_t m) const {
    return srow(m) + (m >> sh);
  }
};

template <class F, class W = word_t<F>>
__global__ void __launch_bounds__(MAX_THREADS, 2)
    four_step_pass1(const W* __restrict__ x, W* __restrict__ c,
                    int log_n1, int log_n2, const W* __restrict__ roots2,
                    const W* __restrict__ wpow,
                    const W* __restrict__ pre_lo,
                    const W* __restrict__ pre_hi) {
  extern __shared__ uint64_t s[];
  const int L = log_n2, log_n = log_n1 + log_n2;
  const uint32_t n1 = 1u << log_n1, n2 = 1u << L, elems = n2 << LOG_C;
  uint64_t* w2 = s + tile_words(L);  // w2^j, j < n2; the stage roots first
  uint64_t* w1 = w2 + n2;            // w^j, j < n1
  const size_t n = (size_t)1 << log_n;
  const W* xr = x + blockIdx.y * n;
  W* cr = c + blockIdx.y * n;
  const uint32_t i0 = blockIdx.x << LOG_C;

  for (uint32_t j = threadIdx.x; j < n2 / 2; j += blockDim.x) {
    const uint64_t r = roots2[j];
    w2[j] = r;
    w2[j + n2 / 2] = F::sub(0, r);  // w2^(n2/2) = -1
  }
  for (uint32_t j = threadIdx.x; j < n1; j += blockDim.x) w1[j] = wpow[j];

  // load: warp lanes take the 4 columns of 8 consecutive positions
  const int h = (log_n + 1) / 2;  // ops/ntt.py::coset_split
  for (uint32_t t = threadIdx.x; t < elems; t += blockDim.x) {
    const uint32_t col = t & ((1u << LOG_C) - 1), m = t >> LOG_C;
    const uint32_t src = (bit_reverse(m, L) << log_n1) + i0 + col;
    uint64_t v = xr[src];
    if (pre_lo) v = F::mul(v, coset_pow<F>(pre_lo, pre_hi, src, h));
    s[(srow(m) << LOG_C) + col] = v;
  }
  __syncthreads();

  all_stages<F>(s, w2, L, LOG_C);

  // store: C[k2, i1] = B[k2, i1] w^e, e = i1 k2 < n
  for (uint32_t t = threadIdx.x; t < elems; t += blockDim.x) {
    const uint32_t col = t & ((1u << LOG_C) - 1), k2 = t >> LOG_C;
    const uint32_t i1 = i0 + col, e = i1 * k2;
    const uint64_t w = F::mul(w1[e & (n1 - 1)], w2[e >> log_n1]);
    cr[((size_t)k2 << log_n1) + i1] = (W)F::mul(s[(srow(k2) << LOG_C) + col], w);
  }
}

template <class F, class W = word_t<F>>
__global__ void __launch_bounds__(MAX_THREADS, 2)
    four_step_pass2(const W* __restrict__ c, W* __restrict__ y,
                    int log_n1, int log_n2, const W* __restrict__ roots1,
                    const W* __restrict__ post_lo,
                    const W* __restrict__ post_hi, uint64_t scale) {
  extern __shared__ uint64_t s[];
  const int L = log_n1, log_n = log_n1 + log_n2;
  const uint32_t n1 = 1u << L, elems = n1 << LOG_C;
  uint64_t* tws = s + tile_words(L);  // w1^j, j < n1 / 2
  const QuarterRows rows{L - 2};
  const size_t n = (size_t)1 << log_n;
  const W* cr = c + blockIdx.y * n;
  W* yr = y + blockIdx.y * n;
  const uint32_t k0 = blockIdx.x << LOG_C;

  for (uint32_t j = threadIdx.x; j < n1 / 2; j += blockDim.x) tws[j] = roots1[j];

  // load: a warp takes 8 consecutive i1 of each of the 4 rows; a half-warp
  // holds i1 mod 4 = 0..3 of every row, which brev sends to 4 quarters
  for (uint32_t t = threadIdx.x; t < elems; t += blockDim.x) {
    const uint32_t r = (t >> 2) & 3;
    const uint32_t i1 = ((t >> 5) << 3) | ((t >> 2) & 4) | (t & 3);
    s[(rows(bit_reverse(i1, L)) << LOG_C) + r] =
        cr[((size_t)(k0 + r) << L) + i1];
  }
  __syncthreads();

  all_stages<F>(s, tws, L, LOG_C, rows);

  // store: lanes take the 4 rows of 8 consecutive k1
  const int h = (log_n + 1) / 2;  // ops/ntt.py::coset_split
  for (uint32_t t = threadIdx.x; t < elems; t += blockDim.x) {
    const uint32_t r = t & ((1u << LOG_C) - 1), k1 = t >> LOG_C;
    const uint32_t idx = k0 + r + (k1 << log_n2);
    uint64_t v = s[(rows(k1) << LOG_C) + r];
    if (post_lo) {
      v = F::mul(v, coset_pow<F>(post_lo, post_hi, idx, h));
    } else if (scale != 1) {
      v = F::mul(v, scale);
    }
    yr[idx] = (W)v;
  }
}

template <typename K>
cudaError_t smem_limit(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// the split of ops/ntt_four_step.py::_split_sizes, 2^14 <= n <= 2^22
bool bad_sizes(int batch, int log_n1, int log_n2) {
  return batch < 1 || batch > 65535 || log_n2 < 7 || log_n1 < log_n2 ||
         log_n1 > log_n2 + 1 || log_n1 > MAX_L;
}

// one thread per 8 elements of a stage round (ops/ntt.py::pass_plan's rule)
unsigned threads_for(int L) {
  const unsigned t = (1u << (L + LOG_C)) >> 3;
  return t < MAX_THREADS ? t : MAX_THREADS;
}

template <class F, class W = word_t<F>>
int run_pass1(const W* x, W* c, int batch, int log_n1, int log_n2,
              const W* roots2, const W* wpow, const W* pre_lo, const W* pre_hi,
              void* stream) {
  if (bad_sizes(batch, log_n1, log_n2) || (pre_lo == nullptr) != (pre_hi == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t bytes =
      (tile_words(log_n2) + (1u << log_n2) + (1u << log_n1)) * sizeof(uint64_t);
  cudaError_t err = smem_limit(four_step_pass1<F, W>, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((1u << log_n1) >> LOG_C, batch);
  four_step_pass1<F, W><<<grid, threads_for(log_n2), bytes, (cudaStream_t)stream>>>(
      x, c, log_n1, log_n2, roots2, wpow, pre_lo, pre_hi);
  return (int)cudaGetLastError();
}

template <class F, class W = word_t<F>>
int run_pass2(const W* c, W* y, int batch, int log_n1, int log_n2,
              const W* roots1, const W* post_lo, const W* post_hi, uint64_t scale,
              void* stream) {
  if (bad_sizes(batch, log_n1, log_n2) || (post_lo == nullptr) != (post_hi == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t bytes = (tile_words(log_n1) + (1u << log_n1) / 2) * sizeof(uint64_t);
  cudaError_t err = smem_limit(four_step_pass2<F, W>, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((1u << log_n2) >> LOG_C, batch);
  four_step_pass2<F, W><<<grid, threads_for(log_n1), bytes, (cudaStream_t)stream>>>(
      c, y, log_n1, log_n2, roots1, post_lo, post_hi, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Pass 1. x: (batch, n1 * n2) natural order; c: (batch, n2, n1) output;
// roots2: w2^j for j < n2 / 2 (the last row of the stage table of w2); wpow:
// w^j for j < n1; pre_lo / pre_hi: ops/ntt.py::coset_tables, or null.
extern "C" int ms_ntt_four_step_pass1_gl(const uint64_t* x, uint64_t* c,
                                         int batch, int log_n1, int log_n2,
                                         const uint64_t* roots2,
                                         const uint64_t* wpow,
                                         const uint64_t* pre_lo,
                                         const uint64_t* pre_hi, void* stream) {
  return run_pass1<gl>(x, c, batch, log_n1, log_n2, roots2, wpow, pre_lo,
                       pre_hi, stream);
}

// the same over BabyBear's 32-bit words
extern "C" int ms_ntt_four_step_pass1_bb(const uint32_t* x, uint32_t* c,
                                         int batch, int log_n1, int log_n2,
                                         const uint32_t* roots2,
                                         const uint32_t* wpow,
                                         const uint32_t* pre_lo,
                                         const uint32_t* pre_hi, void* stream) {
  return run_pass1<bb>(x, c, batch, log_n1, log_n2, roots2, wpow, pre_lo,
                       pre_hi, stream);
}

// Pass 2. c: (batch, n2, n1) from pass 1; y: (batch, n1 * n2) natural order;
// roots1: w1^j for j < n1 / 2 (the last row of the stage table of w1);
// post_lo / post_hi: ops/ntt.py::coset_tables with 1/n folded into hi for an
// inverse transform, or null; scale: 1/n for an inverse transform without
// post, else 1.
extern "C" int ms_ntt_four_step_pass2_gl(const uint64_t* c, uint64_t* y,
                                         int batch, int log_n1, int log_n2,
                                         const uint64_t* roots1,
                                         const uint64_t* post_lo,
                                         const uint64_t* post_hi,
                                         uint64_t scale, void* stream) {
  return run_pass2<gl>(c, y, batch, log_n1, log_n2, roots1, post_lo, post_hi,
                       scale, stream);
}

extern "C" int ms_ntt_four_step_pass2_bb(const uint32_t* c, uint32_t* y,
                                         int batch, int log_n1, int log_n2,
                                         const uint32_t* roots1,
                                         const uint32_t* post_lo,
                                         const uint32_t* post_hi,
                                         uint64_t scale, void* stream) {
  return run_pass2<bb>(c, y, batch, log_n1, log_n2, roots1, post_lo, post_hi,
                       scale, stream);
}
