// Division by (x - z) and sums weighted by powers of z over Goldilocks Fp2
// and BabyBear Fp4 (ext_field.cuh), for B rows at once, each with its own z:
//
//   ms_pow_dot_*   S[b, p] = sum_(j) c[b, P j + p] z[b]^(start + j), p < P
//                  (P = 1: S[b] = sum_j c[b, j] z^(start + j); P = 2: the
//                  even and odd halves in one pass)
//   ms_div_scan_*  q[b, g] = zinv^(start + g + 1)
//                            (carry[b] + sum_(g < j < n) c'[b, j] z^(start + j))
//
// with c'[b, j] = c[b, j], or c[b, 2j] + alpha c[b, 2j + 1] (the fold), minus
// head[b, start + j] where start + j < H. The rows are read in place through
// a batch stride (0: one polynomial for every row) and a coefficient stride,
// both in words of the field's storage (word_t<X>: Goldilocks 64 bits,
// BabyBear 32, the port's int32 tensors); q is a contiguous (B, n, K) tensor.
// A BabyBear word is widened to 64 bits on load and narrowed on store: the
// tile, the look-back's partials and the scratch keep 64-bit words in both
// fields, as laid out, so BabyBear's tile is filled through registers (a
// cp.async cannot widen; one 16-byte load an Fp4 element where the rows are
// contiguous) and leaves in 8-byte stores.
//
// Replaces no Pallas kernel: the JAX package leaves this division to XLA
// (ministark_tpu/ops/planar.py::synth_div_planes :391 and fold_div_planes
// :419, the blocked local-power form of poly_device.py::synth_div_suffix,
// one fusion a FRI round; ROADMAP X3, X1 for the fold).
//
// The scan is Horner's recurrence read from the top, q[g - 1] = c'[g] +
// z q[g], with q[n - 1] = carry zinv^(start + n): with a[j] = c'[j + 1]
// (j < n - 1) and a[n - 1] = q[n - 1], q[g] = a[g] + z q[g + 1], an affine
// suffix scan with the one multiplier z. Field arithmetic is exact, so the
// order of the sums changes no output bit.
//
// What bounds it on the H100 (utils/roofline.py::div_scan_work): the bytes,
// 16 or 32 read and written an element, against the integer operations of
// the products by a fixed element (Fixed below: one an output for Horner's
// step, one more for the fold; 114 operations in Fp2, 96 in Fp4). A
// work-efficient parallel scan takes two Horner steps an element where a
// serial pass takes one, so the kernel's own least time is that of one more
// product an output: where the operations bound a row (the broadcast query
// row of Fp2) it cannot pass 0.5 of the bound, where the bytes do, the
// bytes' time over that of its operations (Fp2 0.70; Fp4 1: its operations
// stay under its bytes). chip_smoke.py prints each row's ceiling.
//
// div_scan: one launch a call, one block a tile of TILE = THREADS x E
// elements (Fp2 128 x 32, or 128 x 16 with the fold; Fp4 128 x 16: 64 KB of
// shared memory, the Fp2 fold 32 KB), 4 compute warps and two helper warps that take the powers and the
// look-back off their path (each a chain of dependent products): the first
// builds z^(2^s), the second takes z^base, zinv^(base + TILE), q[n - 1] and
// then the look-back:
//   ticket    a helper takes the next ticket of an atomic counter; ticket k is
//             row k / tiles, tile tiles - 1 - k % tiles: the top tile of a row
//             first, so a block waits only on tiles that running blocks hold
//             and no order of block scheduling can stall it.
//   load      the tile of a[] into shared memory once, coalesced: cp.async of
//             16-byte units where the row is contiguous and unfolded (the
//             broadcast row too), else 16-byte (or u64) loads through
//             registers with the fold (one product by the fixed alpha); then the head
//             subtraction and a[n - 1] (the top tile, by square and
//             multiply). Meanwhile the helpers' lanes take a power each.
//   chunks    thread t's E neighbours, Horner in z (E - 1 products by the
//             fixed z, each a matrix over the base field, Fixed below), then an
//             inclusive suffix scan of the 32 chunk sums of a warp by
//             __shfl_down_sync with the multipliers z^(E 2^s) (5 products),
//             the 4 warps' totals by the second helper.
//   look-back decoupled, from the top (CUB's single-pass scan reversed), on
//             absolute partials: the tile publishes P = sum_(j in tile) a[j]
//             z^j (flag 1); the second helper reads the flags of the 256 tiles above it
//             at once (8 a lane), waits while one below the first inclusive
//             flag (2) is 0, and adds their P (the inclusive sum at the first
//             flag 2), going on 256 tiles further while none is inclusive;
//             no product on the way, so a deep look-back costs one L2 round
//             trip a round. The tile then publishes P plus that sum, and
//             zinv^(base + TILE) times the sum is q at the next tile's base.
//             Each value is written before its flag, the flag with
//             st.release and read with ld.acquire.
//   finish    each lane's carry (q after its chunk: the next lane's scan plus
//             z^(E (32 - lane - 1)) times the warp's incoming carry, a table
//             the first helper builds), Horner down its chunk (E products) in place, and the
//             tile out of shared memory with coalesced 16-byte stores.
// About 2 products an output (2.2-2.6 with the scan and the tables) without
// the fold, one more with it; the chains' other products (fmul) reduce each
// component once. What holds it (the phase clocks of
// scripts/torch_div_scan_probe.py's trace build, PERF.md): not the products' issue but chains of
// dependent products a block must finish in turn (Horner's E steps twice,
// the warp scan, the powers z^base of ~20 squarings) and the look-back's
// wait for the slowest tile above. Reset: the look-back's flags, the ticket and
// the count of finished blocks live in a counts buffer the wrapper keeps per
// device, zero when made; the last block of a call (by that count) writes
// back to zero what the call used, so each call, and each replay of a CUDA
// graph that captured one, starts from the same state. No memset, no value
// baked into the launch. The partials live in a values buffer beside it.
//
// Shared-memory bank map: the tile is held as 16-byte units (an Fp2 element
// one unit, Fp4 two), unit u of thread t's chunk stored at u ^ (t & 7)
// (swz below): a quarter warp's 16-byte accesses cover the 32 banks when 8
// threads read the same offset of their chunks (the chunk passes) and when
// 8 neighbouring threads touch 8 neighbouring units (the cp.async fill, the
// store); the Fp4 fill through registers writes element-wise, 2-way.
//
// pow_dot: one launch a call. A block takes DOT_TILE = 128 x 32 terms of a
// row, thread t the terms base + i 128 + t (coalesced loads of the P terms
// at once) in 4 / P chains by Horner in z^(512 / P), joined in z^128, then a
// shuffle tree with z^(2^s) over the warp and one over the 4 warps, times
// z^(start + base), which a helper warp takes by square and multiply
// meanwhile (another builds z^(2^s));
// the last block of the row (an atomic count, reset by that block) sums the
// tiles' partials in order. P = 2 reads each coefficient once for the even
// and odd halves. A thread's steps above its last term are skipped (a short
// row). What holds it (PERF.md, from the probe's builds without loads,
// without products and without Horner's steps): each block's chains of
// dependent products (the table z^(2^s), the trees, z^(start + base)) and
// the last block's sum, about half a call even over many tiles; beside
// them Goldilocks's products' issue at two blocks (8 compute warps) an SM,
// BabyBear's loads.
#include <cuda_runtime.h>

#include <cstdint>

#include "ext_field.cuh"

namespace {

constexpr int LOG_THREADS = 7;
constexpr int THREADS = 1 << LOG_THREADS;
constexpr int WARPS = THREADS / 32;            // the compute warps of a block
constexpr int BLOCK = THREADS + 64;            // and two helper warps
constexpr int LOG_DOT_E = 5;
constexpr int LOG_DOT_TILE = LOG_THREADS + LOG_DOT_E;
constexpr int64_t DOT_TILE = int64_t(1) << LOG_DOT_TILE;  // pow_dot's terms a block
constexpr int MAX_ROWS = 65535;
constexpr uint64_t AGGREGATE = 1, INCLUSIVE = 2;  // look-back flags
constexpr int LOOK = 8;                           // tiles a lane reads in a look-back round
constexpr unsigned FULL = 0xffffffffu;

// elements a thread scans: Fp2 32 (16 with the fold, whose loads through
// registers want more blocks an SM), Fp4 16: a 64 KB tile (32 KB)
template <class X, bool FOLD>
struct Geo {
  static constexpr int K = X::K;
  static constexpr int LOG_E = K == 2 && !FOLD ? 5 : 4;
  static constexpr int E = 1 << LOG_E;
  static constexpr int LOG_TILE = LOG_THREADS + LOG_E;
  static constexpr int TILE = 1 << LOG_TILE;
  static constexpr int LOG_U = K == 2 ? 0 : 1;   // 16-byte units an element: 1 or 2
  static constexpr int U = 1 << LOG_U;
  static constexpr int LOG_CHUNK = LOG_E + LOG_U;  // units a chunk (>= 3: swz stays inside)
  static constexpr int SMEM = TILE * U * 16;
};

// The plan's int64 layout (ops/div_scan.py::_plan writes the same order).
enum PlanField {
  PL_B = 0,     // rows
  PL_N,         // pow_dot's terms, div_scan's outputs (a row)
  PL_C_SB,      // c's batch and coefficient strides in u64 words
  PL_C_SJ,
  PL_Z_SB,      // z's and zinv's batch strides (0: one z for every row)
  PL_ZINV_SB,
  PL_HEAD_SB,   // head's batch stride; its H elements are contiguous
  PL_H,
  PL_CARRY_SB,
  PL_START,
  PL_NTILES,    // tiles a row, at least 1
  PL_FLAGS,     // FL_FOLD | FL_HEAD | FL_CARRY
  PL_PARTS,     // pow_dot's P (1 or 2)
  PL_LEN
};

enum Flags { FL_FOLD = 1, FL_HEAD = 2, FL_CARRY = 4 };
// how div_scan fills its tile: cp.async (contiguous 16-byte aligned rows,
// no fold; BabyBear's 32-bit words take 16-byte loads through registers
// there), 16-byte loads through registers with the fold, word loads
// through registers without or with it (any other stride)
enum Fill { ASYNC = 0, FOLD_VEC, SCALAR, FOLD_SCALAR };

template <class Word>
struct Args {
  const Word* c;
  const Word* z;
  const Word* zinv;
  const Word* alpha;
  const Word* head;
  const Word* carry;
  Word* out;
  uint64_t* counts;   // zero between calls: the last block of a call restores it
  uint64_t* values;
  int64_t B, n, c_sb, c_sj, z_sb, zinv_sb, head_sb, H, carry_sb, start, ntiles, flags;
};

// Diagnosis builds only (scripts/torch_div_scan_probe.py; ops/cuda.py's
// library defines neither macro):
//   MS_DIV_SCAN_TRACE  each block writes TRACE words to the buffer that
//                      ms_div_scan_trace() sets (div_scan's by ticket,
//                      pow_dot's by row and tile): its SM, %globaltimer at
//                      its start and end, and clock64 at its start and after
//                      each phase (div_scan: load and powers, chunks,
//                      look-back, Horner down, store; pow_dot: table, Horner
//                      and tree, the wait for z^(start + base), partial, the
//                      last block's sum). The clocks fall where ptxas
//                      schedules them, so a phase's edges are approximate.
//   MS_POW_DOT_LOOP    1: pow_dot's terms are their indices, no loads; 2:
//                      adds in place of its products; 3: no Horner steps
//                      at all. Wrong sums, for timing.
#ifndef MS_POW_DOT_LOOP
#define MS_POW_DOT_LOOP 0
#endif
#ifdef MS_DIV_SCAN_TRACE
constexpr int TRACE = 9;
__device__ uint64_t* g_trace;

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ void trace_start(int64_t slot) {
  if (threadIdx.x == 0) {
    uint32_t smid;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(smid));
    g_trace[slot * TRACE] = smid;
    g_trace[slot * TRACE + 1] = global_ns();
    g_trace[slot * TRACE + 3] = clock64();
  }
}

__device__ __forceinline__ void mark(int64_t slot, int i) {
  if (threadIdx.x == 0) g_trace[slot * TRACE + i] = clock64();
}

__device__ __forceinline__ void trace_end(int64_t slot) {
  if (threadIdx.x == 0) g_trace[slot * TRACE + 2] = global_ns();
}
#else
__device__ __forceinline__ void trace_start(int64_t) {}
__device__ __forceinline__ void mark(int64_t, int) {}
__device__ __forceinline__ void trace_end(int64_t) {}
#endif

// an element's K words, widened
template <class X, class Word>
__device__ __forceinline__ typename X::V load(const Word* p) {
  typename X::V v;
#pragma unroll
  for (int i = 0; i < X::K; ++i) v.c[i] = p[i];
  return v;
}

// an element from 16-byte aligned memory, one 16-byte load a unit: a
// Goldilocks Fp2 element one, a BabyBear Fp4 element (4 x 32 bits) one
template <class X>
__device__ __forceinline__ typename X::V load16(const uint64_t* p) {
  typename X::V v;
#pragma unroll
  for (int h = 0; h < X::K / 2; ++h) {
    const ulonglong2 u = __ldg(reinterpret_cast<const ulonglong2*>(p) + h);
    v.c[2 * h] = u.x;
    v.c[2 * h + 1] = u.y;
  }
  return v;
}

template <class X>
__device__ __forceinline__ typename X::V load16(const uint32_t* p) {
  static_assert(X::K == 4, "32-bit words: one 16-byte load an Fp4 element");
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  typename X::V v;
  v.c[0] = u.x;
  v.c[1] = u.y;
  v.c[2] = u.z;
  v.c[3] = u.w;
  return v;
}

template <class X, class Word>
__device__ __forceinline__ void store(Word* p, const typename X::V& v) {
#pragma unroll
  for (int i = 0; i < X::K; ++i) p[i] = (Word)v.c[i];
}

// bypassing L1: the look-back's and the partials' values, written by other blocks
template <class X>
__device__ __forceinline__ typename X::V load_cg(const uint64_t* p) {
  typename X::V v;
#pragma unroll
  for (int i = 0; i < X::K; ++i) v.c[i] = __ldcg(reinterpret_cast<const unsigned long long*>(p) + i);
  return v;
}

template <class X>
__device__ __forceinline__ void store_cg(uint64_t* p, const typename X::V& v) {
#pragma unroll
  for (int i = 0; i < X::K; ++i) __stcg(reinterpret_cast<unsigned long long*>(p) + i, v.c[i]);
}

__device__ __forceinline__ uint64_t ld_acquire(const uint64_t* p) {
  uint64_t v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(uint64_t* p, uint64_t v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

template <class X>
__device__ __forceinline__ typename X::V shfl_down(const typename X::V& v, int d) {
  typename X::V r;
#pragma unroll
  for (int i = 0; i < X::K; ++i)
    r.c[i] = __shfl_down_sync(FULL, (unsigned long long)v.c[i], d);
  return r;
}

// ---- products by a fixed element: the linear map a -> a z as a matrix over
// the base field, its rows summed before one reduction each (lazy). x + a z
// costs 4 base products and 2 reductions in Fp2 (X::mul: 4 products, 4
// reductions and 5 adds or subs), 16 products and 4 reductions in Fp4
// (X::mul: 14 products and their reductions, 24 adds or subs).
//
// Goldilocks: a b + c d + x < 2^129 as lo + hi 2^64 + carry 2^128, and
// 2^128 = (2^32 - 1)^2 = -2^32 (mod p), so the carry costs one subtraction.
__device__ __forceinline__ uint64_t gl_dot2(uint64_t a, uint64_t b, uint64_t c, uint64_t d,
                                            uint64_t x) {
  uint64_t lo = a * b, hi = __umul64hi(a, b);
  const uint64_t l2 = c * d, h2 = __umul64hi(c, d);
  lo += l2;
  hi += lo < l2;                   // hi < 2^64 - 2^33 + 2: no overflow
  hi += h2;
  uint64_t carry = hi < h2;
  lo += x;
  if (lo < x) {
    ++hi;
    carry += hi == 0;
  }
  const uint64_t r = gl::reduce128(lo, hi);
  return carry ? gl::sub(r, carry << 32) : r;
}

// BabyBear: four products of canonical values and one value below p sum to
// under 4 p^2 + p < 2^64; bb.cuh's Barrett step holds for any x < 2^64 (q =
// umulhi(x, floor(2^64 / p)) is floor(x / p) or one less)
__device__ __forceinline__ uint64_t bb_reduce64(uint64_t x) {
  const uint64_t q = __umul64hi(x, bb::M);
  const uint32_t r = (uint32_t)x - (uint32_t)q * bb::P32;
  return r >= bb::P32 ? r - bb::P32 : r;
}

template <class X>
struct Fixed;

// (a0 + a1 u) z = (a0 z0 + a1 7 z1) + (a0 z1 + a1 z0) u
template <>
struct Fixed<gl2> {
  uint64_t z0, z1, z7;
  __device__ __forceinline__ explicit Fixed(const gl2::V& z)
      : z0(z.c[0]), z1(z.c[1]), z7(gl::mul(z.c[1], 7)) {}
  __device__ __forceinline__ gl2::V mac(const gl2::V& a, const gl2::V& x) const {
    return gl2::V{{gl_dot2(a.c[0], z0, a.c[1], z7, x.c[0]), gl_dot2(a.c[0], z1, a.c[1], z0, x.c[1])}};
  }
};

// (A0 + A1 v)(Z0 + Z1 v) = (A0 Z0 + A1 W) + (A0 Z1 + A1 Z0) v with W = nr Z1,
// nr = -11 + u (ext_field.cuh), each Fp2 product by Y = (y0, y1) the rows
// (y0, 11 y1), (y1, y0): m[i] is output component i's row over (a00, a01,
// a10, a11)
template <>
struct Fixed<bb4> {
  uint32_t m[4][4];
  __device__ __forceinline__ explicit Fixed(const bb4::V& z) {
    const uint64_t z00 = z.c[0], z01 = z.c[1], z10 = z.c[2], z11 = z.c[3];
    const uint64_t w0 = bb::mul(11, bb::sub(z11, z10)), w1 = bb::sub(z10, bb::mul(11, z11));
    const uint64_t e01 = bb::mul(11, z01), e11 = bb::mul(11, z11), ew1 = bb::mul(11, w1);
    const uint64_t rows[4][4] = {{z00, e01, w0, ew1},
                                 {z01, z00, w1, w0},
                                 {z10, e11, z00, e01},
                                 {z11, z10, z01, z00}};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) m[i][j] = (uint32_t)rows[i][j];
  }
  __device__ __forceinline__ bb4::V mac(const bb4::V& a, const bb4::V& x) const {
    bb4::V r;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      uint64_t s = x.c[i];
#pragma unroll
      for (int j = 0; j < 4; ++j) s += (uint64_t)(uint32_t)a.c[j] * m[i][j];
      r.c[i] = bb_reduce64(s);
    }
    return r;
  }
};

// a b, each component with one reduction: Goldilocks c0 = a0 b0 + 7 a1 b1
// as three words (7 t = 8 t - t), then reduce128 and 2^128 = -2^32; c1 =
// a0 b1 + a1 b0 by gl_dot2. The products of the kernels' dependent chains
// (powers, scans, sums); BabyBear keeps ext_field.cuh's product.
template <class X>
__device__ __forceinline__ typename X::V fmul(const typename X::V& a, const typename X::V& b) {
  return X::mul(a, b);
}

template <>
__device__ __forceinline__ gl2::V fmul<gl2>(const gl2::V& a, const gl2::V& b) {
  const uint64_t l1 = a.c[1] * b.c[1], h1 = __umul64hi(a.c[1], b.c[1]);
  const uint64_t s_lo = l1 << 3, s_hi = (h1 << 3) | (l1 >> 61);
  const uint64_t br = s_lo < l1;
  uint64_t lo = s_lo - l1, hi = s_hi - h1;
  uint64_t top = (h1 >> 61) - ((s_hi < h1) | (hi < br));
  hi -= br;
  const uint64_t l0 = a.c[0] * b.c[0], h0 = __umul64hi(a.c[0], b.c[0]);
  lo += l0;
  const uint64_t c = lo < l0;
  hi += h0;
  top += hi < h0;
  hi += c;
  top += hi < c;
  return gl2::V{{gl::sub(gl::reduce128(lo, hi), top << 32),
                 gl_dot2(a.c[0], b.c[1], a.c[1], b.c[0], 0)}};
}

// x^e by square and multiply
template <class X>
__device__ typename X::V power(typename X::V x, uint64_t e) {
  typename X::V r = X::one();
  while (e) {
    if (e & 1) r = fmul<X>(r, x);
    e >>= 1;
    if (e) x = fmul<X>(x, x);
  }
  return r;
}

// v[lane] = sum_(l >= lane) v[l] m^(l - lane) over the warp, where mp[s] =
// m^(2^s): Kogge-Stone from the top; lane 0 holds the warp's whole sum
template <class X>
__device__ __forceinline__ typename X::V warp_suffix(typename X::V v, const typename X::V* mp,
                                                     int lane) {
#pragma unroll
  for (int s = 0; s < 5; ++s) {
    const typename X::V o = shfl_down<X>(v, 1 << s);
    if (lane + (1 << s) < 32) v = X::add(v, fmul<X>(mp[s], o));
  }
  return v;
}

// ------------------------------------------------------------------ div_scan
// 16-byte unit u of the tile (unit-major within thread t's chunk) at u ^ (t & 7)
template <class G>
__device__ __forceinline__ int swz(int u) {
  return u ^ ((u >> G::LOG_CHUNK) & 7);
}

template <class X, class G>
__device__ __forceinline__ typename X::V tile_get(const ulonglong2* sm, int e) {
  typename X::V v;
#pragma unroll
  for (int h = 0; h < G::U; ++h) {
    const ulonglong2 u = sm[swz<G>(e * G::U + h)];
    v.c[2 * h] = u.x;
    v.c[2 * h + 1] = u.y;
  }
  return v;
}

template <class X, class G>
__device__ __forceinline__ void tile_put(ulonglong2* sm, int e, const typename X::V& v) {
#pragma unroll
  for (int h = 0; h < G::U; ++h) sm[swz<G>(e * G::U + h)] = make_ulonglong2(v.c[2 * h], v.c[2 * h + 1]);
}

// the compute warps' barrier (the helpers go on), and theirs with the
// first helper (the second goes on)
__device__ __forceinline__ void compute_bar() {
  asm volatile("bar.sync 1, %0;" ::"n"(THREADS) : "memory");
}

__device__ __forceinline__ void table_bar() {
  asm volatile("bar.sync 2, %0;" ::"n"(THREADS + 32) : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(s), "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

// q[n - 1] of row b: carry zinv^(start + n)
template <class X, class Word>
__device__ __forceinline__ typename X::V first_value(const Args<Word>& a, int64_t b) {
  return fmul<X>(load<X>(a.carry + b * a.carry_sb),
                power<X>(load<X>(a.zinv + b * a.zinv_sb), (uint64_t)(a.start + a.n)));
}

// a[j] = c'[j + 1] of row b for j + 1 < n, read through registers
template <class X, int FILL, class Word>
__device__ __forceinline__ typename X::V coefficient(const Args<Word>& a, const Word* row,
                                                     const Fixed<X>& alpha, int64_t k) {
  if constexpr (FILL == FOLD_VEC) {
    return alpha.mac(load16<X>(row + (2 * k + 1) * X::K), load16<X>(row + 2 * k * X::K));
  } else if constexpr (FILL == ASYNC) {    // 32-bit words: contiguous rows through registers
    return load16<X>(row + k * X::K);
  } else if constexpr (FILL == FOLD_SCALAR) {
    return alpha.mac(load<X>(row + (2 * k + 1) * a.c_sj), load<X>(row + 2 * k * a.c_sj));
  } else {
    return load<X>(row + k * a.c_sj);
  }
}

// The look-back over the tiles above ``tile`` in row b (warp 0): the sum of
// their absolute partials P_u (inclusive values where published), rounds
// of 32 x LOOK tiles, lane l reading tiles u0 + 32 i + l; lane 0 returns it.
template <class X, class Word>
__device__ __forceinline__ typename X::V look_back(const Args<Word>& a, const uint64_t* flags,
                                                   const uint64_t* agg, const uint64_t* incl,
                                                   int64_t b, int64_t tile, int lane) {
  using V = typename X::V;
  V sum = X::zero();
  for (int64_t u0 = tile + 1; u0 < a.ntiles; u0 += 32 * LOOK) {
    uint64_t f[LOOK];
#pragma unroll
    for (int i = 0; i < LOOK; ++i) {
      const int64_t u = u0 + 32 * i + lane;
      f[i] = u < a.ntiles ? ld_acquire(flags + b * a.ntiles + u) : INCLUSIVE;
    }
    int first;  // the round's first inclusive tile (32 LOOK if none)
    for (;;) {
      int mine = 32 * LOOK;
#pragma unroll
      for (int i = LOOK - 1; i >= 0; --i)
        if (f[i] == INCLUSIVE) mine = 32 * i + lane;
      first = (int)__reduce_min_sync(FULL, (unsigned)mine);
      bool wait = false;
#pragma unroll
      for (int i = 0; i < LOOK; ++i) wait |= f[i] == 0 && 32 * i + lane < first;
      if (!__any_sync(FULL, wait)) break;
#pragma unroll
      for (int i = 0; i < LOOK; ++i) {
        const int64_t u = u0 + 32 * i + lane;
        if (f[i] == 0 && 32 * i + lane < first) f[i] = ld_acquire(flags + b * a.ntiles + u);
      }
    }
#pragma unroll
    for (int i = 0; i < LOOK; ++i) {
      const int pos = 32 * i + lane;
      const int64_t u = u0 + pos;
      if (pos <= first && u < a.ntiles)
        sum = X::add(sum, load_cg<X>((pos == first ? incl : agg) + (b * a.ntiles + u) * X::K));
    }
    if (first < 32 * LOOK) break;
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) sum = X::add(sum, shfl_down<X>(sum, d));
  return sum;
}

// a helper warp's table, a lane a power: zp[l] = z^(2^l) for l < nt (lanes
// in step, so lane nt - 1's squarings set the time)
template <class X>
__device__ __forceinline__ void lane_table(typename X::V* zp, int nt, const typename X::V& z,
                                           int lane) {
  const typename X::V r = power<X>(z, lane < nt ? uint64_t(1) << lane : 0);
  if (lane < nt) zp[lane] = r;
}

// blocks an SM the registers leave room for: the Fp2 fold's 512 tiles of
// 2^20 outputs in one wave (4), the other Fp2 tiles 3 (as shared memory),
// Fp4 2 (its products' registers)
template <class X, int FILL>
struct MinBlocks {
  static constexpr int value = X::K == 4 ? 2 : FILL == FOLD_VEC || FILL == FOLD_SCALAR ? 4 : 3;
};

template <class X, int FILL>
__global__ void __launch_bounds__(BLOCK, (MinBlocks<X, FILL>::value))
    div_scan_kernel(Args<word_t<X>> a) {
  using G = Geo<X, FILL == FOLD_VEC || FILL == FOLD_SCALAR>;
  using V = typename X::V;
  using Word = word_t<X>;
  // cp.async copies the tile's 64-bit words as they lie: Goldilocks only
  constexpr bool kAsync = FILL == ASYNC && sizeof(Word) == 8;
  constexpr int NT = G::LOG_E + 6;  // z^(2^s): the warp scan's z^(E 2^s), z^(32 E)
  extern __shared__ ulonglong2 sm[];
  __shared__ V zp[NT];
  __shared__ V ftab[33];           // ftab[l] = z^(E (32 - l)), ftab[32] = 1
  __shared__ V wtot[WARPS];        // each warp's chunk sums, relative to its first element
  __shared__ V xin[WARPS];         // q at the first element after each warp
  __shared__ V zbase, zinv_next, s_first;  // z^base, zinv^(base + TILE), q[n - 1]
  __shared__ int64_t s_ticket;
  __shared__ int s_last;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const bool helper = t >= THREADS;
  const int h = warp - WARPS;               // the helpers: 0 the table, 1 the powers
  const int64_t R = a.B * a.ntiles;
  uint64_t* ctl = a.counts;                  // [0] ticket, [1] finished blocks
  uint64_t* flags = a.counts + 2;            // B x ntiles
  uint64_t* agg = a.values;                  // B x ntiles x K: P_u
  uint64_t* incl = agg + R * X::K;           // B x ntiles x K: sum_(v >= u) P_v

  if (t == THREADS) s_ticket = (int64_t)atomicAdd((unsigned long long*)ctl, 1ull);
  __syncthreads();
  const int64_t ticket = s_ticket;
  trace_start(ticket);
  const int64_t b = ticket / a.ntiles;
  const int64_t tile = a.ntiles - 1 - ticket % a.ntiles;
  const int64_t base = tile * G::TILE;
  const bool top = tile == a.ntiles - 1;
  const bool carry = (a.flags & FL_CARRY) != 0;
  const bool in_head = (a.flags & FL_HEAD) != 0 && a.start + base + 1 < a.H;
  const Word* row = a.c + b * a.c_sb;
  const V z = load<X>(a.z + b * a.z_sb);

  // ---- the compute warps load the tile; the helper warp takes the powers
  if (!helper) {
    if constexpr (kAsync) {
#pragma unroll 8
      for (int it = 0; it < G::E * G::U; ++it) {
        const int u = it * THREADS + t;
        const int64_t k = base + (u >> G::LOG_U) + 1;
        const bool ok = k < a.n;
        cp_async16(&sm[swz<G>(u)], ok ? row + k * X::K + 2 * (u & (G::U - 1)) : row, ok ? 16 : 0);
      }
      cp_async_commit();
      cp_async_wait();
    } else {
      const Fixed<X> alpha(FILL == FOLD_VEC || FILL == FOLD_SCALAR ? load<X>(a.alpha) : X::zero());
      constexpr int BATCH = 8;
#pragma unroll 1
      for (int i0 = 0; i0 < G::E; i0 += BATCH) {
        V v[BATCH];
#pragma unroll
        for (int i = 0; i < BATCH; ++i) {
          const int64_t k = base + (i0 + i) * THREADS + t + 1;
          v[i] = k < a.n ? coefficient<X, FILL>(a, row, alpha, k) : X::zero();
        }
#pragma unroll
        for (int i = 0; i < BATCH; ++i) tile_put<X, G>(sm, (i0 + i) * THREADS + t, v[i]);
      }
    }
    compute_bar();
    // the head over the coefficients c'[k] at start + k < H
    if (in_head) {
      for (int e = t; e < G::TILE; e += THREADS) {
        const int64_t k = base + e + 1, g = a.start + k;
        if (g >= a.H || k >= a.n) break;
        tile_put<X, G>(sm, e, X::sub(tile_get<X, G>(sm, e), load<X>(a.head + b * a.head_sb + g * X::K)));
      }
    }
  } else if (h == 0) {
    lane_table<X>(zp, NT, z, lane);
  } else {
    // z^base and zinv^(base + TILE), two lanes in step
    const V r = power<X>(lane == 1 ? load<X>(a.zinv + b * a.zinv_sb) : z,
                         lane == 0 ? base : lane == 1 ? base + G::TILE : 0);
    if (lane == 0) zbase = r;
    if (lane == 1) zinv_next = r;
    if (top && carry && lane == 0) s_first = first_value<X>(a, b);
  }
  if (top && carry) {               // a[n - 1], from the helper
    __syncthreads();
    if (t == 0) tile_put<X, G>(sm, (int)(a.n - 1 - base), s_first);
  }
  if (!helper && (in_head || (top && carry))) compute_bar();

  mark(ticket, 4);
  // ---- chunks: Horner in z, then (the first helper's table there) the
  // warp's suffix scan in z^E
  const int e0 = t * G::E;
  const Fixed<X> zf(z);
  V w = X::zero();
  if (!helper) {
    w = tile_get<X, G>(sm, e0 + G::E - 1);
#pragma unroll 4
    for (int i = G::E - 2; i >= 0; --i) w = zf.mac(w, tile_get<X, G>(sm, e0 + i));
  }
  if (h <= 0) table_bar();
  V s = X::zero();
  if (!helper) {
    s = warp_suffix<X>(w, zp + G::LOG_E, lane);
    if (lane == 0) wtot[warp] = s;
  } else if (h == 0) {
    // ftab[l] = Z^(32 - l), Z = z^E: the product over lanes l..31 of Z
    V f = zp[G::LOG_E];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const V o = shfl_down<X>(f, d);
      if (lane + d < 32) f = fmul<X>(f, o);
    }
    ftab[lane] = f;
    if (lane == 0) ftab[32] = X::one();
  }
  __syncthreads();

  mark(ticket, 5);
  // ---- the tile's absolute partial, the look-back, the inclusive sum (the
  // second helper)
  if (h == 1) {
    const V zw = zp[G::LOG_E + 5];          // z^(32 E): one warp's span
    const int64_t slot = b * a.ntiles + tile;
    V P = wtot[WARPS - 1];
    if (lane == 0) {
#pragma unroll
      for (int v = WARPS - 2; v >= 0; --v) P = X::add(wtot[v], fmul<X>(zw, P));
      P = fmul<X>(P, zbase);                 // sum over the tile of a[j] z^j
      if (!top) {
        store_cg<X>(agg + slot * X::K, P);
        __threadfence();
        st_release(flags + slot, AGGREGATE);
      }
    }
    const V above = top ? X::zero() : look_back<X>(a, flags, agg, incl, b, tile, lane);
    if (lane == 0) {
      store_cg<X>(incl + slot * X::K, X::add(P, above));
      __threadfence();
      st_release(flags + slot, INCLUSIVE);
      // q at the next tile's base, then at the first element after each warp
      V x = fmul<X>(above, zinv_next);
      xin[WARPS - 1] = x;
#pragma unroll
      for (int v = WARPS - 2; v >= 0; --v) {
        x = X::add(wtot[v + 1], fmul<X>(zw, x));
        xin[v] = x;
      }
      __threadfence();
      s_last = atomicAdd((unsigned long long*)(ctl + 1), 1ull) == (unsigned long long)(R - 1);
    }
  }
  __syncthreads();

  mark(ticket, 6);
  // ---- each lane's carry, Horner down its chunk in place, the tile out
  if (!helper) {
    const V next = shfl_down<X>(s, 1);
    V q = lane == 31 ? xin[warp] : X::add(next, fmul<X>(ftab[lane + 1], xin[warp]));
#pragma unroll 4
    for (int i = G::E - 1; i >= 0; --i) {
      q = zf.mac(q, tile_get<X, G>(sm, e0 + i));
      tile_put<X, G>(sm, e0 + i, q);
    }
    compute_bar();
    mark(ticket, 7);
    Word* orow = a.out + b * a.n * X::K;
#pragma unroll 8
    for (int it = 0; it < G::E * G::U; ++it) {
      const int u = it * THREADS + t;
      const int64_t j = base + (u >> G::LOG_U);
      if (j < a.n) {
        if constexpr (sizeof(Word) == 8) {
          reinterpret_cast<ulonglong2*>(orow + j * X::K)[u & (G::U - 1)] = sm[swz<G>(u)];
        } else {                   // a unit's two components, narrowed: 8 bytes
          const ulonglong2 w2 = sm[swz<G>(u)];
          reinterpret_cast<uint2*>(orow + j * X::K)[u & (G::U - 1)] =
              make_uint2((uint32_t)w2.x, (uint32_t)w2.y);
        }
      }
    }
    mark(ticket, 8);
    trace_end(ticket);
  }
  // the last block of the call: every look-back is over; the counts back to zero
  if (s_last) {
    __threadfence();
    for (int64_t i = t; i < R; i += BLOCK) flags[i] = 0;
    if (t == 0) ctl[0] = ctl[1] = 0;
  }
}

// ------------------------------------------------------------------ pow_dot
template <class X, int P, bool VEC>
__global__ void __launch_bounds__(BLOCK) pow_dot_kernel(Args<word_t<X>> a) {
  using V = typename X::V;
  constexpr int NT = LOG_THREADS + 3;
  __shared__ V zp[NT];                // z^(2^s)
  __shared__ V zs;                    // z^(start + base)
  __shared__ V wtot[P][WARPS];
  __shared__ int s_last;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const bool helper = t >= THREADS;
  const int h = warp - WARPS;                 // the helpers: 0 the table, 1 z^(start + base)
  const int64_t b = blockIdx.y, tile = blockIdx.x, base = tile * DOT_TILE;
  const word_t<X>* row = a.c + b * a.c_sb;
  uint64_t* done = a.counts;                  // B counters
  uint64_t* part = a.values;                  // B x ntiles x P x K
  const int64_t slot = b * a.ntiles + tile;
  trace_start(slot);
  const V z = load<X>(a.z + b * a.z_sb);
  if (h == 0) lane_table<X>(zp, NT, z, lane);
  if (h == 1 && lane == 0) zs = power<X>(z, (uint64_t)(a.start + base));
  if (h <= 0) table_bar();
  mark(slot, 4);

  V w[P];
  if (!helper) {
    // ACC chains a part (4 a thread): chain r takes i = r mod ACC by Horner
    // in z^(ACC THREADS), then the chains join by Horner in z^THREADS; the
    // steps of ACC above the last that holds a term (they add zeros) skipped
    constexpr int ACC = 4 / P;
    const int64_t held = ((a.n + P - 1) / P - base + THREADS - 1) / THREADS;
    const V zt = zp[LOG_THREADS];
    const Fixed<X> zf(zp[LOG_THREADS + (ACC == 4 ? 2 : 1)]);   // z^(ACC THREADS)
    V acc[P][ACC];
#pragma unroll
    for (int p = 0; p < P; ++p)
#pragma unroll
      for (int r = 0; r < ACC; ++r) acc[p][r] = X::zero();
#pragma unroll 2
    for (int i0 = (1 << LOG_DOT_E) - ACC; i0 >= 0; i0 -= ACC) {
      if (i0 >= held || MS_POW_DOT_LOOP == 3) continue;
#pragma unroll
      for (int r = 0; r < ACC; ++r) {
        const int64_t j = base + (int64_t)(i0 + r) * THREADS + t;
#pragma unroll
        for (int p = 0; p < P; ++p) {
          const int64_t k = P * j + p;
          V v = X::zero();
          if (k < a.n) {
            if constexpr (MS_POW_DOT_LOOP == 1) v.c[0] = (uint64_t)k;
            else v = VEC ? load16<X>(row + k * X::K) : load<X>(row + k * a.c_sj);
          }
          acc[p][r] = MS_POW_DOT_LOOP == 2 ? X::add(acc[p][r], v) : zf.mac(acc[p][r], v);
        }
      }
    }
#pragma unroll
    for (int p = 0; p < P; ++p) {
      w[p] = acc[p][ACC - 1];
#pragma unroll
      for (int r = ACC - 2; r >= 0; --r) w[p] = X::add(acc[p][r], fmul<X>(zt, w[p]));
      w[p] = warp_suffix<X>(w[p], zp, lane);
      if (lane == 0) wtot[p][warp] = w[p];
    }
    mark(slot, 5);
  }
  __syncthreads();
  mark(slot, 6);
  if (t == 0) {
#pragma unroll
    for (int p = 0; p < P; ++p) {
      V s = wtot[p][WARPS - 1];
#pragma unroll
      for (int v = WARPS - 2; v >= 0; --v) s = X::add(wtot[p][v], fmul<X>(zp[5], s));
      store_cg<X>(part + (slot * P + p) * X::K, fmul<X>(s, zs));
    }
    __threadfence();
    s_last = atomicAdd((unsigned long long*)(done + b), 1ull) == (unsigned long long)(a.ntiles - 1);
  }
  __syncthreads();
  mark(slot, 7);
  if (!s_last || helper) {
    mark(slot, 8);
    trace_end(slot);
    return;
  }
  // the last block of row b: the tiles' partials in order
  __threadfence();
#pragma unroll
  for (int p = 0; p < P; ++p) {
    V s = X::zero();
    for (int64_t u = t; u < a.ntiles; u += THREADS)
      s = X::add(s, load_cg<X>(part + ((b * a.ntiles + u) * P + p) * X::K));
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) s = X::add(s, shfl_down<X>(s, d));
    if (lane == 0) wtot[p][warp] = s;
  }
  compute_bar();
  if (t == 0) {
#pragma unroll
    for (int p = 0; p < P; ++p) {
      V s = wtot[p][0];
#pragma unroll
      for (int v = 1; v < WARPS; ++v) s = X::add(s, wtot[p][v]);
      store<X>(a.out + (b * P + p) * X::K, s);
    }
    done[b] = 0;
  }
  mark(slot, 8);
  trace_end(slot);
}

// ------------------------------------------------------------------ host
template <class Word>
bool read_plan(const int64_t* plan, Args<Word>& a) {
  a.B = plan[PL_B];
  a.n = plan[PL_N];
  a.c_sb = plan[PL_C_SB];
  a.c_sj = plan[PL_C_SJ];
  a.z_sb = plan[PL_Z_SB];
  a.zinv_sb = plan[PL_ZINV_SB];
  a.head_sb = plan[PL_HEAD_SB];
  a.H = plan[PL_H];
  a.carry_sb = plan[PL_CARRY_SB];
  a.start = plan[PL_START];
  a.ntiles = plan[PL_NTILES];
  a.flags = plan[PL_FLAGS];
  return a.B >= 1 && a.B <= MAX_ROWS && a.n >= 0 && a.start >= 0 && a.ntiles >= 1 &&
         a.B * a.ntiles <= INT32_MAX;
}

// p 16-byte aligned and a row stride of a multiple of 16 bytes
template <class Word>
bool aligned16(const Word* p, int64_t words) {
  return ((uintptr_t)p % 16) == 0 && (words * (int64_t)sizeof(Word)) % 16 == 0;
}

template <class X, int FILL>
int launch_div(const Args<word_t<X>>& a, cudaStream_t s) {
  constexpr int smem = Geo<X, FILL == FOLD_VEC || FILL == FOLD_SCALAR>::SMEM;
  // the whole tile, and as much shared memory as the SM has: three tiles an SM
  cudaError_t err = cudaFuncSetAttribute(
      div_scan_kernel<X, FILL>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(div_scan_kernel<X, FILL>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  div_scan_kernel<X, FILL><<<(unsigned)(a.B * a.ntiles), BLOCK, smem, s>>>(a);
  return (int)cudaGetLastError();
}

template <class X, class Word = word_t<X>>
int div_scan(const Word* c, const Word* z, const Word* zinv, const Word* alpha,
             const Word* head, const Word* carry, Word* out, uint64_t* counts,
             uint64_t* values, const int64_t* plan, void* stream) {
  Args<Word> a{};
  const int64_t flags = plan[PL_FLAGS];
  const int64_t tile = flags & FL_FOLD ? Geo<X, true>::TILE : Geo<X, false>::TILE;
  const int64_t tiles = (plan[PL_N] + tile - 1) / tile;
  if (!read_plan(plan, a) || a.n < 1 || a.ntiles != tiles || (flags & ~int64_t(7)) != 0 ||
      ((flags & FL_FOLD) && !alpha) || ((flags & FL_HEAD) && !head) ||
      (flags & FL_CARRY && !carry) || !zinv || !counts || !values)
    return (int)cudaErrorInvalidValue;
  a.c = c;
  a.z = z;
  a.zinv = zinv;
  a.alpha = alpha;
  a.head = head;
  a.carry = carry;
  a.out = out;
  a.counts = counts;
  a.values = values;
  cudaStream_t s = (cudaStream_t)stream;
  // 16-byte units: an element's K words at a 16-byte boundary in every row
  const bool vec = aligned16(c, a.c_sb) && a.c_sj == X::K;
  if (flags & FL_FOLD) return vec ? launch_div<X, FOLD_VEC>(a, s) : launch_div<X, FOLD_SCALAR>(a, s);
  return vec ? launch_div<X, ASYNC>(a, s) : launch_div<X, SCALAR>(a, s);
}

template <class X, class Word = word_t<X>>
int pow_dot(const Word* c, const Word* z, Word* out, uint64_t* counts,
            uint64_t* values, const int64_t* plan, void* stream) {
  Args<Word> a{};
  const int64_t P = plan[PL_PARTS];
  const int64_t terms = P >= 1 ? (plan[PL_N] + P - 1) / P : 0;
  const int64_t tiles = terms > 0 ? (terms + DOT_TILE - 1) / DOT_TILE : 1;
  if (!read_plan(plan, a) || a.flags != 0 || (P != 1 && P != 2) || a.ntiles != tiles ||
      !counts || !values)
    return (int)cudaErrorInvalidValue;
  a.c = c;
  a.z = z;
  a.out = out;
  a.counts = counts;
  a.values = values;
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid((unsigned)a.ntiles, (unsigned)a.B);
  const bool vec = aligned16(c, a.c_sb) && a.c_sj == X::K;
  if (P == 1) {
    if (vec) pow_dot_kernel<X, 1, true><<<grid, BLOCK, 0, s>>>(a);
    else pow_dot_kernel<X, 1, false><<<grid, BLOCK, 0, s>>>(a);
  } else {
    if (vec) pow_dot_kernel<X, 2, true><<<grid, BLOCK, 0, s>>>(a);
    else pow_dot_kernel<X, 2, false><<<grid, BLOCK, 0, s>>>(a);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// c: element 0 of row 0 (the offset of a strided view included); z: row 0's
// z; out: (B, P, K) contiguous; counts: B words, zero (each call's last
// blocks restore them); values: B ntiles P K words; plan: PL_LEN host int64
// values (above), flags 0, parts P.
extern "C" int ms_pow_dot_gl2(const uint64_t* c, const uint64_t* z, uint64_t* out,
                              uint64_t* counts, uint64_t* values, const int64_t* plan,
                              void* stream) {
  return pow_dot<gl2>(c, z, out, counts, values, plan, stream);
}

// the same over BabyBear Fp4's 32-bit words (c, z, out; the scratch stays
// 64-bit)
extern "C" int ms_pow_dot_bb4(const uint32_t* c, const uint32_t* z, uint32_t* out,
                              uint64_t* counts, uint64_t* values, const int64_t* plan,
                              void* stream) {
  return pow_dot<bb4>(c, z, out, counts, values, plan, stream);
}

// c, z, zinv, alpha (one element, with FL_FOLD), head (with FL_HEAD), carry
// (with FL_CARRY): row 0's first element each; out: (B, n, K) contiguous;
// counts: 2 + B ntiles words, zero (the call's last block restores them);
// values: 2 B ntiles K words.
extern "C" int ms_div_scan_gl2(const uint64_t* c, const uint64_t* z, const uint64_t* zinv,
                               const uint64_t* alpha, const uint64_t* head,
                               const uint64_t* carry, uint64_t* out, uint64_t* counts,
                               uint64_t* values, const int64_t* plan, void* stream) {
  return div_scan<gl2>(c, z, zinv, alpha, head, carry, out, counts, values, plan, stream);
}

// the same over BabyBear Fp4's 32-bit words (every element operand and out;
// the scratch stays 64-bit)
extern "C" int ms_div_scan_bb4(const uint32_t* c, const uint32_t* z, const uint32_t* zinv,
                               const uint32_t* alpha, const uint32_t* head,
                               const uint32_t* carry, uint32_t* out, uint64_t* counts,
                               uint64_t* values, const int64_t* plan, void* stream) {
  return div_scan<bb4>(c, z, zinv, alpha, head, carry, out, counts, values, plan, stream);
}

#ifdef MS_DIV_SCAN_TRACE
// buf: TRACE words for each block of the calls that follow (MS_DIV_SCAN_TRACE above)
extern "C" int ms_div_scan_trace(uint64_t* buf) {
  return (int)cudaMemcpyToSymbol(g_trace, &buf, sizeof(buf));
}
#endif
