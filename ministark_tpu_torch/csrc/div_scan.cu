// Division by (x - z) and sums weighted by powers of z over Goldilocks Fp2
// and BabyBear Fp4 (ext_field.cuh), for B rows at once, each with its own z:
//
//   ms_pow_dot_*   S[b] = sum_(j < n) c[b, j] z[b]^(start + j)
//   ms_div_scan_*  q[b, g] = zinv^(start + g + 1)
//                            (carry[b] + sum_(g < j < n) c'[b, j] z^(start + j))
//
// with c'[b, j] = c[b, j], or c[b, 2j] + alpha c[b, 2j + 1] (the fold), minus
// head[b, start + j] where start + j < H. The rows are read in place through
// a batch stride (0: one polynomial for every row) and a coefficient stride,
// both in u64 words; q is a contiguous (B, n, K) tensor.
//
// Replaces no Pallas kernel: the JAX package leaves this division to XLA
// (ministark_tpu/ops/planar.py::synth_div_planes :391 and fold_div_planes
// :419, the blocked local-power form of poly_device.py::synth_div_suffix,
// one fusion a FRI round). The port ran the closed form in torch ops, two
// power ladders and a Hillis-Steele suffix sum: O(n log n) work in ~1,400
// launches for one division at 2^20 (ROADMAP X3; X1 for the fold).
//
// The scan is Horner's recurrence read from the top, q[g - 1] = c'[g] +
// z q[g], with q[n - 1] = carry zinv^(start + n): an affine suffix scan with
// the one multiplier z, so it needs neither z^start nor z^-1 outside that
// first value (taken by square and multiply in the kernel). With
// a[j] = c'[j + 1] (j < n - 1) and a[n - 1] = q[n - 1], q[g] = sum_(j >= g)
// a[j] z^(j - g). A block scans TILE = THREADS x E elements, each thread E
// neighbours; three launches:
//   tile_totals   each tile's sum_j a[j] z^(j - tile base) (Horner in a
//                 thread, then a tree over the threads with z^(E 2^s));
//   tile_carries  one block a row scans the tiles' totals from the top with
//                 z^TILE into each tile's incoming carry (q at the next
//                 tile's base);
//   scan_finish   each tile again: the threads' chunk sums, an inclusive
//                 suffix scan over them seeded with the tile's carry, and
//                 Horner down each chunk from the carry above it.
// A row of one tile skips the first two. pow_dot is tile_totals and one
// block a row (dot_finish) that sums the tiles with z^TILE and multiplies
// by z^start. Field arithmetic is exact, so the order of the sums changes
// no output bit.
//
// Bound on the H100: the integer operations of the products (one Fp2 or
// Fp4 product per output for Horner, one more for the fold) against 16 or
// 32 bytes read and written per element. This first form reads each
// element twice in scan_finish and three times in all, and spends a
// product per element on each of the three passes' sums; it keeps no tile
// in shared memory (later work: PERF.md).
#include <cuda_runtime.h>

#include <cstdint>

#include "ext_field.cuh"

namespace {

constexpr int LOG_THREADS = 7;
constexpr int THREADS = 1 << LOG_THREADS;
constexpr int LOG_E = 4;
constexpr int E = 1 << LOG_E;                  // neighbouring elements a thread scans
constexpr int LOG_TILE = LOG_THREADS + LOG_E;
constexpr int64_t TILE = int64_t(1) << LOG_TILE;  // elements a block scans (2048)
constexpr int MAX_ROWS = 65535;                // gridDim.y

// The plan's int64 layout (ops/div_scan.py::_plan writes the same order).
enum PlanField {
  PL_B = 0,     // rows
  PL_N,         // elements a row scans: pow_dot's terms, div_scan's outputs
  PL_C_SB,      // c's batch and coefficient strides in u64 words
  PL_C_SJ,
  PL_Z_SB,      // z's and zinv's batch strides (0: one z for every row)
  PL_ZINV_SB,
  PL_HEAD_SB,   // head's batch stride; its H elements are contiguous
  PL_H,
  PL_CARRY_SB,
  PL_START,
  PL_NTILES,    // ceil(n / TILE), at least 1
  PL_FLAGS,     // FL_FOLD | FL_HEAD | FL_CARRY
  PL_LEN
};

enum Flags { FL_FOLD = 1, FL_HEAD = 2, FL_CARRY = 4, DIV = 8 };

struct Args {
  const uint64_t* c;
  const uint64_t* z;
  const uint64_t* zinv;
  const uint64_t* alpha;
  const uint64_t* head;
  const uint64_t* carry;
  uint64_t* out;
  uint64_t* tot;  // (B, ntiles, K): each tile's total
  uint64_t* cin;  // (B, ntiles, K): each tile's incoming carry
  int64_t n, c_sb, c_sj, z_sb, zinv_sb, head_sb, H, carry_sb, start, ntiles;
};

template <class X>
__device__ __forceinline__ typename X::V load(const uint64_t* p) {
  typename X::V v;
#pragma unroll
  for (int i = 0; i < X::K; ++i) v.c[i] = p[i];
  return v;
}

template <class X>
__device__ __forceinline__ void store(uint64_t* p, const typename X::V& v) {
#pragma unroll
  for (int i = 0; i < X::K; ++i) p[i] = v.c[i];
}

// x^e by square and multiply
template <class X>
__device__ typename X::V power(typename X::V x, uint64_t e) {
  typename X::V r = X::one();
  while (e) {
    if (e & 1) r = X::mul(r, x);
    e >>= 1;
    if (e) x = X::mul(x, x);
  }
  return r;
}

// a[j] of row b: pow_dot's term c[b, j]; div_scan's c'[b, j + 1], and at
// j = n - 1 the first value q[n - 1] (``init``, zero without a carry)
template <class X, int FL>
__device__ __forceinline__ typename X::V elem(const Args& a, int64_t b, const uint64_t* row,
                                              const typename X::V& alpha,
                                              const typename X::V& init, int64_t j) {
  using V = typename X::V;
  if (j >= a.n) return X::zero();
  if constexpr ((FL & DIV) == 0) {
    return load<X>(row + j * a.c_sj);
  } else {
    if (j == a.n - 1) return init;
    const int64_t k = j + 1;
    V v;
    if constexpr ((FL & FL_FOLD) != 0) {
      v = X::add(load<X>(row + 2 * k * a.c_sj),
                 X::mul(alpha, load<X>(row + (2 * k + 1) * a.c_sj)));
    } else {
      v = load<X>(row + k * a.c_sj);
    }
    if constexpr ((FL & FL_HEAD) != 0) {
      const int64_t g = a.start + k;
      if (g < a.H) v = X::sub(v, load<X>(a.head + b * a.head_sb + g * X::K));
    }
    return v;
  }
}

// sum_(i < E) a[base + i] z^i, Horner from the top
template <class X, int FL>
__device__ __forceinline__ typename X::V chunk_sum(const Args& a, int64_t b, const uint64_t* row,
                                                   const typename X::V& alpha,
                                                   const typename X::V& init,
                                                   const typename X::V& z, int64_t base) {
  typename X::V w = elem<X, FL>(a, b, row, alpha, init, base + E - 1);
#pragma unroll 4
  for (int i = E - 2; i >= 0; --i) w = X::add(X::mul(w, z), elem<X, FL>(a, b, row, alpha, init, base + i));
  return w;
}

// The per-block setup of tile_totals and scan_finish: z, alpha, the row,
// this thread's first element, q[n - 1] where the thread holds it, and
// zp[s] = z^(E 2^s) (s <= LOG_THREADS) in shared memory.
template <class X, int FL>
struct Tile {
  using V = typename X::V;
  int64_t b, base;
  const uint64_t* row;
  V z, alpha, init;

  __device__ __forceinline__ Tile(const Args& a, V* zp) {
    b = blockIdx.y;
    base = (int64_t)blockIdx.x * TILE + (int64_t)threadIdx.x * E;
    row = a.c + b * a.c_sb;
    z = load<X>(a.z + b * a.z_sb);
    alpha = X::zero();
    if constexpr ((FL & FL_FOLD) != 0) alpha = load<X>(a.alpha);
    init = X::zero();
    if constexpr ((FL & FL_CARRY) != 0) {
      if (base <= a.n - 1 && a.n - 1 < base + E)
        init = X::mul(load<X>(a.carry + b * a.carry_sb),
                      power<X>(load<X>(a.zinv + b * a.zinv_sb), (uint64_t)(a.start + a.n)));
    }
    if (threadIdx.x == 0) {
      V x = z;
      for (int s = 0; s < LOG_E; ++s) x = X::mul(x, x);
      for (int s = 0; s <= LOG_THREADS; ++s) {
        zp[s] = x;
        x = X::mul(x, x);
      }
    }
    __syncthreads();
  }
};

// sm[t] = sum_(u >= t) sm[u] m^(u - t) over the block, where zp[s] = m^(2^s)
template <class X>
__device__ __forceinline__ void suffix_scan(typename X::V* sm, const typename X::V* zp) {
  const int t = threadIdx.x;
#pragma unroll 1
  for (int s = 0; s < LOG_THREADS; ++s) {
    const int d = 1 << s;
    const typename X::V other = t + d < THREADS ? sm[t + d] : X::zero();
    __syncthreads();
    if (t + d < THREADS) sm[t] = X::add(sm[t], X::mul(zp[s], other));
    __syncthreads();
  }
}

// sm[0] = sum_t sm[t] m^t over the block, where zp[s] = m^(2^s)
template <class X>
__device__ __forceinline__ void tree_sum(typename X::V* sm, const typename X::V* zp) {
  const int t = threadIdx.x;
#pragma unroll 1
  for (int s = 0; s < LOG_THREADS; ++s) {
    const int d = 1 << s;
    if ((t & (2 * d - 1)) == 0) sm[t] = X::add(sm[t], X::mul(zp[s], sm[t + d]));
    __syncthreads();
  }
}

template <class X, int FL>
__global__ void __launch_bounds__(THREADS) tile_totals(Args a) {
  using V = typename X::V;
  __shared__ V zp[LOG_THREADS + 1];
  __shared__ V sm[THREADS];
  const Tile<X, FL> tl(a, zp);
  sm[threadIdx.x] = chunk_sum<X, FL>(a, tl.b, tl.row, tl.alpha, tl.init, tl.z, tl.base);
  __syncthreads();
  tree_sum<X>(sm, zp);
  if (threadIdx.x == 0) store<X>(a.tot + (tl.b * a.ntiles + blockIdx.x) * X::K, sm[0]);
}

// The tiles' totals of row b from the top: thread t walks the G tiles
// [t G, t G + G) with Horner in z^TILE; its group's sum (relative to the
// group's base) joins the others in a suffix scan with z^(TILE G 2^s).
// With ``carries`` each thread then writes its tiles' incoming carries,
// else thread 0 writes z^start times the row's whole sum.
template <class X>
__device__ __forceinline__ void tiles_from_top(const Args& a, bool carries) {
  using V = typename X::V;
  __shared__ V zp[LOG_THREADS];
  __shared__ V sm[THREADS];
  __shared__ V zt_s;
  const int t = threadIdx.x;
  const int64_t b = blockIdx.x;
  const int64_t G = (a.ntiles + THREADS - 1) / THREADS;
  const V z = load<X>(a.z + b * a.z_sb);
  if (t == 0) {
    V zt = z;
    for (int s = 0; s < LOG_TILE; ++s) zt = X::mul(zt, zt);
    zt_s = zt;
    V x = power<X>(zt, (uint64_t)G);
    for (int s = 0; s < LOG_THREADS; ++s) {
      zp[s] = x;
      x = X::mul(x, x);
    }
  }
  __syncthreads();
  const V zt = zt_s;
  const int64_t lo = t * G;
  const int64_t hi = lo + G < a.ntiles ? lo + G : a.ntiles;
  const uint64_t* tot = a.tot + b * a.ntiles * X::K;
  V g = X::zero();
  for (int64_t u = hi - 1; u >= lo; --u) g = X::add(X::mul(g, zt), load<X>(tot + u * X::K));
  sm[t] = g;
  __syncthreads();
  if (carries) {
    suffix_scan<X>(sm, zp);
    V c = t + 1 < THREADS ? sm[t + 1] : X::zero();
    for (int64_t u = hi - 1; u >= lo; --u) {
      store<X>(a.cin + (b * a.ntiles + u) * X::K, c);
      c = X::add(load<X>(tot + u * X::K), X::mul(zt, c));
    }
  } else {
    tree_sum<X>(sm, zp);
    if (t == 0) store<X>(a.out + b * X::K, X::mul(sm[0], power<X>(z, (uint64_t)a.start)));
  }
}

template <class X>
__global__ void __launch_bounds__(THREADS) tile_carries(Args a) {
  tiles_from_top<X>(a, true);
}

template <class X>
__global__ void __launch_bounds__(THREADS) dot_finish(Args a) {
  tiles_from_top<X>(a, false);
}

template <class X, int FL>
__global__ void __launch_bounds__(THREADS) scan_finish(Args a) {
  using V = typename X::V;
  __shared__ V zp[LOG_THREADS + 1];
  __shared__ V sm[THREADS];
  const Tile<X, FL> tl(a, zp);
  const int t = threadIdx.x;
  const V cin = blockIdx.x + 1 < a.ntiles
                    ? load<X>(a.cin + (tl.b * a.ntiles + blockIdx.x) * X::K)
                    : X::zero();
  V w = chunk_sum<X, FL>(a, tl.b, tl.row, tl.alpha, tl.init, tl.z, tl.base);
  if (t == THREADS - 1) w = X::add(w, X::mul(zp[0], cin));
  sm[t] = w;
  __syncthreads();
  suffix_scan<X>(sm, zp);
  V q = t + 1 < THREADS ? sm[t + 1] : cin;  // q at the next chunk's first element
  uint64_t* out = a.out + tl.b * a.n * X::K;
#pragma unroll 4
  for (int i = E - 1; i >= 0; --i) {
    const int64_t j = tl.base + i;
    q = X::add(elem<X, FL>(a, tl.b, tl.row, tl.alpha, tl.init, j), X::mul(tl.z, q));
    if (j < a.n) store<X>(out + j * X::K, q);
  }
}

bool read_plan(const int64_t* plan, Args& a) {
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
  const int64_t B = plan[PL_B];
  const int64_t want = a.n > 0 ? (a.n + TILE - 1) / TILE : 1;
  return B >= 1 && B <= MAX_ROWS && a.n >= 0 && a.start >= 0 && a.ntiles == want &&
         a.ntiles <= INT32_MAX;
}

template <class X>
int pow_dot(const uint64_t* c, const uint64_t* z, uint64_t* out, uint64_t* tot,
            const int64_t* plan, void* stream) {
  Args a{};
  if (!read_plan(plan, a) || plan[PL_FLAGS] != 0) return (int)cudaErrorInvalidValue;
  a.c = c;
  a.z = z;
  a.out = out;
  a.tot = tot;
  cudaStream_t s = (cudaStream_t)stream;
  const unsigned B = (unsigned)plan[PL_B];
  tile_totals<X, 0><<<dim3((unsigned)a.ntiles, B), THREADS, 0, s>>>(a);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dot_finish<X><<<B, THREADS, 0, s>>>(a);
  return (int)cudaGetLastError();
}

template <class X, int FL>
int run_div(const Args& a, unsigned B, cudaStream_t s) {
  const dim3 grid((unsigned)a.ntiles, B);
  if (a.ntiles > 1) {
    tile_totals<X, FL | DIV><<<grid, THREADS, 0, s>>>(a);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    tile_carries<X><<<B, THREADS, 0, s>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  scan_finish<X, FL | DIV><<<grid, THREADS, 0, s>>>(a);
  return (int)cudaGetLastError();
}

template <class X>
int div_scan(const uint64_t* c, const uint64_t* z, const uint64_t* zinv, const uint64_t* alpha,
             const uint64_t* head, const uint64_t* carry, uint64_t* out, uint64_t* tot,
             uint64_t* cin, const int64_t* plan, void* stream) {
  Args a{};
  const int64_t flags = plan[PL_FLAGS];
  if (!read_plan(plan, a) || a.n < 1 || (flags & ~int64_t(7)) != 0 ||
      ((flags & FL_FOLD) && !alpha) || ((flags & FL_HEAD) && !head) ||
      ((flags & FL_CARRY) && (!carry || !zinv)) || (a.ntiles > 1 && (!tot || !cin)))
    return (int)cudaErrorInvalidValue;
  a.c = c;
  a.z = z;
  a.zinv = zinv;
  a.alpha = alpha;
  a.head = head;
  a.carry = carry;
  a.out = out;
  a.tot = tot;
  a.cin = cin;
  cudaStream_t s = (cudaStream_t)stream;
  const unsigned B = (unsigned)plan[PL_B];
  switch (flags) {
    case 0: return run_div<X, 0>(a, B, s);
    case 1: return run_div<X, 1>(a, B, s);
    case 2: return run_div<X, 2>(a, B, s);
    case 3: return run_div<X, 3>(a, B, s);
    case 4: return run_div<X, 4>(a, B, s);
    case 5: return run_div<X, 5>(a, B, s);
    case 6: return run_div<X, 6>(a, B, s);
    default: return run_div<X, 7>(a, B, s);
  }
}

}  // namespace

// c: element 0 of row 0 (the offset of a strided view included); z: row 0's
// z; out: (B, K) contiguous; tot: (B, ntiles, K) scratch; plan: PL_LEN host
// int64 values (above), flags 0.
extern "C" int ms_pow_dot_gl2(const uint64_t* c, const uint64_t* z, uint64_t* out,
                              uint64_t* tot, const int64_t* plan, void* stream) {
  return pow_dot<gl2>(c, z, out, tot, plan, stream);
}

extern "C" int ms_pow_dot_bb4(const uint64_t* c, const uint64_t* z, uint64_t* out,
                              uint64_t* tot, const int64_t* plan, void* stream) {
  return pow_dot<bb4>(c, z, out, tot, plan, stream);
}

// c, z, zinv (with FL_CARRY), alpha (one element, with FL_FOLD), head (with
// FL_HEAD), carry (with FL_CARRY): row 0's first element each; out: (B, n,
// K) contiguous; tot, cin: (B, ntiles, K) scratch where ntiles > 1.
extern "C" int ms_div_scan_gl2(const uint64_t* c, const uint64_t* z, const uint64_t* zinv,
                               const uint64_t* alpha, const uint64_t* head,
                               const uint64_t* carry, uint64_t* out, uint64_t* tot,
                               uint64_t* cin, const int64_t* plan, void* stream) {
  return div_scan<gl2>(c, z, zinv, alpha, head, carry, out, tot, cin, plan, stream);
}

extern "C" int ms_div_scan_bb4(const uint64_t* c, const uint64_t* z, const uint64_t* zinv,
                               const uint64_t* alpha, const uint64_t* head,
                               const uint64_t* carry, uint64_t* out, uint64_t* tot,
                               uint64_t* cin, const int64_t* plan, void* stream) {
  return div_scan<bb4>(c, z, zinv, alpha, head, carry, out, tot, cin, plan, stream);
}
