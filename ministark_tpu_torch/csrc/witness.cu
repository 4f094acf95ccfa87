// Witness generation on the card: the rows of the Fibonacci AIR's trace by
// a 2x2 matrix-power ladder, and the rows of the counter AIR's trace in
// closed form, in Goldilocks (64-bit words) and BabyBear (32-bit words).
// Each entry point writes any block of rows [lo, lo + count) of the
// columns in one launch, so a rank of a mesh builds only its own block.
//
// Replaces no Pallas kernel: the JAX package builds each witness as one
// jitted program that XLA fuses (ministark_tpu/models/fibonacci_device.py:19-99,
// the ladder a fori_loop at :80; ministark_tpu/models/counter.py:57-92), where
// the port's torch-op versions (ops/witness.py's *_plain) take some 31
// launches a round of the ladder. Row i of Fibonacci's (3, n) columns is
// (a, b, a + b) with (a, b) = M^i (1, b0), M = [[0, 1], [1, 1]]; the
// counter's (2, n) columns are start + i step and a (start + i step) + b,
// written c1 + i (a step) with c1 = a start + b (the same value mod p).
// Rows i >= steps hold the padding scalar.
//
// Bound on the H100: the bytes written (nothing is read) or, for
// Fibonacci, the products, so the design keeps a row's operations few and
// every store coalesced. A thread writes R = 2 consecutive rows of each
// column at a time (a chunk: one 8-byte BabyBear or 16-byte Goldilocks
// store, neighbouring lanes on neighbouring chunks, so a warp's store is
// contiguous), and a grid of one block an SM (ops/witness.py::grid) walks
// the chunks with a stride of R x the grid's threads. Fibonacci: a warp runs the ladder
// once for its first row (for each set bit b of that index, a product by
// M^(2^b) from the argument table; the same bits in every lane, so no lane
// waits on another), each lane then moves to its own first row by
// M^(R lane) from a second table, steps a row inside a chunk ((a, b) ->
// (b, a + b): one add, which is also the third column) and a chunk by
// M^stride. A product by a power M^k = [[F(k-1), F(k)], [F(k), F(k+1)]]
// takes three field products: x = F(k) (a + b), a' = x - F(k-2) a, b' = x +
// F(k-1) b. Counter: two products at a chunk's first row, two adds a row.
// The tables are kernel arguments (__grid_constant__: read from the
// constant bank; the lanes' table is copied to shared memory first, as each
// lane reads its own entry).
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "bb.cuh"
#include "gl.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int R = 2;        // rows a thread writes at a time (a chunk)
constexpr int LADDER = 32;  // M^(2^b) for b < 32: row indices below 2^32
// the host plans (ops/witness.py::_fib_plan, _counter_plan): FIB_HEAD
// scalars, then the ladder, the lanes' table and the jump, POW words each
constexpr int FIB_HEAD = 7;
constexpr int POW = 3;      // (F(k-2), F(k-1), F(k)) of M^k

struct FibArgs {
  uint64_t ladder[LADDER][POW];  // M^(2^b)
  uint64_t lane[32][POW];        // M^(R lane)
  uint64_t jump[POW];            // M^stride, stride = R x the grid's threads
  uint64_t b0, pad;
  int64_t lo, count, steps;
  int bits;                      // the bit length of the last warp's first row
};

struct CounterArgs {
  uint64_t start, step, c1, c1_step, pad;
  int64_t lo, count, steps;
};

// (a, b) <- M^k (a, b), m = (F(k-2), F(k-1), F(k)): three products
template <class F>
__device__ __forceinline__ void pow_vec(const uint64_t* m, uint64_t& a, uint64_t& b) {
  const uint64_t x = F::mul(m[2], F::add(a, b));
  const uint64_t na = F::sub(x, F::mul(m[0], a));
  b = F::add(x, F::mul(m[1], b));
  a = na;
}

// a chunk of one column at local row i: one 8- or 16-byte store where
// every chunk is whole and aligned (VEC), else a word a row up to count
template <bool VEC, class W>
__device__ __forceinline__ void store_rows(W* col, int64_t i, int64_t count,
                                           const uint64_t (&v)[R]) {
  if constexpr (VEC && sizeof(W) == 4) {
    *reinterpret_cast<uint2*>(col + i) = make_uint2((uint32_t)v[0], (uint32_t)v[1]);
  } else if constexpr (VEC) {
    *reinterpret_cast<ulonglong2*>(col + i) = make_ulonglong2(v[0], v[1]);
  } else {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (i + r < count) col[i + r] = (W)v[r];
    }
  }
}

template <class F, bool VEC>
__global__ void __launch_bounds__(THREADS)
    fib_witness_kernel(const __grid_constant__ FibArgs args, word_t<F>* __restrict__ out) {
  __shared__ uint64_t lane_pow[32][POW];
  for (int k = threadIdx.x; k < 32 * POW; k += THREADS) {
    lane_pow[k / POW][k % POW] = args.lane[k / POW][k % POW];
  }
  __syncthreads();
  const int64_t count = args.count;
  const int64_t stride = (int64_t)gridDim.x * THREADS * R;
  const int64_t first = ((int64_t)blockIdx.x * THREADS + (threadIdx.x & ~31)) * R;
  if (first >= count) return;  // the whole warp
  uint64_t a = 1, b = args.b0;   // row 0
  const uint64_t e = (uint64_t)(args.lo + first);  // the warp's first row
  for (int k = 0; k < args.bits; ++k) {
    if ((e >> k) & 1) pow_vec<F>(args.ladder[k], a, b);
  }
  const int lane = threadIdx.x & 31;
  pow_vec<F>(lane_pow[lane], a, b);
  for (int64_t i = first + (int64_t)lane * R; i < count; i += stride) {
    uint64_t va[R], vb[R], vc[R];
    uint64_t x = a, y = b;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const uint64_t s = F::add(x, y);
      const bool keep = args.lo + i + r < args.steps;
      va[r] = keep ? x : args.pad;
      vb[r] = keep ? y : args.pad;
      vc[r] = keep ? s : args.pad;
      x = y;
      y = s;
    }
    store_rows<VEC>(out, i, count, va);
    store_rows<VEC>(out + count, i, count, vb);
    store_rows<VEC>(out + 2 * count, i, count, vc);
    pow_vec<F>(args.jump, a, b);
  }
}

template <class F, bool VEC>
__global__ void __launch_bounds__(THREADS)
    counter_witness_kernel(const __grid_constant__ CounterArgs args,
                           word_t<F>* __restrict__ out) {
  const int64_t count = args.count;
  const int64_t stride = (int64_t)gridDim.x * THREADS * R;
  for (int64_t i = ((int64_t)blockIdx.x * THREADS + threadIdx.x) * R; i < count;
       i += stride) {
    const uint64_t row = (uint64_t)(args.lo + i);  // < p: the field element i
    uint64_t x = F::add(args.start, F::mul(row, args.step));
    uint64_t y = F::add(args.c1, F::mul(row, args.c1_step));
    uint64_t v0[R], v1[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const bool keep = args.lo + i + r < args.steps;
      v0[r] = keep ? x : args.pad;
      v1[r] = keep ? y : args.pad;
      x = F::add(x, args.step);
      y = F::add(y, args.c1_step);
    }
    store_rows<VEC>(out, i, count, v0);
    store_rows<VEC>(out + count, i, count, v1);
  }
}

// every chunk whole and aligned: count a multiple of R (so each column
// starts on a chunk's boundary too) and the output 16-byte aligned
template <class W>
bool vectors(const W* out, int64_t count) {
  return count % R == 0 && (uintptr_t)out % 16 == 0;
}

bool bad_grid(int64_t lo, int64_t count, int64_t blocks) {
  return lo < 0 || count < 1 || blocks < 1 || blocks > INT_MAX ||
         lo + count > (int64_t(1) << LADDER);
}

// plan: lo, count, steps, blocks, bits, b0, pad, then POW words each of
// the ladder (M^(2^b), b < 32), the lanes' table (M^(R lane), lane < 32)
// and M^stride; values canonical
template <class F>
int fib_launch(word_t<F>* out, const int64_t* plan, cudaStream_t stream) {
  FibArgs args;
  args.lo = plan[0];
  args.count = plan[1];
  args.steps = plan[2];
  const int64_t blocks = plan[3];
  args.bits = (int)plan[4];
  args.b0 = (uint64_t)plan[5];
  args.pad = (uint64_t)plan[6];
  const int64_t* p = plan + FIB_HEAD;
  for (int k = 0; k < LADDER; ++k) {
    for (int j = 0; j < POW; ++j) args.ladder[k][j] = (uint64_t)*p++;
  }
  for (int k = 0; k < 32; ++k) {
    for (int j = 0; j < POW; ++j) args.lane[k][j] = (uint64_t)*p++;
  }
  for (int j = 0; j < POW; ++j) args.jump[j] = (uint64_t)*p++;
  if (bad_grid(args.lo, args.count, blocks) || plan[4] < 1 || plan[4] > LADDER) {
    return (int)cudaErrorInvalidValue;
  }
  if (vectors(out, args.count)) {
    fib_witness_kernel<F, true><<<(unsigned)blocks, THREADS, 0, stream>>>(args, out);
  } else {
    fib_witness_kernel<F, false><<<(unsigned)blocks, THREADS, 0, stream>>>(args, out);
  }
  return (int)cudaGetLastError();
}

// plan: lo, count, steps, blocks, start, step, c1 = a start + b, a step,
// pad; values canonical, lo + count <= p
template <class F>
int counter_launch(word_t<F>* out, const int64_t* plan, cudaStream_t stream) {
  CounterArgs args;
  args.lo = plan[0];
  args.count = plan[1];
  args.steps = plan[2];
  const int64_t blocks = plan[3];
  args.start = (uint64_t)plan[4];
  args.step = (uint64_t)plan[5];
  args.c1 = (uint64_t)plan[6];
  args.c1_step = (uint64_t)plan[7];
  args.pad = (uint64_t)plan[8];
  if (bad_grid(args.lo, args.count, blocks)) return (int)cudaErrorInvalidValue;
  if (vectors(out, args.count)) {
    counter_witness_kernel<F, true><<<(unsigned)blocks, THREADS, 0, stream>>>(args, out);
  } else {
    counter_witness_kernel<F, false><<<(unsigned)blocks, THREADS, 0, stream>>>(args, out);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// out: the (3, count) Fibonacci columns (64-bit words; _bb: 32-bit), rows
// [lo, lo + count) of the trace; plan: int64[FIB_HEAD + POW x 65] on the host
extern "C" int ms_fib_witness_gl(void* out, const int64_t* plan, void* stream) {
  return fib_launch<gl>((uint64_t*)out, plan, (cudaStream_t)stream);
}

extern "C" int ms_fib_witness_bb(void* out, const int64_t* plan, void* stream) {
  return fib_launch<bb>((uint32_t*)out, plan, (cudaStream_t)stream);
}

// out: the (2, count) counter columns; plan: int64[9] on the host
extern "C" int ms_counter_witness_gl(void* out, const int64_t* plan, void* stream) {
  return counter_launch<gl>((uint64_t*)out, plan, (cudaStream_t)stream);
}

extern "C" int ms_counter_witness_bb(void* out, const int64_t* plan, void* stream) {
  return counter_launch<bb>((uint32_t*)out, plan, (cudaStream_t)stream);
}
