// First-occurrence leaf search: for (n, C) leaf components and (q, C) value
// rows, the least index i with comps[i] == rows[j] in all C words, or n
// where there is none (C = 1, 2, 4: base field, Fp2, BabyBear Fp4; the
// reference's first-occurrence lookup, SURVEY §8.6).
//
// Replaces ministark_tpu/commit/packed_tree.py::_first_match_find (:87),
// which XLA lowered as a (q, n) compare, an all over C, a where against an
// iota and a min: about seven passes and a (q, n) int64 temporary. Here
// every element is read once.
//
// What bounds it: at the provers' q = 6 the read of the n C words (bytes:
// 32 MB at the query rounds' 2^21 Fp2 / Fp4, 0.0100 ms at 3.35 TB/s); at
// q = 64 the compares (an element against every row). A cold call (the
// operands out of L2) also pays a launch's fixed ~5 us, and no design
// reads the bytes faster than a read-only pass of the same grid
// (scripts/torch_first_match_probe.py: 0.60-0.63 of the bound at 2^21,
// 0.46 at 2^20). The first design (a row fill and barrier ahead of every
// block's first load, a full C-word compare of every element against every
// row reloaded from shared memory, shared minima, a fence and a ticket in
// each of 1,056 blocks) lost 0.005 ms to that pass; this one:
//  - a grid of one wave (the blocks the occupancy calculator fits on the
//    card at once), thread t of block b taking elements b THREADS + t + k
//    step (step: a pass over the grid), each thread keeping its next
//    stages() elements (64 bytes) in flight in its own ring of shared
//    memory slots by cp.async, the first ones issued before anything but
//    the rows' words, each slot refilled as soon as its element is
//    compared: no barrier, and no register holds an element in flight;
//  - a prefilter on one 32-bit word: each element's first word (the low
//    half of a Goldilocks word 0) against every row's, OR-ed into one
//    predicate, one compare a row an element; the rows' words in
//    registers for q <= REG_ROWS (every prover: q 6), else in shared
//    memory, four rows a 16-byte load for four elements at a time;
//  - on a prefilter hit, which is rare (a value sits once or a few times in
//    a codeword, and random words collide once in 2^32), the element is
//    confirmed against the rows whose word it equals, in all C words, and
//    a true match takes an atomicMin on its row's minimum in a per-device
//    scratch (ops: commit/packed_tree.py); no block keeps minima of its own;
//  - after one barrier a block's warp 0 alone takes the ticket (one atomic a
//    block, a release only where the block took a minimum; holding the
//    block's other warps on a second barrier cost 0.004 ms warm); the
//    block that takes the last writes the q minima out and resets them and
//    the ticket, so each call is one launch and a CUDA graph that captured
//    a call replays right. The scratch: word 0 the ticket (0 between
//    calls), words 1..MAX_ROWS the minima (NONE between calls). The ticket
//    and the last block's read of the minima are two L2 round trips after
//    the last element lands (~0.001 ms of a cold q = 6 call).
//
// Storage: ms_first_match compares Goldilocks' 64-bit words,
// ms_first_match_bb BabyBear's 32-bit ones (int32 tensors): an Fp4 row is
// one 16-byte load, a base element one 4-byte load; the rest is the same
// kernel body on the narrower word.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_ROWS = 1024;     // rows a launch takes (ops: MATCH_MAX_ROWS)
constexpr int REG_ROWS = 8;        // rows whose prefilter words sit in registers
constexpr unsigned NONE = 0xFFFFFFFFu;

// elements a thread keeps in flight (its ring's slots): 64 bytes, 4 to 16
template <int C, class Word>
__host__ __device__ constexpr int stages() {
  constexpr int s = 64 / (C * (int)sizeof(Word));
  return s < 4 ? 4 : (s > 16 ? 16 : s);
}

// a block's ring: stages x THREADS elements, thread t's slots t, t + THREADS, ...
template <int C, class Word>
__host__ __device__ constexpr int ring_bytes() {
  return stages<C, Word>() * THREADS * C * (int)sizeof(Word);
}

// an asynchronous copy of 4, 8 or 16 bytes into shared memory (L2 only for 16)
template <int BYTES>
__device__ __forceinline__ void copy_async(uint32_t dst, const void* src) {
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst), "l"(src) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;" ::"r"(dst), "l"(src), "n"(BYTES)
                 : "memory");
  }
}

__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }

// the oldest of a thread's groups landed once at most N are pending
template <int N>
__device__ __forceinline__ void wait_landed() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// element i's C words into this thread's ring slot (shared address dst)
template <int C, class Word>
__device__ __forceinline__ void fetch(uint32_t dst, const Word* __restrict__ comps, unsigned i) {
  constexpr int E = C * (int)sizeof(Word);
  const Word* src = comps + (size_t)i * C;
  if constexpr (E <= 16) {
    copy_async<E>(dst, src);
  } else {
    copy_async<16>(dst, src);
    copy_async<16>(dst + 16, src + 16 / sizeof(Word));
  }
}

// a landed element from this thread's slot: 16-byte vectors where it holds them
template <int C>
__device__ __forceinline__ void read_slot(const int32_t* e, int32_t (&v)[C]) {
  if constexpr (C == 4) {
    const int4 a = *reinterpret_cast<const int4*>(e);
    v[0] = a.x;
    v[1] = a.y;
    v[2] = a.z;
    v[3] = a.w;
  } else {
#pragma unroll
    for (int c = 0; c < C; ++c) v[c] = e[c];
  }
}

template <int C>
__device__ __forceinline__ void read_slot(const int64_t* e, int64_t (&v)[C]) {
  if constexpr (C == 1) {
    v[0] = *reinterpret_cast<const long long*>(e);
  } else {
#pragma unroll
    for (int h = 0; h < C / 2; ++h) {
      const longlong2 a = reinterpret_cast<const longlong2*>(e)[h];
      v[2 * h] = a.x;
      v[2 * h + 1] = a.y;
    }
  }
}

// a row word, through the read-only cache (every thread reads the same rows)
__device__ __forceinline__ int32_t row_word(const int32_t* p) {
  return __ldg(reinterpret_cast<const int*>(p));
}

__device__ __forceinline__ int64_t row_word(const int64_t* p) {
  return __ldg(reinterpret_cast<const long long*>(p));
}

// the prefilter word: a BabyBear word, or a Goldilocks word's low half
template <class Word>
__device__ __forceinline__ uint32_t pre(Word w) {
  return (uint32_t)w;
}

template <int C, class Word>
__device__ __forceinline__ bool equal_row(const Word (&v)[C], const Word* __restrict__ row) {
  bool eq = true;
#pragma unroll
  for (int c = 0; c < C; ++c) eq &= v[c] == row_word(row + c);
  return eq;
}

// the ticket: one atomic add at the device's scope, a release where the
// block took a minimum (its minima before it), relaxed where it has none
// to order; the tickets are one chain of read-modify-writes, so the last
// block's acquire fence sees every release
__device__ __forceinline__ unsigned take_ticket(unsigned* p, bool release) {
  unsigned old;
  if (release) {
    asm volatile("atom.release.gpu.global.add.u32 %0, [%1], 1;" : "=r"(old) : "l"(p) : "memory");
  } else {
    asm volatile("atom.relaxed.gpu.global.add.u32 %0, [%1], 1;" : "=r"(old) : "l"(p) : "memory");
  }
  return old;
}

__device__ __forceinline__ void acquire_fence() { asm volatile("fence.acq_rel.gpu;" ::: "memory"); }

// the ticket's and the minima's cache lines into L2, kept there over the
// stream of elements, so that a cold call's epilogue finds them on chip
__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2::evict_last [%0];" ::"l"(p));
}

// REG: q <= REG_ROWS, the rows' prefilter words in registers (rows past q
// repeat row 0's), an element compared at a time; else the words in shared
// memory after the ring, padded to a multiple of 4 so, and G = 4 elements
// compared at a time (one 16-byte load of four rows' words serves four)
template <int C, class Word, bool REG>
__global__ void __launch_bounds__(THREADS)
    first_match_kernel(const Word* __restrict__ comps, const Word* __restrict__ rows,
                       int64_t* __restrict__ out, unsigned* __restrict__ scratch, unsigned n,
                       int q) {
  constexpr int S = stages<C, Word>();
  constexpr int G = REG ? 1 : 4;
  static_assert(S % G == 0, "a group's slots lie together in the ring");
  constexpr int E = C * (int)sizeof(Word);
  constexpr int FILL = REG ? REG_ROWS : MAX_ROWS / THREADS;
  extern __shared__ uint4 smem4[];                 // the ring, then !REG's words
  unsigned char* ring = reinterpret_cast<unsigned char*>(smem4) + threadIdx.x * E;
  const uint32_t slot0 = (uint32_t)__cvta_generic_to_shared(ring);
  uint32_t* spre = reinterpret_cast<uint32_t*>(reinterpret_cast<unsigned char*>(smem4) +
                                               ring_bytes<C, Word>());
  const unsigned step = gridDim.x * THREADS;       // a pass over the grid
  const unsigned first = blockIdx.x * THREADS + threadIdx.x;
  const int padded = (q + 3) & ~3;
  // the rows' prefilter words first (every compare waits for them; a cold
  // call finds them in device memory): REG all of them, else this thread's
  // share of the fill
  uint32_t r[FILL];
#pragma unroll
  for (int m = 0; m < FILL; ++m) {
    const int j = REG ? m : (int)threadIdx.x + m * THREADS;
    if (REG || j < padded) r[m] = pre(row_word(rows + (j < q ? j : 0) * C));
  }
  if (blockIdx.x == 0 && (int)threadIdx.x <= q / 32) prefetch_l2(scratch + 32 * threadIdx.x);
  // this thread's elements first + k step: the first S in flight
#pragma unroll
  for (int k = 0; k < S; ++k) {
    if (first + k * step < n) fetch<C>(slot0 + k * THREADS * E, comps, first + k * step);
    commit();
  }
  if constexpr (!REG) {
#pragma unroll
    for (int m = 0; m < FILL; ++m) {
      const int j = (int)threadIdx.x + m * THREADS;
      if (j < padded) spre[j] = r[m];
    }
    __syncthreads();
  }
  bool touched = false;                            // this thread took a minimum
  int k = 0;                                       // the ring slot of element i
  for (unsigned i = first; i < n; i += G * step) {
    wait_landed<S - G>();                          // elements i .. i + (G - 1) step
    Word v[G][C];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (G == 1 || i + g * step < n) {
        read_slot<C>(reinterpret_cast<const Word*>(ring + (k + g) * THREADS * E), v[g]);
      } else {
#pragma unroll
        for (int c = 0; c < C; ++c) v[g][c] = 0;
      }
    }
    bool hit = false;
    if constexpr (REG) {
#pragma unroll
      for (int j = 0; j < REG_ROWS; ++j) hit |= pre(v[0][0]) == r[j];
    } else {
      const uint4* w4 = reinterpret_cast<const uint4*>(spre);
#pragma unroll 2
      for (int j4 = 0; j4 < padded / 4; ++j4) {
        const uint4 w = w4[j4];
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const uint32_t x = pre(v[g][0]);
          hit |= (x == w.x) | (x == w.y) | (x == w.z) | (x == w.w);
        }
      }
    }
    if (hit) {                                     // rare: confirm in all C words
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const unsigned ig = i + g * step;
        const uint32_t x = pre(v[g][0]);
        if constexpr (REG) {
#pragma unroll
          for (int j = 0; j < REG_ROWS; ++j) {
            if (j < q && r[j] == x && equal_row<C>(v[g], rows + j * C)) {
              atomicMin(&scratch[1 + j], ig);
              touched = true;
            }
          }
        } else if (ig < n) {                       // four rows' words a load
          const uint4* w4 = reinterpret_cast<const uint4*>(spre);
#pragma unroll 4
          for (int j4 = 0; j4 < padded / 4; ++j4) {
            const uint4 w = w4[j4];
            const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
            for (int h = 0; h < 4; ++h) {
              const int j = 4 * j4 + h;
              if (ws[h] == x && j < q && equal_row<C>(v[g], rows + j * C)) {
                atomicMin(&scratch[1 + j], ig);
                touched = true;
              }
            }
          }
        }
      }
    }
    // the slots are read (the compare used them): refill them S passes on
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const unsigned next = i + (g + S) * step;
      if (next < n) fetch<C>(slot0 + (k + g) * THREADS * E, comps, next);
      commit();
    }
    k = k + G == S ? 0 : k + G;
  }
  wait_landed<0>();
  const bool took = __syncthreads_or(touched);    // the block's minima are in
  if (threadIdx.x >= 32) return;                   // warp 0 takes the ticket alone
  const int lane = threadIdx.x;
  unsigned ticket = 0;
  if (lane == 0) ticket = take_ticket(&scratch[0], took);
  if (__shfl_sync(0xFFFFFFFFu, ticket, 0) != gridDim.x - 1) return;
  acquire_fence();                                 // every other block's minima are in
  for (int j = lane; j < q; j += 32) {
    const unsigned m = atomicExch(&scratch[1 + j], NONE);
    out[j] = m == NONE ? (int64_t)n : (int64_t)m;
  }
  if (lane == 0) scratch[0] = 0u;
}

int device_index() {
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return -1;
  return dev;
}

int sm_count() {
  static int count[64] = {0};
  const int dev = device_index();
  if (dev < 0) return 132;
  if (count[dev] == 0 &&
      cudaDeviceGetAttribute(&count[dev], cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) {
    count[dev] = 132;
  }
  return count[dev];
}

template <int C, class Word, bool REG>
size_t shared_bytes(int q) {
  return (size_t)ring_bytes<C, Word>() + (REG ? 0 : (size_t)((q + 3) & ~3) * sizeof(uint32_t));
}

// blocks of one instantiation that run on an SM at once (its ring and
// registers decide; at MAX_ROWS rows for !REG), per device; 1 if the
// calculator fails
template <int C, class Word, bool REG>
int resident_blocks() {
  static int count[64] = {0};
  const int dev = device_index();
  if (dev < 0) return 1;
  if (count[dev] == 0) {
    int k = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&k, first_match_kernel<C, Word, REG>,
                                                      THREADS, shared_bytes<C, Word, REG>(
                                                          MAX_ROWS)) != cudaSuccess ||
        k < 1) {
      k = 1;
    }
    count[dev] = k;
  }
  return count[dev];
}

// one wave: a thread an element of a pass, at most the blocks the card holds
template <int C, class Word, bool REG>
unsigned grid(int n) {
  const long long need = ((long long)n + THREADS - 1) / THREADS;
  const long long most = (long long)sm_count() * resident_blocks<C, Word, REG>();
  return (unsigned)(need < most ? need : most);
}

template <int C, class Word>
int launch(const Word* comps, const Word* rows, int64_t* out, unsigned* scratch, int n,
           int q, cudaStream_t stream) {
  if (q <= REG_ROWS) {
    const unsigned blocks = grid<C, Word, true>(n);
    first_match_kernel<C, Word, true><<<blocks, THREADS, shared_bytes<C, Word, true>(q),
                                        stream>>>(comps, rows, out, scratch, (unsigned)n, q);
  } else {
    const unsigned blocks = grid<C, Word, false>(n);
    first_match_kernel<C, Word, false><<<blocks, THREADS, shared_bytes<C, Word, false>(q),
                                         stream>>>(comps, rows, out, scratch, (unsigned)n, q);
  }
  return (int)cudaGetLastError();
}

template <class Word>
int geometry(int n, int q, int C, int* blocks, int* slots) {
  const bool reg = q <= REG_ROWS;
  switch (C) {
    case 1:
      *blocks = (int)(reg ? grid<1, Word, true>(n) : grid<1, Word, false>(n));
      *slots = stages<1, Word>();
      return 0;
    case 2:
      *blocks = (int)(reg ? grid<2, Word, true>(n) : grid<2, Word, false>(n));
      *slots = stages<2, Word>();
      return 0;
    case 4:
      *blocks = (int)(reg ? grid<4, Word, true>(n) : grid<4, Word, false>(n));
      *slots = stages<4, Word>();
      return 0;
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// comps: (n, C) int64, rows: (q, C) int64, both contiguous (comps 16-byte
// aligned for C = 2, 4); out: (q,) int64; scratch: 1 + MAX_ROWS words, word
// 0 zero and the rest NONE (as each call leaves them); 1 <= n < 2^31 - 1,
// 1 <= q <= MAX_ROWS.
extern "C" int ms_first_match(const int64_t* comps, const int64_t* rows, int64_t* out,
                              unsigned* scratch, int n, int q, int C, void* stream) {
  if (n < 1 || n == 0x7FFFFFFF || q < 1 || q > MAX_ROWS) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (C) {
    case 1: return launch<1, int64_t>(comps, rows, out, scratch, n, q, s);
    case 2: return launch<2, int64_t>(comps, rows, out, scratch, n, q, s);
    case 4: return launch<4, int64_t>(comps, rows, out, scratch, n, q, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// as ms_first_match over BabyBear's 32-bit words: comps (n, C) and rows (q,
// C) int32, comps 16-byte aligned for C = 2, 4
extern "C" int ms_first_match_bb(const int32_t* comps, const int32_t* rows, int64_t* out,
                                 unsigned* scratch, int n, int q, int C, void* stream) {
  if (n < 1 || n == 0x7FFFFFFF || q < 1 || q > MAX_ROWS) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (C) {
    case 1: return launch<1, int32_t>(comps, rows, out, scratch, n, q, s);
    case 2: return launch<2, int32_t>(comps, rows, out, scratch, n, q, s);
    case 4: return launch<4, int32_t>(comps, rows, out, scratch, n, q, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// the grid a call of n elements and q rows launches on the current device:
// out[0] its blocks, out[1] the elements a thread keeps in flight (its
// ring's slots; word: 8 Goldilocks, 4 BabyBear), out[2] REG_ROWS, out[3]
// THREADS
extern "C" int ms_first_match_geometry(int n, int q, int C, int word, int* out) {
  if (n < 1 || q < 1 || q > MAX_ROWS) return (int)cudaErrorInvalidValue;
  out[2] = REG_ROWS;
  out[3] = THREADS;
  if (word == 8) return geometry<int64_t>(n, q, C, &out[0], &out[1]);
  if (word == 4) return geometry<int32_t>(n, q, C, &out[0], &out[1]);
  return (int)cudaErrorInvalidValue;
}
