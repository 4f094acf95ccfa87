// First-occurrence leaf search: for (n, C) int64 leaf components and (q, C)
// value rows, the least index i with comps[i] == rows[j] in all C words, or
// n where there is none (C = 1, 2, 4: base field, Fp2, BabyBear Fp4; the
// reference's first-occurrence lookup, SURVEY §8.6).
//
// Replaces ministark_tpu/commit/packed_tree.py::_first_match_find (:87),
// which XLA lowered as a (q, n) compare, an all over C, a where against an
// iota and a min: about seven passes and a (q, n) int64 temporary. Here
// every element is read once. A block copies the q rows into shared memory
// with q per-row minima; its threads walk the elements with a grid-stride
// loop, each loading UNROLL elements (whole 16-byte vectors for Fp2, two for
// Fp4's 32-byte element) before comparing them with every row. A hit is rare
// (a value sits once or a few times in a codeword), so it takes a shared
// atomicMin on its row's minimum and the q minima need no registers: any q
// up to MAX_ROWS fits. Then each block makes one global atomicMin per row
// it hit, into a per-device scratch (ops: commit/packed_tree.py), and the
// block that finishes last (a ticket after a fence) writes the q minima out
// and resets them and the ticket, so each call is one launch and a CUDA
// graph that captured a call replays right. The scratch: word 0 the ticket
// (0 between calls), words 1..MAX_ROWS the minima (NONE between calls).
//
// Storage: ms_first_match compares Goldilocks' 64-bit words,
// ms_first_match_bb BabyBear's 32-bit ones (int32 tensors): an Fp4 row is
// one 16-byte load, a base element one 4-byte load; the rest is the same
// kernel body on the narrower word.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 4;          // elements a thread loads before comparing
constexpr int BLOCKS_PER_SM = 8;   // 2048 resident threads an SM
constexpr int MAX_ROWS = 1024;     // rows a launch takes (ops: MATCH_MAX_ROWS)
constexpr unsigned NONE = 0xFFFFFFFFu;

// BabyBear: C 32-bit words an element, C = 1, 2 or 4 (one 4-, 8- or 16-byte load)
template <int C>
__device__ __forceinline__ void load(const int32_t* __restrict__ comps, long long i,
                                     int32_t (&v)[C]) {
  if constexpr (C == 1) {
    v[0] = __ldcs(reinterpret_cast<const int*>(comps) + i);
  } else if constexpr (C == 2) {
    const int2 a = __ldcs(reinterpret_cast<const int2*>(comps) + i);
    v[0] = a.x;
    v[1] = a.y;
  } else {
    const int4 a = __ldcs(reinterpret_cast<const int4*>(comps) + i);
    v[0] = a.x;
    v[1] = a.y;
    v[2] = a.z;
    v[3] = a.w;
  }
}

template <int C>
__device__ __forceinline__ void load(const int64_t* __restrict__ comps, long long i,
                                     int64_t (&v)[C]) {
  if constexpr (C == 1) {
    v[0] = __ldcs(reinterpret_cast<const long long*>(comps) + i);
  } else {
    const longlong2* p = reinterpret_cast<const longlong2*>(comps) + i * (C / 2);
#pragma unroll
    for (int h = 0; h < C / 2; ++h) {
      const longlong2 a = __ldcs(p + h);
      v[2 * h] = a.x;
      v[2 * h + 1] = a.y;
    }
  }
}

template <int C, class Word>
__global__ void __launch_bounds__(THREADS)
    first_match_kernel(const Word* __restrict__ comps, const Word* __restrict__ rows,
                       int64_t* __restrict__ out, unsigned* __restrict__ scratch, int n,
                       int q) {
  extern __shared__ int64_t smem[];                      // 8-byte aligned for both words
  Word* srow = reinterpret_cast<Word*>(smem);            // q * C row words
  unsigned* smin = reinterpret_cast<unsigned*>(srow + q * C);   // q minima
  __shared__ bool last;
  for (int j = threadIdx.x; j < q * C; j += THREADS) srow[j] = rows[j];
  for (int j = threadIdx.x; j < q; j += THREADS) smin[j] = NONE;
  __syncthreads();

  const long long step = (long long)gridDim.x * THREADS * UNROLL;
  for (long long base = (long long)blockIdx.x * THREADS * UNROLL + threadIdx.x; base < n;
       base += step) {
    Word v[UNROLL][C];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (base + u * THREADS < n) load<C>(comps, base + u * THREADS, v[u]);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long i = base + u * THREADS;
      if (i < n) {
        for (int j = 0; j < q; ++j) {
          bool eq = v[u][0] == srow[j * C];
#pragma unroll
          for (int c = 1; c < C; ++c) eq &= v[u][c] == srow[j * C + c];
          if (eq) atomicMin(&smin[j], (unsigned)i);
        }
      }
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < q; j += THREADS) {
    if (smin[j] != NONE) atomicMin(&scratch[1 + j], smin[j]);
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(&scratch[0], 1u) == gridDim.x - 1;
  __syncthreads();
  if (last) {                       // every other block's minima are in
    __threadfence();
    for (int j = threadIdx.x; j < q; j += THREADS) {
      const unsigned m = atomicExch(&scratch[1 + j], NONE);
      out[j] = m == NONE ? (int64_t)n : (int64_t)m;
    }
    if (threadIdx.x == 0) scratch[0] = 0u;
  }
}

int sm_count() {
  static int count[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  if (count[dev] == 0 &&
      cudaDeviceGetAttribute(&count[dev], cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) {
    count[dev] = 132;
  }
  return count[dev];
}

template <int C, class Word>
int launch(const Word* comps, const Word* rows, int64_t* out, unsigned* scratch, int n,
           int q, cudaStream_t stream) {
  const long long need = ((long long)n + THREADS * UNROLL - 1) / (THREADS * UNROLL);
  const long long most = (long long)sm_count() * BLOCKS_PER_SM;
  const unsigned blocks = (unsigned)(need < most ? need : most);
  const size_t shared = (size_t)q * C * sizeof(Word) + (size_t)q * sizeof(unsigned);
  first_match_kernel<C, Word><<<blocks, THREADS, shared, stream>>>(comps, rows, out, scratch,
                                                                  n, q);
  return (int)cudaGetLastError();
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
