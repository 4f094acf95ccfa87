// Throwaway kernels of scripts/torch_first_match_probe.py, built by it alone
// and never part of ministark_tpu_torch: what a cold call of the
// first-occurrence leaf search (ministark_tpu_torch/csrc/leaf_search.cu)
// spends its time on.
//
//   probe_empty       an empty launch of the search's grid
//   probe_read<U>     a read-only pass over the same bytes with the same
//                     loads (__ldcs, one 16-byte vector an Fp2 element):
//                     U elements a thread a pass, a grid-stride loop, no
//                     compare and no epilogue
//   v0_kernel         leaf_search.cu as it stood before its redesign (the
//                     q rows and minima in shared memory, four elements a
//                     thread a pass, 8 blocks an SM): HOIST issues each thread's
//                     element loads before the row fill (and every next
//                     pass's loads before the compare); TRACE writes each
//                     block's SM and %globaltimer at its start, after its
//                     first compare, after its loop's barrier and at its end
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 4;
constexpr int MAX_ROWS = 1024;
constexpr unsigned NONE = 0xFFFFFFFFu;
constexpr int TRACE_WORDS = 5;

__device__ __forceinline__ long long global_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ unsigned sm_id() {
  unsigned s;
  asm volatile("mov.u32 %0, %%smid;" : "=r"(s));
  return s;
}

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

__global__ void probe_empty() {}

template <int C, class Word, int U>
__global__ void __launch_bounds__(THREADS)
    probe_read(const Word* __restrict__ comps, long long* __restrict__ sink, int n) {
  Word acc = 0;
  const long long step = (long long)gridDim.x * THREADS * U;
  for (long long base = (long long)blockIdx.x * THREADS * U + threadIdx.x; base < n;
       base += step) {
    Word v[U][C];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (base + u * THREADS < n) {
        load<C>(comps, base + u * THREADS, v[u]);
      } else {
#pragma unroll
        for (int c = 0; c < C; ++c) v[u][c] = 0;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int c = 0; c < C; ++c) acc ^= v[u][c];
    }
  }
  if (acc == (Word)0x5bd1e995) sink[0] = (long long)acc;     // keeps the loads
}

template <int C, class Word>
__device__ __forceinline__ void load_group(const Word* __restrict__ comps, long long base,
                                           int n, Word (&v)[UNROLL][C]) {
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    if (base + u * THREADS < n) load<C>(comps, base + u * THREADS, v[u]);
  }
}

template <int C, class Word, bool HOIST, bool TRACE>
__global__ void __launch_bounds__(THREADS)
    v0_kernel(const Word* __restrict__ comps, const Word* __restrict__ rows,
              int64_t* __restrict__ out, unsigned* __restrict__ scratch, int n, int q,
              long long* __restrict__ trace) {
  const long long t_start = TRACE ? global_ns() : 0;
  long long t_first = 0;
  extern __shared__ int64_t smem[];
  Word* srow = reinterpret_cast<Word*>(smem);
  unsigned* smin = reinterpret_cast<unsigned*>(srow + q * C);
  __shared__ bool last;
  const long long step = (long long)gridDim.x * THREADS * UNROLL;
  long long base = (long long)blockIdx.x * THREADS * UNROLL + threadIdx.x;
  Word v[UNROLL][C];
  if (HOIST) load_group<C>(comps, base, n, v);
  for (int j = threadIdx.x; j < q * C; j += THREADS) srow[j] = rows[j];
  for (int j = threadIdx.x; j < q; j += THREADS) smin[j] = NONE;
  __syncthreads();

  for (; base < n; base += step) {
    if (!HOIST) load_group<C>(comps, base, n, v);
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
    if (TRACE && t_first == 0) t_first = global_ns();
    if (HOIST) load_group<C>(comps, base + step, n, v);
  }
  __syncthreads();
  const long long t_loop = TRACE ? global_ns() : 0;
  for (int j = threadIdx.x; j < q; j += THREADS) {
    if (smin[j] != NONE) atomicMin(&scratch[1 + j], smin[j]);
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(&scratch[0], 1u) == gridDim.x - 1;
  __syncthreads();
  if (last) {
    __threadfence();
    for (int j = threadIdx.x; j < q; j += THREADS) {
      const unsigned m = atomicExch(&scratch[1 + j], NONE);
      out[j] = m == NONE ? (int64_t)n : (int64_t)m;
    }
    if (threadIdx.x == 0) scratch[0] = 0u;
  }
  if (TRACE && threadIdx.x == 0) {
    long long* t = trace + (long long)blockIdx.x * TRACE_WORDS;
    t[0] = sm_id();
    t[1] = t_start;
    t[2] = t_first;
    t[3] = t_loop;
    t[4] = global_ns();
  }
}

// the redesign's candidates (rows' prefilter words in registers, q <= 8):
// U elements a thread a pass at TPB threads a block, 32-bit indices, the
// loads past n clamped to element n - 1; EPI 0 no epilogue (timing only,
// no result), 1 the ticket after __threadfence() (a SC fence), 2 the
// ticket as one acq_rel atomic; TRACE as v0_kernel's
__device__ __forceinline__ unsigned ticket_acq_rel(unsigned* p) {
  unsigned old;
  asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;" : "=r"(old) : "l"(p) : "memory");
  return old;
}

template <class Word>
__device__ __forceinline__ uint32_t pre(Word w) {
  return (uint32_t)w;
}

__device__ __forceinline__ int32_t row_word(const int32_t* p) {
  return __ldg(reinterpret_cast<const int*>(p));
}

__device__ __forceinline__ int64_t row_word(const int64_t* p) {
  return __ldg(reinterpret_cast<const long long*>(p));
}

template <int C, class Word, int U, int TPB, int EPI, bool TRACE>
__global__ void __launch_bounds__(TPB)
    v1_kernel(const Word* __restrict__ comps, const Word* __restrict__ rows,
              int64_t* __restrict__ out, unsigned* __restrict__ scratch, unsigned n, int q,
              long long* __restrict__ trace) {
  const long long t_start = TRACE ? global_ns() : 0;
  long long t_first = 0;
  __shared__ bool last;
  const unsigned step = gridDim.x * TPB * U;
  unsigned base = blockIdx.x * TPB * U + threadIdx.x;
  const unsigned top = n - 1;
  Word v[U][C];
#pragma unroll
  for (int u = 0; u < U; ++u) load<C>(comps, min(base + u * TPB, top), v[u]);
  uint32_t r[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) r[j] = pre(row_word(rows + (j < q ? j : 0) * C));
  bool touched = false;
  while (base < n) {
    bool hit = false;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int u = 0; u < U; ++u) hit |= pre(v[u][0]) == r[j];
    }
    if (hit) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const unsigned i = base + u * TPB;
        for (int j = 0; j < q && i < n; ++j) {
          bool eq = true;
#pragma unroll
          for (int c = 0; c < C; ++c) eq &= v[u][c] == row_word(rows + j * C + c);
          if (eq) {
            atomicMin(&scratch[1 + j], i);
            touched = true;
          }
        }
      }
    }
    if (TRACE && t_first == 0) t_first = global_ns();
    base += step;
    if (base < n) {
#pragma unroll
      for (int u = 0; u < U; ++u) load<C>(comps, min(base + u * TPB, top), v[u]);
    }
  }
  const long long t_loop = TRACE ? global_ns() : 0;
  if (EPI == 1) {
    if (touched) __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) {
      __threadfence();
      last = atomicAdd(&scratch[0], 1u) == gridDim.x - 1;
    }
  } else if (EPI == 2) {
    __syncthreads();
    if (threadIdx.x == 0) last = ticket_acq_rel(&scratch[0]) == gridDim.x - 1;
  }
  if (EPI != 0) {
    __syncthreads();
    if (last) {
      if (EPI == 1) __threadfence();
      for (int j = threadIdx.x; j < q; j += TPB) {
        const unsigned m = atomicExch(&scratch[1 + j], NONE);
        out[j] = m == NONE ? (int64_t)n : (int64_t)m;
      }
      if (threadIdx.x == 0) scratch[0] = 0u;
    }
  } else if (touched && q < 0) {
    out[0] = 0;                                   // never: keeps the loop
  }
  if (TRACE && threadIdx.x == 0) {
    long long* t = trace + (long long)blockIdx.x * TRACE_WORDS;
    t[0] = sm_id();
    t[1] = t_start;
    t[2] = t_first;
    t[3] = t_loop;
    t[4] = global_ns();
  }
}

// variant: 0 U 8 / 256 / EPI 1, 1 U 8 / 256 / EPI 2, 2 U 8 / 256 / EPI 0,
// 3 U 8 / 1024 / EPI 2, 4 U 4 / 256 / EPI 2
template <int C, class Word, int U, int TPB, int EPI>
int v1_run(const void* comps, const void* rows, int64_t* out, unsigned* scratch, int n, int q,
           int blocks, long long* trace, cudaStream_t s, int* resident) {
  if (resident) {
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        resident, v1_kernel<C, Word, U, TPB, EPI, false>, TPB, 0);
  }
  const Word* c = static_cast<const Word*>(comps);
  const Word* r = static_cast<const Word*>(rows);
  if (trace) {
    v1_kernel<C, Word, U, TPB, EPI, true><<<blocks, TPB, 0, s>>>(c, r, out, scratch,
                                                                 (unsigned)n, q, trace);
  } else {
    v1_kernel<C, Word, U, TPB, EPI, false><<<blocks, TPB, 0, s>>>(c, r, out, scratch,
                                                                  (unsigned)n, q, nullptr);
  }
  return (int)cudaGetLastError();
}

template <int C, class Word>
int v1_variant(int variant, const void* comps, const void* rows, int64_t* out,
               unsigned* scratch, int n, int q, int blocks, long long* trace, cudaStream_t s,
               int* resident) {
  switch (variant) {
    case 0: return v1_run<C, Word, 8, 256, 1>(comps, rows, out, scratch, n, q, blocks, trace, s, resident);
    case 1: return v1_run<C, Word, 8, 256, 2>(comps, rows, out, scratch, n, q, blocks, trace, s, resident);
    case 2: return v1_run<C, Word, 8, 256, 0>(comps, rows, out, scratch, n, q, blocks, trace, s, resident);
    case 3: return v1_run<C, Word, 8, 1024, 2>(comps, rows, out, scratch, n, q, blocks, trace, s, resident);
    case 4: return v1_run<C, Word, 4, 256, 2>(comps, rows, out, scratch, n, q, blocks, trace, s, resident);
    default: return (int)cudaErrorInvalidValue;
  }
}

// the ring design's knobs (rows in registers, q <= 8): S elements in flight
// a thread through cp.async; READ only consumes them (no compare, no
// epilogue, no result); CHUNK walks a contiguous chunk a block (thread t's
// k-th element at the chunk's start + k THREADS + t) where the port walks
// passes over the grid
template <int BYTES>
__device__ __forceinline__ void copy_async(uint32_t dst, const void* src) {
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst), "l"(src) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;" ::"r"(dst), "l"(src), "n"(BYTES)
                 : "memory");
  }
}

template <int N>
__device__ __forceinline__ void wait_landed() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

template <int C, class Word, int S, bool READ, bool CHUNK, int EPI>
__global__ void __launch_bounds__(THREADS)
    ring_kernel(const Word* __restrict__ comps, const Word* __restrict__ rows,
                int64_t* __restrict__ out, unsigned* __restrict__ scratch, unsigned n, int q) {
  constexpr int E = C * (int)sizeof(Word);
  static_assert(E == 16, "16-byte elements");
  extern __shared__ uint4 smem4[];
  __shared__ bool last;
  const uint32_t slot0 = (uint32_t)__cvta_generic_to_shared(smem4 + threadIdx.x);
  unsigned step, first, end;
  if (CHUNK) {
    const unsigned chunk = (n + gridDim.x * THREADS - 1) / (gridDim.x * THREADS) * THREADS;
    step = THREADS;
    first = blockIdx.x * chunk + threadIdx.x;
    end = min(n, blockIdx.x * chunk + chunk);
  } else {
    step = gridDim.x * THREADS;
    first = blockIdx.x * THREADS + threadIdx.x;
    end = n;
  }
  uint32_t r[8];
  if (!READ) {
#pragma unroll
    for (int j = 0; j < 8; ++j) r[j] = pre(row_word(rows + (j < q ? j : 0) * C));
  }
#pragma unroll
  for (int k = 0; k < S; ++k) {
    if (first + k * step < end) copy_async<16>(slot0 + k * THREADS * 16, comps + (size_t)(first + k * step) * C);
    asm volatile("cp.async.commit_group;" ::: "memory");
  }
  uint32_t acc = 0;
  int k = 0;
  for (unsigned i = first; i < end; i += step) {
    wait_landed<S - 1>();
    const uint4 a = smem4[k * THREADS + threadIdx.x];
    if (READ) {
      acc ^= a.x ^ a.y ^ a.z ^ a.w;
    } else {
      bool hit = false;
#pragma unroll
      for (int j = 0; j < 8; ++j) hit |= a.x == r[j];
      if (hit) {
        Word v[C];
        if constexpr (sizeof(Word) == 8) {
          v[0] = (Word)(((unsigned long long)a.y << 32) | a.x);
          v[1] = (Word)(((unsigned long long)a.w << 32) | a.z);
        } else {
          const uint32_t av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
          for (int c = 0; c < C; ++c) v[c] = (Word)av[c];
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          bool eq = j < q && r[j] == a.x;
#pragma unroll
          for (int c = 0; c < C; ++c) eq = eq && v[c] == row_word(rows + j * C + c);
          if (eq) atomicMin(&scratch[1 + j], i);
        }
      }
    }
    const unsigned next = i + S * step;
    if (next < end) copy_async<16>(slot0 + k * THREADS * 16, comps + (size_t)next * C);
    asm volatile("cp.async.commit_group;" ::: "memory");
    k = k + 1 == S ? 0 : k + 1;
  }
  wait_landed<0>();
  if (READ || EPI == 0) {
    if (acc == 0x5bd1e995u) out[0] = acc;          // keeps the loads
    return;
  }
  __syncthreads();
  if (EPI == 4) return;                            // the barrier alone
  if (EPI >= 6) {                                  // a relaxed ticket, then:
    if (threadIdx.x == 0) last = atomicAdd(&scratch[0], 1u) == gridDim.x - 1;
    __syncthreads();
    if (!last) return;
    unsigned* minima = scratch + (EPI == 6 ? 1 : 32);
    for (int j = threadIdx.x; j < q; j += THREADS) {
      unsigned m = NONE;
      if (EPI == 6 || EPI == 7) {                  // 6 the minima beside it, 7 a line apart
        m = atomicExch(&minima[j], NONE);
      } else if (EPI == 8) {                       // the same, plain loads and stores
        m = __ldcg(&minima[j]);
        minima[j] = NONE;
      }                                            // 9: no minima read
      out[j] = m == NONE ? (int64_t)n : (int64_t)m;
    }
    if (threadIdx.x == 0) scratch[0] = 0u;
    return;
  }
  if (threadIdx.x == 0) {
    if (EPI == 1) {
      last = ticket_acq_rel(&scratch[0]) == gridDim.x - 1;
    } else if (EPI == 3) {                         // a relaxed ticket alone
      if (atomicAdd(&scratch[0], 1u) == gridDim.x - 1) scratch[0] = 0u;
    } else {                                       // 32 group counters, then word 0
      const unsigned g = blockIdx.x % 32;
      const unsigned size = (gridDim.x - g + 31) / 32;
      unsigned* sub = scratch + 1 + MAX_ROWS + (EPI == 5 ? 32 * g : g);
      last = false;
      if (ticket_acq_rel(sub) == size - 1) {
        *sub = 0u;
        const unsigned groups = gridDim.x < 32 ? gridDim.x : 32;
        last = ticket_acq_rel(&scratch[0]) == groups - 1;
      }
    }
  }
  if (EPI == 3) return;
  __syncthreads();
  if (last) {
    for (int j = threadIdx.x; j < q; j += THREADS) {
      const unsigned m = atomicExch(&scratch[1 + j], NONE);
      out[j] = m == NONE ? (int64_t)n : (int64_t)m;
    }
    if (threadIdx.x == 0) scratch[0] = 0u;
  }
}

template <int C, class Word, int S, bool READ, bool CHUNK, int EPI = 1>
int ring_run(const void* comps, const void* rows, int64_t* out, unsigned* scratch, int n,
             int q, int blocks, cudaStream_t s, int* resident) {
  const size_t shared = (size_t)S * THREADS * 16;
  cudaFuncSetAttribute(ring_kernel<C, Word, S, READ, CHUNK, EPI>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shared);
  if (resident) {
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        resident, ring_kernel<C, Word, S, READ, CHUNK, EPI>, THREADS, shared);
  }
  ring_kernel<C, Word, S, READ, CHUNK, EPI><<<blocks, THREADS, shared, s>>>(
      static_cast<const Word*>(comps), static_cast<const Word*>(rows), out, scratch,
      (unsigned)n, q);
  return (int)cudaGetLastError();
}

// a ring in registers: S elements in flight a thread as in ring_kernel, each
// slot a register set loaded by __ldcs and refilled right after its
// compare (the loop unrolled by S so that every slot is static); READ only
// consumes them; else the port's compare, confirm and warp-0 epilogue
// (a relaxed ticket, a release one where the block took a minimum)
__device__ __forceinline__ unsigned ticket_relaxed(unsigned* p, bool release) {
  unsigned old;
  if (release) {
    asm volatile("atom.release.gpu.global.add.u32 %0, [%1], 1;" : "=r"(old) : "l"(p) : "memory");
  } else {
    asm volatile("atom.relaxed.gpu.global.add.u32 %0, [%1], 1;" : "=r"(old) : "l"(p) : "memory");
  }
  return old;
}

template <int C, class Word, int S, bool READ>
__global__ void __launch_bounds__(THREADS)
    rring_kernel(const Word* __restrict__ comps, const Word* __restrict__ rows,
                 int64_t* __restrict__ out, unsigned* __restrict__ scratch, unsigned n, int q) {
  const unsigned step = gridDim.x * THREADS;
  const unsigned first = blockIdx.x * THREADS + threadIdx.x;
  uint32_t r[8];
  if (!READ) {
#pragma unroll
    for (int j = 0; j < 8; ++j) r[j] = pre(row_word(rows + (j < q ? j : 0) * C));
  }
  Word v[S][C];
#pragma unroll
  for (int k = 0; k < S; ++k) {
    if (first + k * step < n) load<C>(comps, first + k * step, v[k]);
  }
  bool touched = false;
  Word acc = 0;
  for (unsigned i = first; i < n; i += S * step) {
#pragma unroll
    for (int k = 0; k < S; ++k) {
      const unsigned e = i + k * step;
      if (e < n) {
        if (READ) {
#pragma unroll
          for (int c = 0; c < C; ++c) acc ^= v[k][c];
        } else {
          const uint32_t x = pre(v[k][0]);
          bool hit = false;
#pragma unroll
          for (int j = 0; j < 8; ++j) hit |= x == r[j];
          if (hit) {
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              bool eq = j < q && r[j] == x;
#pragma unroll
              for (int c = 0; c < C; ++c) eq = eq && v[k][c] == row_word(rows + j * C + c);
              if (eq) {
                atomicMin(&scratch[1 + j], e);
                touched = true;
              }
            }
          }
        }
        const unsigned nx = e + S * step;
        if (nx < n) load<C>(comps, nx, v[k]);
      }
    }
  }
  if (READ) {
    if (acc == (Word)0x5bd1e995) out[0] = (int64_t)acc;     // keeps the loads
    return;
  }
  const bool took = __syncthreads_or(touched);
  if (threadIdx.x >= 32) return;
  unsigned t = 0;
  if (threadIdx.x == 0) t = ticket_relaxed(&scratch[0], took);
  if (__shfl_sync(0xFFFFFFFFu, t, 0) != gridDim.x - 1) return;
  asm volatile("fence.acq_rel.gpu;" ::: "memory");
  for (int j = threadIdx.x; j < q; j += 32) {
    const unsigned m = atomicExch(&scratch[1 + j], NONE);
    out[j] = m == NONE ? (int64_t)n : (int64_t)m;
  }
  if (threadIdx.x == 0) scratch[0] = 0u;
}

template <int C, class Word, int S, bool READ>
int rring_run(const void* comps, const void* rows, int64_t* out, unsigned* scratch, int n,
              int q, int blocks, cudaStream_t s, int* resident) {
  if (resident) {
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        resident, rring_kernel<C, Word, S, READ>, THREADS, 0);
  }
  rring_kernel<C, Word, S, READ><<<blocks, THREADS, 0, s>>>(
      static_cast<const Word*>(comps), static_cast<const Word*>(rows), out, scratch,
      (unsigned)n, q);
  return (int)cudaGetLastError();
}

// variant: 0 S 4, 1 S 8, 2 S 16 (the compare and the ticket), 3 S 8 read
// only, 4 S 8 chunked, 5 S 8 chunked read only, 6 S 8 the compare and no
// epilogue (no result), 7 S 8 and 8 S 4 the ticket in two levels (32 group
// counters after the minima, then word 0), at S 4: 9 a relaxed ticket and
// no write-back (no result), 10 the barrier alone (no result), 11 the two
// levels with the group counters 128 bytes apart, 12 no epilogue (no result);
// a relaxed ticket, then the last block's minima: 13 by atomicExch beside
// the ticket, 14 by atomicExch a line apart (minima at word 32; timing
// only), 15 by plain loads and stores a line apart (timing only), 16 not
// read (no result); the ring in registers (rring_kernel): 17 S 4 and 18 S 8
// read only, 19 S 4 and 20 S 8 with the port's compare and epilogue
template <int C, class Word>
int ring_variant(int variant, const void* comps, const void* rows, int64_t* out,
                 unsigned* scratch, int n, int q, int blocks, cudaStream_t s, int* resident) {
  switch (variant) {
    case 0: return ring_run<C, Word, 4, false, false>(comps, rows, out, scratch, n, q, blocks, s, resident);
    case 1: return ring_run<C, Word, 8, false, false>(comps, rows, out, scratch, n, q, blocks, s, resident);
    case 2: return ring_run<C, Word, 16, false, false>(comps, rows, out, scratch, n, q, blocks, s, resident);
    case 3: return ring_run<C, Word, 8, true, false>(comps, rows, out, scratch, n, q, blocks, s, resident);
    case 4: return ring_run<C, Word, 8, false, true>(comps, rows, out, scratch, n, q, blocks, s, resident);
    case 5: return ring_run<C, Word, 8, true, true>(comps, rows, out, scratch, n, q, blocks, s, resident);
    case 6: return ring_run<C, Word, 8, false, false, 0>(comps, rows, out, scratch, n, q, blocks, s, resident);
    case 7: return ring_run<C, Word, 8, false, false, 2>(comps, rows, out, scratch, n, q, blocks, s, resident);
    case 8: return ring_run<C, Word, 4, false, false, 2>(comps, rows, out, scratch, n, q, blocks, s, resident);
    case 9: return ring_run<C, Word, 4, false, false, 3>(comps, rows, out, scratch, n, q, blocks, s, resident);
    case 10: return ring_run<C, Word, 4, false, false, 4>(comps, rows, out, scratch, n, q, blocks, s, resident);
    case 11: return ring_run<C, Word, 4, false, false, 5>(comps, rows, out, scratch, n, q, blocks, s, resident);
    case 12: return ring_run<C, Word, 4, false, false, 0>(comps, rows, out, scratch, n, q, blocks, s, resident);
    case 13: return ring_run<C, Word, 4, false, false, 6>(comps, rows, out, scratch, n, q, blocks, s, resident);
    case 14: return ring_run<C, Word, 4, false, false, 7>(comps, rows, out, scratch, n, q, blocks, s, resident);
    case 15: return ring_run<C, Word, 4, false, false, 8>(comps, rows, out, scratch, n, q, blocks, s, resident);
    case 16: return ring_run<C, Word, 4, false, false, 9>(comps, rows, out, scratch, n, q, blocks, s, resident);
    case 17: return rring_run<C, Word, 4, true>(comps, rows, out, scratch, n, q, blocks, s, resident);
    case 18: return rring_run<C, Word, 8, true>(comps, rows, out, scratch, n, q, blocks, s, resident);
    case 19: return rring_run<C, Word, 4, false>(comps, rows, out, scratch, n, q, blocks, s, resident);
    case 20: return rring_run<C, Word, 8, false>(comps, rows, out, scratch, n, q, blocks, s, resident);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <int C, class Word, int U>
int read_launch(const void* comps, long long* sink, int n, int blocks, cudaStream_t s) {
  probe_read<C, Word, U><<<blocks, THREADS, 0, s>>>(static_cast<const Word*>(comps), sink, n);
  return (int)cudaGetLastError();
}

template <int C, class Word, int U>
int read_occupancy() {
  int k = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&k, probe_read<C, Word, U>, THREADS, 0)
      != cudaSuccess) {
    return -1;
  }
  return k;
}

template <int C, class Word>
int read_dispatch(const void* comps, long long* sink, int n, int U, int blocks,
                  cudaStream_t s) {
  switch (U) {
    case 4: return read_launch<C, Word, 4>(comps, sink, n, blocks, s);
    case 8: return read_launch<C, Word, 8>(comps, sink, n, blocks, s);
    case 16: return read_launch<C, Word, 16>(comps, sink, n, blocks, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <int C, class Word>
int occupancy_dispatch(int U) {
  switch (U) {
    case 4: return read_occupancy<C, Word, 4>();
    case 8: return read_occupancy<C, Word, 8>();
    case 16: return read_occupancy<C, Word, 16>();
    default: return -1;
  }
}

template <int C, class Word>
int v0_launch(const void* comps, const void* rows, int64_t* out, unsigned* scratch, int n,
              int q, int blocks, int hoist, long long* trace, cudaStream_t s) {
  const size_t shared = (size_t)q * C * sizeof(Word) + (size_t)q * sizeof(unsigned);
  const Word* c = static_cast<const Word*>(comps);
  const Word* r = static_cast<const Word*>(rows);
  if (trace) {
    if (hoist) {
      v0_kernel<C, Word, true, true><<<blocks, THREADS, shared, s>>>(c, r, out, scratch, n,
                                                                     q, trace);
    } else {
      v0_kernel<C, Word, false, true><<<blocks, THREADS, shared, s>>>(c, r, out, scratch, n,
                                                                      q, trace);
    }
  } else if (hoist) {
    v0_kernel<C, Word, true, false><<<blocks, THREADS, shared, s>>>(c, r, out, scratch, n, q,
                                                                    nullptr);
  } else {
    v0_kernel<C, Word, false, false><<<blocks, THREADS, shared, s>>>(c, r, out, scratch, n,
                                                                     q, nullptr);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// word: 4 (BabyBear int32) or 8 (Goldilocks int64); C 1, 2 or 4
extern "C" int probe_empty_launch(int blocks, void* stream) {
  probe_empty<<<blocks, THREADS, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

extern "C" int probe_read_launch(const void* comps, long long* sink, int n, int C, int word,
                                 int U, int blocks, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (word == 8) {
    switch (C) {
      case 1: return read_dispatch<1, int64_t>(comps, sink, n, U, blocks, s);
      case 2: return read_dispatch<2, int64_t>(comps, sink, n, U, blocks, s);
      case 4: return read_dispatch<4, int64_t>(comps, sink, n, U, blocks, s);
    }
  } else if (word == 4) {
    switch (C) {
      case 1: return read_dispatch<1, int32_t>(comps, sink, n, U, blocks, s);
      case 2: return read_dispatch<2, int32_t>(comps, sink, n, U, blocks, s);
      case 4: return read_dispatch<4, int32_t>(comps, sink, n, U, blocks, s);
    }
  }
  return (int)cudaErrorInvalidValue;
}

// resident blocks an SM of probe_read<C, word, U>; -1 on a bad argument
extern "C" int probe_read_occupancy(int C, int word, int U) {
  if (word == 8) {
    switch (C) {
      case 1: return occupancy_dispatch<1, int64_t>(U);
      case 2: return occupancy_dispatch<2, int64_t>(U);
      case 4: return occupancy_dispatch<4, int64_t>(U);
    }
  } else if (word == 4) {
    switch (C) {
      case 1: return occupancy_dispatch<1, int32_t>(U);
      case 2: return occupancy_dispatch<2, int32_t>(U);
      case 4: return occupancy_dispatch<4, int32_t>(U);
    }
  }
  return -1;
}

// the pre-redesign search; trace: null, or blocks x TRACE_WORDS int64
extern "C" int probe_v0_launch(const void* comps, const void* rows, int64_t* out,
                               unsigned* scratch, int n, int q, int C, int word, int blocks,
                               int hoist, long long* trace, void* stream) {
  if (n < 1 || q < 1 || q > MAX_ROWS) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (word == 8) {
    switch (C) {
      case 1: return v0_launch<1, int64_t>(comps, rows, out, scratch, n, q, blocks, hoist, trace, s);
      case 2: return v0_launch<2, int64_t>(comps, rows, out, scratch, n, q, blocks, hoist, trace, s);
      case 4: return v0_launch<4, int64_t>(comps, rows, out, scratch, n, q, blocks, hoist, trace, s);
    }
  } else if (word == 4) {
    switch (C) {
      case 1: return v0_launch<1, int32_t>(comps, rows, out, scratch, n, q, blocks, hoist, trace, s);
      case 2: return v0_launch<2, int32_t>(comps, rows, out, scratch, n, q, blocks, hoist, trace, s);
      case 4: return v0_launch<4, int32_t>(comps, rows, out, scratch, n, q, blocks, hoist, trace, s);
    }
  }
  return (int)cudaErrorInvalidValue;
}

// the redesign's candidates at q <= 8, GL Fp2 (word 8, C 2) or BB Fp4 (word
// 4, C 4); resident: non-null asks for the blocks an SM holds instead
extern "C" int probe_v1_launch(int variant, const void* comps, const void* rows, int64_t* out,
                               unsigned* scratch, int n, int q, int C, int word, int blocks,
                               long long* trace, void* stream, int* resident) {
  if (n < 1 || q < 1 || q > 8) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (word == 8 && C == 2) {
    return v1_variant<2, int64_t>(variant, comps, rows, out, scratch, n, q, blocks, trace, s,
                                  resident);
  }
  if (word == 4 && C == 4) {
    return v1_variant<4, int32_t>(variant, comps, rows, out, scratch, n, q, blocks, trace, s,
                                  resident);
  }
  return (int)cudaErrorInvalidValue;
}

// the ring design's knobs at q <= 8, GL Fp2 or BB Fp4; resident as above
extern "C" int probe_ring_launch(int variant, const void* comps, const void* rows, int64_t* out,
                                 unsigned* scratch, int n, int q, int C, int word, int blocks,
                                 void* stream, int* resident) {
  if (n < 1 || q < 1 || q > 8) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (word == 8 && C == 2) {
    return ring_variant<2, int64_t>(variant, comps, rows, out, scratch, n, q, blocks, s, resident);
  }
  if (word == 4 && C == 4) {
    return ring_variant<4, int32_t>(variant, comps, rows, out, scratch, n, q, blocks, s, resident);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* ms_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
