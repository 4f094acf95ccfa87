// out = x + 1 over 32-bit words, with wraparound: the streaming probe.
//
// Replaces the Pallas kernel scripts/pallas_stream_probe.py::_copy_kernel
// (out = x + 1 over a (16384, 4096) uint32 array, one block of rows per grid
// step), which asks how fast a hand-written kernel can stream device
// memory. Bound on the H100: bytes alone (4 read and 4 written per word
// against one add). So each thread keeps V 16-byte loads in flight: a block
// takes a group of threads x V vectors (neighbouring threads on
// neighbouring vectors), and each thread issues all V loads of its group
// before its first add and store, with streaming cache hints (__ldcs /
// __stcs: the data is touched once). The grid is one group a block (whole
// waves of resident blocks walking the groups read 4-6% slower on the H100:
// PERF.md, row P1). The launch shape (threads per block, V vectors per
// thread) is the caller's, so the probe can walk it. The add is unsigned,
// so 0xFFFFFFFF + 1 wraps to 0 (int32 storage: 2^31 - 1 -> -2^31).
#include <cuda_runtime.h>

#include <cstdint>

namespace {

template <int V>
__global__ void __launch_bounds__(1024)
    stream_add1_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ out,
                       int64_t n) {
  const int64_t n4 = n / 4;
  const uint4* x4 = reinterpret_cast<const uint4*>(x);
  uint4* o4 = reinterpret_cast<uint4*>(out);
  const int64_t base = (int64_t)blockIdx.x * blockDim.x * V + threadIdx.x;
  uint4 v[V];
  if (base + (V - 1) * (int64_t)blockDim.x < n4) {  // the whole group
#pragma unroll
    for (int j = 0; j < V; ++j) v[j] = __ldcs(x4 + base + j * blockDim.x);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      v[j].x += 1u;
      v[j].y += 1u;
      v[j].z += 1u;
      v[j].w += 1u;
      __stcs(o4 + base + j * blockDim.x, v[j]);
    }
  } else {                                         // the last, partial one
#pragma unroll
    for (int j = 0; j < V; ++j) {
      if (base + j * blockDim.x < n4) v[j] = __ldcs(x4 + base + j * blockDim.x);
    }
#pragma unroll
    for (int j = 0; j < V; ++j) {
      if (base + j * blockDim.x < n4) {
        v[j].x += 1u;
        v[j].y += 1u;
        v[j].z += 1u;
        v[j].w += 1u;
        __stcs(o4 + base + j * blockDim.x, v[j]);
      }
    }
  }
  // the last n % 4 words
  if (blockIdx.x == 0 && threadIdx.x < n - 4 * n4) {
    out[4 * n4 + threadIdx.x] = x[4 * n4 + threadIdx.x] + 1u;
  }
}

template <int V>
int launch(const uint32_t* x, uint32_t* out, int64_t n, int threads,
           cudaStream_t stream) {
  const int64_t group = (int64_t)threads * V;
  int64_t blocks = (n / 4 + group - 1) / group;  // one group a block
  if (blocks < 1) blocks = 1;
  if (blocks > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
  stream_add1_kernel<V><<<(unsigned)blocks, threads, 0, stream>>>(x, out, n);
  return (int)cudaGetLastError();
}

}  // namespace

// x, out: n 32-bit words, 16-byte aligned; threads: a multiple of 32 up to
// 1024; per_thread: 16-byte vectors each thread keeps in flight (1, 2, 4 or
// 8: registers, at most 64 a thread at 1024 threads); the grid is one group
// of threads x per_thread vectors a block.
extern "C" int ms_stream_add1(const uint32_t* x, uint32_t* out, int64_t n, int threads,
                              int per_thread, void* stream) {
  if (n < 1 || threads < 32 || threads > 1024 || threads % 32) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  switch (per_thread) {
    case 1: return launch<1>(x, out, n, threads, s);
    case 2: return launch<2>(x, out, n, threads, s);
    case 4: return launch<4>(x, out, n, threads, s);
    case 8: return launch<8>(x, out, n, threads, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
