// out = x + 1 over 32-bit words, with wraparound: the streaming probe.
//
// Replaces the Pallas kernel scripts/pallas_stream_probe.py::_copy_kernel
// (out = x + 1 over a (16384, 4096) uint32 array, one block of rows per grid
// step), which asks how fast a hand-written kernel can stream device
// memory. Bound on the H100: bytes alone (4 read and 4 written per word
// against one add). Each thread moves 16-byte vectors, neighbouring threads
// neighbouring vectors, grid-stride; the launch shape (threads per block,
// vectors per thread) is the caller's, so the probe can walk it. The add is
// unsigned, so 0xFFFFFFFF + 1 wraps to 0 (int32 storage: 2^31 - 1 -> -2^31).
#include <cuda_runtime.h>

#include <cstdint>

namespace {

__global__ void stream_add1_kernel(const uint32_t* __restrict__ x,
                                   uint32_t* __restrict__ out, int64_t n) {
  const int64_t n4 = n / 4;
  const uint4* x4 = reinterpret_cast<const uint4*>(x);
  uint4* o4 = reinterpret_cast<uint4*>(out);
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  const int64_t first = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  for (int64_t i = first; i < n4; i += step) {
    uint4 v = x4[i];
    v.x += 1u;
    v.y += 1u;
    v.z += 1u;
    v.w += 1u;
    o4[i] = v;
  }
  // the last n % 4 words
  const int64_t tail = 4 * n4 + first;
  if (tail < n) out[tail] = x[tail] + 1u;
}

}  // namespace

// x, out: n 32-bit words, 16-byte aligned; threads: a multiple of 32 up to
// 1024; per_thread: 16-byte vectors each thread moves (sets the grid).
extern "C" int ms_stream_add1(const uint32_t* x, uint32_t* out, int64_t n, int threads,
                              int per_thread, void* stream) {
  if (n < 1 || threads < 32 || threads > 1024 || threads % 32 || per_thread < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const int64_t per_block = (int64_t)threads * per_thread;
  int64_t blocks = (n / 4 + per_block - 1) / per_block;
  if (blocks < 1) blocks = 1;
  if (blocks > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
  stream_add1_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(x, out, n);
  return (int)cudaGetLastError();
}
