// Fan-2 Merkle inner level: parent = SHA-256(left digest || right digest).
//
// Replaces the Pallas kernel ministark_tpu/ops/sha256_pallas.py::_make_kernel
// as reached through inner_level_tr with fan 2. One thread per parent reads
// the 16 big-endian words of its two children, compresses them, then
// compresses the constant padding block of a 64-byte message, whose words
// are immediates. Bound on the H100: integer ALU throughput (two 64-round
// compressions per 96 bytes moved).
#include <cuda_runtime.h>

#include "sha256.cuh"

namespace {

constexpr int THREADS = 256;

__global__ void inner_level(const uint32_t* __restrict__ child,
                            uint32_t* __restrict__ parent, int n_parents) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n_parents) return;
  uint32_t m[16];
  const uint32_t* src = child + (size_t)p * 16;
#pragma unroll
  for (int i = 0; i < 16; ++i) m[i] = src[i];
  uint32_t st[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) st[i] = sha::H0[i];
  sha::compress(st, m);
  uint32_t pad[16] = {0x80000000u, 0, 0, 0, 0, 0, 0, 0,
                      0,           0, 0, 0, 0, 0, 0, 64 * 8};
  sha::compress(st, pad);
  uint32_t* dst = parent + (size_t)p * 8;
#pragma unroll
  for (int i = 0; i < 8; ++i) dst[i] = st[i];
}

}  // namespace

// child: (2 * n_parents, 8) digests; parent: (n_parents, 8).
extern "C" int ms_sha256_inner_level(const uint32_t* child, uint32_t* parent,
                                     int n_parents, void* stream) {
  if (n_parents < 1) return (int)cudaErrorInvalidValue;
  const int blocks = (n_parents + THREADS - 1) / THREADS;
  inner_level<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(child, parent,
                                                            n_parents);
  return (int)cudaGetLastError();
}

extern "C" const char* ms_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
