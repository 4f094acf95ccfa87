// Fixed-length SHA-256 for the Merkle trees: inner levels at fan 2/4/8
// and the fast mode's binary row leaves.
//
// Replaces the Pallas kernel ministark_tpu/ops/sha256_pallas.py::_make_kernel
// as reached through inner_level_tr (any fan) and row_digests_tr /
// build_digests_tr (ministark_tpu/commit/index_tree.py::_build_digests).
// Every message of one launch has the same length, so no lane masks:
//
//   inner level  one thread per parent compresses the fan/2 blocks of its
//                concatenated child digests, then the constant padding block
//                of a fan*32-byte message (its words are immediates; the fan
//                is a template argument, so every loop unrolls)
//   row leaves   one thread per row reads its C u64 components; word 2k is
//                bswap32(lo_k), word 2k+1 bswap32(hi_k) (the raw little-endian
//                bytes as big-endian SHA words), then 0x80000000, zeros and
//                the 64-bit bit length; (8C + 9 + 63) / 64 blocks, C at run time.
//                ms_sha256_rows_bb reads BabyBear's 32-bit components (int32
//                tensors): the same preimage, each component's high word 0
//
// Bound on the H100: integer ALU throughput (about 1.4k 32-bit operations per
// 64-byte block, against 64 bytes read). Rows are read one thread per row,
// C * 8 bytes apart, so loads are not coalesced; the L1 keeps each line until
// the warp's neighbouring rows use it.
#include <cuda_runtime.h>

#include "sha256.cuh"

namespace {

constexpr int THREADS = 128;

__device__ __forceinline__ uint32_t bswap32(uint32_t x) {
  return __byte_perm(x, 0, 0x0123);
}

template <int FAN>
__global__ void inner_level(const uint32_t* __restrict__ child,
                            uint32_t* __restrict__ parent, int n_parents) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n_parents) return;
  const uint32_t* src = child + (size_t)p * 8 * FAN;
  uint32_t st[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) st[i] = sha::H0[i];
#pragma unroll
  for (int b = 0; b < FAN / 2; ++b) {
    uint32_t m[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) m[i] = src[b * 16 + i];
    sha::compress(st, m);
  }
  uint32_t pad[16] = {0x80000000u, 0, 0, 0, 0, 0, 0, 0,
                      0,           0, 0, 0, 0, 0, 0, FAN * 32 * 8};
  sha::compress(st, pad);
  uint32_t* dst = parent + (size_t)p * 8;
#pragma unroll
  for (int i = 0; i < 8; ++i) dst[i] = st[i];
}

template <class Word>
__global__ void row_digests(const Word* __restrict__ comps,
                            uint32_t* __restrict__ digests, int n_rows, int C) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n_rows) return;
  const Word* src = comps + (size_t)r * C;
  const uint64_t bits = (uint64_t)C * 64;
  const int n_blocks = (8 * C + 9 + 63) / 64;
  uint32_t st[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) st[i] = sha::H0[i];
  for (int b = 0; b < n_blocks; ++b) {
    uint32_t m[16];
#pragma unroll
    for (int j = 0; j < 8; ++j) {  // component b * 8 + j fills words 2j, 2j+1
      const int k = b * 8 + j;
      if (k < C) {
        const uint64_t v = src[k];
        m[2 * j] = bswap32((uint32_t)v);
        m[2 * j + 1] = bswap32((uint32_t)(v >> 32));
      } else {
        m[2 * j] = k == C ? 0x80000000u : 0u;
        m[2 * j + 1] = 0;
      }
    }
    // n_blocks leaves room for the length after the 0x80 byte
    if (b == n_blocks - 1) {
      m[14] = (uint32_t)(bits >> 32);
      m[15] = (uint32_t)bits;
    }
    sha::compress(st, m);
  }
  uint32_t* dst = digests + (size_t)r * 8;
#pragma unroll
  for (int i = 0; i < 8; ++i) dst[i] = st[i];
}

}  // namespace

// child: (fan * n_parents, 8) digests; parent: (n_parents, 8).
extern "C" int ms_sha256_inner_level(const uint32_t* child, uint32_t* parent,
                                     int n_parents, int fan, void* stream) {
  if (n_parents < 1) return (int)cudaErrorInvalidValue;
  const int blocks = (n_parents + THREADS - 1) / THREADS;
  cudaStream_t s = (cudaStream_t)stream;
  switch (fan) {
    case 2: inner_level<2><<<blocks, THREADS, 0, s>>>(child, parent, n_parents); break;
    case 4: inner_level<4><<<blocks, THREADS, 0, s>>>(child, parent, n_parents); break;
    case 8: inner_level<8><<<blocks, THREADS, 0, s>>>(child, parent, n_parents); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// comps: (n_rows, C) u64 components; digests: (n_rows, 8).
extern "C" int ms_sha256_rows(const uint64_t* comps, uint32_t* digests,
                              int n_rows, int C, void* stream) {
  if (n_rows < 1 || C < 1) return (int)cudaErrorInvalidValue;
  const int blocks = (n_rows + THREADS - 1) / THREADS;
  row_digests<uint64_t><<<blocks, THREADS, 0, (cudaStream_t)stream>>>(comps, digests,
                                                                     n_rows, C);
  return (int)cudaGetLastError();
}

// comps: (n_rows, C) BabyBear components, 32-bit words; digests: (n_rows, 8).
extern "C" int ms_sha256_rows_bb(const uint32_t* comps, uint32_t* digests,
                                 int n_rows, int C, void* stream) {
  if (n_rows < 1 || C < 1) return (int)cudaErrorInvalidValue;
  const int blocks = (n_rows + THREADS - 1) / THREADS;
  row_digests<uint32_t><<<blocks, THREADS, 0, (cudaStream_t)stream>>>(comps, digests,
                                                                     n_rows, C);
  return (int)cudaGetLastError();
}

extern "C" const char* ms_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
