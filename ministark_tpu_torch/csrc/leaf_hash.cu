// Merkle leaf hash: SHA-256 over the decimal Display strings of a group of
// field elements (src/merkle.rs:162-168).
//
// Replaces the Pallas kernel ministark_tpu/ops/sha256_pallas.py::
// _make_masked_kernel together with the XLA digit extraction and byte
// placement that fed it (ministark_tpu/ops/leaf_hash.py:87, :243-304). One
// thread per leaf group reads the group's u64 components, writes the decimal
// digits and the constant segments of its format into a 64-byte block
// buffer, compresses whenever the buffer fills, pads (0x80, zeros, 64-bit
// big-endian bit length) and stores 8 big-endian words:
//
//   fmt 0: "<c0>"                              (a base-field element)
//   fmt 1: "QuadExtField(<c0> + <c1> * u)"     (an Fp2 element)
//
// Bound on the H100: integer ALU throughput (at most 3 compressions and 20
// divide-by-10 steps per component for 8-16 bytes read per element).
#include <cuda_runtime.h>

#include "sha256.cuh"

namespace {

constexpr int THREADS = 128;

// the compression is called from several places; keep one copy of its code
__device__ __noinline__ void compress_block(uint32_t st[8], uint32_t m[16]) {
  sha::compress(st, m);
#pragma unroll
  for (int i = 0; i < 16; ++i) m[i] = 0;
}

struct Hasher {
  uint32_t st[8];
  uint32_t m[16];
  int pos;         // bytes in the current block
  uint32_t total;  // message bytes so far

  __device__ void init() {
#pragma unroll
    for (int i = 0; i < 8; ++i) st[i] = sha::H0[i];
#pragma unroll
    for (int i = 0; i < 16; ++i) m[i] = 0;
    pos = 0;
    total = 0;
  }

  __device__ void raw(uint32_t byte) {
    m[pos >> 2] |= byte << (24 - 8 * (pos & 3));
    if (++pos == 64) {
      compress_block(st, m);
      pos = 0;
    }
  }

  __device__ void put(uint32_t byte) {
    raw(byte);
    ++total;
  }

  __device__ void put_str(const char* str, int len) {
    for (int i = 0; i < len; ++i) put((uint8_t)str[i]);
  }

  __device__ void put_dec(uint64_t v) {
    uint8_t d[20];
    int n = 0;
    do {
      d[n++] = (uint8_t)('0' + v % 10);
      v /= 10;
    } while (v);
    while (n) put(d[--n]);
  }

  __device__ void finish() {
    const uint32_t bits = total * 8;  // total <= 120 bytes here
    raw(0x80);
    if (pos > 56) {
      compress_block(st, m);
      pos = 0;
    }
    m[14] = 0;
    m[15] = bits;
    compress_block(st, m);
  }
};

__global__ void leaf_hash(const uint64_t* __restrict__ comps,
                          uint32_t* __restrict__ out, int n_groups, int k,
                          int fmt) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= n_groups) return;
  Hasher h;
  h.init();
  if (fmt == 0) {
    const uint64_t* src = comps + (size_t)g * k;
    for (int e = 0; e < k; ++e) h.put_dec(src[e]);
  } else {
    const uint64_t* src = comps + (size_t)g * k * 2;
    for (int e = 0; e < k; ++e) {
      h.put_str("QuadExtField(", 13);
      h.put_dec(src[2 * e]);
      h.put_str(" + ", 3);
      h.put_dec(src[2 * e + 1]);
      h.put_str(" * u)", 5);
    }
  }
  h.finish();
  uint32_t* dst = out + (size_t)g * 8;
#pragma unroll
  for (int i = 0; i < 8; ++i) dst[i] = h.st[i];
}

}  // namespace

// comps: (n_groups * k, fmt ? 2 : 1) u64 components; out: (n_groups, 8).
extern "C" int ms_leaf_hash_gl(const uint64_t* comps, uint32_t* out,
                               int n_groups, int k, int fmt, void* stream) {
  if (n_groups < 1 || k < 1 || (fmt != 0 && fmt != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  const int blocks = (n_groups + THREADS - 1) / THREADS;
  leaf_hash<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(comps, out, n_groups,
                                                          k, fmt);
  return (int)cudaGetLastError();
}
