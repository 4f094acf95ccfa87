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
//   fmt 2: "QuadExtField(QuadExtField(<c00> + <c01> * u) + "
//          "QuadExtField(<c10> + <c11> * u) * u)"   (a BabyBear Fp4 element)
//
// max_digits is the caller's, chosen by field (20 for Goldilocks, 10 for
// BabyBear, whose values lie below 2^31): with 10 the digits come from the
// low 32 bits by a 32-bit divide-by-10 ladder, as the JAX package's
// max_digits == 10 path reads only the low word. The kernel never chooses
// the path by value.
//
// Bound on the H100: integer ALU throughput (up to 4 compressions, and 20 or
// 10 divide-by-10 steps per component, for 8-32 bytes read per element).
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

  // v in decimal: 64-bit ladder (up to 20 digits) or, for max_digits 10,
  // the 32-bit ladder over the low word
  __device__ void put_dec(uint64_t v, int max_digits) {
    uint8_t d[20];
    int n = 0;
    if (max_digits == 10) {
      uint32_t w = (uint32_t)v;
      do {
        d[n++] = (uint8_t)('0' + w % 10u);
        w /= 10u;
      } while (w);
    } else {
      do {
        d[n++] = (uint8_t)('0' + v % 10);
        v /= 10;
      } while (v);
    }
    while (n) put(d[--n]);
  }

  __device__ void finish() {
    // the bit length goes into the last word; a group's preimage is at most
    // a few hundred bytes (fmt 2, 2 per group: 206), far below 2^29
    const uint32_t bits = total * 8;
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

__device__ void put_quad(Hasher& h, const uint64_t* c, int md) {
  h.put_str("QuadExtField(", 13);
  h.put_dec(c[0], md);
  h.put_str(" + ", 3);
  h.put_dec(c[1], md);
  h.put_str(" * u)", 5);
}

__global__ void leaf_hash(const uint64_t* __restrict__ comps,
                          uint32_t* __restrict__ out, int n_groups, int k,
                          int fmt, int md) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= n_groups) return;
  const int per = fmt == 0 ? 1 : (fmt == 1 ? 2 : 4);
  const uint64_t* src = comps + (size_t)g * k * per;
  Hasher h;
  h.init();
  for (int e = 0; e < k; ++e, src += per) {
    if (fmt == 0) {
      h.put_dec(src[0], md);
    } else if (fmt == 1) {
      put_quad(h, src, md);
    } else {
      h.put_str("QuadExtField(", 13);
      put_quad(h, src, md);
      h.put_str(" + ", 3);
      put_quad(h, src + 2, md);
      h.put_str(" * u)", 5);
    }
  }
  h.finish();
  uint32_t* dst = out + (size_t)g * 8;
#pragma unroll
  for (int i = 0; i < 8; ++i) dst[i] = h.st[i];
}

}  // namespace

// comps: (n_groups * k, 1 / 2 / 4 for fmt 0 / 1 / 2) u64 components; out:
// (n_groups, 8); max_digits: 20 (u64 values) or 10 (values below 2^32).
extern "C" int ms_leaf_hash(const uint64_t* comps, uint32_t* out, int n_groups,
                            int k, int fmt, int max_digits, void* stream) {
  if (n_groups < 1 || k < 1 || fmt < 0 || fmt > 2 ||
      (max_digits != 10 && max_digits != 20)) {
    return (int)cudaErrorInvalidValue;
  }
  const int blocks = (n_groups + THREADS - 1) / THREADS;
  leaf_hash<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(comps, out, n_groups,
                                                          k, fmt, max_digits);
  return (int)cudaGetLastError();
}
