// Merkle leaf hash: SHA-256 over the decimal Display strings of a group of
// field elements (src/merkle.rs:162-168).
//
// Replaces the Pallas kernel ministark_tpu/ops/sha256_pallas.py::
// _make_masked_kernel together with the XLA digit extraction and byte
// placement that fed it (ministark_tpu/ops/leaf_hash.py:87, :243-304). One
// lane per leaf group hashes the group's preimage:
//
//   fmt 0: "<c0>"                              (a base-field element)
//   fmt 1: "QuadExtField(<c0> + <c1> * u)"     (an Fp2 element)
//   fmt 2: "QuadExtField(QuadExtField(<c00> + <c01> * u) + "
//          "QuadExtField(<c10> + <c11> * u) * u)"   (a BabyBear Fp4 element)
//
// max_digits is the caller's, chosen by field (20 for Goldilocks, 10 for
// BabyBear, whose values lie below 2^31): with 10 the digits come from the
// low 32 bits, as the JAX package's max_digits == 10 path reads only the low
// word. The kernel never chooses the path by value.
//
// Bound on the H100: integer ALU throughput (one SHA-256 compression, ~1,370
// operations, per 64-byte block, and ~4 per decimal digit, for 8-32 bytes
// read per element). The design keeps that work in step across a warp and
// out of local memory:
//
// - A block stages its groups' components in shared memory with coalesced
//   loads; each lane then reads its own group's from there.
// - Lengths first: each component's digit count is known before its digits
//   are written, so the digits go least significant first straight to their
//   places (no digit buffer), and the message length, hence the block count,
//   is known before any compression.
// - Each lane writes its whole padded message into its column of a shared
//   word array laid out word-major ([word][lane]): word w of lane t is at
//   w * THREADS + t, so the 32 lanes of a warp always hit 32 different banks,
//   whatever their byte positions. Every write is a byte store at a run-time
//   position in shared memory, never an indexed register array.
// - Then one loop compresses block by block, each block's 16 words loaded at
//   compile-time indices into registers; a warp runs it once per block of its
//   longest lane, the shorter lanes masked at their end.
// - Digits: a u64 is split once by 10^10 (a 64-bit divide by a constant) and
//   the remainder by 10^5 on 32 bits, then 32-bit divide-by-10 ladders of at
//   most 10, 5 and 5 steps. The 10-digit path is one 32-bit ladder over the
//   low word.
#include <cuda_runtime.h>

#include "sha256.cuh"

namespace {

constexpr int THREADS = 128;  // lanes (leaf groups) per block
constexpr int MAX_SMEM = 227 * 1024;

// byte p of this lane's message: big-endian within each u32 word, so byte
// p & 3 of word p >> 2 is at byte offset 3 - (p & 3) of the little-endian
// word
__device__ __forceinline__ void put_byte(uint8_t* rows, int lane, int p,
                                         uint32_t c) {
  rows[(((p >> 2) * THREADS + lane) << 2) + (3 - (p & 3))] = (uint8_t)c;
}

template <int N>
__device__ __forceinline__ void put_str(uint8_t* rows, int lane, int& pos,
                                        const char (&s)[N]) {
#pragma unroll
  for (int i = 0; i < N - 1; ++i) put_byte(rows, lane, pos + i, (uint8_t)s[i]);
  pos += N - 1;
}

// decimal digits of x, at least 1
__device__ __forceinline__ int dec_len(uint32_t x) {
  return 1 + (x >= 10u) + (x >= 100u) + (x >= 1000u) + (x >= 10000u) +
         (x >= 100000u) + (x >= 1000000u) + (x >= 10000000u) +
         (x >= 100000000u) + (x >= 1000000000u);
}

// the n low decimal digits of x, ending just before byte `end`
__device__ __forceinline__ void put_digits(uint8_t* rows, int lane, int end,
                                           uint32_t x, int n) {
  for (int i = 1; i <= n; ++i) {
    const uint32_t q = x / 10u;
    put_byte(rows, lane, end - i, '0' + (x - q * 10u));
    x = q;
  }
}

template <int MD>
__device__ __forceinline__ void put_dec(uint8_t* rows, int lane, int& pos,
                                        uint64_t v) {
  if constexpr (MD == 10) {
    const uint32_t x = (uint32_t)v;
    const int n = dec_len(x);
    put_digits(rows, lane, pos + n, x, n);
    pos += n;
  } else {
    const uint64_t q = v / 10000000000ull;  // < 1.85e9: fits in 32 bits
    const uint64_t r = v - q * 10000000000ull;  // < 10^10 = 2^10 * 5^10
    // r / 10^5 = (r >> 5) / 3125, and (r >> 5) < 2^29
    const uint32_t rh = (uint32_t)(r >> 5) / 3125u;
    const uint32_t rl = (uint32_t)r - rh * 100000u;
    const int n = q ? 10 + dec_len((uint32_t)q) : (rh ? 5 + dec_len(rh) : dec_len(rl));
    const int end = pos + n;
    put_digits(rows, lane, end, rl, n < 5 ? n : 5);
    if (n > 5) put_digits(rows, lane, end - 5, rh, n < 10 ? n - 5 : 5);
    if (n > 10) put_digits(rows, lane, end - 10, (uint32_t)q, n - 10);
    pos = end;
  }
}

template <int MD>
__device__ __forceinline__ void put_quad(uint8_t* rows, int lane, int& pos,
                                         const uint64_t* c) {
  put_str(rows, lane, pos, "QuadExtField(");
  put_dec<MD>(rows, lane, pos, c[0]);
  put_str(rows, lane, pos, " + ");
  put_dec<MD>(rows, lane, pos, c[1]);
  put_str(rows, lane, pos, " * u)");
}

template <int FMT>
__host__ __device__ constexpr int comps_per_elem() {
  return FMT == 0 ? 1 : (FMT == 1 ? 2 : 4);
}

// dynamic shared memory: the block's components (THREADS * k * per u64),
// then nw message words per lane, word-major
template <int FMT, int MD>
__global__ void __launch_bounds__(THREADS)
    leaf_hash(const uint64_t* __restrict__ comps, uint4* __restrict__ out,
              int n_groups, int k, int nw) {
  extern __shared__ uint64_t smem[];
  constexpr int PER = comps_per_elem<FMT>();
  const int lane = threadIdx.x;
  const int g0 = blockIdx.x * THREADS;
  const int groups = min(THREADS, n_groups - g0);
  const int per_group = k * PER;
  uint64_t* cs = smem;
  uint32_t* words = reinterpret_cast<uint32_t*>(smem + THREADS * per_group);
  uint8_t* rows = reinterpret_cast<uint8_t*>(words);

  const uint64_t* src = comps + (size_t)g0 * per_group;
  for (int j = lane; j < groups * per_group; j += THREADS) cs[j] = src[j];
  for (int w = 0; w < nw; ++w) words[w * THREADS + lane] = 0;
  __syncthreads();
  if (lane >= groups) return;

  int pos = 0;
  const uint64_t* c = cs + lane * per_group;
  for (int e = 0; e < k; ++e, c += PER) {
    if constexpr (FMT == 0) {
      put_dec<MD>(rows, lane, pos, c[0]);
    } else if constexpr (FMT == 1) {
      put_quad<MD>(rows, lane, pos, c);
    } else {
      put_str(rows, lane, pos, "QuadExtField(");
      put_quad<MD>(rows, lane, pos, c);
      put_str(rows, lane, pos, " + ");
      put_quad<MD>(rows, lane, pos, c + 2);
      put_str(rows, lane, pos, " * u)");
    }
  }
  // padding: 0x80, zeros (the column was zeroed), and the bit length in the
  // last word of the last block; a group's preimage is at most a few hundred
  // bytes, so the length's high word is 0
  put_byte(rows, lane, pos, 0x80);
  const int nb = (pos + 8) / 64 + 1;
  words[(16 * nb - 1) * THREADS + lane] = (uint32_t)pos * 8u;

  uint32_t st[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) st[i] = sha::H0[i];
  for (int b = 0; b < nb; ++b) {
    uint32_t m[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) m[i] = words[(16 * b + i) * THREADS + lane];
    sha::compress(st, m);
  }
  uint4* dst = out + 2 * (size_t)(g0 + lane);
  dst[0] = make_uint4(st[0], st[1], st[2], st[3]);
  dst[1] = make_uint4(st[4], st[5], st[6], st[7]);
}

template <int FMT, int MD>
int launch(const uint64_t* comps, uint32_t* out, int n_groups, int k,
           cudaStream_t s) {
  constexpr int PER = comps_per_elem<FMT>();
  const int per_elem = (FMT == 0 ? 0 : (FMT == 1 ? 21 : 63)) + PER * MD;
  const int max_bytes = k * per_elem;
  const int nw = 16 * ((max_bytes + 8) / 64 + 1);
  const size_t smem = (size_t)THREADS * (k * PER * 8 + nw * 4);
  if (smem > (size_t)MAX_SMEM) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        leaf_hash<FMT, MD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = (n_groups + THREADS - 1) / THREADS;
  leaf_hash<FMT, MD><<<blocks, THREADS, smem, s>>>(
      comps, reinterpret_cast<uint4*>(out), n_groups, k, nw);
  return (int)cudaGetLastError();
}

}  // namespace

// comps: (n_groups * k, 1 / 2 / 4 for fmt 0 / 1 / 2) u64 components; out:
// (n_groups, 8), 16-byte aligned; max_digits: 20 (u64 values) or 10 (values
// below 2^32).
extern "C" int ms_leaf_hash(const uint64_t* comps, uint32_t* out, int n_groups,
                            int k, int fmt, int max_digits, void* stream) {
  if (n_groups < 1 || k < 1 || fmt < 0 || fmt > 2 ||
      (max_digits != 10 && max_digits != 20)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  if (max_digits == 20) {
    switch (fmt) {
      case 0: return launch<0, 20>(comps, out, n_groups, k, s);
      case 1: return launch<1, 20>(comps, out, n_groups, k, s);
      default: return launch<2, 20>(comps, out, n_groups, k, s);
    }
  }
  switch (fmt) {
    case 0: return launch<0, 10>(comps, out, n_groups, k, s);
    case 1: return launch<1, 10>(comps, out, n_groups, k, s);
    default: return launch<2, 10>(comps, out, n_groups, k, s);
  }
}
