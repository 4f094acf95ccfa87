// Native Merkle hashing engine for ministark_tpu.
//
// Implements the reference's exact hashing scheme (src/merkle.rs:162-177):
//   leaf-group digest = SHA-256 over concatenated ASCII-decimal Display
//   strings of the field elements in the group; inner digest = SHA-256 over
//   concatenated raw child digests.  Display formats:
//     fmt 0: base field           -> "123"                      (1 u64/elem)
//     fmt 1: quadratic extension  -> "QuadExtField(a + b * u)"  (2 u64/elem)
//     fmt 2: quartic (Fp4 over Fp2, BabyBear) ->
//            "QuadExtField(QuadExtField(a + b * u) + QuadExtField(c + d * u) * u)"
//                                                               (4 u64/elem)
//
// SHA-256 uses x86 SHA-NI when available (runtime-detected) with a portable
// scalar fallback; tree levels are built with a std::thread pool.
//
// Exposed via a C ABI consumed from Python with ctypes (commit/native.py).

#include <cstdint>
#include <cstring>
#include <cstdio>
#include <functional>
#include <string>
#include <thread>
#include <vector>

#if defined(__x86_64__)
#include <immintrin.h>
#include <cpuid.h>
#endif

namespace {

// ---------------------------------------------------------------- scalar sha
const uint32_t K[64] = {
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b, 0x59f111f1,
    0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
    0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174, 0xe49b69c1, 0xefbe4786,
    0x0fc19dc6, 0x240ca1cc, 0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
    0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147,
    0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
    0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85, 0xa2bfe8a1, 0xa81a664b,
    0xc24b8b70, 0xc76c51a3, 0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
    0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a,
    0x5b9cca4f, 0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
    0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2};

inline uint32_t rotr(uint32_t x, int n) { return (x >> n) | (x << (32 - n)); }

void sha256_compress_scalar(uint32_t state[8], const uint8_t* block) {
  uint32_t w[64];
  for (int i = 0; i < 16; i++)
    w[i] = (uint32_t(block[i * 4]) << 24) | (uint32_t(block[i * 4 + 1]) << 16) |
           (uint32_t(block[i * 4 + 2]) << 8) | uint32_t(block[i * 4 + 3]);
  for (int i = 16; i < 64; i++) {
    uint32_t s0 = rotr(w[i - 15], 7) ^ rotr(w[i - 15], 18) ^ (w[i - 15] >> 3);
    uint32_t s1 = rotr(w[i - 2], 17) ^ rotr(w[i - 2], 19) ^ (w[i - 2] >> 10);
    w[i] = w[i - 16] + s0 + w[i - 7] + s1;
  }
  uint32_t a = state[0], b = state[1], c = state[2], d = state[3];
  uint32_t e = state[4], f = state[5], g = state[6], h = state[7];
  for (int i = 0; i < 64; i++) {
    uint32_t S1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25);
    uint32_t ch = (e & f) ^ (~e & g);
    uint32_t t1 = h + S1 + ch + K[i] + w[i];
    uint32_t S0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22);
    uint32_t maj = (a & b) ^ (a & c) ^ (b & c);
    uint32_t t2 = S0 + maj;
    h = g; g = f; f = e; e = d + t1;
    d = c; c = b; b = a; a = t1 + t2;
  }
  state[0] += a; state[1] += b; state[2] += c; state[3] += d;
  state[4] += e; state[5] += f; state[6] += g; state[7] += h;
}

// ---------------------------------------------------------------- sha-ni
#if defined(__x86_64__)
__attribute__((target("sha,sse4.1")))
void sha256_compress_shani(uint32_t state[8], const uint8_t* block) {
  __m128i STATE0, STATE1, MSG, TMP, MSG0, MSG1, MSG2, MSG3;
  const __m128i MASK =
      _mm_set_epi64x(0x0c0d0e0f08090a0bULL, 0x0405060700010203ULL);

  TMP = _mm_loadu_si128((const __m128i*)&state[0]);
  STATE1 = _mm_loadu_si128((const __m128i*)&state[4]);
  TMP = _mm_shuffle_epi32(TMP, 0xB1);          // CDAB
  STATE1 = _mm_shuffle_epi32(STATE1, 0x1B);    // EFGH
  STATE0 = _mm_alignr_epi8(TMP, STATE1, 8);    // ABEF
  STATE1 = _mm_blend_epi16(STATE1, TMP, 0xF0); // CDGH

  const __m128i ABEF_SAVE = STATE0;
  const __m128i CDGH_SAVE = STATE1;

#define ROUNDS4(M, k0, k1, k2, k3)                                   \
  MSG = _mm_add_epi32(M, _mm_set_epi64x(                             \
      (long long)(((uint64_t)k3 << 32) | k2),                        \
      (long long)(((uint64_t)k1 << 32) | k0)));                      \
  STATE1 = _mm_sha256rnds2_epu32(STATE1, STATE0, MSG);               \
  MSG = _mm_shuffle_epi32(MSG, 0x0E);                                \
  STATE0 = _mm_sha256rnds2_epu32(STATE0, STATE1, MSG);

  MSG0 = _mm_shuffle_epi8(_mm_loadu_si128((const __m128i*)(block + 0)), MASK);
  MSG1 = _mm_shuffle_epi8(_mm_loadu_si128((const __m128i*)(block + 16)), MASK);
  MSG2 = _mm_shuffle_epi8(_mm_loadu_si128((const __m128i*)(block + 32)), MASK);
  MSG3 = _mm_shuffle_epi8(_mm_loadu_si128((const __m128i*)(block + 48)), MASK);

  ROUNDS4(MSG0, K[0], K[1], K[2], K[3])
  ROUNDS4(MSG1, K[4], K[5], K[6], K[7])
  ROUNDS4(MSG2, K[8], K[9], K[10], K[11])
  ROUNDS4(MSG3, K[12], K[13], K[14], K[15])

  for (int i = 16; i < 64; i += 16) {
    MSG0 = _mm_sha256msg1_epu32(MSG0, MSG1);
    TMP = _mm_alignr_epi8(MSG3, MSG2, 4);
    MSG0 = _mm_add_epi32(MSG0, TMP);
    MSG0 = _mm_sha256msg2_epu32(MSG0, MSG3);
    ROUNDS4(MSG0, K[i], K[i + 1], K[i + 2], K[i + 3])

    MSG1 = _mm_sha256msg1_epu32(MSG1, MSG2);
    TMP = _mm_alignr_epi8(MSG0, MSG3, 4);
    MSG1 = _mm_add_epi32(MSG1, TMP);
    MSG1 = _mm_sha256msg2_epu32(MSG1, MSG0);
    ROUNDS4(MSG1, K[i + 4], K[i + 5], K[i + 6], K[i + 7])

    MSG2 = _mm_sha256msg1_epu32(MSG2, MSG3);
    TMP = _mm_alignr_epi8(MSG1, MSG0, 4);
    MSG2 = _mm_add_epi32(MSG2, TMP);
    MSG2 = _mm_sha256msg2_epu32(MSG2, MSG1);
    ROUNDS4(MSG2, K[i + 8], K[i + 9], K[i + 10], K[i + 11])

    MSG3 = _mm_sha256msg1_epu32(MSG3, MSG0);
    TMP = _mm_alignr_epi8(MSG2, MSG1, 4);
    MSG3 = _mm_add_epi32(MSG3, TMP);
    MSG3 = _mm_sha256msg2_epu32(MSG3, MSG2);
    ROUNDS4(MSG3, K[i + 12], K[i + 13], K[i + 14], K[i + 15])
  }
#undef ROUNDS4

  STATE0 = _mm_add_epi32(STATE0, ABEF_SAVE);
  STATE1 = _mm_add_epi32(STATE1, CDGH_SAVE);

  TMP = _mm_shuffle_epi32(STATE0, 0x1B);       // FEBA
  STATE1 = _mm_shuffle_epi32(STATE1, 0xB1);    // DCHG
  STATE0 = _mm_blend_epi16(TMP, STATE1, 0xF0); // DCBA
  STATE1 = _mm_alignr_epi8(STATE1, TMP, 8);    // HGFE

  _mm_storeu_si128((__m128i*)&state[0], STATE0);
  _mm_storeu_si128((__m128i*)&state[4], STATE1);
}

bool has_shani() {
  unsigned int a, b, c, d;
  if (!__get_cpuid_count(7, 0, &a, &b, &c, &d)) return false;
  return (b >> 29) & 1;
}
#else
bool has_shani() { return false; }
void sha256_compress_shani(uint32_t*, const uint8_t*) {}
#endif

typedef void (*compress_fn)(uint32_t*, const uint8_t*);
compress_fn g_compress = nullptr;

void init_compress() {
  if (!g_compress) g_compress = has_shani() ? sha256_compress_shani
                                            : sha256_compress_scalar;
}

struct Sha256 {
  uint32_t state[8] = {0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a,
                       0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19};
  uint8_t buf[64];
  size_t buflen = 0;
  uint64_t total = 0;

  void update(const uint8_t* data, size_t len) {
    total += len;
    if (buflen) {
      size_t take = 64 - buflen;
      if (take > len) take = len;
      memcpy(buf + buflen, data, take);
      buflen += take;
      data += take;
      len -= take;
      if (buflen == 64) {
        g_compress(state, buf);
        buflen = 0;
      }
    }
    while (len >= 64) {
      g_compress(state, data);
      data += 64;
      len -= 64;
    }
    if (len) {
      memcpy(buf, data, len);
      buflen = len;
    }
  }

  void finalize(uint8_t out[32]) {
    uint64_t bitlen = total * 8;
    uint8_t pad = 0x80;
    update(&pad, 1);
    uint8_t zero = 0;
    while (buflen != 56) update(&zero, 1);
    uint8_t lenb[8];
    for (int i = 0; i < 8; i++) lenb[i] = uint8_t(bitlen >> (56 - 8 * i));
    update(lenb, 8);
    for (int i = 0; i < 8; i++) {
      out[i * 4] = uint8_t(state[i] >> 24);
      out[i * 4 + 1] = uint8_t(state[i] >> 16);
      out[i * 4 + 2] = uint8_t(state[i] >> 8);
      out[i * 4 + 3] = uint8_t(state[i]);
    }
  }
};

// ------------------------------------------------------------- formatting
inline char* write_u64_dec(char* p, uint64_t v) {
  char tmp[20];
  int n = 0;
  if (v == 0) tmp[n++] = '0';
  while (v) {
    tmp[n++] = char('0' + v % 10);
    v /= 10;
  }
  for (int i = n - 1; i >= 0; i--) *p++ = tmp[i];
  return p;
}

// Write one element's Display string; comps u64 components per element.
inline char* write_elem(char* p, const uint64_t* v, int fmt) {
  switch (fmt) {
    case 0:
      return write_u64_dec(p, v[0]);
    case 1: {
      memcpy(p, "QuadExtField(", 13); p += 13;
      p = write_u64_dec(p, v[0]);
      memcpy(p, " + ", 3); p += 3;
      p = write_u64_dec(p, v[1]);
      memcpy(p, " * u)", 5); p += 5;
      return p;
    }
    case 2: {
      memcpy(p, "QuadExtField(QuadExtField(", 26); p += 26;
      p = write_u64_dec(p, v[0]);
      memcpy(p, " + ", 3); p += 3;
      p = write_u64_dec(p, v[1]);
      memcpy(p, " * u) + QuadExtField(", 21); p += 21;
      p = write_u64_dec(p, v[2]);
      memcpy(p, " + ", 3); p += 3;
      p = write_u64_dec(p, v[3]);
      memcpy(p, " * u) * u)", 10); p += 10;
      return p;
    }
  }
  return p;
}

inline int comps_for_fmt(int fmt) { return fmt == 0 ? 1 : (fmt == 1 ? 2 : 4); }

void hash_leaf_range(const uint64_t* vals, size_t leafs_per_node, int fmt,
                     size_t g0, size_t g1, uint8_t* out) {
  int comps = comps_for_fmt(fmt);
  std::vector<char> strbuf(leafs_per_node * (64 * comps + 64));
  for (size_t g = g0; g < g1; g++) {
    char* p = strbuf.data();
    const uint64_t* base = vals + g * leafs_per_node * comps;
    for (size_t i = 0; i < leafs_per_node; i++)
      p = write_elem(p, base + i * comps, fmt);
    Sha256 h;
    h.update(reinterpret_cast<const uint8_t*>(strbuf.data()),
             size_t(p - strbuf.data()));
    h.finalize(out + g * 32);
  }
}

void hash_inner_range(const uint8_t* children, size_t inner_children,
                      size_t p0, size_t p1, uint8_t* out) {
  for (size_t p = p0; p < p1; p++) {
    Sha256 h;
    h.update(children + p * inner_children * 32, inner_children * 32);
    h.finalize(out + p * 32);
  }
}

void parallel_for(size_t n, int nthreads,
                  const std::function<void(size_t, size_t)>& fn) {
  if (n == 0) return;
  if (nthreads <= 1 || n < 1024) {
    fn(0, n);
    return;
  }
  std::vector<std::thread> ts;
  size_t chunk = (n + nthreads - 1) / nthreads;
  for (int t = 0; t < nthreads; t++) {
    size_t a = t * chunk, b = a + chunk;
    if (a >= n) break;
    if (b > n) b = n;
    ts.emplace_back(fn, a, b);
  }
  for (auto& t : ts) t.join();
}

}  // namespace

extern "C" {

// Hash n_groups leaf groups. vals: n_groups*leafs_per_node*comps u64 words.
// out: n_groups * 32 bytes.
void leaf_hash_batch(const uint64_t* vals, size_t n_groups,
                     size_t leafs_per_node, int fmt, int nthreads,
                     uint8_t* out) {
  init_compress();
  parallel_for(n_groups, nthreads, [&](size_t a, size_t b) {
    hash_leaf_range(vals, leafs_per_node, fmt, a, b, out);
  });
}

// Build all inner levels above a level of n digests with fan-in c.
// out must hold (n/c + n/c^2 + ... + 1) * 32 bytes; returns node count.
size_t inner_levels(const uint8_t* level0, size_t n, size_t c, int nthreads,
                    uint8_t* out) {
  init_compress();
  const uint8_t* src = level0;
  uint8_t* dst = out;
  size_t written = 0;
  while (n > 1) {
    size_t parents = n / c;
    parallel_for(parents, nthreads, [&](size_t a, size_t b) {
      hash_inner_range(src, c, a, b, dst);
    });
    src = dst;
    dst += parents * 32;
    written += parents;
    n = parents;
  }
  return written;
}

// One-shot convenience for tests: sha256 of a byte buffer.
void sha256_oneshot(const uint8_t* data, size_t len, uint8_t* out) {
  init_compress();
  Sha256 h;
  h.update(data, len);
  h.finalize(out);
}

}  // extern "C"
