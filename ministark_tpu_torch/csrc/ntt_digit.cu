// One NTT level over Goldilocks in its digit-matmul form, as three stage
// kernels and one fused kernel:
//
//   ms_digitize_gl      (B, F, R) u64      -> (B, 8F, R) s8 balanced digits
//   ms_digit_dot_s8     (B, K, R) s8 x (K, N) s8 -> (B, R, N) s32
//   ms_recombine_gl     (B, R, 8 PF) s32   -> (B, R, F) u64 canonical
//   ms_digit_level_gl   (B, F, R) u64      -> (B, R, F) u64, the three in one
//                       launch with nothing between them in device memory
//
// Replaces the Pallas kernels scripts/tpu_fused_stage_probe.py::kern_dig,
// kern_dot and kern_rec (the three stages of a level, each alone) and
// scripts/tpu_f32_pad_probe.py::kernel (the fused level at F = 32 with the
// digit columns of plane b starting at b * 128), which run the arithmetic
// of ministark_tpu/ops/ntt_mxu.py::_make_fused_kernel: a length-F DFT as an
// int8 matrix product. x[b, m, r] is centred (v > 0x7F7F7F7F7F7F7F7F
// becomes v - p) and written as 8 balanced signed bytes d_a; the digit
// matrix Vd[a F + m, j PF + k] holds digit j of centre(w^(m k) 256^a mod
// p); the product gives 8 planes R_j[r, k] with |R_j| < 2^27, and
// sum_j (R_j + 2^27) 2^(8 j) < 2^96 is reduced mod p, the offsets'
// constant subtracted, and the inter-level twiddle and trailing scalar
// multiplied in.
//
// The dot forms its product in its own body with the int8 tensor-core
// instruction mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32. Both operands
// arrive with the contraction index k on the slow axis (A is (K, R), Vd is
// (K, N)), and the instruction wants four consecutive k of one row (or
// column) in each 32-bit register, so a tile is loaded as 4 x 4 byte blocks,
// transposed in registers with __byte_perm and stored k-contiguous in
// shared memory, rows padded by 16 bytes so that the fragment reads of a
// warp fall in 32 different banks. A block of 8 warps computes a 128 x 128
// tile of the output (each warp 64 x 32) over chunks of 64 k.
//
// The fused level digitizes a tile of BM positions once into shared memory
// (BM x 8F bytes; BM = 128, 64 or 32 for F <= 128, 256, 512), then walks
// the output in chunks of 16 frequencies: the B tile gathers those 16
// columns of all 8 digit planes, ordered so that the 8 planes of one
// (position, frequency) land in the accumulators of one thread, which
// recombines them in registers and stores the field element.
//
// Bound on the H100: digitize and recombine by device-memory bandwidth
// (16 and 40-48 bytes per element against ~40 integer operations), the dot
// by the int8 tensor-core rate (64 multiply-adds per input byte at F = 128).
// This first version is synchronous (load, __syncthreads, mma): no
// cp.async, TMA or wgmma.
#include <cuda_runtime.h>

#include <cstdint>

#include "gl.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int BK = 64;                // contraction bytes per shared chunk
constexpr int BN = 128;               // output columns per block tile
constexpr int PAD = 16;               // row padding in shared memory, bytes
constexpr int B_STRIDE = BK + PAD;    // 80: 8 rows x 4 words hit 32 banks
constexpr uint64_t CENTER_T = 0x7F7F7F7F7F7F7F7Full;  // 127 (2^64 - 1) / 255
constexpr uint32_t OFF = 1u << 27;    // makes every plane non-negative

// The 8 balanced digits of a canonical value, digit a in byte a (two's
// complement). v - p wraps to its two's complement; byte + carry truncated
// to 8 bits is the balanced digit, and the final carry is dropped (for a
// centred negative value it is the 2^64 of the wrap).
__device__ __forceinline__ uint64_t digits_of(uint64_t v) {
  if (v > CENTER_T) v -= gl::P;
  uint64_t out = 0;
  uint32_t c = 0;
#pragma unroll
  for (int a = 0; a < 8; ++a) {
    const uint32_t t = (uint32_t)((v >> (8 * a)) & 255u) + c;
    out |= (uint64_t)(t & 255u) << (8 * a);
    c = t > 127u;
  }
  return out;
}

// sum_j (pl[j] + OFF) 2^(8 j) mod p, less kc = sum_j OFF 2^(8 j) mod p.
__device__ __forceinline__ uint64_t recombine(const int32_t (&pl)[8], uint64_t kc) {
  uint64_t L = 0, H = 0;              // each < 2^53
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    L += (uint64_t)(uint32_t)(pl[j] + (int32_t)OFF) << (8 * j);
    H += (uint64_t)(uint32_t)(pl[4 + j] + (int32_t)OFF) << (8 * j);
  }
  const uint64_t lo = L + (H << 32);  // Y = L + H 2^32 < 2^96 as (hi, lo)
  const uint64_t hi = (H >> 32) + (lo < L);
  return gl::sub(gl::reduce128(lo, hi), kc);
}

// The level's tail: the twiddle W[r / K_prod, k] and the trailing scalar.
struct Tail {
  const uint64_t* W;   // (R >> log_kprod, F), or null
  int log_kprod;
  uint64_t scale;      // 1 for none
  uint64_t kc;
};

__device__ __forceinline__ uint64_t finish(uint64_t v, const Tail& T, int r, int k,
                                           int F) {
  if (T.W) v = gl::mul(v, T.W[(size_t)(r >> T.log_kprod) * F + k]);
  if (T.scale != 1) v = gl::mul(v, T.scale);
  return v;
}

// ---------------------------------------------------------------- digitize
__global__ void digitize_kernel(const uint64_t* __restrict__ x,
                                int8_t* __restrict__ d, int F, int R,
                                int64_t rows) {
  const int rq = (R + 3) / 4;
  const bool words = (R & 3) == 0;
  const int64_t total = rows * rq;
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += step) {
    const int64_t row = i / rq;       // b * F + m
    const int r0 = (int)(i % rq) * 4;
    const int64_t b = row / F, m = row % F;
    const uint64_t* src = x + row * R + r0;
    const int cnt = R - r0 < 4 ? R - r0 : 4;
    uint64_t dg[4] = {0, 0, 0, 0};
    for (int j = 0; j < cnt; ++j) dg[j] = digits_of(src[j]);
#pragma unroll
    for (int a = 0; a < 8; ++a) {
      int8_t* dst = d + ((b * 8 + a) * F + m) * R + r0;
      if (words) {
        uint32_t w = 0;
#pragma unroll
        for (int j = 0; j < 4; ++j) w |= (uint32_t)((dg[j] >> (8 * a)) & 255u) << (8 * j);
        *reinterpret_cast<uint32_t*>(dst) = w;
      } else {
        for (int j = 0; j < cnt; ++j) dst[j] = (int8_t)(dg[j] >> (8 * a));
      }
    }
  }
}

// --------------------------------------------------------------------- dot
// Four bytes at p, the ones at or past `valid` read as 0.
__device__ __forceinline__ uint32_t load4(const int8_t* p, int valid, bool aligned) {
  if (valid >= 4 && aligned) return *reinterpret_cast<const uint32_t*>(p);
  uint32_t w = 0;
  for (int i = 0; i < 4; ++i) {
    if (i < valid) w |= (uint32_t)(uint8_t)p[i] << (8 * i);
  }
  return w;
}

// w[j] holds bytes (j, 0..3) of a 4 x 4 block; t[i] gets bytes (0..3, i).
__device__ __forceinline__ void transpose4(const uint32_t (&w)[4], uint32_t (&t)[4]) {
  const uint32_t x0 = __byte_perm(w[0], w[1], 0x5140);  // w0[0] w1[0] w0[1] w1[1]
  const uint32_t y0 = __byte_perm(w[2], w[3], 0x5140);
  const uint32_t x1 = __byte_perm(w[0], w[1], 0x7362);  // w0[2] w1[2] w0[3] w1[3]
  const uint32_t y1 = __byte_perm(w[2], w[3], 0x7362);
  t[0] = __byte_perm(x0, y0, 0x5410);
  t[1] = __byte_perm(x0, y0, 0x7632);
  t[2] = __byte_perm(x1, y1, 0x5410);
  t[3] = __byte_perm(x1, y1, 0x7632);
}

// A BK x 128 tile of a matrix whose rows are k (leading dimension ld) into
// dst[c][k] (row stride `stride` bytes): columns at or past `valid` read 0.
__device__ __forceinline__ void load_tile_t(const int8_t* __restrict__ src, int64_t ld,
                                            int valid, bool aligned, int8_t* dst,
                                            int stride) {
  for (int blk = threadIdx.x; blk < (BK / 4) * (BN / 4); blk += THREADS) {
    const int cg = blk % (BN / 4), kg = blk / (BN / 4);
    uint32_t w[4], t[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      w[j] = load4(src + (int64_t)(4 * kg + j) * ld + 4 * cg, valid - 4 * cg, aligned);
    }
    transpose4(w, t);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      *reinterpret_cast<uint32_t*>(dst + (4 * cg + i) * stride + 4 * kg) = t[i];
    }
  }
}

// The fused level's B tile: BK rows of Vd (leading dimension N = 8 PF),
// frequencies k0 .. k0 + 15 of each of the 8 digit planes (plane j starts at
// column j PF). Frequency k0 + q of plane j goes to tile column
// (q / 4) * 32 + (j / 2) * 8 + (q % 4) * 2 + (j % 2): warp q / 4 owns it, and
// in the accumulator layout of m16n8k32 the thread with lane % 4 == q % 4
// then holds all 8 planes of that frequency (n8 tile j / 2, element j % 2).
__device__ __forceinline__ void load_planes_tile(const int8_t* __restrict__ src,
                                                 int64_t N, int PF, int k0,
                                                 int8_t* dst) {
  for (int blk = threadIdx.x; blk < (BK / 4) * (BN / 4); blk += THREADS) {
    const int cg = blk % (BN / 4), kg = blk / (BN / 4);
    const int j = cg / 4, q0 = (cg % 4) * 4;
    uint32_t w[4], t[4];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      w[jj] = *reinterpret_cast<const uint32_t*>(src + (int64_t)(4 * kg + jj) * N +
                                                 (int64_t)j * PF + k0 + q0);
    }
    transpose4(w, t);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int q = q0 + i;
      const int col = (q / 4) * 32 + (j / 2) * 8 + (q % 4) * 2 + (j % 2);
      *reinterpret_cast<uint32_t*>(dst + col * B_STRIDE + 4 * kg) = t[i];
    }
  }
}

__device__ __forceinline__ void mma_s8(int32_t (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One chunk of BK contraction bytes: As[row][k] (row stride a_stride, already
// offset to the chunk) times Bs[col][k], into the warp's (MT x 16) x 32
// accumulators. Fragment layout of m16n8k32 (lane = 4 g + t): a0 row g,
// k 4t..4t+3; a1 row g + 8; a2, a3 the same at k + 16; b0 column g,
// k 4t..4t+3; b1 at k + 16; c0, c1 row g, columns 2t, 2t + 1; c2, c3 row g + 8.
template <int MT>
__device__ __forceinline__ void mma_chunk(const int8_t* As, int a_stride,
                                          const int8_t* Bs, int32_t (&acc)[MT][4][4],
                                          int warp_m, int warp_n, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < BK; kk += 32) {
    uint32_t b[4][2];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int8_t* p = Bs + (warp_n * 32 + nt * 8 + g) * B_STRIDE + kk + 4 * t;
      b[nt][0] = *reinterpret_cast<const uint32_t*>(p);
      b[nt][1] = *reinterpret_cast<const uint32_t*>(p + 16);
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int8_t* p = As + (size_t)((warp_m * MT + mt) * 16 + g) * a_stride + kk + 4 * t;
      uint32_t a[4];
      a[0] = *reinterpret_cast<const uint32_t*>(p);
      a[1] = *reinterpret_cast<const uint32_t*>(p + 8 * (size_t)a_stride);
      a[2] = *reinterpret_cast<const uint32_t*>(p + 16);
      a[3] = *reinterpret_cast<const uint32_t*>(p + 8 * (size_t)a_stride + 16);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) mma_s8(acc[mt][nt], a, b[nt]);
    }
  }
}

template <int MT>
__device__ __forceinline__ void clear(int32_t (&acc)[MT][4][4]) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0;
    }
  }
}

// C[b, r, n] = sum_k A[b, k, r] V[k, n]; K a multiple of 64, N of 128.
__global__ void __launch_bounds__(THREADS)
digit_dot_kernel(const int8_t* __restrict__ A, const int8_t* __restrict__ V,
                 int32_t* __restrict__ C, int K, int R, int N) {
  __shared__ __align__(16) int8_t As[128 * B_STRIDE];
  __shared__ __align__(16) int8_t Bs[BN * B_STRIDE];
  const int b = blockIdx.z, r0 = blockIdx.y * 128, n0 = blockIdx.x * BN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int warp_m = warp >> 2, warp_n = warp & 3;
  const int8_t* Ab = A + (int64_t)b * K * R;
  const bool aligned = (R & 3) == 0;
  int32_t acc[4][4][4];
  clear<4>(acc);
  for (int k0 = 0; k0 < K; k0 += BK) {
    load_tile_t(Ab + (int64_t)k0 * R + r0, R, R - r0, aligned, As, B_STRIDE);
    load_tile_t(V + (int64_t)k0 * N + n0, N, BN, true, Bs, B_STRIDE);
    __syncthreads();
    mma_chunk<4>(As, B_STRIDE, Bs, acc, warp_m, warp_n, lane);
    __syncthreads();
  }
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int col = n0 + warp_n * 32 + nt * 8 + 2 * t;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = r0 + (warp_m * 4 + mt) * 16 + g + 8 * h;
        if (row < R) {
          *reinterpret_cast<int2*>(C + ((int64_t)b * R + row) * N + col) =
              make_int2(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
        }
      }
    }
  }
}

// --------------------------------------------------------------- recombine
__global__ void recombine_kernel(const int32_t* __restrict__ Rm,
                                 uint64_t* __restrict__ y, int R, int F, int PF,
                                 int64_t total, Tail T) {
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += step) {
    const int k = (int)(i % F);
    const int64_t br = i / F;
    const int r = (int)(br % R);
    const int32_t* src = Rm + br * 8 * PF + k;
    int32_t pl[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) pl[j] = src[(int64_t)j * PF];
    y[i] = finish(recombine(pl, T.kc), T, r, k, F);
  }
}

// ------------------------------------------------------------- fused level
template <int MT>
__global__ void __launch_bounds__(THREADS)
digit_level_kernel(const uint64_t* __restrict__ x, const int8_t* __restrict__ V,
                   uint64_t* __restrict__ y, int F, int R, int PF, Tail T) {
  extern __shared__ __align__(16) int8_t smem[];
  constexpr int BM = MT * 32;
  const int K = 8 * F, a_stride = K + PAD;
  const int64_t N = 8 * (int64_t)PF;
  int8_t* As = smem;
  int8_t* Bs = smem + (size_t)BM * a_stride;
  const int b = blockIdx.y, r0 = blockIdx.x * BM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int warp_m = warp >> 2, warp_n = warp & 3;
  const int g = lane >> 2, t = lane & 3;

  // digitize the tile: position r0 + rl, digit a of x[b, m, .] at byte a F + m
  for (int e = threadIdx.x; e < F * BM; e += THREADS) {
    const int m = e / BM, rl = e % BM, r = r0 + rl;
    const uint64_t dg = r < R ? digits_of(x[((int64_t)b * F + m) * R + r]) : 0;
    int8_t* row = As + (size_t)rl * a_stride + m;
#pragma unroll
    for (int a = 0; a < 8; ++a) row[a * F] = (int8_t)(dg >> (8 * a));
  }
  __syncthreads();

  for (int kc0 = 0; kc0 < F; kc0 += 16) {
    int32_t acc[MT][4][4];
    clear<MT>(acc);
    for (int k0 = 0; k0 < K; k0 += BK) {
      load_planes_tile(V + (int64_t)k0 * N, N, PF, kc0, Bs);
      __syncthreads();
      mma_chunk<MT>(As + k0, a_stride, Bs, acc, warp_m, warp_n, lane);
      __syncthreads();
    }
    const int k = kc0 + warp_n * 4 + t;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + (warp_m * MT + mt) * 16 + g + 8 * h;
        if (r < R) {
          int32_t pl[8];
#pragma unroll
          for (int j = 0; j < 8; ++j) pl[j] = acc[mt][j / 2][2 * h + (j % 2)];
          y[((int64_t)b * R + r) * F + k] = finish(recombine(pl, T.kc), T, r, k, F);
        }
      }
    }
  }
}

template <int MT>
int launch_level(const uint64_t* x, const int8_t* V, uint64_t* y, int batch, int F,
                 int R, int PF, const Tail& T, cudaStream_t s) {
  constexpr int BM = MT * 32;
  const size_t bytes = (size_t)BM * (8 * F + PAD) + (size_t)BN * B_STRIDE;
  cudaError_t err = cudaFuncSetAttribute(
      digit_level_kernel<MT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((R + BM - 1) / BM), (unsigned)batch);
  digit_level_kernel<MT><<<grid, THREADS, bytes, s>>>(x, V, y, F, R, PF, T);
  return (int)cudaGetLastError();
}

bool pow2(int v) { return v > 0 && (v & (v - 1)) == 0; }

unsigned flat_blocks(int64_t work) {
  int64_t blocks = (work + THREADS - 1) / THREADS;
  if (blocks > (1 << 20)) blocks = 1 << 20;
  return (unsigned)(blocks < 1 ? 1 : blocks);
}

}  // namespace

// x: (batch, F, R) canonical values -> d: (batch, 8 F, R) digits, digit a of
// position m at row a F + m.
extern "C" int ms_digitize_gl(const uint64_t* x, int8_t* d, int batch, int F, int R,
                              void* stream) {
  if (batch < 1 || F < 1 || R < 1) return (int)cudaErrorInvalidValue;
  const int64_t rows = (int64_t)batch * F;
  digitize_kernel<<<flat_blocks(rows * ((R + 3) / 4)), THREADS, 0,
                    (cudaStream_t)stream>>>(x, d, F, R, rows);
  return (int)cudaGetLastError();
}

// A: (batch, K, R), V: (K, N) -> C: (batch, R, N); K % 64 == 0, N % 128 == 0.
extern "C" int ms_digit_dot_s8(const int8_t* A, const int8_t* V, int32_t* C,
                               int batch, int K, int R, int N, void* stream) {
  if (batch < 1 || batch > 65535 || K < BK || K % BK || N < BN || N % BN || R < 1 ||
      (R + 127) / 128 > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid((unsigned)(N / BN), (unsigned)((R + 127) / 128), (unsigned)batch);
  digit_dot_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(A, V, C, K, R, N);
  return (int)cudaGetLastError();
}

// Rm: (batch, R, 8 PF) -> y: (batch, R, F); plane j in columns j PF .. j PF + F;
// W: (R >> log_kprod, F) twiddles or null; scale: 1 for none; kc: the
// offsets' constant sum_j 2^27 2^(8 j) mod p.
extern "C" int ms_recombine_gl(const int32_t* Rm, uint64_t* y, int batch, int R, int F,
                               int PF, const uint64_t* W, int log_kprod,
                               uint64_t scale, uint64_t kc, void* stream) {
  if (batch < 1 || R < 1 || F < 1 || F > 512 || PF < F || log_kprod < 0 ||
      log_kprod > 30) {
    return (int)cudaErrorInvalidValue;
  }
  const Tail T{W, log_kprod, scale, kc};
  const int64_t total = (int64_t)batch * R * F;
  recombine_kernel<<<flat_blocks(total), THREADS, 0, (cudaStream_t)stream>>>(
      Rm, y, R, F, PF, total, T);
  return (int)cudaGetLastError();
}

// x: (batch, F, R) -> y: (batch, R, F), F a power of two in [32, 512];
// V: the (8 F, 8 PF) digit matrix, PF >= F a multiple of 4.
extern "C" int ms_digit_level_gl(const uint64_t* x, const int8_t* V, uint64_t* y,
                                 int batch, int F, int R, int PF, const uint64_t* W,
                                 int log_kprod, uint64_t scale, uint64_t kc,
                                 void* stream) {
  if (batch < 1 || batch > 65535 || !pow2(F) || F < 32 || F > 512 || R < 1 ||
      PF < F || PF % 4 || log_kprod < 0 || log_kprod > 30) {
    return (int)cudaErrorInvalidValue;
  }
  const Tail T{W, log_kprod, scale, kc};
  cudaStream_t s = (cudaStream_t)stream;
  if (F <= 128) return launch_level<4>(x, V, y, batch, F, R, PF, T, s);
  if (F == 256) return launch_level<2>(x, V, y, batch, F, R, PF, T, s);
  return launch_level<1>(x, V, y, batch, F, R, PF, T, s);
}
