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
// The dot and the fused level run the int8 products on Hopper's warpgroup
// tensor cores (wgmma.mma_async m64n256k32 .s32.s8.s8, wgmma_s8.cuh), which
// read both operands K-major from shared memory under the 128-byte swizzle:
//
//  - The level reads the digit matrix from a K-major copy made once on the
//    host side (ops/ntt_digit.py::kernel_table: only the F live columns of
//    each plane, ordered so that one thread's accumulators hold all 8 planes
//    of two adjacent frequencies), copied stage by stage by TMA through an
//    mbarrier ring. The digits are made on the chip, 16-byte stores into the
//    swizzled tile; the recombine, the twiddle and the scalar run on the
//    accumulators, and two finished values leave as one 16-byte store.
//  - The dot's operands arrive with k on the slow axis (A is (K, R), V is
//    (K, N)); a raw ring is kept full by TMA in that layout, and the block's
//    8 warps turn each k-block into the K-major tiles (4 x 4 byte blocks
//    through __byte_perm, a lane map that meets 32 banks on both sides)
//    while the previous k-block's wgmma run.
//
// Bound on the H100: digitize and recombine by device-memory bandwidth
// (16 and 40-48 bytes per element against ~40 integer operations), the dot
// by its int32 output at the level shapes and by the int8 tensor-core rate
// at 4096^3, the fused level by the tensor-core rate (64 F multiply-adds a
// value).
#include <cuda_runtime.h>

#include <cstdint>

#include "gl.cuh"
#include "wgmma_s8.cuh"

namespace {

constexpr int THREADS = 256;          // the flat kernels (digitize, recombine)
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

// Byte (row, col) of a 128-byte-row tile under the 128-byte swizzle.
__device__ __forceinline__ int sw128(int row, int col) {
  return row * wg::KBLOCK + ((((col >> 4) ^ row) & 7) << 4) + (col & 15);
}

constexpr int DOT_BM = 128;                       // output rows a block (2 x m64)
constexpr int DOT_RAW_A = wg::KBLOCK * DOT_BM;    // 128 k x 128 r, as copied
constexpr int DOT_RAW_B = wg::KBLOCK * wg::TILE_N;  // 128 k x 256 n, two halves
constexpr int DOT_STAGE = DOT_RAW_A + DOT_RAW_B;  // a k-block, raw or K-major
constexpr int DOT_RING = 2;
constexpr int DOT_THREADS = 256;                  // 2 warpgroups
constexpr size_t DOT_SMEM = 1024 + 2 * DOT_RING * DOT_STAGE + DOT_RING * 8;

// The block of 4 x 4 bytes a thread moves on iteration `it` of a
// tile of 32 (A) or 64 (V) x 32 blocks (cg: 4 columns, kg: 4 contraction
// rows); iterations 32-63 are V's second 128-byte half. Lane
// (z, b, a) = (lane >> 4, (lane >> 2) & 3, lane & 3) takes, in a 16 x 16
// sub-grid, cg = 4 A2 + a and kg = 4 B2 + b with A2 = ((b >> 1) ^ q0) +
// 2 (z ^ q2) and B2 = ((a >> 1) ^ q1) + 2 z: the 8 values of q cover the
// sub-grid once, and both the copied tile's reads (rows 4 kg + j, swizzle
// row bits 4 (b & 1) + j) and the K-major stores (rows 4 cg + i, swizzle
// bits 4 (a & 1) + i) meet 32 different banks.
__device__ __forceinline__ void block_of(int it, int lane, int& cg, int& kg) {
  const int q = it & 7, sub = it >> 3, a = lane & 3, b = (lane >> 2) & 3,
            z = lane >> 4;
  const int a2 = (((b >> 1) ^ q) & 1) | (((z ^ (q >> 2)) & 1) << 1);
  const int b2 = (((a >> 1) ^ (q >> 1)) & 1) | (z << 1);
  cg = 16 * (sub & 1) + 4 * a2 + a + 32 * (sub >> 2);   // sub-grids: cg fastest
  kg = 16 * ((sub >> 1) & 1) + 4 * b2 + b;
}

// Warp w takes iterations it = w + 8 ii (q = w, sub-grid ii). Its lane's
// offsets for ii = 0: S of word (row 4 kg, column 4 cg) in a copied tile,
// D of word (row 4 cg, byte 4 kg) in a K-major one; iteration ii and word
// j only XOR and add constants to them (move).
__device__ __forceinline__ void moves_of(int w, int lane, uint32_t& S, uint32_t& D) {
  const int a = lane & 3, b = (lane >> 2) & 3, z = lane >> 4;
  const int cg0 = 4 * ((((b >> 1) ^ w) & 1) | (((z ^ (w >> 2)) & 1) << 1)) + a;
  const int kg0 = 4 * ((((a >> 1) ^ (w >> 1)) & 1) | (z << 1)) + b;
  S = 512 * kg0 + 16 * ((cg0 >> 2) ^ (4 * (b & 1))) + 4 * (cg0 & 3);
  D = 512 * cg0 + 16 * ((kg0 >> 2) ^ (4 * (a & 1))) + 4 * (kg0 & 3);
}

// Iteration ii (unrolled: a constant) of the 4 x 4 transposes from a
// copied 128-byte-row tile (two 16 KB halves for V) into a K-major one.
__device__ __forceinline__ void move(const uint8_t* src, uint8_t* dst, uint32_t S,
                                     uint32_t D, int ii) {
  uint32_t w[4], t[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint32_t x = 16 * (j ^ (4 * (ii & 1)));
    w[j] = *reinterpret_cast<const uint32_t*>(
        src + (S ^ x) + 128 * j + 8192 * ((ii >> 1) & 1) + 16384 * (ii >> 2));
  }
  transpose4(w, t);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint32_t x = 16 * (j ^ (4 * ((ii >> 1) & 1)));
    *reinterpret_cast<uint32_t*>(dst + (D ^ x) + 128 * j + 8192 * (ii & 1) +
                                 16384 * (ii >> 2)) = t[j];
  }
}

// C[b, r, n] = sum_k A[b, k, r] V[k, n]: two warpgroups, rows 0-63 and
// 64-127 of the block's 128, columns n0 .. n0 + 255. Thread 0 keeps a raw
// ring of 2 k-blocks full by TMA (A's (128 r, 128 k) box and V's two (128
// n, 128 k) boxes, 128-byte swizzle, zeros past R, K and N); all 8 warps
// turn raw k-block i + 1 into the K-major one (rows r and n, 128
// contraction bytes) in 4 x 4 byte blocks while k-block i's wgmma run.
// Without a TMA map for A (R not a multiple of 16) the warps read A's
// bytes from global memory instead, with the same block map.
template <bool TMA_A>
__global__ void __launch_bounds__(DOT_THREADS, 1)
digit_dot_kernel(const int8_t* __restrict__ A, int32_t* __restrict__ C,
                 const __grid_constant__ CUtensorMap amap,
                 const __grid_constant__ CUtensorMap vmap, int K, int R, int N) {
  extern __shared__ uint8_t dot_smem[];
  uint8_t* raw = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(dot_smem) + 1023) & ~(uintptr_t)1023);
  uint8_t* kmaj = raw + DOT_RING * DOT_STAGE;
  uint64_t* raw_full = reinterpret_cast<uint64_t*>(kmaj + DOT_RING * DOT_STAGE);
  const int n0 = blockIdx.x * wg::TILE_N, r0 = blockIdx.y * DOT_BM, b = blockIdx.z;
  const int KT = (K + wg::KBLOCK - 1) / wg::KBLOCK;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < DOT_RING; ++s) wg::bar_init(&raw_full[s], 1);
    wg::bar_init_fence();
  }
  __syncthreads();
  // thread 0: k-block i's A box and V's two boxes into raw slot i % 2
  auto load_stage = [&](int i) {
    uint8_t* dst = raw + (i % DOT_RING) * DOT_STAGE;
    uint64_t* bar = &raw_full[i % DOT_RING];
    wg::bar_expect(bar, TMA_A ? DOT_STAGE : DOT_RAW_B);
    if (TMA_A) wg::tma_load_3d(dst, &amap, bar, r0, i * wg::KBLOCK, b);
    for (int h = 0; h < 2; ++h) {
      wg::tma_load_2d(dst + DOT_RAW_A + h * (DOT_RAW_B / 2), &vmap, bar, n0 + 128 * h,
                      i * wg::KBLOCK);
    }
  };
  if (threadIdx.x == 0) {
    for (int i = 0; i < DOT_RING && i < KT; ++i) load_stage(i);
  }
  const int8_t* Ab = A + (int64_t)b * K * R;
  const bool aligned = (R & 3) == 0;
  uint32_t S, D;
  moves_of(warp, lane, S, D);
  // k-block i from its raw slot into K-major slot i % 2, then the slot
  // refilled with k-block i + 2
  auto transpose = [&](int i) {
    const int s = i % DOT_RING;
    const uint8_t* src = raw + s * DOT_STAGE;
    uint8_t* dst = kmaj + s * DOT_STAGE;
    wg::bar_wait(&raw_full[s], (i / DOT_RING) & 1);
    // A: 32 x 32 blocks (cg over r, kg over k) in 32 warp iterations
    if (TMA_A) {
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) move(src, dst, S, D, ii);
    } else {
      for (int it = warp; it < 32; it += 8) {
        int cg, kg;
        block_of(it, lane, cg, kg);
        uint32_t w[4], tr[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int k = i * wg::KBLOCK + 4 * kg + j;
          w[j] = k < K ? load4(Ab + (int64_t)k * R + r0 + 4 * cg, R - r0 - 4 * cg,
                               aligned)
                       : 0u;
        }
        transpose4(w, tr);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          *reinterpret_cast<uint32_t*>(dst + sw128(4 * cg + j, 4 * kg)) = tr[j];
        }
      }
    }
    // B: 64 x 32 blocks (cg over n, two 128-byte halves) in 64 iterations
#pragma unroll
    for (int ii = 0; ii < 8; ++ii) move(src + DOT_RAW_A, dst + DOT_RAW_A, S, D, ii);
    wg::fence_async_smem();
    __syncthreads();                    // K-major slot written, raw slot read
    if (threadIdx.x == 0 && i + DOT_RING < KT) {
      wg::fence_async_smem();
      load_stage(i + DOT_RING);
    }
  };

  const int wgi = warp >> 2, w = warp & 3, g = lane >> 2, u = lane & 3;
  int32_t acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0;
  transpose(0);
  for (int i = 0; i < KT; ++i) {
    const uint8_t* st = kmaj + (i % DOT_RING) * DOT_STAGE;
    wg::hold(acc);
    wg::mma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wg::mma_64x256x32(acc, wg::desc_sw128(st + wgi * 64 * wg::KBLOCK + 32 * kk),
                        wg::desc_sw128(st + DOT_RAW_A + 32 * kk), i | kk);
    }
    wg::mma_commit();
    wg::hold(acc);
    if (i + 1 < KT) {
      wg::mma_wait<1>();                // k-block i - 1's reads of slot (i + 1) % 2 done
      transpose(i + 1);
    }
  }
  wg::mma_wait<0>();
  wg::hold(acc);
  // 16-byte stores: the even lane of a pair keeps row g and takes its
  // partner's two columns of it, the odd lane row g + 8
  const bool odd = u & 1;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int32_t s0 = __shfl_xor_sync(0xffffffffu, odd ? acc[4 * i] : acc[4 * i + 2], 1);
    const int32_t s1 =
        __shfl_xor_sync(0xffffffffu, odd ? acc[4 * i + 1] : acc[4 * i + 3], 1);
    const int row = r0 + wgi * 64 + w * 16 + g + (odd ? 8 : 0);
    const int col = n0 + 8 * i + 2 * (u & 2);
    if (row < R && n0 + 8 * i < N) {
      *reinterpret_cast<int4*>(C + ((int64_t)b * R + row) * N + col) =
          odd ? make_int4(s0, s1, acc[4 * i + 2], acc[4 * i + 3])
              : make_int4(acc[4 * i], acc[4 * i + 1], s0, s1);
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
// The digit matrix as the kernel reads it (ops/ntt_digit.py::kernel_table):
// 8F rows n of 8F bytes, K-major, row n = 64 (k / 8) + 32 (k % 2) +
// 8 (j / 2) + 2 ((k % 8) / 2) + j % 2 for frequency k and plane j, byte
// 8 m + a = digit j of centre(w^(m k) 256^a); a block's digits use the same
// contraction order, so a value's 8 digits are 8 consecutive bytes. In
// wgmma's accumulator lane 4 g + t then holds, in each 64-column group c of
// an n-tile, frequencies 8 c + 2 t and 8 c + 2 t + 1 with all 8 planes of
// each: d[4 (8 c + 4 e + j / 2) + 2 h + j % 2] is plane j of frequency
// 8 c + 2 t + e at row g + 8 h, and the two finished values go out as one
// 16-byte store.
constexpr int MAX_STAGES = 4;
constexpr int LEVEL_STAGE = wg::TILE_N * wg::KBLOCK;   // 256 table rows x 128 bytes
constexpr int SMEM_MAX = 232448;                       // a block's limit on Hopper

// NC warpgroups of 64 rows each; thread 0 keeps a ring of S table stages
// (256 rows x 128 bytes) full by TMA, refilling each stage once every warp
// has released it. For each n-tile of 256 columns each warpgroup multiplies
// its 64 rows by the tile's K / 128 stages (4 wgmma m64n256k32 a stage, one
// group in flight) and recombines, twists and stores its 32 frequencies;
// during the first n-tile it also digitizes its rows into the tile (K / 128
// k-blocks of BM x 128 bytes, 16-byte stores at the swizzled chunk), each
// k-block before its products, the next k-block's values loading
// meanwhile. BM = 32 (F = 512) lets a warpgroup's 64 rows run into the
// next k-block's rows; those 32 results are dropped.
template <int NC, int BM>
__global__ void __launch_bounds__(128 * NC, 1)
digit_level_kernel(const uint64_t* __restrict__ x, uint64_t* __restrict__ y,
                   const __grid_constant__ CUtensorMap vmap, int F, int R, int S,
                   Tail T) {
  extern __shared__ uint8_t level_smem[];
  uint8_t* As = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(level_smem) + 1023) & ~(uintptr_t)1023);
  const int K = 8 * F, KB = K / wg::KBLOCK, NT = K / wg::TILE_N, steps = NT * KB;
  uint8_t* Bs = As + (size_t)BM * K;
  uint64_t* full = reinterpret_cast<uint64_t*>(Bs + (size_t)S * LEVEL_STAGE);
  uint64_t* empty = full + MAX_STAGES;
  const int b = blockIdx.y, r0 = blockIdx.x * BM;
  const int tid = threadIdx.x, tw = tid & 127, lane = tid & 31;
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      wg::bar_init(&full[s], 1);
      wg::bar_init(&empty[s], 4 * NC);
    }
    wg::bar_init_fence();
  }
  __syncthreads();
  // thread 0: step `step`'s stage (n-tile step / KB, k-block step % KB)
  auto refill = [&](int step) {
    const int s = step % S;
    wg::bar_expect(&full[s], LEVEL_STAGE);
    wg::tma_load_2d(Bs + (size_t)s * LEVEL_STAGE, &vmap, &full[s],
                    (step % KB) * wg::KBLOCK, (step / KB) * wg::TILE_N);
  };
  // every warp: step `step`'s stage is read; thread 0 refills it with
  // step + S once all have
  auto release = [&](int step) {
    const int s = step % S;
    if (lane == 0) wg::bar_arrive(&empty[s]);
    if (tid == 0 && step + S < steps) {
      wg::bar_wait(&empty[s], (step / S) & 1);
      refill(step + S);
    }
  };
  if (tid == 0) {
    for (int step = 0; step < S && step < steps; ++step) refill(step);
  }

  // warpgroup wgi owns rows 64 wgi .. 64 wgi + 63 of the block and digitizes
  // them itself: thread tw takes row 64 wgi + tw % 64 and the value pairs
  // p = tw / 64 + 2 i, i < 4, of each k-block; pair p's 16 bytes go to
  // chunk p of the row
  const int wgi = tid >> 7, w = (tid >> 5) & 3, g = lane >> 2, t = lane & 3;
  const int drow = wgi * 64 + (tw & 63), dr = r0 + drow;
  const bool dlive = drow < BM && dr < R;
  const uint64_t* xs = x + (int64_t)b * F * R + (dlive ? dr : 0);
  auto fetch = [&](int kb, uint64_t (&v)[8]) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = 16 * kb + 2 * ((tw >> 6) + 2 * i);
      const bool live = dlive && kb < KB;
      v[2 * i] = live ? xs[(int64_t)m * R] : 0;
      v[2 * i + 1] = live ? xs[(int64_t)(m + 1) * R] : 0;
    }
  };
  uint64_t xv[8];
  fetch(0, xv);
  const uint8_t* Aw = As + wgi * 64 * wg::KBLOCK;
  int32_t acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0;
  int it = 0;
  for (int nt = 0; nt < NT; ++nt) {
    // this n-tile's twiddles, in flight during its products
    uint64_t wv[2][4][2];
    if (T.W) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + wgi * 64 + w * 16 + g + 8 * h;
        const uint64_t* wr = T.W + (size_t)((r < R ? r : 0) >> T.log_kprod) * F +
                             nt * 32 + 2 * t;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          wv[h][c][0] = wr[8 * c];
          wv[h][c][1] = wr[8 * c + 1];
        }
      }
    }
    for (int kb = 0; kb < KB; ++kb, ++it) {
      if (nt == 0) {
        if (drow < BM) {
          uint8_t* tile = As + (size_t)kb * BM * wg::KBLOCK;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const uint64_t d0 = digits_of(xv[2 * i]), d1 = digits_of(xv[2 * i + 1]);
            const int p = (tw >> 6) + 2 * i;
            *reinterpret_cast<uint4*>(tile + sw128(drow, 16 * p)) =
                make_uint4((uint32_t)d0, (uint32_t)(d0 >> 32), (uint32_t)d1,
                           (uint32_t)(d1 >> 32));
          }
        }
        fetch(kb + 1, xv);
        wg::fence_async_smem();
        wg::named_sync(1 + wgi, 128);
      }
      const int s = it % S;
      const uint8_t* a = Aw + (size_t)kb * BM * wg::KBLOCK;
      const uint8_t* bt = Bs + (size_t)s * LEVEL_STAGE;
      wg::bar_wait(&full[s], (it / S) & 1);
      wg::hold(acc);
      wg::mma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wg::mma_64x256x32(acc, wg::desc_sw128(a + 32 * kk), wg::desc_sw128(bt + 32 * kk),
                          kb | kk);
      }
      wg::mma_commit();
      wg::hold(acc);
      if (kb > 0) {
        wg::mma_wait<1>();
        release(it - 1);
      }
    }
    wg::mma_wait<0>();
    wg::hold(acc);
    release(it - 1);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int rl = wgi * 64 + w * 16 + g + 8 * h, r = r0 + rl;
      if (rl < BM && r < R) {
        uint64_t* dst = y + ((int64_t)b * R + r) * F + nt * 32 + 2 * t;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          uint64_t v[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            int32_t pl[8];
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              pl[j] = acc[4 * (8 * c + 4 * e + j / 2) + 2 * h + (j & 1)];
            }
            v[e] = recombine(pl, T.kc);
            if (T.W) v[e] = gl::mul(v[e], wv[h][c][e]);
            if (T.scale != 1) v[e] = gl::mul(v[e], T.scale);
          }
          *reinterpret_cast<ulonglong2*>(dst + 8 * c) = make_ulonglong2(v[0], v[1]);
        }
      }
    }
  }
}

template <int NC, int BM>
int launch_level(const uint64_t* x, const int8_t* V, uint64_t* y, int batch, int F,
                 int R, const Tail& T, cudaStream_t st) {
  const int K = 8 * F;
  // the map describes only (V, K): a level calls with the same cached
  // table again and again, so the last one is kept
  thread_local CUtensorMap map;
  thread_local const void* map_v = nullptr;
  thread_local int map_k = 0;
  if (map_v != V || map_k != K) {
    const uint64_t dims[2] = {(uint64_t)K, (uint64_t)K}, strides[1] = {(uint64_t)K};
    const uint32_t box[2] = {wg::KBLOCK, wg::TILE_N};
    map_v = nullptr;
    if (!wg::encode_s8(&map, V, 2, dims, strides, box, true)) {
      return (int)cudaErrorInvalidValue;
    }
    map_v = V;
    map_k = K;
  }
  const size_t fixed = 1024 + (size_t)BM * K + 2 * MAX_STAGES * 8;
  int S = (int)((SMEM_MAX - fixed) / LEVEL_STAGE);
  if (S > MAX_STAGES) S = MAX_STAGES;
  const size_t bytes = fixed + (size_t)S * LEVEL_STAGE;
  cudaError_t err = cudaFuncSetAttribute(
      digit_level_kernel<NC, BM>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((R + BM - 1) / BM), (unsigned)batch);
  digit_level_kernel<NC, BM><<<grid, 128 * NC, bytes, st>>>(x, y, map, F, R, S, T);
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

// A: (batch, K, R), V: (K, N) -> C: (batch, R, N); K % 64 == 0, N % 128 == 0,
// V 16-byte aligned. A goes by TMA when R % 16 == 0 and A is 16-byte aligned.
extern "C" int ms_digit_dot_s8(const int8_t* A, const int8_t* V, int32_t* C,
                               int batch, int K, int R, int N, void* stream) {
  if (batch < 1 || batch > 65535 || K < 64 || K % 64 || N < 128 || N % 128 || R < 1 ||
      (R + DOT_BM - 1) / DOT_BM > 65535 || reinterpret_cast<uintptr_t>(V) % 16) {
    return (int)cudaErrorInvalidValue;
  }
  CUtensorMap amap, vmap;
  const uint64_t vdims[2] = {(uint64_t)N, (uint64_t)K}, vstrides[1] = {(uint64_t)N};
  const uint32_t vbox[2] = {128, wg::KBLOCK};
  if (!wg::encode_s8(&vmap, V, 2, vdims, vstrides, vbox, true)) {
    return (int)cudaErrorInvalidValue;
  }
  const bool tma_a = R % 16 == 0 && reinterpret_cast<uintptr_t>(A) % 16 == 0;
  if (tma_a) {
    const uint64_t adims[3] = {(uint64_t)R, (uint64_t)K, (uint64_t)batch};
    const uint64_t astrides[2] = {(uint64_t)R, (uint64_t)K * R};
    const uint32_t abox[3] = {DOT_BM, wg::KBLOCK, 1};
    if (!wg::encode_s8(&amap, A, 3, adims, astrides, abox, true)) {
      return (int)cudaErrorInvalidValue;
    }
  } else {
    amap = vmap;                        // unused
  }
  auto kernel = tma_a ? digit_dot_kernel<true> : digit_dot_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)DOT_SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((N + wg::TILE_N - 1) / wg::TILE_N),
                  (unsigned)((R + DOT_BM - 1) / DOT_BM), (unsigned)batch);
  kernel<<<grid, DOT_THREADS, DOT_SMEM, (cudaStream_t)stream>>>(A, C, amap, vmap, K, R,
                                                                  N);
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
// V: the (8 F, 8 F) K-major kernel table (ops/ntt_digit.py::kernel_table),
// 16-byte aligned.
extern "C" int ms_digit_level_gl(const uint64_t* x, const int8_t* V, uint64_t* y,
                                 int batch, int F, int R, const uint64_t* W,
                                 int log_kprod, uint64_t scale, uint64_t kc,
                                 void* stream) {
  if (batch < 1 || batch > 65535 || !pow2(F) || F < 32 || F > 512 || R < 1 ||
      log_kprod < 0 || log_kprod > 30 || reinterpret_cast<uintptr_t>(V) % 16) {
    return (int)cudaErrorInvalidValue;
  }
  const Tail T{W, log_kprod, scale, kc};
  cudaStream_t s = (cudaStream_t)stream;
  if (F <= 128) return launch_level<2, 128>(x, V, y, batch, F, R, T, s);
  if (F == 256) return launch_level<1, 64>(x, V, y, batch, F, R, T, s);
  return launch_level<1, 32>(x, V, y, batch, F, R, T, s);
}
