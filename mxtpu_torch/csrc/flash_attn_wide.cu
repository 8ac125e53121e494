// Flash-attention forward and backward at head dims above 128, for Hopper
// (sm_90a), CUDA C++ on the tensor cores.
//
// Replaces, for D > 128, the Pallas TPU kernel
// mxtpu/ops/attention.py:_fwd_kernel (launched by _flash_call, whose
// BlockSpecs carry D whole, so it takes any D) and that kernel's custom VJP
// mxtpu/ops/attention.py:_flash3_bwd (XLA there, recomputing through
// _streaming). flash_attn_fwd.cu and flash_attn_bwd.cu take D <= 128 with
// D a template argument; this file is the pair for any D above that, D a
// runtime argument. Same functions as those two:
// - forward: o = softmax(q k^T * scale) v by an online softmax over kv
//   tiles, f32 running max m, normaliser l and accumulator; causal masking
//   top-left aligned (col <= row) even when T != S, and the kv tiles wholly
//   above a block's last row skipped; keys at or past S masked and their V
//   rows zero in shared memory, never read from device memory; the running
//   max clamped to 0 while it is -inf, so a fully masked tile gives p = 0;
//   p rounded to the input type before p.v (bf16) while l sums the
//   unrounded p; o = acc / l with l == 0 -> 1. With an lse pointer each row
//   also writes its natural-log log-sum-exp, +inf for a row with no key.
// - backward: from that lse, delta = rowsum(dO * O), then a dK/dV kernel
//   and a dQ kernel: P = exp(S - lse), dV = P^T dO, dP = dO V^T,
//   dS = P (dP - delta), dQ = scale dS K, dK = scale dS^T Q. Every output
//   element is written once, by the block that owns it, in a fixed order:
//   no atomics, so a repeated call gives the same bits.
//
// What bounds it on this card: at B = 4, H = 8, T = S = 1024, D = 256,
// causal, the forward does 4*D flops for each of ~16.8 M live pairs
// (~17.2 Gflop) against 134 MB of f32 q, k, v and o read or written once:
// ~128 flops a byte, bound by operations. f32 to f32 accuracy on the
// tensor cores takes three TF32 products a product (3xTF32, as in
// flash_attn_fwd.cu), so the f32 floor is ~0.10 ms at 495/3 TFLOP/s; bf16
// at 989 TFLOP/s is balanced near bytes (67 MB, ~0.02 ms). The backward's
// five products (seven here, S and dP in both kernels) make it more so.
//
// What the design does about that:
// - Every product on the tensor cores with mma.sync (mma_sm90.cuh): f32 as
//   3xTF32 (each operand split into TF32 big and small parts, the small
//   cross terms first), bf16 as m16n8k16 bf16 -> f32 with bf16 operands
//   read by ldmatrix (.trans for the p.v side). For TF32 the accumulator
//   layout (a thread holds columns 2t, 2t+1) differs from the A-operand
//   layout (k indices t, t+4), so the k index t stands for column 2t and
//   t+4 for 2t+1, and the B operand's rows are read in that order; the
//   scores stay in registers and feed the p.v (dS.K, P^T dO, dS^T Q)
//   products directly.
// - D is split into column groups, each owned by one warp (Cfg below).
//   A 16-row warp tile over all of D would not fit the registers (its O
//   accumulator alone is D/2 floats a thread); a warp here holds 16 rows x
//   kG columns whatever D is. At D <= 256 a block is 4 row tiles (64
//   stationary rows: query rows in the forward and the dQ kernel, keys in
//   the dK/dV kernel) by 2 column groups of 128: 8 warps, 256 output
//   columns. Each warp computes the partial scores of its rows over its
//   own columns (and, in the backward, the partial dP); the partials of a
//   row tile are summed through shared memory in the fixed order c = 0,
//   1, ... behind a named barrier of the row tile's warps, so every warp of
//   the tile holds the same bits of the full scores, runs the same online
//   softmax (or forms the same P and dS), and multiplies them into its own
//   output columns. Nothing is computed twice.
// - D past 256: the output columns are split across blocks along grid z
//   (Z = ceil(D / 256) blocks a row tile). Each such block needs the full
//   scores, so it recomputes them over all of D by streaming the
//   stationary operand too, chunk by chunk (256 columns a chunk), beside
//   the streamed tile's chunk; its own chunk comes last, so the tile's V
//   (dO and Q, or K) columns it multiplies by are the ones in the ring at
//   the end. That recompute is the price of any D: the forward does
//   2 D (Z + 1) flops a pair against 4 D (1.5x at D = 512, 2x at D = 640,
//   2.5x at D = 1024), the backward 2 D (4 Z + 3) against 10 D, and the
//   stationary chunks are read again for every streamed tile, which leaves
//   room for 32 rows and 64-column groups only. At D <= 256 (Z = 1) the
//   stationary chunk is staged once and stays resident (the bf16 forward
//   holds its q fragments in registers).
// - Shared memory and registers do not grow with D: every buffer is sized
//   by the 256-column chunk. Tiles go through a double-buffered ring of
//   cp.async copies, one block barrier a step: the next step's copies are
//   issued behind it, into the stage every warp has finished with, and fly
//   while the current step is multiplied. Rows past T or S and columns past
//   D (up to the chunk's end) are zero-filled, which the MMA's k-depth
//   needs, and never read from device memory. 16-byte copies where every
//   base is 16-byte aligned and a row is a multiple of 16 bytes (D % 4 == 0
//   in f32, D % 8 == 0 in bf16); else 4-byte copies (f32) or plain loads
//   (bf16). Rows are padded by 16 bytes, which keeps the fragment reads
//   free of bank conflicts. Column groups wholly past D are skipped, and a
//   group that D cuts skips its steps past D one by one; a whole group
//   runs with no test in its loops, so that the compiler can issue the
//   steps' shared loads ahead of their products (with a test at every
//   step the pair ran markedly slower).
//   The blocks use 164-211 KB of shared memory: one block (8 warps) a SM.
// - Grid: (head, row tile, column block), heads fastest and the heaviest
//   causal tiles first (the last query tile, the first key tile), so the
//   first wave runs every head's longest tiles and the light ones fill the
//   tail (a head-major order, kinder to L2, balanced the SMs worse and ran
//   slower). A row tile skips the kv tiles its causal mask wholly covers;
//   masks are applied only on tiles that cross an end or the diagonal.
#include <math.h>

#include "mma_sm90.cuh"

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// The tiling of one kernel instance: warps of kG columns, kWC of them a
// row tile (kC = kG * kWC output columns a block, and the D chunk), kWR
// 16-row tiles a block (kM stationary rows), kN rows a streamed tile.
template <typename T, int G, int WC, int WR, int N>
struct Shape {
  using Elem = T;
  static constexpr bool kF32 = sizeof(T) == 4;
  static constexpr int kG = G;
  static constexpr int kWC = WC;
  static constexpr int kWR = WR;
  static constexpr int kN = N;
  static constexpr int kC = G * WC;
  static constexpr int kM = 16 * WR;
  static constexpr int kWarps = WC * WR;  // warp w: row tile w / kWC
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kGT = G / 8;  // 8-column tiles of a group
  static constexpr int kNT = N / 8;  // 8-column tiles of a score tile
  static constexpr int kLd = kC + 16 / (int)sizeof(T);  // padded row
  static_assert(kC == 256, "one D chunk a column block");
};

// The instances' tilings (kernel type, backward, chunked), the fastest of
// those timed at B = 4, H = 8, T = S = 1024, D = 256 that fit 227 KB of
// shared memory (PERF.md records the others). D <= 256: 64 rows and
// 128-column groups (8 warps). D > 256 restreams the stationary chunk at
// every step, which leaves no room for 64 rows. flash_attn_wide_tiling
// reports them.
template <typename T, bool kBwd, bool kChunked>
struct Cfg;
template <>
struct Cfg<float, false, false> : Shape<float, 128, 2, 4, 32> {};
template <>
struct Cfg<float, false, true> : Shape<float, 64, 4, 2, 32> {};
template <>
struct Cfg<__nv_bfloat16, false, false> : Shape<__nv_bfloat16, 128, 2, 4, 64> {};
template <>
struct Cfg<__nv_bfloat16, false, true> : Shape<__nv_bfloat16, 64, 4, 2, 64> {};
template <>
struct Cfg<float, true, false> : Shape<float, 128, 2, 4, 16> {};
template <>
struct Cfg<float, true, true> : Shape<float, 64, 4, 2, 16> {};
template <>
struct Cfg<__nv_bfloat16, true, false> : Shape<__nv_bfloat16, 128, 2, 4, 32> {};
template <>
struct Cfg<__nv_bfloat16, true, true> : Shape<__nv_bfloat16, 64, 4, 2, 32> {};

constexpr int kChunk = 256;  // columns of a D chunk (every Cfg's kC)

// the forward's dynamic shared memory: the resident q chunk (Z = 1), a
// ring of two stages ([q chunk,] K chunk, V chunk), the partial scores
template <class C, bool kChunked>
constexpr size_t fwd_smem_bytes() {
  return (size_t)((kChunked ? 0 : C::kM) +
                  2 * ((kChunked ? C::kM : 0) + 2 * C::kN)) *
             C::kLd * sizeof(typename C::Elem) +
         (size_t)C::kWarps * C::kNT * 32 * sizeof(float4);
}

// the backward's: two resident stationary chunks (Z = 1), a ring of two
// stages ([two stationary chunks,] two streamed chunks), the partial S and
// dP, then the streamed rows' lse and delta [2][kN] each
template <class C, bool kChunked>
constexpr size_t bwd_smem_bytes() {
  return (size_t)((kChunked ? 0 : 2 * C::kM) +
                  2 * ((kChunked ? 2 * C::kM : 0) + 2 * C::kN)) *
             C::kLd * sizeof(typename C::Elem) +
         (size_t)2 * C::kWarps * C::kNT * 32 * sizeof(float4) +
         (size_t)4 * C::kN * sizeof(float);
}

// x = big + small for 3xTF32 (as split in mma_sm90.cuh): big rounded to
// TF32; small = x - big, exact in f32, passed unrounded: the tensor core
// reads a TF32 operand's top 19 bits, so small is truncated there (an
// error below 2^-21 |x| against split's 2^-22) for three instructions, not
// five
__device__ __forceinline__ void split3(float x, uint32_t& big,
                                       uint32_t& small) {
  big = tf32_rna(x);
  small = __float_as_uint(x - __uint_as_float(big));
}

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// the kWC warps of row tile r
template <class C>
__device__ __forceinline__ void group_sync(int r) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + r), "n"(C::kWC * 32)
               : "memory");
}

// Rows [r0, r0 + R) and columns [c0, c0 + kC) of a (n_rows, d) matrix into
// a shared tile with rows of kLd elements, by the block's threads, zero
// past n_rows and past d. vec: 16-byte cp.async (every row starts 16-byte
// aligned and d is a whole number of 16-byte words); else 4-byte cp.async
// for f32, plain loads for bf16.
template <class C, int R>
__device__ __forceinline__ void load_chunk(typename C::Elem* dst,
                                           const typename C::Elem* __restrict__ src,
                                           int r0, int n_rows, int d, int c0,
                                           bool vec, int tid) {
  using T = typename C::Elem;
  constexpr int kLd = C::kLd;
  constexpr int kThreads = C::kThreads;
  if (vec) {
    constexpr int kE = 16 / (int)sizeof(T);
    constexpr int kWords = C::kC / kE;  // 16-byte words a row
    static_assert(R * kWords % kThreads == 0, "whole rounds of copies");
#pragma unroll
    for (int i = 0; i < R * kWords / kThreads; ++i) {
      const int w = tid + i * kThreads;
      const int r = w / kWords, e = (w % kWords) * kE;
      const int gr = r0 + r, gc = c0 + e;
      const bool ok = gr < n_rows && gc < d;
      cp_async16(dst + r * kLd + e, src + (ok ? (size_t)gr * d + gc : 0),
                 ok ? 16 : 0);
    }
  } else {
    static_assert(R * C::kC % kThreads == 0, "whole rounds of copies");
#pragma unroll 4
    for (int i = 0; i < R * C::kC / kThreads; ++i) {
      const int w = tid + i * kThreads;
      const int r = w / C::kC, e = w % C::kC;
      const int gr = r0 + r, gc = c0 + e;
      const bool ok = gr < n_rows && gc < d;
      if constexpr (sizeof(T) == 4) {
        cp_async4(dst + r * kLd + e, src + (ok ? (size_t)gr * d + gc : 0),
                  ok ? 4 : 0);
      } else {
        dst[r * kLd + e] = ok ? src[(size_t)gr * d + gc] : from_f32<T>(0.f);
      }
    }
  }
}

// A warp's A operand: its 16 stationary rows over its column group, in
// shared memory; with kRegs its fragments are loaded once by init.
template <class C, bool kRegs, bool kF32 = C::kF32>
struct AOp;

template <class C, bool kRegs>
struct AOp<C, kRegs, true> {  // TF32 big and small parts, 8 columns a step
  static constexpr int kSlots = kRegs ? C::kGT : 1;
  const float* s;  // row g, column t of the group
  uint32_t big[kSlots][4], small[kSlots][4];

  __device__ __forceinline__ void split_step(int kk, int slot) {
    const float* p = s + kk * 8;  // rows g, g + 8; columns t, t + 4
    split3(p[0], big[slot][0], small[slot][0]);
    split3(p[8 * C::kLd], big[slot][1], small[slot][1]);
    split3(p[4], big[slot][2], small[slot][2]);
    split3(p[8 * C::kLd + 4], big[slot][3], small[slot][3]);
  }

  __device__ __forceinline__ void init(const float* warp_rows, int lane) {
    s = warp_rows + (lane >> 2) * C::kLd + (lane & 3);
    if constexpr (kRegs) {
#pragma unroll
      for (int kk = 0; kk < C::kGT; ++kk) split_step(kk, kk);
    }
  }

  // the slot that holds step kk's fragments
  __device__ __forceinline__ int fetch(int kk) {
    if constexpr (kRegs) {
      return kk;
    } else {
      split_step(kk, 0);
      return 0;
    }
  }
};

template <class C, bool kRegs>
struct AOp<C, kRegs, false> {  // bf16: 16 columns a step, by ldmatrix
  static constexpr int kSlots = kRegs ? C::kG / 16 : 1;
  const __nv_bfloat16* s;
  uint32_t a[kSlots][4];

  __device__ __forceinline__ void init(const __nv_bfloat16* warp_rows,
                                       int lane) {
    s = warp_rows + (lane & 15) * C::kLd + (lane >> 4) * 8;
    if constexpr (kRegs) {
#pragma unroll
      for (int kk = 0; kk < C::kG / 16; ++kk) ldsm_x4(a[kk], s + kk * 16);
    }
  }

  __device__ __forceinline__ int fetch(int kk) {
    if constexpr (kRegs) {
      return kk;
    } else {
      ldsm_x4(a[0], s + kk * 16);
      return 0;
    }
  }
};

// x[j] += A B^T over a column group: A the warp's rows (AOp), B the kN rows
// of a streamed tile at b (the group's first column); steps at or past
// `lim` columns are skipped (zero there). x[j][e] is (row g + 8*(e>>1),
// column j*8 + 2t + (e&1)).
template <class C, bool kFull, bool kRegs>
__device__ __forceinline__ void mma_abt_steps(float (&x)[C::kNT][4],
                                              AOp<C, kRegs>& a,
                                              const typename C::Elem* b,
                                              int lim, int lane) {
  constexpr int kLd = C::kLd;
  const int g = lane >> 2;
  const int t = lane & 3;
  if constexpr (C::kF32) {
#pragma unroll
    for (int kk = 0; kk < C::kGT; ++kk) {
      if (kFull || kk * 8 < lim) {
        const int sl = a.fetch(kk);
#pragma unroll
        for (int j = 0; j < C::kNT; ++j) {
          const float* br = b + (j * 8 + g) * kLd + kk * 8 + t;
          uint32_t bb0, bs0, bb1, bs1;
          split3(br[0], bb0, bs0);
          split3(br[4], bb1, bs1);
          mma_3xtf32(x[j], a.big[sl], a.small[sl], bb0, bb1, bs0, bs1);
        }
      }
    }
  } else {
#pragma unroll
    for (int kk = 0; kk < C::kG / 16; ++kk) {
      if (kFull || kk * 16 < lim) {
        const int sl = a.fetch(kk);
#pragma unroll
        for (int j = 0; j < C::kNT; j += 2) {
          uint32_t bf[4];
          ldsm_x4(bf, b + (j * 8 + (lane >> 4) * 8 + (lane & 7)) * kLd +
                          kk * 16 + ((lane >> 3) & 1) * 8);
          mma_bf16(x[j], a.a[sl], bf[0], bf[1]);
          mma_bf16(x[j + 1], a.a[sl], bf[2], bf[3]);
        }
      }
    }
  }
}

// z[i] += F B over a column group: F (16 x kN) in the accumulator layout of
// mma_abt, B the streamed tile's kN rows at b (the group's first column);
// 8-column tiles at or past `lim` are skipped. z[i][e] is (row
// g + 8*(e>>1), column i*8 + 2t + (e&1)). bf16: F rounded to bf16 as an
// operand (p.astype(v.dtype)).
template <class C, bool kFull>
__device__ __forceinline__ void mma_fb_tiles(float (&z)[C::kGT][4],
                                             const float (&f)[C::kNT][4],
                                             const typename C::Elem* b,
                                             int lim, int lane) {
  constexpr int kLd = C::kLd;
  const int g = lane >> 2;
  const int t = lane & 3;
  if constexpr (C::kF32) {
#pragma unroll
    for (int j = 0; j < C::kNT; ++j) {
      uint32_t fb[4], fs[4];  // k index t <-> column 2t, t + 4 <-> 2t + 1
      split3(f[j][0], fb[0], fs[0]);
      split3(f[j][2], fb[1], fs[1]);
      split3(f[j][1], fb[2], fs[2]);
      split3(f[j][3], fb[3], fs[3]);
      const float* br = b + (j * 8 + 2 * t) * kLd + g;
#pragma unroll
      for (int i = 0; i < C::kGT; ++i) {
        if (kFull || i * 8 < lim) {
          uint32_t bb0, bs0, bb1, bs1;
          split3(br[i * 8], bb0, bs0);
          split3(br[kLd + i * 8], bb1, bs1);
          mma_3xtf32(z[i], fb, fs, bb0, bb1, bs0, bs1);
        }
      }
    }
  } else {
#pragma unroll
    for (int kb = 0; kb < C::kN / 16; ++kb) {
      const uint32_t a[4] = {pack_bf16(f[2 * kb][0], f[2 * kb][1]),
                             pack_bf16(f[2 * kb][2], f[2 * kb][3]),
                             pack_bf16(f[2 * kb + 1][0], f[2 * kb + 1][1]),
                             pack_bf16(f[2 * kb + 1][2], f[2 * kb + 1][3])};
#pragma unroll
      for (int i = 0; i < C::kGT; i += 2) {
        if (kFull || i * 8 < lim) {
          uint32_t bf[4];
          ldsm_x4_trans(bf, b + (kb * 16 + ((lane >> 3) & 1) * 8 +
                                 (lane & 7)) * kLd +
                                (i + (lane >> 4)) * 8);
          mma_bf16(z[i], a, bf[0], bf[1]);
          mma_bf16(z[i + 1], a, bf[2], bf[3]);
        }
      }
    }
  }
}

// x[j] += A B^T over a column group (mma_abt_steps): with no per-step
// test where the whole group lies inside D, so the compiler can run the
// steps' loads ahead of their products
template <class C, bool kRegs>
__device__ __forceinline__ void mma_abt(float (&x)[C::kNT][4],
                                        AOp<C, kRegs>& a,
                                        const typename C::Elem* b, int lim,
                                        int lane) {
  if (lim >= C::kG)
    mma_abt_steps<C, true>(x, a, b, lim, lane);
  else if (lim > 0)
    mma_abt_steps<C, false>(x, a, b, lim, lane);
}

// z[i] += F B over a column group (mma_fb_tiles), likewise
template <class C>
__device__ __forceinline__ void mma_fb(float (&z)[C::kGT][4],
                                       const float (&f)[C::kNT][4],
                                       const typename C::Elem* b, int lim,
                                       int lane) {
  if (lim >= C::kG)
    mma_fb_tiles<C, true>(z, f, b, lim, lane);
  else if (lim > 0)
    mma_fb_tiles<C, false>(z, f, b, lim, lane);
}

// A warp's partial (its column group's) into buf: float4 [kWarps][kNT][32],
// a thread's 4 values of a tile in one word, lanes consecutive.
template <class C>
__device__ __forceinline__ void store_partial(float4* buf,
                                              const float (&x)[C::kNT][4],
                                              int warp, int lane) {
#pragma unroll
  for (int j = 0; j < C::kNT; ++j)
    buf[(warp * C::kNT + j) * 32 + lane] =
        make_float4(x[j][0], x[j][1], x[j][2], x[j][3]);
}

// x = the sum of row tile r's kWC partials in buf, in the order c = 0, 1,
// ...: the same bits in every warp of the tile
template <class C>
__device__ __forceinline__ void sum_partials(const float4* buf,
                                             float (&x)[C::kNT][4], int r,
                                             int lane) {
#pragma unroll
  for (int j = 0; j < C::kNT; ++j) {
    float4 s = buf[(r * C::kWC * C::kNT + j) * 32 + lane];
#pragma unroll
    for (int c = 1; c < C::kWC; ++c) {
      const float4 p = buf[((r * C::kWC + c) * C::kNT + j) * 32 + lane];
      s.x += p.x;
      s.y += p.y;
      s.z += p.z;
      s.w += p.w;
    }
    x[j][0] = s.x;
    x[j][1] = s.y;
    x[j][2] = s.z;
    x[j][3] = s.w;
  }
}

// columns col and col + 1 of a row of d elements, those at or past d
// skipped; vec: one 8-byte (f32) or 4-byte (bf16) store (d is then even)
template <typename T>
__device__ __forceinline__ void store2(T* row, int col, int d, float x0,
                                       float x1, bool vec) {
  if (col >= d) return;
  if (vec) {
    if constexpr (sizeof(T) == 4) {
      *reinterpret_cast<float2*>(row + col) = make_float2(x0, x1);
    } else {
      *reinterpret_cast<__nv_bfloat162*>(row + col) =
          __floats2bfloat162_rn(x0, x1);
    }
    return;
  }
  row[col] = from_f32<T>(x0);
  if (col + 1 < d) row[col + 1] = from_f32<T>(x1);
}

// forward of one (head, q tile, 256-column output block)
template <typename T, bool kChunked>
__global__ void __launch_bounds__(Cfg<T, false, kChunked>::kThreads, 1)
wide_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, T* __restrict__ o,
                float* __restrict__ lse, int t_len, int s_len, int d,
                float scale, int causal, int vec) {
  using C = Cfg<T, false, kChunked>;
  constexpr int kN = C::kN;
  constexpr int kM = C::kM;
  constexpr int kC = C::kC;
  constexpr int kG = C::kG;
  constexpr int kLd = C::kLd;
  constexpr int kNT = C::kNT;
  constexpr int kGT = C::kGT;
  constexpr int kStage = (kChunked ? kM : 0) + 2 * kN;  // rows of a stage
  // q fragments in registers: resident, and (f32) up to 64 columns
  constexpr bool kQRegs = !kChunked && (!C::kF32 || kG <= 64);
  extern __shared__ __align__(128) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);  // resident q chunk (Z = 1)
  T* ring = sQ + (kChunked ? 0 : kM * kLd);
  float4* xbuf = reinterpret_cast<float4*>(ring + 2 * kStage * kLd);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int r = warp / C::kWC;  // row tile
  const int c = warp % C::kWC;  // column group
  const size_t bh = blockIdx.x;
  const int row0 = (gridDim.y - 1 - blockIdx.y) * kM;  // heaviest first
  const int wrow0 = row0 + r * 16;
  const int z = blockIdx.z;
  const int n_chunks = gridDim.z;
  const int gcol = c * kG;         // the group's first column in a chunk
  const int out0 = z * kC + gcol;  // its first output column
  const T* qb = q + bh * (size_t)t_len * d;
  const T* kb = k + bh * (size_t)s_len * d;
  const T* vb = v + bh * (size_t)s_len * d;

  // causal: no key past the block's last row contributes
  const int last_row = min(row0 + kM, t_len) - 1;
  const int kv_end = causal ? min(s_len, last_row + 1) : s_len;
  const int n_tiles = (kv_end + kN - 1) / kN;
  const int n_steps = n_tiles * n_chunks;
  const bool tile_live = wrow0 < t_len;
  const int tile_last = min(wrow0 + 15, t_len - 1);

  // step s: kv tile s / n_chunks, its chunks in the order z + 1, ..., z
  // (mod n_chunks): the block's own chunk, whose V columns it needs, last
  auto load_step = [&](int s) {
    const int it = s / n_chunks;
    const int jj = s - it * n_chunks;
    const int c0 = ((z + 1 + jj) % n_chunks) * kC;
    T* st = ring + (s & 1) * kStage * kLd;
    if constexpr (kChunked)
      load_chunk<C, kM>(st, qb, row0, t_len, d, c0, vec, tid);
    T* sk = st + (kChunked ? kM : 0) * kLd;
    load_chunk<C, kN>(sk, kb, it * kN, s_len, d, c0, vec, tid);
    if (jj == n_chunks - 1)
      load_chunk<C, kN>(sk + kN * kLd, vb, it * kN, s_len, d, z * kC, vec,
                        tid);
  };

  if constexpr (!kChunked)
    load_chunk<C, kM>(sQ, qb, row0, t_len, d, 0, vec, tid);
  if (n_steps > 0) load_step(0);
  cp_async_commit();

  AOp<C, kQRegs> qa;

  float acc[kGT][4];
#pragma unroll
  for (int i = 0; i < kGT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  float sc[kNT][4];
  float m_row[2] = {-INFINITY, -INFINITY};  // rows g, g + 8, log2 domain
  float l_row[2] = {0.f, 0.f};              // this thread's keys only
  const float scale2 = scale * kLog2e;

  for (int s = 0; s < n_steps; ++s) {
    const int it = s / n_chunks;
    const int jj = s - it * n_chunks;
    const int c0 = ((z + 1 + jj) % n_chunks) * kC;
    const int kv0 = it * kN;
    cp_async_wait<0>();  // this step has landed ...
    __syncthreads();     // ... for every thread, and the last is done
    if (s + 1 < n_steps) load_step(s + 1);  // into the other stage
    cp_async_commit();
    if constexpr (kQRegs) {
      if (s == 0) qa.init(sQ + r * 16 * kLd + gcol, lane);
    }
    const T* st = ring + (s & 1) * kStage * kLd;
    const T* cK = st + (kChunked ? kM : 0) * kLd;
    const T* cV = cK + kN * kLd;

    // a row tile whose rows all lie above this kv tile skips it
    if (tile_live && !(causal && kv0 > tile_last)) {
      if (jj == 0) {
#pragma unroll
        for (int j = 0; j < kNT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
      }
      if constexpr (!kQRegs)
        qa.init((kChunked ? st : sQ) + r * 16 * kLd + gcol, lane);
      mma_abt<C>(sc, qa, cK + gcol, d - c0 - gcol, lane);

      if (jj == n_chunks - 1) {
        // the full scores: the row tile's partials summed in a fixed order
        store_partial<C>(xbuf, sc, warp, lane);
        group_sync<C>(r);
        sum_partials<C>(xbuf, sc, r, lane);

        // scale into the log2 domain; mask only where the tile needs it
        const bool mask =
            kv0 + kN > s_len || (causal && kv0 + kN - 1 > wrow0);
#pragma unroll
        for (int j = 0; j < kNT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float x = sc[j][e] * scale2;
            if (mask) {
              const int col = kv0 + j * 8 + 2 * t + (e & 1);
              const int row = wrow0 + g + (e >> 1) * 8;
              if (col >= s_len || (causal && col > row)) x = -INFINITY;
            }
            sc[j][e] = x;
          }

        // online softmax; the 4 threads of a group share a row
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float mx = -INFINITY;
#pragma unroll
          for (int j = 0; j < kNT; ++j)
            mx = fmaxf(mx, fmaxf(sc[j][2 * h], sc[j][2 * h + 1]));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
          const float m_new = fmaxf(m_row[h], mx);
          // a row with no live key yet keeps m = -inf; exp2(-inf - 0) = 0
          const float m_use = m_new == -INFINITY ? 0.f : m_new;
          const float alpha = exp2_approx(m_row[h] - m_use);
          m_row[h] = m_new;
          float sum = 0.f;
#pragma unroll
          for (int j = 0; j < kNT; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float p = exp2_approx(sc[j][2 * h + e] - m_use);
              sc[j][2 * h + e] = p;
              sum += p;
            }
          l_row[h] = l_row[h] * alpha + sum;
#pragma unroll
          for (int i = 0; i < kGT; ++i) {
            acc[i][2 * h] *= alpha;
            acc[i][2 * h + 1] *= alpha;
          }
        }

        // acc += p v over the group's output columns
        if (out0 < d) mma_fb<C>(acc, sc, cV + gcol, d - out0, lane);
      }
    }
  }
  cp_async_wait<0>();  // nothing in flight at exit (no step: q's copies)

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float l = l_row[h];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float denom = l == 0.f ? 1.f : l;
    const int row = wrow0 + g + 8 * h;
    if (row >= t_len) continue;
    if (lse != nullptr && z == 0 && c == 0 && t == 0)
      lse[bh * (size_t)t_len + row] =
          l == 0.f ? INFINITY : (m_row[h] + log2f(l)) * kLn2;
    T* orow = o + (bh * (size_t)t_len + row) * d;
#pragma unroll
    for (int i = 0; i < kGT; ++i)
      store2(orow, out0 + i * 8 + 2 * t, d, acc[i][2 * h] / denom,
             acc[i][2 * h + 1] / denom, vec);
  }
}

// delta = rowsum(dO * O) in f32, a warp a row
constexpr int kDeltaThreads = 256;

template <typename T>
__global__ void wide_delta_kernel(const T* __restrict__ o,
                                  const T* __restrict__ dout,
                                  float* __restrict__ delta, long long rows,
                                  int d) {
  const long long r = (long long)blockIdx.x * (kDeltaThreads / 32) +
                      (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (r >= rows) return;
  const T* orow = o + r * d;
  const T* grow = dout + r * d;
  float sum = 0.f;
  for (int c = lane; c < d; c += 32)
    sum = fmaf(widen(orow[c]), widen(grow[c]), sum);
#pragma unroll
  for (int off = 16; off; off >>= 1)
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (lane == 0) delta[r] = sum;
}

// One block of either gradient kernel. kKeys: the block's rows are keys
// (dK/dV kernel; it streams query rows with their dO, lse and delta);
// otherwise query rows (dQ kernel; it streams keys with their values).
// The warps of a row tile compute the partial S and dP (S^T and dP^T in
// the dK/dV kernel) of each streamed tile over their column groups, sum
// them through shared memory, and multiply P and dS into their own output
// columns.
template <typename T, bool kKeys, bool kChunked>
__device__ __forceinline__ void bwd_tile(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ out1,
    T* __restrict__ out2, int t_len, int s_len, int d, float scale,
    int causal, int vec) {
  using C = Cfg<T, true, kChunked>;
  constexpr int kN = C::kN;
  constexpr int kM = C::kM;
  constexpr int kC = C::kC;
  constexpr int kG = C::kG;
  constexpr int kLd = C::kLd;
  constexpr int kNT = C::kNT;
  constexpr int kGT = C::kGT;
  constexpr int kWarps = C::kWarps;
  // rows of a stage: [the two stationary chunks,] the two streamed chunks
  constexpr int kStage = (kChunked ? 2 * kM : 0) + 2 * kN;
  static_assert(kM % kN == 0, "streamed tiles align with row tiles");
  static_assert(2 * kN <= C::kThreads, "one thread per lse and delta word");
  extern __shared__ __align__(128) unsigned char smem[];
  T* sA = reinterpret_cast<T*>(smem);  // resident [2][kM][kLd] (Z = 1)
  T* ring = sA + (kChunked ? 0 : 2 * kM * kLd);
  float4* xbuf = reinterpret_cast<float4*>(ring + 2 * kStage * kLd);
  float* sLse = reinterpret_cast<float*>(xbuf + 2 * kWarps * kNT * 32);
  float* sDelta = sLse + 2 * kN;  // [2][kN] each

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int r = warp / C::kWC;
  const int c = warp % C::kWC;
  const int m_len = kKeys ? s_len : t_len;
  const int n_len = kKeys ? t_len : s_len;
  // heaviest causal tiles first: key tile 0 meets every row, the last
  // query tile every key
  const size_t bh = blockIdx.x;
  const int m0 = (kKeys ? blockIdx.y : gridDim.y - 1 - blockIdx.y) * kM;
  const int wm0 = m0 + r * 16;
  const int z = blockIdx.z;
  const int n_chunks = gridDim.z;
  const int gcol = c * kG;
  const int out0 = z * kC + gcol;
  const T* a1 = (kKeys ? k : q) + bh * (size_t)m_len * d;
  const T* a2 = (kKeys ? v : dout) + bh * (size_t)m_len * d;
  const T* b1 = (kKeys ? q : k) + bh * (size_t)n_len * d;
  const T* b2 = (kKeys ? dout : v) + bh * (size_t)n_len * d;
  const float* lse_b = lse + bh * (size_t)t_len;
  const float* delta_b = delta + bh * (size_t)t_len;

  // causal (key <= row): a key tile's walk starts at the query tile that
  // holds its first key's row; a query tile's stops after its last row
  int n_begin = 0, n_end = n_len;
  if (causal) {
    if (kKeys)
      n_begin = m0;
    else
      n_end = min(s_len, min(m0 + kM, t_len));
  }
  const int n_tiles = n_end > n_begin ? (n_end - n_begin + kN - 1) / kN : 0;
  const int n_steps = n_tiles * n_chunks;
  const bool tile_live = wm0 < m_len;
  const int tile_last = min(wm0 + 15, m_len - 1);

  // step s: streamed tile s / n_chunks, chunks z + 1, ..., z (mod
  // n_chunks): the block's own chunk, whose columns it multiplies by, last
  auto load_step = [&](int s) {
    const int it = s / n_chunks;
    const int jj = s - it * n_chunks;
    const int c0 = ((z + 1 + jj) % n_chunks) * kC;
    const int n0 = n_begin + it * kN;
    T* st = ring + (s & 1) * kStage * kLd;
    if constexpr (kChunked) {
      load_chunk<C, kM>(st, a1, m0, m_len, d, c0, vec, tid);
      load_chunk<C, kM>(st + kM * kLd, a2, m0, m_len, d, c0, vec, tid);
    }
    T* sb = st + (kChunked ? 2 * kM : 0) * kLd;
    load_chunk<C, kN>(sb, b1, n0, n_len, d, c0, vec, tid);
    load_chunk<C, kN>(sb + kN * kLd, b2, n0, n_len, d, c0, vec, tid);
    if constexpr (kKeys) {
      if (tid < 2 * kN) {  // lse, then delta, of the tile's query rows
        const int i = tid % kN;
        const bool ok = n0 + i < t_len;
        const float* src = (tid < kN ? lse_b : delta_b) + (ok ? n0 + i : 0);
        cp_async4((tid < kN ? sLse : sDelta) + (s & 1) * kN + i, src,
                  ok ? 4 : 0);
      }
    }
  };

  if constexpr (!kChunked) {
    load_chunk<C, kM>(sA, a1, m0, m_len, d, 0, vec, tid);
    load_chunk<C, kM>(sA + kM * kLd, a2, m0, m_len, d, 0, vec, tid);
  }
  if (n_steps > 0) load_step(0);
  cp_async_commit();

  AOp<C, false> op1, op2;  // read from shared memory at each use

  // dQ kernel: lse (log2 domain) and delta of rows g, g + 8, +inf and 0
  // past T, so P is 0 there
  float row_lse2[2] = {INFINITY, INFINITY}, row_delta[2] = {0.f, 0.f};
  if constexpr (!kKeys) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = wm0 + g + 8 * h;
      if (row < t_len) {
        row_lse2[h] = lse_b[row] * kLog2e;
        row_delta[h] = delta_b[row];
      }
    }
  }

  float acc1[kGT][4];              // dQ or dK
  float acc2[kKeys ? kGT : 1][4];  // dV
#pragma unroll
  for (int i = 0; i < kGT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc1[i][e] = 0.f;
#pragma unroll
  for (int i = 0; i < (kKeys ? kGT : 1); ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc2[i][e] = 0.f;
  float x[kNT][4], y[kNT][4];  // S and dP (transposed in dK/dV)
  const float scale2 = scale * kLog2e;

  for (int s = 0; s < n_steps; ++s) {
    const int it = s / n_chunks;
    const int jj = s - it * n_chunks;
    const int c0 = ((z + 1 + jj) % n_chunks) * kC;
    const int n0 = n_begin + it * kN;
    const int stage = s & 1;
    cp_async_wait<0>();  // this step has landed ...
    __syncthreads();     // ... for every thread, and the last is done
    if (s + 1 < n_steps) load_step(s + 1);  // into the other stage
    cp_async_commit();
    const T* st = ring + stage * kStage * kLd;
    const T* cB1 = st + (kChunked ? 2 * kM : 0) * kLd;
    const T* cB2 = cB1 + kN * kLd;

    // a row tile skips a streamed tile whose every pair is causally masked
    const bool skip =
        !tile_live ||
        (causal && (kKeys ? n0 + kN - 1 < wm0 : n0 > tile_last));
    if (!skip) {
      if (jj == 0) {
#pragma unroll
        for (int j = 0; j < kNT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) x[j][e] = y[j][e] = 0.f;
      }
      const T* sa = kChunked ? st : sA;
      op1.init(sa + r * 16 * kLd + gcol, lane);
      op2.init(sa + (kM + r * 16) * kLd + gcol, lane);
      const int lim = d - c0 - gcol;
      mma_abt<C>(x, op1, cB1 + gcol, lim, lane);
      mma_abt<C>(y, op2, cB2 + gcol, lim, lane);

      if (jj == n_chunks - 1) {
        store_partial<C>(xbuf, x, warp, lane);
        store_partial<C>(xbuf + kWarps * kNT * 32, y, warp, lane);
        group_sync<C>(r);
        sum_partials<C>(xbuf, x, r, lane);
        sum_partials<C>(xbuf + kWarps * kNT * 32, y, r, lane);

        // P = exp(S*scale - lse), dS = P (dP - delta); mask only where the
        // row tile's tile crosses S, T or the diagonal
        const int key_hi = kKeys ? wm0 + 15 : n0 + kN - 1;
        const int row_lo = kKeys ? n0 : wm0;
        const int row_hi = kKeys ? n0 + kN - 1 : wm0 + 15;
        const bool mask = key_hi >= s_len || row_hi >= t_len ||
                          (causal && key_hi > row_lo);
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
          float l2[2], dl[2];  // by column (dK/dV) or by row (dQ)
          if constexpr (kKeys) {
            const float2 ls = *reinterpret_cast<const float2*>(
                sLse + stage * kN + j * 8 + 2 * t);
            const float2 ds = *reinterpret_cast<const float2*>(
                sDelta + stage * kN + j * 8 + 2 * t);
            l2[0] = ls.x * kLog2e;
            l2[1] = ls.y * kLog2e;
            dl[0] = ds.x;
            dl[1] = ds.y;
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float lse2 = kKeys ? l2[e & 1] : row_lse2[e >> 1];
            const float dlt = kKeys ? dl[e & 1] : row_delta[e >> 1];
            float p = exp2_approx(fmaf(x[j][e], scale2, -lse2));
            if (mask) {
              const int mi = wm0 + g + 8 * (e >> 1);
              const int ni = n0 + j * 8 + 2 * t + (e & 1);
              const int key = kKeys ? mi : ni;
              const int row = kKeys ? ni : mi;
              if (key >= s_len || row >= t_len || (causal && key > row))
                p = 0.f;
            }
            x[j][e] = p;
            y[j][e] = p * (y[j][e] - dlt);
          }
        }

        if (out0 < d) {
          if constexpr (kKeys) {
            mma_fb<C>(acc2, x, cB2 + gcol, d - out0, lane);  // P^T dO
            mma_fb<C>(acc1, y, cB1 + gcol, d - out0, lane);  // dS^T Q
          } else {
            mma_fb<C>(acc1, y, cB1 + gcol, d - out0, lane);  // dS K
          }
        }
      }
    }
  }
  cp_async_wait<0>();  // nothing in flight at exit

  T* o1 = out1 + bh * (size_t)m_len * d;
  T* o2 = kKeys ? out2 + bh * (size_t)m_len * d : nullptr;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = wm0 + g + 8 * h;
    if (row >= m_len) continue;
#pragma unroll
    for (int i = 0; i < kGT; ++i) {
      const int col = out0 + i * 8 + 2 * t;
      store2(o1 + (size_t)row * d, col, d, acc1[i][2 * h] * scale,
             acc1[i][2 * h + 1] * scale, vec);
      if constexpr (kKeys)
        store2(o2 + (size_t)row * d, col, d, acc2[i][2 * h],
               acc2[i][2 * h + 1], vec);
    }
  }
}

// dK and dV of one (head, key tile, 256-column output block)
template <typename T, bool kChunked>
__global__ void __launch_bounds__(Cfg<T, true, kChunked>::kThreads, 1)
wide_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, T* __restrict__ dk,
                 T* __restrict__ dv, int t_len, int s_len, int d,
                 float scale, int causal, int vec) {
  bwd_tile<T, true, kChunked>(q, k, v, dout, lse, delta, dk, dv, t_len,
                              s_len, d, scale, causal, vec);
}

// dQ of one (head, q tile, 256-column output block)
template <typename T, bool kChunked>
__global__ void __launch_bounds__(Cfg<T, true, kChunked>::kThreads, 1)
wide_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const T* __restrict__ dout,
               const float* __restrict__ lse,
               const float* __restrict__ delta, T* __restrict__ dq,
               int t_len, int s_len, int d, float scale, int causal,
               int vec) {
  bwd_tile<T, false, kChunked>(q, k, v, dout, lse, delta, dq, nullptr,
                               t_len, s_len, d, scale, causal, vec);
}

// column blocks for head dim d: one a D chunk
int column_blocks(int d) { return (d + kChunk - 1) / kChunk; }

template <typename T, bool kChunked>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o,
                       float* lse, int bh, int t_len, int s_len, int d,
                       float scale, int causal, int vec,
                       cudaStream_t stream) {
  using C = Cfg<T, false, kChunked>;
  const int n_qt = (t_len + C::kM - 1) / C::kM;
  const int n_z = column_blocks(d);
  if (n_qt > 65535 || n_z > 65535) return cudaErrorInvalidValue;
  auto kernel = wide_fwd_kernel<T, kChunked>;
  constexpr size_t smem = fwd_smem_bytes<C, kChunked>();
  static std::atomic<unsigned long long> allowed{0};  // per instance
  const cudaError_t err = allow_smem(kernel, smem, allowed);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(bh, n_qt, n_z), C::kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, t_len, s_len, d,
      scale, causal, vec);
  return cudaGetLastError();
}

template <typename T, bool kChunked>
cudaError_t launch_grads(const T* q, const T* k, const T* v, const T* dout,
                         const float* lse, const float* delta, void* dq,
                         void* dk, void* dv, int bh, int t_len, int s_len,
                         int d, float scale, int causal, int vec,
                         cudaStream_t stream) {
  using C = Cfg<T, true, kChunked>;
  const int n_qt = (t_len + C::kM - 1) / C::kM;
  const int n_kt = (s_len + C::kM - 1) / C::kM;
  const int n_z = column_blocks(d);
  if (n_qt > 65535 || n_kt > 65535 || n_z > 65535)
    return cudaErrorInvalidValue;
  constexpr size_t smem = bwd_smem_bytes<C, kChunked>();
  cudaError_t err;
  if (n_kt > 0) {
    static std::atomic<unsigned long long> allowed{0};
    auto kernel = wide_dkdv_kernel<T, kChunked>;
    if ((err = allow_smem(kernel, smem, allowed)) != cudaSuccess) return err;
    kernel<<<dim3(bh, n_kt, n_z), C::kThreads, smem, stream>>>(
        q, k, v, dout, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv),
        t_len, s_len, d, scale, causal, vec);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if (n_qt > 0) {
    static std::atomic<unsigned long long> allowed{0};
    auto kernel = wide_dq_kernel<T, kChunked>;
    if ((err = allow_smem(kernel, smem, allowed)) != cudaSuccess) return err;
    kernel<<<dim3(bh, n_qt, n_z), C::kThreads, smem, stream>>>(
        q, k, v, dout, lse, delta, static_cast<T*>(dq), t_len, s_len, d,
        scale, causal, vec);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return cudaSuccess;
}

template <typename T>
cudaError_t fwd_t(const void* q, const void* k, const void* v, void* o,
                  float* lse, int bh, int t_len, int s_len, int d,
                  float scale, int causal, int vec, cudaStream_t stream) {
  return column_blocks(d) == 1
             ? launch_fwd<T, false>(q, k, v, o, lse, bh, t_len, s_len, d,
                                    scale, causal, vec, stream)
             : launch_fwd<T, true>(q, k, v, o, lse, bh, t_len, s_len, d,
                                   scale, causal, vec, stream);
}

template <typename T>
cudaError_t bwd_t(const void* q, const void* k, const void* v, const void* o,
                  const void* dout, const float* lse, float* delta, void* dq,
                  void* dk, void* dv, int bh, int t_len, int s_len, int d,
                  float scale, int causal, int vec, cudaStream_t stream) {
  const T* tq = static_cast<const T*>(q);
  const T* tk = static_cast<const T*>(k);
  const T* tv = static_cast<const T*>(v);
  const T* tdo = static_cast<const T*>(dout);
  if (t_len > 0) {
    const long long rows = (long long)bh * t_len;
    const int per = kDeltaThreads / 32;
    wide_delta_kernel<T><<<(unsigned)((rows + per - 1) / per), kDeltaThreads,
                           0, stream>>>(static_cast<const T*>(o), tdo, delta,
                                        rows, d);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return column_blocks(d) == 1
             ? launch_grads<T, false>(tq, tk, tv, tdo, lse, delta, dq, dk, dv,
                                      bh, t_len, s_len, d, scale, causal, vec,
                                      stream)
             : launch_grads<T, true>(tq, tk, tv, tdo, lse, delta, dq, dk, dv,
                                     bh, t_len, s_len, d, scale, causal, vec,
                                     stream);
}

// 16-byte copies need every base 16-byte aligned and rows of whole words
int vec_ok(uintptr_t bases, int d, int elem) {
  return (bases & 15) == 0 && (d * elem) % 16 == 0;
}

template <class C>
void tiling_of(int d, int* out) {
  out[0] = C::kC;
  out[1] = C::kM;
  out[2] = column_blocks(d);
}

template <typename T>
void tiling_t(int d, int backward, int* out) {
  const bool chunked = column_blocks(d) > 1;
  if (backward)
    chunked ? tiling_of<Cfg<T, true, true>>(d, out)
            : tiling_of<Cfg<T, true, false>>(d, out);
  else
    chunked ? tiling_of<Cfg<T, false, true>>(d, out)
            : tiling_of<Cfg<T, false, false>>(d, out);
}

}  // namespace

// As flash_attn_fwd (flash_attn_fwd.cu), for any head dim d >= 1:
// q (bh, t, d), k and v (bh, s, d), o (bh, t, d), contiguous, one dtype
// (0 = float32, 1 = bfloat16); lse (bh, t) float32, or null to skip it.
// Launches on `stream`, does not synchronise, and returns the launch's
// cudaError_t.
extern "C" int flash_attn_wide_fwd(const void* q, const void* k,
                                   const void* v, void* o, float* lse,
                                   int bh, int t_len, int s_len, int d,
                                   float scale, int causal, int dtype,
                                   void* stream) {
  if (bh <= 0 || t_len <= 0) return cudaSuccess;
  if (s_len < 0 || d < 1) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uintptr_t bases =
      reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
      reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o);
  if (dtype == 0)
    return fwd_t<float>(q, k, v, o, lse, bh, t_len, s_len, d, scale, causal,
                        vec_ok(bases, d, 4), st);
  if (dtype == 1)
    return fwd_t<__nv_bfloat16>(q, k, v, o, lse, bh, t_len, s_len, d, scale,
                                causal, vec_ok(bases, d, 2), st);
  return cudaErrorInvalidValue;
}

// As flash_attn_bwd (flash_attn_bwd.cu), for any head dim d >= 1:
// q, o, dout, dq (bh, t, d); k, v, dk, dv (bh, s, d), contiguous, one dtype;
// lse (bh, t) float32 from the forward; delta (bh, t) float32 scratch.
// Launches the delta, dK/dV and dQ kernels on `stream` in that order, does
// not synchronise, and returns the first launch error.
extern "C" int flash_attn_wide_bwd(const void* q, const void* k,
                                   const void* v, const void* o,
                                   const void* dout, const float* lse,
                                   float* delta, void* dq, void* dk,
                                   void* dv, int bh, int t_len, int s_len,
                                   int d, float scale, int causal, int dtype,
                                   void* stream) {
  if (bh <= 0) return cudaSuccess;
  if (t_len < 0 || s_len < 0 || d < 1) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uintptr_t bases =
      reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
      reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(dout) |
      reinterpret_cast<uintptr_t>(dq) | reinterpret_cast<uintptr_t>(dk) |
      reinterpret_cast<uintptr_t>(dv);
  if (dtype == 0)
    return bwd_t<float>(q, k, v, o, dout, lse, delta, dq, dk, dv, bh, t_len,
                        s_len, d, scale, causal, vec_ok(bases, d, 4), st);
  if (dtype == 1)
    return bwd_t<__nv_bfloat16>(q, k, v, o, dout, lse, delta, dq, dk, dv,
                                bh, t_len, s_len, d, scale, causal,
                                vec_ok(bases, d, 2), st);
  return cudaErrorInvalidValue;
}

// The launch shape at head dim d >= 1, dtype as above, of the forward
// (backward = 0) or of the dK/dV and dQ kernels (backward = 1): out[0] the
// output columns of a block (the D chunk), out[1] the stationary rows of a
// block, out[2] the column blocks of a row tile (grid z). Returns
// cudaErrorInvalidValue for another dtype or d < 1.
extern "C" int flash_attn_wide_tiling(int d, int dtype, int backward,
                                      int* out) {
  if (d < 1) return cudaErrorInvalidValue;
  if (dtype == 0)
    tiling_t<float>(d, backward, out);
  else if (dtype == 1)
    tiling_t<__nv_bfloat16>(d, backward, out);
  else
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

extern "C" const char* flash_attn_wide_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
