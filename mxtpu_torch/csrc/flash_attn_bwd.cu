// Flash-attention backward for Hopper (sm_90a), CUDA C++ on the tensor cores.
//
// Counterpart of mxtpu/ops/attention.py:_flash3_bwd, the custom VJP of the
// Pallas forward, which recomputes through _streaming's scan (XLA there, not
// Pallas). Same function: the gradient of o = softmax(q k^T * scale) v with
// the forward's masks (causal col <= row aligned top-left, keys past S
// masked), by the standard recompute from the forward's row log-sum-exp
// (flash_attn_fwd.cu, natural log; +inf for a row with no live key):
//   P = exp(S - lse), delta = rowsum(dO * O),
//   dV = P^T dO, dP = dO V^T, dS = P * (dP - delta),
//   dQ = scale * dS K, dK = scale * dS^T Q.
// No T x S matrix reaches device memory, and no tile of P or dS reaches
// shared memory: they stay in the registers of the warp that made them.
//
// What bounds it on this card: at the LM's shape (B = 4, H = 12,
// T = S = 1024, D = 64, causal) the gradient needs 5 products of 2*D flops
// for each live (row, key) pair, ~16.1 Gflop, against ~25 MB of q, k, v,
// o, dO, lse read and dq, dk, dv written once: ~650 flops per byte, bound
// by operations. f32 takes three TF32 products per product (below), so at
// 495/3 TFLOP/s; bf16 at 989 TFLOP/s. This design does 7 products (S and
// dP in both kernels), the price of writing every output tile once.
//
// What the design does about that:
// - Deterministic, with no atomics: a small pass for delta; a dK/dV kernel
//   with one block per (head, 64-key tile) that walks the query tiles from
//   its diagonal on; a dQ kernel with one block per (head, 64-row tile)
//   that walks the key tiles up to its diagonal, heaviest tiles first in
//   both. Each output element is written once, by the block that owns it.
// - Every product on the tensor cores with mma.sync, as in the forward
//   (mma_sm90.cuh): f32 as 3xTF32 (x = big + small, both TF32, and
//   small*big + big*small + big*big in f32), bf16 as m16n8k16 bf16 -> f32,
//   with P and dS rounded to bf16 as operands as the forward rounds p.
// - Each of a block's 4 warps owns 16 rows of the block's stationary tile
//   and computes with them the S and dP tiles of each streamed tile, so
//   both kernels are one routine (bwd_tile) with the roles swapped:
//   dQ kernel: rows are query rows; S = Q K^T and dP = dO V^T, then
//     dS = P (dP - delta) stays in registers as the A operand of dQ += dS K;
//   dK/dV kernel: rows are keys; it computes the transposes S^T = K Q^T and
//     dP^T = V dO^T, whose accumulators are already the A operands of
//     dV += P^T dO and dK += dS^T Q; lse and delta index its columns.
//   For TF32 the accumulator layout (a thread holds columns 2t, 2t+1)
//   differs from the A-operand layout (k indices t, t+4), so inside each
//   8-column step the k index t stands for column 2t and t+4 for 2t+1, and
//   the B operand (K, dO or Q) is read in that row order.
// - Operands keep their own type in shared memory (bf16 stays bf16, read
//   by ldmatrix; f32 by plain loads from rows padded by 16 bytes, free of
//   bank conflicts). The stationary tiles are read from shared memory per
//   use (bf16 up to D = 64 holds its fragments in registers), which keeps
//   the dK/dV warp's two D-wide accumulators and its two score tiles in
//   registers without spilling.
// - The streamed tiles (and, in the dK/dV kernel, their lse and delta) go
//   through a double-buffered ring of 16-byte (4-byte) cp.async copies,
//   zero-filled past the ends, so nothing past T or S is read; the next
//   tile's copy is in flight while the current one is multiplied. Pointers
//   that are not 16-byte aligned take plain loads into the same ring.
// - Rows past T and keys past S are masked on the tiles that cross the
//   ends or the diagonal; a warp skips a tile its mask wholly covers.
// - Tiles: 64 stationary rows per block; 32 streamed rows for f32 (and at
//   D = 128), 64 for bf16. At the LM's shape 32-row f32 tiles (70 KB of
//   shared memory a block, not 103) ran ~8 % faster than 64-row ones;
//   holding their registers to 168, for 3 blocks a SM, gained nothing
//   more. The kernels declare a minimum of one block a SM: ptxas then
//   allots more registers than with none (bf16 at D = 64: 216 and 249,
//   not 179 and 243), which ran 3-5 % faster.
#include <math.h>

#include "mma_sm90.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBlockM = 16 * kWarps;  // stationary rows per block, 16 a warp
constexpr float kLog2e = 1.4426950408889634f;

template <typename T, int D>
struct Cfg {
  static constexpr bool kF32 = sizeof(T) == 4;
  // rows of a streamed tile (see the note above)
  static constexpr int kBlockN = (kF32 || D == 128) ? 32 : 64;
  static constexpr int kLd = D + 16 / (int)sizeof(T);  // padded row, elements
  // bf16 A fragments held in registers for the whole walk
  static constexpr bool kARegs = !kF32 && D <= 64;
  // two stationary tiles, the streamed tiles B1[2] and B2[2], then the
  // streamed tile's lse and delta [2][kBlockN]
  static constexpr size_t kSmemBytes =
      (size_t)(2 * kBlockM + 4 * kBlockN) * kLd * sizeof(T) +
      4 * kBlockN * sizeof(float);
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// A warp's stationary A operand (its 16 rows of a tile, D wide) in shared
// memory; for bf16 up to D = 64 its fragments are loaded once.
template <typename T, int D>
struct AOperand {
  using C = Cfg<T, D>;
  const T* s;  // the warp's first row in shared memory
  uint32_t r[C::kARegs ? D / 16 : 1][4];

  __device__ __forceinline__ void init(const T* warp_rows, int lane) {
    s = warp_rows;
    if constexpr (C::kARegs) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) ldsm(r[kk], kk, lane);
    }
  }

  // bf16: the A fragment of dims kk*16 .. kk*16 + 15
  __device__ __forceinline__ void ldsm(uint32_t (&a)[4], int kk,
                                       int lane) const {
    ldsm_x4(a, s + (lane & 15) * C::kLd + kk * 16 + (lane >> 4) * 8);
  }

  __device__ __forceinline__ void bf16(uint32_t (&a)[4], int kk,
                                       int lane) const {
    if constexpr (C::kARegs) {
#pragma unroll
      for (int e = 0; e < 4; ++e) a[e] = r[kk][e];
    } else {
      ldsm(a, kk, lane);
    }
  }
};

// x[j] += A B^T over D: A the warp's 16 stationary rows, B the kN rows of
// a streamed tile; x[j][e] is (row g + 8*(e>>1), column j*8 + 2t + (e&1)).
template <typename T, int D>
__device__ __forceinline__ void mma_abt(float (&x)[Cfg<T, D>::kBlockN / 8][4],
                                        const AOperand<T, D>& a,
                                        const T* sb, int lane) {
  using C = Cfg<T, D>;
  constexpr int kLd = C::kLd;
  constexpr int kNT = C::kBlockN / 8;
  const int g = lane >> 2;
  const int t = lane & 3;
  if constexpr (C::kF32) {
    const float* sa = a.s + g * kLd + t;
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      // rows g, g + 8; dims kk*8 + t, kk*8 + t + 4
      uint32_t ab[4], as[4];
      split(sa[kk * 8], ab[0], as[0]);
      split(sa[8 * kLd + kk * 8], ab[1], as[1]);
      split(sa[kk * 8 + 4], ab[2], as[2]);
      split(sa[8 * kLd + kk * 8 + 4], ab[3], as[3]);
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const float* br = sb + (j * 8 + g) * kLd + kk * 8 + t;
        uint32_t bb0, bs0, bb1, bs1;
        split(br[0], bb0, bs0);
        split(br[4], bb1, bs1);
        mma_3xtf32(x[j], ab, as, bb0, bb1, bs0, bs1);
      }
    }
  } else {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t af[4];
      a.bf16(af, kk, lane);
#pragma unroll
      for (int j = 0; j < kNT; j += 2) {
        uint32_t b[4];
        ldsm_x4(b, sb + (j * 8 + (lane >> 4) * 8 + (lane & 7)) * kLd +
                       kk * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(x[j], af, b[0], b[1]);
        mma_bf16(x[j + 1], af, b[2], b[3]);
      }
    }
  }
}

// z[i] += F B: F (16 x kN) in the accumulator layout of mma_abt, B the
// streamed tile (kN x D), summed over its rows; z[i][e] is (row
// g + 8*(e>>1), dim i*8 + 2t + (e&1)).
template <typename T, int D>
__device__ __forceinline__ void mma_fb(float (&z)[D / 8][4],
                                       const float (&f)[Cfg<T, D>::kBlockN /
                                                        8][4],
                                       const T* sb, int lane) {
  using C = Cfg<T, D>;
  constexpr int kLd = C::kLd;
  constexpr int kN = C::kBlockN;
  const int g = lane >> 2;
  const int t = lane & 3;
  if constexpr (C::kF32) {
    // k index t <-> column 2t, t + 4 <-> column 2t + 1 of each 8-step
#pragma unroll
    for (int j = 0; j < kN / 8; ++j) {
      uint32_t fb[4], fs[4];
      split(f[j][0], fb[0], fs[0]);
      split(f[j][2], fb[1], fs[1]);
      split(f[j][1], fb[2], fs[2]);
      split(f[j][3], fb[3], fs[3]);
      const float* br = sb + (j * 8 + 2 * t) * kLd + g;
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        uint32_t bb0, bs0, bb1, bs1;
        split(br[i * 8], bb0, bs0);
        split(br[kLd + i * 8], bb1, bs1);
        mma_3xtf32(z[i], fb, fs, bb0, bb1, bs0, bs1);
      }
    }
  } else {
    // F rounded to bf16 as an operand, as the forward rounds p
#pragma unroll
    for (int kb = 0; kb < kN / 16; ++kb) {
      const uint32_t a[4] = {pack_bf16(f[2 * kb][0], f[2 * kb][1]),
                             pack_bf16(f[2 * kb][2], f[2 * kb][3]),
                             pack_bf16(f[2 * kb + 1][0], f[2 * kb + 1][1]),
                             pack_bf16(f[2 * kb + 1][2], f[2 * kb + 1][3])};
#pragma unroll
      for (int i = 0; i < D / 8; i += 2) {
        uint32_t b[4];
        ldsm_x4_trans(b, sb + (kb * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) *
                                  kLd +
                              (i + (lane >> 4)) * 8);
        mma_bf16(z[i], a, b[0], b[1]);
        mma_bf16(z[i + 1], a, b[2], b[3]);
      }
    }
  }
}

template <typename T>
__device__ __forceinline__ void store2(T* p, float x0, float x1, bool vec) {
  if constexpr (sizeof(T) == 4) {
    if (vec) {
      *reinterpret_cast<float2*>(p) = make_float2(x0, x1);
      return;
    }
  } else {
    if (vec) {
      *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x0, x1);
      return;
    }
  }
  p[0] = from_f32<T>(x0);
  p[1] = from_f32<T>(x1);
}

// One block of either gradient kernel. kKeys: the block's rows are 64 keys
// (dK/dV kernel; it streams query rows with their dO, lse and delta);
// otherwise 64 query rows (dQ kernel; it streams keys with their values).
template <typename T, int D, bool kKeys>
__device__ __forceinline__ void bwd_tile(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ out1,
    T* __restrict__ out2, int t_len, int s_len, float scale, int causal,
    int vec) {
  using C = Cfg<T, D>;
  constexpr int kN = C::kBlockN;
  constexpr int kLd = C::kLd;
  constexpr int kNT = kN / 8;  // 8-column tiles of S
  constexpr int kDT = D / 8;   // 8-dim column tiles of the gradients
  static_assert(2 * kN <= kThreads, "one thread per lse and delta word");
  extern __shared__ __align__(128) unsigned char smem[];
  T* sA1 = reinterpret_cast<T*>(smem);  // Q (dQ) or K (dK/dV)
  T* sA2 = sA1 + kBlockM * kLd;         // dO or V
  T* sB1 = sA2 + kBlockM * kLd;         // [2][kN][kLd]: K or Q
  T* sB2 = sB1 + 2 * kN * kLd;          // [2][kN][kLd]: V or dO
  float* sLse = reinterpret_cast<float*>(sB2 + 2 * kN * kLd);  // [2][kN]
  float* sDelta = sLse + 2 * kN;                                // [2][kN]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const size_t bh = blockIdx.x;
  const int m_len = kKeys ? s_len : t_len;
  const int n_len = kKeys ? t_len : s_len;
  // heaviest causal tiles first: key tile 0 meets every row, the last
  // query tile every key
  const int m0 = (kKeys ? blockIdx.y : gridDim.y - 1 - blockIdx.y) * kBlockM;
  const int wm0 = m0 + warp * 16;
  const T* a1 = (kKeys ? k : q) + bh * (size_t)m_len * D;
  const T* a2 = (kKeys ? v : dout) + bh * (size_t)m_len * D;
  const T* b1 = (kKeys ? q : k) + bh * (size_t)n_len * D;
  const T* b2 = (kKeys ? dout : v) + bh * (size_t)n_len * D;
  const float* lse_b = lse + bh * (size_t)t_len;
  const float* delta_b = delta + bh * (size_t)t_len;

  // causal (key <= row): a key tile's walk starts at the query tile that
  // holds its first key's row (kN divides kBlockM); a query tile's stops
  // after its last row
  static_assert(kBlockM % kN == 0, "streamed tiles align with row tiles");
  int n_begin = 0, n_end = n_len;
  if (causal) {
    if (kKeys)
      n_begin = m0;
    else
      n_end = min(s_len, min(m0 + kBlockM, t_len));
  }
  const int n_tiles = n_end > n_begin ? (n_end - n_begin + kN - 1) / kN : 0;
  const bool warp_live = wm0 < m_len;
  const int warp_last = min(wm0 + 15, m_len - 1);

  auto load_tile = [&](int stage, int n0) {
    load_rows<T, D, kLd, kN, kThreads>(sB1 + stage * kN * kLd, b1, n0, n_len,
                                       vec, tid);
    load_rows<T, D, kLd, kN, kThreads>(sB2 + stage * kN * kLd, b2, n0, n_len,
                                       vec, tid);
    if constexpr (kKeys) {
      if (tid < 2 * kN) {  // lse, then delta, of the tile's query rows
        const int i = tid % kN;
        const bool ok = n0 + i < t_len;
        const float* src = (tid < kN ? lse_b : delta_b) + (ok ? n0 + i : 0);
        cp_async4((tid < kN ? sLse : sDelta) + stage * kN + i, src,
                  ok ? 4 : 0);
      }
    }
  };

  load_rows<T, D, kLd, kBlockM, kThreads>(sA1, a1, m0, m_len, vec, tid);
  load_rows<T, D, kLd, kBlockM, kThreads>(sA2, a2, m0, m_len, vec, tid);
  cp_async_commit();
  if (n_tiles > 0) load_tile(0, n_begin);
  cp_async_commit();
  cp_async_wait<1>();  // the stationary tiles have landed
  __syncthreads();

  AOperand<T, D> op1, op2;
  op1.init(sA1 + warp * 16 * kLd, lane);
  op2.init(sA2 + warp * 16 * kLd, lane);

  // dQ kernel: lse (log2 domain) and delta of rows g, g + 8, +inf and 0
  // past T, so P is 0 there
  float row_lse2[2] = {INFINITY, INFINITY}, row_delta[2] = {0.f, 0.f};
  if constexpr (!kKeys) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = wm0 + g + 8 * r;
      if (row < t_len) {
        row_lse2[r] = lse_b[row] * kLog2e;
        row_delta[r] = delta_b[row];
      }
    }
  }

  float acc1[kDT][4];                // dQ or dK
  float acc2[kKeys ? kDT : 1][4];    // dV
#pragma unroll
  for (int i = 0; i < kDT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc1[i][e] = 0.f;
#pragma unroll
  for (int i = 0; i < (kKeys ? kDT : 1); ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc2[i][e] = 0.f;
  const float scale2 = scale * kLog2e;

  for (int it = 0; it < n_tiles; ++it) {
    const int n0 = n_begin + it * kN;
    const int stage = it & 1;
    if (it + 1 < n_tiles) load_tile(stage ^ 1, n0 + kN);  // prefetch
    cp_async_commit();
    cp_async_wait<1>();  // this tile has landed
    __syncthreads();
    const T* cB1 = sB1 + stage * kN * kLd;
    const T* cB2 = sB2 + stage * kN * kLd;

    // a warp skips a tile whose every (row, key) pair is causally masked
    const bool skip = !warp_live ||
                      (causal && (kKeys ? n0 + kN - 1 < wm0 : n0 > warp_last));
    if (!skip) {
      float x[kNT][4], y[kNT][4];  // S and dP (transposed in dK/dV)
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) x[j][e] = y[j][e] = 0.f;
      mma_abt<T, D>(x, op1, cB1, lane);
      mma_abt<T, D>(y, op2, cB2, lane);

      // P = exp(S*scale - lse), dS = P (dP - delta); mask only where the
      // warp's tile crosses S, T or the diagonal
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

      if constexpr (kKeys) {
        mma_fb<T, D>(acc2, x, cB2, lane);  // dV += P^T dO
        mma_fb<T, D>(acc1, y, cB1, lane);  // dK += dS^T Q
      } else {
        mma_fb<T, D>(acc1, y, cB1, lane);  // dQ += dS K
      }
    }
    __syncthreads();  // every warp is done with this stage
  }

  T* o1 = out1 + bh * (size_t)m_len * D;
  T* o2 = kKeys ? out2 + bh * (size_t)m_len * D : nullptr;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = wm0 + g + 8 * r;
    if (row >= m_len) continue;
#pragma unroll
    for (int i = 0; i < kDT; ++i) {
      const size_t at = (size_t)row * D + i * 8 + 2 * t;
      store2(o1 + at, acc1[i][2 * r] * scale, acc1[i][2 * r + 1] * scale,
             vec);
      if constexpr (kKeys)
        store2(o2 + at, acc2[i][2 * r], acc2[i][2 * r + 1], vec);
    }
  }
}

// delta[row] = sum_d dO[row, d] * O[row, d], one warp per row
template <typename T>
__global__ void __launch_bounds__(256)
flash_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                       float* __restrict__ delta, int rows, int d) {
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const T* orow = o + (size_t)row * d;
  const T* grow = dout + (size_t)row * d;
  float sum = 0.f;
  for (int c = lane; c < d; c += 32) sum += to_f32(orow[c]) * to_f32(grow[c]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (lane == 0) delta[row] = sum;
}

// dK and dV of one (head, 64-key tile)
template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dk,
                      T* __restrict__ dv, int t_len, int s_len, float scale,
                      int causal, int vec) {
  bwd_tile<T, D, true>(q, k, v, dout, lse, delta, dk, dv, t_len, s_len,
                       scale, causal, vec);
}

// dQ of one (head, 64-row tile)
template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int t_len, int s_len, float scale, int causal, int vec) {
  bwd_tile<T, D, false>(q, k, v, dout, lse, delta, dq, nullptr, t_len, s_len,
                        scale, causal, vec);
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* o, const void* dout, const float* lse,
                   float* delta, void* dq, void* dk, void* dv, int bh,
                   int t_len, int s_len, float scale, int causal, int vec,
                   cudaStream_t stream) {
  using C = Cfg<T, D>;
  const int n_qt = (t_len + kBlockM - 1) / kBlockM;
  const int n_kt = (s_len + kBlockM - 1) / kBlockM;
  if (n_qt > 65535 || n_kt > 65535) return cudaErrorInvalidValue;
  const T* tq = static_cast<const T*>(q);
  const T* tk = static_cast<const T*>(k);
  const T* tv = static_cast<const T*>(v);
  const T* tdo = static_cast<const T*>(dout);
  cudaError_t err;
  if (t_len > 0) {
    const long long rows = (long long)bh * t_len;
    flash_bwd_delta_kernel<T><<<(unsigned)((rows + 7) / 8), 256, 0,
                                stream>>>(static_cast<const T*>(o), tdo,
                                          delta, (int)rows, D);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if (n_kt > 0) {
    static std::atomic<unsigned long long> allowed{0};
    auto kernel = flash_bwd_dkdv_kernel<T, D>;
    if ((err = allow_smem(kernel, C::kSmemBytes, allowed)) != cudaSuccess)
      return err;
    kernel<<<dim3(bh, n_kt), kThreads, C::kSmemBytes, stream>>>(
        tq, tk, tv, tdo, lse, delta, static_cast<T*>(dk),
        static_cast<T*>(dv), t_len, s_len, scale, causal, vec);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if (n_qt > 0) {
    static std::atomic<unsigned long long> allowed{0};
    auto kernel = flash_bwd_dq_kernel<T, D>;
    if ((err = allow_smem(kernel, C::kSmemBytes, allowed)) != cudaSuccess)
      return err;
    kernel<<<dim3(bh, n_qt), kThreads, C::kSmemBytes, stream>>>(
        tq, tk, tv, tdo, lse, delta, static_cast<T*>(dq), t_len, s_len,
        scale, causal, vec);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return cudaSuccess;
}

template <typename T>
cudaError_t launch_d(const void* q, const void* k, const void* v,
                     const void* o, const void* dout, const float* lse,
                     float* delta, void* dq, void* dk, void* dv, int bh,
                     int t_len, int s_len, int d, float scale, int causal,
                     int vec, cudaStream_t stream) {
  switch (d) {
    case 32:
      return launch<T, 32>(q, k, v, o, dout, lse, delta, dq, dk, dv, bh,
                           t_len, s_len, scale, causal, vec, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, dout, lse, delta, dq, dk, dv, bh,
                           t_len, s_len, scale, causal, vec, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, dout, lse, delta, dq, dk, dv, bh,
                            t_len, s_len, scale, causal, vec, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, o, dout, dq (bh, t, d); k, v, dk, dv (bh, s, d): contiguous, one dtype
// (0 = float32, 1 = bfloat16). lse (bh, t) float32 from flash_attn_fwd;
// delta (bh, t) float32 scratch. Launches the delta, dK/dV and dQ kernels
// on `stream` in that order, does not synchronise, and returns the first
// launch error (cudaSuccess when all three were accepted).
extern "C" int flash_attn_bwd(const void* q, const void* k, const void* v,
                              const void* o, const void* dout,
                              const float* lse, float* delta, void* dq,
                              void* dk, void* dv, int bh, int t_len,
                              int s_len, int d, float scale, int causal,
                              int dtype, void* stream) {
  if (bh <= 0) return cudaSuccess;
  if (t_len < 0 || s_len < 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int vec = ((reinterpret_cast<uintptr_t>(q) |
                    reinterpret_cast<uintptr_t>(k) |
                    reinterpret_cast<uintptr_t>(v) |
                    reinterpret_cast<uintptr_t>(dout) |
                    reinterpret_cast<uintptr_t>(dq) |
                    reinterpret_cast<uintptr_t>(dk) |
                    reinterpret_cast<uintptr_t>(dv)) & 15) == 0;
  if (dtype == 0)
    return launch_d<float>(q, k, v, o, dout, lse, delta, dq, dk, dv, bh,
                           t_len, s_len, d, scale, causal, vec, st);
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(q, k, v, o, dout, lse, delta, dq, dk, dv,
                                   bh, t_len, s_len, d, scale, causal, vec,
                                   st);
  return cudaErrorInvalidValue;
}

extern "C" const char* flash_attn_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
