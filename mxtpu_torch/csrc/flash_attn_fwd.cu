// Flash-attention forward for Hopper (sm_90a), CUDA C++ on the tensor cores.
//
// Replaces the Pallas TPU kernel mxtpu/ops/attention.py:_fwd_kernel
// (launched by _flash_call). Same function: o = softmax(q k^T * scale) v
// with an online softmax, f32 running max m, normaliser l and f32
// accumulator; causal masking is top-left aligned (col <= row) even when
// T != S; p is rounded to the input type before p.v (bf16 inputs) while l
// sums the unrounded p; the running max is clamped to 0 while it is -inf,
// so a fully masked tile gives p = 0; the output is acc / l with
// l == 0 -> 1 (S = 0 gives 0). Where the caller passes an lse pointer,
// the kernel's kLse instance runs (a null pointer runs the instance
// without it, the served path's code unchanged), and each row also writes
// its log-sum-exp for the backward (flash_attn_bwd.cu):
// in the natural log, lse = ln(sum_j exp(s_j * scale)), computed from the
// log2-domain running max m and normaliser l as (m + log2(l)) * ln 2; a row
// with no live key (S = 0) writes +inf, so exp(s - lse) is 0 there.
//
// What bounds it on this card: at the serving path's shape (T = S = 1024,
// D = 64, causal) a head does 4*D flops for each of the T(T+1)/2 live
// (row, key) pairs, ~134 Mflop, against 16*T*D = 1 MB of f32 q, k, v and o
// read or written once: ~128 flops per byte. f32 to f32 accuracy on the
// tensor cores takes three TF32 products per product (below), so the f32
// kernel is bound by operations at 495/3 TFLOP/s; bf16 at 989 TFLOP/s is
// balanced near bytes (3.35 TB/s).
//
// What the design does about that:
// - Products on the tensor cores with mma.sync. f32 runs m16n8k8 TF32 as
//   3xTF32: each operand x is split into big = rna_tf32(x) and
//   small = rna_tf32(x - big) (round to nearest, ties away from zero, as
//   cvt.rna.tf32.f32), and big*small + small*big + big*big (the
//   small cross terms first) accumulate in f32, which keeps f32-grade
//   error where one TF32 pass keeps ~3 decimal digits. bf16 runs m16n8k16
//   bf16 -> f32.
// - Each of the block's 4 warps owns 16 query rows; the scores S of a kv
//   tile stay in registers and feed the p.v product directly. For TF32 the
//   accumulator layout (a thread holds keys 2t, 2t+1) differs from the
//   A-operand layout (keys t, t+4), so inside each 8-key step the k index t
//   stands for key 2t and t+4 for key 2t+1, and V's rows are read in that
//   order. bf16 operands come from shared memory by ldmatrix (.trans for
//   V); f32 ones by plain loads from rows padded by 16 bytes, which keeps
//   every fragment read free of bank conflicts.
// - K/V tiles go through a double-buffered ring in dynamic shared memory,
//   filled by 16-byte cp.async copies (zero-filled past S, so rows past
//   kv_len are never read); the next tile's copy is in flight while the
//   current one is multiplied. Pointers that are not 16-byte aligned take
//   plain loads into the same ring.
// - 64 query rows per block, so B = 1 (12 heads x 1024 rows) puts 192
//   blocks on the 132 SMs. Heads run along grid x and q tiles along grid
//   y, heaviest causal tile first, so every head's long tiles start in the
//   first wave. The causal mask is applied only on tiles that cross a
//   warp's diagonal, a warp skips tiles wholly above its diagonal, and a
//   block stops at its last row's diagonal.
// - f32 q fragments (big and small) stay in registers up to D = 64; at
//   D = 128 they are read from shared memory and split per tile, and the
//   kv tile is 32 keys, to stay clear of spills.
#include <math.h>

#include "mma_sm90.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBlockM = 16 * kWarps;  // query rows per block, 16 per warp
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

template <typename T, int D>
struct Cfg {
  static constexpr bool kF32 = sizeof(T) == 4;
  static constexpr int kBlockN = (kF32 && D == 128) ? 32 : 64;  // keys/tile
  static constexpr int kLd = D + 16 / (int)sizeof(T);  // padded row, elements
  static constexpr bool kQInSmem = kF32 && D == 128;
  // q tile, then K[2] and V[2] kv tiles
  static constexpr size_t kSmemBytes =
      (size_t)(kBlockM + 4 * kBlockN) * kLd * sizeof(T);
};

// Per-warp fragments of q, held for the whole kv loop (unless kQInSmem).
template <typename T, int D, bool kF32 = Cfg<T, D>::kF32>
struct QFrag;

template <typename T, int D>
struct QFrag<T, D, true> {  // f32: TF32 big and small parts, 8 dims a step
  static constexpr int kSteps = Cfg<T, D>::kQInSmem ? 1 : D / 8;
  uint32_t big[kSteps][4], small[kSteps][4];

  // A operand of step kk: rows g, g + 8; dims kk*8 + t, kk*8 + t + 4
  __device__ __forceinline__ void fetch(const float* sq, int kk, int slot) {
    constexpr int kLd = Cfg<T, D>::kLd;
    const float* p = sq + kk * 8;
    split(p[0], big[slot][0], small[slot][0]);
    split(p[8 * kLd], big[slot][1], small[slot][1]);
    split(p[4], big[slot][2], small[slot][2]);
    split(p[8 * kLd + 4], big[slot][3], small[slot][3]);
  }
};

template <typename T, int D>
struct QFrag<T, D, false> {  // bf16: A operands, 16 dims a step
  uint32_t a[D / 16][4];
};

template <typename T, int D, bool kLse>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int t_len, int s_len, float scale,
                 int causal, int vec) {
  using C = Cfg<T, D>;
  static_assert(C::kF32 || !C::kQInSmem, "q stays in shared memory for f32");
  constexpr int kN = C::kBlockN;
  constexpr int kLd = C::kLd;
  constexpr int kNT = kN / 8;  // 8-key column tiles of S
  constexpr int kDT = D / 8;   // 8-dim column tiles of o
  extern __shared__ __align__(128) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sK = sQ + kBlockM * kLd;  // [2][kN][kLd]
  T* sV = sK + 2 * kN * kLd;   // [2][kN][kLd]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;  // fragment row group
  const int t = lane & 3;   // thread in group
  const size_t bh = blockIdx.x;
  const int q_tile = gridDim.y - 1 - blockIdx.y;  // heaviest tiles first
  const int row0 = q_tile * kBlockM;
  const int wrow0 = row0 + warp * 16;
  const T* qb = q + bh * (size_t)t_len * D;
  const T* kb = k + bh * (size_t)s_len * D;
  const T* vb = v + bh * (size_t)s_len * D;
  T* ob = o + bh * (size_t)t_len * D;

  // causal: no column past the block's last row contributes
  const int last_row = min(row0 + kBlockM, t_len) - 1;
  const int kv_end = causal ? min(s_len, last_row + 1) : s_len;
  const int n_tiles = (kv_end + kN - 1) / kN;
  const bool warp_live = wrow0 < t_len;
  const int warp_last = min(wrow0 + 15, t_len - 1);

  load_rows<T, D, kLd, kBlockM, kThreads>(sQ, qb, row0, t_len, vec, tid);
  cp_async_commit();
  if (n_tiles > 0) {
    load_rows<T, D, kLd, kN, kThreads>(sK, kb, 0, s_len, vec, tid);
    load_rows<T, D, kLd, kN, kThreads>(sV, vb, 0, s_len, vec, tid);
  }
  cp_async_commit();
  cp_async_wait<1>();  // q has landed
  __syncthreads();

  QFrag<T, D> qf;
  const T* sq_warp = sQ + (warp * 16) * kLd;
  if constexpr (C::kF32) {
    if constexpr (!C::kQInSmem) {
#pragma unroll
      for (int kk = 0; kk < kDT; ++kk)
        qf.fetch(sq_warp + g * kLd + t, kk, kk);
    }
  } else {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      ldsm_x4(qf.a[kk], sq_warp + (lane & 15) * kLd + kk * 16 + (lane >> 4) * 8);
  }

  float acc[kDT][4];
#pragma unroll
  for (int i = 0; i < kDT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  float m_row[2] = {-INFINITY, -INFINITY};  // rows g and g + 8, log2 domain
  float l_row[2] = {0.f, 0.f};              // this thread's columns only
  const float scale2 = scale * kLog2e;

  for (int it = 0; it < n_tiles; ++it) {
    const int kv0 = it * kN;
    const int stage = it & 1;
    if (it + 1 < n_tiles) {  // prefetch the next tile into the other stage
      load_rows<T, D, kLd, kN, kThreads>(sK + (stage ^ 1) * kN * kLd, kb,
                                         kv0 + kN, s_len, vec, tid);
      load_rows<T, D, kLd, kN, kThreads>(sV + (stage ^ 1) * kN * kLd, vb,
                                         kv0 + kN, s_len, vec, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this tile has landed
    __syncthreads();
    const T* cK = sK + stage * kN * kLd;
    const T* cV = sV + stage * kN * kLd;

    // a warp whose rows all lie above this tile's first column skips it
    if (warp_live && !(causal && kv0 > warp_last)) {
      float s[kNT][4];
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;

      // S = q k^T: c[e] of tile j is (row g + 8*(e>>1), key j*8 + 2t + (e&1))
      if constexpr (C::kF32) {
#pragma unroll
        for (int kk = 0; kk < kDT; ++kk) {
          const int slot = C::kQInSmem ? 0 : kk;
          if constexpr (C::kQInSmem) qf.fetch(sq_warp + g * kLd + t, kk, 0);
#pragma unroll
          for (int j = 0; j < kNT; ++j) {
            const float* kr = cK + (j * 8 + g) * kLd + kk * 8 + t;
            uint32_t bb0, bs0, bb1, bs1;
            split(kr[0], bb0, bs0);
            split(kr[4], bb1, bs1);
            mma_3xtf32(s[j], qf.big[slot], qf.small[slot], bb0, bb1, bs0,
                       bs1);
          }
        }
      } else {
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
          for (int j = 0; j < kNT; j += 2) {
            uint32_t b[4];
            ldsm_x4(b, cK + (j * 8 + (lane >> 4) * 8 + (lane & 7)) * kLd +
                           kk * 16 + ((lane >> 3) & 1) * 8);
            mma_bf16(s[j], qf.a[kk], b[0], b[1]);
            mma_bf16(s[j + 1], qf.a[kk], b[2], b[3]);
          }
        }
      }

      // scale into the log2 domain; mask only where the tile needs it
      const bool mask = kv0 + kN > s_len || (causal && kv0 + kN - 1 > wrow0);
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[j][e] * scale2;
          if (mask) {
            const int col = kv0 + j * 8 + 2 * t + (e & 1);
            const int row = wrow0 + g + (e >> 1) * 8;
            if (col >= s_len || (causal && col > row)) x = -INFINITY;
          }
          s[j][e] = x;
        }

      // online softmax; the 4 threads of a group share a row
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < kNT; ++j)
          mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m_row[r], mx);
        // a row with no live column yet keeps m = -inf; exp2(-inf - 0) = 0
        const float m_use = m_new == -INFINITY ? 0.f : m_new;
        const float alpha = exp2_approx(m_row[r] - m_use);
        m_row[r] = m_new;
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < kNT; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const float p = exp2_approx(s[j][2 * r + c] - m_use);
            s[j][2 * r + c] = p;
            sum += p;
          }
        l_row[r] = l_row[r] * alpha + sum;
#pragma unroll
        for (int i = 0; i < kDT; ++i) {
          acc[i][2 * r] *= alpha;
          acc[i][2 * r + 1] *= alpha;
        }
      }

      // acc += p v
      if constexpr (C::kF32) {
        // k index t <-> key 2t, t + 4 <-> key 2t + 1 of each 8-key step
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
          uint32_t pb[4], ps[4];
          split(s[j][0], pb[0], ps[0]);
          split(s[j][2], pb[1], ps[1]);
          split(s[j][1], pb[2], ps[2]);
          split(s[j][3], pb[3], ps[3]);
          const float* vr = cV + (j * 8 + 2 * t) * kLd + g;
#pragma unroll
          for (int i = 0; i < kDT; ++i) {
            uint32_t bb0, bs0, bb1, bs1;
            split(vr[i * 8], bb0, bs0);
            split(vr[kLd + i * 8], bb1, bs1);
            mma_3xtf32(acc[i], pb, ps, bb0, bb1, bs0, bs1);
          }
        }
      } else {
        // p rounded to bf16 (p.astype(v.dtype)); l kept the unrounded sum
#pragma unroll
        for (int kb16 = 0; kb16 < kN / 16; ++kb16) {
          const uint32_t a[4] = {
              pack_bf16(s[2 * kb16][0], s[2 * kb16][1]),
              pack_bf16(s[2 * kb16][2], s[2 * kb16][3]),
              pack_bf16(s[2 * kb16 + 1][0], s[2 * kb16 + 1][1]),
              pack_bf16(s[2 * kb16 + 1][2], s[2 * kb16 + 1][3])};
#pragma unroll
          for (int i = 0; i < kDT; i += 2) {
            uint32_t b[4];
            ldsm_x4_trans(b, cV + (kb16 * 16 + ((lane >> 3) & 1) * 8 +
                                   (lane & 7)) * kLd +
                                 (i + (lane >> 4)) * 8);
            mma_bf16(acc[i], a, b[0], b[1]);
            mma_bf16(acc[i + 1], a, b[2], b[3]);
          }
        }
      }
    }
    __syncthreads();  // every warp is done with this stage
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_row[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float denom = l == 0.f ? 1.f : l;
    const int row = wrow0 + g + 8 * r;
    if (row >= t_len) continue;
    if (kLse && t == 0)
      lse[bh * (size_t)t_len + row] =
          l == 0.f ? INFINITY : (m_row[r] + log2f(l)) * kLn2;
    T* orow = ob + (size_t)row * D + 2 * t;
#pragma unroll
    for (int i = 0; i < kDT; ++i) {
      const float x0 = acc[i][2 * r] / denom;
      const float x1 = acc[i][2 * r + 1] / denom;
      if constexpr (C::kF32) {
        if (vec) {
          *reinterpret_cast<float2*>(orow + i * 8) = make_float2(x0, x1);
        } else {
          orow[i * 8] = x0;
          orow[i * 8 + 1] = x1;
        }
      } else {
        if (vec) {
          *reinterpret_cast<__nv_bfloat162*>(orow + i * 8) =
              __floats2bfloat162_rn(x0, x1);
        } else {
          orow[i * 8] = __float2bfloat16(x0);
          orow[i * 8 + 1] = __float2bfloat16(x1);
        }
      }
    }
  }
}

template <typename T, int D, bool kLse>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int bh, int t_len, int s_len, float scale,
                   int causal, int vec, cudaStream_t stream) {
  using C = Cfg<T, D>;
  const int n_qt = (t_len + kBlockM - 1) / kBlockM;
  if (n_qt > 65535) return cudaErrorInvalidValue;
  auto kernel = flash_fwd_kernel<T, D, kLse>;
  static std::atomic<unsigned long long> allowed{0};  // per instance
  const cudaError_t err = allow_smem(kernel, C::kSmemBytes, allowed);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, n_qt);
  kernel<<<grid, kThreads, C::kSmemBytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, t_len, s_len,
      scale, causal, vec);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const void* q, const void* k, const void* v, void* o,
                     float* lse, int bh, int t_len, int s_len, int d,
                     float scale, int causal, int vec, cudaStream_t stream) {
  switch (d) {
    case 32:
      return lse ? launch<T, 32, true>(q, k, v, o, lse, bh, t_len, s_len,
                                       scale, causal, vec, stream)
                 : launch<T, 32, false>(q, k, v, o, lse, bh, t_len, s_len,
                                        scale, causal, vec, stream);
    case 64:
      return lse ? launch<T, 64, true>(q, k, v, o, lse, bh, t_len, s_len,
                                       scale, causal, vec, stream)
                 : launch<T, 64, false>(q, k, v, o, lse, bh, t_len, s_len,
                                        scale, causal, vec, stream);
    case 128:
      return lse ? launch<T, 128, true>(q, k, v, o, lse, bh, t_len, s_len,
                                        scale, causal, vec, stream)
                 : launch<T, 128, false>(q, k, v, o, lse, bh, t_len, s_len,
                                         scale, causal, vec, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (bh, t, d), k and v (bh, s, d), o (bh, t, d): contiguous, one dtype
// (0 = float32, 1 = bfloat16); lse (bh, t) float32, or null to skip it.
// Launches on `stream`, does not synchronise, and returns the launch's
// cudaError_t.
extern "C" int flash_attn_fwd(const void* q, const void* k, const void* v,
                              void* o, float* lse, int bh, int t_len,
                              int s_len, int d, float scale, int causal,
                              int dtype, void* stream) {
  if (bh <= 0 || t_len <= 0) return cudaSuccess;
  if (s_len < 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int vec = ((reinterpret_cast<uintptr_t>(q) |
                    reinterpret_cast<uintptr_t>(k) |
                    reinterpret_cast<uintptr_t>(v) |
                    reinterpret_cast<uintptr_t>(o)) & 15) == 0;
  if (dtype == 0)
    return launch_d<float>(q, k, v, o, lse, bh, t_len, s_len, d, scale,
                           causal, vec, st);
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(q, k, v, o, lse, bh, t_len, s_len, d,
                                   scale, causal, vec, st);
  return cudaErrorInvalidValue;
}

extern "C" const char* flash_attn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
