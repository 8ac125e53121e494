// Flash-attention backward for Hopper (sm_90a), CUDA C++ on the CUDA cores.
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
// No T x S matrix reaches device memory: P and dS live one 64 x 64 tile at
// a time in shared memory.
//
// What bounds it on this card: at the LM's shape (B = 4, H = 12,
// T = S = 1024, D = 64, causal) the two kernels below do 7 products of
// 2*D flops for each live (row, key) pair (S and dP in both, dV and dK in
// one, dQ in the other): ~22.6 Gflop of f32 against ~25 MB of q, k, v, o,
// dO, lse read and dq, dk, dv written once, ~900 flops per byte. It is
// bound by operations: on the CUDA cores, at 67 TFLOP/s of f32 FMA.
//
// What the design does about that (a simple kernel first):
// - Deterministic, with no atomics: one small pass for delta; a dK/dV kernel
//   with one block per (head, 64-key tile) that walks the query tiles from
//   its diagonal on and keeps dK and dV in registers; a dQ kernel with one
//   block per (head, 64-row tile) that walks the key tiles up to its
//   diagonal and keeps dQ in registers. Each output is written once.
// - Tiles are float32 in shared memory (bf16 inputs are widened as they
//   are loaded), rows padded to an odd stride, so a warp's column walk hits
//   32 banks. Each of 256 threads owns a 4 x 4 block of the 64 x 64 score
//   tile (rows ty + 16 r, keys tx + 16 c) and a 4 x D/16 block of the
//   accumulators, one FMA per product term.
// - Rows past T and keys past S are zero-filled in shared memory and never
//   read from device memory; their P is 0 (lse = +inf past T, masked past
//   S), so NaN beyond the tensors' ends cannot enter a sum. The causal mask
//   is applied only on tiles that cross the diagonal.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;  // query rows and keys per tile
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Cfg {
  static constexpr int kLd = D + 1;          // padded f32 row of q, k, v, dO
  static constexpr int kLdS = kTile + 1;     // padded f32 row of P, dS
  static constexpr int kDC = D / 16;         // accumulator dims per thread
  static constexpr int kTileF = kTile * kLd;
  static constexpr int kScoreF = kTile * kLdS;
  // dK/dV: k, v, q, dO tiles, P and dS, lse2 and delta of the q tile
  static constexpr size_t kSmemDkdv =
      (size_t)(4 * kTileF + 2 * kScoreF + 2 * kTile) * sizeof(float);
  // dQ: q, dO, k, v tiles, dS, lse2 and delta
  static constexpr size_t kSmemDq =
      (size_t)(4 * kTileF + kScoreF + 2 * kTile) * sizeof(float);
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// 2^x by the SFU, as the forward computes it (2^-inf = 0)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Rows [row0, row0 + kTile) of a (n_rows, D) matrix into a padded f32 tile;
// rows past n_rows are zero-filled.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int row0,
                                          int n_rows, int tid) {
  constexpr int kLd = Cfg<D>::kLd;
  for (int e = tid; e < kTile * D; e += kThreads) {
    const int r = e / D;
    const int c = e % D;
    const int gr = row0 + r;
    dst[r * kLd + c] = gr < n_rows ? to_f32(src[(size_t)gr * D + c]) : 0.f;
  }
}

// The q tile's lse in the log2 domain (+inf past T, so P = 0 there) and
// its delta (0 past T).
__device__ __forceinline__ void load_rows_stats(float* s_lse2, float* s_delta,
                                                const float* lse,
                                                const float* delta, int row0,
                                                int t_len, int tid) {
  if (tid < kTile) {
    const int row = row0 + tid;
    s_lse2[tid] = row < t_len ? lse[row] * kLog2e : INFINITY;
    s_delta[tid] = row < t_len ? delta[row] : 0.f;
  }
}

// acc[r][c] = sum_k A[ty + 16 r][k] * B[tx + 16 c][k] over two padded tiles
template <int D>
__device__ __forceinline__ void tile_abt(float (&acc)[4][4], const float* a,
                                         const float* b, int ty, int tx) {
  constexpr int kLd = Cfg<D>::kLd;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
#pragma unroll 8
  for (int k = 0; k < D; ++k) {
    float av[4], bv[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) av[r] = a[(ty + 16 * r) * kLd + k];
#pragma unroll
    for (int c = 0; c < 4; ++c) bv[c] = b[(tx + 16 * c) * kLd + k];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
  }
}

// P and dS of one (q tile, kv tile) pair, from this thread's S and dP
// blocks: rows ty + 16 r of the q tile at q0, keys tx + 16 c of the kv tile
// at kv0. Writes P to s_p (when given) and dS to s_ds.
template <int D>
__device__ __forceinline__ void scores_to_p_ds(
    const float (&s)[4][4], const float (&dp)[4][4], const float* s_lse2,
    const float* s_delta, float* s_p, float* s_ds, float scale2, int q0,
    int kv0, int s_len, bool causal, int ty, int tx) {
  constexpr int kLdS = Cfg<D>::kLdS;
  const bool mask = kv0 + kTile > s_len || (causal && kv0 + kTile - 1 > q0);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = ty + 16 * r;
    const float lse2 = s_lse2[i];
    const float dlt = s_delta[i];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = tx + 16 * c;
      float p = exp2_approx(s[r][c] * scale2 - lse2);
      if (mask) {
        const int col = kv0 + j;
        if (col >= s_len || (causal && col > q0 + i)) p = 0.f;
      }
      if (s_p != nullptr) s_p[i * kLdS + j] = p;
      s_ds[i * kLdS + j] = p * (dp[r][c] - dlt);
    }
  }
}

// delta[row] = sum_d dO[row, d] * O[row, d], one warp per row
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                       float* __restrict__ delta, int rows, int d) {
  const int row = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
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

// dK and dV of one (head, 64-key tile): walks the q tiles from the
// diagonal on (all of them without the causal mask).
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dk,
                      T* __restrict__ dv, int t_len, int s_len, float scale,
                      int causal) {
  using C = Cfg<D>;
  constexpr int kLd = C::kLd;
  constexpr int kLdS = C::kLdS;
  constexpr int kDC = C::kDC;
  extern __shared__ __align__(16) float smem[];
  float* sK = smem;
  float* sV = sK + C::kTileF;
  float* sQ = sV + C::kTileF;
  float* sdO = sQ + C::kTileF;
  float* sP = sdO + C::kTileF;
  float* sdS = sP + C::kScoreF;
  float* sLse2 = sdS + C::kScoreF;
  float* sDelta = sLse2 + kTile;

  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;
  const size_t bh = blockIdx.x;
  const int kv0 = blockIdx.y * kTile;
  const T* qb = q + bh * (size_t)t_len * D;
  const T* gb = dout + bh * (size_t)t_len * D;
  const float* lb = lse + bh * (size_t)t_len;
  const float* db = delta + bh * (size_t)t_len;
  const float scale2 = scale * kLog2e;

  load_tile<T, D>(sK, k + bh * (size_t)s_len * D, kv0, s_len, tid);
  load_tile<T, D>(sV, v + bh * (size_t)s_len * D, kv0, s_len, tid);

  float dk_acc[4][kDC], dv_acc[4][kDC];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < kDC; ++c) dk_acc[r][c] = dv_acc[r][c] = 0.f;

  // causal: row kv0 is the first that sees key kv0
  const int n_qt = (t_len + kTile - 1) / kTile;
  for (int qt = causal ? kv0 / kTile : 0; qt < n_qt; ++qt) {
    const int q0 = qt * kTile;
    __syncthreads();  // the last tile's readers are done
    load_tile<T, D>(sQ, qb, q0, t_len, tid);
    load_tile<T, D>(sdO, gb, q0, t_len, tid);
    load_rows_stats(sLse2, sDelta, lb + q0, db + q0, 0, t_len - q0, tid);
    __syncthreads();

    float s[4][4], dp[4][4];
    tile_abt<D>(s, sQ, sK, ty, tx);
    tile_abt<D>(dp, sdO, sV, ty, tx);
    scores_to_p_ds<D>(s, dp, sLse2, sDelta, sP, sdS, scale2, q0, kv0, s_len,
                      causal, ty, tx);
    __syncthreads();

    // dV[j] += sum_i P[i][j] dO[i], dK[j] += sum_i dS[i][j] Q[i]
#pragma unroll 4
    for (int i = 0; i < kTile; ++i) {
      float pv[4], dsv[4], gv[kDC], qv[kDC];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        pv[r] = sP[i * kLdS + ty + 16 * r];
        dsv[r] = sdS[i * kLdS + ty + 16 * r];
      }
#pragma unroll
      for (int c = 0; c < kDC; ++c) {
        gv[c] = sdO[i * kLd + tx + 16 * c];
        qv[c] = sQ[i * kLd + tx + 16 * c];
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < kDC; ++c) {
          dv_acc[r][c] = fmaf(pv[r], gv[c], dv_acc[r][c]);
          dk_acc[r][c] = fmaf(dsv[r], qv[c], dk_acc[r][c]);
        }
    }
  }

  T* dkb = dk + bh * (size_t)s_len * D;
  T* dvb = dv + bh * (size_t)s_len * D;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int key = kv0 + ty + 16 * r;
    if (key >= s_len) continue;
#pragma unroll
    for (int c = 0; c < kDC; ++c) {
      const size_t at = (size_t)key * D + tx + 16 * c;
      dkb[at] = from_f32<T>(dk_acc[r][c] * scale);
      dvb[at] = from_f32<T>(dv_acc[r][c]);
    }
  }
}

// dQ of one (head, 64-row tile): walks the kv tiles up to the diagonal.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int t_len, int s_len, float scale, int causal) {
  using C = Cfg<D>;
  constexpr int kLd = C::kLd;
  constexpr int kLdS = C::kLdS;
  constexpr int kDC = C::kDC;
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;
  float* sdO = sQ + C::kTileF;
  float* sK = sdO + C::kTileF;
  float* sV = sK + C::kTileF;
  float* sdS = sV + C::kTileF;
  float* sLse2 = sdS + C::kScoreF;
  float* sDelta = sLse2 + kTile;

  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;
  const size_t bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTile;  // heaviest first
  const T* kb = k + bh * (size_t)s_len * D;
  const T* vb = v + bh * (size_t)s_len * D;
  const float scale2 = scale * kLog2e;

  load_tile<T, D>(sQ, q + bh * (size_t)t_len * D, q0, t_len, tid);
  load_tile<T, D>(sdO, dout + bh * (size_t)t_len * D, q0, t_len, tid);
  load_rows_stats(sLse2, sDelta, lse + bh * (size_t)t_len + q0,
                  delta + bh * (size_t)t_len + q0, 0, t_len - q0, tid);

  float dq_acc[4][kDC];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < kDC; ++c) dq_acc[r][c] = 0.f;

  // causal: no key past the tile's last row contributes
  const int last_row = min(q0 + kTile, t_len) - 1;
  const int kv_end = causal ? min(s_len, last_row + 1) : s_len;
  for (int kv0 = 0; kv0 < kv_end; kv0 += kTile) {
    __syncthreads();  // the last tile's readers are done
    load_tile<T, D>(sK, kb, kv0, s_len, tid);
    load_tile<T, D>(sV, vb, kv0, s_len, tid);
    __syncthreads();

    float s[4][4], dp[4][4];
    tile_abt<D>(s, sQ, sK, ty, tx);
    tile_abt<D>(dp, sdO, sV, ty, tx);
    scores_to_p_ds<D>(s, dp, sLse2, sDelta, nullptr, sdS, scale2, q0, kv0,
                      s_len, causal, ty, tx);
    __syncthreads();

    // dQ[i] += sum_j dS[i][j] K[j]
#pragma unroll 4
    for (int j = 0; j < kTile; ++j) {
      float dsv[4], kv[kDC];
#pragma unroll
      for (int r = 0; r < 4; ++r) dsv[r] = sdS[(ty + 16 * r) * kLdS + j];
#pragma unroll
      for (int c = 0; c < kDC; ++c) kv[c] = sK[j * kLd + tx + 16 * c];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < kDC; ++c)
          dq_acc[r][c] = fmaf(dsv[r], kv[c], dq_acc[r][c]);
    }
  }

  T* dqb = dq + bh * (size_t)t_len * D;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = q0 + ty + 16 * r;
    if (row >= t_len) continue;
#pragma unroll
    for (int c = 0; c < kDC; ++c)
      dqb[(size_t)row * D + tx + 16 * c] = from_f32<T>(dq_acc[r][c] * scale);
  }
}

// Above 48 KB a kernel's dynamic shared memory must be allowed once per
// device; `allowed` holds one bit per device id.
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes,
                       std::atomic<unsigned long long>& allowed) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = 1ull << (dev & 63);
  if (allowed.load() & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
  if (err == cudaSuccess) allowed.fetch_or(bit);
  return err;
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* o, const void* dout, const float* lse,
                   float* delta, void* dq, void* dk, void* dv, int bh,
                   int t_len, int s_len, float scale, int causal,
                   cudaStream_t stream) {
  using C = Cfg<D>;
  const int n_qt = (t_len + kTile - 1) / kTile;
  const int n_kt = (s_len + kTile - 1) / kTile;
  if (n_qt > 65535 || n_kt > 65535) return cudaErrorInvalidValue;
  const T* tq = static_cast<const T*>(q);
  const T* tk = static_cast<const T*>(k);
  const T* tv = static_cast<const T*>(v);
  const T* tdo = static_cast<const T*>(dout);
  cudaError_t err;
  if (t_len > 0) {
    const long long rows = (long long)bh * t_len;
    const int per = kThreads / 32;
    flash_bwd_delta_kernel<T><<<(unsigned)((rows + per - 1) / per), kThreads,
                                0, stream>>>(static_cast<const T*>(o), tdo,
                                             delta, (int)rows, D);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if (n_kt > 0) {
    static std::atomic<unsigned long long> allowed{0};
    auto kernel = flash_bwd_dkdv_kernel<T, D>;
    if ((err = allow_smem(kernel, C::kSmemDkdv, allowed)) != cudaSuccess)
      return err;
    kernel<<<dim3(bh, n_kt), kThreads, C::kSmemDkdv, stream>>>(
        tq, tk, tv, tdo, lse, delta, static_cast<T*>(dk),
        static_cast<T*>(dv), t_len, s_len, scale, causal);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if (n_qt > 0) {
    static std::atomic<unsigned long long> allowed{0};
    auto kernel = flash_bwd_dq_kernel<T, D>;
    if ((err = allow_smem(kernel, C::kSmemDq, allowed)) != cudaSuccess)
      return err;
    kernel<<<dim3(bh, n_qt), kThreads, C::kSmemDq, stream>>>(
        tq, tk, tv, tdo, lse, delta, static_cast<T*>(dq), t_len, s_len,
        scale, causal);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return cudaSuccess;
}

template <typename T>
cudaError_t launch_d(const void* q, const void* k, const void* v,
                     const void* o, const void* dout, const float* lse,
                     float* delta, void* dq, void* dk, void* dv, int bh,
                     int t_len, int s_len, int d, float scale, int causal,
                     cudaStream_t stream) {
  switch (d) {
    case 32:
      return launch<T, 32>(q, k, v, o, dout, lse, delta, dq, dk, dv, bh,
                           t_len, s_len, scale, causal, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, dout, lse, delta, dq, dk, dv, bh,
                           t_len, s_len, scale, causal, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, dout, lse, delta, dq, dk, dv, bh,
                            t_len, s_len, scale, causal, stream);
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
  if (dtype == 0)
    return launch_d<float>(q, k, v, o, dout, lse, delta, dq, dk, dv, bh,
                           t_len, s_len, d, scale, causal, st);
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(q, k, v, o, dout, lse, delta, dq, dk, dv,
                                   bh, t_len, s_len, d, scale, causal, st);
  return cudaErrorInvalidValue;
}

extern "C" const char* flash_attn_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
