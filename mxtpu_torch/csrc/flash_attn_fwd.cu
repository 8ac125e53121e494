// Flash-attention forward for Hopper (sm_90a), CUDA C++.
//
// Replaces the Pallas TPU kernel mxtpu/ops/attention.py:_fwd_kernel
// (launched by _flash_call). Same function: o = softmax(q k^T * scale) v
// with an online softmax, f32 running max m, normaliser l and f32
// accumulator; causal masking is top-left aligned (col <= row) even when
// T != S; p is rounded to the input type before p.v (bf16 inputs); the
// output is acc / l with l == 0 -> 1.
//
// What bounds it on this card: at the serving path's shape (T = S = 1024,
// D = 64, causal, f32) a head does 4*D flops for each of the T(T+1)/2
// live (row, key) pairs, ~134 Mflop, against 16*T*D = 1 MB of q, k, v
// and o read or written once: ~128 flops per byte, six times the ~20 f32
// flops per byte that the H100's CUDA-core rate (67 TFLOP/s) over its
// HBM rate (3.35 TB/s) balances at. It is bound by operations, not bytes.
//
// What the design does about that: it keeps every operand of the inner
// loops on chip. One block per (batch*head, 128-row q tile); its q rows
// and f32 accumulators live in registers (one thread per query row, or
// two threads splitting D = 128), and K/V tiles of 32 keys are staged in
// shared memory once per block and read by all rows as broadcasts, so
// HBM traffic is one pass over K/V per q tile. A loop over kv tiles
// inside the block takes the place of the TPU grid's sequential third
// axis; a causal block stops at its last row's diagonal, and the q tiles
// are issued heaviest first so the causal tail does not idle the card.
// Loads past S are predicated off and the tile is zero-filled, so rows
// past kv_len are never read (the TPU kernel zeroes them instead). The
// products run on the CUDA cores in f32 (FMA); moving them to the tensor
// cores (mma.sync / wgmma) is the next step for speed.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // threads per block
constexpr int kBlockN = 32;    // keys per shared-memory tile

template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
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

// Dimension held in slot i by the thread owning part `part` of a row:
// chunks of 4 dims alternate between the kTPR threads of a row, so the
// two halves of a D = 128 row read neighbouring 16-byte chunks of a
// shared-memory row (different banks) rather than the same bank.
template <int kTPR>
__device__ __forceinline__ int dim_of(int i, int part) {
  return (i / 4) * 4 * kTPR + part * 4 + (i % 4);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int t_len,
                 int s_len, float scale, int causal) {
  constexpr int kTPR = D > 64 ? 2 : 1;      // threads per query row
  constexpr int kDS = D / kTPR;             // dims each thread holds
  constexpr int kBlockM = kThreads / kTPR;  // query rows per block
  __shared__ __align__(16) float ks[kBlockN][D];
  __shared__ __align__(16) float vs[kBlockN][D];

  const int tid = threadIdx.x;
  const int part = tid % kTPR;
  const int q_tile = gridDim.x - 1 - blockIdx.x;  // heaviest tiles first
  const int row0 = q_tile * kBlockM;
  const int row = row0 + tid / kTPR;
  const bool row_ok = row < t_len;
  const size_t bh = blockIdx.y;
  const T* qb = q + bh * (size_t)t_len * D;
  const T* kb = k + bh * (size_t)s_len * D;
  const T* vb = v + bh * (size_t)s_len * D;
  T* ob = o + bh * (size_t)t_len * D;

  float qr[kDS];
  float acc[kDS];
#pragma unroll
  for (int i = 0; i < kDS; ++i) {
    qr[i] = row_ok ? to_f32(qb[(size_t)row * D + dim_of<kTPR>(i, part)])
                   : 0.f;
    acc[i] = 0.f;
  }
  float m = -INFINITY;
  float l = 0.f;

  // causal: no column past the block's last row contributes
  const int kv_end = causal ? min(s_len, row0 + kBlockM) : s_len;
  for (int kv0 = 0; kv0 < kv_end; kv0 += kBlockN) {
    const int n = min(kBlockN, kv_end - kv0);
    __syncthreads();  // every row is done with the previous tile
    for (int idx = tid; idx < kBlockN * D; idx += kThreads) {
      const int r = idx / D;
      const int c = idx % D;
      float kx = 0.f, vx = 0.f;
      if (r < n) {
        const size_t off = (size_t)(kv0 + r) * D + c;
        kx = to_f32(kb[off]);
        vx = to_f32(vb[off]);
      }
      ks[r][c] = kx;
      vs[r][c] = vx;
    }
    __syncthreads();

    float s[kBlockN];
    float m_tile = -INFINITY;
#pragma unroll
    for (int j = 0; j < kBlockN; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < kDS; ++i) dot += qr[i] * ks[j][dim_of<kTPR>(i, part)];
      if (kTPR == 2) dot += __shfl_xor_sync(0xffffffffu, dot, 1);
      const int col = kv0 + j;
      const bool ok = j < n && (!causal || col <= row);
      s[j] = ok ? dot * scale : -INFINITY;
      m_tile = fmaxf(m_tile, s[j]);
    }
    const float m_new = fmaxf(m, m_tile);
    // a row with no live column yet keeps m = -inf; exp(-inf - 0) = 0
    const float m_use = m_new == -INFINITY ? 0.f : m_new;
    const float alpha = expf(m - m_use);
    l *= alpha;
#pragma unroll
    for (int i = 0; i < kDS; ++i) acc[i] *= alpha;
#pragma unroll
    for (int j = 0; j < kBlockN; ++j) {
      const float p = expf(s[j] - m_use);
      l += p;
      const float pv = to_f32(from_f32<T>(p));  // p.astype(v.dtype)
#pragma unroll
      for (int i = 0; i < kDS; ++i) acc[i] += pv * vs[j][dim_of<kTPR>(i, part)];
    }
    m = m_new;
  }

  if (row_ok) {
    const float denom = l == 0.f ? 1.f : l;
#pragma unroll
    for (int i = 0; i < kDS; ++i)
      ob[(size_t)row * D + dim_of<kTPR>(i, part)] = from_f32<T>(acc[i] / denom);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int bh, int t_len, int s_len, float scale, int causal,
                   cudaStream_t stream) {
  constexpr int kBlockM = kThreads / (D > 64 ? 2 : 1);
  const dim3 grid((t_len + kBlockM - 1) / kBlockM, bh);
  flash_fwd_kernel<T, D><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), t_len, s_len, scale,
      causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const void* q, const void* k, const void* v, void* o,
                     int bh, int t_len, int s_len, int d, float scale,
                     int causal, cudaStream_t stream) {
  switch (d) {
    case 32:
      return launch<T, 32>(q, k, v, o, bh, t_len, s_len, scale, causal, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, bh, t_len, s_len, scale, causal, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, bh, t_len, s_len, scale, causal, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (bh, t, d), k and v (bh, s, d), o (bh, t, d): contiguous, one dtype
// (0 = float32, 1 = bfloat16). Launches on `stream`, does not
// synchronise, and returns the launch's cudaError_t.
extern "C" int flash_attn_fwd(const void* q, const void* k, const void* v,
                              void* o, int bh, int t_len, int s_len, int d,
                              float scale, int causal, int dtype,
                              void* stream) {
  if (bh <= 0 || t_len <= 0) return cudaSuccess;
  if (bh > 65535 || s_len < 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_d<float>(q, k, v, o, bh, t_len, s_len, d, scale, causal, st);
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(q, k, v, o, bh, t_len, s_len, d, scale,
                                   causal, st);
  return cudaErrorInvalidValue;
}

extern "C" const char* flash_attn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
