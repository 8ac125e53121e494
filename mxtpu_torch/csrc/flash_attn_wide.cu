// Flash-attention forward and backward at head dims above 128, for Hopper
// (sm_90a), CUDA C++ on the CUDA cores.
//
// Replaces, for 128 < D <= 512, the Pallas TPU kernel
// mxtpu/ops/attention.py:_fwd_kernel (launched by _flash_call, whose
// BlockSpecs carry D whole, so it takes any D) and that kernel's custom VJP
// mxtpu/ops/attention.py:_flash3_bwd (XLA there, recomputing through
// _streaming). flash_attn_fwd.cu and flash_attn_bwd.cu take D <= 128 on the
// tensor cores, where the f32 D = 128 instances already hold 168-255
// registers a thread; this file is the width-generic pair, with D a runtime
// argument. Same functions as those two:
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
// (~17 Gflop) against ~34 MB of f32 q, k, v, o: ~500 flops a byte, bound by
// operations. The backward's 5 products make it more so. On the CUDA cores
// (67 TFLOP/s f32) the floor is ~0.26 ms for the forward; this design
// runs at ~10 TFLOP/s there (forward 1.6 ms, backward 5.4 ms on an H100),
// because each product reads both of its operands from shared memory
// (below), and the tensor cores are not used.
//
// What the design does about that (a simple kernel that is right first;
// moving D > 128 onto the tensor cores is B.2/B.3's work):
// - One block of 256 threads for each (head, 16-row tile) of the stationary
//   side: query rows in the forward and the dQ kernel, keys in the dK/dV
//   kernel. Its 16 rows stay in shared memory as f32 (bf16 is widened once
//   on the way in) for the whole walk over the streamed side.
// - Streamed tiles (32 keys in the forward, 16 rows in the backward) are
//   loaded by all threads, column-consecutive so the reads coalesce, K
//   with V (Q with dO) and 16 independent loads in flight a thread (one
//   load at a time left the first version waiting on memory latency: the
//   forward below took 4.7 ms that way, 1.6 ms this way), and zero-filled
//   past T or S
//   and from D up to Dp, D rounded up to 4. Rows
//   are Dp floats plus 4 where Dp / 4 is even, an odd number of 16-byte
//   words, so the 8 threads of a quarter warp that each read one row with
//   16-byte loads hit 8 distinct bank groups.
// - Scores: 16 threads a stationary row, each one or two dot products of
//   length Dp from shared memory, four columns a 16-byte load (one q load
//   feeds both of a forward thread's keys); the row's max and sum by
//   16-lane shuffles. The accumulators (O, dQ, or dK and dV) live in
//   registers: thread t owns columns t and t + 256 of all 16 rows (NC = 1
//   up to D = 256, else 2), 16 * NC floats each, and adds p * V (or dS * K,
//   P * dO, dS * Q) for each streamed row in a fixed order, the p (dS)
//   values read four streamed rows a 16-byte broadcast load.
// - Shared memory: (16 + 32) * (Dp + 4) + 32 * Dp floats in the forward
//   (167 KB at D = 512), 4 * 16 * (Dp + 4) in the backward (134 KB).
//   D = 512 is the limit: at D = 640 the forward's tiles no longer fit in
//   227 KB.
#include <math.h>

#include "mma_sm90.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 16;     // stationary rows a block
constexpr int kFwdKeys = 32;  // keys a streamed forward tile
constexpr int kBwdRows = 16;  // rows a streamed backward tile
constexpr int kMaxD = 512;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

static_assert(kThreads == kRows * 16, "16 threads a stationary row");
static_assert(kFwdKeys == 32 && kBwdRows == 16, "tiles the lanes cover");

// D rounded up to whole 16-byte words
__host__ __device__ __forceinline__ int padded(int d) { return (d + 3) & ~3; }

// a row of shared memory: an odd number of 16-byte words
__host__ __device__ __forceinline__ int row_stride(int d) {
  const int dp = padded(d);
  return ((dp >> 2) & 1) ? dp : dp + 4;
}

size_t fwd_smem_bytes(int d) {
  return sizeof(float) * ((size_t)(kRows + kFwdKeys) * row_stride(d) +
                          (size_t)kFwdKeys * padded(d) + kRows * kFwdKeys +
                          2 * kRows);
}

size_t bwd_smem_bytes(int d) {
  return sizeof(float) * ((size_t)4 * kRows * row_stride(d) +
                          2 * kRows * kBwdRows + 2 * kRows);
}

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// p as the product p.v sees it: rounded to the input type
template <typename T>
__device__ __forceinline__ float as_operand(float p) {
  return widen(from_f32<T>(p));
}

// rows [r0, r0 + n) of a (rows, d) matrix into dst (stride ld) as f32,
// columns [d, padded(d)) and rows past `rows` zero; every thread of the
// block takes part. Each thread issues kBatch independent loads before it
// stores any, so their latencies overlap.
constexpr int kBatch = 8;

template <typename T>
__device__ __forceinline__ void stage_rows(float* dst, int ld,
                                           const T* __restrict__ src, int r0,
                                           int n, int rows, int d) {
  const int dp = padded(d);
  const int total = n * dp;
  for (int base = threadIdx.x; base < total; base += kBatch * kThreads) {
    float val[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int idx = base + u * kThreads;
      const int r = idx / dp, c = idx - r * dp;
      val[u] = idx < total && r0 + r < rows && c < d
                   ? widen(src[(size_t)(r0 + r) * d + c])
                   : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int idx = base + u * kThreads;
      const int r = idx / dp;
      if (idx < total) dst[r * ld + idx - r * dp] = val[u];
    }
  }
}

// stage_rows of two matrices of one shape at once (K and V, or Q and dO),
// 2 * kBatch loads in flight a thread
template <typename T>
__device__ __forceinline__ void stage_pair(float* dst_a, int lda,
                                           const T* __restrict__ src_a,
                                           float* dst_b, int ldb,
                                           const T* __restrict__ src_b,
                                           int r0, int n, int rows, int d) {
  const int dp = padded(d);
  const int total = n * dp;
  for (int base = threadIdx.x; base < total; base += kBatch * kThreads) {
    float va[kBatch], vb[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int idx = base + u * kThreads;
      const int r = idx / dp, c = idx - r * dp;
      const bool in = idx < total && r0 + r < rows && c < d;
      const size_t off = (size_t)(r0 + r) * d + c;
      va[u] = in ? widen(src_a[off]) : 0.f;
      vb[u] = in ? widen(src_b[off]) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int idx = base + u * kThreads;
      const int r = idx / dp, c = idx - r * dp;
      if (idx < total) {
        dst_a[r * lda + c] = va[u];
        dst_b[r * ldb + c] = vb[u];
      }
    }
  }
}

__device__ __forceinline__ void fma4(float& s, float4 a, float4 b) {
  s = fmaf(a.x, b.x, s);
  s = fmaf(a.y, b.y, s);
  s = fmaf(a.z, b.z, s);
  s = fmaf(a.w, b.w, s);
}

// a . b over dp (a multiple of 4) floats, 16 bytes a load
__device__ __forceinline__ float dot(const float* a, const float* b,
                                     int dp) {
  const float4* a4 = reinterpret_cast<const float4*>(a);
  const float4* b4 = reinterpret_cast<const float4*>(b);
  float s = 0.f;
#pragma unroll 4
  for (int i = 0; i < (dp >> 2); ++i) fma4(s, a4[i], b4[i]);
  return s;
}

// q . ka and q . kb, each q word loaded once
__device__ __forceinline__ void dot2(const float* q, const float* ka,
                                     const float* kb, int dp, float& sa,
                                     float& sb) {
  const float4* q4 = reinterpret_cast<const float4*>(q);
  const float4* a4 = reinterpret_cast<const float4*>(ka);
  const float4* b4 = reinterpret_cast<const float4*>(kb);
  sa = sb = 0.f;
#pragma unroll 4
  for (int i = 0; i < (dp >> 2); ++i) {
    const float4 x = q4[i];
    fma4(sa, x, a4[i]);
    fma4(sb, x, b4[i]);
  }
}

__device__ __forceinline__ float lane(float4 v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

// max and sum over the 16 lanes of one stationary row
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int off = 8; off; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = 8; off; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// forward of one (head, 16-row q tile)
template <typename T, int NC>
__global__ void __launch_bounds__(kThreads)
wide_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, T* __restrict__ o,
                float* __restrict__ lse, int t_len, int s_len, int d,
                float scale, int causal) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int ld = row_stride(d), dp = padded(d);
  float* qs = smem;                        // kRows x ld
  float* ks = qs + kRows * ld;             // kFwdKeys x ld
  float* vs = ks + kFwdKeys * ld;          // kFwdKeys x dp
  float* ps = vs + kFwdKeys * dp;          // kRows x kFwdKeys
  float* alpha_s = ps + kRows * kFwdKeys;  // kRows
  float* l_s = alpha_s + kRows;            // kRows

  const size_t head = blockIdx.x;
  const int q0 = blockIdx.y * kRows;
  const int tid = threadIdx.x;
  const int row = tid >> 4;  // this thread's query row in the tile
  const int c = tid & 15;    // its keys in a kv tile: c and c + 16
  const T* kh = k + head * s_len * d;
  const T* vh = v + head * s_len * d;
  stage_rows(qs, ld, q + head * t_len * d, q0, kRows, t_len, d);

  const float sl2 = scale * kLog2e;  // scores in the log2 domain
  const int qi = q0 + row;
  float m = -INFINITY, l = 0.f;
  float acc[kRows][NC];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int n = 0; n < NC; ++n) acc[r][n] = 0.f;

  // causal: keys past the tile's last row are masked for all its rows
  const int stop = causal ? min(s_len, q0 + kRows) : s_len;
  for (int k0 = 0; k0 < stop; k0 += kFwdKeys) {
    __syncthreads();  // the last tile's reads are done (and q is staged)
    stage_pair(ks, ld, kh, vs, dp, vh, k0, kFwdKeys, s_len, d);
    __syncthreads();
    float s0, s1;
    dot2(qs + row * ld, ks + c * ld, ks + (c + 16) * ld, dp, s0, s1);
    const int j0 = k0 + c, j1 = j0 + 16;
    s0 = (j0 < s_len && (!causal || j0 <= qi)) ? s0 * sl2 : -INFINITY;
    s1 = (j1 < s_len && (!causal || j1 <= qi)) ? s1 * sl2 : -INFINITY;
    const float m_new = fmaxf(m, row_max(fmaxf(s0, s1)));
    const float m_use = m_new == -INFINITY ? 0.f : m_new;
    const float p0 = exp2f(s0 - m_use), p1 = exp2f(s1 - m_use);
    const float alpha = exp2f(m - m_use);
    l = alpha * l + row_sum(p0 + p1);
    m = m_new;
    ps[row * kFwdKeys + c] = as_operand<T>(p0);
    ps[row * kFwdKeys + c + 16] = as_operand<T>(p1);
    if (c == 0) alpha_s[row] = alpha;
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float a = alpha_s[r];
#pragma unroll
      for (int n = 0; n < NC; ++n) acc[r][n] *= a;
    }
    // keys past S have p = 0 and V = 0: stop at the word that holds S
    const int nk = padded(min(kFwdKeys, s_len - k0));
    for (int jw = 0; jw < nk; jw += 4) {
      float vj[4][NC];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int n = 0; n < NC; ++n) {
          const int col = tid + n * kThreads;
          vj[u][n] = col < d ? vs[(jw + u) * dp + col] : 0.f;
        }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 p4 =
            *reinterpret_cast<const float4*>(ps + r * kFwdKeys + jw);
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int n = 0; n < NC; ++n)
            acc[r][n] = fmaf(lane(p4, u), vj[u][n], acc[r][n]);
      }
    }
  }
  if (c == 0) {
    l_s[row] = l;
    if (lse != nullptr && qi < t_len)
      lse[head * t_len + qi] =
          l == 0.f ? INFINITY : (m + log2f(l)) * kLn2;
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (q0 + r >= t_len) break;
    const float lr = l_s[r];
    const float denom = lr == 0.f ? 1.f : lr;
    T* orow = o + (head * t_len + q0 + r) * d;
#pragma unroll
    for (int n = 0; n < NC; ++n) {
      const int col = tid + n * kThreads;
      if (col < d) orow[col] = from_f32<T>(acc[r][n] / denom);
    }
  }
}

// delta = rowsum(dO * O) in f32, a warp a row
template <typename T>
__global__ void wide_delta_kernel(const T* __restrict__ o,
                                  const T* __restrict__ dout,
                                  float* __restrict__ delta, long long rows,
                                  int d) {
  const long long r = (long long)blockIdx.x * (kThreads / 32) +
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

// dK and dV of one (head, 16-key tile), walking the query rows from its
// diagonal on (all of them without the causal mask)
template <typename T, int NC>
__global__ void __launch_bounds__(kThreads)
wide_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, T* __restrict__ dk,
                 T* __restrict__ dv, int t_len, int s_len, int d,
                 float scale, int causal) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int ld = row_stride(d), dp = padded(d);
  float* ks = smem;                        // kRows x ld, stationary
  float* vs = ks + kRows * ld;             // kRows x ld, stationary
  float* qs = vs + kRows * ld;             // kBwdRows x ld, streamed
  float* dos = qs + kBwdRows * ld;         // kBwdRows x ld, streamed
  float* ps = dos + kBwdRows * ld;         // kRows x kBwdRows
  float* dss = ps + kRows * kBwdRows;      // kRows x kBwdRows
  float* lse_s = dss + kRows * kBwdRows;   // kBwdRows
  float* delta_s = lse_s + kBwdRows;       // kBwdRows

  const size_t head = blockIdx.x;
  const int k0 = blockIdx.y * kRows;
  const int tid = threadIdx.x;
  const int i = tid >> 4;  // this thread's key in the tile
  const int j = tid & 15;  // its query row in a streamed tile
  const T* qh = q + head * t_len * d;
  const T* doh = dout + head * t_len * d;
  stage_pair(ks, ld, k + head * s_len * d, vs, ld, v + head * s_len * d, k0,
             kRows, s_len, d);

  float dka[kRows][NC], dva[kRows][NC];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int n = 0; n < NC; ++n) dka[r][n] = dva[r][n] = 0.f;

  const int key = k0 + i;
  for (int r0 = causal ? k0 : 0; r0 < t_len; r0 += kBwdRows) {
    __syncthreads();
    stage_pair(qs, ld, qh, dos, ld, doh, r0, kBwdRows, t_len, d);
    if (tid < kBwdRows) {
      const bool in = r0 + tid < t_len;
      lse_s[tid] = in ? lse[head * t_len + r0 + tid] : INFINITY;
      delta_s[tid] = in ? delta[head * t_len + r0 + tid] : 0.f;
    }
    __syncthreads();
    const float s = dot(ks + i * ld, qs + j * ld, dp);
    const float dpv = dot(vs + i * ld, dos + j * ld, dp);
    const int qr = r0 + j;
    const bool live = key < s_len && qr < t_len && (!causal || key <= qr);
    const float p = live ? expf(s * scale - lse_s[j]) : 0.f;
    ps[i * kBwdRows + j] = p;
    dss[i * kBwdRows + j] = live ? p * (dpv - delta_s[j]) : 0.f;
    __syncthreads();
    // rows past T have P = dS = 0: stop at the word that holds T
    const int nr = padded(min(kBwdRows, t_len - r0));
    for (int j0 = 0; j0 < nr; j0 += 4) {
      float qv[4][NC], gv[4][NC];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int n = 0; n < NC; ++n) {
          const int col = tid + n * kThreads;
          qv[u][n] = col < d ? qs[(j0 + u) * ld + col] : 0.f;
          gv[u][n] = col < d ? dos[(j0 + u) * ld + col] : 0.f;
        }
#pragma unroll
      for (int ii = 0; ii < kRows; ++ii) {
        const float4 p4 =
            *reinterpret_cast<const float4*>(ps + ii * kBwdRows + j0);
        const float4 d4 =
            *reinterpret_cast<const float4*>(dss + ii * kBwdRows + j0);
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int n = 0; n < NC; ++n) {
            dva[ii][n] = fmaf(lane(p4, u), gv[u][n], dva[ii][n]);
            dka[ii][n] = fmaf(lane(d4, u), qv[u][n], dka[ii][n]);
          }
      }
    }
  }
#pragma unroll
  for (int ii = 0; ii < kRows; ++ii) {
    if (k0 + ii >= s_len) break;
    T* dkrow = dk + (head * s_len + k0 + ii) * d;
    T* dvrow = dv + (head * s_len + k0 + ii) * d;
#pragma unroll
    for (int n = 0; n < NC; ++n) {
      const int col = tid + n * kThreads;
      if (col < d) {
        dkrow[col] = from_f32<T>(dka[ii][n] * scale);
        dvrow[col] = from_f32<T>(dva[ii][n]);
      }
    }
  }
}

// dQ of one (head, 16-row q tile), walking the keys up to its diagonal
template <typename T, int NC>
__global__ void __launch_bounds__(kThreads)
wide_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const T* __restrict__ dout,
               const float* __restrict__ lse,
               const float* __restrict__ delta, T* __restrict__ dq,
               int t_len, int s_len, int d, float scale, int causal) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int ld = row_stride(d), dp = padded(d);
  float* qs = smem;                        // kRows x ld, stationary
  float* dos = qs + kRows * ld;            // kRows x ld, stationary
  float* ks = dos + kRows * ld;            // kBwdRows x ld, streamed
  float* vs = ks + kBwdRows * ld;          // kBwdRows x ld, streamed
  float* dss = vs + kBwdRows * ld;         // kRows x kBwdRows
  float* lse_s = dss + 2 * kRows * kBwdRows;  // kRows (ps's room unused)
  float* delta_s = lse_s + kRows;          // kRows

  const size_t head = blockIdx.x;
  const int q0 = blockIdx.y * kRows;
  const int tid = threadIdx.x;
  const int j = tid >> 4;  // this thread's query row in the tile
  const int i = tid & 15;  // its key in a streamed tile
  const T* kh = k + head * s_len * d;
  const T* vh = v + head * s_len * d;
  stage_pair(qs, ld, q + head * t_len * d, dos, ld, dout + head * t_len * d,
             q0, kRows, t_len, d);
  if (tid < kRows) {
    const bool in = q0 + tid < t_len;
    lse_s[tid] = in ? lse[head * t_len + q0 + tid] : INFINITY;
    delta_s[tid] = in ? delta[head * t_len + q0 + tid] : 0.f;
  }

  float dqa[kRows][NC];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int n = 0; n < NC; ++n) dqa[r][n] = 0.f;

  const int qr = q0 + j;
  const int stop = causal ? min(s_len, q0 + kRows) : s_len;
  for (int k0 = 0; k0 < stop; k0 += kBwdRows) {
    __syncthreads();
    stage_pair(ks, ld, kh, vs, ld, vh, k0, kBwdRows, s_len, d);
    __syncthreads();
    const float s = dot(qs + j * ld, ks + i * ld, dp);
    const float dpv = dot(dos + j * ld, vs + i * ld, dp);
    const int key = k0 + i;
    const bool live = key < s_len && qr < t_len && (!causal || key <= qr);
    dss[j * kBwdRows + i] =
        live ? expf(s * scale - lse_s[j]) * (dpv - delta_s[j]) : 0.f;
    __syncthreads();
    // keys past S have dS = 0: stop at the word that holds S
    const int nk = padded(min(kBwdRows, s_len - k0));
    for (int i0 = 0; i0 < nk; i0 += 4) {
      float kv[4][NC];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int n = 0; n < NC; ++n) {
          const int col = tid + n * kThreads;
          kv[u][n] = col < d ? ks[(i0 + u) * ld + col] : 0.f;
        }
#pragma unroll
      for (int jj = 0; jj < kRows; ++jj) {
        const float4 d4 =
            *reinterpret_cast<const float4*>(dss + jj * kBwdRows + i0);
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int n = 0; n < NC; ++n)
            dqa[jj][n] = fmaf(lane(d4, u), kv[u][n], dqa[jj][n]);
      }
    }
  }
#pragma unroll
  for (int jj = 0; jj < kRows; ++jj) {
    if (q0 + jj >= t_len) break;
    T* dqrow = dq + (head * t_len + q0 + jj) * d;
#pragma unroll
    for (int n = 0; n < NC; ++n) {
      const int col = tid + n * kThreads;
      if (col < d) dqrow[col] = from_f32<T>(dqa[jj][n] * scale);
    }
  }
}

template <typename T, int NC>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o,
                       float* lse, int bh, int t_len, int s_len, int d,
                       float scale, int causal, cudaStream_t stream) {
  const int n_qt = (t_len + kRows - 1) / kRows;
  if (n_qt > 65535) return cudaErrorInvalidValue;
  auto kernel = wide_fwd_kernel<T, NC>;
  static std::atomic<unsigned long long> allowed{0};  // per instance
  const cudaError_t err = allow_smem(kernel, fwd_smem_bytes(kMaxD), allowed);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(bh, n_qt), kThreads, fwd_smem_bytes(d), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, t_len, s_len, d,
      scale, causal);
  return cudaGetLastError();
}

template <typename T, int NC>
cudaError_t launch_bwd(const void* q, const void* k, const void* v,
                       const void* o, const void* dout, const float* lse,
                       float* delta, void* dq, void* dk, void* dv, int bh,
                       int t_len, int s_len, int d, float scale, int causal,
                       cudaStream_t stream) {
  const int n_qt = (t_len + kRows - 1) / kRows;
  const int n_kt = (s_len + kRows - 1) / kRows;
  if (n_qt > 65535 || n_kt > 65535) return cudaErrorInvalidValue;
  const T* tq = static_cast<const T*>(q);
  const T* tk = static_cast<const T*>(k);
  const T* tv = static_cast<const T*>(v);
  const T* tdo = static_cast<const T*>(dout);
  const size_t smem = bwd_smem_bytes(d);
  cudaError_t err;
  if (t_len > 0) {
    const long long rows = (long long)bh * t_len;
    const int per = kThreads / 32;
    wide_delta_kernel<T><<<(unsigned)((rows + per - 1) / per), kThreads, 0,
                           stream>>>(static_cast<const T*>(o), tdo, delta,
                                     rows, d);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if (n_kt > 0) {
    static std::atomic<unsigned long long> allowed{0};
    auto kernel = wide_dkdv_kernel<T, NC>;
    if ((err = allow_smem(kernel, bwd_smem_bytes(kMaxD), allowed)) !=
        cudaSuccess)
      return err;
    kernel<<<dim3(bh, n_kt), kThreads, smem, stream>>>(
        tq, tk, tv, tdo, lse, delta, static_cast<T*>(dk),
        static_cast<T*>(dv), t_len, s_len, d, scale, causal);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if (n_qt > 0) {
    static std::atomic<unsigned long long> allowed{0};
    auto kernel = wide_dq_kernel<T, NC>;
    if ((err = allow_smem(kernel, bwd_smem_bytes(kMaxD), allowed)) !=
        cudaSuccess)
      return err;
    kernel<<<dim3(bh, n_qt), kThreads, smem, stream>>>(
        tq, tk, tv, tdo, lse, delta, static_cast<T*>(dq), t_len, s_len, d,
        scale, causal);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return cudaSuccess;
}

template <typename T>
cudaError_t fwd_d(const void* q, const void* k, const void* v, void* o,
                  float* lse, int bh, int t_len, int s_len, int d,
                  float scale, int causal, cudaStream_t stream) {
  return d <= kThreads
             ? launch_fwd<T, 1>(q, k, v, o, lse, bh, t_len, s_len, d, scale,
                                causal, stream)
             : launch_fwd<T, 2>(q, k, v, o, lse, bh, t_len, s_len, d, scale,
                                causal, stream);
}

template <typename T>
cudaError_t bwd_d(const void* q, const void* k, const void* v, const void* o,
                  const void* dout, const float* lse, float* delta, void* dq,
                  void* dk, void* dv, int bh, int t_len, int s_len, int d,
                  float scale, int causal, cudaStream_t stream) {
  return d <= kThreads
             ? launch_bwd<T, 1>(q, k, v, o, dout, lse, delta, dq, dk, dv, bh,
                                t_len, s_len, d, scale, causal, stream)
             : launch_bwd<T, 2>(q, k, v, o, dout, lse, delta, dq, dk, dv, bh,
                                t_len, s_len, d, scale, causal, stream);
}

}  // namespace

// As flash_attn_fwd (flash_attn_fwd.cu), for any head dim d in [1, 512]:
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
  if (s_len < 0 || d < 1 || d > kMaxD) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return fwd_d<float>(q, k, v, o, lse, bh, t_len, s_len, d, scale, causal,
                        st);
  if (dtype == 1)
    return fwd_d<__nv_bfloat16>(q, k, v, o, lse, bh, t_len, s_len, d, scale,
                                causal, st);
  return cudaErrorInvalidValue;
}

// As flash_attn_bwd (flash_attn_bwd.cu), for any head dim d in [1, 512]:
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
  if (t_len < 0 || s_len < 0 || d < 1 || d > kMaxD)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return bwd_d<float>(q, k, v, o, dout, lse, delta, dq, dk, dv, bh, t_len,
                        s_len, d, scale, causal, st);
  if (dtype == 1)
    return bwd_d<__nv_bfloat16>(q, k, v, o, dout, lse, delta, dq, dk, dv,
                                bh, t_len, s_len, d, scale, causal, st);
  return cudaErrorInvalidValue;
}

extern "C" const char* flash_attn_wide_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
