// ROI max pooling for Hopper (sm_90a), CUDA C++: the forward and the
// backward of ROIPooling, the stage-2 pooling of the Faster R-CNN.
//
// Replaces mxtpu/ops/spatial.py:_roi_pool_one and _roi_pooling
// (:135-180), XLA (not Pallas): a masked max over a (C, ph, pw, H, W)
// tensor for each ROI, whose gradient is jax.vjp of jnp.max. No plain
// PyTorch form runs that at the model's width (256 ROIs, C = 512, 7x7
// bins over a 37x62 map is ~1.5e10 elements), and a separable max gives
// another gradient where a bin has tied maxima, which after a ReLU is the
// common case.
//
// What it computes, as mxtpu does:
//  - ROI r is [image, x1, y1, x2, y2] in image pixels. The image is
//    roi[0] converted toward zero with saturation (NaN to 0), as XLA's
//    convert, then clamped into [0, N), as XLA's gather clamps an index.
//  - The corners are rint(coordinate * spatial_scale) (half to even, as
//    jnp.round; roundf would round half away from zero), the extent
//    max(x2 - x1 + 1, 1), the bin size extent * (1 / pooled) with the
//    reciprocal rounded to float32 (mxtpu's op runs compiled, and XLA
//    rewrites the division by the constant pooled size into that
//    product: at extent 7 over 3 bins, 3 * bin is 7.0000005 and the last
//    bin's end is one row further than 7 / 3 gives), and bin p spans
//    [clip(floor(p * bin) + x1, 0, W - 1), clip(ceil((p + 1) * bin) + x1,
//    0, W)). Every product, sum and quotient is rounded on its own
//    (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn), so nvcc cannot
//    contract a pair into an FMA and move a boundary by one ulp. A max
//    and a clip propagate NaN as XLA's do, and a NaN bound makes the bin
//    empty (every comparison with NaN is false).
//  - Each output is the max over its bin; 0 where that max is not
//    finite: an empty bin, a bin of -inf, a bin holding +inf or NaN.
//  - The gradient splits each bin's head gradient equally over the
//    pixels equal to its max (jnp.max's vjp: a 3x3 bin of zeros gives
//    each pixel 1/9), gives nothing for a bin whose max is +-inf or that
//    is empty (jnp.where zeroes it), and NaN to every pixel of a bin that
//    holds a NaN (0 / 0 in jnp.max's vjp). The ROIs get no gradient.
//
// What bounds it on this card: bytes. The function's forward reads the
// map once and writes the max; its backward reads dy, the map and the
// max and writes dx. At the training shape (R = 256, C = 512, 7x7, a
// 2x512x37x62 map) that is ~35 MB and ~70 MB, 10.5 and 20.9
// microseconds at 3.35 TB/s. This route also writes and reads an int32
// count of ties an output (~61 MB and ~96 MB, 18.1 and 28.6
// microseconds). Neither launch comes near either; this is the simple
// kernel that is right.
//
// Design. Two launches, one for each direction, with no atomics:
//   1. roi_pool_fwd_kernel: one thread an output (r, c, ph, pw), the
//      channel's map read over the bin from L2. It writes the max and
//      the count of pixels equal to it (int32; -1 marks a bin that holds
//      a NaN, 0 a bin whose max is not finite).
//   2. roi_pool_bwd_kernel: one thread an input element (n, c, y, x). The
//      block computes a chunk of ROIs' bin tables into shared memory at a
//      time (the ROI's image, the rows and columns its bins span, each
//      bin's bounds: roi_frame and bin_span, as the forward computes
//      them, so the bounds are the forward's), and each thread walks the
//      ROIs in order, skips those of another image or whose span misses
//      (y, x), and for each bin holding (y, x) whose max equals the pixel
//      adds dy / count. The sum is taken in the same order on every run:
//      repeats are bit-identical.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTableSmemWords = 8192;  // 32 KB of bin tables a chunk

__device__ __forceinline__ float nan_max(float a, float b) {
  return a != a ? a : fmaxf(a, b);  // b is never NaN here
}

__device__ __forceinline__ float nan_clip(float v, float lo, float hi) {
  return v != v ? v : fminf(fmaxf(v, lo), hi);
}

struct Frame {
  float x1, y1, bin_w, bin_h;
};

__device__ __forceinline__ Frame roi_frame(const float* roi, float scale,
                                           int ph, int pw) {
  Frame f;
  f.x1 = rintf(__fmul_rn(roi[1], scale));
  f.y1 = rintf(__fmul_rn(roi[2], scale));
  const float x2 = rintf(__fmul_rn(roi[3], scale));
  const float y2 = rintf(__fmul_rn(roi[4], scale));
  const float rw = nan_max(__fadd_rn(__fsub_rn(x2, f.x1), 1.f), 1.f);
  const float rh = nan_max(__fadd_rn(__fsub_rn(y2, f.y1), 1.f), 1.f);
  f.bin_w = __fmul_rn(rw, __frcp_rn(static_cast<float>(pw)));
  f.bin_h = __fmul_rn(rh, __frcp_rn(static_cast<float>(ph)));
  return f;
}

// bin p's span [lo, hi) along an axis of n pixels, bins of size b from
// origin o; a NaN bound gives the empty span
__device__ __forceinline__ void bin_span(int p, float b, float o, int n,
                                         int* lo, int* hi) {
  const float s = nan_clip(
      __fadd_rn(floorf(__fmul_rn(static_cast<float>(p), b)), o), 0.f,
      static_cast<float>(n - 1));
  const float e = nan_clip(
      __fadd_rn(ceilf(__fmul_rn(static_cast<float>(p + 1), b)), o), 0.f,
      static_cast<float>(n));
  if (s != s || e != e) {
    *lo = 0;
    *hi = 0;
    return;
  }
  *lo = static_cast<int>(s);
  *hi = static_cast<int>(e);
}

__device__ __forceinline__ int roi_image(float v, int n) {
  const int b = __float2int_rz(v);  // NaN -> 0, saturating
  return b < 0 ? 0 : (b >= n ? n - 1 : b);
}

__global__ void roi_pool_fwd_kernel(const float* __restrict__ data,
                                    const float* __restrict__ rois,
                                    float* __restrict__ out,
                                    int* __restrict__ count, int N, int C,
                                    int H, int W, int R, int PH, int PW,
                                    float scale) {
  const size_t total = static_cast<size_t>(R) * C * PH * PW;
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x;
       i < total; i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const int pw = static_cast<int>(i % PW);
    const int ph = static_cast<int>((i / PW) % PH);
    const int c = static_cast<int>((i / (static_cast<size_t>(PW) * PH)) % C);
    const int r = static_cast<int>(i / (static_cast<size_t>(PW) * PH * C));
    const float* roi = rois + 5 * static_cast<size_t>(r);
    const Frame f = roi_frame(roi, scale, PH, PW);
    const int b = roi_image(roi[0], N);
    int hs, he, ws, we;
    bin_span(ph, f.bin_h, f.y1, H, &hs, &he);
    bin_span(pw, f.bin_w, f.x1, W, &ws, &we);
    const float* plane = data + (static_cast<size_t>(b) * C + c) * H * W;
    float m = -INFINITY;
    int cnt = 0;
    bool nan = false;
    for (int y = hs; y < he; ++y) {
      for (int x = ws; x < we; ++x) {
        const float v = plane[static_cast<size_t>(y) * W + x];
        if (v != v) {
          nan = true;
        } else if (v > m) {
          m = v;
          cnt = 1;
        } else if (v == m) {
          ++cnt;
        }
      }
    }
    if (nan) {
      out[i] = 0.f;
      count[i] = -1;
    } else if (!isfinite(m)) {
      out[i] = 0.f;
      count[i] = 0;
    } else {
      out[i] = m;
      count[i] = cnt;
    }
  }
}

// the bin table of a ROI, T = 5 + 2 PH + 2 PW words: [image, y_lo,
// y_hi, x_lo, x_hi, hs[PH], he[PH], ws[PW], we[PW]], [y_lo, y_hi) and
// [x_lo, x_hi) the rows and columns its non-empty bins span
__device__ void roi_row(const float* roi, float scale, int N, int H, int W,
                        int PH, int PW, int* row) {
  const Frame f = roi_frame(roi, scale, PH, PW);
  int ylo = H, yhi = 0, xlo = W, xhi = 0;
  for (int p = 0; p < PH; ++p) {
    int lo, hi;
    bin_span(p, f.bin_h, f.y1, H, &lo, &hi);
    row[5 + p] = lo;
    row[5 + PH + p] = hi;
    if (lo < hi) {
      ylo = min(ylo, lo);
      yhi = max(yhi, hi);
    }
  }
  for (int p = 0; p < PW; ++p) {
    int lo, hi;
    bin_span(p, f.bin_w, f.x1, W, &lo, &hi);
    row[5 + 2 * PH + p] = lo;
    row[5 + 2 * PH + PW + p] = hi;
    if (lo < hi) {
      xlo = min(xlo, lo);
      xhi = max(xhi, hi);
    }
  }
  row[0] = roi_image(roi[0], N);
  row[1] = ylo;
  row[2] = yhi;
  row[3] = xlo;
  row[4] = xhi;
}

__global__ void roi_pool_bwd_kernel(const float* __restrict__ dy,
                                    const float* __restrict__ data,
                                    const float* __restrict__ out,
                                    const int* __restrict__ count,
                                    const float* __restrict__ rois,
                                    float* __restrict__ dx, int N, int C,
                                    int H, int W, int R, int PH, int PW,
                                    float scale, int chunk) {
  const int T = 5 + 2 * PH + 2 * PW;
  extern __shared__ int tab[];
  const size_t total = static_cast<size_t>(N) * C * H * W;
  const size_t i = blockIdx.x * static_cast<size_t>(kThreads) + threadIdx.x;
  const bool active = i < total;
  const size_t j = active ? i : 0;
  const int x = static_cast<int>(j % W);
  const int y = static_cast<int>((j / W) % H);
  const int c = static_cast<int>((j / (static_cast<size_t>(W) * H)) % C);
  const int n = static_cast<int>(j / (static_cast<size_t>(W) * H * C));
  const float v = active ? data[j] : 0.f;
  float acc = 0.f;
  for (int r0 = 0; r0 < R; r0 += chunk) {
    const int rc = min(chunk, R - r0);
    __syncthreads();
    for (int q = threadIdx.x; q < rc; q += kThreads)
      roi_row(rois + 5 * static_cast<size_t>(r0 + q), scale, N, H, W, PH,
              PW, tab + q * T);
    __syncthreads();
    if (!active) continue;
    for (int q = 0; q < rc; ++q) {
      const int* t = tab + q * T;
      if (t[0] != n || y < t[1] || y >= t[2] || x < t[3] || x >= t[4])
        continue;
      const int* hs = t + 5;
      const int* he = hs + PH;
      const int* ws = he + PH;
      const int* we = ws + PW;
      const size_t base = (static_cast<size_t>(r0 + q) * C + c) * PH;
      for (int ph = 0; ph < PH; ++ph) {
        if (y < hs[ph] || y >= he[ph]) continue;
        for (int pw = 0; pw < PW; ++pw) {
          if (x < ws[pw] || x >= we[pw]) continue;
          const size_t k = (base + ph) * PW + pw;
          const int cnt = count[k];
          if (cnt > 0) {
            if (v == out[k])
              acc = __fadd_rn(acc, __fdiv_rn(dy[k], static_cast<float>(cnt)));
          } else if (cnt < 0) {
            acc = __fadd_rn(acc, __int_as_float(0x7fc00000));  // NaN
          }
        }
      }
    }
  }
  if (active) dx[i] = acc;
}

}  // namespace

extern "C" {

// data (N, C, H, W), rois (R, 5): float32, contiguous; out (R, C, PH, PW)
// float32, count (R, C, PH, PW) int32. One launch on `stream`; returns
// cudaGetLastError().
int roi_pool_forward(const void* data, const void* rois, void* out,
                     void* count, int N, int C, int H, int W, int R, int PH,
                     int PW, float scale, void* stream) {
  if (N <= 0 || C <= 0 || H <= 0 || W <= 0 || R <= 0 || PH <= 0 || PW <= 0)
    return cudaErrorInvalidValue;
  const size_t total = static_cast<size_t>(R) * C * PH * PW;
  const size_t want = (total + kThreads - 1) / kThreads;
  const unsigned blocks = static_cast<unsigned>(want < 1u << 30 ? want
                                                                : 1u << 30);
  roi_pool_fwd_kernel<<<blocks, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(data), static_cast<const float*>(rois),
      static_cast<float*>(out), static_cast<int*>(count), N, C, H, W, R, PH,
      PW, scale);
  return cudaGetLastError();
}

// dy (R, C, PH, PW) float32, data, rois and scale as the forward took
// them, out and count as it wrote them; dx (N, C, H, W) float32, every
// element written. One launch on `stream`; returns cudaGetLastError().
int roi_pool_backward(const void* dy, const void* data, const void* out,
                      const void* count, const void* rois, void* dx, int N,
                      int C, int H, int W, int R, int PH, int PW, float scale,
                      void* stream) {
  const int T = 5 + 2 * PH + 2 * PW;
  if (N <= 0 || C <= 0 || H <= 0 || W <= 0 || R < 0 || PH <= 0 ||
      PW <= 0 || T > kTableSmemWords)
    return cudaErrorInvalidValue;
  const int chunk = R == 0 ? 1 : min(R, kTableSmemWords / T);
  const size_t total = static_cast<size_t>(N) * C * H * W;
  const size_t blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffu) return cudaErrorInvalidValue;
  roi_pool_bwd_kernel<<<static_cast<unsigned>(blocks), kThreads,
                        sizeof(int) * chunk * T,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(dy), static_cast<const float*>(data),
      static_cast<const float*>(out), static_cast<const int*>(count),
      static_cast<const float*>(rois), static_cast<float*>(dx), N, C, H, W,
      R, PH, PW, scale, chunk);
  return cudaGetLastError();
}

const char* roi_pooling_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
