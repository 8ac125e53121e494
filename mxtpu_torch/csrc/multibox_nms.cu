// Greedy non-maximum suppression over score-sorted candidates for Hopper
// (sm_90a), CUDA C++: the sweep of MultiBoxDetection.
//
// Replaces mxtpu/ops/contrib.py:_nms_scan, an XLA lax.scan (not Pallas)
// over the nms_topk score-sorted candidates of each image. Same
// function: alive_0 = score > -inf; step i keeps i if it is alive; a kept
// i clears every later j with IoU(i, j) > thresh and the same class (any
// class under force_suppress). The output is the keep mask (B, K), one
// byte a candidate (torch.bool).
//
// What bounds it on this card: neither bytes nor operations. It reads
// 24 bytes a candidate and writes one (~10 KB an image at K = 400) and
// does ~K^2/2 IoUs (80 k at K = 400, ~2 MFLOP), far below a launch's
// latency either way. What it has is a chain of K dependent steps, which
// mxtpu's XLA runs as one loop on the device and a PyTorch loop would run
// as ~4 launches a step from the host.
//
// What the design does about that: one block an image, everything in
// shared memory, one launch for the batch.
//   1. The block loads the image's boxes and class ids into shared
//      memory. Each warp then takes rows i in turn and, for each 32-column
//      word w of the row, lane b computes "i clears j = 32 w + b" and a
//      ballot makes the word. Only the words from i's own on are made
//      and kept (row i needs j > i), so
//      the bit matrix is an upper triangle: ~K^2/64 words (2,896 at K =
//      400, 30,272 at K = 1,376, with nms_topk = -1 on the tiny net).
//   2. Warp 0 sweeps the rows in order. Lane l holds alive words l and
//      l + 32 in registers (K <= 2048); bit i is read with one shuffle
//      from its owner and, when set, each lane clears its words with
//      row i's. A kept i stays alive and a cleared one was never kept,
//      so the final alive mask is the keep mask.
// IoU in mxtpu's order with every product, sum, difference and quotient
// rounded on its own (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn), so
// nvcc cannot contract a pair into an FMA and move it across the
// threshold; max/min propagate NaN as torch.maximum/minimum do. The
// kernel therefore equals its plain PyTorch version bit for bit.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float tmax(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}

__device__ __forceinline__ float tmin(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fminf(a, b);
}

// extents as torch's clamp(min=0): NaN passes
__device__ __forceinline__ float extent(float hi, float lo) {
  float d = __fsub_rn(hi, lo);
  return d < 0.f ? 0.f : d;
}

__device__ __forceinline__ float box_iou(float4 a, float4 b) {
  float iw = extent(tmin(a.z, b.z), tmax(a.x, b.x));
  float ih = extent(tmin(a.w, b.w), tmax(a.y, b.y));
  float inter = __fmul_rn(iw, ih);
  float area_a = __fmul_rn(extent(a.z, a.x), extent(a.w, a.y));
  float area_b = __fmul_rn(extent(b.z, b.x), extent(b.w, b.y));
  float uni = __fsub_rn(__fadd_rn(area_a, area_b), inter);
  return uni > 0.f ? __fdiv_rn(inter, uni) : 0.f;
}

// first word of row i's stored part in the triangle: each row of word
// block v (rows 32 v .. 32 v + 31) keeps the W - v words from v on
__host__ __device__ __forceinline__ int row_offset(int i, int W) {
  int v = i >> 5;
  return 32 * (v * W - v * (v - 1) / 2) + (i - 32 * v) * (W - v);
}

__global__ void __launch_bounds__(kThreads)
multibox_nms_kernel(const float* __restrict__ boxes,
                    const float* __restrict__ scores,
                    const float* __restrict__ cls,
                    bool* __restrict__ keep, int K, float thresh,
                    int force) {
  extern __shared__ float4 smem[];
  const int W = (K + 31) >> 5;
  float4* sbox = smem;                                   // K
  float* scls = reinterpret_cast<float*>(sbox + K);      // K
  uint32_t* mask = reinterpret_cast<uint32_t*>(scls + K);
  const int tri = row_offset(K, W);  // words of every row < K
  uint32_t* alive_out = mask + tri;  // W

  const int64_t img = blockIdx.x;
  const float* b_boxes = boxes + img * K * 4;
  const float* b_scores = scores + img * K;
  const float* b_cls = cls + img * K;
  for (int k = threadIdx.x; k < K; k += kThreads) {
    sbox[k] = make_float4(b_boxes[4 * k], b_boxes[4 * k + 1],
                          b_boxes[4 * k + 2], b_boxes[4 * k + 3]);
    scls[k] = b_cls[k];
  }
  __syncthreads();

  // 1. the triangle of "i clears j" words, a row a warp at a time
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int i = warp; i < K; i += kWarps) {
    const float4 bi = sbox[i];
    const float ci = scls[i];
    const int wi = i >> 5;
    uint32_t* row = mask + row_offset(i, W);  // row[w - wi], w >= wi
    for (int w = wi; w < W; ++w) {
      const int j = 32 * w + lane;
      bool bit = false;
      if (j > i && j < K && (force || ci == scls[j]))
        bit = box_iou(bi, sbox[j]) > thresh;
      const uint32_t word = __ballot_sync(kFull, bit);
      if (lane == 0) row[w - wi] = word;
    }
  }
  __syncthreads();

  // 2. the sweep, by warp 0: lane l holds alive words l and l + 32
  if (warp == 0) {
    uint32_t lo = 0, hi = 0;
    for (int w = 0; w < W; ++w) {
      const int j = 32 * w + lane;
      const uint32_t word =
          __ballot_sync(kFull, j < K && b_scores[j] > -INFINITY);
      if (lane == (w & 31)) {
        if (w < 32) lo = word; else hi = word;
      }
    }
    for (int i = 0; i < K; ++i) {
      const int wi = i >> 5;
      const uint32_t own = __shfl_sync(kFull, wi < 32 ? lo : hi, wi & 31);
      if ((own >> (i & 31)) & 1u) {  // the same in every lane
        const uint32_t* row = mask + row_offset(i, W);
        if (lane >= wi && lane < W) lo &= ~row[lane - wi];
        if (lane + 32 >= wi && lane + 32 < W) hi &= ~row[lane + 32 - wi];
      }
    }
    if (lane < W) alive_out[lane] = lo;
    if (lane + 32 < W) alive_out[lane + 32] = hi;
  }
  __syncthreads();
  for (int k = threadIdx.x; k < K; k += kThreads)
    keep[img * K + k] = (alive_out[k >> 5] >> (k & 31)) & 1u;
}

// Shared memory of one block at K candidates, in bytes: the boxes and
// class ids, the triangle, the alive words (ops/contrib.py nms_smem_bytes)
long long smem_bytes(int K) {
  const int W = (K + 31) >> 5;
  return 4 * (5LL * K + row_offset(K, W) + W);
}

}  // namespace

extern "C" {

// boxes (B, K, 4), scores (B, K), cls (B, K): float32, contiguous, sorted
// by score; keep (B, K) bytes. Returns cudaGetLastError() after the
// launch (cudaErrorInvalidValue for K outside [1, 2048] or shared memory
// beyond the device's opt-in limit).
int multibox_nms(const void* boxes, const void* scores, const void* cls,
                 void* keep, int B, int K, float thresh, int force,
                 void* stream) {
  if (B <= 0 || K <= 0 || K > 2048) return cudaErrorInvalidValue;
  const long long bytes = smem_bytes(K);
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  if (bytes > optin) return cudaErrorInvalidValue;
  if (bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        multibox_nms_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (e != cudaSuccess) return e;
  }
  multibox_nms_kernel<<<B, kThreads, static_cast<size_t>(bytes),
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(boxes), static_cast<const float*>(scores),
      static_cast<const float*>(cls), static_cast<bool*>(keep), K, thresh,
      force);
  return cudaGetLastError();
}

const char* multibox_nms_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
