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
// map pixels that some bin covers and the ROIs and writes the max; its
// backward reads dy, those pixels (each bin's max and tie count follow
// from them again) and the ROIs and writes the whole dx. At the training
// shape (R = 256, C = 512, 7x7, a 2x512x37x62 map, 98 % of it covered)
// that is ~35 MB and ~44 MB, ~10 and ~13 microseconds at 3.35 TB/s. The map (9.4 MB) stays in L2 between
// launches. A bin holds ~6 pixels there, so what costs besides the max's
// and dy's bytes is the work around each bin: its bounds, its reads, and
// lanes of a warp that walk different bins.
//
// Design. Three launches, one forward and two backward. No two threads
// ever add into one element, so no sum depends on the order threads run:
//   1. roi_bins_kernel<false> (the forward): one block a (ROI, 32
//      channels, group of up to 64 bins). Warp 0 computes the ROI's
//      frame and its PH + PW bin spans, reduces them to the ROI's window,
//      rows [y_lo, y_hi) x columns [x_lo, x_hi) (the union of its bins:
//      every bin is a product of a row span and a column span, and
//      consecutive spans touch), and puts the bounds of the block's bins
//      into shared memory, once an item. The block stages the
//      window of its channels into shared memory with cp.async, a 2-D
//      tile of it at a time where the window is larger than kTileFloats.
//      A lane is a channel and a warp carries up to kBinsPerWarp bins, so
//      the lanes of a warp walk the same bin (the same trip counts) and
//      read a channel stride apart (odd: no bank conflict); the running
//      max of each bin stays in registers across the tiles. The maxima
//      go through shared memory to be written coalesced: out[r, c0:c0+32,
//      :, :] is contiguous. Each window pixel is read from L2 once per
//      channel, not once per bin holding it. The forward writes the max
//      alone. As many blocks as stay resident walk the items in turn, and
//      lanes 0-4 of warp 0 load the next item's ROI while the block works
//      on the current one.
//   2. roi_bins_kernel<true> (the backward's first launch): the same walk
//      counts the pixels equal to each bin's max and writes, once a bin,
//      the pair (max, share of dy) into a scratch laid out (R, PH, PW, C),
//      channels innermost, so a warp writes 32 channels' pairs at once:
//      share = dy / count (__fdiv_rn, as jnp.max's vjp), 0 with a max of
//      0 for a bin whose max is not finite, and the kNanBin marker for a
//      bin holding a NaN. The first block of each ROI writes the ROI's bin
//      table (its layout at roi_pool_gather_kernel).
//   3. roi_pool_gather_kernel (the backward's second launch): one block a
//      (image, kTileY x kTileX pixels, kGroupChannels channels). The
//      block lists, in ROI order, the ROIs of its image whose window
//      meets its tile (a ballot and a prefix sum over a chunk of ROIs at
//      a time) and copies their tables into shared memory. Each warp
//      takes one pixel, its lanes the channels. Its lanes find, one
//      listed ROI each, the bins of that ROI holding the pixel (a range
//      of rows by a range of columns), and a prefix sum over the lanes
//      puts them in (ROI, ph, pw) order in the warp's list; the warp then
//      reads the (max, share) pairs of 32 channels a bin, coalesced,
//      kBatch bins at a time. Each lane sums, from 0 in (ROI, ph, pw)
//      order, the share of every bin holding its pixel whose max equals
//      its value: the order and the terms of one thread an element
//      summing over every ROI, so repeats are bit-identical (adding the 0
//      of a bin whose max is not finite leaves the sum as it is: the sum
//      is never -0).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// the forward and the backward's first launch
constexpr int kChannelTile = 32;  // channels a block: one a lane
constexpr int kBinsPerWarp = 8;   // bins a warp carries
constexpr int kGroupBins = kWarps * kBinsPerWarp;  // bins a block
constexpr int kTileFloats = 8192;  // the staged window: 32 KB
// the gather
constexpr int kTileY = 2, kTileX = 4;  // pixels a block: one a warp
constexpr int kLaneChannels = 4;       // channels a lane sums, 32 apart
constexpr int kGroupChannels = 32 * kLaneChannels;
constexpr int kTableSmemWords = 2048;  // listed ROIs' spans: 8 KB
constexpr int kListCap = 64;  // bins a warp lists at a time
constexpr int kBatch = 4;     // bins whose pairs a warp reads at once
constexpr int kTableWordsMax = 8192;   // the most table words a ROI has
constexpr unsigned kNanBin = 0xffc00001u;  // the share of a bin with NaN
constexpr unsigned kCanonicalNan = 0x7fffffffu;

__device__ __forceinline__ float nan_max(float a, float b) {
  return a != a ? a : fmaxf(a, b);  // b is never NaN here
}

__device__ __forceinline__ float nan_clip(float v, float lo, float hi) {
  return v != v ? v : fminf(fmaxf(v, lo), hi);
}

struct Frame {
  float x1, y1, bin_w, bin_h;
};

// the frame of a ROI whose corners (image pixels) are x1, y1, x2, y2
__device__ __forceinline__ Frame roi_frame(float x1, float y1, float x2,
                                           float y2, float scale, int ph,
                                           int pw) {
  Frame f;
  f.x1 = rintf(__fmul_rn(x1, scale));
  f.y1 = rintf(__fmul_rn(y1, scale));
  x2 = rintf(__fmul_rn(x2, scale));
  y2 = rintf(__fmul_rn(y2, scale));
  const float rw = nan_max(__fadd_rn(__fsub_rn(x2, f.x1), 1.f), 1.f);
  const float rh = nan_max(__fadd_rn(__fsub_rn(y2, f.y1), 1.f), 1.f);
  f.bin_w = __fmul_rn(rw, __frcp_rn(static_cast<float>(pw)));
  f.bin_h = __fmul_rn(rh, __frcp_rn(static_cast<float>(ph)));
  return f;
}

// bin p's span [lo, hi) along an axis of n pixels, bins of size b from
// origin o; a NaN bound gives the empty span. lo and hi do not decrease
// with p (b is positive, +inf or NaN), which the gather's loops use.
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

// n / d for n < 2^16 and 1 <= d <= 2^16 with a multiply: m is
// ceil(2^32 / d), and n * (m - 2^32 / d) < 2^32 keeps the product's high
// word the quotient (d == 1 is taken apart: its m does not fit)
struct FastDiv {
  unsigned d, m;
  __device__ explicit FastDiv(int divisor)
      : d(static_cast<unsigned>(divisor)),
        m(divisor == 1 ? 0u : 0xffffffffu / static_cast<unsigned>(divisor)
                                  + 1u) {}
  __device__ __forceinline__ int operator()(int n) const {
    return d == 1 ? n : static_cast<int>(__umulhi(static_cast<unsigned>(n),
                                                  m));
  }
};

// (block index) -> (i / a, i % a) for the walk over blocks
__device__ __forceinline__ size_t split(size_t i, int a, int* rem) {
  *rem = static_cast<int>(i % static_cast<size_t>(a));
  return i / static_cast<size_t>(a);
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

// The forward (kShare false: writes out, the max) and the backward's
// first launch (kShare true: reads dy, writes kv, the (max, share) pairs
// laid out (R, PH, PW, C), and table, the ROIs' bin tables). A block is
// (ROI r, channel tile ct of kChannelTile channels, bin group g of
// kGroupBins bins); lane c of warp w carries channel c0 + c of bins
// g * kGroupBins + w + kWarps * j.
template <bool kShare>
__global__ void __launch_bounds__(kThreads, 4)
    roi_bins_kernel(const float* __restrict__ data,
                    const float* __restrict__ rois,
                    const float* __restrict__ dy, float* __restrict__ out,
                    float2* __restrict__ kv, int* __restrict__ table, int N,
                    int C, int H, int W, int R, int PH, int PW,
                    float scale) {
  __shared__ __align__(16) float tile[kTileFloats];
  __shared__ int4 spans[kGroupBins];  // the item's bins: hs, he, ws, we
  __shared__ float dys[kShare ? kChannelTile * kGroupBins : 1];
  __shared__ int meta[8];  // image, window (4), TH, TW
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int PHPW = PH * PW;
  const int S = 2 * PH + 2 * PW;
  const size_t HW = static_cast<size_t>(H) * W;
  const int ctiles = (C + kChannelTile - 1) / kChannelTile;
  const int groups = (PHPW + kGroupBins - 1) / kGroupBins;
  const size_t blocks = static_cast<size_t>(R) * ctiles * groups;
  // lanes 0-4 of warp 0 hold the current item's ROI and load the next
  // one's while the block works on the current item
  auto roi_word = [&](size_t item) {
    int unused;
    const size_t r = split(split(item, groups, &unused), ctiles, &unused);
    return warp == 0 && lane < 5 && item < blocks
               ? __ldg(rois + 5 * r + lane)
               : 0.f;
  };
  float roi_now = roi_word(blockIdx.x);
  for (size_t blk = blockIdx.x; blk < blocks; blk += gridDim.x) {
    int g, ct;
    const int r =
        static_cast<int>(split(split(blk, groups, &g), ctiles, &ct));
    const float roi_next = roi_word(blk + gridDim.x);
    const int c0 = ct * kChannelTile;
    const int nc = min(kChannelTile, C - c0);
    const int b0 = g * kGroupBins;
    const int nb = min(kGroupBins, PHPW - b0);
    const size_t plane = static_cast<size_t>(r) * C + c0;  // out's row
    __syncthreads();  // the previous item's readers of shared memory
    if (warp == 0) {
      // the frame, the spans and the window; the tile's sizes
      const Frame f = roi_frame(__shfl_sync(0xffffffffu, roi_now, 1),
                                __shfl_sync(0xffffffffu, roi_now, 2),
                                __shfl_sync(0xffffffffu, roi_now, 3),
                                __shfl_sync(0xffffffffu, roi_now, 4), scale,
                                PH, PW);
      const float image = __shfl_sync(0xffffffffu, roi_now, 0);
      const bool writes_table = kShare && ct == 0 && g == 0;
      int* row = kShare ? table + static_cast<size_t>(r) * (5 + S) : nullptr;
      int win[4] = {H, 0, W, 0};  // y_lo, y_hi, x_lo, x_hi
      for (int p = lane; p < PH + PW; p += 32) {
        int lo, hi;
        const bool rows = p < PH;
        const int q = rows ? p : p - PH;
        if (rows)
          bin_span(q, f.bin_h, f.y1, H, &lo, &hi);
        else
          bin_span(q, f.bin_w, f.x1, W, &lo, &hi);
        if (writes_table) {
          const int at = rows ? q : 2 * PH + q;
          row[5 + at] = lo;
          row[5 + at + (rows ? PH : PW)] = hi;
        }
        if (lo < hi) {
          const int k = rows ? 0 : 2;
          win[k] = min(win[k], lo);
          win[k + 1] = max(win[k + 1], hi);
        }
      }
      // the spans of this item's bins, once
      for (int k = lane; k < nb; k += 32) {
        const int ph = (b0 + k) / PW, pw = b0 + k - ph * PW;
        int hs, he, ws, we;
        bin_span(ph, f.bin_h, f.y1, H, &hs, &he);
        bin_span(pw, f.bin_w, f.x1, W, &ws, &we);
        spans[k] = make_int4(hs, he, ws, we);
      }
      win[0] = __reduce_min_sync(0xffffffffu, win[0]);
      win[1] = __reduce_max_sync(0xffffffffu, win[1]);
      win[2] = __reduce_min_sync(0xffffffffu, win[2]);
      win[3] = __reduce_max_sync(0xffffffffu, win[3]);
      if (lane == 0) {
        const int b = roi_image(image, N);
        meta[0] = b;
        for (int i = 0; i < 4; ++i) meta[1 + i] = win[i];
        // a tile of TH x TW pixels a channel, each channel's block of it
        // an odd number of floats apart
        const int cap = kTileFloats / nc - 1;
        const int TW = min(max(win[3] - win[2], 1), cap);
        meta[5] = min(max(win[1] - win[0], 1), cap / TW);
        meta[6] = TW;
        if (writes_table) {
          row[0] = b;
          for (int i = 0; i < 4; ++i) row[1 + i] = win[i];
        }
      }
    }
    const FastDiv div_nb(nb);
    if (kShare)
      for (int i = tid; i < nc * nb; i += kThreads) {
        const int c = div_nb(i);
        dys[i] = dy[(plane + c) * PHPW + b0 + i - c * nb];
      }
    __syncthreads();
    const int b = meta[0];
    const int y_lo = meta[1], y_hi = meta[2], x_lo = meta[3], x_hi = meta[4];
    const int TH = meta[5], TW = meta[6];
    const bool live = lane < nc;
    int cnt[kBinsPerWarp];
    float m[kBinsPerWarp];
    bool nan[kBinsPerWarp];
#pragma unroll
    for (int j = 0; j < kBinsPerWarp; ++j) {
      m[j] = -INFINITY;
      cnt[j] = 0;
      nan[j] = false;
    }
    for (int y0 = y_lo; y0 < y_hi; y0 += TH) {
      const int th = min(TH, y_hi - y0);
      for (int x0 = x_lo; x0 < x_hi; x0 += TW) {
        const int tw = min(TW, x_hi - x0);
        const int n_i = th * tw;
        const int P = n_i | 1;  // a channel's stride in the tile
        const FastDiv div_tw(tw);
        const float* plane0 = data + (static_cast<size_t>(b) * C + c0) * HW;
        for (int i = tid; i < n_i; i += kThreads) {
          const int ty = div_tw(i);
          const int tx = i - ty * tw;
          const float* src =
              plane0 + static_cast<size_t>(y0 + ty) * W + x0 + tx;
          float* dst = tile + i;
          for (int c = 0; c < nc; ++c) {
            cp_async4(dst, src);
            src += HW;
            dst += P;
          }
        }
        cp_async_wait_all();
        __syncthreads();
        const float* t = tile + lane * P;
#pragma unroll
        for (int j = 0; j < kBinsPerWarp; ++j) {
          const int k = warp + kWarps * j;
          if (k >= nb || !live) continue;
          const int4 sp = spans[k];
          const int ya = max(sp.x, y0), yb = min(sp.y, y0 + th);
          const int xa = max(sp.z, x0), xb = min(sp.w, x0 + tw);
          float mj = m[j];
          int cj = cnt[j];
          bool nj = nan[j];
          int at = (ya - y0) * tw - x0;
          for (int y = ya; y < yb; ++y, at += tw) {
            for (int x = xa; x < xb; ++x) {
              const float v = t[at + x];
              if (!kShare) {  // the max alone: NaN is kept apart
                nj |= v != v;
                mj = fmaxf(mj, v);
              } else if (v != v) {
                nj = true;
              } else if (v > mj) {
                mj = v;
                cj = 1;
              } else if (v == mj) {
                ++cj;
              }
            }
          }
          m[j] = mj;
          cnt[j] = cj;
          nan[j] = nj;
        }
        __syncthreads();  // the tile is read before the next one lands
      }
    }
    // the maxima: through shared memory to out, coalesced; or the pairs
    // straight to kv, consecutive lanes on consecutive channels
#pragma unroll
    for (int j = 0; j < kBinsPerWarp; ++j) {
      const int k = warp + kWarps * j;
      if (k >= nb || !live) continue;
      const bool finite = isfinite(m[j]);
      if (!kShare) {
        tile[lane * nb + k] = nan[j] || !finite ? 0.f : m[j];
        continue;
      }
      float2 pair = make_float2(0.f, 0.f);
      if (nan[j]) {
        pair.y = __uint_as_float(kNanBin);
      } else if (finite) {
        const float s = __fdiv_rn(dys[lane * nb + k],
                                  static_cast<float>(cnt[j]));
        pair = make_float2(m[j], s != s ? __uint_as_float(kCanonicalNan)
                                        : s);
      }
      kv[(static_cast<size_t>(r) * PHPW + b0 + k) * C + c0 + lane] = pair;
    }
    if (!kShare) {
      __syncthreads();
      for (int i = tid; i < nc * nb; i += kThreads) {
        const int c = div_nb(i);
        out[(plane + c) * PHPW + b0 + i - c * nb] = tile[i];
      }
    }
    roi_now = roi_next;
  }
}

// The backward's sum (see the head comment). table holds each ROI's bin
// table, T = 5 + 2 PH + 2 PW words: [image, y_lo, y_hi, x_lo, x_hi,
// hs[PH], he[PH], ws[PW], we[PW]]; kv the (max, share) pairs, (R, PH, PW,
// C). A block is (image n, tile of kTileY x kTileX pixels, channels c0 ..
// c0 + kGroupChannels): warp w sums pixel w of the tile, lane c channels
// c0 + c + 32 k. kThreads ROIs are listed at a time.
__global__ void __launch_bounds__(kThreads, 3)
    roi_pool_gather_kernel(const float* __restrict__ data,
                           const float2* __restrict__ kv,
                           const int* __restrict__ table,
                           float* __restrict__ dx, int N, int C, int H,
                           int W, int R, int PH, int PW) {
  constexpr int kPix = kTileY * kTileX;
  constexpr int kStride = kPix + 1;  // a channel's row of pixels, padded
  static_assert(kPix == kWarps, "one pixel a warp");
  __shared__ int4 hdr[kThreads];  // listed ROIs' windows
  __shared__ int rid[kThreads];   // and their indices, in ROI order
  __shared__ int tabs[kTableSmemWords];
  __shared__ float vals[kGroupChannels * kStride];  // the map, then dx
  __shared__ int lists[kWarps][kListCap];  // each warp's bins, in order
  __shared__ int wcount[kWarps];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int S = 2 * PH + 2 * PW, T = 5 + S, PHPW = PH * PW;
  int* list = lists[warp];
  const int tiles_x = (W + kTileX - 1) / kTileX;
  const int tiles_y = (H + kTileY - 1) / kTileY;
  const int groups = (C + kGroupChannels - 1) / kGroupChannels;
  const size_t HW = static_cast<size_t>(H) * W;
  const size_t blocks =
      static_cast<size_t>(N) * tiles_y * tiles_x * groups;
  const FastDiv div_s(S);
  for (size_t blk = blockIdx.x; blk < blocks; blk += gridDim.x) {
    int grp, txi, tyi;
    const int n = static_cast<int>(
        split(split(split(blk, groups, &grp), tiles_x, &txi), tiles_y, &tyi));
    const int y0 = tyi * kTileY, x0 = txi * kTileX;
    const int y1 = min(y0 + kTileY, H), x1 = min(x0 + kTileX, W);
    const int c0 = grp * kGroupChannels;
    const int nc = min(kGroupChannels, C - c0);
    const float* plane0 = data + (static_cast<size_t>(n) * C + c0) * HW;
    float* dx0 = dx + (static_cast<size_t>(n) * C + c0) * HW;
    __syncthreads();  // the previous item's readers of shared memory
    for (int e = tid; e < nc * kPix; e += kThreads) {
      const int c = e / kPix, p = e % kPix;
      const int y = y0 + p / kTileX, x = x0 + p % kTileX;
      vals[c * kStride + p] =
          y < H && x < W ? plane0[c * HW + static_cast<size_t>(y) * W + x]
                         : 0.f;
    }
    // warp `warp` sums pixel (py, px) for channels c0 + lane + 32 k
    const int py = y0 + warp / kTileX, px = x0 + warp % kTileX;
    const bool active = py < H && px < W;
    float acc[kLaneChannels], v[kLaneChannels];
#pragma unroll
    for (int k = 0; k < kLaneChannels; ++k) acc[k] = 0.f;
    for (int r0 = 0; r0 < R; r0 += kThreads) {
      const int rc = min(kThreads, R - r0);
      bool hit = false;
      int4 h = make_int4(0, 0, 0, 0);
      if (tid < rc) {
        const int* t = table + static_cast<size_t>(r0 + tid) * T;
        h = make_int4(t[1], t[2], t[3], t[4]);
        hit = t[0] == n && h.x < y1 && h.y > y0 && h.z < x1 && h.w > x0;
      }
      const unsigned mask = __ballot_sync(0xffffffffu, hit);
      __syncthreads();  // the previous chunk's readers are done
      if (lane == 0) wcount[warp] = __popc(mask);
      __syncthreads();
      int at = 0, L = 0;
      for (int w = 0; w < kWarps; ++w) {
        at += w < warp ? wcount[w] : 0;
        L += wcount[w];
      }
      if (hit) {
        const int q = at + __popc(mask & ((1u << lane) - 1u));
        hdr[q] = h;
        rid[q] = r0 + tid;
      }
      __syncthreads();
      if (r0 == 0) {
#pragma unroll
        for (int k = 0; k < kLaneChannels; ++k) {
          const int c = lane + 32 * k;
          v[k] = c < nc ? vals[c * kStride + warp] : 0.f;
        }
      }
      // the listed ROIs' spans: copied into shared memory a batch at a
      // time (each ROI's an odd number of words apart), or read where
      // they are when one ROI's do not fit
      const bool in_smem = S + 1 <= kTableSmemWords;
      const int Sp = S | 1;
      const int batch = in_smem ? kTableSmemWords / Sp : max(L, 1);
      for (int q0 = 0; q0 < L; q0 += batch) {
        const int qn = min(batch, L - q0);
        if (in_smem) {
          __syncthreads();  // the previous batch's readers are done
          for (int i = tid; i < qn * S; i += kThreads) {
            const int q = div_s(i);
            tabs[q * Sp + i - q * S] =
                table[static_cast<size_t>(rid[q0 + q]) * T + 5 + i - q * S];
          }
          __syncthreads();
        }
        if (!active) continue;
        // 32 listed ROIs at a time, one a lane: each lane finds the bins
        // of its ROI that hold the pixel (a range of rows by a range of
        // columns: the spans do not decrease), a prefix sum over the
        // lanes places them in (ROI, ph, pw) order in the warp's list,
        // and the warp reads the list's (max, share) pairs kBatch bins
        // at a time
        for (int qg = q0; qg < q0 + qn; qg += 32) {
          const int q = qg + lane;
          int pa = 0, pb = -1, wa = 0, wb = -1, row0 = 0;
          if (q < q0 + qn) {
            const int4 w = hdr[q];
            if (py >= w.x && py < w.y && px >= w.z && px < w.w) {
              const int* hs = in_smem ? tabs + (q - q0) * Sp
                                      : table + static_cast<size_t>(rid[q]) *
                                                    T + 5;
              const int* he = hs + PH;
              const int* ws = he + PH;
              const int* we = ws + PW;
              for (int ph = 0; ph < PH && hs[ph] <= py; ++ph)
                if (py < he[ph]) {
                  pa = pb < 0 ? ph : pa;
                  pb = ph;
                }
              for (int pw = 0; pw < PW && ws[pw] <= px; ++pw)
                if (px < we[pw]) {
                  wa = wb < 0 ? pw : wa;
                  wb = pw;
                }
              row0 = rid[q] * PHPW;
            }
          }
          const int nw = wb - wa + 1;
          const int nbins = pb < 0 || wb < 0 ? 0 : (pb - pa + 1) * nw;
          int end = nbins;  // inclusive prefix sum over the lanes
#pragma unroll
          for (int d = 1; d < 32; d <<= 1) {
            const int t = __shfl_up_sync(0xffffffffu, end, d);
            if (lane >= d) end += t;
          }
          const int total = __shfl_sync(0xffffffffu, end, 31);
          const int start = end - nbins;
          for (int base = 0; base < total; base += kListCap) {
            // this lane's bins whose place falls in [base, base + cap)
            for (int i = max(start, base); i < min(end, base + kListCap);
                 ++i) {
              const int j = i - start;
              const int ph = pa + j / nw;
              list[i - base] = row0 + ph * PW + wa + j - (ph - pa) * nw;
            }
            __syncwarp();
            const int cnt = min(kListCap, total - base);
            for (int i = 0; i < cnt; i += kBatch) {
              float2 e[kBatch][kLaneChannels];
#pragma unroll
              for (int t = 0; t < kBatch; ++t) {
                const float2* kb =
                    kv + static_cast<size_t>(i + t < cnt ? list[i + t] : 0) *
                             C + c0 + lane;
#pragma unroll
                for (int k = 0; k < kLaneChannels; ++k)
                  e[t][k] = i + t < cnt && lane + 32 * k < nc
                                ? __ldg(kb + 32 * k)
                                : make_float2(1.f, 0.f);
              }
#pragma unroll
              for (int t = 0; t < kBatch; ++t) {
                if (i + t >= cnt) break;
#pragma unroll
                for (int k = 0; k < kLaneChannels; ++k) {
                  if (__float_as_uint(e[t][k].y) == kNanBin)
                    acc[k] = __fadd_rn(acc[k], __int_as_float(0x7fc00000));
                  else if (v[k] == e[t][k].x)
                    acc[k] = __fadd_rn(acc[k], e[t][k].y);
                }
              }
            }
            __syncwarp();  // the list is read before it is rewritten
          }
        }
      }
    }
    __syncthreads();  // every lane has read its value
#pragma unroll
    for (int k = 0; k < kLaneChannels; ++k) {
      const int c = lane + 32 * k;
      if (c < nc) vals[c * kStride + warp] = acc[k];
    }
    __syncthreads();
    for (int e = tid; e < nc * kPix; e += kThreads) {
      const int c = e / kPix, p = e % kPix;
      const int y = y0 + p / kTileX, x = x0 + p % kTileX;
      if (y < H && x < W)
        dx0[c * HW + static_cast<size_t>(y) * W + x] = vals[c * kStride + p];
    }
  }
}

// as many blocks as `kernel` keeps resident on the card, or fewer: each
// walks the items blockIdx.x, + gridDim.x, ...
template <typename Kernel>
unsigned grid_of(Kernel kernel, size_t items) {
  int device = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                0);
  const size_t resident = static_cast<size_t>(sms > 0 ? sms : 1) *
                          (per_sm > 0 ? per_sm : 1);
  return static_cast<unsigned>(items < resident ? items : resident);
}

int launch_bins(bool share, const float* data, const float* rois,
                const float* dy, float* out, float2* kv, int* table, int N,
                int C, int H, int W, int R, int PH, int PW, float scale,
                cudaStream_t stream) {
  const size_t groups =
      (static_cast<size_t>(PH) * PW + kGroupBins - 1) / kGroupBins;
  const size_t blocks = static_cast<size_t>(R) *
                        ((C + kChannelTile - 1) / kChannelTile) * groups;
  if (share)
    roi_bins_kernel<true>
        <<<grid_of(roi_bins_kernel<true>, blocks), kThreads, 0, stream>>>(
            data, rois, dy, out, kv, table, N, C, H, W, R, PH, PW, scale);
  else
    roi_bins_kernel<false>
        <<<grid_of(roi_bins_kernel<false>, blocks), kThreads, 0, stream>>>(
            data, rois, dy, out, kv, table, N, C, H, W, R, PH, PW, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// data (N, C, H, W), rois (R, 5): float32, contiguous; out (R, C, PH, PW)
// float32, the max. One launch on `stream`; returns cudaGetLastError().
int roi_pool_forward(const void* data, const void* rois, void* out, int N,
                     int C, int H, int W, int R, int PH, int PW, float scale,
                     void* stream) {
  if (N <= 0 || C <= 0 || H <= 0 || W <= 0 || R <= 0 || PH <= 0 || PW <= 0)
    return cudaErrorInvalidValue;
  return launch_bins(false, static_cast<const float*>(data),
                     static_cast<const float*>(rois), nullptr,
                     static_cast<float*>(out), nullptr, nullptr, N, C, H, W,
                     R, PH, PW, scale, static_cast<cudaStream_t>(stream));
}

// dy (R, C, PH, PW) float32, data, rois and scale as the forward took
// them; kv (R, PH, PW, C, 2) float32 and table (R, 5 + 2 PH + 2 PW) int32
// scratch; dx (N, C, H, W) float32, every element written. Two launches
// on `stream` (none of the first for R = 0); returns the first non-zero
// cudaGetLastError().
int roi_pool_backward(const void* dy, const void* data, const void* rois,
                      void* kv, void* table, void* dx, int N, int C, int H,
                      int W, int R, int PH, int PW, float scale,
                      void* stream) {
  if (N <= 0 || C <= 0 || H <= 0 || W <= 0 || R < 0 || PH <= 0 ||
      PW <= 0 || 5 + 2 * PH + 2 * PW > kTableWordsMax)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (R > 0) {
    const int rc = launch_bins(true, static_cast<const float*>(data),
                               static_cast<const float*>(rois),
                               static_cast<const float*>(dy), nullptr,
                               static_cast<float2*>(kv),
                               static_cast<int*>(table), N, C, H, W, R, PH,
                               PW, scale, s);
    if (rc != 0) return rc;
  }
  const size_t blocks = static_cast<size_t>(N) *
                        ((H + kTileY - 1) / kTileY) *
                        ((W + kTileX - 1) / kTileX) *
                        ((C + kGroupChannels - 1) / kGroupChannels);
  roi_pool_gather_kernel<<<grid_of(roi_pool_gather_kernel, blocks),
                           kThreads, 0, s>>>(
      static_cast<const float*>(data), static_cast<const float2*>(kv),
      static_cast<const int*>(table), static_cast<float*>(dx), N, C, H, W,
      R, PH, PW);
  return cudaGetLastError();
}

const char* roi_pooling_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
