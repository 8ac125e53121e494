// Greedy non-maximum suppression over score-sorted candidates for Hopper
// (sm_90a), CUDA C++: the sweep of MultiBoxDetection, for any number of
// candidates K.
//
// Replaces mxtpu/ops/contrib.py:_nms_scan, an XLA lax.scan (not Pallas)
// over the nms_topk score-sorted candidates of each image. Same
// function: alive_0 = score > -inf; step i keeps i if it is alive; a kept
// i clears every later j with IoU(i, j) > thresh and the same class (any
// class under force_suppress). The output is the keep mask (B, K), one
// byte a candidate (torch.bool).
//
// What bounds it on this card: neither bytes nor operations. It reads 24
// bytes a candidate and writes one, and needs an IoU (14 operations) for
// each kept i and each later live j of its class: at K = 7,486 and B = 32,
// 6 MB and 0.5-2 G operations, a few to 30 microseconds at the card's
// rates. Neither is reached. The time goes where the bound does not look:
// the matrix tests every pair of live candidates, kept or not (K^2 / 2 an
// image, 0.9 G pairs at K = 7,486 and B = 32), at the rate the card
// issues instructions, a warp paying for the divide when one of its 32
// rows needs it; and the sweep is a chain, candidate i's fate depending
// on every kept candidate before it.
//
// What the design does about that: two launches on the caller's stream,
// the second after the first, with the "i clears j" bit matrix between
// them in a scratch tensor the wrapper allocates.
//   1. nms_matrix_kernel, over the whole card: one block of 64 threads
//      for each (image, 64-row tile r, 64-column tile c >= r), the upper
//      triangle only. The block stages the 64 columns' boxes, areas and
//      class ids in shared memory, thread t loads row i = 64 r + t's box
//      into registers (16-byte loads where the boxes are 16-byte
//      aligned), and makes row i's 64-bit word "i clears j" for the
//      tile's columns j = 64 c .. 64 c + 63, written at mask[img][c][i],
//      so that a warp writes 256 consecutive bytes. A tile whose 64 rows
//      or whose 64 columns are all dead (score not > -inf: -inf, NaN, or
//      past K) exits at once: no word of it is ever needed. That covers
//      every tile past the live count n, so on sorted scores the work
//      follows the live candidates, not K. Per pair the class and j > i
//      are tested first; where the intersection is exactly 0 the IoU is
//      +-0 whatever the union, so the union and the divide are skipped
//      (the decision 0 > thresh is the same).
//   2. nms_sweep_kernel, one block of 1,024 threads an image. The block
//      finds n by a reduction over the score row (the last 64-candidate
//      chunk with a live candidate), and keeps the removed-mask, one bit
//      a candidate, in shared memory (8 bytes per 64 candidates: 936
//      bytes at K = 7,486, 3 KB at 24,564), set at the start for the dead
//      ones. For each chunk of 64 up to n, warp 0 holds the chunk's 64
//      diagonal words in registers (one coalesced read, issued during the
//      previous chunk) and resolves the chunk as the fixed point of
//      kept = alive & ~(OR of the kept rows' diagonal words), a warp
//      reduction an iteration, a few iterations on real candidates; it
//      then ORs the kept rows' words of the next chunk into its removed
//      word while warps 1-31 do the same for the chunks after it, four
//      loads in flight a warp (coalesced reads from L2, no atomics). One
//      barrier a chunk. The chain is ceil(n / 64) chunk steps of about
//      one L2 round trip each, not n single steps. The keep mask is
//      written once at the end, coalesced.
// Why two launches and not one with a thread-block cluster sharing the
// matrix through distributed shared memory: the matrix of one image
// outgrows a cluster's shared memory from K ~ 5,000 on (K^2 / 8 bytes),
// so the two-launch path is needed for large K in any case, and at K =
// 400 the second launch takes a few microseconds; one path is kept.
//
// IoU in mxtpu's order with every product, sum, difference and quotient
// rounded on its own (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn), so
// nvcc cannot contract a pair into an FMA and move it across the
// threshold; a box with a NaN coordinate is staged as the empty box (see
// staged()). The kernel therefore equals its plain PyTorch version bit
// for bit.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;          // candidates a tile, bits a word
constexpr int kSweepThreads = 1024;
constexpr int kSweepWarps = kSweepThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxImageBlocks = 65535;  // gridDim.y

// extents as torch's clamp(min=0)
__device__ __forceinline__ float extent(float hi, float lo) {
  float d = __fsub_rn(hi, lo);
  return d < 0.f ? 0.f : d;
}

__device__ __forceinline__ float box_area(float4 b) {
  return __fmul_rn(extent(b.z, b.x), extent(b.w, b.y));
}

// A box with a NaN coordinate has a NaN intersection with any box, so a
// NaN union and an IoU of 0 in mxtpu's order. The empty box (+inf, +inf,
// -inf, -inf) has an intersection of exactly 0 with any box without NaN,
// so an IoU of 0 too: the kernel stages a NaN box as the empty box and
// then needs no NaN test per pair (min and max of numbers are fminf and
// fmaxf; a zero's sign changes no decision: it makes the product +-0)
__device__ __forceinline__ float4 staged(float4 b) {
  const bool nan = b.x != b.x || b.y != b.y || b.z != b.z || b.w != b.w;
  return nan ? make_float4(INFINITY, INFINITY, -INFINITY, -INFINITY) : b;
}

// IoU(a, b) > thresh, with a's and b's areas given; the areas and the
// divide are skipped where the intersection is exactly 0 (the IoU is
// +-0 whatever the union)
__device__ __forceinline__ bool clears(float4 a, float area_a, float4 b,
                                       float area_b, float thresh) {
  const float iw = extent(fminf(a.z, b.z), fmaxf(a.x, b.x));
  const float ih = extent(fminf(a.w, b.w), fmaxf(a.y, b.y));
  const float inter = __fmul_rn(iw, ih);
  if (inter == 0.f) return 0.f > thresh;
  const float uni = __fsub_rn(__fadd_rn(area_a, area_b), inter);
  return (uni > 0.f ? __fdiv_rn(inter, uni) : 0.f) > thresh;
}

__device__ __forceinline__ float4 load_box(const float* boxes, int64_t k,
                                           bool aligned) {
  const float* p = boxes + 4 * k;
  if (aligned) return *reinterpret_cast<const float4*>(p);
  return make_float4(p[0], p[1], p[2], p[3]);
}

// tiles in the rows before row tile r of the upper triangle
__device__ __forceinline__ long long row_start(long long r, long long T) {
  return r * T - r * (r - 1) / 2;
}

__global__ void __launch_bounds__(kTile)
nms_matrix_kernel(const float* __restrict__ boxes,
                  const float* __restrict__ scores,
                  const float* __restrict__ cls,
                  unsigned long long* __restrict__ mask, int B, int K,
                  int T, float thresh, int force, int aligned) {
  __shared__ float4 sbox[kTile];
  __shared__ float scls[kTile], sarea[kTile];
  // (r, c) of this block's tile from its index p in the upper triangle
  const long long p = blockIdx.x;
  const double b2 = 2.0 * T + 1.0;
  long long r = static_cast<long long>((b2 - sqrt(b2 * b2 - 8.0 * p)) / 2);
  if (r < 0) r = 0;
  if (r > T - 1) r = T - 1;
  while (r > 0 && row_start(r, T) > p) --r;
  while (r + 1 < T && row_start(r + 1, T) <= p) ++r;
  const int c = static_cast<int>(r + (p - row_start(r, T)));
  const int t = threadIdx.x;
  const int i = static_cast<int>(r) * kTile + t;  // this thread's row
  const int j = c * kTile + t;                    // the column it stages

  for (int64_t img = blockIdx.y; img < B; img += gridDim.y) {
    const float* b_boxes = boxes + img * K * 4;
    const float* b_scores = scores + img * K;
    const float* b_cls = cls + img * K;
    const bool row_live = i < K && b_scores[i] > -INFINITY;
    const bool col_live = j < K && b_scores[j] > -INFINITY;
    if (j < K) {
      const float4 bj = load_box(b_boxes, j, aligned);
      sbox[t] = staged(bj);
      sarea[t] = box_area(bj);
      scls[t] = b_cls[j];
    }
    const bool any_row = __syncthreads_or(row_live);
    const bool any_col = __syncthreads_or(col_live);
    if (any_row && any_col && i < K) {
      const float4 box = load_box(b_boxes, i, aligned);
      const float4 bi = staged(box);
      const float ai = box_area(box), ci = b_cls[i];
      const int ncols = min(kTile, K - c * kTile);
      const int first = c == r ? t + 1 : 0;  // j > i
      unsigned long long word = 0;
      for (int jj = first; jj < ncols; ++jj) {
        if ((force || ci == scls[jj]) &&
            clears(bi, ai, sbox[jj], sarea[jj], thresh))
          word |= 1ull << jj;
      }
      mask[(img * T + c) * K + i] = word;
    }
    __syncthreads();  // sbox is restaged for the next image
  }
}

__global__ void __launch_bounds__(kSweepThreads)
nms_sweep_kernel(const float* __restrict__ scores,
                 const unsigned long long* __restrict__ mask,
                 bool* __restrict__ keep, int K, int T) {
  extern __shared__ unsigned long long removed[];  // T words
  __shared__ unsigned long long s_kept[2];
  __shared__ int s_last;
  const int64_t img = blockIdx.x;
  const float* b_scores = scores + img * K;
  const unsigned long long* M = mask + img * T * static_cast<int64_t>(K);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // the dead candidates start removed; the last chunk with a live one
  // bounds the sweep (a reduction, right for any order of the scores)
  if (threadIdx.x == 0) s_last = -1;
  __syncthreads();
  uint32_t* removed32 = reinterpret_cast<uint32_t*>(removed);
  for (int base = 0; base < T * kTile; base += kSweepThreads) {
    const int k = base + threadIdx.x;
    const unsigned live =
        __ballot_sync(kFull, k < K && b_scores[k] > -INFINITY);
    if (lane == 0 && k < T * kTile) {  // a warp's 32 are all in or out
      removed32[k >> 5] = ~live;
      if (live) atomicMax(&s_last, k >> 6);
    }
  }
  __syncthreads();
  const int chunks = s_last + 1;

  // chunk c's kept rows' words of a later chunk w, ORed over the warp:
  // lane l loads rows 64 c + l and 64 c + l + 32 where they are kept
  auto kept_words = [&](int c, unsigned long long kept, int w) {
    const unsigned long long* row =
        M + static_cast<int64_t>(w) * K + static_cast<int64_t>(c) * kTile;
    return (((kept >> lane) & 1ull) ? row[lane] : 0ull) |
           (((kept >> (lane + 32)) & 1ull) ? row[lane + 32] : 0ull);
  };
  auto warp_or = [](unsigned long long v) {
    const unsigned lo = __reduce_or_sync(kFull, static_cast<unsigned>(v));
    const unsigned hi =
        __reduce_or_sync(kFull, static_cast<unsigned>(v >> 32));
    return (static_cast<unsigned long long>(hi) << 32) | lo;
  };
  // warp 0 resolves the chunks in order and ORs each chunk's kept rows
  // into the next chunk's word; warps 1.. OR them into the words after
  // it. removed[c + 1] is final when warp 0 comes to it: the other
  // warps' ORs into it ended at the barrier of chunk c. One barrier a
  // chunk; s_kept is double-buffered across it.
  unsigned long long d0 = 0, d1 = 0;  // warp 0: rows 64 c + lane (+ 32)
  auto diagonal = [&](int c) {
    const int i0 = c * kTile + lane, i1 = i0 + 32;
    d0 = i0 < K ? M[static_cast<int64_t>(c) * K + i0] : 0ull;
    d1 = i1 < K ? M[static_cast<int64_t>(c) * K + i1] : 0ull;
  };
  if (warp == 0 && chunks > 0) diagonal(0);
  for (int c = 0; c < chunks; ++c) {
    if (warp == 0) {
      // the greedy keep set of the chunk is the one fixed point of
      // kept = alive & ~(OR of the kept rows' diagonal words): each row
      // clears only later ones, so the iteration settles one more
      // candidate each time at least, and in a few on real candidates
      const unsigned long long alive = ~removed[c];
      unsigned long long kept = alive, prev;
      do {
        prev = kept;
        kept = alive & ~warp_or((((kept >> lane) & 1ull) ? d0 : 0ull) |
                                (((kept >> (lane + 32)) & 1ull) ? d1 : 0ull));
      } while (kept != prev);
      if (lane == 0) {
        removed[c] = ~kept;
        s_kept[c & 1] = kept;
      }
      if (c + 1 < chunks) diagonal(c + 1);  // in flight across the barrier
    }
    __syncthreads();
    const unsigned long long kept = s_kept[c & 1];
    if (kept && warp == 0 && c + 1 < chunks) {
      const unsigned long long v = warp_or(kept_words(c, kept, c + 1));
      if (lane == 0) removed[c + 1] |= v;
      __syncwarp();  // the whole warp reads it next
    } else if (kept && warp > 0) {
      // up to four words a warp in flight at once
      for (int w0 = c + 1 + warp; w0 < chunks; w0 += 4 * (kSweepWarps - 1)) {
        unsigned long long v[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int w = w0 + u * (kSweepWarps - 1);
          v[u] = w < chunks && removed[w] != ~0ull ? kept_words(c, kept, w)
                                                    : 0ull;
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int w = w0 + u * (kSweepWarps - 1);
          const unsigned long long x = warp_or(v[u]);
          if (lane == 0 && w < chunks) removed[w] |= x;
        }
      }
    }
  }
  __syncthreads();
  // a kept candidate is the only one not removed
  for (int k = threadIdx.x; k < K; k += kSweepThreads)
    keep[img * K + k] = !((removed[k >> 6] >> (k & 63)) & 1ull);
}

}  // namespace

extern "C" {

// boxes (B, K, 4), scores (B, K), cls (B, K): float32, contiguous, sorted
// by score; mask: scratch of B * tiles * K 64-bit words; keep (B, K)
// bytes. tiles = ceil(K / 64), pairs = tiles (tiles + 1) / 2 and
// image_blocks = min(B, 65535), as ops/contrib.py nms_plan gives them
// (checked here). Two launches on `stream`; returns cudaGetLastError()
// after each (cudaErrorInvalidValue for a plan that does not match B and
// K).
int multibox_nms(const void* boxes, const void* scores, const void* cls,
                 void* mask, void* keep, int B, int K, int tiles,
                 long long pairs, int image_blocks, float thresh, int force,
                 void* stream) {
  if (B <= 0 || K <= 0 || tiles != (K + kTile - 1) / kTile ||
      pairs != static_cast<long long>(tiles) * (tiles + 1) / 2 ||
      image_blocks != (B < kMaxImageBlocks ? B : kMaxImageBlocks))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int aligned = (reinterpret_cast<uintptr_t>(boxes) & 15) == 0;
  nms_matrix_kernel<<<dim3(static_cast<unsigned>(pairs), image_blocks),
                      kTile, 0, s>>>(
      static_cast<const float*>(boxes), static_cast<const float*>(scores),
      static_cast<const float*>(cls),
      static_cast<unsigned long long*>(mask), B, K, tiles, thresh, force,
      aligned);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const size_t smem = sizeof(unsigned long long) * tiles;
  if (smem > 48 * 1024) {
    // K > 393,216: its matrix (K^2 / 8 bytes an image) is tens of GB
    e = cudaFuncSetAttribute(nms_sweep_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  nms_sweep_kernel<<<B, kSweepThreads, smem, s>>>(
      static_cast<const float*>(scores),
      static_cast<const unsigned long long*>(mask),
      static_cast<bool*>(keep), K, tiles);
  return cudaGetLastError();
}

const char* multibox_nms_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
