// BN-apply + ReLU (+ residual) epilogue for Hopper (sm_90a), CUDA C++.
//
// Replaces the Pallas TPU kernel mxtpu/ops/epilogue.py:_kernel (launched
// by bn_apply_relu_add). Same function: y = relu(x * scale[c] + shift[c]),
// then + residual when one is given (after the ReLU), computed in f32 and
// stored in y's type; scale and shift are f32. x and y are f32 or bf16,
// alike or not: a bf16 x with an f32 y, or an f32 x with a bf16 y, is the
// compile pipeline's bf16 rewrite around a BatchNorm (its f32 island) at
// a boundary of the bf16 region. The residual has y's type.
//
// What bounds it on this card: per element it does a multiply, an add, a
// compare (and an add) against 8 bytes moved in f32 (x read, y written) or
// 4 in bf16, well under one operation per byte where the H100 balances
// at ~20 f32 operations per byte. It is bound by HBM bytes: x (and the
// residual) read once, y written once.
//
// What the design does about that: every thread moves 16-byte vectors
// (4 f32 or 8 bf16; 8 elements, one bf16 vector and two f32 vectors, when
// the types differ) with adjacent threads on adjacent addresses, and no
// byte is read twice. The activation is taken as (outer, C, inner) with
// `inner` contiguous elements per channel, so channel-minor (M, C)
// (inner = 1) and NCHW (outer = N, inner = H*W) both run in place:
//   - inner == 1: a flat grid of vectors; each thread loads the scale and
//     shift of its vector's channels (C floats stay in L1/L2).
//   - inner > 1: each warp takes one chunk of one (n, c) plane and holds
//     that plane's scale and shift in registers. Planes go on blockIdx.x
//     (grid y stops at 65535, and (32, 2048, 7, 7) has 65536 planes);
//     a plane that does not start on a 16-byte boundary runs a scalar
//     head up to it, then vectors, then a scalar tail.
// Indices are 64-bit. Rounding is exact: __fmul_rn then __fadd_rn (nvcc
// would otherwise contract x*s+b into an FMA), ReLU as y < 0 ? 0 : y so NaN
// passes as it does through torch.relu, and __float2bfloat16_rn. The
// kernel therefore equals its plain PyTorch version bit for bit.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;           // threads per block
constexpr int kWarps = kThreads / 32;   // warps per block
constexpr int kChunkVecs = 4;           // 16-byte vectors per lane per chunk

union Pack {  // one 16-byte vector
  uint4 u;
  float f[4];
  unsigned short h[8];
};

template <typename T>
struct Elem;

template <>
struct Elem<float> {
  static constexpr int kVec = 4;  // elements in one 16-byte vector
  __device__ static float load(const float* p) { return __ldg(p); }
  __device__ static void store(float* p, float v) { *p = v; }
  __device__ static float get(const Pack& k, int j) { return k.f[j]; }
  __device__ static void put(Pack& k, int j, float v) { k.f[j] = v; }
};

template <>
struct Elem<__nv_bfloat16> {
  static constexpr int kVec = 8;
  __device__ static float load(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  __device__ static void store(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16_rn(v);
  }
  __device__ static float get(const Pack& k, int j) {
    return __bfloat162float(__ushort_as_bfloat16(k.h[j]));
  }
  __device__ static void put(Pack& k, int j, float v) {
    k.h[j] = __bfloat16_as_ushort(__float2bfloat16_rn(v));
  }
};

// Elements a thread moves per vector step: the larger of the two types'
// 16-byte vectors (the smaller type then moves several vectors).
template <typename TI, typename TO>
struct Step {
  static constexpr int kVec =
      Elem<TI>::kVec > Elem<TO>::kVec ? Elem<TI>::kVec : Elem<TO>::kVec;
};

// kN elements from a 16-byte aligned p into v, as f32.
template <typename T, int kN>
__device__ __forceinline__ void vload(const T* p, float* v) {
  constexpr int kV = Elem<T>::kVec;
#pragma unroll
  for (int k = 0; k < kN / kV; ++k) {
    Pack pk;
    pk.u = __ldg(reinterpret_cast<const uint4*>(p) + k);
#pragma unroll
    for (int j = 0; j < kV; ++j) v[k * kV + j] = Elem<T>::get(pk, j);
  }
}

// kN f32 values of v to a 16-byte aligned p in T.
template <typename T, int kN>
__device__ __forceinline__ void vstore(T* p, const float* v) {
  constexpr int kV = Elem<T>::kVec;
#pragma unroll
  for (int k = 0; k < kN / kV; ++k) {
    Pack pk;
#pragma unroll
    for (int j = 0; j < kV; ++j) Elem<T>::put(pk, j, v[k * kV + j]);
    reinterpret_cast<uint4*>(p)[k] = pk.u;
  }
}

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) {
  return a < b ? a : b;
}

__device__ __forceinline__ float bn_relu(float x, float s, float b) {
  const float y = __fadd_rn(__fmul_rn(x, s), b);
  return y < 0.0f ? 0.0f : y;
}

template <typename TI, typename TO, bool kRes>
__device__ __forceinline__ void scalar_at(const TI* x, const TO* r, TO* y,
                                          int64_t i, float s, float b) {
  float v = bn_relu(Elem<TI>::load(x + i), s, b);
  if (kRes) v = __fadd_rn(v, Elem<TO>::load(r + i));
  Elem<TO>::store(y + i, v);
}

// i must be a multiple of Step<TI, TO>::kVec and the three base pointers
// 16-byte aligned.
template <typename TI, typename TO, bool kRes>
__device__ __forceinline__ void vector_at(const TI* x, const TO* r, TO* y,
                                          int64_t i, const float* s,
                                          const float* b) {
  constexpr int kVec = Step<TI, TO>::kVec;
  float xv[kVec], rv[kVec];
  vload<TI, kVec>(x + i, xv);
  if (kRes) vload<TO, kVec>(r + i, rv);
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    xv[j] = bn_relu(xv[j], s[j], b[j]);
    if (kRes) xv[j] = __fadd_rn(xv[j], rv[j]);
  }
  vstore<TO, kVec>(y + i, xv);
}

// inner == 1: x is (outer, C) flat, element i has channel i % C. One
// vector per thread (vec), or one element per thread (unaligned pointers).
template <typename TI, typename TO, bool kRes>
__global__ void __launch_bounds__(kThreads)
    rows_kernel(const TI* __restrict__ x, const float* __restrict__ scale,
                const float* __restrict__ shift, const TO* __restrict__ r,
                TO* __restrict__ y, int64_t n, int64_t channels, int vec) {
  constexpr int kVec = Step<TI, TO>::kVec;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (!vec) {
    if (t < n) {
      const int64_t c = t % channels;
      scalar_at<TI, TO, kRes>(x, r, y, t, __ldg(scale + c), __ldg(shift + c));
    }
    return;
  }
  int64_t i = t * kVec;
  if (i + kVec <= n) {
    float s[kVec], b[kVec];
    int64_t c = i % channels;
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      s[j] = __ldg(scale + c);
      b[j] = __ldg(shift + c);
      if (++c == channels) c = 0;
    }
    vector_at<TI, TO, kRes>(x, r, y, i, s, b);
  } else {
    for (; i < n; ++i) {  // the last thread: the n % kVec tail
      const int64_t c = i % channels;
      scalar_at<TI, TO, kRes>(x, r, y, i, __ldg(scale + c), __ldg(shift + c));
    }
  }
}

// inner > 1: plane p = o * C + c holds `inner` contiguous elements of
// channel c. Warp w of the grid takes chunk (w % chunks) of plane
// (w / chunks); a chunk is 32 lanes x kChunkVecs vector steps.
template <typename TI, typename TO, bool kRes>
__global__ void __launch_bounds__(kThreads)
    planes_kernel(const TI* __restrict__ x, const float* __restrict__ scale,
                  const float* __restrict__ shift, const TO* __restrict__ r,
                  TO* __restrict__ y, int64_t planes, int64_t channels,
                  int64_t inner, int64_t chunks, int vec) {
  constexpr int kVec = Step<TI, TO>::kVec;
  constexpr int64_t kChunk = 32 * kVec * kChunkVecs;
  const int lane = threadIdx.x & 31;
  const int64_t unit =
      static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (unit >= planes * chunks) return;
  const int64_t p = unit / chunks;
  const int64_t k = unit - p * chunks;
  const int64_t c = p % channels;
  const float s = __ldg(scale + c);
  const float b = __ldg(shift + c);
  const int64_t lo = p * inner + k * kChunk;
  const int64_t hi = p * inner + min64(inner, (k + 1) * kChunk);
  if (!vec) {
    for (int64_t i = lo + lane; i < hi; i += 32)
      scalar_at<TI, TO, kRes>(x, r, y, i, s, b);
    return;
  }
  // the head runs element by element up to a multiple of kVec; a head of
  // more than 32 elements (kVec > 32 never holds) would need a loop
  const int64_t head = min64((kVec - lo % kVec) % kVec, hi - lo);
  if (lane < head) scalar_at<TI, TO, kRes>(x, r, y, lo + lane, s, b);
  const int64_t v0 = lo + head;
  const int64_t nvec = (hi - v0) / kVec;
  float sv[kVec], bv[kVec];
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    sv[j] = s;
    bv[j] = b;
  }
#pragma unroll 4
  for (int64_t j = lane; j < nvec; j += 32)
    vector_at<TI, TO, kRes>(x, r, y, v0 + j * kVec, sv, bv);
  const int64_t tail = v0 + nvec * kVec;
  // the tail is under kVec <= 8 elements: one lane each
  if (tail + lane < hi) scalar_at<TI, TO, kRes>(x, r, y, tail + lane, s, b);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <typename TI, typename TO>
cudaError_t launch(const void* x, const void* scale, const void* shift,
                   const void* r, void* y, int64_t outer, int64_t channels,
                   int64_t inner, cudaStream_t st) {
  constexpr int kVec = Step<TI, TO>::kVec;
  const int64_t n = outer * channels * inner;
  if (n == 0) return cudaSuccess;
  const int vec = aligned16(x) && aligned16(y) && (!r || aligned16(r));
  const TI* xp = static_cast<const TI*>(x);
  const TO* rp = static_cast<const TO*>(r);
  TO* yp = static_cast<TO*>(y);
  const float* sp = static_cast<const float*>(scale);
  const float* bp = static_cast<const float*>(shift);
  int64_t blocks;
  if (inner == 1) {
    const int64_t threads = vec ? (n + kVec - 1) / kVec : n;
    blocks = (threads + kThreads - 1) / kThreads;
    if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
    if (r)
      rows_kernel<TI, TO, true>
          <<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
              xp, sp, bp, rp, yp, n, channels, vec);
    else
      rows_kernel<TI, TO, false>
          <<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
              xp, sp, bp, rp, yp, n, channels, vec);
  } else {
    constexpr int64_t kChunk = 32 * kVec * kChunkVecs;
    const int64_t planes = outer * channels;
    const int64_t chunks = (inner + kChunk - 1) / kChunk;
    blocks = (planes * chunks + kWarps - 1) / kWarps;
    if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
    if (r)
      planes_kernel<TI, TO, true>
          <<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
              xp, sp, bp, rp, yp, planes, channels, inner, chunks, vec);
    else
      planes_kernel<TI, TO, false>
          <<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
              xp, sp, bp, rp, yp, planes, channels, inner, chunks, vec);
  }
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, residual and y alike), 2 = a
// bfloat16 x with a float32 y (and residual), 3 = a float32 x with a
// bfloat16 y (and residual); scale and shift are float32 (channels,);
// residual may be null. Launches on `stream` and returns the launch's
// cudaError_t (0 on success).
extern "C" int bn_relu_epilogue(const void* x, const void* scale,
                                const void* shift, const void* residual,
                                void* y, long long outer, long long channels,
                                long long inner, int dtype, void* stream) {
  if (outer < 0 || channels < 0 || inner < 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  typedef __nv_bfloat16 bf16;
  if (dtype == 0)
    return launch<float, float>(x, scale, shift, residual, y, outer,
                                channels, inner, st);
  if (dtype == 1)
    return launch<bf16, bf16>(x, scale, shift, residual, y, outer, channels,
                              inner, st);
  if (dtype == 2)
    return launch<bf16, float>(x, scale, shift, residual, y, outer,
                               channels, inner, st);
  if (dtype == 3)
    return launch<float, bf16>(x, scale, shift, residual, y, outer,
                               channels, inner, st);
  return cudaErrorInvalidValue;
}

extern "C" const char* bn_relu_epilogue_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
