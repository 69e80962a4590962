// Shared device code of the paged-attention kernels (paged_decode.cu,
// paged_window.cu): loads, warp reductions and the one online-softmax
// loop that folds a query row's visible keys, read through the block
// table, into a running max / denominator / accumulator.
//
// Layouts (all element strides, the last dimension contiguous):
//   pages  one layer of the pool, (P+1, T, kv, dh); the trailing page is
//          the write scratch and is never read here
//   table  (b, M) int32, -1 for an unmapped entry
// Query row j of slot s sees keys k_pos <= pos[s] + j.  Keys past the
// visibility edge and keys on unmapped pages get no weight at all, as in
// the TPU kernels (which mask them to -1e30 or skip the page).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace tpudp {

constexpr float kNegInf = -1e30f;  // the masking sentinel of the TPU kernels
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// One 16-byte load of consecutive elements, widened to float.
template <typename T>
struct Vec16;

template <>
struct Vec16<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void load(const float* p, float* o) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    o[0] = v.x;
    o[1] = v.y;
    o[2] = v.z;
    o[3] = v.w;
  }
};

template <>
struct Vec16<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* p,
                                              float* o) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h2[i]);
      o[2 * i] = f.x;
      o[2 * i + 1] = f.y;
    }
  }
};

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFullMask, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFullMask, x, o);
  return x;
}

// Where the K/V of one layer live: base pointers (already offset to the
// layer in whole-pool mode) and element strides of page, token and head.
template <typename T>
struct PageView {
  const T* k;
  const T* v;
  long long page_stride;
  long long tok_stride;
  long long head_stride;
};

// One warp folds keys [first, limit] of one query row into (m, l, acc).
// Keys come in tiles of 32, one key per lane: lane i scores key base+i
// against the pre-scaled query q_s (shared memory, read as a broadcast),
// the tile updates the online softmax once, and the P.V product is
// accumulated with lane i owning output dims i, i+32, ...  Tiles start at
// `first` and step by `step` keys, so several warps can split one row's
// keys.  Runs in float32 whatever T is.
template <typename T, int DH>
__device__ __forceinline__ void fold_keys(const float* q_s,
                                          const PageView<T>& pv,
                                          const int* trow, int page_tokens,
                                          int kv_head, int first, int step,
                                          int limit, float& m, float& l,
                                          float (&acc)[DH / 32]) {
  const int lane = threadIdx.x & 31;
  const long long head_off = kv_head * pv.head_stride;
  for (int base = first; base <= limit; base += step) {
    const int key = base + lane;
    const int page = key <= limit ? trow[key / page_tokens] : -1;
    float s = kNegInf;
    if (page >= 0) {
      const T* kr = pv.k + page * pv.page_stride +
                    (long long)(key % page_tokens) * pv.tok_stride + head_off;
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < DH; d += Vec16<T>::N) {
        float kx[Vec16<T>::N];
        Vec16<T>::load(kr + d, kx);
#pragma unroll
        for (int e = 0; e < Vec16<T>::N; ++e) dot += q_s[d + e] * kx[e];
      }
      s = dot;
    }
    const float tile_max = warp_max(s);
    if (tile_max <= kNegInf) continue;  // no visible mapped key in the tile
    const float m_new = fmaxf(m, tile_max);
    const float alpha = expf(m - m_new);
    const float p = page >= 0 ? expf(s - m_new) : 0.f;
    l = l * alpha + warp_sum(p);
#pragma unroll
    for (int i = 0; i < DH / 32; ++i) acc[i] *= alpha;
    for (int t = 0; t < 32; ++t) {
      const int pg = __shfl_sync(kFullMask, page, t);
      const float pt = __shfl_sync(kFullMask, p, t);
      if (pg < 0) continue;  // warp-uniform: the broadcast value
      const T* vr = pv.v + pg * pv.page_stride +
                    (long long)((base + t) % page_tokens) * pv.tok_stride +
                    head_off;
#pragma unroll
      for (int i = 0; i < DH / 32; ++i) acc[i] += pt * to_f32(vr[lane + 32 * i]);
    }
    m = m_new;
  }
}

}  // namespace tpudp

// Message for a launch's return code (a cudaError_t).
extern "C" const char* tpudp_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Expands BODY once for each supported (element type, head dim) pair,
// with `scalar_t` and `kDH` bound; returns cudaErrorInvalidValue for any
// other pair.  dtype_code: 0 = float32, 1 = bfloat16.
#define TPUDP_DISPATCH(dtype_code, dh, ...)                               \
  do {                                                                    \
    if ((dtype_code) == 0) {                                              \
      using scalar_t = float;                                             \
      if ((dh) == 32) { constexpr int kDH = 32; __VA_ARGS__; }            \
      else if ((dh) == 64) { constexpr int kDH = 64; __VA_ARGS__; }       \
      else if ((dh) == 128) { constexpr int kDH = 128; __VA_ARGS__; }     \
      else return cudaErrorInvalidValue;                                  \
    } else if ((dtype_code) == 1) {                                       \
      using scalar_t = __nv_bfloat16;                                     \
      if ((dh) == 32) { constexpr int kDH = 32; __VA_ARGS__; }            \
      else if ((dh) == 64) { constexpr int kDH = 64; __VA_ARGS__; }       \
      else if ((dh) == 128) { constexpr int kDH = 128; __VA_ARGS__; }     \
      else return cudaErrorInvalidValue;                                  \
    } else {                                                              \
      return cudaErrorInvalidValue;                                       \
    }                                                                     \
  } while (0)
