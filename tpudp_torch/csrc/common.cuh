// Device helpers shared by every kernel of the port: element loads and
// stores widened to float32 (int8 page payloads load the same way), warp
// reductions, the masking sentinel of the TPU kernels, the opt-in to
// more than 48 KB of dynamic shared memory, the error-string export every
// library carries, and the (element type, head dim) dispatch of the
// launch functions.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

namespace tpudp {

constexpr float kNegInf = -1e30f;  // the masking sentinel of the TPU kernels
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(int8_t x) {
  return static_cast<float>(x);
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

template <>
struct Vec16<int8_t> {
  static constexpr int N = 16;
  __device__ __forceinline__ static void load(const int8_t* p, float* o) {
    const int4 raw = *reinterpret_cast<const int4*>(p);
    const int8_t* b = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
    for (int i = 0; i < 16; ++i) o[i] = static_cast<float>(b[i]);
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

// Opt Kernel into `bytes` of dynamic shared memory where that is over the
// 48 KB default: once a device (the attribute holds for the device's
// context, and Kernel's bytes never change), not on every launch.
template <auto Kernel>
cudaError_t allow_smem(size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  static std::atomic<unsigned long long> done{0};  // a bit a device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = 1ull << (dev % 64);
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(
      Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return err;
}

}  // namespace tpudp

// Message for a launch's return code (a cudaError_t).
extern "C" const char* tpudp_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Expands BODY once for the head dim `dh` (32, 64 or 128), with `kDH`
// bound; returns cudaErrorInvalidValue for any other.
#define TPUDP_HEAD_DIM(dh, ...)                                           \
  do {                                                                    \
    if ((dh) == 32) { constexpr int kDH = 32; __VA_ARGS__; }              \
    else if ((dh) == 64) { constexpr int kDH = 64; __VA_ARGS__; }         \
    else if ((dh) == 128) { constexpr int kDH = 128; __VA_ARGS__; }       \
    else return cudaErrorInvalidValue;                                    \
  } while (0)

// Expands BODY once for each supported (element type, head dim) pair,
// with `scalar_t` and `kDH` bound; returns cudaErrorInvalidValue for any
// other pair.  dtype_code: 0 = float32, 1 = bfloat16.
#define TPUDP_DISPATCH(dtype_code, dh, ...)                               \
  do {                                                                    \
    if ((dtype_code) == 0) {                                              \
      using scalar_t = float;                                             \
      TPUDP_HEAD_DIM(dh, __VA_ARGS__);                                    \
    } else if ((dtype_code) == 1) {                                       \
      using scalar_t = __nv_bfloat16;                                     \
      TPUDP_HEAD_DIM(dh, __VA_ARGS__);                                    \
    } else {                                                              \
      return cudaErrorInvalidValue;                                       \
    }                                                                     \
  } while (0)
