// Shared device code of the flash-attention kernels that run on the
// float32 CUDA cores: the float32 kernels of K1 (flash_fwd.cu), K2
// (flash_dq.cu) and K3 (flash_dkv.cu), which replace
// tpudp/ops/flash_attention.py's _fwd_kernel, _dq_kernel and _dkv_kernel.
// It holds the strided (b, t, h, dh) view every flash kernel takes, the
// tile geometry, shared-memory tile loads and the two register-blocked
// tile products those kernels are built from.  The bf16 kernels of K1,
// K2 and K3 run on the tensor cores instead (flash_sm90.cuh).
//
// Bound on this card: operations, as for every flash kernel (4 to 8 dh
// flops per visible (query, key) pair against a few bytes per row), but
// here against the 67 TFLOP/s float32 rate, and in practice against
// shared-memory bandwidth: each 4 x 4 register-block step reads 8 floats
// of shared memory for 16 FMAs.  float32 keeps these kernels because
// their checks hold o to 2e-5 and the gradients to 1e-4, which TF32
// tensor cores would not meet.
//
// Geometry: a block of kThreads = 256 threads works on 64-row tiles.  The
// threads form a 16 x 16 grid (ty, tx); thread (ty, tx) owns rows
// ty + 16 i and columns tx + 16 j (i, j < 4) of a 64 x 64 score tile, and
// rows ty + 16 i, head dims tx + 16 j (j < D / 16) of a 64 x D output
// tile.  The 16 threads sharing a row are the lanes of one half warp, so
// a row reduction is four xor shuffles.  Tiles live in shared memory as
// float32 with a pitch of D + 1 (score tiles kTile + 1): the 16 rows a
// half warp reads at one column fall in 16 different banks.
//
// The kernels run whatever t the public API admits: rows at or past t
// load as zeros, get no weight and are never stored.
#pragma once

#include "common.cuh"

namespace tpudp {

constexpr int kTile = 64;      // query rows / key rows per tile
constexpr int kThreads = 256;  // 16 x 16 threads
constexpr int kSub = 4;        // kTile / 16 rows (and score columns) per thread
constexpr int kScorePitch = kTile + 1;

// A (b, t, h, dh) tensor read or written through its element strides of
// batch, token and head; the head dim is contiguous and every row starts
// on a 16-byte boundary (the wrapper checks both).
template <typename T>
struct Bthd {
  T* p;
  long long sb, st, sh;
  __device__ __forceinline__ T* slice(int b, int h) const {
    return p + b * sb + h * sh;
  }
};

// The view of tensor `i` of a launch: strides[3 i .. 3 i + 2] are its
// batch, token and head strides.
template <typename T>
Bthd<T> make_view(const void* p, const long long* strides, int i) {
  return {reinterpret_cast<T*>(const_cast<void*>(p)), strides[3 * i],
          strides[3 * i + 1], strides[3 * i + 2]};
}

// Rows [row0, row0 + kTile) of one (batch, head) slice into a (kTile,
// D + 1) float tile, each value times `mul`; rows at or past t are 0.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          long long row_stride, int row0,
                                          int t, float mul) {
  constexpr int N = Vec16<T>::N;
  constexpr int kChunks = D / N;  // 16-byte loads per row
  for (int c = threadIdx.x; c < kTile * kChunks; c += kThreads) {
    const int r = c / kChunks;
    const int d = (c % kChunks) * N;
    float x[N];
    if (row0 + r < t) {
      Vec16<T>::load(src + (long long)(row0 + r) * row_stride + d, x);
    } else {
#pragma unroll
      for (int e = 0; e < N; ++e) x[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < N; ++e) dst[r * (D + 1) + d + e] = x[e] * mul;
  }
}

// s[i][j] = row (ty + 16 i) of `a` . row (tx + 16 j) of `b`, both (kTile,
// D + 1) tiles: one 64 x 64 tile of dot products over the head dim.
template <int D>
__device__ __forceinline__ void tile_dots(float (&s)[kSub][kSub],
                                          const float* a, const float* b,
                                          int ty, int tx) {
#pragma unroll
  for (int i = 0; i < kSub; ++i)
#pragma unroll
    for (int j = 0; j < kSub; ++j) s[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float av[kSub], bv[kSub];
#pragma unroll
    for (int i = 0; i < kSub; ++i) av[i] = a[(ty + 16 * i) * (D + 1) + d];
#pragma unroll
    for (int j = 0; j < kSub; ++j) bv[j] = b[(tx + 16 * j) * (D + 1) + d];
#pragma unroll
    for (int i = 0; i < kSub; ++i)
#pragma unroll
      for (int j = 0; j < kSub; ++j) s[i][j] += av[i] * bv[j];
  }
}

// acc[i][j] += sum over c < kTile of w[ty + 16 i][c] * x[c][tx + 16 j]:
// a (kTile, kScorePitch) weight tile times a (kTile, D + 1) value tile,
// accumulated into the thread's rows of a 64 x D output.
template <int D>
__device__ __forceinline__ void tile_matmul_acc(float (&acc)[kSub][D / 16],
                                                const float* w,
                                                const float* x, int ty,
                                                int tx) {
#pragma unroll 4
  for (int c = 0; c < kTile; ++c) {
    float wv[kSub];
#pragma unroll
    for (int i = 0; i < kSub; ++i) wv[i] = w[(ty + 16 * i) * kScorePitch + c];
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      const float xv = x[c * (D + 1) + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < kSub; ++i) acc[i][j] += wv[i] * xv;
    }
  }
}

// Row (ty + 16 i) of a 64 x D output tile, times `mul`, into rows
// [row0, row0 + kTile) of one (batch, head) slice; rows past t are not
// written.
template <typename T, int D>
__device__ __forceinline__ void store_tile(T* dst, long long row_stride,
                                           int row0, int t,
                                           const float (&acc)[kSub][D / 16],
                                           int ty, int tx, float mul) {
#pragma unroll
  for (int i = 0; i < kSub; ++i) {
    const int r = row0 + ty + 16 * i;
    if (r >= t) continue;
    T* out = dst + (long long)r * row_stride;
#pragma unroll
    for (int j = 0; j < D / 16; ++j) store_f32(out + tx + 16 * j, acc[i][j] * mul);
  }
}

// Max and sum over the 16 threads of a half warp (the threads of one row).
__device__ __forceinline__ float row_max16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFullMask, x, o));
  return x;
}

__device__ __forceinline__ float row_sum16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(kFullMask, x, o);
  return x;
}

// Whether query row qi sees key kj.
__device__ __forceinline__ bool visible(int qi, int kj, int t, int causal) {
  return qi < t && kj < t && (!causal || kj <= qi);
}

// Opt the kernel into `bytes` of dynamic shared memory (above 48 KB) and
// launch it on a (query or key tiles, heads, batch) grid.
template <typename Kernel, typename... Args>
cudaError_t launch_tiles(Kernel kernel, size_t bytes, int t, int heads,
                         int batch, cudaStream_t stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((t + kTile - 1) / kTile, heads, batch);
  kernel<<<grid, kThreads, bytes, stream>>>(args...);
  return cudaGetLastError();
}

}  // namespace tpudp
