// Flash-attention forward for Hopper (sm_90a): o = softmax(q k^T * scale)
// v over (b, t, h, dh) q, k, v, causal or not, plus the per-row
// log-sum-exp lse = m + log(l) that the backward kernels recompute the
// probabilities from.
//
// Replaces tpudp/ops/flash_attention.py:_fwd_kernel (launched by
// _flash_fwd_impl).  On the TPU the grid is (b * h, q blocks, k blocks)
// and the online-softmax carry (running max m, denominator l,
// accumulator) sits in VMEM scratch across the sequential k-block axis.
// Hopper runs blocks in no order, so block (q tile, head, batch) owns 64
// query rows and walks the K/V tiles itself: up to the diagonal tile when
// causal, all of them otherwise.  Each K/V tile is staged in shared
// memory (float32); m, l and the accumulator stay in registers.  Masked
// scores get no weight (the TPU kernel's -1e30), l is clamped at 1e-30
// before the division, and q is scaled once as it is staged.  q, k and v
// are read through their strides, so the views of the qkv projection the
// model passes are never transposed or copied.  Query tiles are issued
// longest-first (the last causal tile walks the most keys).
//
// Bound on this card: operations.  Causal GPT-2 small at t = 2048 does
// 4 * dh flops per visible (query, key) pair, 25.8 GFLOP per call at
// b = 4, h = 12: 0.026 ms at 989 TFLOP/s bf16, against 0.015 ms for
// reading q, k, v and writing o and lse once at 3.35 TB/s.  This first
// version multiplies on the float32 CUDA cores out of shared memory
// (register-blocked 4 x 4 per thread), so it is bounded by the 67 TFLOP/s
// float32 rate and by shared-memory bandwidth, well above the tensor-core
// bound; mma/wgmma tiles fed by TMA are later work.
#include "flash_common.cuh"

namespace tpudp {

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(Bthd<const T> q, Bthd<const T> k, Bthd<const T> v,
                     Bthd<T> o, float* __restrict__ lse, int t, int heads,
                     int causal, float scale) {
  extern __shared__ float smem[];
  float* q_s = smem;                    // (kTile, D + 1), pre-scaled
  float* k_s = q_s + kTile * (D + 1);   // (kTile, D + 1)
  float* v_s = k_s + kTile * (D + 1);   // (kTile, D + 1)
  float* p_s = v_s + kTile * (D + 1);   // (kTile, kScorePitch)
  const int n_tiles = gridDim.x;
  const int qt = n_tiles - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
  const int q0 = qt * kTile;

  load_tile<T, D>(q_s, q.slice(b, h), q.st, q0, t, scale);
  float m[kSub], l[kSub], acc[kSub][D / 16];
#pragma unroll
  for (int i = 0; i < kSub; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < D / 16; ++j) acc[i][j] = 0.f;
  }

  const int k_tiles = causal ? qt + 1 : n_tiles;
  for (int kt = 0; kt < k_tiles; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // every reader of the previous K/V and P tiles is done
    load_tile<T, D>(k_s, k.slice(b, h), k.st, k0, t, 1.f);
    load_tile<T, D>(v_s, v.slice(b, h), v.st, k0, t, 1.f);
    __syncthreads();
    float s[kSub][kSub];
    tile_dots<D>(s, q_s, k_s, ty, tx);
#pragma unroll
    for (int i = 0; i < kSub; ++i) {
      const int qi = q0 + ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kSub; ++j)
        if (visible(qi, k0 + tx + 16 * j, t, causal)) mx = fmaxf(mx, s[i][j]);
      const float m_new = fmaxf(m[i], row_max16(mx));
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kSub; ++j) {
        const float p = visible(qi, k0 + tx + 16 * j, t, causal)
                            ? expf(s[i][j] - m_new)
                            : 0.f;
        p_s[(ty + 16 * i) * kScorePitch + tx + 16 * j] = p;
        sum += p;
      }
      l[i] = l[i] * alpha + row_sum16(sum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < D / 16; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();
    tile_matmul_acc<D>(acc, p_s, v_s, ty, tx);
  }

  T* o_bh = o.slice(b, h);
  float* lse_bh = lse + ((long long)b * heads + h) * t;
#pragma unroll
  for (int i = 0; i < kSub; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= t) continue;
    const float l_safe = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < D / 16; ++j)
      store_f32(o_bh + (long long)r * o.st + tx + 16 * j, acc[i][j] / l_safe);
    if (tx == 0) lse_bh[r] = m[i] + logf(l_safe);
  }
}

}  // namespace tpudp

// q, k, v: (b, t, h, dh) read through strides; o: (b, t, h, dh) written
// through strides; lse: contiguous (b, h, t) float32.  strides holds the
// (batch, token, head) element strides of q, k, v, o in that order.
extern "C" int launch_flash_fwd(const void* q, const void* k, const void* v,
                                void* o, float* lse, const long long* strides,
                                int dtype_code, int batch, int t, int heads,
                                int head_dim, int causal, float scale,
                                cudaStream_t stream) {
  if (batch < 1 || t < 1 || heads < 1) return cudaErrorInvalidValue;
  TPUDP_DISPATCH(dtype_code, head_dim, {
    using tpudp::kTile;
    const size_t bytes =
        (3 * kTile * (kDH + 1) + kTile * tpudp::kScorePitch) * sizeof(float);
    return static_cast<int>(tpudp::launch_tiles(
        tpudp::flash_fwd_kernel<scalar_t, kDH>, bytes, t, heads, batch,
        stream, tpudp::make_view<const scalar_t>(q, strides, 0),
        tpudp::make_view<const scalar_t>(k, strides, 1),
        tpudp::make_view<const scalar_t>(v, strides, 2),
        tpudp::make_view<scalar_t>(o, strides, 3), lse, t, heads, causal,
        scale));
  });
}
