// Flash-attention backward, query side, for Hopper (sm_90a):
// dq = scale * sum_k ds k, with p = exp(q k^T * scale - lse) recomputed
// from the forward's log-sum-exp, dp = do v^T and ds = p (dp - delta),
// delta = rowsum(do o) computed beforehand by the caller.
//
// Replaces tpudp/ops/flash_attention.py:_dq_kernel (launched by
// _flash_bwd_impl).  On the TPU the grid is (b * h, q blocks, k blocks)
// with the dq accumulator in VMEM across the sequential k-block axis.
// Here block (q tile, head, batch) stages its 64 rows of q (pre-scaled)
// and do once, walks the K/V tiles up to the diagonal when causal, and
// keeps dq in registers; ds passes through shared memory on its way into
// the ds k product.  dq is scaled once, at the store, as the TPU kernel
// does; splitting dq from dk/dv (flash_dkv.cu) is what keeps both
// kernels free of atomics.
//
// Bound on this card: operations.  Causal GPT-2 small at t = 2048 does
// 6 * dh flops per visible (query, key) pair (s, dp and ds k), 38.7 GFLOP
// per call at b = 4, h = 12: 0.039 ms at 989 TFLOP/s bf16, against
// 0.019 ms of bytes (q, k, v, do, lse, delta read once, dq written once).
// Like the forward, this first version runs on the float32 CUDA cores out
// of shared memory; tensor-core tiles are later work.
#include "flash_common.cuh"

namespace tpudp {

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_dq_kernel(Bthd<const T> q, Bthd<const T> k, Bthd<const T> v,
                    Bthd<const T> dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, Bthd<T> dq, int t,
                    int heads, int causal, float scale) {
  extern __shared__ float smem[];
  float* q_s = smem;                     // (kTile, D + 1), pre-scaled
  float* do_s = q_s + kTile * (D + 1);   // (kTile, D + 1)
  float* k_s = do_s + kTile * (D + 1);   // (kTile, D + 1)
  float* v_s = k_s + kTile * (D + 1);    // (kTile, D + 1)
  float* ds_s = v_s + kTile * (D + 1);   // (kTile, kScorePitch)
  const int n_tiles = gridDim.x;
  const int qt = n_tiles - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
  const int q0 = qt * kTile;

  load_tile<T, D>(q_s, q.slice(b, h), q.st, q0, t, scale);
  load_tile<T, D>(do_s, dout.slice(b, h), dout.st, q0, t, 1.f);
  const long long bh = ((long long)b * heads + h) * t;
  float lse_r[kSub], delta_r[kSub], acc[kSub][D / 16];
#pragma unroll
  for (int i = 0; i < kSub; ++i) {
    const int r = q0 + ty + 16 * i;
    lse_r[i] = r < t ? lse[bh + r] : 0.f;
    delta_r[i] = r < t ? delta[bh + r] : 0.f;
#pragma unroll
    for (int j = 0; j < D / 16; ++j) acc[i][j] = 0.f;
  }

  const int k_tiles = causal ? qt + 1 : n_tiles;
  for (int kt = 0; kt < k_tiles; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // every reader of the previous K/V and ds tiles is done
    load_tile<T, D>(k_s, k.slice(b, h), k.st, k0, t, 1.f);
    load_tile<T, D>(v_s, v.slice(b, h), v.st, k0, t, 1.f);
    __syncthreads();
    float s[kSub][kSub], dp[kSub][kSub];
    tile_dots<D>(s, q_s, k_s, ty, tx);
    tile_dots<D>(dp, do_s, v_s, ty, tx);
#pragma unroll
    for (int i = 0; i < kSub; ++i) {
      const int qi = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < kSub; ++j) {
        const float p = visible(qi, k0 + tx + 16 * j, t, causal)
                            ? expf(s[i][j] - lse_r[i])
                            : 0.f;
        ds_s[(ty + 16 * i) * kScorePitch + tx + 16 * j] =
            p * (dp[i][j] - delta_r[i]);
      }
    }
    __syncthreads();
    tile_matmul_acc<D>(acc, ds_s, k_s, ty, tx);
  }
  store_tile<T, D>(dq.slice(b, h), dq.st, q0, t, acc, ty, tx, scale);
}

}  // namespace tpudp

// q, k, v, do: (b, t, h, dh) read through strides; lse, delta: contiguous
// (b, h, t) float32; dq: (b, t, h, dh) written through strides.  strides
// holds the (batch, token, head) element strides of q, k, v, do, dq.
extern "C" int launch_flash_dq(const void* q, const void* k, const void* v,
                               const void* dout, const float* lse,
                               const float* delta, void* dq,
                               const long long* strides, int dtype_code,
                               int batch, int t, int heads, int head_dim,
                               int causal, float scale, cudaStream_t stream) {
  if (batch < 1 || t < 1 || heads < 1) return cudaErrorInvalidValue;
  TPUDP_DISPATCH(dtype_code, head_dim, {
    using tpudp::kTile;
    const size_t bytes =
        (4 * kTile * (kDH + 1) + kTile * tpudp::kScorePitch) * sizeof(float);
    return static_cast<int>(tpudp::launch_tiles(
        tpudp::flash_dq_kernel<scalar_t, kDH>, bytes, t, heads, batch,
        stream, tpudp::make_view<const scalar_t>(q, strides, 0),
        tpudp::make_view<const scalar_t>(k, strides, 1),
        tpudp::make_view<const scalar_t>(v, strides, 2),
        tpudp::make_view<const scalar_t>(dout, strides, 3), lse, delta,
        tpudp::make_view<scalar_t>(dq, strides, 4), t, heads, causal,
        scale));
  });
}
