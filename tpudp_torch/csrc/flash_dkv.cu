// Flash-attention backward, key side, for Hopper (sm_90a):
// dv = sum_q p^T do and dk = sum_q ds^T (q * scale), with
// p = exp(q k^T * scale - lse) recomputed from the forward's log-sum-exp,
// dp = do v^T, ds = p (dp - delta) and delta = rowsum(do o) computed
// beforehand by the caller.
//
// Replaces tpudp/ops/flash_attention.py:_dkv_kernel (launched by
// _flash_bwd_impl).  On the TPU the grid is (b * h, k blocks, q blocks)
// with the dk/dv accumulators in VMEM across the sequential q-block
// axis.  Here block (k tile, head, batch) stages its 64 rows of k and v
// once and walks the query tiles from the diagonal on when causal (all of
// them otherwise), staging q (pre-scaled), do, lse and delta per tile;
// dk and dv stay in registers.  The thread grid computes the transposed
// score tile directly (key rows, query columns), so p^T and ds^T land in
// shared memory ready for the two products.  The scale is folded into q,
// so dk needs no scaling of its own.  Key tiles go out in natural order:
// the first ones walk the most query tiles.
//
// Bound on this card: operations.  Causal GPT-2 small at t = 2048 does
// 8 * dh flops per visible (query, key) pair (s, dp, p^T do and ds^T q),
// 51.6 GFLOP per call at b = 4, h = 12: 0.052 ms at 989 TFLOP/s bf16,
// against 0.023 ms of bytes (q, k, v, do, lse, delta read once, dk and dv
// written once).  Like the forward, this first version runs on the
// float32 CUDA cores out of shared memory; tensor-core tiles are later
// work.
#include "flash_common.cuh"

namespace tpudp {

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_dkv_kernel(Bthd<const T> q, Bthd<const T> k, Bthd<const T> v,
                     Bthd<const T> dout, const float* __restrict__ lse,
                     const float* __restrict__ delta, Bthd<T> dk, Bthd<T> dv,
                     int t, int heads, int causal, float scale) {
  extern __shared__ float smem[];
  float* k_s = smem;                      // (kTile, D + 1)
  float* v_s = k_s + kTile * (D + 1);     // (kTile, D + 1)
  float* q_s = v_s + kTile * (D + 1);     // (kTile, D + 1), pre-scaled
  float* do_s = q_s + kTile * (D + 1);    // (kTile, D + 1)
  float* pt_s = do_s + kTile * (D + 1);   // (kTile, kScorePitch): p^T
  float* dst_s = pt_s + kTile * kScorePitch;  // (kTile, kScorePitch): ds^T
  float* lse_s = dst_s + kTile * kScorePitch;  // (kTile)
  float* delta_s = lse_s + kTile;              // (kTile)
  const int n_tiles = gridDim.x;
  const int kt = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
  const int k0 = kt * kTile;

  load_tile<T, D>(k_s, k.slice(b, h), k.st, k0, t, 1.f);
  load_tile<T, D>(v_s, v.slice(b, h), v.st, k0, t, 1.f);
  const long long bh = ((long long)b * heads + h) * t;
  float dk_acc[kSub][D / 16], dv_acc[kSub][D / 16];
#pragma unroll
  for (int i = 0; i < kSub; ++i)
#pragma unroll
    for (int j = 0; j < D / 16; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  for (int qt = causal ? kt : 0; qt < n_tiles; ++qt) {
    const int q0 = qt * kTile;
    __syncthreads();  // every reader of the previous q/do and score tiles is done
    load_tile<T, D>(q_s, q.slice(b, h), q.st, q0, t, scale);
    load_tile<T, D>(do_s, dout.slice(b, h), dout.st, q0, t, 1.f);
    for (int r = threadIdx.x; r < kTile; r += kThreads) {
      lse_s[r] = q0 + r < t ? lse[bh + q0 + r] : 0.f;
      delta_s[r] = q0 + r < t ? delta[bh + q0 + r] : 0.f;
    }
    __syncthreads();
    float s[kSub][kSub], dp[kSub][kSub];  // rows: keys, columns: queries
    tile_dots<D>(s, k_s, q_s, ty, tx);
    tile_dots<D>(dp, v_s, do_s, ty, tx);
#pragma unroll
    for (int i = 0; i < kSub; ++i) {
      const int kj = k0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < kSub; ++j) {
        const int c = tx + 16 * j;
        const float p = visible(q0 + c, kj, t, causal)
                            ? expf(s[i][j] - lse_s[c])
                            : 0.f;
        pt_s[(ty + 16 * i) * kScorePitch + c] = p;
        dst_s[(ty + 16 * i) * kScorePitch + c] = p * (dp[i][j] - delta_s[c]);
      }
    }
    __syncthreads();
    tile_matmul_acc<D>(dv_acc, pt_s, do_s, ty, tx);
    tile_matmul_acc<D>(dk_acc, dst_s, q_s, ty, tx);
  }
  store_tile<T, D>(dk.slice(b, h), dk.st, k0, t, dk_acc, ty, tx, 1.f);
  store_tile<T, D>(dv.slice(b, h), dv.st, k0, t, dv_acc, ty, tx, 1.f);
}

}  // namespace tpudp

// q, k, v, do: (b, t, h, dh) read through strides; lse, delta: contiguous
// (b, h, t) float32; dk, dv: (b, t, h, dh) written through strides.
// strides holds the (batch, token, head) element strides of q, k, v, do,
// dk, dv.
extern "C" int launch_flash_dkv(const void* q, const void* k, const void* v,
                                const void* dout, const float* lse,
                                const float* delta, void* dk, void* dv,
                                const long long* strides, int dtype_code,
                                int batch, int t, int heads, int head_dim,
                                int causal, float scale,
                                cudaStream_t stream) {
  if (batch < 1 || t < 1 || heads < 1) return cudaErrorInvalidValue;
  TPUDP_DISPATCH(dtype_code, head_dim, {
    using tpudp::kTile;
    const size_t bytes = (4 * kTile * (kDH + 1) +
                          2 * kTile * tpudp::kScorePitch + 2 * kTile) *
                         sizeof(float);
    return static_cast<int>(tpudp::launch_tiles(
        tpudp::flash_dkv_kernel<scalar_t, kDH>, bytes, t, heads, batch,
        stream, tpudp::make_view<const scalar_t>(q, strides, 0),
        tpudp::make_view<const scalar_t>(k, strides, 1),
        tpudp::make_view<const scalar_t>(v, strides, 2),
        tpudp::make_view<const scalar_t>(dout, strides, 3), lse, delta,
        tpudp::make_view<scalar_t>(dk, strides, 4),
        tpudp::make_view<scalar_t>(dv, strides, 5), t, heads, causal,
        scale));
  });
}
