// Paged window attention for Hopper (sm_90a): a window of `cur` query
// tokens per slot against the slot's K/V pages, read through the block
// table.  Chunked prefill sends a page-wide window at one shared depth
// (scalar pos, broadcast by the caller); a speculative verify window
// sends per-slot depths.
//
// Replaces tpudp/ops/paged_attention.py:_window_kernel (launched by
// _window_paged).  On the TPU the grid is (slot, query tile <= 32, page)
// with the query rows flattened KV-head-major into one tile and the
// online-softmax carry held in VMEM across the sequential page axis.  On
// Hopper, block (row tile, head, slot) gives each of its warps one query
// row, and the warp walks that row's visible keys (0 .. pos[slot] + j) in
// 32-key tiles with the running max, denominator and accumulator in
// registers: the page axis is a loop inside the block, and row j's causal
// in-window mask is the same comparison as cache visibility because the
// caller writes the window's K/V into its pages before attending.
// Unmapped (-1) entries are skipped; query head j reads KV head
// j / groups.  Whole-pool mode offsets the pool base to the layer.
//
// The int8 variant (launch_paged_window_int8) runs the same kernel over
// int8 pages with float32 per-vector scales, as paged_decode.cu's does:
// the TPU kernel's `int8` branch dequantizes whole page blocks in VMEM,
// here each lane folds its key's scale into the score and its v_scale
// into the P.V weight.
//
// Bound on this card: bytes for the shapes the serving path sends
// (a prefill chunk of 16-32 rows over a few hundred keys does about
// 4 * rows * dh flops per key and byte of K/V row, below the fp32 ridge).
// The warps of a block share K/V rows through L1/L2 rather than shared
// memory, and every row tile of a slot re-reads the slot's K/V; a
// tensor-core (wgmma) tile loop over shared-memory K/V is later work.
#include "paged_common.cuh"

namespace tpudp {

constexpr int kWindowWarps = 4;  // query rows per block

template <typename T, typename P, int DH>
__global__ void __launch_bounds__(kWindowWarps * 32)
    paged_window_kernel(const T* __restrict__ q, PageView<P> pv,
                        const int* __restrict__ table,
                        const int* __restrict__ pos, T* __restrict__ out,
                        int cur, int heads, int groups, int max_pages,
                        int page_tokens, long long q_slot_stride,
                        long long q_row_stride, long long q_head_stride,
                        float scale) {
  const int head = blockIdx.y;
  const int s = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int j = blockIdx.x * kWindowWarps + warp;
  __shared__ float q_s[kWindowWarps][DH];
  if (j >= cur) return;  // whole warp: no block-wide barrier follows

  const T* qr = q + s * q_slot_stride + j * q_row_stride + head * q_head_stride;
  for (int d = lane; d < DH; d += 32) q_s[warp][d] = to_f32(qr[d]) * scale;
  __syncwarp();

  const int limit = min(pos[s] + j, max_pages * page_tokens - 1);
  float m = kNegInf, l = 0.f;
  float acc[DH / 32];
#pragma unroll
  for (int i = 0; i < DH / 32; ++i) acc[i] = 0.f;
  fold_keys<P, DH>(q_s[warp], pv, table + (long long)s * max_pages,
                   page_tokens, head / groups, 0, 32, limit, m, l, acc);

  T* o = out + (((long long)s * cur + j) * heads + head) * DH;
  const float denom = fmaxf(l, 1e-30f);
#pragma unroll
  for (int i = 0; i < DH / 32; ++i) store_f32(o + lane + 32 * i, acc[i] / denom);
}

}  // namespace tpudp

// q: (b, cur, h, dh) with the given slot/row/head strides; out: contiguous
// (b, cur, h, dh); k/v: one layer's pages at k/v (+ layer_offset elements).
extern "C" int launch_paged_window(
    const void* q, const void* k, const void* v, const int* table,
    const int* pos, void* out, int dtype_code, int batch, int cur, int heads,
    int kv_heads, int head_dim, int max_pages, int page_tokens,
    long long q_slot_stride, long long q_row_stride, long long q_head_stride,
    long long layer_offset, long long page_stride, long long tok_stride,
    long long head_stride, float scale, cudaStream_t stream) {
  if (batch < 1 || cur < 1 || kv_heads < 1 || heads % kv_heads)
    return cudaErrorInvalidValue;
  const dim3 grid((cur + tpudp::kWindowWarps - 1) / tpudp::kWindowWarps, heads,
                  batch);
  TPUDP_DISPATCH(dtype_code, head_dim, {
    const scalar_t* kb = static_cast<const scalar_t*>(k) + layer_offset;
    const scalar_t* vb = static_cast<const scalar_t*>(v) + layer_offset;
    tpudp::PageView<scalar_t> pv{kb, vb, page_stride, tok_stride, head_stride};
    tpudp::paged_window_kernel<scalar_t, scalar_t, kDH>
        <<<grid, tpudp::kWindowWarps * 32, 0, stream>>>(
            static_cast<const scalar_t*>(q), pv, table, pos,
            static_cast<scalar_t*>(out), cur, heads, heads / kv_heads,
            max_pages, page_tokens, q_slot_stride, q_row_stride,
            q_head_stride, scale);
  });
  return static_cast<int>(cudaGetLastError());
}

// As launch_paged_window over an int8 pool: k/v int8 pages, k_scale/v_scale
// their float32 scales (+ scale_layer_offset elements, s_* strides); q and
// out are float32 or bf16 (dtype_code).
extern "C" int launch_paged_window_int8(
    const void* q, const void* k, const void* v, const float* k_scale,
    const float* v_scale, const int* table, const int* pos, void* out,
    int dtype_code, int batch, int cur, int heads, int kv_heads, int head_dim,
    int max_pages, int page_tokens, long long q_slot_stride,
    long long q_row_stride, long long q_head_stride, long long layer_offset,
    long long page_stride, long long tok_stride, long long head_stride,
    long long scale_layer_offset, long long s_page_stride,
    long long s_tok_stride, long long s_head_stride, float scale,
    cudaStream_t stream) {
  if (batch < 1 || cur < 1 || kv_heads < 1 || heads % kv_heads)
    return cudaErrorInvalidValue;
  const dim3 grid((cur + tpudp::kWindowWarps - 1) / tpudp::kWindowWarps, heads,
                  batch);
  const tpudp::PageView<int8_t> pv = tpudp::int8_page_view(
      k, v, k_scale, v_scale, layer_offset, page_stride, tok_stride,
      head_stride, scale_layer_offset, s_page_stride, s_tok_stride,
      s_head_stride);
  TPUDP_DISPATCH(dtype_code, head_dim, {
    tpudp::paged_window_kernel<scalar_t, int8_t, kDH>
        <<<grid, tpudp::kWindowWarps * 32, 0, stream>>>(
            static_cast<const scalar_t*>(q), pv, table, pos,
            static_cast<scalar_t*>(out), cur, heads, heads / kv_heads,
            max_pages, page_tokens, q_slot_stride, q_row_stride,
            q_head_stride, scale);
  });
  return static_cast<int>(cudaGetLastError());
}
