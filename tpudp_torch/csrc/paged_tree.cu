// Paged tree-verify attention for Hopper (sm_90a): the T+1 nodes of a
// speculative token tree per slot attend the slot's committed cache,
// read through the block table, jointly with the in-flight window K/V
// under the tree's ancestor-or-self mask, in one softmax.
//
// Replaces tpudp/ops/paged_attention.py:_tree_kernel (launched by
// _tree_paged).  On the TPU the grid is (slot, page + 1): the cache pages
// stream with strict visibility k_pos < pos0[slot] and one extra grid
// step folds the T+1 window keys (never written to the pool: rejected
// branches must leave zero pool bytes) into the online-softmax carry
// held in VMEM.  On Hopper, block (node tile, head, slot) gives each of
// its warps one node row, and the warp first folds the row's visible
// cache keys (0 .. pos0[slot] - 1: node 0's own K/V are in the window,
// not the pages) in 32-key tiles with fold_keys, then folds the window
// as one more tile inside the same loop state: lane c scores window
// node c when bit c of the row's ancestor bitmask is set.  The window
// K/V are strided views of the qkv projection and are read where they
// lie.  Unmapped (-1) table entries are skipped; query head i reads KV
// head i / groups.  Whole-pool mode offsets the pool base to the layer.
//
// Bound on this card: bytes (a verify window of <= 32 rows does about
// 4 * rows * dh flops per cache key row, below the fp32 ridge).  Every
// node tile of a slot re-reads the slot's cache K/V through L1/L2, as
// paged_window.cu does; a shared-memory K/V tile reused by all nodes and
// tensor-core products are later work.
#include "paged_common.cuh"

namespace tpudp {

constexpr int kTreeWarps = 4;  // node rows per block

template <typename T, int DH>
__global__ void __launch_bounds__(kTreeWarps * 32)
    paged_tree_kernel(const T* __restrict__ q, PageView<T> pv,
                      const int* __restrict__ table,
                      const int* __restrict__ pos0, const T* __restrict__ wk,
                      const T* __restrict__ wv,
                      const unsigned* __restrict__ anc, T* __restrict__ out,
                      int t1, int heads, int groups, int max_pages,
                      int page_tokens, long long q_slot_stride,
                      long long q_row_stride, long long q_head_stride,
                      long long w_slot_stride, long long w_row_stride,
                      long long w_head_stride, float scale) {
  const int head = blockIdx.y;
  const int s = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int j = blockIdx.x * kTreeWarps + warp;
  __shared__ float q_s[kTreeWarps][DH];
  if (j >= t1) return;  // whole warp: no block-wide barrier follows

  const T* qr = q + s * q_slot_stride + j * q_row_stride + head * q_head_stride;
  for (int d = lane; d < DH; d += 32) q_s[warp][d] = to_f32(qr[d]) * scale;
  __syncwarp();

  const int kv_head = head / groups;
  // Strict visibility: cache keys 0 .. pos0 - 1 (none when pos0 <= 0).
  const int limit = min(pos0[s] - 1, max_pages * page_tokens - 1);
  float m = kNegInf, l = 0.f;
  float acc[DH / 32];
#pragma unroll
  for (int i = 0; i < DH / 32; ++i) acc[i] = 0.f;
  fold_keys<T, DH>(q_s[warp], pv, table + (long long)s * max_pages,
                   page_tokens, kv_head, 0, 32, limit, m, l, acc);

  // The window tile: lane c holds node c's score if node c is an
  // ancestor of node j or j itself.
  const unsigned row_mask = anc[j];
  const long long w_base = s * w_slot_stride + kv_head * w_head_stride;
  const bool seen = lane < t1 && ((row_mask >> lane) & 1u);
  float sc = kNegInf;
  if (seen) {
    const T* kr = wk + w_base + lane * w_row_stride;
    float dot = 0.f;
#pragma unroll 8
    for (int d = 0; d < DH; ++d) dot += q_s[warp][d] * to_f32(kr[d]);
    sc = dot;
  }
  const float tile_max = warp_max(sc);
  if (tile_max > kNegInf) {
    const float m_new = fmaxf(m, tile_max);
    const float alpha = expf(m - m_new);
    const float p = seen ? expf(sc - m_new) : 0.f;
    l = l * alpha + warp_sum(p);
#pragma unroll
    for (int i = 0; i < DH / 32; ++i) acc[i] *= alpha;
    for (int c = 0; c < t1; ++c) {
      if (!((row_mask >> c) & 1u)) continue;  // warp-uniform
      const float pc = __shfl_sync(kFullMask, p, c);
      const T* vr = wv + w_base + c * w_row_stride;
#pragma unroll
      for (int i = 0; i < DH / 32; ++i) acc[i] += pc * to_f32(vr[lane + 32 * i]);
    }
    m = m_new;
  }

  T* o = out + (((long long)s * t1 + j) * heads + head) * DH;
  const float denom = fmaxf(l, 1e-30f);
#pragma unroll
  for (int i = 0; i < DH / 32; ++i) store_f32(o + lane + 32 * i, acc[i] / denom);
}

}  // namespace tpudp

// q: (b, t1, h, dh) with the given slot/row/head strides; wk, wv: (b, t1,
// kv, dh) with the w_* strides; anc: (t1,) row bitmasks; out: contiguous
// (b, t1, h, dh); k/v: one layer's pages at k/v (+ layer_offset elements).
extern "C" int launch_paged_tree(
    const void* q, const void* k, const void* v, const int* table,
    const int* pos0, const void* wk, const void* wv, const unsigned* anc,
    void* out, int dtype_code, int batch, int t1, int heads, int kv_heads,
    int head_dim, int max_pages, int page_tokens, long long q_slot_stride,
    long long q_row_stride, long long q_head_stride, long long w_slot_stride,
    long long w_row_stride, long long w_head_stride, long long layer_offset,
    long long page_stride, long long tok_stride, long long head_stride,
    float scale, cudaStream_t stream) {
  if (batch < 1 || t1 < 1 || t1 > 32 || kv_heads < 1 || heads % kv_heads)
    return cudaErrorInvalidValue;
  const dim3 grid((t1 + tpudp::kTreeWarps - 1) / tpudp::kTreeWarps, heads,
                  batch);
  TPUDP_DISPATCH(dtype_code, head_dim, {
    const scalar_t* kb = static_cast<const scalar_t*>(k) + layer_offset;
    const scalar_t* vb = static_cast<const scalar_t*>(v) + layer_offset;
    tpudp::PageView<scalar_t> pv{kb, vb, page_stride, tok_stride, head_stride};
    tpudp::paged_tree_kernel<scalar_t, kDH>
        <<<grid, tpudp::kTreeWarps * 32, 0, stream>>>(
            static_cast<const scalar_t*>(q), pv, table, pos0,
            static_cast<const scalar_t*>(wk), static_cast<const scalar_t*>(wv),
            anc, static_cast<scalar_t*>(out), t1, heads, heads / kv_heads,
            max_pages, page_tokens, q_slot_stride, q_row_stride,
            q_head_stride, w_slot_stride, w_row_stride, w_head_stride, scale);
  });
  return static_cast<int>(cudaGetLastError());
}
