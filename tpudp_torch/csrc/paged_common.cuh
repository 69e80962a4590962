// Shared device code of the paged-attention kernels (paged_decode.cu,
// paged_window.cu, paged_tree.cu): the page view and the one
// online-softmax loop that folds a query row's visible keys, read through
// the block table, into a running max / denominator / accumulator.
//
// Layouts (all element strides, the last dimension contiguous):
//   pages  one layer of the pool, (P+1, T, kv, dh); the trailing page is
//          the write scratch and is never read here.  float32 or bf16
//          like the queries, or int8 with float32 scales (P+1, T, kv), one
//          per (page, token, head) vector: the stored value is
//          int8 * scale (symmetric absmax quantization)
//   table  (b, M) int32, -1 for an unmapped entry
// Query row j of slot s sees keys k_pos <= pos[s] + j.  Keys past the
// visibility edge and keys on unmapped pages get no weight at all, as in
// the TPU kernels (which mask them to -1e30 or skip the page).
#pragma once

#include <type_traits>

#include "common.cuh"

namespace tpudp {

// Where the K/V of one layer live: base pointers (already offset to the
// layer in whole-pool mode) and element strides of page, token and head.
// P is the page element type; int8 pages also carry their scale pools,
// offset to the layer, with strides of their own (a (L, P+1, T, kv) scale
// pool is strided unlike the (L, P+1, T, kv, dh) payload).
template <typename P>
struct PageView {
  const P* k;
  const P* v;
  long long page_stride;
  long long tok_stride;
  long long head_stride;
  const float* k_scale = nullptr;  // int8 pages only
  const float* v_scale = nullptr;
  long long s_page_stride = 0;
  long long s_tok_stride = 0;
  long long s_head_stride = 0;
};

template <typename P>
constexpr bool kInt8Pages = std::is_same<P, int8_t>::value;

// The view of one layer of an int8 pool: payload and scale bases offset
// to the layer (layer_offset / scale_layer_offset elements).
inline PageView<int8_t> int8_page_view(
    const void* k, const void* v, const float* k_scale, const float* v_scale,
    long long layer_offset, long long page_stride, long long tok_stride,
    long long head_stride, long long scale_layer_offset,
    long long s_page_stride, long long s_tok_stride, long long s_head_stride) {
  return {static_cast<const int8_t*>(k) + layer_offset,
          static_cast<const int8_t*>(v) + layer_offset,
          page_stride, tok_stride, head_stride,
          k_scale + scale_layer_offset, v_scale + scale_layer_offset,
          s_page_stride, s_tok_stride, s_head_stride};
}

// One warp folds keys [first, limit] of one query row into (m, l, acc).
// Keys come in tiles of 32, one key per lane: lane i scores key base+i
// against the pre-scaled query q_s (shared memory, read as a broadcast),
// the tile updates the online softmax once, and the P.V product is
// accumulated with lane i owning output dims i, i+32, ...  Tiles start at
// `first` and step by `step` keys, so several warps can split one row's
// keys.  Runs in float32 whatever P is.  Over int8 pages the key's scale
// leaves the dot product (s = k_scale * sum q * k8: the dequantized dot
// in another summation order), and each P.V weight takes the key's
// v_scale, broadcast from its lane with the page id.
template <typename P, int DH>
__device__ __forceinline__ void fold_keys(const float* q_s,
                                          const PageView<P>& pv,
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
    float v_scale = 1.f;
    if (page >= 0) {
      const long long row = (long long)(key % page_tokens);
      const P* kr =
          pv.k + page * pv.page_stride + row * pv.tok_stride + head_off;
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < DH; d += Vec16<P>::N) {
        float kx[Vec16<P>::N];
        Vec16<P>::load(kr + d, kx);
#pragma unroll
        for (int e = 0; e < Vec16<P>::N; ++e) dot += q_s[d + e] * kx[e];
      }
      s = dot;
      if constexpr (kInt8Pages<P>) {
        const long long so = page * pv.s_page_stride + row * pv.s_tok_stride +
                             kv_head * pv.s_head_stride;
        s *= pv.k_scale[so];
        v_scale = pv.v_scale[so];
      }
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
      float pt = __shfl_sync(kFullMask, p, t);
      if constexpr (kInt8Pages<P>) pt *= __shfl_sync(kFullMask, v_scale, t);
      if (pg < 0) continue;  // warp-uniform: the broadcast value
      const P* vr = pv.v + pg * pv.page_stride +
                    (long long)((base + t) % page_tokens) * pv.tok_stride +
                    head_off;
#pragma unroll
      for (int i = 0; i < DH / 32; ++i) acc[i] += pt * to_f32(vr[lane + 32 * i]);
    }
    m = m_new;
  }
}

}  // namespace tpudp
