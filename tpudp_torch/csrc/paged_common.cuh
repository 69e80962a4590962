// Shared device code of the paged-attention kernels (paged_decode.cu,
// paged_window.cu): the page view and the one online-softmax loop that
// folds a query row's visible keys, read through the block
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

#include "common.cuh"

namespace tpudp {

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
