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
// held in VMEM.
//
// Bound on this card: bytes (a verify window of <= 32 rows does about
// 4 * rows * dh flops per cache key row, below the fp32 ridge), so every
// cache K/V byte should cross from memory once.  Block (row tile, KV
// head, slot) owns every query row that reads that KV head: the T+1
// nodes times the `groups` query heads sharing it, up to kTileRows of
// them (wider tiles, past 32 rows, take further blocks), each of its
// warps folding up to kRowsPerWarp rows.  The block walks the slot's
// visible cache keys (0 .. pos0[slot] - 1: node 0's own K/V are in the
// window, not the pages) in tiles of 32 keys.  For each tile it resolves
// the page table once per key, loads the K and V rows coalesced (16
// bytes a thread, consecutive threads along a row) by cp.async into
// shared memory, padded by 16 bytes a row and double-buffered, so the
// next tile streams in while this one is folded; then every row folds
// the tile from shared memory with the running max, denominator and
// accumulator in registers: scores with lane = key (each lane reads its
// key's row once for all of the warp's rows, conflict-free through the
// padding), then P.V with lane = output dims.  The window K/V (strided
// views of the qkv projection, at most 32 rows) are staged once per
// block the same way and folded last, as one more tile under each row's
// ancestor bitmask.  Unmapped (-1) table entries get no weight; query
// head i reads KV head i / groups.  Whole-pool mode offsets the pool
// base to the layer.  bf16 pools run the same kernel, widening values to
// float32 as they are read from shared memory; everything is computed in
// float32 on the CUDA cores (TF32 tensor cores would not meet the f32
// check's 2e-5).  The staging and fold of the cache tiles are
// paged_common.cuh's shared key tiles, which the window kernel uses too.
#include "paged_common.cuh"

namespace tpudp {

// Shared memory of a block: its query rows (float32, pre-scaled), the
// two stages of cache key tiles, and the window K and V, staged in the
// same padded row layout.
template <typename T, int DH>
struct TreeSmem {
  using M = StagedRows<T, DH>;
  static constexpr size_t kBytes =
      M::kQ + KeyStages<T, DH>::kBytes + 2 * M::kTile;
};

template <typename T, int DH>
__global__ void __launch_bounds__(kTileWarps * 32)
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
  using M = StagedRows<T, DH>;
  extern __shared__ __align__(16) uint8_t smem[];
  float* q_s = reinterpret_cast<float*>(smem);  // (kTileRows, DH)
  const KeyStages<T, DH> st = KeyStages<T, DH>::at(smem + M::kQ);
  uint8_t* wk_t = smem + M::kQ + KeyStages<T, DH>::kBytes;
  uint8_t* wv_t = wk_t + M::kTile;

  const int kv_head = blockIdx.y;
  const int s = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row0 = blockIdx.x * kTileRows;  // of the t1 * groups rows
  const int rows = min(kTileRows, t1 * groups - row0);
  const int nr = warp_rows(rows, warp);

  // Strict visibility: cache keys 0 .. pos0 - 1 (none when pos0 <= 0).
  const int limit = min(pos0[s] - 1, max_pages * page_tokens - 1);
  const int n_tiles = limit < 0 ? 0 : limit / kTileKeys + 1;
  const int* trow = table + (long long)s * max_pages;
  if (n_tiles > 0)
    stage_keys<T, DH>(st, 0, pv, trow, page_tokens, kv_head, limit);
  // The block's query rows: row r is node r / groups.
  stage_queries<T, DH>(q_s, q, s, kv_head, groups, row0, rows,
                       q_slot_stride, q_row_stride, q_head_stride, scale);
  // The window K/V rows of this KV head, staged once; the V rows past
  // the last node are zero (fold_tile reads all 32).
  const long long w_base = s * w_slot_stride + kv_head * w_head_stride;
  for (int i = threadIdx.x; i < kTileKeys * DH; i += blockDim.x) {
    const int j = i / DH, d = i % DH;
    if (j >= t1) {
      store_f32(reinterpret_cast<T*>(wv_t + j * M::kPitch) + d, 0.f);
      continue;
    }
    const long long src = w_base + j * w_row_stride + d;
    reinterpret_cast<T*>(wk_t + j * M::kPitch)[d] = wk[src];
    reinterpret_cast<T*>(wv_t + j * M::kPitch)[d] = wv[src];
  }

  float m[kRowsPerWarp], l[kRowsPerWarp];
  float acc[kRowsPerWarp][DH / 32];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    m[rr] = kNegInf;
    l[rr] = 0.f;
#pragma unroll
    for (int i = 0; i < DH / 32; ++i) acc[rr][i] = 0.f;
  }
  // Every mapped cache key is visible to every node.
  fold_key_tiles<T, DH>(
      st, pv, trow, page_tokens, kv_head, limit, 0, n_tiles, q_s, warp, nr,
      [](int, unsigned mapped, unsigned (&vis)[kRowsPerWarp]) {
#pragma unroll
        for (int rr = 0; rr < kRowsPerWarp; ++rr) vis[rr] = mapped;
      },
      m, l, acc);
  __syncthreads();  // the query rows and the window are in

  // The window tile: lane c is node c, seen by row r iff c is an
  // ancestor of the row's node or the node itself.
  if (nr > 0) {
    float sc[kRowsPerWarp];
    unsigned vis[kRowsPerWarp];
    row_scores<T, DH>(wk_t + min(lane, t1 - 1) * M::kPitch, q_s, warp, nr,
                      sc);
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int node = (row0 + warp + kTileWarps * rr) / groups;
      vis[rr] = rr < nr ? anc[node] & (t1 == 32 ? ~0u : (1u << t1) - 1) : 0u;
    }
    fold_tile<T, DH>(sc, vis, wv_t, 1.f, nr, m, l, acc);
  }

#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    if (rr >= nr) break;
    const int r = row0 + warp + kTileWarps * rr;
    T* o = out + (((long long)s * t1 + r / groups) * heads + kv_head * groups +
                  r % groups) * DH;
    const float denom = fmaxf(l[rr], 1e-30f);
#pragma unroll
    for (int i = 0; i < DH / 32; ++i)
      store_f32(o + lane + 32 * i, acc[rr][i] / denom);
  }
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
  const int groups = heads / kv_heads;
  const dim3 grid((t1 * groups + tpudp::kTileRows - 1) / tpudp::kTileRows,
                  kv_heads, batch);
  TPUDP_DISPATCH(dtype_code, head_dim, {
    const auto kernel = tpudp::paged_tree_kernel<scalar_t, kDH>;
    const size_t bytes = tpudp::TreeSmem<scalar_t, kDH>::kBytes;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    const scalar_t* kb = static_cast<const scalar_t*>(k) + layer_offset;
    const scalar_t* vb = static_cast<const scalar_t*>(v) + layer_offset;
    tpudp::PageView<scalar_t> pv{kb, vb, page_stride, tok_stride, head_stride};
    kernel<<<grid, tpudp::kTileWarps * 32, bytes, stream>>>(
        static_cast<const scalar_t*>(q), pv, table, pos0,
        static_cast<const scalar_t*>(wk), static_cast<const scalar_t*>(wv),
        anc, static_cast<scalar_t*>(out), t1, heads, groups, max_pages,
        page_tokens, q_slot_stride, q_row_stride, q_head_stride,
        w_slot_stride, w_row_stride, w_head_stride, scale);
  });
  return static_cast<int>(cudaGetLastError());
}
