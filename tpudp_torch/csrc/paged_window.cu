// Paged window attention for Hopper (sm_90a): a window of `cur` query
// tokens per slot against the slot's K/V pages, read through the block
// table.  Chunked prefill sends a page-wide window at one shared depth
// (scalar pos, broadcast by the caller); a speculative verify window
// sends per-slot depths.
//
// Replaces tpudp/ops/paged_attention.py:_window_kernel (launched by
// _window_paged).  On the TPU the grid is (slot, query tile <= 32, page)
// with the query rows flattened KV-head-major into one tile and the
// online-softmax carry held in VMEM across the sequential page axis.
//
// Bound on this card: bytes (a window of R rows a KV head does about
// 4 * R * dh flops per K/V row, far below the fp32 ridge at the rows a
// prefill chunk or a verify window sends), so every K/V byte should
// cross from memory once, and the wait on memory and the serial chain of
// the fold, not the FMA rate, are what remain.  Block (row tile, KV head,
// slot, key split) owns query rows that all read that KV head, as the
// TPU's flattened tile does: window positions times the `groups` query
// heads sharing the KV head, up to kTileRows of them a row tile (the
// caller picks the width, 8 rows on the serving path: more blocks with
// shorter folds beat fewer blocks sharing more of each tile).  The
// rows are staged once, pre-scaled, in float32; the K/V tiles of the
// block's keys stream through paged_common.cuh's shared key tiles (page
// ids resolved once a key, rows by cp.async into padded, double-buffered
// shared memory; over int8 pages each key's two scales staged beside its
// page id), and every row folds each tile from shared memory: scores
// with lane = key, P.V with lane = output dims.  Row j's causal in-window
// mask is the same comparison as cache visibility (key <= pos[slot] + j)
// because the caller writes the window's K/V into its pages before
// attending; it is a 32-bit mask a tile and row, full except in the last
// tile or two.  Unmapped (-1) entries get no weight; query head i reads
// KV head i / groups.  Whole-pool mode offsets the pool base to the
// layer.
//
// A block walks its key tiles in order, and a prefill chunk is one slot,
// so (row tile, KV head) gives few blocks with long walks: the caller's
// schedule (ops/paged_attention.py window_schedule) launches `splits`
// blocks a (row tile, KV head, slot), and the first `used` of them (one
// a key tile its rows see, at most `splits`: a verify window's depths
// are known only here) each fold an even share of the tiles into a
// partial (m, l, acc) in the caller's float32 scratch; the rest exit at
// once.  A depth shared by the batch (the engine's prefill chunk start)
// comes by value, with no depth tensor.  The last block of a (row tile,
// KV head, slot) to finish, found by an atomic ticket taken after a
// __threadfence, merges the partials in split order (so the output does
// not depend on which block merges) and writes it, and resets the ticket
// to 0 for the next launch; one launch a call, nothing allocated here.
// With one split used there is no partial and no merge.
//
// Everything runs in float32 on the CUDA cores, bf16 pools widening
// values as they are read from shared memory: TF32 tensor cores keep
// about three decimal digits and would not meet the fp32 check's 2e-5,
// and at this arithmetic intensity they would buy nothing.  A bf16
// mma.sync path for bf16 pools is possible later work.
//
// The int8 variant (launch_paged_window_int8) runs the same kernel over
// int8 pages with float32 per-vector scales, as the decode kernel does:
// the TPU kernel's `int8` branch dequantizes whole page blocks in VMEM,
// here the key's scale leaves the dot product and its v_scale joins the
// key's P.V weight.
#include "paged_common.cuh"

namespace tpudp {

template <typename T, typename P, int DH>
__global__ void __launch_bounds__(kTileWarps * 32)
    paged_window_kernel(const T* __restrict__ q, PageView<P> pv,
                        const int* __restrict__ table,
                        const int* __restrict__ pos, T* __restrict__ out,
                        float* __restrict__ part, unsigned* __restrict__ ticket,
                        int cur, int heads, int groups, int max_pages,
                        int page_tokens, int row_tile, int splits, int depth,
                        long long q_slot_stride, long long q_row_stride,
                        long long q_head_stride, float scale) {
  using M = StagedRows<P, DH>;
  extern __shared__ __align__(16) uint8_t smem[];
  float* q_s = reinterpret_cast<float*>(smem);  // (row_tile, DH)
  const KeyStages<P, DH> st = KeyStages<P, DH>::at(smem + M::kQ);

  const int n_rows = cur * groups;  // rows reading one KV head
  const int row_tiles = (n_rows + row_tile - 1) / row_tile;
  const int rt = blockIdx.x / splits, split = blockIdx.x % splits;
  const int kv_head = blockIdx.y;
  const int s = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row0 = rt * row_tile;
  const int rows = min(row_tile, n_rows - row0);
  const int nr = warp_rows(rows, warp);

  // The block's keys: 0 .. the visibility edge of its last row, within
  // the table.  Of the `splits` blocks of this (row tile, KV head, slot),
  // the first `used` share its key tiles, one or more each (the depths
  // may be known only here): this split folds tiles [kt0, kt1).
  const int p0 = pos != nullptr ? pos[s] : depth;
  const int limit =
      min(p0 + (row0 + rows - 1) / groups, max_pages * page_tokens - 1);
  const int n_tiles = limit < 0 ? 0 : limit / kTileKeys + 1;
  const int used = max(1, min(splits, n_tiles));
  if (split >= used) return;  // whole block: no work, no ticket
  const int kt0 = split * n_tiles / used;
  const int kt1 = (split + 1) * n_tiles / used;
  const int* trow = table + (long long)s * max_pages;
  if (kt0 < kt1)
    stage_keys<P, DH>(st, kt0, pv, trow, page_tokens, kv_head, limit);
  stage_queries<T, DH>(q_s, q, s, kv_head, groups, row0, rows, q_slot_stride,
                       q_row_stride, q_head_stride, scale);

  float m[kRowsPerWarp], l[kRowsPerWarp];
  float acc[kRowsPerWarp][DH / 32];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    m[rr] = kNegInf;
    l[rr] = 0.f;
#pragma unroll
    for (int i = 0; i < DH / 32; ++i) acc[rr][i] = 0.f;
  }
  // Row r sees the mapped keys <= p0 + r / groups.
  fold_key_tiles<P, DH>(
      st, pv, trow, page_tokens, kv_head, limit, kt0, kt1, q_s, warp, nr,
      [&](int kt, unsigned mapped, unsigned (&vis)[kRowsPerWarp]) {
#pragma unroll
        for (int rr = 0; rr < kRowsPerWarp; ++rr) {
          const int j = (row0 + warp + kTileWarps * rr) / groups;
          const int e = p0 + j - kt * kTileKeys;  // last visible lane
          const unsigned edge =
              e >= 31 ? ~0u : e < 0 ? 0u : (1u << (e + 1)) - 1u;
          vis[rr] = rr < nr ? mapped & edge : 0u;
        }
      },
      m, l, acc);

  // Output row of the warp's row rr: (slot, position, query head).
  auto out_row = [&](int rr) {
    const int r = row0 + warp + kTileWarps * rr;
    return ((long long)s * cur + r / groups) * heads + kv_head * groups +
           r % groups;
  };
  if (used > 1) {
    unsigned* t =
        ticket + ((long long)s * gridDim.y + kv_head) * row_tiles + rt;
    if (!merge_key_splits<DH>(part, t, split, used, splits,
                              (long long)gridDim.z * cur * heads, nr, out_row,
                              m, l, acc))
      return;  // another split merges
  }
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    if (rr >= nr) break;
    T* o = out + out_row(rr) * DH;
    const float denom = fmaxf(l[rr], 1e-30f);
#pragma unroll
    for (int i = 0; i < DH / 32; ++i)
      store_f32(o + lane + 32 * i, acc[rr][i] / denom);
  }
}

// Launch over pages of P with T queries: grid (row tiles x splits, KV
// heads, slots), 8 warps a block.
template <typename T, typename P, int DH>
int launch_window(const T* q, const PageView<P>& pv, const int* table,
                  const int* pos, T* out, float* part, unsigned* ticket,
                  int batch, int cur, int heads, int kv_heads, int max_pages,
                  int page_tokens, int row_tile, int splits, int depth,
                  long long q_slot_stride, long long q_row_stride,
                  long long q_head_stride, float scale, cudaStream_t stream) {
  const int groups = heads / kv_heads;
  const int row_tiles = (cur * groups + row_tile - 1) / row_tile;
  const auto kernel = paged_window_kernel<T, P, DH>;
  const size_t bytes = StagedRows<P, DH>::kQ + KeyStages<P, DH>::kBytes;
  const cudaError_t err = allow_smem<paged_window_kernel<T, P, DH>>(bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(row_tiles * splits, kv_heads, batch);
  kernel<<<grid, kTileWarps * 32, bytes, stream>>>(
      q, pv, table, pos, out, part, ticket, cur, heads, groups, max_pages,
      page_tokens, row_tile, splits, depth, q_slot_stride, q_row_stride,
      q_head_stride, scale);
  return static_cast<int>(cudaGetLastError());
}

// What every launch refuses: an empty batch or window, heads that do not
// group, a row tile outside 1..kTileRows, or key splits without their
// scratch and tickets.
inline bool window_args_ok(int batch, int cur, int heads, int kv_heads,
                           int row_tile, int splits, const float* part,
                           const unsigned* ticket) {
  return batch >= 1 && cur >= 1 && kv_heads >= 1 && heads % kv_heads == 0 &&
         row_tile >= 1 && row_tile <= kTileRows && splits >= 1 &&
         (splits == 1 || (part != nullptr && ticket != nullptr));
}

}  // namespace tpudp

// q: (b, cur, h, dh) with the given slot/row/head strides; out: contiguous
// (b, cur, h, dh); k/v: one layer's pages at k/v (+ layer_offset elements).
// part: float32 scratch of splits * b * cur * h * (dh + 2) elements and
// ticket: b * kv_heads * row tiles zeroed counters (both unused, and may
// be null, when splits == 1); row_tile: query rows a block (<= 32) of the
// cur * h / kv_heads rows reading one KV head; pos: (b,) depths on the
// card, or null for one depth shared by the batch, `depth`.
extern "C" int launch_paged_window(
    const void* q, const void* k, const void* v, const int* table,
    const int* pos, void* out, float* part, unsigned* ticket, int dtype_code,
    int batch, int cur, int heads, int kv_heads, int head_dim, int max_pages,
    int page_tokens, int row_tile, int splits, int depth,
    long long q_slot_stride, long long q_row_stride, long long q_head_stride,
    long long layer_offset, long long page_stride, long long tok_stride,
    long long head_stride, float scale, cudaStream_t stream) {
  if (!tpudp::window_args_ok(batch, cur, heads, kv_heads, row_tile, splits,
                             part, ticket))
    return cudaErrorInvalidValue;
  TPUDP_DISPATCH(dtype_code, head_dim, {
    const scalar_t* kb = static_cast<const scalar_t*>(k) + layer_offset;
    const scalar_t* vb = static_cast<const scalar_t*>(v) + layer_offset;
    tpudp::PageView<scalar_t> pv{kb, vb, page_stride, tok_stride, head_stride};
    return tpudp::launch_window<scalar_t, scalar_t, kDH>(
        static_cast<const scalar_t*>(q), pv, table, pos,
        static_cast<scalar_t*>(out), part, ticket, batch, cur, heads,
        kv_heads, max_pages, page_tokens, row_tile, splits, depth,
        q_slot_stride, q_row_stride, q_head_stride, scale, stream);
  });
}

// As launch_paged_window over an int8 pool: k/v int8 pages, k_scale/v_scale
// their float32 scales (+ scale_layer_offset elements, s_* strides); q and
// out are float32 or bf16 (dtype_code).
extern "C" int launch_paged_window_int8(
    const void* q, const void* k, const void* v, const float* k_scale,
    const float* v_scale, const int* table, const int* pos, void* out,
    float* part, unsigned* ticket, int dtype_code, int batch, int cur,
    int heads, int kv_heads, int head_dim, int max_pages, int page_tokens,
    int row_tile, int splits, int depth, long long q_slot_stride,
    long long q_row_stride, long long q_head_stride, long long layer_offset,
    long long page_stride, long long tok_stride, long long head_stride,
    long long scale_layer_offset,
    long long s_page_stride, long long s_tok_stride, long long s_head_stride,
    float scale, cudaStream_t stream) {
  if (!tpudp::window_args_ok(batch, cur, heads, kv_heads, row_tile, splits,
                             part, ticket))
    return cudaErrorInvalidValue;
  const tpudp::PageView<int8_t> pv = tpudp::int8_page_view(
      k, v, k_scale, v_scale, layer_offset, page_stride, tok_stride,
      head_stride, scale_layer_offset, s_page_stride, s_tok_stride,
      s_head_stride);
  TPUDP_DISPATCH(dtype_code, head_dim, {
    return tpudp::launch_window<scalar_t, int8_t, kDH>(
        static_cast<const scalar_t*>(q), pv, table, pos,
        static_cast<scalar_t*>(out), part, ticket, batch, cur, heads,
        kv_heads, max_pages, page_tokens, row_tile, splits, depth,
        q_slot_stride, q_row_stride, q_head_stride, scale, stream);
  });
}
