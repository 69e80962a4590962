// Paged decode attention for Hopper (sm_90a): one query token per slot
// against that slot's K/V pages, read through the block table.
//
// Replaces tpudp/ops/paged_attention.py:_decode_kernel (launched by
// _kernel_paged).  On the TPU the grid is (slot, page): each step DMAs
// one page of every KV head and folds it into all of the slot's query
// heads, the online-softmax carry held in VMEM across the sequential page
// axis, so every page crosses from memory once.
//
// Bound on this card: bytes.  A call must read the visible K/V rows once
// (2 * visible * kv * dh * itemsize a slot, plus 8 bytes of scales per
// visible key and KV head over int8 pages) plus q and out, and does 4 *
// h * dh flops a visible key, far below the fp32 rate.  At a decode
// step's few slots those bytes take microseconds: what a call costs is
// its chain of dependent memory round trips (table, K/V rows, partials)
// and how many of them run side by side.  So:
//
// * Block (row tile, KV head, slot, key split) owns the query heads that
//   read one KV head (the `groups` rows, up to kRowsPerWarp a row tile),
//   so each K/V row crosses from memory once a call, not once a query
//   head, as on the TPU.
// * Its warps form key lanes of RW warps, RW the largest of 1, 2 and 4
//   within the row tile, and the block as many lanes as fit in 8 warps,
//   up to 4 (kDecodeLanes): GPT-2 (one row a block) runs four lanes of
//   one warp, LLaMA-GQA (four rows) two lanes of four warps.  Each lane
//   stages key tiles of its own (32 keys: page ids resolved once a key,
//   one a thread, K and V rows by cp.async into padded shared memory,
//   int8 scales beside the page ids), and its warps fold them into the
//   block's rows out of shared memory, warp j the rows j, j + RW, ...:
//   scores with lane = key, P.V unrolled over the tile with lane = output
//   dims (paged_common.cuh's row_scores and fold_tile).  A block folds as
//   many tiles side by side as it has lanes; the lanes' (m, l, acc) then
//   merge through shared memory.
// * The depths stay on the card, so the caller's schedule
//   (ops/paged_attention.py decode_schedule) launches `splits` blocks a
//   (row tile, KV head, slot) for the table's capacity, the split the
//   grid's slowest index.  The first `used` of them, one per lanes' worth
//   of the key tiles the slot sees, fold even shares of the tiles, and the
//   last of those to finish merges their partials in the same launch
//   (merge_key_splits); the rest exit at once.  With one split used there
//   is no partial and no merge.
//
// The other candidate, the window kernel at one query row (its 8 warps
// stage each tile together and warp w folds rows w, w + 8, ...: at decode
// most warps only stage), lost to this block at every shape measured
// (PERF.md §6); chip_window_sweep.py still times it through paged_window.
//
// Everything runs in float32 on the CUDA cores (TF32 would miss the fp32
// check's 2e-5, and at this arithmetic intensity it would buy nothing);
// bf16 queries and pages widen as they are read.  A slot none of whose
// visible keys is mapped (an idle slot) gets zeros, as the TPU kernel's
// l = 0, acc = 0 does.  The int8 variant (launch_paged_decode_int8) is
// the same kernel over int8 pages with float32 per-vector scales (the
// TPU kernel's `int8` branch): the key's scale leaves the dot product and
// its v_scale joins the key's P.V weight.
#include "paged_common.cuh"

namespace tpudp {

// Key lanes of a block whose lanes have RW warps: as many as fit in 8
// warps, up to 4.
template <int RW>
constexpr int kDecodeLanes = RW == 4 ? 2 : 4;

// Shared memory of a decode block of `lanes` key lanes: its query rows
// (float32, pre-scaled), then one key stage a lane.
template <typename P, int DH>
struct DecodeSmem {
  using Stage = KeyStages<P, DH, 1>;
  static constexpr size_t kQ = kRowsPerWarp * DH * 4;
  static constexpr size_t bytes(int lanes) {
    return kQ + lanes * Stage::kBytes;
  }
};

// Waits for the RW warps of each key lane: a lane of one warp by itself,
// of several with the whole block (whose lanes all make the same number of
// passes).
template <int RW>
__device__ __forceinline__ void lane_sync() {
  if constexpr (RW == 1)
    __syncwarp();
  else
    __syncthreads();
}

// Key tile kt into a key lane's stage by its RW warps, warp j of them:
// each lane r resolves key r's page id once (-1 past `limit` or on an
// unmapped entry) and, in warp 0, stores it and copies the key's two
// scales over int8 pages; then the K and V rows go in by cp.async, 16
// bytes a thread, each lane taking its row's address from the row's lane
// by a shuffle.  A key with no page gets a zero V row.  Commits one
// cp.async group.
template <typename P, int DH, int RW>
__device__ __forceinline__ void stage_lane_tile(
    const KeyStages<P, DH, 1>& st, int kt, const PageView<P>& pv,
    const int* trow, int page_tokens, int kv_head, int limit, int j) {
  using M = StagedRows<P, DH>;
  const int lane = threadIdx.x & 31;
  const int key = kt * kTileKeys + lane;
  const int page = key <= limit ? trow[key / page_tokens] : -1;
  const long long row = key % page_tokens;
  const long long off =
      page < 0 ? -1
               : page * pv.page_stride + row * pv.tok_stride +
                     kv_head * pv.head_stride;
  if (j == 0) {
    st.page[lane] = page;
    if constexpr (kInt8Pages<P>) {
      if (page >= 0) {
        const long long so = page * pv.s_page_stride +
                             row * pv.s_tok_stride +
                             kv_head * pv.s_head_stride;
        cp_async4(st.k_scale + lane, pv.k_scale + so);
        cp_async4(st.v_scale + lane, pv.v_scale + so);
      }
    }
  }
  // 32 chunks a pass, warp j taking passes j, j + RW, ...
#pragma unroll 4
  for (int pass = j; pass < M::kChunks; pass += RW) {
    const int i = 32 * pass + lane;
    const int r = i / M::kChunks, c = i % M::kChunks;
    const long long o = __shfl_sync(kFullMask, off, r);
    const int dst = r * M::kPitch + 16 * c;
    if (o < 0) {
      *reinterpret_cast<uint4*>(st.v + dst) = make_uint4(0u, 0u, 0u, 0u);
      continue;
    }
    cp_async16(st.k + dst,
               reinterpret_cast<const uint8_t*>(pv.k + o) + 16 * c);
    cp_async16(st.v + dst,
               reinterpret_cast<const uint8_t*>(pv.v + o) + 16 * c);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// RW: warps a key lane (1, 2 or 4).
template <typename T, typename P, int DH, int RW>
__global__ void __launch_bounds__(kDecodeLanes<RW> * RW * 32)
    paged_decode_kernel(const T* __restrict__ q, PageView<P> pv,
                        const int* __restrict__ table,
                        const int* __restrict__ pos, T* __restrict__ out,
                        float* __restrict__ part, unsigned* __restrict__ ticket,
                        int heads, int groups, int max_pages, int page_tokens,
                        int row_tile, int splits, long long q_slot_stride,
                        long long q_head_stride, float scale) {
  using Sm = DecodeSmem<P, DH>;
  using Stage = typename Sm::Stage;
  extern __shared__ __align__(16) uint8_t smem[];
  constexpr int lanes = kDecodeLanes<RW>, warps = lanes * RW;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  // Warp w is warp j of key lane g: the lane's warps share its staged
  // tiles, warp j folding rows j, j + RW, ... of them.
  const int g = warp / RW, j = warp % RW;
  float* q_s = reinterpret_cast<float*>(smem);  // (row_tile, DH)
  auto stage_of = [&](int k) { return smem + Sm::kQ + k * Stage::kBytes; };
  const Stage st = Stage::at(stage_of(g));

  // The split is the grid's slowest index, so the blocks that fold (the
  // first splits) are dispatched before those that exit at once.
  const int batch = gridDim.z / splits;
  const int rt = blockIdx.x;
  const int kv_head = blockIdx.y;
  const int s = blockIdx.z % batch, split = blockIdx.z / batch;
  const int row0 = rt * row_tile;
  const int rows = min(row_tile, groups - row0);
  const int nr = warp_rows(rows, j, RW);  // rows this warp folds

  // The slot's keys: 0 .. pos[s], within the table.  Of the `splits`
  // blocks of this (row tile, KV head, slot), the first `used` (one per
  // `lanes` key tiles) share the tiles: this split folds [kt0, kt1), key
  // lane g the tiles kt0 + g, kt0 + g + lanes, ...
  const int limit = min(pos[s], max_pages * page_tokens - 1);
  const int n_tiles = limit < 0 ? 0 : limit / kTileKeys + 1;
  const int used = max(1, min(splits, (n_tiles + lanes - 1) / lanes));
  if (split >= used) return;  // whole block: no work, no ticket
  const int kt0 = split * n_tiles / used;
  const int kt1 = (split + 1) * n_tiles / used;
  const int* trow = table + (long long)s * max_pages;
  if (kt0 + g < kt1)
    stage_lane_tile<P, DH, RW>(st, kt0 + g, pv, trow, page_tokens, kv_head,
                               limit, j);
  stage_queries<T, DH>(q_s, q, s, kv_head, groups, row0, rows, q_slot_stride,
                       0, q_head_stride, scale);
  __syncthreads();  // the query rows are in

  float m[kRowsPerWarp], l[kRowsPerWarp];
  float acc[kRowsPerWarp][DH / 32];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    m[rr] = kNegInf;
    l[rr] = 0.f;
#pragma unroll
    for (int i = 0; i < DH / 32; ++i) acc[rr][i] = 0.f;
  }
  // Every row sees every mapped key of the tile (the staged page ids are
  // -1 past pos[s]).
  unsigned vis[kRowsPerWarp];
  for (int base = kt0; base < kt1; base += lanes) {
    const int kt = base + g;  // this lane's tile of the pass, if any
    if (base > kt0 && kt < kt1)
      stage_lane_tile<P, DH, RW>(st, kt, pv, trow, page_tokens, kv_head,
                                 limit, j);
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    lane_sync<RW>();  // the tile, page ids and scales are in
    const unsigned mapped =
        kt < kt1 ? __ballot_sync(kFullMask, st.page[lane] >= 0) : 0u;
    if (nr > 0 && mapped) {
#pragma unroll
      for (int rr = 0; rr < kRowsPerWarp; ++rr)
        vis[rr] = rr < nr ? mapped : 0u;
      fold_staged_tile<P, DH>(st, 0, mapped, vis, q_s, j, RW, nr, m, l, acc);
    }
    lane_sync<RW>();  // all done with the stage: it refills
  }

  // The key lanes' partials merge through shared memory: each warp writes
  // its rows' (acc, m, l) over its lane's stage (the lane's warps hold
  // other rows), then warp w merges rows w, w + warps, ... over the lanes.
  constexpr int kMl = kRowsPerWarp * DH;  // m, then l, after the sums
  float* mine = reinterpret_cast<float*>(stage_of(g));
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    if (rr >= nr) break;
    const int r = j + RW * rr;
#pragma unroll
    for (int i = 0; i < DH / 32; ++i)
      mine[r * DH + lane + 32 * i] = acc[rr][i];
    if (lane == 0) {
      mine[kMl + r] = m[rr];
      mine[kMl + kRowsPerWarp + r] = l[rr];
    }
  }
  __syncthreads();
  const int nm = warp_rows(rows, warp, warps);  // rows this warp merges
#pragma unroll
  for (int jj = 0; jj < kRowsPerWarp; ++jj) {
    if (jj >= nm) break;
    const int r = warp + warps * jj;
    float mx = kNegInf;
    for (int k = 0; k < lanes; ++k)
      mx = fmaxf(mx, reinterpret_cast<const float*>(stage_of(k))[kMl + r]);
    l[jj] = 0.f;
#pragma unroll
    for (int i = 0; i < DH / 32; ++i) acc[jj][i] = 0.f;
    for (int k = 0; k < lanes; ++k) {
      const float* theirs = reinterpret_cast<const float*>(stage_of(k));
      const float c = expf(theirs[kMl + r] - mx);
      l[jj] += theirs[kMl + kRowsPerWarp + r] * c;
#pragma unroll
      for (int i = 0; i < DH / 32; ++i)
        acc[jj][i] += theirs[r * DH + lane + 32 * i] * c;
    }
    m[jj] = mx;
  }

  // Output row of the warp's merged row jj: (slot, query head).
  auto out_row = [&](int jj) {
    return (long long)s * heads + kv_head * groups + row0 + warp + warps * jj;
  };
  if (used > 1) {
    unsigned* t =
        ticket + ((long long)s * gridDim.y + kv_head) * gridDim.x + rt;
    if (!merge_key_splits<DH>(part, t, split, used, splits,
                              (long long)batch * heads, nm, out_row, m, l,
                              acc))
      return;  // another split merges
  }
#pragma unroll
  for (int jj = 0; jj < kRowsPerWarp; ++jj) {
    if (jj >= nm) break;
    T* o = out + out_row(jj) * DH;
    const float denom = fmaxf(l[jj], 1e-30f);
#pragma unroll
    for (int i = 0; i < DH / 32; ++i)
      store_f32(o + lane + 32 * i, acc[jj][i] / denom);
  }
}

// What every launch refuses: an empty batch, heads that do not group, a
// row tile outside 1..kRowsPerWarp, or key splits without their scratch
// and tickets.
inline bool decode_args_ok(int batch, int heads, int kv_heads, int row_tile,
                           int splits, const float* part,
                           const unsigned* ticket) {
  return batch >= 1 && kv_heads >= 1 && heads % kv_heads == 0 &&
         row_tile >= 1 && row_tile <= kRowsPerWarp && splits >= 1 &&
         (splits == 1 || (part != nullptr && ticket != nullptr));
}

// Launch over pages of P with T queries: grid (row tiles, KV heads, slots
// x splits), block z = split * batch + slot, in key lanes of RW warps.
template <typename T, typename P, int DH, int RW>
int launch_decode_rw(const T* q, const PageView<P>& pv, const int* table,
                     const int* pos, T* out, float* part, unsigned* ticket,
                     int batch, int heads, int kv_heads, int max_pages,
                     int page_tokens, int row_tile, int splits,
                     long long q_slot_stride, long long q_head_stride,
                     float scale, cudaStream_t stream) {
  constexpr int lanes = kDecodeLanes<RW>;
  const auto kernel = paged_decode_kernel<T, P, DH, RW>;
  constexpr size_t bytes = DecodeSmem<P, DH>::bytes(lanes);
  const cudaError_t err = allow_smem<paged_decode_kernel<T, P, DH, RW>>(bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int groups = heads / kv_heads;
  const dim3 grid((groups + row_tile - 1) / row_tile, kv_heads,
                  batch * splits);
  kernel<<<grid, lanes * RW * 32, bytes, stream>>>(
      q, pv, table, pos, out, part, ticket, heads, groups, max_pages,
      page_tokens, row_tile, splits, q_slot_stride, q_head_stride, scale);
  return static_cast<int>(cudaGetLastError());
}

// The lanes' width for a row tile: the largest of 1, 2 and 4 within it.
template <typename T, typename P, int DH>
int launch_decode(const T* q, const PageView<P>& pv, const int* table,
                  const int* pos, T* out, float* part, unsigned* ticket,
                  int batch, int heads, int kv_heads, int max_pages,
                  int page_tokens, int row_tile, int splits,
                  long long q_slot_stride, long long q_head_stride,
                  float scale, cudaStream_t stream) {
  const auto launch = row_tile >= 4   ? launch_decode_rw<T, P, DH, 4>
                      : row_tile >= 2 ? launch_decode_rw<T, P, DH, 2>
                                      : launch_decode_rw<T, P, DH, 1>;
  return launch(q, pv, table, pos, out, part, ticket, batch, heads, kv_heads,
                max_pages, page_tokens, row_tile, splits, q_slot_stride,
                q_head_stride, scale, stream);
}

}  // namespace tpudp

// q: (b, 1, h, dh) with the given slot/head strides; out: contiguous
// (b, 1, h, dh); k/v: one layer's pages at k/v (+ layer_offset elements);
// pos: (b,) depths on the card.  row_tile: query heads a block (<= 4) of
// the heads / kv_heads reading one KV head.  part: float32 scratch of
// splits * b * h * (dh + 2) elements and ticket: b * kv_heads * row tiles
// zeroed counters (both unused, and may be null, when splits == 1).
extern "C" int launch_paged_decode(
    const void* q, const void* k, const void* v, const int* table,
    const int* pos, void* out, float* part, unsigned* ticket, int dtype_code,
    int batch, int heads, int kv_heads, int head_dim, int max_pages,
    int page_tokens, int row_tile, int splits, long long q_slot_stride,
    long long q_head_stride, long long layer_offset, long long page_stride,
    long long tok_stride, long long head_stride, float scale,
    cudaStream_t stream) {
  if (!tpudp::decode_args_ok(batch, heads, kv_heads, row_tile, splits, part,
                             ticket))
    return cudaErrorInvalidValue;
  TPUDP_DISPATCH(dtype_code, head_dim, {
    const scalar_t* kb = static_cast<const scalar_t*>(k) + layer_offset;
    const scalar_t* vb = static_cast<const scalar_t*>(v) + layer_offset;
    tpudp::PageView<scalar_t> pv{kb, vb, page_stride, tok_stride, head_stride};
    return tpudp::launch_decode<scalar_t, scalar_t, kDH>(
        static_cast<const scalar_t*>(q), pv, table, pos,
        static_cast<scalar_t*>(out), part, ticket, batch, heads, kv_heads,
        max_pages, page_tokens, row_tile, splits, q_slot_stride,
        q_head_stride, scale, stream);
  });
}

// As launch_paged_decode over an int8 pool: k/v int8 pages, k_scale/v_scale
// their float32 scales (+ scale_layer_offset elements, s_* strides); q and
// out are float32 or bf16 (dtype_code).
extern "C" int launch_paged_decode_int8(
    const void* q, const void* k, const void* v, const float* k_scale,
    const float* v_scale, const int* table, const int* pos, void* out,
    float* part, unsigned* ticket, int dtype_code, int batch, int heads,
    int kv_heads, int head_dim, int max_pages, int page_tokens, int row_tile,
    int splits, long long q_slot_stride, long long q_head_stride,
    long long layer_offset, long long page_stride, long long tok_stride,
    long long head_stride, long long scale_layer_offset,
    long long s_page_stride, long long s_tok_stride, long long s_head_stride,
    float scale, cudaStream_t stream) {
  if (!tpudp::decode_args_ok(batch, heads, kv_heads, row_tile, splits, part,
                             ticket))
    return cudaErrorInvalidValue;
  const tpudp::PageView<int8_t> pv = tpudp::int8_page_view(
      k, v, k_scale, v_scale, layer_offset, page_stride, tok_stride,
      head_stride, scale_layer_offset, s_page_stride, s_tok_stride,
      s_head_stride);
  TPUDP_DISPATCH(dtype_code, head_dim, {
    return tpudp::launch_decode<scalar_t, int8_t, kDH>(
        static_cast<const scalar_t*>(q), pv, table, pos,
        static_cast<scalar_t*>(out), part, ticket, batch, heads, kv_heads,
        max_pages, page_tokens, row_tile, splits, q_slot_stride,
        q_head_stride, scale, stream);
  });
}
