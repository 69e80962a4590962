// Shared device code of the paged-attention kernels (paged_decode.cu,
// paged_window.cu, paged_tree.cu): the page view; the shared key tiles,
// whose blocks own every query row that reads one KV head and fold each
// 32-key tile of K/V, staged once in shared memory, into all of those
// rows (StagedRows, KeyStages, stage_keys, fold_key_tiles, row_scores,
// fold_tile); and the merge of a key split's partials in the launch
// (merge_key_splits).
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

// -- Shared key tiles (paged_window.cu, paged_tree.cu, paged_decode.cu)
//
// A block of kTileWarps warps owns up to kTileRows query rows that read
// one KV head; warp w folds rows w + kTileWarps * rr for rr < nr.  Key
// tiles of kTileKeys keys are staged in shared memory once for all of
// them: page ids resolved once a key, K and V rows copied by cp.async, 16
// bytes a thread along each row, into two stages, so the next tile
// streams in while this one is folded.  Scores run with lane = key (each
// lane reads its key's row once for all of its warp's rows), P.V with
// lane = output dims, both out of shared memory, in float32.  The decode
// kernel uses the same pieces the other way round: each key lane (one to
// four warps) stages and folds key tiles of its own into all of its
// block's rows.

constexpr int kTileWarps = 8;
constexpr int kRowsPerWarp = 4;
constexpr int kTileRows = kTileWarps * kRowsPerWarp;  // query rows a block
constexpr int kTileKeys = 32;                          // keys a tile, one a lane

// The padded row layout of a staged tile of P (the page element type):
// a row holds DH elements padded by 16 bytes, so the lanes of a quarter
// warp reading 16 bytes of eight consecutive rows hit 32 distinct banks
// (pitches of 4 mod 32 words at 4- and 2-byte elements and dh 64/128,
// 12 and 20 words at int8).  kQ: a block's query rows, float32.
template <typename P, int DH>
struct StagedRows {
  static constexpr int kChunks = DH * (int)sizeof(P) / 16;  // 16 B a row
  static constexpr int kN = 16 / (int)sizeof(P);            // elements a chunk
  static constexpr int kPitch = DH * (int)sizeof(P) + 16;   // bytes a row
  static constexpr int kTile = kTileKeys * kPitch;
  static constexpr int kQ = kTileRows * DH * 4;
};

// S stages (tile kt in stage kt % S) of staged key tiles in shared
// memory: K and V rows, each key's page id (-1: no weight) and, over
// int8 pages, its k_scale and v_scale, so the fold reads nothing from
// global memory.
template <typename P, int DH, int S = 2>
struct KeyStages {
  static constexpr int kScales = kInt8Pages<P> ? 2 : 0;
  static constexpr size_t kBytes =
      2 * S * StagedRows<P, DH>::kTile + S * kTileKeys * 4 * (1 + kScales);
  uint8_t* k;        // stage i at + i * kTile
  uint8_t* v;
  int* page;         // [S][kTileKeys]
  float* k_scale;    // [S][kTileKeys], int8 pages only
  float* v_scale;

  // The stages laid out from `base` (16-byte aligned), kBytes long.
  __device__ __forceinline__ static KeyStages at(uint8_t* base) {
    constexpr int kTile = StagedRows<P, DH>::kTile;
    int* page = reinterpret_cast<int*>(base + 2 * S * kTile);
    float* scales = reinterpret_cast<float*>(page + S * kTileKeys);
    return {base, base + S * kTile, page, scales, scales + S * kTileKeys};
  }
};

// 16 bytes global -> shared, asynchronously (L2 only).
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

// 4 bytes global -> shared, asynchronously.
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

// Key tile kt (keys kt * kTileKeys ..) into stage kt % 2, by every
// thread of the block: page ids once a key (-1 past `limit` or on an
// unmapped entry), K and V rows by cp.async, 16 bytes a thread along
// each row, and over int8 pages the key's two scales.  A key with no
// page gets a zero V row, which its zero weight in the P.V loop keeps
// finite.  Commits one cp.async group.
template <typename P, int DH>
__device__ __forceinline__ void stage_keys(const KeyStages<P, DH>& st, int kt,
                                           const PageView<P>& pv,
                                           const int* trow, int page_tokens,
                                           int kv_head, int limit) {
  using M = StagedRows<P, DH>;
  const int stage = kt & 1;
  const long long head_off = kv_head * pv.head_stride;
  for (int i = threadIdx.x; i < kTileKeys * M::kChunks; i += blockDim.x) {
    const int r = i / M::kChunks, c = i % M::kChunks;
    const int key = kt * kTileKeys + r;
    const int page = key <= limit ? trow[key / page_tokens] : -1;
    const long long row = key % page_tokens;
    if (c == 0) {
      st.page[stage * kTileKeys + r] = page;
      if constexpr (kInt8Pages<P>) {
        if (page >= 0) {
          const long long so = page * pv.s_page_stride +
                               row * pv.s_tok_stride +
                               kv_head * pv.s_head_stride;
          cp_async4(st.k_scale + stage * kTileKeys + r, pv.k_scale + so);
          cp_async4(st.v_scale + stage * kTileKeys + r, pv.v_scale + so);
        }
      }
    }
    const int dst = stage * M::kTile + r * M::kPitch + 16 * c;
    if (page < 0) {
      *reinterpret_cast<uint4*>(st.v + dst) = make_uint4(0u, 0u, 0u, 0u);
      continue;
    }
    const long long off =
        page * pv.page_stride + row * pv.tok_stride + head_off;
    cp_async16(st.k + dst, reinterpret_cast<const uint8_t*>(pv.k + off) +
                               16 * c);
    cp_async16(st.v + dst, reinterpret_cast<const uint8_t*>(pv.v + off) +
                               16 * c);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Scores of one staged row (lane's own: key or window node) against
// each of the warp's query rows: sc[rr] = q_row(rr) . row, for rr < nr,
// where q_row(rr) is row first + step * rr of q_s (a warp of the window
// and tree kernels folds rows warp + kTileWarps * rr; a decode warp all
// of its block's rows, 0, 1, ...).
template <typename P, int DH>
__device__ __forceinline__ void row_scores(const uint8_t* row,
                                           const float* q_s, int first,
                                           int nr,
                                           float (&sc)[kRowsPerWarp],
                                           int step = kTileWarps) {
  using M = StagedRows<P, DH>;
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) sc[rr] = 0.f;
#pragma unroll 4
  for (int c = 0; c < M::kChunks; ++c) {
    float x[M::kN];
    Vec16<P>::load(reinterpret_cast<const P*>(row + 16 * c), x);
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      if (rr >= nr) break;  // warp-uniform
      const float* qr = q_s + (first + step * rr) * DH + c * M::kN;
#pragma unroll
      for (int e = 0; e < M::kN; e += 4) {
        const float4 qv = *reinterpret_cast<const float4*>(qr + e);
        sc[rr] += qv.x * x[e] + qv.y * x[e + 1] + qv.z * x[e + 2] +
                  qv.w * x[e + 3];
      }
    }
  }
}

// Fold one tile into the warp's rows: lane i holds key i's score in
// sc[rr] (visible iff bit i of vis[rr], warp-uniform); v is the tile's
// staged V rows, all 32 finite (a key without a row has a zero one).
// v_scale is the lane's key's V scale over int8 pages: it joins the
// key's P.V weight, not the denominator.  The P.V loop runs over every
// key of the tile, unrolled, with the invisible ones at weight 0, so the
// V rows' shared-memory loads issue ahead of their products.
template <typename P, int DH>
__device__ __forceinline__ void fold_tile(
    const float (&sc)[kRowsPerWarp], const unsigned (&vis)[kRowsPerWarp],
    const uint8_t* v, float v_scale, int nr, float (&m)[kRowsPerWarp],
    float (&l)[kRowsPerWarp], float (&acc)[kRowsPerWarp][DH / 32]) {
  using M = StagedRows<P, DH>;
  const int lane = threadIdx.x & 31;
  float p[kRowsPerWarp];
  unsigned any = 0;
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    p[rr] = 0.f;
    if (rr >= nr || !vis[rr]) continue;  // warp-uniform
    const bool seen = (vis[rr] >> lane) & 1u;
    const float s = seen ? sc[rr] : kNegInf;
    const float m_new = fmaxf(m[rr], warp_max(s));
    const float alpha = expf(m[rr] - m_new);
    p[rr] = seen ? expf(s - m_new) : 0.f;
    l[rr] = l[rr] * alpha + warp_sum(p[rr]);
    if constexpr (kInt8Pages<P>) p[rr] *= v_scale;
#pragma unroll
    for (int i = 0; i < DH / 32; ++i) acc[rr][i] *= alpha;
    m[rr] = m_new;
    any |= vis[rr];
  }
  if (!any) return;  // warp-uniform
#pragma unroll 8
  for (int t = 0; t < kTileKeys; ++t) {
    const P* vr = reinterpret_cast<const P*>(v + t * M::kPitch);
    float vx[DH / 32];
#pragma unroll
    for (int i = 0; i < DH / 32; ++i) vx[i] = to_f32(vr[lane + 32 * i]);
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      if (rr >= nr) break;
      const float pt = __shfl_sync(kFullMask, p[rr], t);
#pragma unroll
      for (int i = 0; i < DH / 32; ++i) acc[rr][i] += pt * vx[i];
    }
  }
}

// Fold the tile staged in `stage` of st into the warp's rows (m, l,
// acc): rows first + step * rr of q_s for rr < nr (see row_scores), row
// rr seeing the tile's keys in vis[rr] (warp-uniform; mapped: the ballot
// of the staged page ids).  Over int8 pages the key's scale leaves the
// dot product (s = k_scale * sum q * k8: the dequantized dot in another
// summation order) and its v_scale joins the P.V weight.
template <typename P, int DH, int S>
__device__ __forceinline__ void fold_staged_tile(
    const KeyStages<P, DH, S>& st, int stage, unsigned mapped,
    const unsigned (&vis)[kRowsPerWarp], const float* q_s, int first,
    int step, int nr, float (&m)[kRowsPerWarp], float (&l)[kRowsPerWarp],
    float (&acc)[kRowsPerWarp][DH / 32]) {
  using M = StagedRows<P, DH>;
  const int lane = threadIdx.x & 31;
  float sc[kRowsPerWarp];
  row_scores<P, DH>(st.k + stage * M::kTile + lane * M::kPitch, q_s, first,
                    nr, sc, step);
  float v_scale = 1.f;
  if constexpr (kInt8Pages<P>) {
    const int slot = stage * kTileKeys + lane;
    const bool has = (mapped >> lane) & 1u;
    const float k_scale = has ? st.k_scale[slot] : 0.f;
    v_scale = has ? st.v_scale[slot] : 0.f;
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) sc[rr] *= k_scale;
  }
  fold_tile<P, DH>(sc, vis, st.v + stage * M::kTile, v_scale, nr, m, l, acc);
}

// Fold key tiles [kt0, kt1) into the warp's rows (m, l, acc): the caller
// has staged tile kt0 (stage_keys) so that its copy overlaps the caller's
// own staging of the query rows q_s, which the first barrier here
// covers.  visible(kt, mapped, vis) gives each row's 32-bit mask of the
// tile's keys (mapped: the ballot of the staged page ids), warp-uniform.
template <typename P, int DH, typename Visible>
__device__ __forceinline__ void fold_key_tiles(
    const KeyStages<P, DH>& st, const PageView<P>& pv, const int* trow,
    int page_tokens, int kv_head, int limit, int kt0, int kt1,
    const float* q_s, int warp, int nr, Visible visible,
    float (&m)[kRowsPerWarp], float (&l)[kRowsPerWarp],
    float (&acc)[kRowsPerWarp][DH / 32]) {
  const int lane = threadIdx.x & 31;
  unsigned vis[kRowsPerWarp];
  for (int kt = kt0; kt < kt1; ++kt) {
    if (kt + 1 < kt1) {  // streams in while this tile is folded
      stage_keys<P, DH>(st, kt + 1, pv, trow, page_tokens, kv_head, limit);
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();  // tile kt, its page ids and scales are in
    const int stage = kt & 1;
    const unsigned mapped =
        __ballot_sync(kFullMask, st.page[stage * kTileKeys + lane] >= 0);
    if (nr > 0 && mapped) {
      visible(kt, mapped, vis);
      fold_staged_tile<P, DH>(st, stage, mapped, vis, q_s, warp, kTileWarps,
                              nr, m, l, acc);
    }
    __syncthreads();  // every reader of this stage is done before reuse
  }
}

// The block's query rows, pre-scaled, float32: row i of q_s is flattened
// row row0 + i, i.e. window position (row0 + i) / groups at query head
// kv_head * groups + (row0 + i) % groups.
template <typename T, int DH>
__device__ __forceinline__ void stage_queries(
    float* q_s, const T* q, int s, int kv_head, int groups, int row0,
    int rows, long long q_slot_stride, long long q_row_stride,
    long long q_head_stride, float scale) {
  for (int i = threadIdx.x; i < rows * DH; i += blockDim.x) {
    const int r = row0 + i / DH, d = i % DH;
    const T* qr = q + s * q_slot_stride + (r / groups) * q_row_stride +
                  (kv_head * groups + r % groups) * q_head_stride;
    q_s[i] = to_f32(qr[d]) * scale;
  }
}

// How many of a block's `rows` rows warp `warp` of `warps` folds, rows
// warp, warp + warps, ...
__device__ __forceinline__ int warp_rows(int rows, int warp,
                                         int warps = kTileWarps) {
  return rows > warp ? (rows - warp + warps - 1) / warps : 0;
}

// The merge of a key split, in the launch.  The first `used` of a row
// group's `splits` blocks (split = 0 .. used - 1) each hold a partial
// (m, l, acc) of the warp's nr rows, row rr written to output row
// out_row(rr) of n_out; part is float32 scratch of splits * n_out *
// (DH + 2) elements: (splits, n_out, DH) sums, then (splits, n_out, 2)
// maxima and denominators.  Each block stores its partials, then takes
// the group's ticket after a __threadfence; the last to arrive resets the
// ticket to 0 for the next launch and merges every partial in split
// order (its own from the scratch too, so the output does not depend on
// which split merges), leaving the merged (m, l, acc) in the warp's rows
// and returning true.  The other blocks return false and are done.
template <int DH, typename OutRow>
__device__ __forceinline__ bool merge_key_splits(
    float* part, unsigned* ticket, int split, int used, int splits,
    long long n_out, int nr, OutRow out_row, float (&m)[kRowsPerWarp],
    float (&l)[kRowsPerWarp], float (&acc)[kRowsPerWarp][DH / 32]) {
  __shared__ int last;
  const int lane = threadIdx.x & 31;
  float* part_acc = part;                       // (splits, n_out, DH)
  float2* part_ml =
      reinterpret_cast<float2*>(part + splits * n_out * DH);  // (.., 2)
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    if (rr >= nr) break;
    const long long o = split * n_out + out_row(rr);
#pragma unroll
    for (int i = 0; i < DH / 32; ++i)
      part_acc[o * DH + lane + 32 * i] = acc[rr][i];
    if (lane == 0) part_ml[o] = make_float2(m[rr], l[rr]);
  }
  __threadfence();  // the partial is visible before the ticket is taken
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(ticket, 1u) == (unsigned)used - 1;
    if (last) *ticket = 0;  // every split has taken its ticket: reset
  }
  __syncthreads();
  if (!last) return false;
  __threadfence();
  // One pass, rescaling the running sums as the maximum grows.
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    if (rr >= nr) break;
    const long long o = out_row(rr);
    m[rr] = kNegInf;
    l[rr] = 0.f;
#pragma unroll
    for (int i = 0; i < DH / 32; ++i) acc[rr][i] = 0.f;
#pragma unroll 4
    for (int sp = 0; sp < used; ++sp) {
      const long long po = sp * n_out + o;
      const float2 part_m_l = __ldcg(part_ml + po);
      float part_acc_i[DH / 32];
#pragma unroll
      for (int i = 0; i < DH / 32; ++i)
        part_acc_i[i] = __ldcg(part_acc + po * DH + lane + 32 * i);
      const float m_new = fmaxf(m[rr], part_m_l.x);
      const float alpha = expf(m[rr] - m_new);
      const float w = expf(part_m_l.x - m_new);
      l[rr] = l[rr] * alpha + part_m_l.y * w;
#pragma unroll
      for (int i = 0; i < DH / 32; ++i)
        acc[rr][i] = acc[rr][i] * alpha + part_acc_i[i] * w;
      m[rr] = m_new;
    }
  }
  return true;
}

}  // namespace tpudp
