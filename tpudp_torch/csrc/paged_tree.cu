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
// nodes times the `groups` query heads sharing it, up to kTreeRows of
// them (wider tiles, past 32 rows, take further blocks), each of its
// warps folding up to kTreeRowsPerWarp rows.  The block walks the slot's
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
// check's 2e-5).
#include "paged_common.cuh"

namespace tpudp {

constexpr int kTreeWarps = 8;
constexpr int kTreeRowsPerWarp = 4;
constexpr int kTreeRows = kTreeWarps * kTreeRowsPerWarp;  // rows a block
constexpr int kTreeKeys = 32;  // keys a tile, one a lane

// Shared memory of a block: its query rows (float32, pre-scaled), two
// stages of K and V tiles, the window K and V, and each stage's page ids
// (-1: no weight).  A staged row holds DH elements of T padded to a
// 16-byte multiple plus 16 bytes, so the lanes of a quarter warp reading
// 16 bytes of eight rows hit 32 distinct banks.
template <typename T, int DH>
struct TreeSmem {
  static constexpr int kChunks = DH * (int)sizeof(T) / 16;  // 16 B a row
  static constexpr int kN = 16 / (int)sizeof(T);            // elements a chunk
  static constexpr int kPitch = DH * (int)sizeof(T) + 16;   // bytes a row
  static constexpr int kTile = kTreeKeys * kPitch;
  static constexpr int kQ = kTreeRows * DH * 4;
  static constexpr size_t kBytes = kQ + 6 * kTile + 2 * kTreeKeys * 4;
};

// 16 bytes global -> shared, asynchronously (L2 only).
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

// Scores of one staged row (lane's own: key or window node) against
// each of the warp's query rows: sc[rr] = q_row(rr) . row, for rr < nr.
template <typename T, int DH>
__device__ __forceinline__ void row_scores(const uint8_t* row,
                                           const float* q_s, int warp,
                                           int nr,
                                           float (&sc)[kTreeRowsPerWarp]) {
  using M = TreeSmem<T, DH>;
#pragma unroll
  for (int rr = 0; rr < kTreeRowsPerWarp; ++rr) sc[rr] = 0.f;
#pragma unroll 4
  for (int c = 0; c < M::kChunks; ++c) {
    float x[M::kN];
    Vec16<T>::load(reinterpret_cast<const T*>(row + 16 * c), x);
#pragma unroll
    for (int rr = 0; rr < kTreeRowsPerWarp; ++rr) {
      if (rr >= nr) break;  // warp-uniform
      const float* qr = q_s + (warp + kTreeWarps * rr) * DH + c * M::kN;
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
// sc[rr] (visible iff bit i of vis[rr]); v is the tile's staged V rows.
template <typename T, int DH>
__device__ __forceinline__ void fold_tile(
    const float (&sc)[kTreeRowsPerWarp], const unsigned (&vis)[kTreeRowsPerWarp],
    const uint8_t* v, int nr, float (&m)[kTreeRowsPerWarp],
    float (&l)[kTreeRowsPerWarp], float (&acc)[kTreeRowsPerWarp][DH / 32]) {
  using M = TreeSmem<T, DH>;
  const int lane = threadIdx.x & 31;
  float p[kTreeRowsPerWarp];
  unsigned any = 0;
#pragma unroll
  for (int rr = 0; rr < kTreeRowsPerWarp; ++rr) {
    p[rr] = 0.f;
    if (rr >= nr || !vis[rr]) continue;  // warp-uniform
    const bool seen = (vis[rr] >> lane) & 1u;
    const float s = seen ? sc[rr] : kNegInf;
    const float m_new = fmaxf(m[rr], warp_max(s));
    const float alpha = expf(m[rr] - m_new);
    p[rr] = seen ? expf(s - m_new) : 0.f;
    l[rr] = l[rr] * alpha + warp_sum(p[rr]);
#pragma unroll
    for (int i = 0; i < DH / 32; ++i) acc[rr][i] *= alpha;
    m[rr] = m_new;
    any |= vis[rr];
  }
  for (unsigned bits = any; bits; bits &= bits - 1) {  // warp-uniform
    const int t = __ffs(bits) - 1;
    const T* vr = reinterpret_cast<const T*>(v + t * M::kPitch);
    float vx[DH / 32];
#pragma unroll
    for (int i = 0; i < DH / 32; ++i) vx[i] = to_f32(vr[lane + 32 * i]);
#pragma unroll
    for (int rr = 0; rr < kTreeRowsPerWarp; ++rr) {
      if (rr >= nr) break;
      const float pt = __shfl_sync(kFullMask, p[rr], t);
#pragma unroll
      for (int i = 0; i < DH / 32; ++i) acc[rr][i] += pt * vx[i];
    }
  }
}

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
  using M = TreeSmem<T, DH>;
  extern __shared__ __align__(16) uint8_t smem[];
  float* q_s = reinterpret_cast<float*>(smem);  // (kTreeRows, DH)
  uint8_t* k_t = smem + M::kQ;                  // stage i at + i * kTile
  uint8_t* v_t = k_t + 2 * M::kTile;
  uint8_t* wk_t = v_t + 2 * M::kTile;
  uint8_t* wv_t = wk_t + M::kTile;
  int* pg_s = reinterpret_cast<int*>(wv_t + M::kTile);  // [2][kTreeKeys]

  const int kv_head = blockIdx.y;
  const int s = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row0 = blockIdx.x * kTreeRows;  // of the t1 * groups rows
  const int rows = min(kTreeRows, t1 * groups - row0);
  // The warp's rows: warp + kTreeWarps * rr for rr < nr.
  const int nr = rows > warp ? (rows - warp + kTreeWarps - 1) / kTreeWarps : 0;

  // The block's query rows, pre-scaled: row r is node (row0 + r) / groups
  // at query head kv_head * groups + (row0 + r) % groups.
  for (int i = threadIdx.x; i < rows * DH; i += blockDim.x) {
    const int r = row0 + i / DH, d = i % DH;
    const T* qr = q + s * q_slot_stride + (r / groups) * q_row_stride +
                  (kv_head * groups + r % groups) * q_head_stride;
    q_s[i] = to_f32(qr[d]) * scale;
  }
  // The window K/V rows of this KV head, staged once.
  const long long w_base = s * w_slot_stride + kv_head * w_head_stride;
  for (int i = threadIdx.x; i < t1 * DH; i += blockDim.x) {
    const int j = i / DH, d = i % DH;
    const long long src = w_base + j * w_row_stride + d;
    reinterpret_cast<T*>(wk_t + j * M::kPitch)[d] = wk[src];
    reinterpret_cast<T*>(wv_t + j * M::kPitch)[d] = wv[src];
  }

  // Strict visibility: cache keys 0 .. pos0 - 1 (none when pos0 <= 0).
  const int limit = min(pos0[s] - 1, max_pages * page_tokens - 1);
  const int n_tiles = limit < 0 ? 0 : limit / kTreeKeys + 1;
  const int* trow = table + (long long)s * max_pages;
  const long long head_off = kv_head * pv.head_stride;
  // Key tile kt into stage kt % 2: page ids once a key, K and V rows by
  // cp.async, 16 bytes a thread along each row.
  auto load_tile = [&](int kt) {
    const int stage = kt & 1;
    for (int i = threadIdx.x; i < kTreeKeys * M::kChunks; i += blockDim.x) {
      const int r = i / M::kChunks, c = i % M::kChunks;
      const int key = kt * kTreeKeys + r;
      const int page = key <= limit ? trow[key / page_tokens] : -1;
      if (c == 0) pg_s[stage * kTreeKeys + r] = page;
      if (page < 0) continue;
      const long long off = page * pv.page_stride +
                            (long long)(key % page_tokens) * pv.tok_stride +
                            head_off;
      const int dst = stage * M::kTile + r * M::kPitch + 16 * c;
      cp_async16(k_t + dst, reinterpret_cast<const uint8_t*>(pv.k + off) +
                                16 * c);
      cp_async16(v_t + dst, reinterpret_cast<const uint8_t*>(pv.v + off) +
                                16 * c);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  float m[kTreeRowsPerWarp], l[kTreeRowsPerWarp];
  float acc[kTreeRowsPerWarp][DH / 32];
#pragma unroll
  for (int rr = 0; rr < kTreeRowsPerWarp; ++rr) {
    m[rr] = kNegInf;
    l[rr] = 0.f;
#pragma unroll
    for (int i = 0; i < DH / 32; ++i) acc[rr][i] = 0.f;
  }
  float sc[kTreeRowsPerWarp];
  unsigned vis[kTreeRowsPerWarp];

  if (n_tiles > 0) load_tile(0);
  for (int kt = 0; kt < n_tiles; ++kt) {
    if (kt + 1 < n_tiles) {  // streams in while this tile is folded
      load_tile(kt + 1);
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();  // tile kt and its page ids are in
    const int stage = kt & 1;
    const unsigned mapped =
        __ballot_sync(kFullMask, pg_s[stage * kTreeKeys + lane] >= 0);
    if (nr > 0 && mapped) {
      row_scores<T, DH>(k_t + stage * M::kTile + lane * M::kPitch, q_s, warp,
                        nr, sc);
#pragma unroll
      for (int rr = 0; rr < kTreeRowsPerWarp; ++rr) vis[rr] = mapped;
      fold_tile<T, DH>(sc, vis, v_t + stage * M::kTile, nr, m, l, acc);
    }
    __syncthreads();  // every reader of this stage is done before reuse
  }
  __syncthreads();  // the query rows and the window are in

  // The window tile: lane c is node c, seen by row r iff c is an
  // ancestor of the row's node or the node itself.
  if (nr > 0) {
    row_scores<T, DH>(wk_t + min(lane, t1 - 1) * M::kPitch, q_s, warp, nr,
                      sc);
#pragma unroll
    for (int rr = 0; rr < kTreeRowsPerWarp; ++rr) {
      const int node = (row0 + warp + kTreeWarps * rr) / groups;
      vis[rr] = rr < nr ? anc[node] & (t1 == 32 ? ~0u : (1u << t1) - 1) : 0u;
    }
    fold_tile<T, DH>(sc, vis, wv_t, nr, m, l, acc);
  }

#pragma unroll
  for (int rr = 0; rr < kTreeRowsPerWarp; ++rr) {
    if (rr >= nr) break;
    const int r = row0 + warp + kTreeWarps * rr;
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
  const dim3 grid((t1 * groups + tpudp::kTreeRows - 1) / tpudp::kTreeRows,
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
    kernel<<<grid, tpudp::kTreeWarps * 32, bytes, stream>>>(
        static_cast<const scalar_t*>(q), pv, table, pos0,
        static_cast<const scalar_t*>(wk), static_cast<const scalar_t*>(wv),
        anc, static_cast<scalar_t*>(out), t1, heads, groups, max_pages,
        page_tokens, q_slot_stride, q_row_stride, q_head_stride,
        w_slot_stride, w_row_stride, w_head_stride, scale);
  });
  return static_cast<int>(cudaGetLastError());
}
