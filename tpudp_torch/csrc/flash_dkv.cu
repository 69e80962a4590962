// Flash-attention backward, key side, for Hopper (sm_90a):
// dv = sum_q p^T do and dk = scale * sum_q ds^T q, with
// p = exp(q k^T * scale - lse) recomputed from the forward's log-sum-exp,
// dp = do v^T, ds = p (dp - delta) and delta = rowsum(do o) computed
// beforehand by the caller.
//
// Replaces tpudp/ops/flash_attention.py:_dkv_kernel (launched by
// _flash_bwd_impl).  On the TPU the grid is (b * h, k blocks, q blocks)
// with the dk/dv accumulators in VMEM across the sequential q-block
// axis.  Here a block owns a tile of key rows, stages its k and v once
// and walks the query tiles from the diagonal on when causal (all of
// them otherwise), keeping dk and dv in registers.  Key tiles go out in
// natural order: the first ones walk the most query tiles.  dq is K2's
// (flash_dq.cu), so neither kernel needs atomics.
//
// Bound on this card: operations.  Causal GPT-2 small at t = 2048 does
// 8 * dh flops per visible (query, key) pair (s, dp, p^T do and ds^T q),
// 51.6 GFLOP per call at b = 4, h = 12: 0.052 ms at 989 TFLOP/s bf16,
// against 0.023 ms of bytes (q, k, v, do, lse, delta read once, dk and dv
// written once).  The launch function picks the kernel by dtype:
//
// * bfloat16 (the training path): flash_dkv_sm90_kernel, on the tensor
//   cores.  A block is one warpgroup owning 64 key rows (at dh 128 the
//   dk and dv accumulators alone take 128 f32 registers a thread; at dh
//   32 and 64 three blocks share an SM).  Its k and v tiles, then query
//   tiles of 64 rows of q and do, come by TMA from one thread (tensor
//   maps over the strided views, rows past t zero-filled) into swizzled
//   shared memory, the query side through a two-stage ring that loads one
//   tile ahead; the lse and delta rows of each query tile come beside
//   them by cp.async.  S^T = K Q^T and dP^T = V dO^T are wgmmas with both
//   operands K-major in shared memory; P^T = exp(scale S^T - lse) (masked
//   to 0, only on tiles that cross the diagonal or t) and dS^T = P^T
//   (dP^T - delta) are formed in f32 registers, rounded to bf16 there and
//   fed as wgmma's register A operand to dV += P^T dO and dK += dS^T Q,
//   with dO and Q read MN-major through the transpose bit: no score tile
//   goes through shared memory, and no atomics are needed.  Key tiles are
//   the grid's slow axis, so the first (the longest when causal) go first
//   over all heads.  dk is multiplied by the scale once, in f32, at the
//   store.  Rounding P^T and dS^T to bf16 is what the f32 version does
//   not do (ROADMAP Queue 3; bounded on the CPU by
//   tests/test_torch_flash_attention.py).
// * float32: flash_dkv_kernel, the first port's tile loop on the f32 CUDA
//   cores (q pre-scaled as it is staged, p^T and ds^T through padded f32
//   shared memory), kept because the f32 check holds the gradients to
//   1e-4, which TF32 tensor cores would not meet.  It is instantiated
//   for float32 only.
#include "flash_common.cuh"
#include "flash_sm90.cuh"

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

namespace sm90 {

// One warpgroup owns 64 key rows and walks query tiles of 64 rows.  The
// dk and dv accumulators (dh floats a thread) and the two 64 x 64 score
// tiles (64 floats) leave room for three blocks an SM at dh 32 and 64;
// small blocks, each with its own tiles, kept the tensor cores busier
// than blocks of two warpgroups sharing theirs.
template <int D>
struct DkvConfig {
  static constexpr int kBlockN = 64;
  static constexpr int kBlockM = 64;
  static constexpr int kThreads = 128;
  static constexpr int kMinBlocks = D == 128 ? 1 : 3;
  static constexpr int kStages = 2;  // of the query-side ring
  static constexpr int kKVBytes = kBlockN * D * 2;
  static constexpr int kQBytes = kBlockM * D * 2;
  // k, v, then the stages of q, of do and of the lse and delta rows, then
  // the mbarriers (k and v landed; stage i's q and do landed); 1024 bytes
  // of slack for the alignment of the swizzle atoms.
  static constexpr size_t kSmem = 2 * kKVBytes + 2 * kStages * kQBytes +
                                  2 * kStages * kBlockM * sizeof(float) +
                                  8 * (1 + kStages) + 1024;
};

template <int D>
__global__ void __launch_bounds__(DkvConfig<D>::kThreads, DkvConfig<D>::kMinBlocks)
    flash_dkv_sm90_kernel(const __grid_constant__ CUtensorMap q_map,
                          const __grid_constant__ CUtensorMap k_map,
                          const __grid_constant__ CUtensorMap v_map,
                          const __grid_constant__ CUtensorMap do_map,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta, Bthd<bf16> dk,
                          Bthd<bf16> dv, int t, int heads, int causal,
                          float scale) {
  using C = DkvConfig<D>;
  using G = TileGeom<D>;
  constexpr int BN = C::kBlockN, BM = C::kBlockM, S = C::kStages;
  constexpr int kON = G::kRowElems;  // N of one dV / dK product
  constexpr int kOC = G::kChunks;    // head-dim chunks of dk and dv
  extern __shared__ uint8_t smem_raw[];
  const uint32_t k_s = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t v_s = k_s + C::kKVBytes;
  const uint32_t q_s = v_s + C::kKVBytes;    // stage i at + i * kQBytes
  const uint32_t do_s = q_s + S * C::kQBytes;
  const uint32_t rows_s = do_s + S * C::kQBytes;  // lse[S][BM], delta[S][BM]
  const uint32_t kv_bar = rows_s + 2 * S * BM * 4;
  const uint32_t full = kv_bar + 8;  // stage i's q and do landed: + 8 i
  const float* lse_rows = reinterpret_cast<const float*>(
      smem_raw + (rows_s - smem_u32(smem_raw)));
  const float* delta_rows = lse_rows + S * BM;

  // Key tiles are the grid's slow axis, the first (the longest when
  // causal) issued first over all heads and batches.
  const int h = blockIdx.x % heads;
  const int b = blockIdx.x / heads;
  const int k0 = blockIdx.y * BN;
  const int lane = threadIdx.x % 32;
  // The thread's keys (krow, krow + 8) and first query column.
  const int krow = k0 + 16 * (threadIdx.x / 32) + lane / 4;
  const int col = 2 * (lane % 4);
  const long long bh = ((long long)b * heads + h) * t;
  const int first_qt = causal ? k0 / BM : 0;
  const int n_qt = (t + BM - 1) / BM;

  // Query tile qt into its ring stage: q and do by TMA from one thread,
  // the lse and delta rows by every thread's cp.async (one group).
  auto load_queries = [&](int qt) {
    const int q0 = qt * BM;
    const int stage = (qt - first_qt) % S;
    if (threadIdx.x == 0) {
      const uint32_t bar = full + 8 * stage;
      mbar_expect_tx(bar, 2 * C::kQBytes);
      tma_load_tile<D, BM>(q_s + stage * C::kQBytes, &q_map, b, h, q0, bar);
      tma_load_tile<D, BM>(do_s + stage * C::kQBytes, &do_map, b, h, q0, bar);
    }
    const int i = threadIdx.x;
    if (i < 2 * BM) {
      const int r = i % BM;
      const bool valid = q0 + r < t;
      const float* src = (i < BM ? lse : delta) + bh + (valid ? q0 + r : 0);
      cp_async4(rows_s + 4 * ((i < BM ? 0 : S * BM) + stage * BM + r), src,
                valid);
    }
    cp_async_commit();
  };

  if (threadIdx.x == 0) {
    for (int i = 0; i < 1 + S; ++i) mbar_init(kv_bar + 8 * i, 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect_tx(kv_bar, 2 * C::kKVBytes);
    tma_load_tile<D, BN>(k_s, &k_map, b, h, k0, kv_bar);
    tma_load_tile<D, BN>(v_s, &v_map, b, h, k0, kv_bar);
  }
  for (int qt = first_qt; qt < first_qt + S - 1; ++qt)
    if (qt < n_qt) load_queries(qt);

  const float sl2 = scale * kLog2e;
  float dk_acc[kOC][kON / 2], dv_acc[kOC][kON / 2];
#pragma unroll
  for (int c = 0; c < kOC; ++c)
#pragma unroll
    for (int i = 0; i < kON / 2; ++i) dk_acc[c][i] = dv_acc[c][i] = 0.f;

  for (int qt = first_qt; qt < n_qt; ++qt) {
    const int it = qt - first_qt;
    const int stage = it % S;
    if (qt + S - 1 < n_qt) {  // streams in while this tile is used
      load_queries(qt + S - 1);
      cp_async_wait<S - 1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // the lse and delta rows are in
    if (it == 0) mbar_wait(kv_bar, 0);
    mbar_wait(full + 8 * stage, (it / S) & 1);
    const int q0 = qt * BM;
    const uint32_t qt_s = q_s + stage * C::kQBytes;
    const uint32_t dot_s = do_s + stage * C::kQBytes;
    float s[32], dp[32];  // rows: keys, columns: queries
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      wgmma_ss_n64<0>(s, desc_k<D, BN>(k_s, 0, ks), desc_k<D, BM>(qt_s, 0, ks),
                      ks > 0);
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      wgmma_ss_n64<0>(dp, desc_k<D, BN>(v_s, 0, ks),
                      desc_k<D, BM>(dot_s, 0, ks), ks > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);

    const bool edge = q0 + BM > t || k0 + BN > t ||
                      (causal && q0 < k0 + BN - 1);
    const float* lse_t = lse_rows + stage * BM;
    const float* delta_t = delta_rows + stage * BM;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * j + col + e;
        const float lse2 = lse_t[c] * kLog2e;
        const float dlt = delta_t[c];
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int i = 4 * j + 2 * rr + e;
          const int kj = krow + 8 * rr;
          const int qi = q0 + c;
          const bool visible =
              !edge || (qi < t && kj < t && (!causal || kj <= qi));
          const float p =
              visible ? exp2_approx(fmaf(s[i], sl2, -lse2)) : 0.f;
          s[i] = p;
          dp[i] = p * (dp[i] - dlt);
        }
      }

    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BM / 16; ++kk) {
      uint32_t pa[4], dsa[4];
      frag_a(pa, s, kk);
      frag_a(dsa, dp, kk);
#pragma unroll
      for (int c = 0; c < kOC; ++c) {
        wgmma_rs<1>(dv_acc[c], pa, desc_mn<D, BM>(dot_s, c, kk));
        wgmma_rs<1>(dk_acc[c], dsa, desc_mn<D, BM>(qt_s, c, kk));
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < kOC; ++c) {
      fence_regs(dk_acc[c]);
      fence_regs(dv_acc[c]);
    }
    __syncthreads();  // every reader of this stage is done before reuse
  }

  bf16* dk_bh = dk.slice(b, h);
  bf16* dv_bh = dv.slice(b, h);
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int r = krow + 8 * rr;
    if (r >= t) continue;
    bf16* dk_row = dk_bh + (long long)r * dk.st;
    bf16* dv_row = dv_bh + (long long)r * dv.st;
#pragma unroll
    for (int c = 0; c < kOC; ++c)
#pragma unroll
      for (int j = 0; j < kON / 8; ++j) {
        const int i = 4 * j + 2 * rr;
        const int d = c * kON + 8 * j + col;
        store_bf16x2(dk_row + d, dk_acc[c][i] * scale,
                     dk_acc[c][i + 1] * scale);
        store_bf16x2(dv_row + d, dv_acc[c][i], dv_acc[c][i + 1]);
      }
  }
}

}  // namespace sm90

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
  if (dtype_code == 1) {  // bfloat16: the tensor-core kernel
    using bf16 = __nv_bfloat16;
    TPUDP_HEAD_DIM(head_dim, {
      using C = tpudp::sm90::DkvConfig<kDH>;
      CUtensorMap maps[4];  // q, k, v, do
      const void* bases[4] = {q, k, v, dout};
      for (int i = 0; i < 4; ++i) {
        const cudaError_t err = tpudp::sm90::make_tensor_map<kDH>(
            &maps[i], bases[i], strides[3 * i], strides[3 * i + 1],
            strides[3 * i + 2], batch, t, heads, 64);
        if (err != cudaSuccess) return static_cast<int>(err);
      }
      const dim3 grid(heads * batch, (t + C::kBlockN - 1) / C::kBlockN);
      return static_cast<int>(tpudp::sm90::launch(
          tpudp::sm90::flash_dkv_sm90_kernel<kDH>, grid, C::kThreads,
          C::kSmem, stream, maps[0], maps[1], maps[2], maps[3], lse, delta,
          tpudp::make_view<bf16>(dk, strides, 4),
          tpudp::make_view<bf16>(dv, strides, 5), t, heads, causal, scale));
    });
  }
  if (dtype_code != 0) return cudaErrorInvalidValue;
  TPUDP_HEAD_DIM(head_dim, {  // float32: the CUDA-core kernel
    using tpudp::kTile;
    const size_t bytes = (4 * kTile * (kDH + 1) +
                          2 * kTile * tpudp::kScorePitch + 2 * kTile) *
                         sizeof(float);
    return static_cast<int>(tpudp::launch_tiles(
        tpudp::flash_dkv_kernel<float, kDH>, bytes, t, heads, batch, stream,
        tpudp::make_view<const float>(q, strides, 0),
        tpudp::make_view<const float>(k, strides, 1),
        tpudp::make_view<const float>(v, strides, 2),
        tpudp::make_view<const float>(dout, strides, 3), lse, delta,
        tpudp::make_view<float>(dk, strides, 4),
        tpudp::make_view<float>(dv, strides, 5), t, heads, causal, scale));
  });
}
