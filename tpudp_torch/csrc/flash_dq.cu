// Flash-attention backward, query side, for Hopper (sm_90a):
// dq = scale * sum_k ds k, with p = exp(q k^T * scale - lse) recomputed
// from the forward's log-sum-exp, dp = do v^T and ds = p (dp - delta),
// delta = rowsum(do o) computed beforehand by the caller.
//
// Replaces tpudp/ops/flash_attention.py:_dq_kernel (launched by
// _flash_bwd_impl).  On the TPU the grid is (b * h, q blocks, k blocks)
// with the dq accumulator in VMEM across the sequential k-block axis.
// Here a block owns a tile of query rows, stages its q and do once,
// walks the K/V tiles up to the diagonal when causal (all of them
// otherwise) and keeps dq in registers.  dq is scaled once, at the
// store, as the TPU kernel does; splitting dq from dk/dv (flash_dkv.cu)
// is what keeps both kernels free of atomics.
//
// Bound on this card: operations.  Causal GPT-2 small at t = 2048 does
// 6 * dh flops per visible (query, key) pair (s, dp and ds k), 38.7 GFLOP
// per call at b = 4, h = 12: 0.039 ms at 989 TFLOP/s bf16, against
// 0.019 ms of bytes (q, k, v, do, lse, delta read once, dq written once).
// The launch function picks the kernel by dtype:
//
// * bfloat16 (the training path): flash_dq_sm90_kernel, on the tensor
//   cores, K3's design with the roles of queries and keys swapped.  A
//   block is one warpgroup owning 64 query rows; its q and do tiles come
//   once by TMA from one thread (tensor maps over the strided views, rows
//   past t zero-filled) into swizzled shared memory, and its rows of lse
//   and delta sit in registers.  K/V tiles of 64 keys stream through a
//   two-stage TMA ring that loads one tile ahead.  S = Q K^T and dP =
//   dO V^T are wgmmas with both operands K-major in shared memory; P =
//   exp2(S scale log2e - lse log2e) (masked to 0, only on tiles that
//   cross the diagonal or t) and dS = P (dP - delta) are formed in f32
//   registers, dS is rounded to bf16 there and fed as wgmma's register A
//   operand to dQ += dS K, with K read MN-major through the transpose
//   bit: no score tile goes through shared memory.  The only accumulator
//   is dq (dh / 2 f32 registers a thread, half of K3's), so three blocks
//   share an SM at dh 32 and 64, two at dh 128.  Query tiles are the
//   grid's slow axis, the last (the longest when causal) first over all
//   heads.  Rounding dS to bf16 is what the f32 version does not do
//   (ROADMAP Queue 3; bounded on the CPU by
//   tests/test_torch_flash_attention.py).
// * float32: flash_dq_kernel, the first port's tile loop on the f32 CUDA
//   cores (q pre-scaled as it is staged, ds through padded f32 shared
//   memory on its way into the ds k product), kept because the f32 check
//   holds the gradients to 1e-4, which TF32 tensor cores would not meet.
//   It is instantiated for float32 only.
#include "flash_common.cuh"
#include "flash_sm90.cuh"

namespace tpudp {

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_dq_kernel(Bthd<const T> q, Bthd<const T> k, Bthd<const T> v,
                    Bthd<const T> dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, Bthd<T> dq, int t,
                    int heads, int causal, float scale) {
  extern __shared__ float smem[];
  float* q_s = smem;                     // (kTile, D + 1), pre-scaled
  float* do_s = q_s + kTile * (D + 1);   // (kTile, D + 1)
  float* k_s = do_s + kTile * (D + 1);   // (kTile, D + 1)
  float* v_s = k_s + kTile * (D + 1);    // (kTile, D + 1)
  float* ds_s = v_s + kTile * (D + 1);   // (kTile, kScorePitch)
  const int n_tiles = gridDim.x;
  const int qt = n_tiles - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
  const int q0 = qt * kTile;

  load_tile<T, D>(q_s, q.slice(b, h), q.st, q0, t, scale);
  load_tile<T, D>(do_s, dout.slice(b, h), dout.st, q0, t, 1.f);
  const long long bh = ((long long)b * heads + h) * t;
  float lse_r[kSub], delta_r[kSub], acc[kSub][D / 16];
#pragma unroll
  for (int i = 0; i < kSub; ++i) {
    const int r = q0 + ty + 16 * i;
    lse_r[i] = r < t ? lse[bh + r] : 0.f;
    delta_r[i] = r < t ? delta[bh + r] : 0.f;
#pragma unroll
    for (int j = 0; j < D / 16; ++j) acc[i][j] = 0.f;
  }

  const int k_tiles = causal ? qt + 1 : n_tiles;
  for (int kt = 0; kt < k_tiles; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // every reader of the previous K/V and ds tiles is done
    load_tile<T, D>(k_s, k.slice(b, h), k.st, k0, t, 1.f);
    load_tile<T, D>(v_s, v.slice(b, h), v.st, k0, t, 1.f);
    __syncthreads();
    float s[kSub][kSub], dp[kSub][kSub];
    tile_dots<D>(s, q_s, k_s, ty, tx);
    tile_dots<D>(dp, do_s, v_s, ty, tx);
#pragma unroll
    for (int i = 0; i < kSub; ++i) {
      const int qi = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < kSub; ++j) {
        const float p = visible(qi, k0 + tx + 16 * j, t, causal)
                            ? expf(s[i][j] - lse_r[i])
                            : 0.f;
        ds_s[(ty + 16 * i) * kScorePitch + tx + 16 * j] =
            p * (dp[i][j] - delta_r[i]);
      }
    }
    __syncthreads();
    tile_matmul_acc<D>(acc, ds_s, k_s, ty, tx);
  }
  store_tile<T, D>(dq.slice(b, h), dq.st, q0, t, acc, ty, tx, scale);
}

namespace sm90 {

// One warpgroup owns 64 query rows and walks key tiles of 64 rows.  The
// dq accumulator (dh / 2 floats a thread) and the two 64 x 64 score
// tiles leave room for three blocks an SM at dh 32 and 64.
template <int D>
struct DqConfig {
  static constexpr int kBlockM = 64;
  static constexpr int kBlockN = 64;
  static constexpr int kThreads = 128;
  static constexpr int kMinBlocks = D == 128 ? 2 : 3;
  static constexpr int kStages = 2;  // of the key-side ring
  static constexpr int kQBytes = kBlockM * D * 2;
  static constexpr int kKVBytes = kBlockN * D * 2;
  // q, do, then the stages of k and of v, then the mbarriers (q and do
  // landed; stage i's k and v landed); 1024 bytes of slack for the
  // alignment of the swizzle atoms.
  static constexpr size_t kSmem =
      2 * kQBytes + 2 * kStages * kKVBytes + 8 * (1 + kStages) + 1024;
};

template <int D>
__global__ void __launch_bounds__(DqConfig<D>::kThreads, DqConfig<D>::kMinBlocks)
    flash_dq_sm90_kernel(const __grid_constant__ CUtensorMap q_map,
                         const __grid_constant__ CUtensorMap k_map,
                         const __grid_constant__ CUtensorMap v_map,
                         const __grid_constant__ CUtensorMap do_map,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta, Bthd<bf16> dq,
                         int t, int heads, int causal, float scale) {
  using C = DqConfig<D>;
  using G = TileGeom<D>;
  constexpr int BM = C::kBlockM, BN = C::kBlockN, S = C::kStages;
  constexpr int kON = G::kRowElems;  // N of one dQ product
  constexpr int kOC = G::kChunks;    // head-dim chunks of dq
  extern __shared__ uint8_t smem_raw[];
  const uint32_t q_s = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t do_s = q_s + C::kQBytes;
  const uint32_t k_s = do_s + C::kQBytes;       // stage i at
  const uint32_t v_s = k_s + S * C::kKVBytes;   // + i * kKVBytes in each
  const uint32_t q_bar = v_s + S * C::kKVBytes;
  const uint32_t full = q_bar + 8;  // stage i's k and v landed: + 8 i

  // Query tiles are the grid's slow axis, the last (the longest when
  // causal) issued first over all heads and batches.
  const int qt = gridDim.y - 1 - blockIdx.y;
  const int h = blockIdx.x % heads;
  const int b = blockIdx.x / heads;
  const int q0 = qt * BM;
  const int lane = threadIdx.x % 32;
  // The thread's query rows (qrow, qrow + 8) and first key column.
  const int qrow = q0 + 16 * (threadIdx.x / 32) + lane / 4;
  const int col = 2 * (lane % 4);
  const int kv_end = causal ? min(q0 + BM, t) : t;
  const int n_kt = (kv_end + BN - 1) / BN;
  // One thread issues the TMA loads of key tile kt into its stage.
  auto load_kv = [&](int kt) {
    const uint32_t bar = full + 8 * (kt % S);
    mbar_expect_tx(bar, 2 * C::kKVBytes);
    tma_load_tile<D, BN>(k_s + (kt % S) * C::kKVBytes, &k_map, b, h, kt * BN,
                         bar);
    tma_load_tile<D, BN>(v_s + (kt % S) * C::kKVBytes, &v_map, b, h, kt * BN,
                         bar);
  };

  if (threadIdx.x == 0) {
    for (int i = 0; i < 1 + S; ++i) mbar_init(q_bar + 8 * i, 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect_tx(q_bar, 2 * C::kQBytes);
    tma_load_tile<D, BM>(q_s, &q_map, b, h, q0, q_bar);
    tma_load_tile<D, BM>(do_s, &do_map, b, h, q0, q_bar);
    for (int kt = 0; kt < S - 1 && kt < n_kt; ++kt) load_kv(kt);
  }
  // The thread's rows of lse (in base 2) and delta.
  const long long bh = ((long long)b * heads + h) * t;
  float lse2[2], dlt[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int r = qrow + 8 * rr;
    lse2[rr] = r < t ? lse[bh + r] * kLog2e : 0.f;
    dlt[rr] = r < t ? delta[bh + r] : 0.f;
  }

  const float sl2 = scale * kLog2e;
  float dq_acc[kOC][kON / 2];
#pragma unroll
  for (int c = 0; c < kOC; ++c)
#pragma unroll
    for (int i = 0; i < kON / 2; ++i) dq_acc[c][i] = 0.f;

  mbar_wait(q_bar, 0);
  for (int kt = 0; kt < n_kt; ++kt) {
    if (threadIdx.x == 0 && kt + S - 1 < n_kt)
      load_kv(kt + S - 1);  // streams in while this tile is used
    mbar_wait(full + 8 * (kt % S), (kt / S) & 1);
    const int k0 = kt * BN;
    const uint32_t kt_s = k_s + (kt % S) * C::kKVBytes;
    const uint32_t vt_s = v_s + (kt % S) * C::kKVBytes;
    float s[32], dp[32];  // rows: queries, columns: keys
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      wgmma_ss_n64<0>(s, desc_k<D, BM>(q_s, 0, ks), desc_k<D, BN>(kt_s, 0, ks),
                      ks > 0);
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      wgmma_ss_n64<0>(dp, desc_k<D, BM>(do_s, 0, ks),
                      desc_k<D, BN>(vt_s, 0, ks), ks > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);

    const bool edge = q0 + BM > t || k0 + BN > t ||
                      (causal && k0 + BN - 1 > q0);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int rr = (i >> 1) & 1;
      const int qi = qrow + 8 * rr;
      const int kj = k0 + 8 * (i >> 2) + col + (i & 1);
      const bool visible =
          !edge || (qi < t && kj < t && (!causal || kj <= qi));
      const float p =
          visible ? exp2_approx(fmaf(s[i], sl2, -lse2[rr])) : 0.f;
      dp[i] = p * (dp[i] - dlt[rr]);
    }

    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      uint32_t dsa[4];
      frag_a(dsa, dp, kk);
#pragma unroll
      for (int c = 0; c < kOC; ++c)
        wgmma_rs<1>(dq_acc[c], dsa, desc_mn<D, BN>(kt_s, c, kk));
    }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < kOC; ++c) fence_regs(dq_acc[c]);
    __syncthreads();  // every reader of this stage is done before reuse
  }

  bf16* dq_bh = dq.slice(b, h);
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int r = qrow + 8 * rr;
    if (r >= t) continue;
    bf16* dq_row = dq_bh + (long long)r * dq.st;
#pragma unroll
    for (int c = 0; c < kOC; ++c)
#pragma unroll
      for (int j = 0; j < kON / 8; ++j) {
        const int i = 4 * j + 2 * rr;
        store_bf16x2(dq_row + c * kON + 8 * j + col, dq_acc[c][i] * scale,
                     dq_acc[c][i + 1] * scale);
      }
  }
}

}  // namespace sm90

}  // namespace tpudp

// q, k, v, do: (b, t, h, dh) read through strides; lse, delta: contiguous
// (b, h, t) float32; dq: (b, t, h, dh) written through strides.  strides
// holds the (batch, token, head) element strides of q, k, v, do, dq.
extern "C" int launch_flash_dq(const void* q, const void* k, const void* v,
                               const void* dout, const float* lse,
                               const float* delta, void* dq,
                               const long long* strides, int dtype_code,
                               int batch, int t, int heads, int head_dim,
                               int causal, float scale, cudaStream_t stream) {
  if (batch < 1 || t < 1 || heads < 1) return cudaErrorInvalidValue;
  if (dtype_code == 1) {  // bfloat16: the tensor-core kernel
    using bf16 = __nv_bfloat16;
    TPUDP_HEAD_DIM(head_dim, {
      using C = tpudp::sm90::DqConfig<kDH>;
      CUtensorMap maps[4];  // q, k, v, do
      const void* bases[4] = {q, k, v, dout};
      for (int i = 0; i < 4; ++i) {
        const cudaError_t err = tpudp::sm90::make_tensor_map<kDH>(
            &maps[i], bases[i], strides[3 * i], strides[3 * i + 1],
            strides[3 * i + 2], batch, t, heads, 64);
        if (err != cudaSuccess) return static_cast<int>(err);
      }
      const dim3 grid(heads * batch, (t + C::kBlockM - 1) / C::kBlockM);
      return static_cast<int>(tpudp::sm90::launch(
          tpudp::sm90::flash_dq_sm90_kernel<kDH>, grid, C::kThreads, C::kSmem,
          stream, maps[0], maps[1], maps[2], maps[3], lse, delta,
          tpudp::make_view<bf16>(dq, strides, 4), t, heads, causal, scale));
    });
  }
  if (dtype_code != 0) return cudaErrorInvalidValue;
  TPUDP_HEAD_DIM(head_dim, {  // float32: the CUDA-core kernel
    using tpudp::kTile;
    const size_t bytes =
        (4 * kTile * (kDH + 1) + kTile * tpudp::kScorePitch) * sizeof(float);
    return static_cast<int>(tpudp::launch_tiles(
        tpudp::flash_dq_kernel<float, kDH>, bytes, t, heads, batch, stream,
        tpudp::make_view<const float>(q, strides, 0),
        tpudp::make_view<const float>(k, strides, 1),
        tpudp::make_view<const float>(v, strides, 2),
        tpudp::make_view<const float>(dout, strides, 3), lse, delta,
        tpudp::make_view<float>(dq, strides, 4), t, heads, causal, scale));
  });
}
