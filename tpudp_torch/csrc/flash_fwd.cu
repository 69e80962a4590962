// Flash-attention forward for Hopper (sm_90a): o = softmax(q k^T * scale)
// v over (b, t, h, dh) q, k, v, causal or not, plus the per-row
// log-sum-exp lse = m + log(l) that the backward kernels recompute the
// probabilities from.
//
// Replaces tpudp/ops/flash_attention.py:_fwd_kernel (launched by
// _flash_fwd_impl).  On the TPU the grid is (b * h, q blocks, k blocks)
// and the online-softmax carry (running max m, denominator l,
// accumulator) sits in VMEM scratch across the sequential k-block axis.
// Hopper runs blocks in no order, so a block owns a tile of query rows
// and walks the K/V tiles itself: up to the diagonal when causal, all of
// them otherwise.  Masked scores get no weight (the TPU kernel's -1e30),
// l is clamped at 1e-30 before the division, and q, k and v are read
// through their strides, so the views of the qkv projection the model
// passes are never transposed or copied.  Query tiles are issued
// longest-first (the last causal tile walks the most keys).
//
// Bound on this card: operations.  Causal GPT-2 small at t = 2048 does
// 4 * dh flops per visible (query, key) pair, 25.8 GFLOP per call at
// b = 4, h = 12: 0.026 ms at 989 TFLOP/s bf16, against 0.015 ms for
// reading q, k, v and writing o and lse once at 3.35 TB/s.  Only the
// tensor cores come near that bound, so the two dtypes take two kernels,
// chosen explicitly by the launch function:
//
// * bfloat16 (the training path): flash_fwd_sm90_kernel, on the tensor
//   cores.  A block is one warpgroup owning 64 query rows (its q as wgmma
//   register fragments, loaded once); K/V tiles of 64 keys come by TMA,
//   issued by one thread, into a three-stage ring of swizzled shared-
//   memory tiles, one tile ahead, completing on an mbarrier a stage; the
//   4-D tensor map (dh, h, t, b) reads the strided projection views as
//   they are and zero-fills rows past t.  S = Q K^T is a wgmma with K
//   from shared memory, accumulated in f32 registers; the scale is
//   applied to the f32 scores (1/sqrt(32) and 1/sqrt(128) are not exact
//   in bf16) and the online softmax runs in base 2 in registers, masking
//   only tiles that cross the diagonal or t.  P is rounded to bf16 in
//   registers and fed to O += P V as wgmma's register A operand; V is
//   read MN-major through the transpose bit.  The P V product of one tile
//   runs while the next tile's scores are multiplied and exponentiated;
//   only the rescaling of o waits for it.  Small blocks (122 registers a
//   thread and 49 KB at dh 64) let four fit on an SM, and query tiles are
//   the grid's slow axis, so the longest go first over all heads.
//   o = acc / max(l, 1e-30) is written as bf16, lse = m + log(max(l,
//   1e-30)) in f32.  Rounding P to bf16 is the one rounding the f32
//   version does not make (ROADMAP Queue 3;
//   tests/test_torch_flash_attention.py holds a model of it to the plain
//   version within the card's bf16 tolerance).
// * float32: flash_fwd_kernel, the first port's tile loop on the f32
//   CUDA cores (64-row tiles staged in padded f32 shared memory, 4 x 4
//   register blocks), kept because the f32 check holds o to 2e-5, which
//   TF32 tensor cores would not meet.  It is instantiated for float32
//   only.
#include "flash_common.cuh"
#include "flash_sm90.cuh"

namespace tpudp {

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(Bthd<const T> q, Bthd<const T> k, Bthd<const T> v,
                     Bthd<T> o, float* __restrict__ lse, int t, int heads,
                     int causal, float scale) {
  extern __shared__ float smem[];
  float* q_s = smem;                    // (kTile, D + 1), pre-scaled
  float* k_s = q_s + kTile * (D + 1);   // (kTile, D + 1)
  float* v_s = k_s + kTile * (D + 1);   // (kTile, D + 1)
  float* p_s = v_s + kTile * (D + 1);   // (kTile, kScorePitch)
  const int n_tiles = gridDim.x;
  const int qt = n_tiles - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
  const int q0 = qt * kTile;

  load_tile<T, D>(q_s, q.slice(b, h), q.st, q0, t, scale);
  float m[kSub], l[kSub], acc[kSub][D / 16];
#pragma unroll
  for (int i = 0; i < kSub; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < D / 16; ++j) acc[i][j] = 0.f;
  }

  const int k_tiles = causal ? qt + 1 : n_tiles;
  for (int kt = 0; kt < k_tiles; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // every reader of the previous K/V and P tiles is done
    load_tile<T, D>(k_s, k.slice(b, h), k.st, k0, t, 1.f);
    load_tile<T, D>(v_s, v.slice(b, h), v.st, k0, t, 1.f);
    __syncthreads();
    float s[kSub][kSub];
    tile_dots<D>(s, q_s, k_s, ty, tx);
#pragma unroll
    for (int i = 0; i < kSub; ++i) {
      const int qi = q0 + ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kSub; ++j)
        if (visible(qi, k0 + tx + 16 * j, t, causal)) mx = fmaxf(mx, s[i][j]);
      const float m_new = fmaxf(m[i], row_max16(mx));
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kSub; ++j) {
        const float p = visible(qi, k0 + tx + 16 * j, t, causal)
                            ? expf(s[i][j] - m_new)
                            : 0.f;
        p_s[(ty + 16 * i) * kScorePitch + tx + 16 * j] = p;
        sum += p;
      }
      l[i] = l[i] * alpha + row_sum16(sum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < D / 16; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();
    tile_matmul_acc<D>(acc, p_s, v_s, ty, tx);
  }

  T* o_bh = o.slice(b, h);
  float* lse_bh = lse + ((long long)b * heads + h) * t;
#pragma unroll
  for (int i = 0; i < kSub; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= t) continue;
    const float l_safe = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < D / 16; ++j)
      store_f32(o_bh + (long long)r * o.st + tx + 16 * j, acc[i][j] / l_safe);
    if (tx == 0) lse_bh[r] = m[i] + logf(l_safe);
  }
}

namespace sm90 {

// A block is one warpgroup owning 64 query rows; K/V tiles of 64 keys
// come through a ring of three stages, one tile ahead of the one being
// multiplied while a third still holds the V of the tile before it.  At
// 122 registers a thread (dh 64) and 49 KB of shared memory, four blocks
// fit on an SM, so one block's softmax overlaps the others' products.
template <int D>
struct FwdConfig {
  static constexpr int kBlockM = 64;
  static constexpr int kBlockN = 64;
  static constexpr int kThreads = 128;
  static constexpr int kMinBlocks = D == 128 ? 2 : 3;
  static constexpr int kStages = 3;
  static constexpr int kAhead = kStages - 2;  // tiles loaded ahead
  static constexpr int kKVBytes = kBlockN * D * 2;
  // The stages of k, then those of v, then one mbarrier a stage; 1024
  // bytes of slack for the alignment of the swizzle atoms.
  static constexpr size_t kSmem = 2 * kStages * kKVBytes + 8 * kStages + 1024;
};

template <int D>
__global__ void __launch_bounds__(FwdConfig<D>::kThreads,
                                  FwdConfig<D>::kMinBlocks)
    flash_fwd_sm90_kernel(Bthd<const bf16> q,
                          const __grid_constant__ CUtensorMap k_map,
                          const __grid_constant__ CUtensorMap v_map,
                          Bthd<bf16> o, float* __restrict__ lse, int t,
                          int heads, int causal, float scale) {
  using C = FwdConfig<D>;
  using G = TileGeom<D>;
  constexpr int BM = C::kBlockM, BN = C::kBlockN, S = C::kStages;
  constexpr int kON = G::kRowElems;  // N of one P.V product
  constexpr int kOC = G::kChunks;    // head-dim chunks of o
  extern __shared__ uint8_t smem_raw[];
  const uint32_t k_s = (smem_u32(smem_raw) + 1023) & ~1023u;  // stage i at
  const uint32_t v_s = k_s + S * C::kKVBytes;  // + i * kKVBytes in each
  const uint32_t full = v_s + S * C::kKVBytes;  // stage i landed: + 8 i

  // Query tiles are the grid's slow axis, issued longest first over all
  // heads and batches.
  const int qt = gridDim.y - 1 - blockIdx.y;
  const int h = blockIdx.x % heads;
  const int b = blockIdx.x / heads;
  const int q0 = qt * BM;
  const int lane = threadIdx.x % 32;
  // The thread's rows (row, row + 8) of the q tile and first column.
  const int row = 16 * (threadIdx.x / 32) + lane / 4;
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
    for (int i = 0; i < S; ++i) mbar_init(full + 8 * i, 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x == 0)
    for (int kt = 0; kt < C::kAhead && kt < n_kt; ++kt) load_kv(kt);
  uint32_t qa[D / 16][4];  // the q rows, as A fragments
  load_frag_a<D>(qa, q.slice(b, h), q.st, q0, t);

  const float sl2 = scale * kLog2e;     // raw scores to base-2 exponents
  float m[2] = {-INFINITY, -INFINITY};  // running max, base 2
  float l[2] = {0.f, 0.f};              // this thread's share of each sum
  float acc[kOC][kON / 2];
#pragma unroll
  for (int c = 0; c < kOC; ++c)
#pragma unroll
    for (int i = 0; i < kON / 2; ++i) acc[c][i] = 0.f;
  uint32_t pa[BN / 16][4];  // the previous tile's P, as A fragments

  // O += P V for the P in `pa` and the V tile of key tile kt (issued, not
  // waited for).
  auto issue_pv = [&](int kt) {
    const uint32_t vt_s = v_s + (kt % S) * C::kKVBytes;
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
      for (int c = 0; c < kOC; ++c)
        wgmma_rs<1>(acc[c], pa[kk], desc_mn<D, BN>(vt_s, c, kk));
    wgmma_commit();
  };

  // Key tile kt's scores are multiplied while the previous tile's P V
  // product runs; the softmax of tile kt then overlaps that product, and
  // only the rescaling of o waits for it.
  for (int kt = 0; kt < n_kt; ++kt) {
    if (threadIdx.x == 0 && kt + C::kAhead < n_kt)
      load_kv(kt + C::kAhead);  // streams in meanwhile
    mbar_wait(full + 8 * (kt % S), (kt / S) & 1);
    const int k0 = kt * BN;
    const uint32_t kt_s = k_s + (kt % S) * C::kKVBytes;
    float s[32];
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      wgmma_rs<0>(s, qa[ks], desc_k<D, BN>(kt_s, 0, ks), ks > 0);
    wgmma_commit();
    if (kt > 0) {
      issue_pv(kt - 1);
      wgmma_wait<1>();
    } else {
      wgmma_wait<0>();
    }
    fence_regs(s);

    if (k0 + BN > t || (causal && k0 + BN - 1 > q0)) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {  // masked scores get no weight
        const int kj = k0 + 8 * (i >> 2) + col + (i & 1);
        const int qi = q0 + row + 8 * ((i >> 1) & 1);
        if (kj >= t || (causal && kj > qi)) s[i] = -INFINITY;
      }
    }
    float mx[2] = {-INFINITY, -INFINITY};  // raw scores
#pragma unroll
    for (int i = 0; i < 32; ++i)
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
    float base[2], alpha[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const float m_new = fmaxf(m[rr], quad_max(mx[rr]) * sl2);
      base[rr] = m_new == -INFINITY ? 0.f : m_new;  // no key seen yet
      alpha[rr] = exp2_approx(m[rr] - base[rr]);
      m[rr] = m_new;
      l[rr] *= alpha[rr];
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int rr = (i >> 1) & 1;
      s[i] = exp2_approx(fmaf(s[i], sl2, -base[rr]));
      l[rr] += s[i];
    }

    wgmma_wait<0>();  // the previous P V is done with acc and pa
#pragma unroll
    for (int c = 0; c < kOC; ++c) {
      fence_regs(acc[c]);
#pragma unroll
      for (int i = 0; i < kON / 2; ++i) acc[c][i] *= alpha[(i >> 1) & 1];
    }
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) frag_a(pa[kk], s, kk);
    __syncthreads();  // every reader of the oldest stage is done
  }
  wgmma_fence();
  issue_pv(n_kt - 1);
  wgmma_wait<0>();
#pragma unroll
  for (int c = 0; c < kOC; ++c) fence_regs(acc[c]);

  bf16* o_bh = o.slice(b, h);
  float* lse_bh = lse + ((long long)b * heads + h) * t;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int r = q0 + row + 8 * rr;
    const float l_safe = fmaxf(quad_sum(l[rr]), 1e-30f);
    if (r >= t) continue;
    const float inv = 1.f / l_safe;
    bf16* out = o_bh + (long long)r * o.st;
#pragma unroll
    for (int c = 0; c < kOC; ++c)
#pragma unroll
      for (int j = 0; j < kON / 8; ++j)
        store_bf16x2(out + c * kON + 8 * j + col, acc[c][4 * j + 2 * rr] * inv,
                     acc[c][4 * j + 2 * rr + 1] * inv);
    if (lane % 4 == 0) lse_bh[r] = m[rr] * kLn2 + logf(l_safe);
  }
}

}  // namespace sm90

}  // namespace tpudp

// q, k, v: (b, t, h, dh) read through strides; o: (b, t, h, dh) written
// through strides; lse: contiguous (b, h, t) float32.  strides holds the
// (batch, token, head) element strides of q, k, v, o in that order.
extern "C" int launch_flash_fwd(const void* q, const void* k, const void* v,
                                void* o, float* lse, const long long* strides,
                                int dtype_code, int batch, int t, int heads,
                                int head_dim, int causal, float scale,
                                cudaStream_t stream) {
  if (batch < 1 || t < 1 || heads < 1) return cudaErrorInvalidValue;
  if (dtype_code == 1) {  // bfloat16: the tensor-core kernel
    using bf16 = __nv_bfloat16;
    TPUDP_HEAD_DIM(head_dim, {
      using C = tpudp::sm90::FwdConfig<kDH>;
      CUtensorMap k_map, v_map;
      cudaError_t err = tpudp::sm90::make_tensor_map<kDH>(
          &k_map, k, strides[3], strides[4], strides[5], batch, t, heads,
          C::kBlockN);
      if (err == cudaSuccess)
        err = tpudp::sm90::make_tensor_map<kDH>(&v_map, v, strides[6],
                                                strides[7], strides[8], batch,
                                                t, heads, C::kBlockN);
      if (err != cudaSuccess) return static_cast<int>(err);
      const dim3 grid(heads * batch, (t + C::kBlockM - 1) / C::kBlockM);
      return static_cast<int>(tpudp::sm90::launch(
          tpudp::sm90::flash_fwd_sm90_kernel<kDH>, grid, C::kThreads,
          C::kSmem, stream, tpudp::make_view<const bf16>(q, strides, 0),
          k_map, v_map, tpudp::make_view<bf16>(o, strides, 3), lse, t,
          heads, causal, scale));
    });
  }
  if (dtype_code != 0) return cudaErrorInvalidValue;
  TPUDP_HEAD_DIM(head_dim, {  // float32: the CUDA-core kernel
    using tpudp::kTile;
    const size_t bytes =
        (3 * kTile * (kDH + 1) + kTile * tpudp::kScorePitch) * sizeof(float);
    return static_cast<int>(tpudp::launch_tiles(
        tpudp::flash_fwd_kernel<float, kDH>, bytes, t, heads, batch, stream,
        tpudp::make_view<const float>(q, strides, 0),
        tpudp::make_view<const float>(k, strides, 1),
        tpudp::make_view<const float>(v, strides, 2),
        tpudp::make_view<float>(o, strides, 3), lse, t, heads, causal,
        scale));
  });
}
