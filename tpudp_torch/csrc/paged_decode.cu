// Paged decode attention for Hopper (sm_90a): one query token per slot
// against that slot's K/V pages, read through the block table.
//
// Replaces tpudp/ops/paged_attention.py:_decode_kernel (launched by
// _kernel_paged).  On the TPU the grid is (slot, page) and the online-
// softmax carry lives in VMEM scratch across the sequential page axis.
// Hopper runs blocks in no order, so the page axis becomes a loop inside
// one block: block (head, slot) walks only the slot's visible keys
// (0 .. pos[slot], i.e. its table row up to pos // T), its NW warps take
// interleaved 32-key tiles, each warp keeps its own running max,
// denominator and accumulator in registers, and the warps merge through
// shared memory at the end.  Unmapped (-1) entries are skipped; query
// head j reads KV head j / groups (GQA; groups == 1 is GPT-2's MHA).
// Whole-pool mode passes the pool's base already offset to the layer,
// so no per-layer slice is ever materialized.
//
// The int8 variant (launch_paged_decode_int8) is the same kernel over
// int8 pages with float32 per-vector scales (the TPU kernel's `int8`
// branch: its two extra scale BlockSpecs become the scale pointers and
// strides of PageView<int8_t>): a key row is 16 int8 values per 16-byte
// load, the key's scale multiplies its dot product and its v_scale the
// key's P.V weight; queries and output stay float32 or bf16.
//
// Bound on this card: bytes.  The kernel must read the visible K/V rows
// once (2 * visible * kv * dh * itemsize per slot, plus 8 bytes of
// scales per visible key and KV head over int8 pages) plus q and out; its
// arithmetic is 4 * h * dh flops per visible key, far below the fp32
// rate at any batch a decode step sees.  This first version reads each K
// row with 16-byte loads, one key per lane, and each V row coalesced
// across the warp; a slot's K/V is read once per query head, so GQA
// shapes re-read K/V `groups` times (from L2).  wgmma, TMA and split-K
// across blocks are later work.
#include "paged_common.cuh"

namespace tpudp {

constexpr int kDecodeWarps = 4;

template <typename T, typename P, int DH>
__global__ void __launch_bounds__(kDecodeWarps * 32)
    paged_decode_kernel(const T* __restrict__ q, PageView<P> pv,
                        const int* __restrict__ table,
                        const int* __restrict__ pos, T* __restrict__ out,
                        int heads, int groups, int max_pages,
                        int page_tokens, long long q_slot_stride,
                        long long q_head_stride, float scale) {
  const int head = blockIdx.x;
  const int s = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  __shared__ float q_s[DH];
  __shared__ float m_s[kDecodeWarps];
  __shared__ float l_s[kDecodeWarps];
  __shared__ float acc_s[kDecodeWarps][DH];

  const T* qr = q + s * q_slot_stride + head * q_head_stride;
  for (int d = threadIdx.x; d < DH; d += blockDim.x) q_s[d] = to_f32(qr[d]) * scale;
  __syncthreads();

  const int limit = min(pos[s], max_pages * page_tokens - 1);
  float m = kNegInf, l = 0.f;
  float acc[DH / 32];
#pragma unroll
  for (int i = 0; i < DH / 32; ++i) acc[i] = 0.f;
  fold_keys<P, DH>(q_s, pv, table + (long long)s * max_pages, page_tokens,
                   head / groups, warp * 32, kDecodeWarps * 32, limit, m, l,
                   acc);
  if (lane == 0) {
    m_s[warp] = m;
    l_s[warp] = l;
  }
#pragma unroll
  for (int i = 0; i < DH / 32; ++i) acc_s[warp][lane + 32 * i] = acc[i];
  __syncthreads();

  for (int d = threadIdx.x; d < DH; d += blockDim.x) {
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kDecodeWarps; ++w) mx = fmaxf(mx, m_s[w]);
    float denom = 0.f, num = 0.f;
#pragma unroll
    for (int w = 0; w < kDecodeWarps; ++w) {
      const float c = expf(m_s[w] - mx);
      denom += l_s[w] * c;
      num += acc_s[w][d] * c;
    }
    store_f32(out + ((long long)s * heads + head) * DH + d,
              num / fmaxf(denom, 1e-30f));
  }
}

}  // namespace tpudp

// q: (b, 1, h, dh) with the given slot/head strides; out: contiguous
// (b, 1, h, dh); k/v: one layer's pages at k/v (+ layer_offset elements).
extern "C" int launch_paged_decode(
    const void* q, const void* k, const void* v, const int* table,
    const int* pos, void* out, int dtype_code, int batch, int heads,
    int kv_heads, int head_dim, int max_pages, int page_tokens,
    long long q_slot_stride, long long q_head_stride, long long layer_offset,
    long long page_stride, long long tok_stride, long long head_stride,
    float scale, cudaStream_t stream) {
  if (batch < 1 || kv_heads < 1 || heads % kv_heads) return cudaErrorInvalidValue;
  const dim3 grid(heads, batch);
  TPUDP_DISPATCH(dtype_code, head_dim, {
    const scalar_t* kb = static_cast<const scalar_t*>(k) + layer_offset;
    const scalar_t* vb = static_cast<const scalar_t*>(v) + layer_offset;
    tpudp::PageView<scalar_t> pv{kb, vb, page_stride, tok_stride, head_stride};
    tpudp::paged_decode_kernel<scalar_t, scalar_t, kDH>
        <<<grid, tpudp::kDecodeWarps * 32, 0, stream>>>(
            static_cast<const scalar_t*>(q), pv, table, pos,
            static_cast<scalar_t*>(out), heads, heads / kv_heads, max_pages,
            page_tokens, q_slot_stride, q_head_stride, scale);
  });
  return static_cast<int>(cudaGetLastError());
}

// As launch_paged_decode over an int8 pool: k/v int8 pages, k_scale/v_scale
// their float32 scales (+ scale_layer_offset elements, s_* strides); q and
// out are float32 or bf16 (dtype_code).
extern "C" int launch_paged_decode_int8(
    const void* q, const void* k, const void* v, const float* k_scale,
    const float* v_scale, const int* table, const int* pos, void* out,
    int dtype_code, int batch, int heads, int kv_heads, int head_dim,
    int max_pages, int page_tokens, long long q_slot_stride,
    long long q_head_stride, long long layer_offset, long long page_stride,
    long long tok_stride, long long head_stride, long long scale_layer_offset,
    long long s_page_stride, long long s_tok_stride, long long s_head_stride,
    float scale, cudaStream_t stream) {
  if (batch < 1 || kv_heads < 1 || heads % kv_heads) return cudaErrorInvalidValue;
  const dim3 grid(heads, batch);
  const tpudp::PageView<int8_t> pv = tpudp::int8_page_view(
      k, v, k_scale, v_scale, layer_offset, page_stride, tok_stride,
      head_stride, scale_layer_offset, s_page_stride, s_tok_stride,
      s_head_stride);
  TPUDP_DISPATCH(dtype_code, head_dim, {
    tpudp::paged_decode_kernel<scalar_t, int8_t, kDH>
        <<<grid, tpudp::kDecodeWarps * 32, 0, stream>>>(
            static_cast<const scalar_t*>(q), pv, table, pos,
            static_cast<scalar_t*>(out), heads, heads / kv_heads, max_pages,
            page_tokens, q_slot_stride, q_head_stride, scale);
  });
  return static_cast<int>(cudaGetLastError());
}
