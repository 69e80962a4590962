// Hopper building blocks of the bf16 flash-attention kernels (flash_fwd.cu
// K1, flash_dq.cu K2 and flash_dkv.cu K3): swizzled bf16 tiles
// in shared memory filled by TMA (the tensor map of a strided (b, t, h, D)
// view, encoded on the host by cuTensorMapEncodeTiled, fetched through the
// CUDA runtime so that no library links against libcuda, and
// the mbarriers the copies complete on), register A fragments loaded
// straight from device memory, the wgmma shared-memory matrix descriptors,
// the wgmma instructions themselves (both operands from shared memory, or
// A from registers), and the fences and waits around them.  Everything
// here needs sm_90a; nothing needs libcuda at link time.
//
// Tile layout.  An (R, D) bf16 tile (R rows, head dim D contiguous) is
// stored as D / W column chunks of W = min(D, 64) elements, each chunk R
// rows of 2 W bytes, one after the other.  Inside a chunk the 16-byte
// pieces of row r are permuted by the hardware swizzle that wgmma's
// descriptors name: piece g sits at g ^ (r % 8) for 128-byte rows (the
// 128B swizzle, D >= 64) and at g ^ ((r / 2) % 4) for 64-byte rows (the
// 64B swizzle, D = 32).  Eight rows make one swizzle atom (1024 or 512
// bytes), tiles start 1024-byte aligned, so the swizzle the descriptor
// applies to absolute addresses is the one TMA wrote.  The same
// stored tile serves as a K-major operand (rows are M or N, head dim the
// reduction) and as an MN-major one (rows are the reduction, head dim N,
// read through the transpose bit).
//
// Accumulator fragment of a 64 x N wgmma tile (N / 2 floats a thread):
// warp w of the warpgroup holds rows 16 w + lane / 4 (registers 4 j and
// 4 j + 1) and 16 w + lane / 4 + 8 (4 j + 2, 4 j + 3), at columns
// 8 j + 2 (lane % 4) and one more.  The four threads of a quad share a
// row, so a row reduction is two xor shuffles.  Sixteen columns of it,
// rounded to bf16 pairs, are exactly the register A fragment of a
// 64 x 16 slice (frag_a), which is how P and dS feed the next product
// without leaving registers.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only: no libcuda link)

#include "common.cuh"

namespace tpudp {
namespace sm90 {

using bf16 = __nv_bfloat16;

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Geometry of the swizzled tiles of head dim D.
template <int D>
struct TileGeom {
  static constexpr int kRowElems = D < 64 ? D : 64;  // W above
  static constexpr int kRowBytes = 2 * kRowElems;
  static constexpr int kChunks = D / kRowElems;
  static constexpr uint64_t kLayout = kRowBytes == 128 ? 1 : 2;  // 128B / 64B
  static constexpr uint32_t kAtomBytes = 8 * kRowBytes;
  static_assert(D == 32 || D == 64 || D == 128, "head dim 32, 64 or 128");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 4 bytes global -> shared, asynchronously; zeros when !valid.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N committed groups of this thread are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// -- mbarriers and TMA -----------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// Make initialized mbarriers visible to the async proxy; a barrier
// follows.
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Arrive on `bar` and expect `bytes` more from the copies it tracks.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

// Wait for the phase of `bar` with the given parity to complete.  A wait
// that outlasts any real copy by far traps, so a broken pipeline fails
// the launch instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t spin = 0;; ++spin) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (spin == (1u << 22)) __trap();
  }
}

// One box of a 4-D tensor map (coordinates innermost first) into shared
// memory at `dst`, completing its bytes on `bar`.  Boxes past the tensor's
// edge arrive as zeros.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            int c0, int c1, int c2, int c3,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(bar)
      : "memory");
}

// Rows [row0, row0 + R) of one (batch, head) slice into a swizzled R-row
// tile at `dst` by TMA (one box per head-dim chunk), completing on `bar`;
// rows past t arrive as zeros.  Issued by one thread.
template <int D, int R>
__device__ __forceinline__ void tma_load_tile(uint32_t dst, const CUtensorMap* map,
                                              int b, int h, int row0,
                                              uint32_t bar) {
  using G = TileGeom<D>;
#pragma unroll
  for (int c = 0; c < G::kChunks; ++c)
    tma_load_4d(dst + c * R * G::kRowBytes, map, c * G::kRowElems, h, row0, b,
                bar);
}

// Shared-memory matrix descriptor of a swizzled tile for wgmma: start
// address, both byte offsets at the stride between eight-row groups (the
// only one a 64-wide N or K slice of these tiles uses, whichever of the
// two fields the major-ness reads it from), and the swizzle mode.
template <int D>
__device__ __forceinline__ uint64_t make_desc(uint32_t addr) {
  using G = TileGeom<D>;
  constexpr uint64_t stride = G::kAtomBytes >> 4;
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (stride << 16) | (stride << 32) |
         (G::kLayout << 62);
}

// K-major slice: rows [row, row + 64) (M or N) of an R-row tile, head-dim
// elements [16 ks, 16 ks + 16) as the reduction.
template <int D, int R>
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int row, int ks) {
  using G = TileGeom<D>;
  const int e = 16 * ks;
  return make_desc<D>(tile + (e / G::kRowElems) * R * G::kRowBytes +
                      row * G::kRowBytes + 2 * (e % G::kRowElems));
}

// MN-major slice: rows [16 kk, 16 kk + 16) of an R-row tile as the
// reduction, head-dim chunk `chunk` (W elements) as N.
template <int D, int R>
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int chunk, int kk) {
  using G = TileGeom<D>;
  return make_desc<D>(tile + chunk * R * G::kRowBytes + 16 * kk * G::kRowBytes);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Register A fragments of rows [row0, row0 + 64) of one (batch, head)
// slice of a bf16 (b, t, h, D) view, for the warpgroup's D / 16 products
// of depth 16: a[ks] is the fragment of head-dim elements [16 ks,
// 16 ks + 16).  Rows at or past t are zeros.
template <int D>
__device__ __forceinline__ void load_frag_a(uint32_t (&a)[D / 16][4],
                                            const bf16* src,
                                            long long row_stride, int row0,
                                            int t) {
  const int lane = threadIdx.x % 32;
  const int r = row0 + 16 * (threadIdx.x % 128 / 32) + lane / 4;
  const int c = 2 * (lane % 4);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const bool valid = r + 8 * half < t;
    const uint32_t* p = reinterpret_cast<const uint32_t*>(
        src + (long long)(valid ? r + 8 * half : 0) * row_stride + c);
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      a[ks][half] = valid ? p[8 * ks] : 0u;          // columns 16 ks + c
      a[ks][half + 2] = valid ? p[8 * ks + 4] : 0u;  // and 8 further on
    }
  }
}

// Keeps the compiler from touching accumulator registers across a
// wgmma wait: reads and writes of them stay on their side of it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The register A fragment of columns [16 kk, 16 kk + 16) of a 64 x 64
// accumulator tile, rounded to bf16.
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const float (&d)[32],
                                       int kk) {
  const int b = 8 * kk;
  a[0] = pack_bf16(d[b + 0], d[b + 1]);
  a[1] = pack_bf16(d[b + 2], d[b + 3]);
  a[2] = pack_bf16(d[b + 4], d[b + 5]);
  a[3] = pack_bf16(d[b + 6], d[b + 7]);
}

// 2^x by the special-function unit (2^-inf = 0).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(kFullMask, x, 1));
  return fmaxf(x, __shfl_xor_sync(kFullMask, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(kFullMask, x, 1);
  return x + __shfl_xor_sync(kFullMask, x, 2);
}

// Two f32 values as a bf16 pair at p (4-byte aligned).
__device__ __forceinline__ void store_bf16x2(bf16* p, float lo, float hi) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(lo, hi);
}

// The wgmma instructions, m64 k16, bf16 inputs, f32 accumulators.
// kTransB = 1 reads B MN-major (the transpose bit).
// d (64 x 64, f32) (+)= A (64 x 16, smem, K-major) * B (16 x 64, smem).
template <int kTransB>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t desc_a,
                                          uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31},"
      " %32, %33, p, 1, 1, 0, %35;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate), "n"(kTransB));
}

// d (64 x 64, f32) (+)= A (64 x 16, bf16 pairs in registers) * B (16 x 64, smem).
template <int kTransB>
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                          uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31},"
      " {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate),
        "n"(kTransB));
}

// d (64 x 32, f32) (+)= A (64 x 16, bf16 pairs in registers) * B (16 x 32, smem).
template <int kTransB>
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const uint32_t (&a)[4],
                                          uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15},"
      " {%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate),
        "n"(kTransB));
}

// A (64 x 16, registers) times B into a 64 x 64 or 64 x 32 accumulator,
// added to it unless `accumulate` is 0.
template <int kTransB>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t desc_b, int accumulate = 1) {
  wgmma_rs_n64<kTransB>(d, a, desc_b, accumulate);
}
template <int kTransB>
__device__ __forceinline__ void wgmma_rs(float (&d)[16], const uint32_t (&a)[4],
                                         uint64_t desc_b, int accumulate = 1) {
  wgmma_rs_n32<kTransB>(d, a, desc_b, accumulate);
}

// The tensor map TMA reads a bf16 (b, t, h, D) view through: dims
// (D, h, t, b) innermost first with the view's element strides `sb`,
// `st`, `sh`, boxes of one head-dim chunk by `rows` tokens, swizzled as
// TileGeom<D> lays tiles out, zeros past the edge.
template <int D>
cudaError_t make_tensor_map(CUtensorMap* map, const void* base, long long sb,
                            long long st, long long sh, int batch, int t,
                            int heads, int rows) {
  using Encode = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                              void*, const cuuint64_t*, const cuuint64_t*,
                              const cuuint32_t*, const cuuint32_t*,
                              CUtensorMapInterleave, CUtensorMapSwizzle,
                              CUtensorMapL2promotion,
                              CUtensorMapFloatOOBfill);
  static Encode encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn,
                                              cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr)
      return cudaErrorNotSupported;
    encode = reinterpret_cast<Encode>(fn);
  }
  using G = TileGeom<D>;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads, (cuuint64_t)t,
                              (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)sh * 2, (cuuint64_t)st * 2,
                                 (cuuint64_t)sb * 2};  // bytes, dims 1-3
  const cuuint32_t box[4] = {(cuuint32_t)G::kRowElems, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      G::kRowBytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                          : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Opt the kernel into `bytes` of dynamic shared memory and launch it.
template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, dim3 grid, int threads, size_t bytes,
                   cudaStream_t stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, bytes, stream>>>(args...);
  return cudaGetLastError();
}

}  // namespace sm90
}  // namespace tpudp
