// Host data-path kernels of the port's loader (C++/OpenMP): its own copy
// of the JAX package's augment backend, with the symbols renamed so both
// libraries can live in one process.
//
// One fused pass over a uint8 NHWC batch does what the reference's
// torchvision stack does per sample (RandomCrop(32, padding=4) ->
// RandomHorizontalFlip -> ToTensor -> Normalize) and yields the
// normalized float32 NHWC batch, with OpenMP threads in place of
// DataLoader worker processes.
//
// The caller draws the random decisions (crop origins, flip flags) in
// Python, so this path and the numpy path give the same bytes from the
// same RNG stream.  The float math is ordered as numpy's,
// (x / 255 - mean) / std in float32, and the build turns off FP
// contraction (-ffp-contract=off), so the outputs equal numpy's to the
// last bit.

#include <cstdint>
#include <cstring>

extern "C" {

// Fused zero-pad -> crop -> horizontal flip -> normalize.
//   in:       (b, hi, wi, c) uint8, NHWC
//   out:      (b, ho, wo, c) float32, NHWC
//   offsets:  (b, 2) int32 crop origins (row, col) in the zero-padded
//             frame, in [0, hi + 2*pad - ho] x [0, wi + 2*pad - wo]
//   flips:    (b,) uint8 booleans: flip the crop along the width
//   mean/std: (c,) float32 channel statistics
void tpudp_torch_augment_normalize(const uint8_t* in, float* out,
                                   const int32_t* offsets,
                                   const uint8_t* flips, int64_t b,
                                   int64_t hi, int64_t wi, int64_t ho,
                                   int64_t wo, int64_t c, int64_t pad,
                                   const float* mean, const float* std_) {
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < b; ++i) {
    const uint8_t* img = in + i * hi * wi * c;
    float* dst = out + i * ho * wo * c;
    // The crop origin in source coordinates (negative: in the padding).
    const int64_t r0 = (int64_t)offsets[2 * i] - pad;
    const int64_t c0 = (int64_t)offsets[2 * i + 1] - pad;
    const bool flip = flips[i] != 0;
    for (int64_t r = 0; r < ho; ++r) {
      const int64_t sr = r0 + r;
      const bool row_in = sr >= 0 && sr < hi;
      for (int64_t col = 0; col < wo; ++col) {
        const int64_t dc = flip ? wo - 1 - col : col;
        float* o = dst + (r * wo + dc) * c;
        const int64_t sc = c0 + col;
        if (row_in && sc >= 0 && sc < wi) {
          const uint8_t* p = img + (sr * wi + sc) * c;
          for (int64_t k = 0; k < c; ++k)
            o[k] = ((float)p[k] / 255.0f - mean[k]) / std_[k];
        } else {  // the zero padding: a normalized zero pixel
          for (int64_t k = 0; k < c; ++k)
            o[k] = (0.0f - mean[k]) / std_[k];
        }
      }
    }
  }
}

// Normalize only (the eval path's ToTensor + Normalize): uint8 ->
// float32, n pixels of c channels each.
void tpudp_torch_normalize(const uint8_t* in, float* out, int64_t n,
                           int64_t c, const float* mean,
                           const float* std_) {
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    const uint8_t* p = in + i * c;
    float* o = out + i * c;
    for (int64_t k = 0; k < c; ++k)
      o[k] = ((float)p[k] / 255.0f - mean[k]) / std_[k];
  }
}

// Parallel batch gather: out[i] = data[idx[i]] for samples of
// sample_bytes each (numpy's fancy indexing copies on one thread; at
// ImageNet's 150 KB a sample the copy is worth spreading over cores).
void tpudp_torch_gather_u8(const uint8_t* data, const int64_t* idx,
                           uint8_t* out, int64_t b, int64_t sample_bytes) {
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < b; ++i)
    std::memcpy(out + i * sample_bytes, data + idx[i] * sample_bytes,
                (size_t)sample_bytes);
}

int tpudp_torch_native_abi_version(void) { return 1; }

}  // extern "C"
