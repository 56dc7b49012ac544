// Host-side data-path helpers of pagnerf_tpu_torch: random ray-index
// sampling (xorshift128+ partial Fisher-Yates), batched pixel gathers and
// COCO RLE decoding, behind a plain C interface.
//
// The sampler's stream is the one the JAX package's training batches come
// from (its native/batcher.cpp, the same C signatures), so both packages
// draw the same pixels from the same seed. Built with g++ at first use by
// pagnerf_tpu_torch/data/native.py and loaded with ctypes.

#include <cstdint>
#include <cstring>

extern "C" {

// xorshift128+ PRNG (per-call state owned by caller)
static inline uint64_t xorshift(uint64_t *s) {
  uint64_t x = s[0];
  uint64_t const y = s[1];
  s[0] = y;
  x ^= x << 23;
  s[1] = x ^ y ^ (x >> 17) ^ (y >> 26);
  return s[1] + y;
}

// Sample `num_rays` distinct pixel indices in [0, num_pixels) for each of
// `batch` images (partial Fisher-Yates over an index pool).
// out: [batch, num_rays] int64. pool: scratch of size num_pixels (int64).
void sample_ray_indices(int64_t batch, int64_t num_rays, int64_t num_pixels,
                        uint64_t seed, int64_t *pool, int64_t *out) {
  uint64_t st[2] = {seed ^ 0x9e3779b97f4a7c15ull, seed + 0xbf58476d1ce4e5b9ull};
  for (int64_t b = 0; b < batch; ++b) {
    for (int64_t i = 0; i < num_pixels; ++i) pool[i] = i;
    for (int64_t i = 0; i < num_rays; ++i) {
      int64_t j = i + (int64_t)(xorshift(st) % (uint64_t)(num_pixels - i));
      int64_t tmp = pool[i];
      pool[i] = pool[j];
      pool[j] = tmp;
      out[b * num_rays + i] = pool[i];
    }
  }
}

// Gather pixels from per-image flattened modes.
// src:      [num_images, num_pixels, channels] float32 (contiguous)
// img_idx:  [batch] int64 image selector
// ray_idx:  [batch, num_rays] int64 pixel selector
// dst:      [batch, num_rays, channels] float32
void gather_pixels_f32(const float *src, const int64_t *img_idx,
                       const int64_t *ray_idx, float *dst, int64_t batch,
                       int64_t num_rays, int64_t num_pixels, int64_t channels) {
  for (int64_t b = 0; b < batch; ++b) {
    const float *img = src + img_idx[b] * num_pixels * channels;
    const int64_t *ridx = ray_idx + b * num_rays;
    float *out = dst + b * num_rays * channels;
    for (int64_t r = 0; r < num_rays; ++r) {
      std::memcpy(out + r * channels, img + ridx[r] * channels,
                  sizeof(float) * (size_t)channels);
    }
  }
}

// Same for int32 modes (labels).
void gather_pixels_i32(const int32_t *src, const int64_t *img_idx,
                       const int64_t *ray_idx, int32_t *dst, int64_t batch,
                       int64_t num_rays, int64_t num_pixels, int64_t channels) {
  for (int64_t b = 0; b < batch; ++b) {
    const int32_t *img = src + img_idx[b] * num_pixels * channels;
    const int64_t *ridx = ray_idx + b * num_rays;
    int32_t *out = dst + b * num_rays * channels;
    for (int64_t r = 0; r < num_rays; ++r) {
      std::memcpy(out + r * channels, img + ridx[r] * channels,
                  sizeof(int32_t) * (size_t)channels);
    }
  }
}

// Decode COCO uncompressed RLE runs (column-major) into a [h, w] uint8 mask.
void rle_decode(const int64_t *runs, int64_t num_runs, int64_t h, int64_t w,
                uint8_t *mask /* row-major [h, w] */) {
  int64_t pos = 0;
  uint8_t val = 0;
  for (int64_t i = 0; i < num_runs; ++i) {
    int64_t run = runs[i];
    if (val) {
      for (int64_t k = 0; k < run; ++k) {
        int64_t p = pos + k;            // column-major position
        if (p >= h * w) break;
        int64_t col = p / h, row = p % h;
        mask[row * w + col] = 1;
      }
    }
    pos += run;
    val ^= 1;
  }
}

}  // extern "C"
