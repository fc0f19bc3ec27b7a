// The bilinear resize of the port's frame readers, without a JPEG decoder:
// resize_normalize and resize_u8 copied verbatim from frameio.cpp (the JAX
// package's csrc/frameio.cpp), so a frame decoded by any decoder and
// resized here gets the arithmetic of the JAX package's native path.  Used
// by data/transforms.py (frames already in memory) and by the nvJPEG
// reader (data/nvjpeg.cpp decodes on the card, the resize runs here).
//
// C ABI:
//   fio_resize_u8(src, sw, sh, dst_u8, dw, dh)
//   fio_resize_normalize(src, sw, sh, dst_f32, dw, dh, mean3, std3)

#include <cstddef>
#include <cstdint>
#include <vector>

namespace {

// Bilinear resize RGB8 -> normalized float32 HWC: ((x/255) - mean) / std.
// Matches cv2.INTER_LINEAR sampling (half-pixel centers).
void resize_normalize(const uint8_t* src, int sw, int sh, float* dst, int dw,
                      int dh, const float* mean, const float* stdv) {
  const float sx = float(sw) / dw, sy = float(sh) / dh;
  const float inv255 = 1.0f / 255.0f;
  float inv_std[3] = {1.0f / stdv[0], 1.0f / stdv[1], 1.0f / stdv[2]};

  std::vector<int> x0s(dw), x1s(dw);
  std::vector<float> fxs(dw);
  for (int x = 0; x < dw; ++x) {
    float fx = (x + 0.5f) * sx - 0.5f;
    if (fx < 0) fx = 0;
    int x0 = int(fx);
    if (x0 > sw - 1) x0 = sw - 1;
    int x1 = x0 + 1 < sw ? x0 + 1 : sw - 1;
    x0s[x] = x0; x1s[x] = x1; fxs[x] = fx - x0;
  }
  for (int y = 0; y < dh; ++y) {
    float fy = (y + 0.5f) * sy - 0.5f;
    if (fy < 0) fy = 0;
    int y0 = int(fy);
    if (y0 > sh - 1) y0 = sh - 1;
    int y1 = y0 + 1 < sh ? y0 + 1 : sh - 1;
    float wy = fy - y0;
    const uint8_t* r0 = src + size_t(y0) * sw * 3;
    const uint8_t* r1 = src + size_t(y1) * sw * 3;
    float* out = dst + size_t(y) * dw * 3;
    for (int x = 0; x < dw; ++x) {
      int x0 = x0s[x] * 3, x1 = x1s[x] * 3;
      float wx = fxs[x];
      float w00 = (1 - wy) * (1 - wx), w01 = (1 - wy) * wx;
      float w10 = wy * (1 - wx), w11 = wy * wx;
      for (int c = 0; c < 3; ++c) {
        float v = w00 * r0[x0 + c] + w01 * r0[x1 + c] + w10 * r1[x0 + c] +
                  w11 * r1[x1 + c];
        out[x * 3 + c] = (v * inv255 - mean[c]) * inv_std[c];
      }
    }
  }
}

// Bilinear resize RGB8 -> RGB8 (same half-pixel-center sampling as
// resize_normalize; round-to-nearest).  Used by the device-normalize
// path: the host ships raw uint8 and the model normalizes on device.
void resize_u8(const uint8_t* src, int sw, int sh, uint8_t* dst, int dw,
               int dh) {
  const float sx = float(sw) / dw, sy = float(sh) / dh;
  std::vector<int> x0s(dw), x1s(dw);
  std::vector<float> fxs(dw);
  for (int x = 0; x < dw; ++x) {
    float fx = (x + 0.5f) * sx - 0.5f;
    if (fx < 0) fx = 0;
    int x0 = int(fx);
    if (x0 > sw - 1) x0 = sw - 1;
    int x1 = x0 + 1 < sw ? x0 + 1 : sw - 1;
    x0s[x] = x0; x1s[x] = x1; fxs[x] = fx - x0;
  }
  for (int y = 0; y < dh; ++y) {
    float fy = (y + 0.5f) * sy - 0.5f;
    if (fy < 0) fy = 0;
    int y0 = int(fy);
    if (y0 > sh - 1) y0 = sh - 1;
    int y1 = y0 + 1 < sh ? y0 + 1 : sh - 1;
    float wy = fy - y0;
    const uint8_t* r0 = src + size_t(y0) * sw * 3;
    const uint8_t* r1 = src + size_t(y1) * sw * 3;
    uint8_t* out = dst + size_t(y) * dw * 3;
    for (int x = 0; x < dw; ++x) {
      int x0 = x0s[x] * 3, x1 = x1s[x] * 3;
      float wx = fxs[x];
      float w00 = (1 - wy) * (1 - wx), w01 = (1 - wy) * wx;
      float w10 = wy * (1 - wx), w11 = wy * wx;
      for (int c = 0; c < 3; ++c) {
        float v = w00 * r0[x0 + c] + w01 * r0[x1 + c] + w10 * r1[x0 + c] +
                  w11 * r1[x1 + c];
        out[x * 3 + c] = uint8_t(v + 0.5f);
      }
    }
  }
}

}  // namespace

extern "C" {

void fio_resize_u8(const uint8_t* src, int sw, int sh, uint8_t* dst, int dw,
                   int dh) {
  resize_u8(src, sw, sh, dst, dw, dh);
}

void fio_resize_normalize(const uint8_t* src, int sw, int sh, float* dst,
                          int dw, int dh, const float* mean,
                          const float* stdv) {
  resize_normalize(src, sw, sh, dst, dw, dh, mean, stdv);
}

}  // extern "C"
