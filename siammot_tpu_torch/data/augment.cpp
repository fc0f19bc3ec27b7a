// The pixel arithmetic of the training augmentation (data/augmentation.py)
// on uint8 RGB HWC frames, reproducing OpenCV's 8-bit paths bit for bit, so
// the port needs no cv2 and its batches equal the JAX package's:
//
//   aug_resize_u8     cv::resize(INTER_LINEAR) on CV_8UC3: 11-bit
//                     fixed-point coefficients, integer horizontal pass,
//                     and the vertical pass as OpenCV's SIMD kernel runs it
//                     (each row >> 4 times its coefficient, high 16 bits,
//                     summed, then (s + 2) >> 2)
//   aug_rgb2hsv       cv::cvtColor(COLOR_RGB2HSV) on 8 bits: hue in [0, 180)
//                     from OpenCV's integer division tables
//   aug_hsv2rgb       cv::cvtColor(COLOR_HSV2RGB) on 8 bits (hue < 180):
//                     float s, v / 255 and the sector table, 1 - s h as a
//                     fused multiply-add, times 255, truncated in OpenCV's
//                     SIMD blocks and rounded in each row's tail
//   aug_filter2d_u8   cv::filter2D(src, -1, float kernel): BORDER_REFLECT_101,
//                     centre anchor, the kernel's non-zero taps in row-major
//                     order accumulated with fused multiply-adds in float,
//                     rounded half to even
//   aug_gauss_u8      cv::GaussianBlur on 8 bits: separable, Q8 fixed-point
//                     taps (data/augmentation.py:gaussian_taps builds them),
//                     exact integer sums, (s + 2^15) >> 16
//   aug_warp_f32      cv::warpAffine(INTER_LINEAR, BORDER_CONSTANT 0) of a
//                     one-channel float image (the motion-blur kernel): the
//                     matrix inverted in double, then float, each sample
//                     position x m0 + y m1 + m2 with one fused multiply-add,
//                     and three fused lerps
//
// Built by data/native.py with g++ and -ffp-contract=off, so the float
// paths round where the source says and nowhere else.
//
// C ABI (all images interleaved RGB, rows packed):
//   aug_resize_u8(src, sw, sh, dst, dw, dh)
//   aug_rgb2hsv(src, dst, n_pixels) / aug_hsv2rgb(src, dst, w, h)
//   aug_filter2d_u8(src, w, h, dst, kernel_f32[kh][kw], kw, kh)
//   aug_gauss_u8(src, w, h, dst, taps_q8[n], n)
//   aug_warp_f32(src_f32, w, h, m_f64[6], dst_f32)

#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int kCoefBits = 11;               // INTER_RESIZE_COEF_BITS
constexpr float kCoefScale = 1 << kCoefBits;

inline uint8_t sat_u8(int v) {
  return uint8_t(v < 0 ? 0 : v > 255 ? 255 : v);
}

inline int16_t sat_s16(int v) {
  return int16_t(v < -32768 ? -32768 : v > 32767 ? 32767 : v);
}

// Round half to even, as cvRound / the SIMD cvt instructions do.
inline int round_even(float v) { return int(std::nearbyint(v)); }

// One axis' source index and Q11 weights, as cv::resize computes them:
// fx = float((d + 0.5) * scale - 0.5), the weights rounded from
// (1 - frac) * 2048 and frac * 2048.
void axis_coefs(int ssize, int dsize, bool clamp, std::vector<int>* s0,
                std::vector<int>* s1, std::vector<int16_t>* w0,
                std::vector<int16_t>* w1) {
  const double scale = 1.0 / (double(dsize) / ssize);
  s0->resize(dsize); s1->resize(dsize); w0->resize(dsize); w1->resize(dsize);
  for (int d = 0; d < dsize; ++d) {
    float f = float((d + 0.5) * scale - 0.5);
    int s = int(std::floor(f));
    f -= float(s);
    if (clamp) {                // columns: OpenCV clamps index and weight
      if (s < 0) { f = 0.f; s = 0; }
      if (s >= ssize - 1) { f = 0.f; s = ssize - 1; }
    }
    (*w0)[d] = int16_t(round_even((1.f - f) * kCoefScale));
    (*w1)[d] = int16_t(round_even(f * kCoefScale));
    // rows: the weights keep the unclamped fraction, the rows clamp
    (*s0)[d] = s < 0 ? 0 : s > ssize - 1 ? ssize - 1 : s;
    (*s1)[d] = s + 1 < 0 ? 0 : s + 1 > ssize - 1 ? ssize - 1 : s + 1;
  }
}

void resize_u8(const uint8_t* src, int sw, int sh, uint8_t* dst, int dw,
               int dh) {
  if (sw == dw && sh == dh) {
    std::memcpy(dst, src, size_t(sw) * sh * 3);
    return;
  }
  std::vector<int> x0, x1, y0, y1;
  std::vector<int16_t> a0, a1, b0, b1;
  axis_coefs(sw, dw, true, &x0, &x1, &a0, &a1);
  axis_coefs(sh, dh, false, &y0, &y1, &b0, &b1);
  const int n = dw * 3;
  // horizontal pass of each source row once (int sums of Q11 weights)
  std::vector<int> rows(size_t(sh) * n);
  std::vector<char> done(sh, 0);
  auto hrow = [&](int y) -> const int* {
    int* out = rows.data() + size_t(y) * n;
    if (!done[y]) {
      const uint8_t* s = src + size_t(y) * sw * 3;
      for (int x = 0; x < dw; ++x) {
        const uint8_t* p0 = s + x0[x] * 3;
        const uint8_t* p1 = s + x1[x] * 3;
        for (int c = 0; c < 3; ++c)
          out[x * 3 + c] = p0[c] * a0[x] + p1[c] * a1[x];
      }
      done[y] = 1;
    }
    return out;
  };
  for (int y = 0; y < dh; ++y) {
    const int* r0 = hrow(y0[y]);
    const int* r1 = hrow(y1[y]);
    const int w0 = b0[y], w1 = b1[y];
    uint8_t* out = dst + size_t(y) * n;
    for (int i = 0; i < n; ++i) {
      int p0 = (int(sat_s16(r0[i] >> 4)) * w0) >> 16;
      int p1 = (int(sat_s16(r1[i] >> 4)) * w1) >> 16;
      out[i] = sat_u8(int16_t(p0 + p1 + 2) >> 2);
    }
  }
}

constexpr int kHsvShift = 12;

struct HsvTables {
  int sdiv[256], hdiv[256];
  HsvTables() {
    sdiv[0] = hdiv[0] = 0;
    for (int i = 1; i < 256; ++i) {
      sdiv[i] = int(std::nearbyint((255 << kHsvShift) / (1.0 * i)));
      hdiv[i] = int(std::nearbyint((180 << kHsvShift) / (6.0 * i)));
    }
  }
};

void rgb2hsv(const uint8_t* src, uint8_t* dst, size_t n) {
  static const HsvTables t;
  for (size_t i = 0; i < n; ++i, src += 3, dst += 3) {
    int r = src[0], g = src[1], b = src[2];
    int v = b > g ? b : g;
    v = v > r ? v : r;
    int vmin = b < g ? b : g;
    vmin = vmin < r ? vmin : r;
    int diff = v - vmin;
    int vr = v == r ? -1 : 0, vg = v == g ? -1 : 0;
    int s = (diff * t.sdiv[v] + (1 << (kHsvShift - 1))) >> kHsvShift;
    int h = (vr & (g - b)) +
            (~vr & ((vg & (b - r + 2 * diff)) + (~vg & (r - g + 4 * diff))));
    h = (h * t.hdiv[diff] + (1 << (kHsvShift - 1))) >> kHsvShift;
    h += h < 0 ? 180 : 0;
    dst[0] = sat_u8(h);
    dst[1] = uint8_t(s);
    dst[2] = uint8_t(v);
  }
}

// OpenCV converts each row's pixels in blocks of kHsvBlock with SIMD,
// storing the float results truncated, and the rest of the row (fewer than
// kHsvBlock pixels) with its scalar code, rounding half to even.  Both use
// fused multiply-adds for 1 - s h.  The block is what OpenCV 5's x86-64
// dispatch (AVX-512) processes at once.
constexpr int kHsvBlock = 32;

void hsv2rgb(const uint8_t* src, uint8_t* dst, int w, int h) {
  static const int sector_data[6][3] = {{1, 3, 0}, {1, 0, 2}, {3, 0, 1},
                                        {0, 2, 1}, {0, 1, 3}, {2, 1, 0}};
  const float hscale = 6.f / 180.f;
  const float inv255 = 1.f / 255.f;
  const int vec_end = w / kHsvBlock * kHsvBlock;
  for (int y = 0; y < h; ++y)
    for (int x = 0; x < w; ++x, src += 3, dst += 3) {
      float hh = src[0] * hscale;
      const float s = src[1] * inv255, v = src[2] * inv255;
      int sector = int(std::floor(hh));
      hh -= float(sector);
      if (unsigned(sector) >= 6u) {   // hue past 179: not an OpenCV hue
        sector = 0;
        hh = 0.f;
      }
      const float tab[4] = {v, v * (1.f - s), v * std::fma(-s, hh, 1.f),
                            v * std::fma(-s, 1.f - hh, 1.f)};
      const float r = tab[sector_data[sector][2]] * 255.f;
      const float g = tab[sector_data[sector][1]] * 255.f;
      const float b = tab[sector_data[sector][0]] * 255.f;
      if (x < vec_end) {
        dst[0] = uint8_t(r);
        dst[1] = uint8_t(g);
        dst[2] = uint8_t(b);
      } else {
        dst[0] = sat_u8(round_even(r));
        dst[1] = sat_u8(round_even(g));
        dst[2] = sat_u8(round_even(b));
      }
    }
}

// BORDER_REFLECT_101: ... 2 1 | 0 1 2 ... n-1 | n-2 n-3 ...
inline int reflect101(int p, int n) {
  if (n == 1) return 0;
  while (p < 0 || p >= n) p = p < 0 ? -p : 2 * n - 2 - p;
  return p;
}

void filter2d_u8(const uint8_t* src, int w, int h, uint8_t* dst,
                 const float* kernel, int kw, int kh) {
  const int ax = kw / 2, ay = kh / 2;
  std::vector<int> ky, kx;
  std::vector<float> kv;
  for (int i = 0; i < kh; ++i)
    for (int j = 0; j < kw; ++j)
      if (kernel[i * kw + j] != 0.f) {
        ky.push_back(i - ay);
        kx.push_back(j - ax);
        kv.push_back(kernel[i * kw + j]);
      }
  const size_t nz = kv.size();
  std::vector<int> cols(size_t(w) * kw);      // reflected column per tap
  for (int x = 0; x < w; ++x)
    for (int j = 0; j < kw; ++j)
      cols[size_t(x) * kw + j] = reflect101(x + j - ax, w);
  for (int y = 0; y < h; ++y) {
    uint8_t* out = dst + size_t(y) * w * 3;
    for (int x = 0; x < w; ++x)
      for (int c = 0; c < 3; ++c) {
        float s = 0.f;
        for (size_t k = 0; k < nz; ++k) {
          int yy = reflect101(y + ky[k], h);
          int xx = cols[size_t(x) * kw + kx[k] + ax];
          s = std::fma(kv[k], float(src[(size_t(yy) * w + xx) * 3 + c]), s);
        }
        out[x * 3 + c] = sat_u8(round_even(s));
      }
  }
}

void gauss_u8(const uint8_t* src, int w, int h, uint8_t* dst,
              const uint16_t* taps, int n) {
  const int r = n / 2;
  std::vector<uint32_t> tmp(size_t(w) * h * 3);   // Q8 row sums
  for (int y = 0; y < h; ++y) {
    const uint8_t* s = src + size_t(y) * w * 3;
    uint32_t* t = tmp.data() + size_t(y) * w * 3;
    for (int x = 0; x < w; ++x)
      for (int c = 0; c < 3; ++c) {
        uint32_t acc = 0;
        for (int k = 0; k < n; ++k)
          acc += uint32_t(taps[k]) * s[reflect101(x + k - r, w) * 3 + c];
        t[x * 3 + c] = acc;
      }
  }
  for (int y = 0; y < h; ++y) {
    uint8_t* out = dst + size_t(y) * w * 3;
    for (int i = 0; i < w * 3; ++i) {
      uint64_t acc = 0;
      for (int k = 0; k < n; ++k)
        acc += uint64_t(taps[k]) *
               tmp[size_t(reflect101(y + k - r, h)) * w * 3 + i];
      uint64_t v = (acc + (1u << 15)) >> 16;
      out[i] = uint8_t(v > 255 ? 255 : v);
    }
  }
}

void warp_f32(const float* src, int w, int h, const double* m6,
              float* dst) {
  double m[6];
  for (int i = 0; i < 6; ++i) m[i] = m6[i];
  double d = m[0] * m[4] - m[1] * m[3];
  d = d != 0 ? 1. / d : 0;
  const double a11 = m[4] * d, a22 = m[0] * d;
  m[0] = a11;
  m[1] *= -d;
  m[3] *= -d;
  m[4] = a22;
  const double b1 = -m[0] * m[2] - m[1] * m[5];
  const double b2 = -m[3] * m[2] - m[4] * m[5];
  m[2] = b1;
  m[5] = b2;
  float mf[6];
  for (int i = 0; i < 6; ++i) mf[i] = float(m[i]);
  auto at = [&](int y, int x) -> float {
    return x >= 0 && x < w && y >= 0 && y < h ? src[size_t(y) * w + x] : 0.f;
  };
  for (int y = 0; y < h; ++y)
    for (int x = 0; x < w; ++x) {
      const float xf = float(x), yf = float(y);
      const float sx = std::fma(xf, mf[0], yf * mf[1]) + mf[2];
      const float sy = std::fma(xf, mf[3], yf * mf[4]) + mf[5];
      const int ix = int(std::floor(sx)), iy = int(std::floor(sy));
      const float a = sx - float(ix), b = sy - float(iy);
      const float p00 = at(iy, ix), p01 = at(iy, ix + 1);
      const float p10 = at(iy + 1, ix), p11 = at(iy + 1, ix + 1);
      const float v0 = std::fma(a, p01 - p00, p00);
      const float v1 = std::fma(a, p11 - p10, p10);
      dst[size_t(y) * w + x] = std::fma(b, v1 - v0, v0);
    }
}

}  // namespace

extern "C" {

void aug_resize_u8(const uint8_t* src, int sw, int sh, uint8_t* dst, int dw,
                   int dh) {
  resize_u8(src, sw, sh, dst, dw, dh);
}

void aug_rgb2hsv(const uint8_t* src, uint8_t* dst, size_t n) {
  rgb2hsv(src, dst, n);
}

void aug_hsv2rgb(const uint8_t* src, uint8_t* dst, int w, int h) {
  hsv2rgb(src, dst, w, h);
}

void aug_filter2d_u8(const uint8_t* src, int w, int h, uint8_t* dst,
                     const float* kernel, int kw, int kh) {
  filter2d_u8(src, w, h, dst, kernel, kw, kh);
}

void aug_gauss_u8(const uint8_t* src, int w, int h, uint8_t* dst,
                  const uint16_t* taps, int n) {
  gauss_u8(src, w, h, dst, taps, n);
}

void aug_warp_f32(const float* src, int w, int h, const double* m6,
                  float* dst) {
  warp_f32(src, w, h, m6, dst);
}

}  // extern "C"
