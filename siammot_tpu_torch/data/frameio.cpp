// The port's libjpeg frame reader: its own copy of the JAX package's
// csrc/frameio.cpp, so its bytes are the JAX package's native path's bytes.
// Multi-threaded JPEG decode with libjpeg fused with a bilinear resize and
// normalization, for the dataset-inference host path on the CPU (MOT17 /
// CrowdHuman / COCO are JPEG image corpora).
// siammot_tpu_torch/data/native.py builds it with g++ at first use and binds
// it with ctypes.
//
// C ABI (ctypes-friendly):
//   fio_decode_file(path, out_w, out_h, mean3, std3, out_f32)   -> 0/err
//   fio_decode_batch(n, paths, out_w, out_h, mean3, std3, out)  -> 0/err
//   fio_decode_file_u8(path, out_w, out_h, out_u8)              -> 0/err
//   fio_decode_batch_u8(n, paths, out_w, out_h, out_u8)         -> 0/err
//   fio_pool_create(n_threads) / fio_pool_destroy()
//   fio_image_size(path, &w, &h)                                -> 0/err
//   fio_jpeg_roundtrip_u8(rgb, w, h, quality, out_rgb)          -> 0/err
//     (the augmentation's JPEG compression: encode in memory at `quality`
//     with libjpeg's defaults, as cv2.imencode does -- 4:2:0 chroma,
//     baseline tables, the islow DCT -- then decode as above)
//   fio_mem_size(data, len, &w, &h)                             -> 0/err
//   fio_decode_mem_u8(data, len, w, h, out_u8)                  -> 0/err
//     (a JPEG held in memory, such as a video packet, at its own size)
//   fio_encode_u8(rgb, w, h, quality, &buf, &len)               -> 0/err
//   fio_free(buf)
//     (encode as the round trip does, as cv2.imencode / cv2.imwrite do;
//     the caller copies the stream out and frees it)

#include <cstddef>
#include <cstdio>

#include <jpeglib.h>

#include <atomic>
#include <cmath>
#include <condition_variable>
#include <csetjmp>
#include <cstdint>
#include <cstdlib>
#include <cstdio>
#include <cstring>
#include <functional>
#include <mutex>
#include <queue>
#include <thread>
#include <vector>

namespace {

struct JpegError {
  jpeg_error_mgr mgr;
  jmp_buf jump;
};

void jpeg_error_exit(j_common_ptr cinfo) {
  auto* err = reinterpret_cast<JpegError*>(cinfo->err);
  longjmp(err->jump, 1);
}

// Decode a JPEG file into an RGB8 buffer. Returns 0 on success.
int decode_jpeg(const char* path, std::vector<uint8_t>* rgb, int* w, int* h) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;

  jpeg_decompress_struct cinfo;
  JpegError jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_error_exit;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    fclose(f);
    return -2;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);

  *w = cinfo.output_width;
  *h = cinfo.output_height;
  rgb->resize(size_t(*w) * *h * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    JSAMPROW row = rgb->data() + size_t(cinfo.output_scanline) * *w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  fclose(f);
  return 0;
}

// Bilinear resize RGB8 -> normalized float32 HWC: ((x/255) - mean) / std.
// Samples at cv2.INTER_LINEAR's half-pixel centres, in float: the JAX
// package's native reader's bytes, not cv2.resize's (OpenCV's 8-bit resize
// is fixed-point and differs by one on about a tenth of the bytes; the
// augmentation's exact port of it is augment.cpp).
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

int decode_resize_one(const char* path, int out_w, int out_h,
                      const float* mean, const float* stdv, float* out) {
  std::vector<uint8_t> rgb;
  int w = 0, h = 0;
  int rc = decode_jpeg(path, &rgb, &w, &h);
  if (rc != 0) return rc;
  resize_normalize(rgb.data(), w, h, out, out_w, out_h, mean, stdv);
  return 0;
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

int decode_resize_u8_one(const char* path, int out_w, int out_h,
                         uint8_t* out) {
  std::vector<uint8_t> rgb;
  int w = 0, h = 0;
  int rc = decode_jpeg(path, &rgb, &w, &h);
  if (rc != 0) return rc;
  resize_u8(rgb.data(), w, h, out, out_w, out_h);
  return 0;
}

// ---- persistent worker pool ------------------------------------------------

class Pool {
 public:
  explicit Pool(int n) : stop_(false) {
    for (int i = 0; i < n; ++i)
      workers_.emplace_back([this] { this->run(); });
  }
  ~Pool() {
    {
      std::lock_guard<std::mutex> lk(mu_);
      stop_ = true;
    }
    cv_.notify_all();
    for (auto& t : workers_) t.join();
  }
  void submit(std::function<void()> fn) {
    {
      std::lock_guard<std::mutex> lk(mu_);
      q_.push(std::move(fn));
    }
    cv_.notify_one();
  }

 private:
  void run() {
    for (;;) {
      std::function<void()> fn;
      {
        std::unique_lock<std::mutex> lk(mu_);
        cv_.wait(lk, [this] { return stop_ || !q_.empty(); });
        if (stop_ && q_.empty()) return;
        fn = std::move(q_.front());
        q_.pop();
      }
      fn();
    }
  }
  std::mutex mu_;
  std::condition_variable cv_;
  std::queue<std::function<void()>> q_;
  std::vector<std::thread> workers_;
  bool stop_;
};

Pool* g_pool = nullptr;

// Decode a JPEG held in memory into rgb (w x h x 3). Returns 0 on success,
// -5 if its size is not w x h.
int decode_jpeg_mem(const uint8_t* data, size_t len, int w, int h,
                    uint8_t* out) {
  jpeg_decompress_struct cinfo;
  JpegError jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_error_exit;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return -2;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(data), (unsigned long)len);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  if (int(cinfo.output_width) != w || int(cinfo.output_height) != h) {
    jpeg_destroy_decompress(&cinfo);
    return -5;
  }
  while (cinfo.output_scanline < cinfo.output_height) {
    JSAMPROW row = out + size_t(cinfo.output_scanline) * w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

int encode_jpeg(const uint8_t* rgb, int w, int h, int quality,
                unsigned char** buf, unsigned long* size) {
  jpeg_compress_struct cinfo;
  JpegError jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_error_exit;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_compress(&cinfo);
    free(*buf);
    *buf = nullptr;
    return -3;
  }
  jpeg_create_compress(&cinfo);
  jpeg_mem_dest(&cinfo, buf, size);
  cinfo.image_width = w;
  cinfo.image_height = h;
  cinfo.input_components = 3;
  cinfo.in_color_space = JCS_RGB;
  jpeg_set_defaults(&cinfo);
  jpeg_set_quality(&cinfo, quality, TRUE);
  jpeg_start_compress(&cinfo, TRUE);
  while (cinfo.next_scanline < cinfo.image_height) {
    JSAMPROW row = const_cast<uint8_t*>(rgb) +
                   size_t(cinfo.next_scanline) * w * 3;
    jpeg_write_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_compress(&cinfo);
  jpeg_destroy_compress(&cinfo);
  return 0;
}

int jpeg_roundtrip(const uint8_t* rgb, int w, int h, int quality,
                   uint8_t* out) {
  unsigned char* buf = nullptr;
  unsigned long size = 0;
  int rc = encode_jpeg(rgb, w, h, quality, &buf, &size);
  if (rc != 0) return rc;
  rc = decode_jpeg_mem(buf, size, w, h, out);
  free(buf);
  return rc == -2 ? -4 : rc;
}

}  // namespace

extern "C" {

int fio_mem_size(const uint8_t* data, size_t len, int* w, int* h) {
  jpeg_decompress_struct cinfo;
  JpegError jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_error_exit;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return -2;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(data), (unsigned long)len);
  jpeg_read_header(&cinfo, TRUE);
  *w = cinfo.image_width;
  *h = cinfo.image_height;
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

int fio_decode_mem_u8(const uint8_t* data, size_t len, int w, int h,
                      uint8_t* out) {
  return decode_jpeg_mem(data, len, w, h, out);
}

int fio_encode_u8(const uint8_t* rgb, int w, int h, int quality,
                  unsigned char** buf, unsigned long* len) {
  *buf = nullptr;
  *len = 0;
  return encode_jpeg(rgb, w, h, quality, buf, len);
}

void fio_free(unsigned char* buf) { free(buf); }

int fio_pool_create(int n_threads) {
  if (g_pool) return -1;
  g_pool = new Pool(n_threads > 0 ? n_threads
                                  : int(std::thread::hardware_concurrency()));
  return 0;
}

void fio_pool_destroy() {
  delete g_pool;
  g_pool = nullptr;
}

int fio_jpeg_roundtrip_u8(const uint8_t* rgb, int w, int h, int quality,
                          uint8_t* out) {
  return jpeg_roundtrip(rgb, w, h, quality, out);
}

int fio_image_size(const char* path, int* w, int* h) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  jpeg_decompress_struct cinfo;
  JpegError jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_error_exit;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    fclose(f);
    return -2;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  *w = cinfo.image_width;
  *h = cinfo.image_height;
  jpeg_destroy_decompress(&cinfo);
  fclose(f);
  return 0;
}

int fio_decode_file(const char* path, int out_w, int out_h, const float* mean,
                    const float* stdv, float* out) {
  return decode_resize_one(path, out_w, out_h, mean, stdv, out);
}

// Decode n files concurrently into out[n, out_h, out_w, 3].
int fio_decode_batch(int n, const char** paths, int out_w, int out_h,
                     const float* mean, const float* stdv, float* out) {
  if (!g_pool) fio_pool_create(0);
  std::atomic<int> remaining(n), status(0);
  std::mutex done_mu;
  std::condition_variable done_cv;
  const size_t stride = size_t(out_w) * out_h * 3;
  for (int i = 0; i < n; ++i) {
    g_pool->submit([&, i] {
      int rc = decode_resize_one(paths[i], out_w, out_h, mean, stdv,
                                 out + stride * i);
      if (rc != 0) status.store(rc);
      if (remaining.fetch_sub(1) == 1) {
        std::lock_guard<std::mutex> lk(done_mu);
        done_cv.notify_one();
      }
    });
  }
  std::unique_lock<std::mutex> lk(done_mu);
  done_cv.wait(lk, [&] { return remaining.load() == 0; });
  return status.load();
}

int fio_decode_file_u8(const char* path, int out_w, int out_h,
                       uint8_t* out) {
  return decode_resize_u8_one(path, out_w, out_h, out);
}

// Decode n files concurrently into out[n, out_h, out_w, 3] uint8.
int fio_decode_batch_u8(int n, const char** paths, int out_w, int out_h,
                        uint8_t* out) {
  if (!g_pool) fio_pool_create(0);
  std::atomic<int> remaining(n), status(0);
  std::mutex done_mu;
  std::condition_variable done_cv;
  const size_t stride = size_t(out_w) * out_h * 3;
  for (int i = 0; i < n; ++i) {
    g_pool->submit([&, i] {
      int rc = decode_resize_u8_one(paths[i], out_w, out_h, out + stride * i);
      if (rc != 0) status.store(rc);
      if (remaining.fetch_sub(1) == 1) {
        std::lock_guard<std::mutex> lk(done_mu);
        done_cv.notify_one();
      }
    });
  }
  std::unique_lock<std::mutex> lk(done_mu);
  done_cv.wait(lk, [&] { return remaining.load() == 0; });
  return status.load();
}

}  // extern "C"
