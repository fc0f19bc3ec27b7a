// The port's JPEG decoder on the card: nvJPEG from the CUDA toolkit decodes
// a file's bytes into interleaved RGB8 in device memory, on the caller's
// stream.  data/native.py builds it with g++ against the toolkit's nvjpeg.h
// and libnvjpeg at first use and binds it with ctypes; the resize to the
// network's input runs in bilinear.cpp, the JAX package's arithmetic.
//
// nvJPEG's inverse DCT and chroma upsampling are its own, so its bytes may
// differ from libjpeg's (the JAX package's decoder) by a few units.
//
// C ABI:
//   nvj_create(&reader) / nvj_destroy(reader)                 -> 0/err
//   nvj_image_size(reader, data, len, &w, &h)                 -> 0/err
//   nvj_decode_rgbi(reader, data, len, dev_out, w, h, stream) -> 0/err
// Errors are nvjpegStatus_t values; -100 means the image is not w x h.

#include <cstddef>

#include <nvjpeg.h>

namespace {

struct Reader {
  nvjpegHandle_t handle = nullptr;
  nvjpegJpegState_t state = nullptr;
};

}  // namespace

extern "C" {

int nvj_create(void** out) {
  Reader* r = new Reader;
  nvjpegStatus_t st = nvjpegCreateSimple(&r->handle);
  if (st == NVJPEG_STATUS_SUCCESS)
    st = nvjpegJpegStateCreate(r->handle, &r->state);
  if (st != NVJPEG_STATUS_SUCCESS) {
    if (r->handle) nvjpegDestroy(r->handle);
    delete r;
    return int(st);
  }
  *out = r;
  return 0;
}

void nvj_destroy(void* reader) {
  Reader* r = static_cast<Reader*>(reader);
  nvjpegJpegStateDestroy(r->state);
  nvjpegDestroy(r->handle);
  delete r;
}

int nvj_image_size(void* reader, const unsigned char* data, size_t len,
                   int* w, int* h) {
  Reader* r = static_cast<Reader*>(reader);
  int n = 0;
  nvjpegChromaSubsampling_t sub;
  int ws[NVJPEG_MAX_COMPONENT] = {0}, hs[NVJPEG_MAX_COMPONENT] = {0};
  nvjpegStatus_t st =
      nvjpegGetImageInfo(r->handle, data, len, &n, &sub, ws, hs);
  if (st != NVJPEG_STATUS_SUCCESS) return int(st);
  *w = ws[0];
  *h = hs[0];
  return 0;
}

// Decode into dev_out[h][w][3] (device memory, pitch 3 w) on `stream`;
// returns once the work is queued.
int nvj_decode_rgbi(void* reader, const unsigned char* data, size_t len,
                    unsigned char* dev_out, int w, int h, void* stream) {
  Reader* r = static_cast<Reader*>(reader);
  int iw = 0, ih = 0;
  int rc = nvj_image_size(reader, data, len, &iw, &ih);
  if (rc != 0) return rc;
  if (iw != w || ih != h) return -100;
  nvjpegImage_t img = {};
  img.channel[0] = dev_out;
  img.pitch[0] = size_t(3) * w;
  return int(nvjpegDecode(r->handle, r->state, data, len, NVJPEG_OUTPUT_RGBI,
                          &img, static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
