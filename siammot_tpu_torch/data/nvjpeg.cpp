// The port's JPEG decoder on the card: nvJPEG from the CUDA toolkit decodes
// a file's bytes into interleaved RGB8 in device memory, on the caller's
// stream.  data/native.py builds it with g++ against the toolkit's nvjpeg.h
// and libnvjpeg at first use and binds it with ctypes; the resize to the
// network's input runs in bilinear.cpp, the JAX package's arithmetic.
//
// The training augmentation's JPEG compression encodes with nvJPEG's
// encoder (quality, 4:2:0 chroma, Huffman tables not optimised, as
// cv2.imencode's libjpeg defaults) and decodes the stream back with the
// decoder.
//
// nvJPEG's DCTs, quantisation rounding and chroma resampling are its own,
// so its bytes may differ from libjpeg's (the JAX package's) by a few
// units.
//
// C ABI:
//   nvj_create(&reader) / nvj_destroy(reader)                 -> 0/err
//   nvj_image_size(reader, data, len, &w, &h)                 -> 0/err
//   nvj_decode_rgbi(reader, data, len, dev_out, w, h, stream) -> 0/err
//   nvj_encode_rgbi(reader, dev_in, w, h, quality, stream, &len) -> 0/err
//     (queues the encode; len: the stream's size in bytes)
//   nvj_encoded_bytes(reader, host_out, &len, stream)         -> 0/err
//     (after the stream has finished: copies the stream out)
// Errors are nvjpegStatus_t values; -100 means the image is not w x h.

#include <cstddef>

#include <nvjpeg.h>

namespace {

struct Reader {
  nvjpegHandle_t handle = nullptr;
  nvjpegJpegState_t state = nullptr;
  nvjpegEncoderState_t enc_state = nullptr;      // made at the first encode
  nvjpegEncoderParams_t enc_params = nullptr;
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
  if (r->enc_params) nvjpegEncoderParamsDestroy(r->enc_params);
  if (r->enc_state) nvjpegEncoderStateDestroy(r->enc_state);
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

// Encode dev_in[h][w][3] (device memory, RGB, pitch 3 w) at `quality` with
// 4:2:0 chroma on `stream`; *len receives the stream's size.
int nvj_encode_rgbi(void* reader, const unsigned char* dev_in, int w, int h,
                    int quality, void* stream, size_t* len) {
  Reader* r = static_cast<Reader*>(reader);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  nvjpegStatus_t st = NVJPEG_STATUS_SUCCESS;
  if (!r->enc_state) {
    st = nvjpegEncoderStateCreate(r->handle, &r->enc_state, s);
    if (st != NVJPEG_STATUS_SUCCESS) return int(st);
    st = nvjpegEncoderParamsCreate(r->handle, &r->enc_params, s);
    if (st != NVJPEG_STATUS_SUCCESS) return int(st);
  }
  st = nvjpegEncoderParamsSetQuality(r->enc_params, quality, s);
  if (st == NVJPEG_STATUS_SUCCESS)
    st = nvjpegEncoderParamsSetSamplingFactors(r->enc_params, NVJPEG_CSS_420,
                                               s);
  if (st == NVJPEG_STATUS_SUCCESS)
    st = nvjpegEncoderParamsSetOptimizedHuffman(r->enc_params, 0, s);
  if (st != NVJPEG_STATUS_SUCCESS) return int(st);
  nvjpegImage_t img = {};
  img.channel[0] = const_cast<unsigned char*>(dev_in);
  img.pitch[0] = size_t(3) * w;
  st = nvjpegEncodeImage(r->handle, r->enc_state, r->enc_params, &img,
                         NVJPEG_INPUT_RGBI, w, h, s);
  if (st != NVJPEG_STATUS_SUCCESS) return int(st);
  return int(nvjpegEncodeRetrieveBitstream(r->handle, r->enc_state, nullptr,
                                           len, s));
}

int nvj_encoded_bytes(void* reader, unsigned char* out, size_t* len,
                      void* stream) {
  Reader* r = static_cast<Reader*>(reader);
  return int(nvjpegEncodeRetrieveBitstream(
      r->handle, r->enc_state, out, len, static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
