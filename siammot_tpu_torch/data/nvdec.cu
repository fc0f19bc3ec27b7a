// The port's video decoder on the card: NVIDIA's hardware decoder (NVDEC)
// through NVIDIA's libnvcuvid.so.1, and the kernels that turn its NV12, P016
// and YUV444 frames into the RGB bytes cv2 gives.  data/native.py builds this file
// with nvcc at first use and data/nvdec.py binds it with ctypes.
//
// The machine with the card has NVIDIA's libnvcuvid.so.1 but not the
// Video Codec SDK's headers, so the part of cuviddec.h and nvcuvid.h that
// is used is declared below by hand, laid out as SDK 12.x lays it out
// (reserved tails included and zeroed: libnvcuvid reads as much as its own
// header says), and the library is opened with dlopen at first use.  The
// CUDA API's libcuda.so.1 is opened the same way, for the current
// context.  tests/test_torch_video_codecs.py holds data/nvdec.py's ctypes
// mirrors of these structs to the sizes and offsets written there.  The
// parser takes H.264 and HEVC as Annex B, MPEG-4 Part 2, VP8 and VP9 frames
// (a VP9 superframe whole) and AV1 temporal units of low-overhead OBUs, as
// data/container.py makes them.  A stream is 8-, 10- or 12-bit, 4:2:0
// or 4:4:4 (data/container.py refuses the rest before any driver call, and
// the sequence callback again); the decoder writes NV12 (8-bit 4:2:0), P016
// (10- and 12-bit 4:2:0, each sample in the top bits of a 16-bit word),
// YUV444 (8-bit 4:4:4) or YUV444_16Bit surfaces.
//
// A session is one parser and one decoder on PyTorch's primary context of
// the caller's device.  The parser's callbacks stay here: the sequence
// callback checks cuvidGetDecoderCaps at the stream's chroma format and bit
// depth, and its output format mask, and creates the decoder with the
// parser's min_num_decode_surfaces (returned to the parser), cropped to the
// display area; the decode callback hands the parser's picture parameters
// to the decoder; the display callback maps the picture (post-processed on
// the caller's stream) and queues it.  The caller drains the queue after
// each parse call: a conversion kernel reads the mapped surface, the RGB
// frame is copied to the host (which waits for the stream), then the
// frame is unmapped.
//
// The conversions replace no TPU kernel.  nv12_to_rgb: the JAX package reads video through
// cv2, whose FFmpeg backend converts with swscale.  Same-size YUV 4:2:0 to
// BGR24 takes swscale's unscaled x86 SIMD route (libswscale/x86/yuv2rgb):
// BT.601 limited range, each 2x2 block sharing its chroma sample (no
// interpolation), 16-bit fixed point.  With Y, U, V bytes:
//   y' = ((8 Y - 128) * 9539) >> 16
//   R = sat(y' + (((8 V - 1024) * 13075) >> 16))
//   G = sat(y' + (((8 U - 1024) * -3209) >> 16) + (((8 V - 1024) * -6660) >> 16))
//   B = sat(y' + (((8 U - 1024) * 16525) >> 16))
// (pmulhw: the high half of a 16x16-bit product, an arithmetic shift).  A
// CPU run matched cv2's frames of the H.264 fixture bit for bit.  The
// kernel is bound by bytes (1.5 read and 3 written a pixel); one thread a
// pixel, a block of 256 along a row.
//
// p016_to_rgb and yuv444_to_rgb give what cv2 gives for FFmpeg's
// yuv420p10le / yuv420p12le and yuv444p / yuv444p10le / yuv444p12le frames.
// cv2 hands swscale the frame with its chroma location, and these formats
// take swscale's generic scaler (SWS_BICUBIC), each source line first
// scaled horizontally to a 15-bit intermediate (hScale: sample s of depth d
// times 14-bit coefficients, >> (d - 1), at most 32767; the identity gives
// s << (15 - d)).  A CPU run of cv2's own libswscale matched these rules on
// random planes at 10 and 12 bits (and 8 for 4:4:4), at 128x64 to 1280x720,
// and cv2's frames of lossless x265 streams bit for bit.
//
// 4:4:4 (the "full chroma" output, SWS_FULL_CHR_H_INT, which swscale turns
// on for unsubsampled input): with the 15-bit Y, U, V,
//   Y' = (4 Y - 8192) * 9539 + 2^21,  U' = 4 (U - 16384),  V' = 4 (V - 16384)
//   R = Y' + 13075 V',  G = Y' - 6660 V' - 3209 U',  B = Y' + 16525 U'
// summed in unsigned 32-bit words (a bright Y with a high U or V wraps past
// 2^31 and comes out 0, as in swscale), then sat(x >> 22).
//
// 4:2:0 with an even width (odd widths and fewer than 9 rows take other
// swscale routes and are refused): each pair of pixels shares one chroma
// column.  The chroma columns are filtered horizontally to as many columns
// (the identity when the chroma is centred; a bicubic shift of a quarter
// chroma sample when it is left-sited, as HEVC reports by default), and the
// chroma rows up to the frame's rows by the bicubic filter (B 0, C 0.6:
// four taps of 1/4096, folded into the plane at its edges).  The filters
// are swscale's initFilter's, built on the host (data/nvdec.py:
// chroma_filters) and read here as (first index, taps) tables.  Every row
// but the last two then takes swscale's x86 vertical scaler (the MMX
// YSCALEYUV2RGBX: each tap a pmulhw, a rounder of 4), with the 15-bit
// chroma taps c_j, coefficients f_j and luma Y:
//   U = 4 + sum_j ((c_j f_j) >> 16) - 1024 (and V),  y = 4 + (Y >> 4)
//   then nv12_to_rgb's arithmetic on (y - 128, U, V): yy = ((y - 128) *
//   9539) >> 16, R = sat(yy + ((V 13075) >> 16)), ...
// and the last two rows its C scaler (swscale runs them without MMX):
//   U = sat((2^18 + sum_j c_j f_j) >> 19) (and V), Y1 = (2^18 + 4096 Y) >> 19
//   R = T[663 + ((V 89830) >> 16) + Y1]
//   G = T[972 + ((U -22049) >> 16) + ((V -45756) >> 16) + Y1]
//   B = T[617 + ((U 113537) >> 16) + Y1]
//   T[i] = sat((-65284608 + 76309 i + 2^15) >> 16)
// (swscale's yuv2rgb tables for BT.601 limited range, the coefficients
// scaled by 76309 = 2^16 * 255 / 219).  All three kernels use BT.601
// limited range: what swscale takes for a stream that signals no colour
// description.  One thread a pixel; bound by bytes.
//
// C ABI (0 or an error code; nvd_error() holds the text of the last error
// on the calling thread):
//   nvd_load()                                   opens the libraries
//   nvd_caps(device, codec, chroma, depth, out[8])  (codec: a
//     cudaVideoCodec, chroma a cudaVideoChromaFormat); the driver's
//     CUresult where cuvidGetDecoderCaps fails, -1 where a step before it
//     does; out: supported, NVDECs, output format mask, max width, max
//     height, max macroblocks, min width, min height
//   nvd_create(device, codec, &session) / nvd_destroy(session)
//   nvd_parse(session, data, size, flags, stream)  flags: 1 end of stream
//   nvd_ready(session)                           mapped frames queued
//   nvd_front(session, &ptr, &pitch, &width, &height, &chroma_row,
//             &surface_format, &depth)
//   nvd_release(session)                         unmaps the front frame
//   nvd_nv12_to_rgb(luma, chroma, pitch, width, height, rgb, stream)
//   nvd_p016_to_rgb(luma, chroma, pitch, width, height, depth, hpos, hcoef,
//                   taps, vpos, vcoef, taps, rgb, stream)
//   nvd_yuv444_to_rgb(luma, cb, pitch, width, height, depth, rgb, stream)
//     (Cr follows Cb after (height + 1) & ~1 rows)

#include <cuda.h>
#include <cuda_runtime.h>
#include <dlfcn.h>

#include <cstddef>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <string>

#define NVD_API extern "C" __attribute__((visibility("default")))

// -- the Video Codec SDK 12.x declarations used -------------------------------

typedef void* CUvideodecoder;
typedef void* CUvideoparser;
typedef void* CUvideoctxlock;
typedef long long CUvideotimestamp;
struct CUVIDPICPARAMS;                  // opaque: from the parser to the decoder

// cudaVideoCodec: the codecs data/nvdec.py's CODEC_IDS names
enum { kCodecMPEG4 = 2, kCodecH264 = 4, kCodecHEVC = 8, kCodecVP8 = 9,
       kCodecVP9 = 10, kCodecAV1 = 11 };
enum { kChroma420 = 1, kChroma444 = 3 };            // cudaVideoChromaFormat
enum { kSurfaceNV12 = 0, kSurfaceP016 = 1,           // cudaVideoSurfaceFormat
       kSurfaceYUV444 = 2, kSurfaceYUV444_16Bit = 3 };
enum { kDeinterlaceWeave = 0 };                      // cudaVideoDeinterlaceMode
enum { kCreatePreferCUVID = 4 };                     // cudaVideoCreateFlags
enum { kPktEndOfStream = 1 };                        // CUVID_PKT_ENDOFSTREAM

struct CUVIDDECODECAPS {                             // 88 bytes
  int eCodecType;
  int eChromaFormat;
  unsigned int nBitDepthMinus8;
  unsigned int reserved1[3];
  unsigned char bIsSupported;
  unsigned char nNumNVDECs;
  unsigned short nOutputFormatMask;
  unsigned int nMaxWidth;
  unsigned int nMaxHeight;
  unsigned int nMaxMBCount;
  unsigned short nMinWidth;
  unsigned short nMinHeight;
  unsigned char bIsHistogramSupported;
  unsigned char nCounterBitDepth;
  unsigned short nMaxHistogramBins;
  unsigned int reserved3[10];
};

struct Rect16 {
  short left, top, right, bottom;
};

struct CUVIDDECODECREATEINFO {                       // 176 bytes
  unsigned long ulWidth;
  unsigned long ulHeight;
  unsigned long ulNumDecodeSurfaces;
  int CodecType;
  int ChromaFormat;
  unsigned long ulCreationFlags;
  unsigned long bitDepthMinus8;
  unsigned long ulIntraDecodeOnly;
  unsigned long ulMaxWidth;
  unsigned long ulMaxHeight;
  unsigned long Reserved1;
  Rect16 display_area;
  int OutputFormat;
  int DeinterlaceMode;
  unsigned long ulTargetWidth;
  unsigned long ulTargetHeight;
  unsigned long ulNumOutputSurfaces;
  CUvideoctxlock vidLock;
  Rect16 target_rect;
  unsigned long enableHistogram;
  unsigned long Reserved2[4];
};

struct CUVIDPROCPARAMS {                             // 264 bytes
  int progressive_frame;
  int second_field;
  int top_field_first;
  int unpaired_field;
  unsigned int reserved_flags;
  unsigned int reserved_zero;
  unsigned long long raw_input_dptr;
  unsigned int raw_input_pitch;
  unsigned int raw_input_format;
  unsigned long long raw_output_dptr;
  unsigned int raw_output_pitch;
  unsigned int Reserved1;
  CUstream output_stream;
  unsigned int Reserved[46];
  unsigned long long* histogram_dptr;
  void* Reserved2[1];
};

struct CUVIDEOFORMAT {                               // 64 bytes
  int codec;
  struct {
    unsigned int numerator, denominator;
  } frame_rate;
  unsigned char progressive_sequence;
  unsigned char bit_depth_luma_minus8;
  unsigned char bit_depth_chroma_minus8;
  unsigned char min_num_decode_surfaces;
  unsigned int coded_width;
  unsigned int coded_height;
  struct {
    int left, top, right, bottom;
  } display_area;
  int chroma_format;
  unsigned int bitrate;
  struct {
    int x, y;
  } display_aspect_ratio;
  unsigned char video_signal_description[4];         // bitfields, 3 bytes
  unsigned int seqhdr_data_length;
};

struct CUVIDPARSERDISPINFO {                         // 24 bytes
  int picture_index;
  int progressive_frame;
  int top_field_first;
  int repeat_first_field;
  CUvideotimestamp timestamp;
};

typedef int (*SequenceCallback)(void*, CUVIDEOFORMAT*);
typedef int (*DecodeCallback)(void*, CUVIDPICPARAMS*);
typedef int (*DisplayCallback)(void*, CUVIDPARSERDISPINFO*);

struct CUVIDPARSERPARAMS {                           // 136 bytes
  int CodecType;
  unsigned int ulMaxNumDecodeSurfaces;
  unsigned int ulClockRate;
  unsigned int ulErrorThreshold;
  unsigned int ulMaxDisplayDelay;
  unsigned int flags;                                // bAnnexb : 1 etc.
  unsigned int uReserved1[4];
  void* pUserData;
  SequenceCallback pfnSequenceCallback;
  DecodeCallback pfnDecodePicture;
  DisplayCallback pfnDisplayPicture;
  void* pfnGetOperatingPoint;
  void* pfnGetSEIMsg;
  void* pvReserved2[5];
  void* pExtVideoInfo;
};

struct CUVIDSOURCEDATAPACKET {                       // 32 bytes
  unsigned long flags;
  unsigned long payload_size;
  const unsigned char* payload;
  CUvideotimestamp timestamp;
};

static_assert(sizeof(CUVIDDECODECAPS) == 88, "CUVIDDECODECAPS");
static_assert(sizeof(CUVIDDECODECREATEINFO) == 176, "CUVIDDECODECREATEINFO");
static_assert(offsetof(CUVIDDECODECREATEINFO, vidLock) == 120, "vidLock");
static_assert(sizeof(CUVIDPROCPARAMS) == 264, "CUVIDPROCPARAMS");
static_assert(offsetof(CUVIDPROCPARAMS, output_stream) == 56, "stream");
static_assert(sizeof(CUVIDEOFORMAT) == 64, "CUVIDEOFORMAT");
static_assert(sizeof(CUVIDPARSERDISPINFO) == 24, "CUVIDPARSERDISPINFO");
static_assert(sizeof(CUVIDPARSERPARAMS) == 136, "CUVIDPARSERPARAMS");
static_assert(offsetof(CUVIDPARSERPARAMS, pUserData) == 40, "pUserData");
static_assert(sizeof(CUVIDSOURCEDATAPACKET) == 32, "CUVIDSOURCEDATAPACKET");

// -- the libraries, opened at first use ---------------------------------------

namespace {

thread_local std::string g_error;

struct Api {
  CUresult (*ctxGetCurrent)(CUcontext*);
  CUresult (*ctxPush)(CUcontext);
  CUresult (*ctxPop)(CUcontext*);
  CUresult (*getErrorName)(CUresult, const char**);
  CUresult (*getDecoderCaps)(CUVIDDECODECAPS*);
  CUresult (*createDecoder)(CUvideodecoder*, CUVIDDECODECREATEINFO*);
  CUresult (*destroyDecoder)(CUvideodecoder);
  CUresult (*decodePicture)(CUvideodecoder, CUVIDPICPARAMS*);
  CUresult (*mapFrame)(CUvideodecoder, int, unsigned long long*,
                       unsigned int*, CUVIDPROCPARAMS*);
  CUresult (*unmapFrame)(CUvideodecoder, unsigned long long);
  CUresult (*createParser)(CUvideoparser*, CUVIDPARSERPARAMS*);
  CUresult (*parse)(CUvideoparser, CUVIDSOURCEDATAPACKET*);
  CUresult (*destroyParser)(CUvideoparser);
  CUresult (*lockCreate)(CUvideoctxlock*, CUcontext);
  CUresult (*lockDestroy)(CUvideoctxlock);
};

Api g_api;
bool g_loaded = false;

int fail(const std::string& what) {
  g_error = what;
  return -1;
}

std::string cu_text(CUresult r) {
  const char* name = nullptr;
  if (g_api.getErrorName) g_api.getErrorName(r, &name);
  return std::string(name ? name : "CUresult") + " (" + std::to_string(r) +
         ")";
}

template <typename F>
bool sym(void* lib, const char* name, F* out, const char* file) {
  *out = reinterpret_cast<F>(dlsym(lib, name));
  if (!*out) g_error = std::string(file) + " has no " + name;
  return *out != nullptr;
}

int load() {
  if (g_loaded) return 0;
  void* cuda = dlopen("libcuda.so.1", RTLD_NOW | RTLD_GLOBAL);
  if (!cuda) return fail(std::string("dlopen libcuda.so.1: ") + dlerror());
  void* cuvid = dlopen("libnvcuvid.so.1", RTLD_NOW | RTLD_GLOBAL);
  if (!cuvid)
    return fail(std::string("dlopen libnvcuvid.so.1 (NVIDIA's NVDEC "
                            "library): ") + dlerror());
  const char* a = "libcuda.so.1";
  const char* v = "libnvcuvid.so.1";
  bool ok = sym(cuda, "cuCtxGetCurrent", &g_api.ctxGetCurrent, a) &&
            sym(cuda, "cuCtxPushCurrent_v2", &g_api.ctxPush, a) &&
            sym(cuda, "cuCtxPopCurrent_v2", &g_api.ctxPop, a) &&
            sym(cuda, "cuGetErrorName", &g_api.getErrorName, a) &&
            sym(cuvid, "cuvidGetDecoderCaps", &g_api.getDecoderCaps, v) &&
            sym(cuvid, "cuvidCreateDecoder", &g_api.createDecoder, v) &&
            sym(cuvid, "cuvidDestroyDecoder", &g_api.destroyDecoder, v) &&
            sym(cuvid, "cuvidDecodePicture", &g_api.decodePicture, v) &&
            sym(cuvid, "cuvidMapVideoFrame64", &g_api.mapFrame, v) &&
            sym(cuvid, "cuvidUnmapVideoFrame64", &g_api.unmapFrame, v) &&
            sym(cuvid, "cuvidCreateVideoParser", &g_api.createParser, v) &&
            sym(cuvid, "cuvidParseVideoData", &g_api.parse, v) &&
            sym(cuvid, "cuvidDestroyVideoParser", &g_api.destroyParser, v) &&
            sym(cuvid, "cuvidCtxLockCreate", &g_api.lockCreate, v) &&
            sym(cuvid, "cuvidCtxLockDestroy", &g_api.lockDestroy, v);
  if (!ok) return -1;
  g_loaded = true;
  return 0;
}

// the primary context of `device`, current on this thread
int primary_context(int device, CUcontext* ctx) {
  cudaError_t e = cudaSetDevice(device);
  if (e == cudaSuccess) e = cudaFree(nullptr);
  if (e != cudaSuccess)
    return fail(std::string("cudaSetDevice: ") + cudaGetErrorString(e));
  CUresult r = g_api.ctxGetCurrent(ctx);
  if (r != CUDA_SUCCESS || !*ctx)
    return fail("cuCtxGetCurrent: " + cu_text(r));
  return 0;
}

// the surface an NVDEC decoder writes for a stream of this chroma format and
// bit depth
int surface_format(int chroma, int depth) {
  if (chroma == kChroma444) return depth > 8 ? kSurfaceYUV444_16Bit
                                             : kSurfaceYUV444;
  return depth > 8 ? kSurfaceP016 : kSurfaceNV12;
}

// the driver's CUresult (0: the caps are filled in)
int query_caps(int codec, int chroma, int depth, CUVIDDECODECAPS* caps) {
  std::memset(caps, 0, sizeof(*caps));
  caps->eCodecType = codec;
  caps->eChromaFormat = chroma;
  caps->nBitDepthMinus8 = depth - 8;
  CUresult r = g_api.getDecoderCaps(caps);
  if (r != CUDA_SUCCESS) g_error = "cuvidGetDecoderCaps: " + cu_text(r);
  return static_cast<int>(r);
}

struct Frame {
  unsigned long long ptr;
  unsigned int pitch;
};

struct Session {
  int device = 0;
  int codec = 0;
  CUcontext ctx = nullptr;
  CUvideoctxlock lock = nullptr;
  CUvideoparser parser = nullptr;
  CUvideodecoder decoder = nullptr;
  CUVIDEOFORMAT format = {};
  int surfaces = 0;
  int width = 0, height = 0;
  int output_format = kSurfaceNV12, depth = 8;
  CUstream stream = nullptr;
  std::deque<Frame> ready;
  std::string error;                   // set by a callback that failed

  int sequence(CUVIDEOFORMAT* f) {
    if (decoder) {
      if (f->coded_width == format.coded_width &&
          f->coded_height == format.coded_height &&
          std::memcmp(&f->display_area, &format.display_area,
                      sizeof(f->display_area)) == 0)
        return surfaces;
      error = "the stream changes its frame size mid-stream";
      return 0;
    }
    const int bits = 8 + f->bit_depth_luma_minus8;
    if ((f->chroma_format != kChroma420 && f->chroma_format != kChroma444) ||
        f->bit_depth_luma_minus8 != f->bit_depth_chroma_minus8 ||
        (bits != 8 && bits != 10 && bits != 12)) {
      error = "only 8-, 10- and 12-bit 4:2:0 and 4:4:4 streams decode "
              "(chroma format " + std::to_string(f->chroma_format) +
              ", luma bit depth " + std::to_string(bits) +
              ", chroma bit depth " +
              std::to_string(8 + f->bit_depth_chroma_minus8) + ")";
      return 0;
    }
    CUVIDDECODECAPS caps;
    if (query_caps(f->codec, f->chroma_format, bits, &caps)) {
      error = g_error;
      return 0;
    }
    const int out_format = surface_format(f->chroma_format, bits);
    if (caps.bIsSupported && !(caps.nOutputFormatMask >> out_format & 1)) {
      error = "cuvidGetDecoderCaps: codec " + std::to_string(f->codec) +
              " at chroma format " + std::to_string(f->chroma_format) +
              ", " + std::to_string(bits) + " bits: output format mask " +
              std::to_string(caps.nOutputFormatMask) + " lacks surface "
              "format " + std::to_string(out_format);
      return 0;
    }
    if (!caps.bIsSupported || f->coded_width > caps.nMaxWidth ||
        f->coded_height > caps.nMaxHeight ||
        f->coded_width < caps.nMinWidth || f->coded_height < caps.nMinHeight) {
      error = "cuvidGetDecoderCaps: codec " + std::to_string(f->codec) +
              " supported " + std::to_string(caps.bIsSupported) + ", " +
              std::to_string(caps.nMinWidth) + "x" +
              std::to_string(caps.nMinHeight) + " to " +
              std::to_string(caps.nMaxWidth) + "x" +
              std::to_string(caps.nMaxHeight) + "; the stream is " +
              std::to_string(f->coded_width) + "x" +
              std::to_string(f->coded_height);
      return 0;
    }
    format = *f;
    output_format = out_format;
    depth = bits;
    surfaces = f->min_num_decode_surfaces;
    width = f->display_area.right - f->display_area.left;
    height = f->display_area.bottom - f->display_area.top;
    CUVIDDECODECREATEINFO ci;
    std::memset(&ci, 0, sizeof(ci));
    ci.ulWidth = f->coded_width;
    ci.ulHeight = f->coded_height;
    ci.ulNumDecodeSurfaces = surfaces;
    ci.CodecType = f->codec;
    ci.ChromaFormat = f->chroma_format;
    ci.ulCreationFlags = kCreatePreferCUVID;
    ci.bitDepthMinus8 = bits - 8;
    ci.ulMaxWidth = f->coded_width;
    ci.ulMaxHeight = f->coded_height;
    ci.display_area = {short(f->display_area.left), short(f->display_area.top),
                       short(f->display_area.right),
                       short(f->display_area.bottom)};
    ci.OutputFormat = out_format;
    ci.DeinterlaceMode = kDeinterlaceWeave;   // fields woven, as FFmpeg
    ci.ulTargetWidth = width;
    ci.ulTargetHeight = height;
    // every frame an end of stream releases can be mapped at once
    ci.ulNumOutputSurfaces = surfaces;
    ci.vidLock = lock;
    CUresult r = g_api.createDecoder(&decoder, &ci);
    if (r != CUDA_SUCCESS) {
      decoder = nullptr;
      error = "cuvidCreateDecoder: " + cu_text(r);
      return 0;
    }
    return surfaces;
  }

  int decode(CUVIDPICPARAMS* p) {
    if (!decoder) {
      error = "a picture before the sequence header";
      return 0;
    }
    CUresult r = g_api.decodePicture(decoder, p);
    if (r != CUDA_SUCCESS) {
      error = "cuvidDecodePicture: " + cu_text(r);
      return 0;
    }
    return 1;
  }

  int display(CUVIDPARSERDISPINFO* d) {
    if (!d) return 1;
    CUVIDPROCPARAMS vp;
    std::memset(&vp, 0, sizeof(vp));
    vp.progressive_frame = d->progressive_frame;
    vp.second_field = d->repeat_first_field + 1;
    vp.top_field_first = d->top_field_first;
    vp.unpaired_field = d->repeat_first_field < 0;
    vp.output_stream = stream;
    Frame f = {0, 0};
    CUresult r = g_api.mapFrame(decoder, d->picture_index, &f.ptr, &f.pitch,
                                &vp);
    if (r != CUDA_SUCCESS) {
      error = "cuvidMapVideoFrame64: " + cu_text(r);
      return 0;
    }
    ready.push_back(f);
    return 1;
  }
};

int on_sequence(void* s, CUVIDEOFORMAT* f) {
  return static_cast<Session*>(s)->sequence(f);
}
int on_decode(void* s, CUVIDPICPARAMS* p) {
  return static_cast<Session*>(s)->decode(p);
}
int on_display(void* s, CUVIDPARSERDISPINFO* d) {
  return static_cast<Session*>(s)->display(d);
}

__device__ __forceinline__ uint8_t sat8(int v) {
  return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
}

// One thread a pixel: swscale's x86 YUV 4:2:0 -> RGB arithmetic (see the
// top of the file), chroma shared by each 2x2 block.
__global__ void nv12_to_rgb_kernel(const uint8_t* __restrict__ luma,
                                   const uint8_t* __restrict__ chroma,
                                   int pitch, int width,
                                   uint8_t* __restrict__ rgb) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y;
  if (x >= width) return;
  const int lum = luma[static_cast<size_t>(y) * pitch + x];
  const uint8_t* c = chroma + static_cast<size_t>(y >> 1) * pitch + (x & ~1);
  const int u = 8 * c[0] - 1024;
  const int v = 8 * c[1] - 1024;
  const int yy = ((8 * lum - 128) * 9539) >> 16;
  uint8_t* o = rgb + (static_cast<size_t>(y) * width + x) * 3;
  o[0] = sat8(yy + ((v * 13075) >> 16));
  o[1] = sat8(yy + ((u * -3209) >> 16) + ((v * -6660) >> 16));
  o[2] = sat8(yy + ((u * 16525) >> 16));
}

__device__ __forceinline__ uint8_t table8(int i) {     // swscale's T[i]
  return sat8((-65284608 + 76309 * i + 0x8000) >> 16);
}

// One thread a pixel: swscale's generic 4:2:0 -> RGB route (see the top of
// the file).  The chroma of pixel pair x / 2 at row y: each vertical tap's
// chroma row filtered horizontally, then the taps summed.
__global__ void p016_to_rgb_kernel(const uint16_t* __restrict__ luma,
                                   const char* __restrict__ chroma,
                                   int pitch, int width, int height,
                                   int depth, const int* __restrict__ hpos,
                                   const int* __restrict__ hcoef, int hn,
                                   const int* __restrict__ vpos,
                                   const int* __restrict__ vcoef, int vn,
                                   uint8_t* __restrict__ rgb) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y;
  if (x >= width) return;
  const int down = 16 - depth, sh = depth - 1;
  const int cw = width >> 1, ch = (height + 1) >> 1, cx = x >> 1;
  const int h0 = hpos[cx], v0 = vpos[y];
  const int* ht = hcoef + cx * hn;
  const int* vt = vcoef + y * vn;
  int um = 4, vm = 4, uc = 1 << 18, vc = 1 << 18;
  for (int j = 0; j < vn; ++j) {
    const uint16_t* row = reinterpret_cast<const uint16_t*>(
        chroma + static_cast<size_t>(min(v0 + j, ch - 1)) * pitch);
    int u = 0, v = 0;
    for (int k = 0; k < hn; ++k) {
      const int c = 2 * min(h0 + k, cw - 1);
      u += (row[c] >> down) * ht[k];
      v += (row[c + 1] >> down) * ht[k];
    }
    u = min(u >> sh, 32767);
    v = min(v >> sh, 32767);
    um += (u * vt[j]) >> 16;                  // pmulhw
    vm += (v * vt[j]) >> 16;
    uc += u * vt[j];
    vc += v * vt[j];
  }
  const uint16_t* lrow = reinterpret_cast<const uint16_t*>(
      reinterpret_cast<const char*>(luma) + static_cast<size_t>(y) * pitch);
  const int y15 = min(((lrow[x] >> down) << 14) >> sh, 32767);
  uint8_t* o = rgb + (static_cast<size_t>(y) * width + x) * 3;
  if (y < height - 2) {
    const int u = um - 1024, v = vm - 1024;
    const int yy = ((4 + (y15 >> 4) - 128) * 9539) >> 16;
    o[0] = sat8(yy + ((v * 13075) >> 16));
    o[1] = sat8(yy + ((u * -3209) >> 16) + ((v * -6660) >> 16));
    o[2] = sat8(yy + ((u * 16525) >> 16));
  } else {
    const int u = sat8(uc >> 19), v = sat8(vc >> 19);
    const int y1 = ((1 << 18) + 4096 * y15) >> 19;
    o[0] = table8(663 + ((v * 89830) >> 16) + y1);
    o[1] = table8(972 + ((u * -22049) >> 16) + ((v * -45756) >> 16) + y1);
    o[2] = table8(617 + ((u * 113537) >> 16) + y1);
  }
}

// One thread a pixel: swscale's full-chroma 4:4:4 -> RGB route.  T is the
// surface's word (uint8_t at 8 bits, else uint16_t, the sample in its top
// `depth` bits).
template <typename T>
__global__ void yuv444_to_rgb_kernel(const char* __restrict__ luma,
                                     const char* __restrict__ cb,
                                     int pitch, int plane, int width,
                                     int depth, uint8_t* __restrict__ rgb) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y;
  if (x >= width) return;
  const int down = 8 * static_cast<int>(sizeof(T)) - depth, up = 15 - depth;
  const size_t at = static_cast<size_t>(y) * pitch;
  const T* yr = reinterpret_cast<const T*>(luma + at);
  const T* ur = reinterpret_cast<const T*>(cb + at);
  const T* vr = reinterpret_cast<const T*>(cb + static_cast<size_t>(plane) *
                                           pitch + at);
  const int yy = (4 * (static_cast<int>(yr[x] >> down) << up) - 8192) * 9539 +
                 (1 << 21);
  const unsigned u = 4 * ((static_cast<int>(ur[x] >> down) << up) - 16384);
  const unsigned v = 4 * ((static_cast<int>(vr[x] >> down) << up) - 16384);
  const unsigned base = static_cast<unsigned>(yy);
  uint8_t* o = rgb + (static_cast<size_t>(y) * width + x) * 3;
  o[0] = sat8(static_cast<int>(base + v * 13075u) >> 22);
  o[1] = sat8(static_cast<int>(base + v * static_cast<unsigned>(-6660) +
                               u * static_cast<unsigned>(-3209)) >> 22);
  o[2] = sat8(static_cast<int>(base + u * 16525u) >> 22);
}

}  // namespace

// -- the C interface ----------------------------------------------------------

NVD_API const char* nvd_error() { return g_error.c_str(); }

NVD_API int nvd_load() { return load(); }

NVD_API int nvd_caps(int device, int codec, int chroma, int depth,
                     unsigned int* out) {
  if (load()) return -1;
  CUcontext ctx;
  if (primary_context(device, &ctx)) return -1;
  CUVIDDECODECAPS caps;
  if (int r = query_caps(codec, chroma, depth, &caps)) return r;
  out[0] = caps.bIsSupported;
  out[1] = caps.nNumNVDECs;
  out[2] = caps.nOutputFormatMask;
  out[3] = caps.nMaxWidth;
  out[4] = caps.nMaxHeight;
  out[5] = caps.nMaxMBCount;
  out[6] = caps.nMinWidth;
  out[7] = caps.nMinHeight;
  return 0;
}

NVD_API void nvd_destroy(void* handle) {
  Session* s = static_cast<Session*>(handle);
  if (!s) return;
  cudaSetDevice(s->device);
  for (const Frame& f : s->ready) g_api.unmapFrame(s->decoder, f.ptr);
  if (s->parser) g_api.destroyParser(s->parser);
  if (s->decoder) g_api.destroyDecoder(s->decoder);
  if (s->lock) g_api.lockDestroy(s->lock);
  delete s;
}

NVD_API int nvd_create(int device, int codec, void** out) {
  if (load()) return -1;
  Session* s = new Session;
  s->device = device;
  s->codec = codec;
  if (primary_context(device, &s->ctx)) {
    delete s;
    return -1;
  }
  CUresult r = g_api.lockCreate(&s->lock, s->ctx);
  if (r != CUDA_SUCCESS) {
    delete s;
    return fail("cuvidCtxLockCreate: " + cu_text(r));
  }
  CUVIDPARSERPARAMS pp;
  std::memset(&pp, 0, sizeof(pp));
  pp.CodecType = codec;
  pp.ulMaxNumDecodeSurfaces = 1;       // the sequence callback sets it
  pp.ulMaxDisplayDelay = 0;
  pp.pUserData = s;
  pp.pfnSequenceCallback = on_sequence;
  pp.pfnDecodePicture = on_decode;
  pp.pfnDisplayPicture = on_display;
  r = g_api.createParser(&s->parser, &pp);
  if (r != CUDA_SUCCESS) {
    s->parser = nullptr;
    nvd_destroy(s);
    return fail("cuvidCreateVideoParser: " + cu_text(r));
  }
  *out = s;
  return 0;
}

NVD_API int nvd_parse(void* handle, const unsigned char* data, size_t size,
                      int flags, void* stream) {
  Session* s = static_cast<Session*>(handle);
  cudaSetDevice(s->device);
  s->stream = static_cast<CUstream>(stream);
  CUVIDSOURCEDATAPACKET pkt;
  std::memset(&pkt, 0, sizeof(pkt));
  pkt.flags = (flags & 1) ? kPktEndOfStream : 0;
  pkt.payload_size = size;
  pkt.payload = size ? data : nullptr;
  CUresult r = g_api.parse(s->parser, &pkt);
  if (!s->error.empty()) {
    std::string e = s->error;
    s->error.clear();
    return fail(e);
  }
  if (r != CUDA_SUCCESS) return fail("cuvidParseVideoData: " + cu_text(r));
  return 0;
}

NVD_API int nvd_ready(void* handle) {
  return static_cast<int>(static_cast<Session*>(handle)->ready.size());
}

NVD_API int nvd_front(void* handle, unsigned long long* ptr,
                      unsigned int* pitch, int* width, int* height,
                      int* chroma_row, int* format, int* depth) {
  Session* s = static_cast<Session*>(handle);
  if (s->ready.empty()) return fail("no decoded frame is waiting");
  *ptr = s->ready.front().ptr;
  *pitch = s->ready.front().pitch;
  *width = s->width;
  *height = s->height;
  // NVDEC's chroma plane starts after the luma rows rounded up to even (a
  // YUV444 surface's Cr plane as far again after its Cb plane)
  *chroma_row = (s->height + 1) & ~1;
  *format = s->output_format;
  *depth = s->depth;
  return 0;
}

NVD_API int nvd_release(void* handle) {
  Session* s = static_cast<Session*>(handle);
  if (s->ready.empty()) return fail("no decoded frame is waiting");
  cudaSetDevice(s->device);
  CUresult r = g_api.unmapFrame(s->decoder, s->ready.front().ptr);
  s->ready.pop_front();
  if (r != CUDA_SUCCESS) return fail("cuvidUnmapVideoFrame64: " + cu_text(r));
  return 0;
}

NVD_API int nvd_nv12_to_rgb(const uint8_t* luma, const uint8_t* chroma,
                            int pitch, int width, int height, uint8_t* rgb,
                            void* stream) {
  dim3 block(256), grid((width + 255) / 256, height);
  nv12_to_rgb_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      luma, chroma, pitch, width, rgb);
  return static_cast<int>(cudaGetLastError());
}

NVD_API int nvd_p016_to_rgb(const uint16_t* luma, const void* chroma,
                            int pitch, int width, int height, int depth,
                            const int* hpos, const int* hcoef, int hn,
                            const int* vpos, const int* vcoef, int vn,
                            uint8_t* rgb, void* stream) {
  dim3 block(256), grid((width + 255) / 256, height);
  p016_to_rgb_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      luma, static_cast<const char*>(chroma), pitch, width, height, depth,
      hpos, hcoef, hn, vpos, vcoef, vn, rgb);
  return static_cast<int>(cudaGetLastError());
}

NVD_API int nvd_yuv444_to_rgb(const void* luma, const void* cb, int pitch,
                              int width, int height, int depth, uint8_t* rgb,
                              void* stream) {
  dim3 block(256), grid((width + 255) / 256, height);
  const int plane = (height + 1) & ~1;
  const char* l = static_cast<const char*>(luma);
  const char* c = static_cast<const char*>(cb);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (depth > 8)
    yuv444_to_rgb_kernel<uint16_t><<<grid, block, 0, st>>>(
        l, c, pitch, plane, width, depth, rgb);
  else
    yuv444_to_rgb_kernel<uint8_t><<<grid, block, 0, st>>>(
        l, c, pitch, plane, width, depth, rgb);
  return static_cast<int>(cudaGetLastError());
}

NVD_API const char* nvd_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
