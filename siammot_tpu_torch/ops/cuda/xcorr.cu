// Depthwise cross-correlation and its gradient: the CUDA counterparts of
// the Pallas kernel siammot_tpu/ops/pallas/xcorr.py:xcorr_depthwise_pallas
// with ``valid`` (_xcorr_kernel_masked, inference: kernel 2), without it
// (_xcorr_kernel, training and the unmasked inference route: kernel 6),
// and of the two calls its custom VJP makes (siammot_tpu/ops/xcorr.py:
// _xcorr_bwd), also kernel 6.
//
// xcorr:     out[k, oy, ox, c] = sum_i sum_j s[k, oy + i, ox + j, c]
//                                            * t[k, i, j, c]   (f32, i-major)
// full:      out[k, y, x, c]   = sum_i sum_j g[k, y - i, x - j, c]
//                                            * t[k, i, j, c]
//            over the taps that lie inside g: the gradient of xcorr with
//            respect to its search input.  JAX writes it as the xcorr of g
//            zero-padded by (ht - 1, wt - 1) with the flipped template; the
//            pad is never built here.
// Every output sums its taps i ascending, then j ascending, one f32 fma
// each, in every kernel of this file, so kernels 2 and 6 give the same
// bits for a live slot.
//
// Bound on the H100: operations on the CUDA cores.  The op is depthwise
// (no channel mixing), so it has no tensor-core form without extra work:
// Ho*Wo*Ht*Wt fmas per channel against a few hundred kilobytes per slot
// (7.55 G fmas a pass at the training shapes, 0.225 ms at 67 TFLOP/s).
//
// Kernels 2 and 6 run one kernel, xcorr6_kernel, built to run near the
// fma rate:
// - A sliding window in registers.  A thread owns one channel (lanes on
//   neighbouring channels) and one output row segment (two rows,
//   balanced, for the search gradient).  For each template row it holds
//   that row's taps in registers and streams the search row through them
//   once: each value it loads feeds every output it touches, so a
//   shared-memory load serves about SEG*Wt / (SEG + Wt) ~ 5-8 fmas
//   instead of one.  The xcorr cuts each output row into segments of a
//   compile-time width (16 outputs for a 15-wide template, 15 for a
//   16-wide one: the template gradient), so any output width, 16 at the
//   default search region and 61 at SEARCH_REGION 5, is fully unrolled
//   with no predicate; the search gradient's widths are compile-time at
//   the training shapes (30/15) and streams g from right to left, so each
//   output still meets its taps j ascending.  Other template widths take
//   a generic instantiation (one load per fma, predicated).
// - The search gradient's bands: where two stages of all of g fit and the
//   output is at most W_GEN wide (the training shapes), one band of every
//   output row; past that (a 61x61 g at SEARCH_REGION 5, 75x75 out), the
//   caller's plan (ops/xcorr.py:grad_search_plan) gives bands of output
//   rows, each staging only the rows of g it meets, and column segments:
//   of 16 outputs for a 15-wide template, g streamed through the template
//   row in registers as above, else of at most W_GEN (generic).  The taps'
//   order does not depend on either.
// - Inputs staged in their own dtype, 8 channels a tile (16 when both are
//   bf16), with a row stride padded so the four (two) rows a warp reads
//   fall in distinct banks.
// - A persistent grid (as many blocks as fit on the SMs at once) walks
//   the (slot, channel tile, band of output rows) items; 16-byte cp.async
//   copies stage the next item into a second buffer while the current one
//   computes.
// - Kernel 2's ``valid`` ([K] uint8; null for kernel 6: every slot live):
//   each block first orders the slots live first (a warp ballot over
//   ``valid``, no host sync), so the live items spread evenly over the
//   blocks and the dead ones come last; a dead item reads nothing (its
//   prefetch issues no copy) and writes its rows of zeros.
// Templates too large for two stages in shared memory (a template
// gradient over a wide search region, 61x61 taps) take the one other
// kernel of this file, xcorr_band_kernel: one block per (slot, tile of 32
// channels, band of 8 output rows), both inputs staged as f32 a template
// row at a time, one shared-memory load per fma.  It is kept for that
// fallback alone.
#include <algorithm>

#include "common.cuh"

// -- the fallback for oversized taps ---------------------------------------
constexpr int CT = 32;      // channels per block
constexpr int BAND = 8;     // output rows per block
constexpr int WO_BAND_MAX = 64;

template <typename TS, typename TT>
__device__ __forceinline__ void stage(const TS* s_g, const TT* t_g,
                                      float* s_s, float* t_s, int ns,
                                      int nt, int C, int c0) {
  for (int e = threadIdx.x; e < ns * CT; e += blockDim.x) {
    const int cc = e % CT, p = e / CT;
    s_s[e] = c0 + cc < C ? load_f32(s_g, (size_t)p * C + c0 + cc) : 0.f;
  }
  for (int e = threadIdx.x; e < nt * CT; e += blockDim.x) {
    const int cc = e % CT, p = e / CT;
    t_s[e] = c0 + cc < C ? load_f32(t_g, (size_t)p * C + c0 + cc) : 0.f;
  }
}

// block (slot, channel tile, band of BAND output rows); valid may be null
template <typename TS, typename TT>
__global__ void __launch_bounds__(BAND * CT)
    xcorr_band_kernel(const TS* __restrict__ search,
                      const TT* __restrict__ tmpl,
                      const uint8_t* __restrict__ valid,
                      float* __restrict__ out, int hs, int ws, int ht, int wt,
                      int C) {
  const int k = blockIdx.x;
  const int c0 = blockIdx.y * CT;
  const int y0 = blockIdx.z * BAND;
  const int ho = hs - ht + 1, wo = ws - wt + 1;
  const int c = threadIdx.x % CT;
  const int r = threadIdx.x / CT;
  const int oy = y0 + r;
  const bool has_c = c0 + c < C, has_row = oy < ho;
  float* out_row = out + (((size_t)k * ho + oy) * wo) * C + c0 + c;
  if (valid != nullptr && !valid[k]) {
    if (has_c && has_row)
      for (int ox = 0; ox < wo; ++ox) out_row[(size_t)ox * C] = 0.f;
    return;
  }
  extern __shared__ float smem[];
  float* s_s = smem;                  // [BAND * ws][CT]: rows y0 + i ..
  float* t_s = smem + BAND * ws * CT; // [wt][CT]: template row i
  const TS* sk = search + (size_t)k * hs * ws * C;
  const TT* tk = tmpl + (size_t)k * ht * wt * C;
  float acc[WO_BAND_MAX];
#pragma unroll
  for (int ox = 0; ox < WO_BAND_MAX; ++ox) acc[ox] = 0.f;
  for (int i = 0; i < ht; ++i) {
    __syncthreads();  // previous row consumed
    const int rows = min(BAND, hs - (y0 + i));
    stage(sk + (size_t)(y0 + i) * ws * C, tk + (size_t)i * wt * C, s_s, t_s,
          rows * ws, wt, C, c0);
    __syncthreads();
    if (!has_row) continue;
    for (int j = 0; j < wt; ++j) {
      const float t = t_s[j * CT + c];
      const float* srow = s_s + (r * ws + j) * CT + c;
#pragma unroll
      for (int ox = 0; ox < WO_BAND_MAX; ++ox)
        if (ox < wo) acc[ox] = fmaf(srow[ox * CT], t, acc[ox]);
    }
  }
  if (has_c && has_row) {
#pragma unroll
    for (int ox = 0; ox < WO_BAND_MAX; ++ox)
      if (ox < wo) out_row[(size_t)ox * C] = acc[ox];
  }
}

template <typename TS, typename TT>
static int launch_band(const void* search, const void* tmpl,
                       const uint8_t* valid, float* out, int K, int hs,
                       int ws, int ht, int wt, int C, cudaStream_t stream) {
  const int ho = hs - ht + 1, wo = ws - wt + 1;
  if (ho < 1 || wo < 1 || wo > WO_BAND_MAX) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(BAND * ws + wt) * CT * sizeof(float);
  cudaError_t err = set_smem(xcorr_band_kernel<TS, TT>, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(K, (C + CT - 1) / CT, (ho + BAND - 1) / BAND);
  xcorr_band_kernel<TS, TT><<<grid, BAND * CT, smem, stream>>>(
      (const TS*)search, (const TT*)tmpl, valid, out, hs, ws, ht, wt, C);
  return (int)cudaGetLastError();
}

// -- kernels 2 and 6 -------------------------------------------------------
namespace k6 {

constexpr int XCORR = 0, FULL = 1;
constexpr int FULL_SEG = 2;      // FULL in compile-time column segments
constexpr int W_GEN = 64;        // accumulators a thread, generic widths
constexpr int MAX_THREADS = 256;

// One launch's geometry.  a [K, ha, wa, C] is the input that slides (the
// search region, or g for the search gradient), b [K, hb, wb, C] the taps
// (the template, or g for the template gradient); out [K, ho, wo, C] f32.
struct Shape {
  int K, ha, wa, hb, wb, C, ho, wo;
  int tiles, bands;  // channel tiles, bands of output rows
  int rpi, nrt;      // output rows an item, row threads a block
  int nseg, segw;    // column segments an output row; their width (FULL)
  int rsa;           // row stride of a in shared memory, elements
  int b_off, stage;  // bytes: b's offset in a stage, a stage
  int items, vec;    // work items; 16-byte copies (every tile full, aligned)
};

struct Item {
  int k, c0, y0, y1, a0;
  bool live;
};

// Item -> (position p in the slot order, channel tile, band); the slot is
// order[p] (live slots first) or p when every slot is live.
template <int MODE, int TILE>
__device__ __forceinline__ Item decode(const Shape& sh, int item,
                                       const int* order, int n_live) {
  Item it;
  const int band = item % sh.bands, t = item / sh.bands;
  const int p = t / sh.tiles;
  it.k = order != nullptr ? order[p] : p;
  it.live = p < n_live;
  it.c0 = (t % sh.tiles) * TILE;
  it.y0 = band * sh.rpi;
  it.y1 = min(sh.ho, it.y0 + sh.rpi);
  it.a0 = MODE == XCORR ? it.y0 : max(0, it.y0 - sh.hb + 1);
  return it;
}

// Stage one live item's rows of a and all of b into `st`, TILE channels a
// pixel: 16-byte cp.async copies, or element loads with zeros past C.  A
// dead item stages nothing.
template <int MODE, int TILE, typename TA, typename TB>
__device__ __forceinline__ void stage_item(const TA* __restrict__ a,
                                           const TB* __restrict__ b,
                                           const Shape& sh, const Item& it,
                                           unsigned char* st) {
  if (!it.live) return;
  const int a1 = MODE == XCORR ? min(sh.ha, it.y1 + sh.hb - 1)
                               : min(sh.ha, it.y1);
  TA* a_s = (TA*)st;
  TB* b_s = (TB*)(st + sh.b_off);
  const TA* ag = a + ((size_t)it.k * sh.ha + it.a0) * sh.wa * sh.C + it.c0;
  const TB* bg = b + (size_t)it.k * sh.hb * sh.wb * sh.C + it.c0;
  const int na = (a1 - it.a0) * sh.wa, nb = sh.hb * sh.wb;
  if (sh.vec) {
    constexpr int EA = 16 / sizeof(TA), EB = 16 / sizeof(TB);
    constexpr int QA = TILE / EA, QB = TILE / EB;
    for (int e = threadIdx.x; e < na * QA; e += blockDim.x) {
      const int q = e % QA, p = e / QA;
      cp_async16(a_s + (p / sh.wa) * sh.rsa + (p % sh.wa) * TILE + q * EA,
                 ag + (size_t)p * sh.C + q * EA);
    }
    for (int e = threadIdx.x; e < nb * QB; e += blockDim.x) {
      const int q = e % QB, p = e / QB;
      cp_async16(b_s + p * TILE + q * EB, bg + (size_t)p * sh.C + q * EB);
    }
  } else {
    for (int e = threadIdx.x; e < na * TILE; e += blockDim.x) {
      const int cc = e % TILE, p = e / TILE;
      a_s[(p / sh.wa) * sh.rsa + (p % sh.wa) * TILE + cc] =
          it.c0 + cc < sh.C ? ag[(size_t)p * sh.C + cc] : zero_of<TA>();
    }
    for (int e = threadIdx.x; e < nb * TILE; e += blockDim.x) {
      const int cc = e % TILE, p = e / TILE;
      b_s[p * TILE + cc] =
          it.c0 + cc < sh.C ? bg[(size_t)p * sh.C + cc] : zero_of<TB>();
    }
  }
}

// out[k, y, x0 .. x0 + n) of channel c from acc[0 .. n)
template <int N>
__device__ __forceinline__ void store_row(const Shape& sh, const Item& it,
                                          int y, int c, int x0, int n,
                                          const float (&acc)[N],
                                          float* __restrict__ out) {
  if (it.c0 + c >= sh.C) return;
  float* o = out + (((size_t)it.k * sh.ho + y) * sh.wo + x0) * sh.C +
             it.c0 + c;
#pragma unroll
  for (int x = 0; x < N; ++x)
    if (x < n) o[(size_t)x * sh.C] = acc[x];
}

// xcorr rows of one item: thread (c, r) takes the units r, r + nrt, ...
// of (output row, column segment), rows fastest, so the rows a warp reads
// are neighbours.  SEG > 0: segments of SEG outputs and a WT-wide
// template at compile time, the search row streamed through the template
// row held in registers (the last segment may run past wo: those outputs
// read the padded stride and are not stored).  SEG == 0: one segment, the
// generic form.  A dead item stores zeros.
template <int TILE, int SEG, int WT, typename TA, typename TB>
__device__ __forceinline__ void xcorr_rows(const Shape& sh, const Item& it,
                                           const TA* a_s, const TB* b_s,
                                           float* __restrict__ out) {
  const int c = threadIdx.x % TILE, r = threadIdx.x / TILE;
  const int rows = it.y1 - it.y0;
  for (int u = r; u < rows * sh.nseg; u += sh.nrt) {
    const int y = it.y0 + u % rows;
    if constexpr (SEG > 0) {
      const int x0 = (u / rows) * SEG;
      float acc[SEG];
#pragma unroll
      for (int x = 0; x < SEG; ++x) acc[x] = 0.f;
      for (int i = 0; it.live && i < sh.hb; ++i) {
        float t[WT];
        const TB* trow = b_s + i * WT * TILE + c;
#pragma unroll
        for (int j = 0; j < WT; ++j) t[j] = load_f32(trow, j * TILE);
        const TA* srow = a_s + (y + i - it.a0) * sh.rsa + x0 * TILE + c;
#pragma unroll
        for (int x = 0; x < SEG + WT - 1; ++x) {
          const float v = load_f32(srow, x * TILE);
#pragma unroll
          for (int ox = 0; ox < SEG; ++ox) {
            const int j = x - ox;  // ascending in x for each output
            if (j >= 0 && j < WT) acc[ox] = fmaf(v, t[j], acc[ox]);
          }
        }
      }
      store_row(sh, it, y, c, x0, min(SEG, sh.wo - x0), acc, out);
    } else {
      float acc[W_GEN];
#pragma unroll
      for (int x = 0; x < W_GEN; ++x) acc[x] = 0.f;
      for (int i = 0; it.live && i < sh.hb; ++i) {
        for (int j = 0; j < sh.wb; ++j) {
          const float t = load_f32(b_s, (i * sh.wb + j) * TILE + c);
          const TA* srow = a_s + (y + i - it.a0) * sh.rsa + j * TILE + c;
#pragma unroll
          for (int ox = 0; ox < W_GEN; ++ox)
            if (ox < sh.wo)
              acc[ox] = fmaf(load_f32(srow, ox * TILE), t, acc[ox]);
        }
      }
      store_row(sh, it, y, c, 0, sh.wo, acc, out);
    }
  }
}

// full-convolution rows (the search gradient), a = g: output row y meets
// the template rows i whose g row y - i lies inside g.  WO > 0: output
// width WO, template width WT, g width WO - WT + 1, each g value streamed
// right to left through the template row in registers, so that each
// output still meets its taps j ascending.  WO == 0: thread r takes the
// units r, r + nrt, ... of (output row, column segment of segw), rows
// fastest, one load per fma.
template <int TILE, int WO, int WT, typename TA, typename TB>
__device__ __forceinline__ void full_rows(const Shape& sh, const Item& it,
                                          const TA* a_s, const TB* b_s,
                                          float* __restrict__ out) {
  const int c = threadIdx.x % TILE, r = threadIdx.x / TILE;
  if constexpr (WO > 0) {
    for (int y = it.y0 + r; y < it.y1; y += sh.nrt) {
      const int i_lo = max(0, y - sh.ha + 1), i_hi = min(sh.hb - 1, y);
      constexpr int WG = WO - WT + 1;
      float acc[WO];
#pragma unroll
      for (int x = 0; x < WO; ++x) acc[x] = 0.f;
      for (int i = i_lo; i <= i_hi; ++i) {
        float t[WT];
        const TB* trow = b_s + i * WT * TILE + c;
#pragma unroll
        for (int j = 0; j < WT; ++j) t[j] = load_f32(trow, j * TILE);
        const TA* grow = a_s + (y - i - it.a0) * sh.rsa + c;
#pragma unroll
        for (int gx = WG - 1; gx >= 0; --gx) {
          const float v = load_f32(grow, gx * TILE);
#pragma unroll
          for (int j = 0; j < WT; ++j)
            acc[gx + j] = fmaf(v, t[j], acc[gx + j]);
        }
      }
      store_row(sh, it, y, c, 0, WO, acc, out);
    }
  } else {
    const int rows = it.y1 - it.y0;
    for (int u = r; u < rows * sh.nseg; u += sh.nrt) {
      const int y = it.y0 + u % rows, x0 = (u / rows) * sh.segw;
      const int n = min(sh.segw, sh.wo - x0);
      const int i_lo = max(0, y - sh.ha + 1), i_hi = min(sh.hb - 1, y);
      float acc[W_GEN];
#pragma unroll
      for (int x = 0; x < W_GEN; ++x) acc[x] = 0.f;
      for (int i = i_lo; i <= i_hi; ++i) {
        const TA* grow = a_s + (y - i - it.a0) * sh.rsa + c;
        for (int j = 0; j < sh.wb; ++j) {
          const float t = load_f32(b_s, (i * sh.wb + j) * TILE + c);
#pragma unroll
          for (int x = 0; x < W_GEN; ++x) {
            const int gx = x0 + x - j;
            if (x < n && gx >= 0 && gx < sh.wa)
              acc[x] = fmaf(load_f32(grow, gx * TILE), t, acc[x]);
          }
        }
      }
      store_row(sh, it, y, c, x0, n, acc, out);
    }
  }
}

// full-convolution rows in column segments of SEG outputs with a WT-wide
// template at compile time (the bands past the training shapes): the
// units of the generic form, each g value a segment reaches that lies
// inside g streamed right to left through the template row in registers,
// so each output meets its taps j ascending, as in the generic form
// (the same bits); outputs past wo are not stored.
template <int TILE, int SEG, int WT, typename TA, typename TB>
__device__ __forceinline__ void full_rows_seg(const Shape& sh,
                                              const Item& it, const TA* a_s,
                                              const TB* b_s,
                                              float* __restrict__ out) {
  const int c = threadIdx.x % TILE, r = threadIdx.x / TILE;
  const int rows = it.y1 - it.y0;
  for (int u = r; u < rows * sh.nseg; u += sh.nrt) {
    const int y = it.y0 + u % rows, x0 = (u / rows) * SEG;
    const int i_lo = max(0, y - sh.ha + 1), i_hi = min(sh.hb - 1, y);
    float acc[SEG];
#pragma unroll
    for (int x = 0; x < SEG; ++x) acc[x] = 0.f;
    for (int i = i_lo; i <= i_hi; ++i) {
      float t[WT];
      const TB* trow = b_s + i * WT * TILE + c;
#pragma unroll
      for (int j = 0; j < WT; ++j) t[j] = load_f32(trow, j * TILE);
      const TA* grow = a_s + (y - i - it.a0) * sh.rsa + c;
#pragma unroll
      for (int d = SEG - 1; d > -WT; --d) {
        const int gx = x0 + d;
        if (gx >= 0 && gx < sh.wa) {
          const float v = load_f32(grow, gx * TILE);
#pragma unroll
          for (int j = 0; j < WT; ++j)
            if (d + j >= 0 && d + j < SEG)
              acc[d + j] = fmaf(v, t[j], acc[d + j]);
        }
      }
    }
    store_row(sh, it, y, c, x0, min(SEG, sh.wo - x0), acc, out);
  }
}

// The persistent kernel: block b takes items b, b + grid, ...; the next
// item's copies are in flight while the current one computes.  With
// ``valid`` (xcorr only) the items run in the block's live-first slot
// order, kept in shared memory after the two stages.
template <int MODE, int TILE, int SEG, int WT, typename TA, typename TB>
__global__ void __launch_bounds__(MAX_THREADS)
    xcorr6_kernel(const TA* __restrict__ a, const TB* __restrict__ b,
                  const uint8_t* __restrict__ valid,
                  float* __restrict__ out, const Shape sh) {
  extern __shared__ __align__(16) unsigned char k6_smem[];
  const int* order = nullptr;
  int n_live = sh.K;
  if (valid != nullptr) {
    int* o = (int*)(k6_smem + 2 * (size_t)sh.stage);
    n_live = live_order(valid, sh.K, o);
    order = o;
  }
  int item = blockIdx.x;
  stage_item<MODE, TILE>(a, b, sh, decode<MODE, TILE>(sh, item, order,
                                                      n_live), k6_smem);
  cp_async_commit();
  for (int n = 0; item < sh.items; ++n, item += gridDim.x) {
    const int next = item + gridDim.x;
    if (next < sh.items)
      stage_item<MODE, TILE>(a, b, sh,
                             decode<MODE, TILE>(sh, next, order, n_live),
                             k6_smem + ((n + 1) & 1) * sh.stage);
    cp_async_commit();
    cp_async_wait<1>();  // this item's copies are in
    __syncthreads();
    const unsigned char* st = k6_smem + (n & 1) * sh.stage;
    const Item it = decode<MODE, TILE>(sh, item, order, n_live);
    if constexpr (MODE == XCORR)
      xcorr_rows<TILE, SEG, WT>(sh, it, (const TA*)st,
                                (const TB*)(st + sh.b_off), out);
    else if constexpr (MODE == FULL_SEG)
      full_rows_seg<TILE, SEG, WT>(sh, it, (const TA*)st,
                                   (const TB*)(st + sh.b_off), out);
    else
      full_rows<TILE, SEG, WT>(sh, it, (const TA*)st,
                               (const TB*)(st + sh.b_off), out);
    __syncthreads();  // before the next prefetch overwrites this stage
  }
  cp_async_wait<0>();
}

// The smallest row stride (bytes, a multiple of 16) from `bytes` up at
// which the `groups` rows a warp reads, `width` bytes each, fall in
// distinct banks.
static int row_stride(int bytes, int groups, int width) {
  for (int rs = (bytes + 15) / 16 * 16;; rs += 16) {
    bool ok = true;
    for (int m = 1; m < groups && ok; ++m) {
      const int d = (m * rs) % 128;
      ok = d >= width && d <= 128 - width;
    }
    if (ok) return rs;
  }
}

template <int MODE, int TILE, int SEG, int WT, typename TA, typename TB>
static int launch(const void* a, const void* b, const uint8_t* valid,
                  float* out, const Shape& sh, size_t smem,
                  cudaStream_t stream) {
  auto kernel = xcorr6_kernel<MODE, TILE, SEG, WT, TA, TB>;
  const int threads = TILE * sh.nrt;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int resident = resident_blocks(kernel, threads, smem);
  if (resident == 0) return (int)cudaErrorInvalidConfiguration;
  kernel<<<std::min(sh.items, resident), threads, smem, stream>>>(
      (const TA*)a, (const TB*)b, valid, out, sh);
  return (int)cudaGetLastError();
}

// mode XCORR: a the search, b the taps (the template, or g for the
// template gradient), valid null or [K] (kernel 2); mode FULL: the search
// gradient, a = g, b the template, valid null, in bands of `band_rows`
// output rows (all of them: one band) and `segments` column segments.
// With `takes_band`, nothing is launched: it is set to 1 where the taps
// would take the banded fallback, else 0.
template <typename TA, typename TB>
static int launch6(int mode, const void* a, const void* b,
                   const uint8_t* valid, float* out, int K, int ha, int wa,
                   int hb, int wb, int C, cudaStream_t stream,
                   int band_rows = 0, int segments = 1,
                   int* takes_band = nullptr) {
  constexpr int TILE = sizeof(TA) == 2 && sizeof(TB) == 2 ? 16 : 8;
  constexpr int CAP = MAX_THREADS / TILE;  // row threads a block at most
  Shape sh{};
  sh.K = K, sh.ha = ha, sh.wa = wa, sh.hb = hb, sh.wb = wb, sh.C = C;
  sh.ho = mode == XCORR ? ha - hb + 1 : ha + hb - 1;
  sh.wo = mode == XCORR ? wa - wb + 1 : wa + wb - 1;
  const bool one_band = band_rows == sh.ho && segments == 1;
  // the xcorr's segment width: 16 for a 15-wide template, 15 for a
  // 16-wide one, 0 (one generic segment, at most W_GEN wide) otherwise;
  // compile-time segments take any output width
  const int seg = mode == XCORR ? (wb == 15 ? 16 : wb == 16 ? 15 : 0) : 0;
  if (sh.ho < 1 || sh.wo < 1 || hb < 1 || wb < 1 ||
      (mode == XCORR && seg == 0 && sh.wo > W_GEN) ||
      (mode == FULL &&
       (valid != nullptr || band_rows < 1 || band_rows > sh.ho ||
        segments < 1 || (sh.wo + segments - 1) / segments > W_GEN ||
        (one_band && sh.ho > 2 * CAP))))
    return (int)cudaErrorInvalidValue;
  int a_cols = wa;
  if (mode == XCORR) {
    sh.nseg = seg > 0 ? (sh.wo + seg - 1) / seg : 1;
    sh.rpi = std::max(1, std::min(sh.ho, CAP / sh.nseg));
    sh.nrt = std::min(sh.rpi * sh.nseg, CAP);
    if (seg > 0) a_cols = std::max(wa, sh.nseg * seg + wb - 1);
  } else if (one_band) {
    // thread r takes rows r and r + nrt, so that every thread meets as
    // many template rows (at the training shapes r + 1 and 15 - r: 16 for
    // every thread)
    sh.nseg = 1;
    sh.segw = sh.wo;
    sh.rpi = sh.ho;
    sh.nrt = (sh.ho + 1) / 2;
  } else {
    sh.nseg = segments;
    sh.segw = (sh.wo + segments - 1) / segments;
    sh.rpi = band_rows;
    sh.nrt = std::min(CAP, band_rows * segments);
  }
  sh.bands = (sh.ho + sh.rpi - 1) / sh.rpi;
  sh.tiles = (C + TILE - 1) / TILE;
  sh.items = K * sh.tiles * sh.bands;
  // the rows of a an item meets: its rows and the template's height less
  // one (below them for the xcorr, above for the full convolution)
  const int a_rows = std::min(ha, sh.rpi + hb - 1);
  const int rs = row_stride(a_cols * TILE * (int)sizeof(TA), 32 / TILE,
                            TILE * (int)sizeof(TA));
  sh.rsa = rs / (int)sizeof(TA);
  sh.b_off = a_rows * rs;
  sh.stage = (sh.b_off + hb * wb * TILE * (int)sizeof(TB) + 15) / 16 * 16;
  sh.vec = C % TILE == 0 && (C * sizeof(TA)) % 16 == 0 &&
           (C * sizeof(TB)) % 16 == 0 && (uintptr_t)a % 16 == 0 &&
           (uintptr_t)b % 16 == 0;
  const size_t smem = 2 * (size_t)sh.stage +
                      (valid != nullptr ? (size_t)(K + 1) * sizeof(int) : 0);
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  if (smem > (size_t)optin) {
    // taps too large for two stages: the banded fallback (the full
    // convolution's plan keeps its bands inside the limit)
    if (mode == FULL) return (int)cudaErrorInvalidValue;
    if (takes_band) {
      *takes_band = 1;
      return 0;
    }
    return launch_band<TA, TB>(a, b, valid, out, K, ha, wa, hb, wb, C,
                               stream);
  }
  if (takes_band) {
    *takes_band = 0;
    return 0;
  }
  if (mode == XCORR) {
    if (seg == 16)  // a 15-wide template: the forward, kernel 2
      return launch<XCORR, TILE, 16, 15, TA, TB>(a, b, valid, out, sh, smem,
                                                 stream);
    if (seg == 15)  // the template gradient: 16-wide g as taps
      return launch<XCORR, TILE, 15, 16, TA, TB>(a, b, valid, out, sh, smem,
                                                 stream);
    return launch<XCORR, TILE, 0, 0, TA, TB>(a, b, valid, out, sh, smem,
                                             stream);
  }
  if (one_band && wa == 16 && wb == 15)  // 16x16 g, 15x15 taps
    return launch<FULL, TILE, 30, 15, TA, TB>(a, b, nullptr, out, sh, smem,
                                              stream);
  if (!one_band && wb == 15) {  // bands of a 15-wide template: 16 columns
    if (segments != (sh.wo + 15) / 16) return (int)cudaErrorInvalidValue;
    return launch<FULL_SEG, TILE, 16, 15, TA, TB>(a, b, nullptr, out, sh,
                                                  smem, stream);
  }
  return launch<FULL, TILE, 0, 0, TA, TB>(a, b, nullptr, out, sh, smem,
                                          stream);
}

}  // namespace k6

// dtype codes: 0 = float32, 1 = bfloat16, one per input
#define SIAMMOT_DISPATCH2(d0, d1, FN, ...)                              \
  ((d0) == 1 ? ((d1) == 1 ? FN<__nv_bfloat16, __nv_bfloat16>(__VA_ARGS__) \
                          : FN<__nv_bfloat16, float>(__VA_ARGS__))        \
             : ((d1) == 1 ? FN<float, __nv_bfloat16>(__VA_ARGS__)         \
                          : FN<float, float>(__VA_ARGS__)))

// Kernel 2: the masked xcorr (inference), one dtype for both inputs.
SIAMMOT_API int siammot_xcorr_masked(const void* search, const void* tmpl,
                                     int dtype, const uint8_t* valid,
                                     float* out, int K, int hs, int ws,
                                     int ht, int wt, int C, void* stream) {
  if (K == 0) return 0;
  return SIAMMOT_DISPATCH2(dtype, dtype, k6::launch6, k6::XCORR, search,
                           tmpl, valid, out, K, hs, ws, ht, wt, C,
                           (cudaStream_t)stream);
}

// Unmasked xcorr: the training forward and the template gradient
// (xcorr of the search with the upstream gradient).
SIAMMOT_API int siammot_xcorr(const void* search, int search_dtype,
                              const void* tmpl, int tmpl_dtype, float* out,
                              int K, int hs, int ws, int ht, int wt, int C,
                              void* stream) {
  if (K == 0) return 0;
  return SIAMMOT_DISPATCH2(search_dtype, tmpl_dtype, k6::launch6, k6::XCORR,
                           search, tmpl, nullptr, out, K, hs, ws, ht, wt, C,
                           (cudaStream_t)stream);
}

// Search gradient: the full convolution of the upstream gradient with the
// template, [K, hg + ht - 1, wg + wt - 1, C] f32, in bands of `band_rows`
// output rows and `segments` column segments (ops/xcorr.py:
// grad_search_plan).
SIAMMOT_API int siammot_xcorr_grad_search(const void* grad, int grad_dtype,
                                          const void* tmpl, int tmpl_dtype,
                                          float* out, int K, int hg, int wg,
                                          int ht, int wt, int C,
                                          int band_rows, int segments,
                                          void* stream) {
  if (K == 0) return 0;
  return SIAMMOT_DISPATCH2(grad_dtype, tmpl_dtype, k6::launch6, k6::FULL,
                           grad, tmpl, nullptr, out, K, hg, wg, ht, wt, C,
                           (cudaStream_t)stream, band_rows, segments);
}

// Whether the unmasked xcorr of [K, hs, ws, C] with [K, ht, wt, C] taps
// (the template gradient: the search with g) takes the banded fallback
// kernel: 1, or xcorr6_kernel: 0; a negative CUDA error for shapes the
// kernel refuses.  Launches nothing.
SIAMMOT_API int siammot_xcorr_takes_band(int search_dtype, int tmpl_dtype,
                                         int K, int hs, int ws, int ht,
                                         int wt, int C) {
  int band = 0;
  const int err = SIAMMOT_DISPATCH2(
      search_dtype, tmpl_dtype, k6::launch6, k6::XCORR, nullptr, nullptr,
      nullptr, nullptr, K, hs, ws, ht, wt, C, (cudaStream_t)0, 0, 1, &band);
  return err ? -err : band;
}

// Shared memory a block of the current device may opt in to, bytes.
SIAMMOT_API int siammot_smem_optin() {
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return 0;
  return optin;
}
