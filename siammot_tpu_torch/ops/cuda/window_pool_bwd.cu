// Gradient of the windowed ROIAlign pool with respect to its table
// (kernel 7): the CUDA counterpart of the Pallas kernel
// siammot_tpu/ops/pallas/window_pool.py:window_pool_pallas_bwd
// (_bwd_kernel).
//
// dtable[row0[n] + y, col0[n] + x, c] +=
//     sum_j wx[n, j, x] * (sum_i wy[n, i, y] * g[n, i, j, c])
//
// The TPU kernel walks the ROIs in order on its sequential grid and
// read-modify-writes each ROI's window stripes: rows first (stage 1
// contracts wy over the bins i), then columns (stage 2 contracts wx over
// the bins j).  This kernel keeps that order and is deterministic: every
// table element adds its ROIs' contributions in ROI order, each
// contribution summed rows first, then columns, in f32, with no atomics;
// the table is written once, zeros included, so the caller allocates it
// uninitialised.
//
// Bound on the H100: bytes (g and the weights read once, the whole f32
// table written once).  A weight row has at most 2 * sampling_ratio
// non-zero taps, so each table element meets a few taps of a few ROIs.
// Design, a gather over table tiles in three launches:
// 1. window_pool_bwd_spans, a block per ROI: for every window row y the
//    span [i_lo, i_hi) of bins with a non-zero wy[i, y], for every column
//    x the span of bins j with a non-zero wx[j, x] (empty outside the
//    table, and for a dead ROI: ``valid`` False; null = all live), and
//    the table rectangle the ROI touches.
// 2. window_pool_bwd_masks, a thread per (band of TR table rows, or span
//    of TC columns) and word of 32 ROIs: the bit mask of the ROIs whose
//    rectangle meets it.  A tile's ROIs are the AND of its band's and its
//    columns' masks, and walking the bits low to high visits them in ROI
//    order.
// 3. window_pool_bwd_gather, a block per tile of TR rows x TC columns x
//    (32 * CPL) channels: warp r owns table row r of the tile, each lane
//    CPL neighbouring channels (16-byte loads and stores of g and the
//    table).  Warp 0 turns the AND of the tile's masks into the tile's ROI
//    list in ROI order; the block stages the spans over the tile of 32
//    ROIs at a time in one round trip; then, ROI by ROI, it stages the
//    ROI's block of g (the bins [i0, i1) x [j0, j1) that reach the tile)
//    and its weights over the tile with cp.async into one of two buffers
//    while the previous ROI computes from the other, and every warp adds
//    the ROI's contribution to its row in registers (acc[x] += sum_j wx *
//    (sum_i wy * g) over the spans; spans of up to SPAN bins unrolled, so
//    a column's loads issue together).  A ROI whose block exceeds a
//    buffer (bins much smaller than a table cell, common for the small
//    boxes of a real step) is read from global memory instead, four bins
//    and two columns in flight.  Each warp writes its row once at the
//    end; a tile no ROI touches writes zeros.
// Within a ROI the stage-1 sum is formed again for each column x it
// feeds (about 2.4 columns a bin at the training search-region site):
// the same fmas in the same order, so each element gets the separable
// sums' bits, read from shared memory.
#include <algorithm>

#include "common.cuh"

namespace k7 {

constexpr int TR = 8;            // table rows a tile: one warp each
constexpr int TC = 8;            // table columns a tile
constexpr int THREADS = 32 * TR;
constexpr int GCAP = 96;         // g pixels a stage holds
constexpr int WCAP = 32;         // bins a stage holds on each axis
constexpr int BATCH = 32;        // pairs whose spans are staged at once
constexpr int SPAN = 3;          // bins a span takes unrolled
// a pair's meta: origin (row, col), the tile rows' and columns' spans,
// then its index in the list, bins [i0, i1) x [j0, j1), whether it fits
constexpr int M_IDX = 2 + TR + TC, M_I0 = M_IDX + 1, M_I1 = M_IDX + 2,
              M_J0 = M_IDX + 3, M_J1 = M_IDX + 4, M_FIT = M_IDX + 5,
              META = M_IDX + 6;

__device__ __forceinline__ int span_lo(int s) { return s & 0xffff; }
__device__ __forceinline__ int span_hi(int s) { return s >> 16; }

// spans [N][2 * win] (rows y, then columns x; lo | hi << 16, 0 = empty),
// rects [N] (first row, last row, first column, last column; empty: first
// > last)
__global__ void window_pool_bwd_spans(const int* __restrict__ origins,
                                      const float* __restrict__ wy,
                                      const float* __restrict__ wx,
                                      const uint8_t* __restrict__ valid,
                                      int* __restrict__ spans,
                                      int4* __restrict__ rects, int R,
                                      int Wmax, int S, int win) {
  extern __shared__ int sp[];  // [2 * win]
  const int n = blockIdx.x;
  const bool live = valid == nullptr || valid[n];
  const int row0 = origins[2 * n], col0 = origins[2 * n + 1];
  for (int t = threadIdx.x; t < 2 * win; t += blockDim.x) {
    const bool is_y = t < win;
    const int p = is_y ? t : t - win;
    const float* w = (is_y ? wy : wx) + (size_t)n * S * win + p;
    const int pos = (is_y ? row0 : col0) + p;
    int lo = -1, hi = 0;
    if (live && pos >= 0 && pos < (is_y ? R : Wmax)) {
      for (int i = 0; i < S; ++i) {
        if (w[(size_t)i * win] != 0.f) {
          if (lo < 0) lo = i;
          hi = i + 1;
        }
      }
    }
    const int v = lo >= 0 ? lo | hi << 16 : 0;
    spans[(size_t)n * 2 * win + t] = v;
    sp[t] = v;
  }
  __syncthreads();
  if (threadIdx.x < 32) {  // the touched rows' and columns' extremes
    int y0 = win, y1 = -1, x0 = win, x1 = -1;
    for (int p = threadIdx.x; p < win; p += 32) {
      if (sp[p]) y0 = min(y0, p), y1 = max(y1, p);
      if (sp[win + p]) x0 = min(x0, p), x1 = max(x1, p);
    }
    for (int o = 16; o > 0; o >>= 1) {
      y0 = min(y0, __shfl_xor_sync(~0u, y0, o));
      y1 = max(y1, __shfl_xor_sync(~0u, y1, o));
      x0 = min(x0, __shfl_xor_sync(~0u, x0, o));
      x1 = max(x1, __shfl_xor_sync(~0u, x1, o));
    }
    if (threadIdx.x == 0)
      rects[n] = y1 >= 0 && x1 >= 0
                     ? make_int4(row0 + y0, row0 + y1, col0 + x0, col0 + x1)
                     : make_int4(1, 0, 1, 0);
  }
}

// masks [nbands + ncols][nw]: bit b of word w of band t (columns t -
// nbands) is set when ROI 32 w + b's rectangle meets it
__global__ void window_pool_bwd_masks(const int4* __restrict__ rects,
                                      uint32_t* __restrict__ masks, int N,
                                      int nbands, int ncols) {
  const int nw = (N + 31) / 32;
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (nbands + ncols) * nw) return;
  const int t = e / nw, w = e % nw;
  const bool band = t < nbands;
  const int lo = band ? t * TR : (t - nbands) * TC;
  const int hi = lo + (band ? TR : TC) - 1;
  uint32_t bits = 0;
  for (int b = 0; b < 32 && w * 32 + b < N; ++b) {
    const int4 r = rects[w * 32 + b];
    const int a = band ? r.x : r.z, z = band ? r.y : r.w;
    if (a <= z && a <= hi && z >= lo) bits |= 1u << b;
  }
  masks[e] = bits;
}

template <int CPL>
__device__ __forceinline__ void load_c(const float* p, float (&v)[CPL]) {
  if constexpr (CPL == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
  } else {
    v[0] = *p;
  }
}

template <int CPL>
__device__ __forceinline__ void store_c(float* p, const float (&v)[CPL]) {
  if constexpr (CPL == 4)
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  else
    *p = v[0];
}

// 4 bytes global -> shared, asynchronously (cp.async, L1 allowed)
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}

// One stage of the gather: a pair's g block [ni][nj][32 * CPL] and its
// weights over the tile, wy [ni][TR] and wx [nj][TC].
template <int CPL>
struct Stage {
  static constexpr int G = GCAP * 32 * CPL, WY = WCAP * TR, WX = WCAP * TC;
  static constexpr int FLOATS = G + WY + WX;
};

// Add one ROI's contribution to warp r's row of the tile: for each column
// x with a non-empty span, acc[x] += sum_j wx(j, x) * (sum_i wy(i) *
// g(i, j)), i over the row's span, j over the column's.  The accessors
// are offsets from (i0, j0): into the staged block, or into global memory
// for a pair too large to stage.  Spans of up to SPAN bins on both axes
// (nearly all) run fully unrolled under predicates, so that a column's
// loads issue together; the fmas keep their order either way.
template <int CPL>
__device__ __forceinline__ void add_roi(float (&acc)[TC][CPL], int i_lo,
                                        int i_hi, const int* xspans,
                                        const float* gp, int gsi, int gsj,
                                        const float* wyp, int wysi,
                                        const float* wxp, int wxsj, int xb,
                                        int i0, int j0) {
  const bool short_i = i_hi - i_lo <= SPAN;
  float a[SPAN];  // the row's weights, when its span is short
#pragma unroll
  for (int u = 0; u < SPAN; ++u)
    a[u] = short_i && i_lo + u < i_hi ? wyp[(i_lo + u - i0) * wysi] : 0.f;
#pragma unroll
  for (int x = 0; x < TC; ++x) {
    const int xs = xspans[x];
    const int j_lo = span_lo(xs), j_hi = span_hi(xs);
    if (j_lo >= j_hi) continue;
    float contrib[CPL];
#pragma unroll
    for (int q = 0; q < CPL; ++q) contrib[q] = 0.f;
    if (short_i && j_hi - j_lo <= SPAN) {
#pragma unroll
      for (int v = 0; v < SPAN; ++v) {
        const int j = j_lo + v;
        if (j >= j_hi) continue;
        const float b = wxp[(j - j0) * wxsj + xb + x];
        float p[CPL];
#pragma unroll
        for (int q = 0; q < CPL; ++q) p[q] = 0.f;
#pragma unroll
        for (int u = 0; u < SPAN; ++u) {  // stage 1: rows
          if (i_lo + u >= i_hi) continue;
          float gv[CPL];
          load_c<CPL>(gp + (i_lo + u - i0) * gsi + (j - j0) * gsj, gv);
#pragma unroll
          for (int q = 0; q < CPL; ++q) p[q] = fmaf(a[u], gv[q], p[q]);
        }
#pragma unroll
        for (int q = 0; q < CPL; ++q)  // stage 2: columns
          contrib[q] = fmaf(b, p[q], contrib[q]);
      }
    } else {
      // long spans (bins finer than a table cell): four bins of the row
      // and two columns in flight at a time, each sum in its order
      for (int j = j_lo; j < j_hi; j += 2) {
        const bool two = j + 1 < j_hi;
        float p[2][CPL];
#pragma unroll
        for (int t = 0; t < 2; ++t)
#pragma unroll
          for (int q = 0; q < CPL; ++q) p[t][q] = 0.f;
        for (int i = i_lo; i < i_hi; i += 4) {
          float w[4], gv[2][4][CPL];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            if (i + u >= i_hi) continue;
            w[u] = wyp[(i + u - i0) * wysi];
#pragma unroll
            for (int t = 0; t < 2; ++t)
              if (t == 0 || two)
                load_c<CPL>(gp + (i + u - i0) * gsi + (j + t - j0) * gsj,
                            gv[t][u]);
          }
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            if (i + u >= i_hi) continue;
#pragma unroll
            for (int t = 0; t < 2; ++t)
              if (t == 0 || two)
#pragma unroll
                for (int q = 0; q < CPL; ++q)
                  p[t][q] = fmaf(w[u], gv[t][u][q], p[t][q]);
          }
        }
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          if (t == 1 && !two) break;
          const float b = wxp[(j + t - j0) * wxsj + xb + x];
#pragma unroll
          for (int q = 0; q < CPL; ++q)
            contrib[q] = fmaf(b, p[t][q], contrib[q]);
        }
      }
    }
#pragma unroll
    for (int q = 0; q < CPL; ++q) acc[x][q] += contrib[q];
  }
}

template <int CPL>
__global__ void __launch_bounds__(THREADS, 2)
    window_pool_bwd_gather(const float* __restrict__ g,
                           const int* __restrict__ origins,
                           const float* __restrict__ wy,
                           const float* __restrict__ wx,
                           const int* __restrict__ spans,
                           const uint32_t* __restrict__ masks,
                           float* __restrict__ dtable, int R, int Wmax,
                           int C, int N, int S, int win, int nbands) {
  constexpr int CB = 32 * CPL;  // channels a block
  using St = Stage<CPL>;
  extern __shared__ __align__(16) float k7_smem[];
  float* stages = k7_smem;                          // 2 x St::FLOATS
  int* list = (int*)(k7_smem + 2 * St::FLOATS);     // [32 * 32] ROIs
  int(*meta)[META] = (int(*)[META])(list + 32 * 32);  // [BATCH][META]
  __shared__ int list_len;
  const int X0 = blockIdx.x * TC, Y0 = blockIdx.y * TR;
  const int r = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int c0 = blockIdx.z * CB, c = c0 + lane * CPL;
  const bool has_c = c < C;
  const int nw = (N + 31) / 32;
  const uint32_t* bmask = masks + (size_t)blockIdx.y * nw;
  const uint32_t* cmask = masks + (size_t)(nbands + blockIdx.x) * nw;
  float acc[TC][CPL];
#pragma unroll
  for (int x = 0; x < TC; ++x)
#pragma unroll
    for (int q = 0; q < CPL; ++q) acc[x][q] = 0.f;

  // stage pair k of the batch (if it fits) into stage buffer `buf`
  auto stage_pair = [&](int k, int buf) {
    const int* m = meta[k];
    if (!m[M_FIT]) return;
    const int n = list[m[M_IDX]];
    const int i0 = m[M_I0], j0 = m[M_J0];
    const int ni = m[M_I1] - i0, nj = m[M_J1] - j0;
    float* st = stages + buf * St::FLOATS;
    const float* gn = g + ((size_t)n * S * S) * C + c0;
    // warp r copies the block's pixels r, r + TR, ..., each lane its
    // channels of each
    if (c0 + lane * CPL < C) {
      int a = r / nj, b = r % nj;
      for (int pix = r; pix < ni * nj; pix += TR) {
        const float* src =
            gn + ((size_t)(i0 + a) * S + j0 + b) * C + lane * CPL;
        if constexpr (CPL == 4)
          cp_async16(st + pix * CB + lane * 4, src);
        else
          cp_async4(st + pix * CB + lane, src);
        for (b += TR; b >= nj; b -= nj) ++a;
      }
    }
    const float* wn_y = wy + (size_t)n * S * win;
    const float* wn_x = wx + (size_t)n * S * win;
    const int y0 = Y0 - m[0], x0 = X0 - m[1];
    for (int e = threadIdx.x; e < ni * TR + nj * TC; e += THREADS) {
      if (e < ni * TR) {
        const int a = e / TR, rr = e % TR;
        if (y0 + rr >= 0 && y0 + rr < win)
          cp_async4(st + St::G + e, wn_y + (size_t)(i0 + a) * win + y0 + rr);
      } else {
        const int f = e - ni * TR, b = f / TC, xx = f % TC;
        if (x0 + xx >= 0 && x0 + xx < win)
          cp_async4(st + St::G + St::WY + f,
                    wn_x + (size_t)(j0 + b) * win + x0 + xx);
      }
    }
  };

  for (int w0 = 0; w0 < nw; w0 += 32) {
    // the tile's ROIs among the next 32 mask words, in ROI order
    __syncthreads();  // the previous list is consumed
    if (threadIdx.x < 32) {
      const int w = w0 + lane;
      uint32_t bits = w < nw ? bmask[w] & cmask[w] : 0;
      const int cnt = __popc(bits);
      int off = cnt;  // inclusive prefix over the lanes
      for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(~0u, off, o);
        if (lane >= o) off += v;
      }
      if (lane == 31) list_len = off;
      off -= cnt;
      for (; bits; bits &= bits - 1) list[off++] = w * 32 + __ffs(bits) - 1;
    }
    __syncthreads();
    const int len = list_len;
    for (int b0 = 0; b0 < len; b0 += BATCH) {
      const int cnt = min(BATCH, len - b0);
      // the batch's origins and spans over the tile
      __syncthreads();  // the previous batch's meta is consumed
      for (int e = threadIdx.x; e < cnt * (2 + TR + TC); e += THREADS) {
        const int k = e / (2 + TR + TC), f = e % (2 + TR + TC);
        const int n = list[b0 + k];
        const int* sn = spans + (size_t)n * 2 * win;
        int v;
        if (f < 2) {
          v = origins[2 * n + f];
        } else if (f < 2 + TR) {
          const int y = Y0 + f - 2 - origins[2 * n];
          v = y >= 0 && y < win ? sn[y] : 0;
        } else {
          const int x = X0 + f - 2 - TR - origins[2 * n + 1];
          v = x >= 0 && x < win ? sn[win + x] : 0;
        }
        meta[k][f] = v;
      }
      __syncthreads();
      if (threadIdx.x < cnt) {  // each pair's bins over the tile
        int* m = meta[threadIdx.x];
        int i0 = S, i1 = 0, j0 = S, j1 = 0;
        for (int t = 0; t < TR; ++t)
          if (span_hi(m[2 + t]) > 0)
            i0 = min(i0, span_lo(m[2 + t])), i1 = max(i1, span_hi(m[2 + t]));
        for (int t = 0; t < TC; ++t)
          if (span_hi(m[2 + TR + t]) > 0)
            j0 = min(j0, span_lo(m[2 + TR + t])),
            j1 = max(j1, span_hi(m[2 + TR + t]));
        m[M_IDX] = b0 + threadIdx.x;
        m[M_I0] = i0, m[M_I1] = i1, m[M_J0] = j0, m[M_J1] = j1;
        m[M_FIT] = i1 > i0 && j1 > j0 && i1 - i0 <= WCAP &&
                   j1 - j0 <= WCAP && (i1 - i0) * (j1 - j0) <= GCAP;
      }
      __syncthreads();
      // the pairs, pair k + 1's copies in flight while pair k computes
      stage_pair(0, 0);
      cp_async_commit();
      for (int k = 0; k < cnt; ++k) {
        if (k + 1 < cnt) stage_pair(k + 1, (k + 1) & 1);
        cp_async_commit();
        cp_async_wait<1>();
        __syncthreads();
        const int* m = meta[k];
        const int ys = m[2 + r];
        if (span_lo(ys) < span_hi(ys) && has_c) {
          const int i0 = m[M_I0], j0 = m[M_J0];
          if (m[M_FIT]) {
            const float* st = stages + (k & 1) * St::FLOATS;
            const int nj = m[M_J1] - j0;
            add_roi<CPL>(acc, span_lo(ys), span_hi(ys), m + 2 + TR,
                         st + lane * CPL, nj * CB, CB, st + St::G + r, TR,
                         st + St::G + St::WY, TC, 0, i0, j0);
          } else {  // too large to stage: global memory
            const int n = list[m[M_IDX]];
            const size_t wn = (size_t)n * S * win;
            add_roi<CPL>(acc, span_lo(ys), span_hi(ys), m + 2 + TR,
                         g + (size_t)n * S * S * C + c, S * C, C,
                         wy + wn + (Y0 + r - m[0]), win, wx + wn, win,
                         X0 - m[1], 0, 0);
          }
        }
        __syncthreads();  // before the next copies overwrite this stage
      }
      cp_async_wait<0>();
    }
  }
  const int row = Y0 + r;
  if (row >= R || !has_c) return;
  float* drow = dtable + ((size_t)row * Wmax + X0) * C + c;
#pragma unroll
  for (int x = 0; x < TC; ++x)
    if (X0 + x < Wmax) store_c<CPL>(drow + (size_t)x * C, acc[x]);
}

template <int CPL>
static size_t gather_smem() {
  return (2 * (size_t)Stage<CPL>::FLOATS + 32 * 32 + BATCH * META) * 4;
}

struct Layout {
  int nbands, ncols, nw;
  size_t rects, spans, masks, words;  // offsets and size in 4-byte words
};

static Layout layout(int N, int win, int R, int Wmax) {
  Layout l;
  l.nbands = (R + TR - 1) / TR;
  l.ncols = (Wmax + TC - 1) / TC;
  l.nw = (N + 31) / 32;
  l.rects = 0;
  l.spans = 4 * (size_t)N;
  l.masks = l.spans + 2 * (size_t)N * win;
  l.words = l.masks + (size_t)(l.nbands + l.ncols) * l.nw;
  return l;
}

}  // namespace k7

// Scratch the gradient needs, in 4-byte words (the caller allocates it
// 16-byte aligned).
SIAMMOT_API int siammot_window_pool_bwd_scratch(int N, int win, int R,
                                                int Wmax) {
  return (int)k7::layout(N, win, R, Wmax).words;
}

SIAMMOT_API int siammot_window_pool_bwd(const float* g, const int* origins,
                                        const float* wy, const float* wx,
                                        const uint8_t* valid, float* dtable,
                                        int* scratch, int R, int Wmax, int C,
                                        int N, int S, int win,
                                        void* stream) {
  using namespace k7;
  if (win >= 1 << 15 || S >= 1 << 15) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const Layout l = layout(N, win, R, Wmax);
  int4* rects = (int4*)(scratch + l.rects);
  int* spans = scratch + l.spans;
  uint32_t* masks = (uint32_t*)(scratch + l.masks);
  if (N > 0) {
    const size_t smem = 2 * (size_t)win * sizeof(int);
    cudaError_t err = set_smem(window_pool_bwd_spans, smem);
    if (err != cudaSuccess) return (int)err;
    window_pool_bwd_spans<<<N, 256, smem, st>>>(origins, wy, wx, valid,
                                                spans, rects, R, Wmax, S,
                                                win);
    const int words = (l.nbands + l.ncols) * l.nw;
    window_pool_bwd_masks<<<(words + 255) / 256, 256, 0, st>>>(
        rects, masks, N, l.nbands, l.ncols);
  }
  const bool vec = C % 4 == 0 && (uintptr_t)g % 16 == 0 &&
                   (uintptr_t)dtable % 16 == 0;
  const int cpb = 32 * (vec ? 4 : 1);  // channels a block
  dim3 grid(l.ncols, l.nbands, (C + cpb - 1) / cpb);
  if (vec) {
    const size_t smem = gather_smem<4>();
    cudaError_t err = set_smem(window_pool_bwd_gather<4>, smem);
    if (err != cudaSuccess) return (int)err;
    window_pool_bwd_gather<4><<<grid, THREADS, smem, st>>>(
        g, origins, wy, wx, spans, masks, dtable, R, Wmax, C, N, S, win,
        l.nbands);
  } else {
    const size_t smem = gather_smem<1>();
    cudaError_t err = set_smem(window_pool_bwd_gather<1>, smem);
    if (err != cudaSuccess) return (int)err;
    window_pool_bwd_gather<1><<<grid, THREADS, smem, st>>>(
        g, origins, wy, wx, spans, masks, dtable, R, Wmax, C, N, S, win,
        l.nbands);
  }
  return (int)cudaGetLastError();
}
