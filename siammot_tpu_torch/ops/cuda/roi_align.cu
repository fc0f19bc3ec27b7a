// The exact gather ROIAlign, forward and backward: the CUDA form of the
// JAX package's XLA gather pooler (siammot_tpu/ops/roi_align.py:
// multilevel_roi_align, roi_align).  It replaces no Pallas kernel: JAX
// leaves this pooler to XLA.  The port writes it by hand because its plain
// form gathers four corner tensors of every sample, [N, o*r, o*r, C] each
// (2.57 GB in f32 at the AOT recipe's search-region training site), and
// autograd keeps them.
//
// Semantics (maskrcnn ROIAlign, aligned=False, with the virtual pad):
// start = roi * scale, extent = max(end - start, 1), r x r samples a bin at
// start + (s + 0.5) / r * extent / o; a sample outside [-1, padded size]
// weighs 0, else it is clamped into [0, padded size - 1]; taps that land in
// the pad band of a level read 0.  Each ROI names its level block of one
// row table [T, C] (the levels of every image, flattened) by its geometry
// row (first row of the block, height, width, pad) and its scale.
//
// Forward, rounding as the JAX gather rounds in the table's dtype: the
// weight wy * wx formed in f32 and cast to the dtype, each corner product
// taken in the dtype, the four corners added in the dtype in the order
// lo-lo, lo-hi, hi-lo, hi-hi, and the r * r samples averaged as jnp.mean
// averages: an f32 sum, divided, rounded once.  No fused multiply-adds
// (explicit __fmul_rn / __fadd_rn), so the f32 arithmetic is the plain
// form's, operation for operation.
//
// Backward: the gradient in the table only (proposals are data): each
// table element sums (g / r^2) * w over the samples whose taps reach it,
// w the forward's corner weight rounded to the dtype, g / r^2 divided as
// the forward's mean divides; each product and sum in f32 (no
// contraction), in one fixed order: the ROIs that reach the element in
// ROI order, then each ROI's samples in order (its bins in row-major
// order, then each bin's samples in row-major order), by one thread, or
// where its tile's list is long, by one thread a chunk of the list and
// the chunks' sums added in chunk order; stored once in the table's dtype
// (the same f32 sums rounded once; ops/roi_align.py:
// roi_align_bwd_ordered is the order in plain PyTorch).  No
// float atomics: the gradient is bitwise the same from call to call, and
// every element is written, zeros included.
//
// Bound on the H100: bytes, at every site.  An output element takes 4 r^2
// taps and about 8 r^2 operations, but the taps of neighbouring samples
// and ROIs overlap and hit the caches: what must move is the table rows
// under the taps, once, and the output (forward), or the upstream
// gradient, once, and the whole table gradient (backward).
//
// Forward design (roi_align_fwd_staged, where C and the pointers allow
// 16-byte accesses): a block per (ROI, band of output rows), a ROI's
// bands one after another and, at large sites, the ROIs in the order of
// the table row under their centres (roi_fwd_order), so that the cells of
// neighbouring bands and overlapping ROIs meet in the L2.  The block
// computes its ROI's column taps and its band's row taps, the distinct
// table columns and rows they read (one warp each, by ballots: along an
// axis the taps rise with the sample) and every sample's four weights;
// then, slice by slice of 64 bytes of channels, it copies the cells under
// them (rows x columns x the slice) into shared memory with cp.async,
// once, 16 bytes a copy, and a thread per (output row, output column, 16
// bytes of channels) adds its r x r samples from there.  bf16 products
// and sums are bf16x2 instructions (the f32 operation rounded to bf16
// gives the same bits: see add_sample).  The band is as many output rows
// as keep a block near 128 threads, so the small inference sites have
// enough blocks.  Other channel counts, and sites whose staged block
// would pass the shared memory a block may hold (a sampling ratio past 3
// at the widest outputs), take roi_align_fwd: a block per
// (ROI, band of BAND output rows), a thread per (channel group, output
// column), loads from global memory.  A dead ROI writes zeros and reads
// nothing.  What sets its pace at the AOT step's search-region site: the
// staged bytes (each ROI's own footprint, ~2.7 GB in bf16) from the L2
// and HBM, and the block's setup and barriers (PERF.md).
//
// Backward design, a gather over table tiles:
// 1. roi_bwd_taps, a block per ROI: its taps on both axes, and for every
//    row and column of its level the span of samples that reach it (the
//    first and last, each known from its neighbours' taps), its
//    rectangle of reached cells and its layout block.
// 2. roi_bwd_masks, a thread per (row band or column span of TILE cells
//    of a block, word of 32 ROIs): the bits of the block's ROIs whose
//    rectangle meets it.
// 3. roi_bwd_lengths, a warp per tile: its list's length, and for each
//    range of 32 tiles the chunks that cutting its lists at 32, 64, ...
//    ROIs would make.
// 4. roi_bwd_plan, one block: where ROIs pile up on a few objects a few
//    tiles hold long lists, which one block each would walk alone while
//    the card idles; the lists longer than q ROIs are cut into chunks of
//    q, q the least of 32, 64, ... whose chunks fit in the call's partial
//    slots; each range's first slot.
// 5. roi_bwd_chunks, a thread per tile: its list's chunks' slots, in tile
//    order, by prefix sums.
// 6. roi_bwd_gather, a block per (tile of TILE x TILE cells, slice of K
//    x GROUPS x V channels) and one per chunk past a list's first, a
//    thread per (cell, K groups of V channels, 16 bytes of the upstream
//    gradient each): the AND of the tile's band and column words, walked
//    low bit to high, is its ROI list in ROI order; the block takes all
//    of it, or its chunk; it stages the ROIs' spans over the tile and the
//    weights of their first SPAN samples, 32 ROIs at a time; each thread
//    adds the samples of its cell's row span x column span, bin by bin,
//    each bin's g loaded once for its K groups; a chunk's sums go to its
//    slot in f32.
// 7. roi_bwd_reduce, a block per long list: its chunks' sums added in
//    chunk order, stored once in the table's dtype.
//    What sets its pace: instruction issue at 16 warps an SM (the K x V
//    sums and the bin's g take 127 registers), the g loads, then the taps
//    (PERF.md).
#include <limits.h>

#include "common.cuh"

namespace roi {

constexpr int BAND = 4;          // output rows a block
constexpr int MAX_THREADS = 256;

// The taps of one sample along one axis: real (unpadded) indices, clamped
// into the level, and their weights, 0 where the JAX gather weighs 0.
struct Taps {
  int lo, hi;
  float w_lo, w_hi;
};

__device__ __forceinline__ Taps axis_taps(float pos, int size, int pad) {
  const int sp = size + 2 * pad;
  const bool inside = pos >= -1.f && pos <= (float)sp;
  const float p = fminf(fmaxf(pos, 0.f), (float)(sp - 1));
  const int lo = min((int)floorf(p), sp - 1);
  const int hi = min(lo + 1, sp - 1);
  const float frac = lo >= sp - 1 ? 0.f : __fsub_rn(p, (float)lo);
  const int rlo = lo - pad, rhi = hi - pad;
  Taps t;
  t.w_lo = inside && rlo >= 0 && rlo < size ? __fsub_rn(1.f, frac) : 0.f;
  t.w_hi = inside && rhi >= 0 && rhi < size ? frac : 0.f;
  t.lo = min(max(rlo, 0), size - 1);
  t.hi = min(max(rhi, 0), size - 1);
  return t;
}

// Sample i of an axis (i in [0, o * r)): start + ((i + 0.5) / r) * bin.
__device__ __forceinline__ float sample_pos(float start, float bin, int i,
                                            int r) {
  return __fadd_rn(start,
                   __fmul_rn(__fdiv_rn((float)i + 0.5f, (float)r), bin));
}

// A float rounded to the table's dtype and back.
template <typename T>
__device__ __forceinline__ float rnd(float x);
template <>
__device__ __forceinline__ float rnd<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ float rnd<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ void store(float* p, size_t i, float v) {
  p[i] = v;
}
__device__ __forceinline__ void store(__nv_bfloat16* p, size_t i, float v) {
  p[i] = __float2bfloat16_rn(v);
}

// V consecutive channels as one load or store (V = 4: 16 bytes of f32, 8
// of bf16), or one channel (V = 1).
template <typename T, int V>
struct Vec {
  static __device__ __forceinline__ void load(const T* p, float (&v)[V]) {
    v[0] = load_f32(p, 0);
  }
  static __device__ __forceinline__ void store(T* p, const float (&v)[V]) {
    roi::store(p, 0, v[0]);
  }
};
template <>
struct Vec<float, 4> {
  static __device__ __forceinline__ void load(const float* p, float (&v)[4]) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
  }
  static __device__ __forceinline__ void store(float* p, const float (&v)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};
template <>
struct Vec<__nv_bfloat16, 4> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float (&v)[4]) {
    const uint2 q = *reinterpret_cast<const uint2*>(p);
    const float2 a = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&q.x));
    const float2 b = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&q.y));
    v[0] = a.x, v[1] = a.y, v[2] = b.x, v[3] = b.y;
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p,
                                               const float (&v)[4]) {
    const __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
    const __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
    uint2 q;
    q.x = *reinterpret_cast<const unsigned*>(&a);
    q.y = *reinterpret_cast<const unsigned*>(&b);
    *reinterpret_cast<uint2*>(p) = q;
  }
};

// Shared memory of a block: the column taps of its ROI [o * r], the row
// taps of its band [BAND * r], then each of the band's samples' four
// weights [BAND * r][o * r] (lo-lo, lo-hi, hi-lo, hi-hi), rounded to the
// table's dtype once for every channel.
static __host__ __device__ size_t smem_for(int o, int r) {
  return (size_t)(o + BAND) * r * sizeof(Taps) +
         (size_t)BAND * r * o * r * sizeof(float4);
}

// The block's taps and sample weights (then a barrier).
template <typename T>
__device__ __forceinline__ void block_taps(const float* __restrict__ rois,
                                           const int* __restrict__ geom,
                                           const float* __restrict__ scale,
                                           int n, int o, int r, int py0,
                                           int rows, Taps* xt, Taps* yt,
                                           float4* wq) {
  const float s = scale[n];
  const float x0 = __fmul_rn(rois[4 * n + 0], s);
  const float y0 = __fmul_rn(rois[4 * n + 1], s);
  const float x1 = __fmul_rn(rois[4 * n + 2], s);
  const float y1 = __fmul_rn(rois[4 * n + 3], s);
  const float bin_x = __fdiv_rn(fmaxf(__fsub_rn(x1, x0), 1.f), (float)o);
  const float bin_y = __fdiv_rn(fmaxf(__fsub_rn(y1, y0), 1.f), (float)o);
  const int h = geom[4 * n + 1], w = geom[4 * n + 2], pad = geom[4 * n + 3];
  for (int i = threadIdx.x; i < o * r; i += blockDim.x)
    xt[i] = axis_taps(sample_pos(x0, bin_x, i, r), w, pad);
  for (int i = threadIdx.x; i < rows * r; i += blockDim.x)
    yt[i] = axis_taps(sample_pos(y0, bin_y, py0 * r + i, r), h, pad);
  __syncthreads();
  for (int i = threadIdx.x; i < rows * r * o * r; i += blockDim.x) {
    const Taps ty = yt[i / (o * r)], tx = xt[i % (o * r)];
    wq[i] = make_float4(rnd<T>(__fmul_rn(ty.w_lo, tx.w_lo)),
                        rnd<T>(__fmul_rn(ty.w_lo, tx.w_hi)),
                        rnd<T>(__fmul_rn(ty.w_hi, tx.w_lo)),
                        rnd<T>(__fmul_rn(ty.w_hi, tx.w_hi)));
  }
  __syncthreads();
}

// Threads of a block: (channel, output column) pairs, channels fastest.
struct Smem {
  Taps* xt;
  Taps* yt;
  float4* wq;
};
__device__ __forceinline__ Smem carve(unsigned char* smem, int o, int r) {
  Smem m;
  m.xt = reinterpret_cast<Taps*>(smem);
  m.yt = m.xt + o * r;
  m.wq = reinterpret_cast<float4*>(m.yt + BAND * r);
  return m;
}

template <typename T, int V>
__global__ void __launch_bounds__(MAX_THREADS)
    roi_align_fwd(const T* __restrict__ table, int C,
                  const float* __restrict__ rois,
                  const int* __restrict__ geom,
                  const float* __restrict__ scale,
                  const uint8_t* __restrict__ valid, T* __restrict__ out,
                  int o, int r) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Smem m = carve(smem, o, r);
  const int n = blockIdx.x;
  const int py0 = blockIdx.y * BAND;
  const int rows = min(BAND, o - py0);
  const size_t out0 = ((size_t)n * o + py0) * o * C;
  if (valid && !valid[n]) {
    for (size_t i = threadIdx.x; i < (size_t)rows * o * C; i += blockDim.x)
      store(out, out0 + i, 0.f);
    return;
  }
  block_taps<T>(rois, geom, scale, n, o, r, py0, rows, m.xt, m.yt, m.wq);
  const size_t base = (size_t)geom[4 * n];
  const int w = geom[4 * n + 2];
  const float count = (float)(r * r);
  const int cv = C / V;
  for (int idx = threadIdx.x; idx < cv * o; idx += blockDim.x) {
    const int c = (idx % cv) * V, px = idx / cv;
    for (int py = 0; py < rows; ++py) {
      float acc[V];
#pragma unroll
      for (int k = 0; k < V; ++k) acc[k] = 0.f;
      for (int sy = 0; sy < r; ++sy) {
        const Taps ty = m.yt[py * r + sy];
        const size_t row_lo = base + (size_t)ty.lo * w;
        const size_t row_hi = base + (size_t)ty.hi * w;
        const float4* wrow = m.wq + (size_t)(py * r + sy) * o * r + px * r;
        for (int sx = 0; sx < r; ++sx) {
          const Taps tx = m.xt[px * r + sx];
          const float4 q = wrow[sx];
          float v_ll[V], v_lh[V], v_hl[V], v_hh[V];
          Vec<T, V>::load(table + (row_lo + tx.lo) * C + c, v_ll);
          Vec<T, V>::load(table + (row_lo + tx.hi) * C + c, v_lh);
          Vec<T, V>::load(table + (row_hi + tx.lo) * C + c, v_hl);
          Vec<T, V>::load(table + (row_hi + tx.hi) * C + c, v_hh);
#pragma unroll
          for (int k = 0; k < V; ++k) {
            float t = rnd<T>(__fadd_rn(rnd<T>(__fmul_rn(v_ll[k], q.x)),
                                       rnd<T>(__fmul_rn(v_lh[k], q.y))));
            t = rnd<T>(__fadd_rn(t, rnd<T>(__fmul_rn(v_hl[k], q.z))));
            t = rnd<T>(__fadd_rn(t, rnd<T>(__fmul_rn(v_hh[k], q.w))));
            acc[k] = __fadd_rn(acc[k], t);
          }
        }
      }
#pragma unroll
      for (int k = 0; k < V; ++k) acc[k] = __fdiv_rn(acc[k], count);
      Vec<T, V>::store(out + out0 + ((size_t)py * o + px) * C + c, acc);
    }
  }
}

// -- the backward: a gather over table tiles --------------------------------

constexpr int TILE = 8;          // table rows and columns a tile (bwd_plan)
constexpr int GROUPS = 4;        // threads a cell (channel groups a slice)
constexpr int GATHER_THREADS = TILE * TILE * GROUPS;
constexpr int GATHER_K = 4;      // groups of V channels a gather thread
constexpr int BLOCK_COLS = 7;    // a layout block's row (bwd_plan)
constexpr int BATCH = 32;        // ROIs whose spans a gather stages at once
constexpr int SPAN = 8;          // samples of a span whose weights it stages
// roi_bwd_gather's static shared memory (its spans, their weights and the
// list's length; ops/roi_align.py:BWD_STATIC_SMEM); the list takes the
// rest of the 227 KB a block may opt in to
constexpr size_t GATHER_STATIC =
    BATCH * 2 * TILE * (sizeof(int) + SPAN * sizeof(float)) + sizeof(int);
static_assert(GATHER_STATIC == 18436, "ops/roi_align.py:BWD_STATIC_SMEM");
constexpr size_t SMEM_OPT_IN = 227 * 1024;  // a block's most shared memory
// Long lists: a tile's list is cut into chunks of q ROIs, q the least
// CHUNK << k (k < CHUNK_STEPS) whose chunks of the lists longer than q fit
// in the call's partial slots (ops/roi_align.py:bwd_chunk_size); the last
// q passes BWD_MAX_ROIS, so no list is longer
constexpr int CHUNK = BATCH;
constexpr int CHUNK_STEPS = 12;
constexpr int RANGE = 32;       // tiles a range of the chunk planning
constexpr int RANGE_WARPS = 8;  // warps a range's lengths

// 8 bf16 channels as one 16-byte load or store; f32 stores of 8 channels
// as two 16-byte stores
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 q = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x, v[2 * i + 1] = f.y;
  }
}

template <typename T, int V>
__device__ __forceinline__ void load_vec(const T* p, float (&v)[V]) {
  if constexpr (V == 8) {
    load8(p, v);
  } else {
    Vec<T, V>::load(p, v);
  }
}

template <typename T, int V>
__device__ __forceinline__ void store_vec(T* p, const float (&v)[V]) {
  if constexpr (V == 8 && sizeof(T) == 2) {
    uint4 q;
    unsigned* u = reinterpret_cast<unsigned*>(&q);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
      u[i] = *reinterpret_cast<const unsigned*>(&h);
    }
    *reinterpret_cast<uint4*>(p) = q;
  } else if constexpr (V == 8) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
    *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
  } else {
    Vec<T, V>::store(p, v);
  }
}

// Whether a sample's taps reach table row (or column) u with a non-zero
// weight, and that weight (a sample reaches u by at most one tap).
__device__ __forceinline__ bool hits(const Taps& t, int u) {
  return (t.lo == u && t.w_lo != 0.f) || (t.hi == u && t.w_hi != 0.f);
}
__device__ __forceinline__ float weight_at(const Taps& t, int u) {
  return t.lo == u && t.w_lo != 0.f ? t.w_lo : t.w_hi;
}

// The layout block a ROI's geometry row names (first row, height, width),
// or -1.
__device__ __forceinline__ int find_block(const int* __restrict__ blocks,
                                          int nb, int off, int h, int w) {
  for (int k = 0; k < nb; ++k) {
    const int* b = blocks + k * BLOCK_COLS;
    if (b[0] == off && b[1] == h && b[2] == w) return k;
  }
  return -1;
}

// 1. A block per ROI: its taps on both axes (taps [N][2][o * r], rows then
// columns), and for every row and column of its level the span [lo, hi) of
// samples whose taps reach it with a non-zero weight (spans [N][SH + SW],
// lo | hi << 16, 0 = none: along an axis the samples' taps rise with the
// sample, so the samples that reach a row are contiguous), the rectangle
// of rows and columns it reaches (rects [N], empty: first > last) and its
// layout block (blk [N], -1: it reaches nothing).
__global__ void roi_bwd_taps(const float* __restrict__ rois,
                             const int* __restrict__ geom,
                             const float* __restrict__ scale,
                             const int* __restrict__ blocks, int nb, int o,
                             int r, int SH, int SW, Taps* __restrict__ taps,
                             int* __restrict__ spans,
                             int4* __restrict__ rects, int* __restrict__ blk) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n = blockIdx.x, os = o * r;
  Taps* yt = reinterpret_cast<Taps*>(smem);
  Taps* xt = yt + os;
  int* sp = reinterpret_cast<int*>(xt + os);  // [SH + SW]
  __shared__ int ext[4];
  const float s = scale[n];
  const float x0 = __fmul_rn(rois[4 * n + 0], s);
  const float y0 = __fmul_rn(rois[4 * n + 1], s);
  const float x1 = __fmul_rn(rois[4 * n + 2], s);
  const float y1 = __fmul_rn(rois[4 * n + 3], s);
  const float bin_x = __fdiv_rn(fmaxf(__fsub_rn(x1, x0), 1.f), (float)o);
  const float bin_y = __fdiv_rn(fmaxf(__fsub_rn(y1, y0), 1.f), (float)o);
  const int h = geom[4 * n + 1], w = geom[4 * n + 2], pad = geom[4 * n + 3];
  Taps* out = taps + (size_t)n * 2 * os;
  for (int i = threadIdx.x; i < os; i += blockDim.x) {
    yt[i] = out[i] = axis_taps(sample_pos(y0, bin_y, i, r), h, pad);
    xt[i] = out[os + i] = axis_taps(sample_pos(x0, bin_x, i, r), w, pad);
  }
  for (int i = threadIdx.x; i < SH + SW; i += blockDim.x) sp[i] = 0;
  if (threadIdx.x == 0) ext[0] = ext[2] = INT_MAX, ext[1] = ext[3] = -1;
  __syncthreads();
  for (int t = threadIdx.x; t < 2 * os; t += blockDim.x) {
    const bool is_y = t < os;
    const int i = is_y ? t : t - os;
    const Taps* tv = is_y ? yt : xt;
    int* s_ = is_y ? sp : sp + SH;
    int* e = is_y ? ext : ext + 2;
    const int lim = is_y ? SH : SW;
    const Taps c = tv[i];
    for (int k = 0; k < 2; ++k) {
      const int u = k ? c.hi : c.lo;
      if ((k ? c.w_hi : c.w_lo) == 0.f || u >= lim) continue;
      if (i == 0 || !hits(tv[i - 1], u)) atomicOr(s_ + u, i);
      if (i + 1 == os || !hits(tv[i + 1], u)) atomicOr(s_ + u, (i + 1) << 16);
      atomicMin(e, u);
      atomicMax(e + 1, u);
    }
  }
  __syncthreads();
  int* dst = spans + (size_t)n * (SH + SW);
  for (int i = threadIdx.x; i < SH + SW; i += blockDim.x) dst[i] = sp[i];
  if (threadIdx.x == 0) {
    const bool any = ext[1] >= 0 && ext[3] >= 0;
    rects[n] = make_int4(ext[0], ext[1], ext[2], ext[3]);
    blk[n] = any ? find_block(blocks, nb, geom[4 * n], h, w) : -1;
  }
}

// 2. A thread per (row band of TILE rows, or column span of TILE columns,
// of a layout block) and word of 32 ROIs: the bits of the ROIs of that
// block whose rectangle meets it.  masks [bands + columns][words]; a
// tile's ROIs are the AND of its band's and its columns' words, and
// walking the bits low to high visits them in ROI order.
__global__ void roi_bwd_masks(const int* __restrict__ blocks, int nb,
                              const int4* __restrict__ rects,
                              const int* __restrict__ blk, int N, int words,
                              int n_bands, int n_cols,
                              unsigned* __restrict__ masks) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  const int q = idx / words, wd = idx % words;
  if (q >= n_bands + n_cols) return;
  const bool band = q < n_bands;
  const int qq = band ? q : q - n_bands;
  int k = 0, lo = 0;
  for (; k < nb; ++k) {
    const int* b = blocks + k * BLOCK_COLS;
    const int first = band ? b[5] : b[6];
    const int cnt = ((band ? b[1] : b[2]) + TILE - 1) / TILE;
    if (qq >= first && qq < first + cnt) {
      lo = (qq - first) * TILE;
      break;
    }
  }
  const int hi = lo + TILE - 1;
  unsigned bits = 0;
  for (int b = 0; b < 32; ++b) {
    const int n = wd * 32 + b;
    if (n >= N || blk[n] != k) continue;
    const int4 rc = rects[n];
    const bool meets = band ? rc.x <= hi && rc.y >= lo
                            : rc.z <= hi && rc.w >= lo;
    if (meets) bits |= 1u << b;
  }
  masks[(size_t)q * words + wd] = bits;
}

// The exclusive prefix sum of v over the block's threads, in thread
// order, and their total (shared: [32] ints; blockDim a multiple of 32).
__device__ __forceinline__ int block_scan(int v, int* __restrict__ shared,
                                          int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x / 32;
  int incl = v;
  for (int d = 1; d < 32; d <<= 1) {
    const int u = __shfl_up_sync(~0u, incl, d);
    if (lane >= d) incl += u;
  }
  if (lane == 31) shared[warp] = incl;
  __syncthreads();
  int before = 0;
  total = 0;
  for (int w = 0; w < (int)blockDim.x / 32; ++w) {
    if (w < warp) before += shared[w];
    total += shared[w];
  }
  __syncthreads();
  return before + incl - v;
}

// 3. A block per range of RANGE tiles, a warp per tile: the length of its
// list (the bits of the AND of its band's and its columns' words), and
// the range's chunks of CHUNK << k ROIs of the lists longer than that
// (part [ranges][CHUNK_STEPS]).
__global__ void __launch_bounds__(RANGE_WARPS * 32)
    roi_bwd_lengths(const int* __restrict__ blocks, int nb,
                    const unsigned* __restrict__ masks, int words,
                    int n_bands, int n_tiles, int* __restrict__ len,
                    int* __restrict__ part) {
  __shared__ int cnt_s[RANGE_WARPS][CHUNK_STEPS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x / 32;
  int mine[CHUNK_STEPS];
#pragma unroll
  for (int k = 0; k < CHUNK_STEPS; ++k) mine[k] = 0;
  for (int i = warp; i < RANGE; i += RANGE_WARPS) {
    const int t = blockIdx.x * RANGE + i;
    if (t >= n_tiles) break;
    int k = 0;
    while (k + 1 < nb && blocks[(k + 1) * BLOCK_COLS + 3] <= t) ++k;
    const int* b = blocks + k * BLOCK_COLS;
    const int local = t - b[3];
    const unsigned* mb = masks + (size_t)(b[5] + local / b[4]) * words;
    const unsigned* mc =
        masks + (size_t)(n_bands + b[6] + local % b[4]) * words;
    int l = 0;
    for (int wd = lane; wd < words; wd += 32) l += __popc(mb[wd] & mc[wd]);
    for (int d = 16; d > 0; d >>= 1) l += __shfl_xor_sync(~0u, l, d);
    if (lane == 0) len[t] = l;
#pragma unroll
    for (int k = 0; k < CHUNK_STEPS; ++k)
      if (l > CHUNK << k) mine[k] += (l + (CHUNK << k) - 1) / (CHUNK << k);
  }
  if (lane == 0)
#pragma unroll
    for (int k = 0; k < CHUNK_STEPS; ++k) cnt_s[warp][k] = mine[k];
  __syncthreads();
  if (threadIdx.x < CHUNK_STEPS) {
    int sum = 0;
    for (int w = 0; w < RANGE_WARPS; ++w) sum += cnt_s[w][threadIdx.x];
    part[blockIdx.x * CHUNK_STEPS + threadIdx.x] = sum;
  }
}

// 4. One block: the chunk size q, the least CHUNK << k whose chunks fit in
// `parts` slots (plan[0]), the slots in all (plan[1]) and each range's
// first slot (base [ranges]), in range order.
__global__ void __launch_bounds__(1024)
    roi_bwd_plan(const int* __restrict__ part, int ranges, int parts,
                 int* __restrict__ plan, int* __restrict__ base) {
  __shared__ int scan_s[32];
  __shared__ int warp_s[32][CHUNK_STEPS];
  __shared__ int total_s[CHUNK_STEPS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x / 32;
  int mine[CHUNK_STEPS];
#pragma unroll
  for (int k = 0; k < CHUNK_STEPS; ++k) mine[k] = 0;
  for (int g = threadIdx.x; g < ranges; g += blockDim.x)
#pragma unroll
    for (int k = 0; k < CHUNK_STEPS; ++k) mine[k] += part[g * CHUNK_STEPS + k];
#pragma unroll
  for (int k = 0; k < CHUNK_STEPS; ++k) {
    for (int d = 16; d > 0; d >>= 1)
      mine[k] += __shfl_xor_sync(~0u, mine[k], d);
    if (lane == 0) warp_s[warp][k] = mine[k];
  }
  __syncthreads();
  if (threadIdx.x < CHUNK_STEPS) {
    int sum = 0;
    for (int w = 0; w < (int)blockDim.x / 32; ++w)
      sum += warp_s[w][threadIdx.x];
    total_s[threadIdx.x] = sum;
  }
  __syncthreads();
  int k = 0;
  while (k + 1 < CHUNK_STEPS && total_s[k] > parts) ++k;
  int at = 0;
  for (int g0 = 0; g0 < ranges; g0 += blockDim.x) {
    const int g = g0 + threadIdx.x;
    const int v = g < ranges ? part[g * CHUNK_STEPS + k] : 0;
    int total;
    const int excl = block_scan(v, scan_s, total);
    if (g < ranges) base[g] = at + excl;
    at += total;
  }
  if (threadIdx.x == 0) plan[0] = CHUNK << k, plan[1] = at;
}

// 5. A block per range, a thread per tile: where its list is longer than
// q, its chunks' partial slots, consecutive, in tile order: slot_of[t]
// the first (-1: one chunk, written to the table by its own block),
// work[s] = (tile, chunk) of slot s.
__global__ void __launch_bounds__(RANGE)
    roi_bwd_chunks(const int* __restrict__ len, int n_tiles,
                   const int* __restrict__ plan,
                   const int* __restrict__ base, int* __restrict__ slot_of,
                   int2* __restrict__ work) {
  __shared__ int scan_s[32];
  const int t = blockIdx.x * RANGE + threadIdx.x, q = plan[0];
  const int l = t < n_tiles ? len[t] : 0;
  const int n = l > q ? (l + q - 1) / q : 0;
  int total;
  const int first = base[blockIdx.x] + block_scan(n, scan_s, total);
  if (t >= n_tiles) return;
  slot_of[t] = n ? first : -1;
  for (int j = 0; j < n; ++j) work[first + j] = make_int2(t, j);
}

// The layout block that holds tile t (its first tile is at most t): one
// warp's ballot over up to 32 blocks at a time.
__device__ __forceinline__ int tile_block(const int* __restrict__ blocks,
                                          int nb, int t) {
  int k = 0;
  for (int base = 0; base < nb; base += 32) {
    const int kk = base + (threadIdx.x & 31);
    const bool before =
        kk < nb && blocks[kk * BLOCK_COLS + 3] <= t;
    k += __popc(__ballot_sync(~0u, before));
  }
  return k - 1;
}

// g / r^2 as the forward's mean divides: an IEEE division, or where r^2 is
// a power of two the product with its exact reciprocal (the same rounded
// quotient).
__device__ __forceinline__ float div_count(float g, float count, float inv,
                                           bool pow2) {
  return pow2 ? __fmul_rn(g, inv) : __fdiv_rn(g, count);
}

// 6. A block per (table tile of TILE x TILE cells, slice of K x GROUPS x
// V channels), and one per partial slot past the tiles (those of a long
// list's chunks but its first, which its tile's block takes): a thread
// per (cell, K groups of V channels).  Warp 0 turns the AND of the tile's
// band and column words into the tile's ROI list in ROI order (shared
// memory), of which the block takes all, or its chunk of q; the block
// stages the ROIs' spans over the tile's
// rows and columns BATCH ROIs at a time; then each thread adds, ROI by
// ROI, the samples that reach its cell in order (the ROI's bins in
// row-major order, each loaded once, then the bin's samples in row-major
// order): acc += (g / r^2) * w, w the forward's corner weight rounded to
// the dtype, in f32 with no contraction.  A thread holds K groups of V
// channels (K loads of g in flight a bin).  Stored once in the table's
// dtype (TO), zeros where nothing reaches; a chunk's f32 sums go to its
// partial slot (ws [parts][TILE * TILE][C]) instead.
template <typename T, typename TO, int V, int K, int R>
__global__ void __launch_bounds__(GATHER_THREADS)
    roi_bwd_gather(const T* __restrict__ grad, int C,
                   const int* __restrict__ blocks, int nb,
                   const Taps* __restrict__ taps,
                   const int* __restrict__ spans,
                   const unsigned* __restrict__ masks, int words,
                   int n_bands, int n_tiles, const int* __restrict__ plan,
                   const int* __restrict__ slot_of,
                   const int2* __restrict__ work, float* __restrict__ ws,
                   TO* __restrict__ dtable, int o, int r_, int SH, int SW) {
  const int r = R ? R : r_;  // a constant where the sampling ratio is 2
  extern __shared__ int list[];  // [32 * words]
  __shared__ int sspan[BATCH * 2 * TILE];
  // the weights of each span's first SPAN samples toward its row or column
  // (a span of more samples reads its taps from global memory)
  __shared__ float sweight[BATCH * 2 * TILE * SPAN];
  __shared__ int n_list;
  int t = blockIdx.x, chunk = 0, slot;
  if (t < n_tiles) {
    slot = slot_of[t];
  } else {  // a partial slot: a chunk past a long list's first
    slot = t - n_tiles;
    if (slot >= plan[1]) return;
    const int2 wk = work[slot];
    if (wk.y == 0) return;
    t = wk.x, chunk = wk.y;
  }
  const int* b = blocks + tile_block(blocks, nb, t) * BLOCK_COLS;
  const int h = b[1], w = b[2], tcols = b[4];
  const int local = t - b[3];
  const int tr = local / tcols, tc = local % tcols;
  const int cell = threadIdx.x / GROUPS;
  const int cy = cell / TILE, cx = cell % TILE;
  const int y = tr * TILE + cy, x = tc * TILE + cx;
  // channels c0 + k * GROUPS * V, k < K: the GROUPS threads of a cell read
  // GROUPS * V neighbouring channels at each k
  const int c0 = (blockIdx.y * K * GROUPS + threadIdx.x % GROUPS) * V;
  const bool live = y < h && x < w && c0 < C;
  if (threadIdx.x < 32) {
    const unsigned* mb = masks + (size_t)(b[5] + tr) * words;
    const unsigned* mc = masks + (size_t)(n_bands + b[6] + tc) * words;
    const int lane = threadIdx.x;
    int at = 0;
    for (int base = 0; base < words; base += 32) {
      const int wd = base + lane;
      unsigned m = wd < words ? mb[wd] & mc[wd] : 0u;
      const int cnt = __popc(m);
      int incl = cnt;
      for (int d = 1; d < 32; d <<= 1) {
        const int v = __shfl_up_sync(~0u, incl, d);
        if (lane >= d) incl += v;
      }
      int pos = at + incl - cnt;
      while (m) {
        list[pos++] = wd * 32 + __ffs(m) - 1;
        m &= m - 1;
      }
      at += __shfl_sync(~0u, incl, 31);
    }
    if (lane == 0) n_list = at;
  }
  __syncthreads();
  const int per = slot < 0 ? n_list : plan[0];  // ROIs a chunk
  const int first = chunk * per, n_rois = min(n_list, first + per);
  const int os = o * r, count_i = r * r;
  const float count = (float)count_i, inv = 1.f / count;
  const bool pow2 = (count_i & (count_i - 1)) == 0;
  float acc[K][V];
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int i = 0; i < V; ++i) acc[k][i] = 0.f;
  for (int b0 = first; b0 < n_rois; b0 += BATCH) {
    const int nbatch = min(BATCH, n_rois - b0);
    for (int it = threadIdx.x; it < nbatch * 2 * TILE; it += blockDim.x) {
      const int q = it % (2 * TILE);
      const int* sn = spans + (size_t)list[b0 + it / (2 * TILE)] * (SH + SW);
      const int u = q < TILE ? tr * TILE + q : tc * TILE + q - TILE;
      sspan[it] = q < TILE ? (u < min(h, SH) ? sn[u] : 0)
                           : (u < min(w, SW) ? sn[SH + u] : 0);
    }
    __syncthreads();
    for (int it = threadIdx.x; it < nbatch * 2 * TILE * SPAN;
         it += blockDim.x) {
      const int e = it / SPAN, q = e % (2 * TILE);
      const int i = (sspan[e] & 0xffff) + it % SPAN;
      if (i < (sspan[e] >> 16))
        sweight[it] = weight_at(
            taps[((size_t)list[b0 + e / (2 * TILE)] * 2 + q / TILE) * os + i],
            q < TILE ? tr * TILE + q : tc * TILE + q - TILE);
    }
    __syncthreads();
    for (int kk = 0; live && kk < nbatch; ++kk) {
      const int sy = sspan[kk * 2 * TILE + cy];
      const int sx = sspan[kk * 2 * TILE + TILE + cx];
      if (!sy || !sx) continue;
      const int n = list[b0 + kk];
      const Taps* ty_ = taps + (size_t)n * 2 * os;
      const Taps* tx_ = ty_ + os;
      const int i0 = sy & 0xffff, i1 = sy >> 16;
      const int j0 = sx & 0xffff, j1 = sx >> 16;
      const float* swy = sweight + (kk * 2 * TILE + cy) * SPAN - i0;
      const float* swx = sweight + (kk * 2 * TILE + TILE + cx) * SPAN - j0;
      const bool fy = i1 - i0 <= SPAN, fx = j1 - j0 <= SPAN;
      // the bins that reach the cell in row-major order, each loaded once;
      // a bin's samples that reach it in row-major order
      for (int bi = i0 / r; bi <= (i1 - 1) / r; ++bi) {
        const int ia = max(i0, bi * r), ib = min(i1, bi * r + r);
        const T* grow = grad + ((size_t)n * o + bi) * o * C + c0;
        for (int bj = j0 / r; bj <= (j1 - 1) / r; ++bj) {
          const int ja = max(j0, bj * r), jb = min(j1, bj * r + r);
          float g[K][V];
#pragma unroll
          for (int k = 0; k < K; ++k) {
            if (c0 + k * GROUPS * V < C)
              load_vec<T, V>(grow + (size_t)bj * C + k * GROUPS * V, g[k]);
#pragma unroll
            for (int q = 0; q < V; ++q)
              g[k][q] = div_count(g[k][q], count, inv, pow2);
          }
          auto add = [&](float wgt) {
#pragma unroll
            for (int k = 0; k < K; ++k)
#pragma unroll
              for (int q = 0; q < V; ++q)
                acc[k][q] = __fadd_rn(acc[k][q], __fmul_rn(g[k][q], wgt));
          };
          if constexpr (R > 0) {  // the bin's R x R samples, unrolled
            float wx[R];
#pragma unroll
            for (int jj = 0; jj < R; ++jj) {
              const int j = bj * R + jj;
              wx[jj] = j < ja || j >= jb ? 0.f
                       : fx             ? swx[j]
                                        : weight_at(tx_[j], x);
            }
#pragma unroll
            for (int ii = 0; ii < R; ++ii) {
              const int i = bi * R + ii;
              if (i < ia || i >= ib) continue;
              const float wy = fy ? swy[i] : weight_at(ty_[i], y);
#pragma unroll
              for (int jj = 0; jj < R; ++jj)
                if (bj * R + jj >= ja && bj * R + jj < jb)
                  add(rnd<T>(__fmul_rn(wy, wx[jj])));
            }
          } else {
            for (int i = ia; i < ib; ++i) {
              const float wy = weight_at(ty_[i], y);
              for (int j = ja; j < jb; ++j)
                add(rnd<T>(__fmul_rn(wy, weight_at(tx_[j], x))));
            }
          }
        }
      }
    }
    __syncthreads();
  }
  if (live && slot < 0) {
    TO* out = dtable + ((size_t)b[0] + (size_t)y * w + x) * C + c0;
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (c0 + k * GROUPS * V < C)
        store_vec<TO, V>(out + k * GROUPS * V, acc[k]);
  } else if (live) {
    float* out = ws + ((size_t)slot * TILE * TILE + cell) * C + c0;
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (c0 + k * GROUPS * V < C)
        store_vec<float, V>(out + k * GROUPS * V, acc[k]);
  }
}

// 7. A block per partial slot that holds a long list's first chunk: the
// list's chunks' f32 sums added in chunk order (the first, plus the
// second, ...), stored once in the table's dtype.
template <typename TO>
__global__ void __launch_bounds__(256)
    roi_bwd_reduce(const int* __restrict__ blocks, int nb,
                   const int* __restrict__ len, const int* __restrict__ plan,
                   const int2* __restrict__ work,
                   const float* __restrict__ ws, int C,
                   TO* __restrict__ dtable) {
  const int s = blockIdx.x;
  if (s >= plan[1] || work[s].y != 0) return;
  const int t = work[s].x, q = plan[0];
  const int n = (len[t] + q - 1) / q;
  const int* b = blocks + tile_block(blocks, nb, t) * BLOCK_COLS;
  const int h = b[1], w = b[2], local = t - b[3];
  const int y0 = local / b[4] * TILE, x0 = local % b[4] * TILE;
  const size_t step = (size_t)TILE * TILE * C;
  for (int e = threadIdx.x; e < TILE * TILE * C; e += blockDim.x) {
    const int cell = e / C, y = y0 + cell / TILE, x = x0 + cell % TILE;
    if (y >= h || x >= w) continue;
    const float* p = ws + s * step + e;
    float acc[1] = {p[0]};
    for (int j = 1; j < n; ++j) acc[0] = __fadd_rn(acc[0], p[j * step]);
    store_vec<TO, 1>(dtable + ((size_t)b[0] + (size_t)y * w + x) * C +
                         e % C,
                     acc);
  }
}

template <typename T, typename TO, int V>
static cudaError_t launch_bwd(const void* grad, int C, const float* rois,
                              const int* geom, const float* scale,
                              const int* blocks, int nb, int n_tiles,
                              int n_bands, int n_cols, int SH, int SW,
                              Taps* taps, int* spans, int4* rects, int* blk,
                              unsigned* masks, int* len, int* part,
                              int* base, int* plan, int* slot_of, int2* work,
                              float* ws, int parts,
                              void* dtable, int N, int o, int r,
                              cudaStream_t s) {
  const size_t smem = (size_t)2 * o * r * sizeof(Taps) +
                      (size_t)(SH + SW) * sizeof(int);
  cudaError_t e = set_smem(roi_bwd_taps, smem);
  if (e != cudaSuccess) return e;
  roi_bwd_taps<<<N, 128, smem, s>>>(rois, geom, scale, blocks, nb, o, r, SH,
                                     SW, taps, spans, rects, blk);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  const int words = (N + 31) / 32;
  const long items = (long)(n_bands + n_cols) * words;
  roi_bwd_masks<<<(unsigned)((items + 255) / 256), 256, 0, s>>>(
      blocks, nb, rects, blk, N, words, n_bands, n_cols, masks);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  const int ranges = (n_tiles + RANGE - 1) / RANGE;
  roi_bwd_lengths<<<ranges, RANGE_WARPS * 32, 0, s>>>(
      blocks, nb, masks, words, n_bands, n_tiles, len, part);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  roi_bwd_plan<<<1, 1024, 0, s>>>(part, ranges, parts, plan, base);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  roi_bwd_chunks<<<ranges, RANGE, 0, s>>>(len, n_tiles, plan, base, slot_of,
                                          work);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  constexpr int K = GATHER_K;
  const int slices = (C + K * GROUPS * V - 1) / (K * GROUPS * V);
  const auto gather = r == 2 ? roi_bwd_gather<T, TO, V, K, 2>
                             : roi_bwd_gather<T, TO, V, K, 0>;
  // the list; past 48 KB with the static spans, an opt-in to its size
  const size_t lsmem = (size_t)words * 32 * sizeof(int);
  if (lsmem + GATHER_STATIC > 48 * 1024 &&
      (e = cudaFuncSetAttribute(gather,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)lsmem)) != cudaSuccess)
    return e;
  gather<<<dim3(n_tiles + parts, slices), GATHER_THREADS, lsmem, s>>>(
      (const T*)grad, C, blocks, nb, taps, spans, masks, words, n_bands,
      n_tiles, plan, slot_of, work, ws, (TO*)dtable, o, r, SH, SW);
  if ((e = cudaGetLastError()) != cudaSuccess || parts == 0) return e;
  roi_bwd_reduce<TO><<<parts, 256, 0, s>>>(blocks, nb, len, plan, work, ws,
                                           C, (TO*)dtable);
  return cudaGetLastError();
}
// -- the forward: each block's taps staged in shared memory -----------------

constexpr int FG = 4;            // threads an output element (channel groups)
constexpr int FWD_THREADS = 256; // most threads a staged block

// The distinct table rows (columns) that n samples' taps read, in rising
// order, into vals[0 .. *count), and each sample's lo and hi tap as an
// index into them (rk).  Along an axis lo and hi rise with the sample and
// hi is lo or lo + 1, so the events lo_0, hi_0, lo_1, hi_1, ... meet each
// new value in rising order: a value's index is the number of new values
// met before it, less one where it was met already, less one more where
// lo_j was met already and hi_{j-1} lies above it.  One warp.
__device__ __forceinline__ void rank_taps(const Taps* __restrict__ t, int n,
                                          int2* __restrict__ rk,
                                          int* __restrict__ vals,
                                          int* __restrict__ count) {
  const int lane = threadIdx.x & 31;
  int seen = 0;
  for (int base = 0; base < 2 * n; base += 32) {
    const int k = base + lane, j = k >> 1;
    const bool in = k < 2 * n;
    bool fresh = false, above = false;
    int v = 0;
    if (in) {
      const Taps c = t[j];
      if (k & 1) {
        v = c.hi;
        fresh = c.hi != c.lo && (j == 0 || c.hi != t[j - 1].hi);
      } else {
        v = c.lo;
        fresh = j == 0 || (c.lo != t[j - 1].lo && c.lo != t[j - 1].hi);
        above = j > 0 && !fresh && t[j - 1].hi > c.lo;
      }
    }
    const unsigned b = __ballot_sync(~0u, fresh);
    const int rank = seen + __popc(b & ((1u << lane) - 1)) - !fresh - above;
    if (in) {
      if (k & 1) rk[j].y = rank;
      else rk[j].x = rank;
    }
    if (fresh) vals[rank] = v;
    seen += __popc(b);
  }
  if (lane == 0) *count = seen;
}

// A staged block's shared memory (16-byte units first): the ROI's column
// taps [o r], its band's row taps [band r], each of the band's samples'
// four weights [band r][o r] (rounded to the dtype), the staged cells of
// a slice [2 band r][2 o r][FG] of 16 bytes, then the samples' tap
// indices into the distinct columns and rows [o r], [band r], those
// columns and rows [2 o r], [2 band r], and their two counts.
struct FwdSmem {
  Taps* xt;
  Taps* yt;
  float4* wq;
  uint4* cells;
  int2* xr;
  int2* yr;
  int* colv;
  int* rowv;
  int* counts;
};

static __host__ __device__ size_t fwd_smem(int o, int r, int band) {
  const size_t os = (size_t)o * r, bs = (size_t)band * r;
  return (os + bs) * sizeof(Taps) + bs * os * sizeof(float4) +
         4 * bs * os * FG * sizeof(uint4) +
         (os + bs) * sizeof(int2) + 2 * (os + bs) * sizeof(int) +
         2 * sizeof(int);
}

__device__ __forceinline__ FwdSmem fwd_carve(unsigned char* smem, int o,
                                             int r, int band) {
  const int os = o * r, bs = band * r;
  FwdSmem m;
  m.xt = reinterpret_cast<Taps*>(smem);
  m.yt = m.xt + os;
  m.wq = reinterpret_cast<float4*>(m.yt + bs);
  m.cells = reinterpret_cast<uint4*>(m.wq + bs * os);
  m.xr = reinterpret_cast<int2*>(m.cells + 4 * bs * os * FG);
  m.yr = m.xr + os;
  m.colv = reinterpret_cast<int*>(m.yr + bs);
  m.rowv = m.colv + 2 * os;
  m.counts = m.rowv + 2 * bs;
  return m;
}

// The four corners of a sample in the table's dtype, in the order lo-lo,
// lo-hi, hi-lo, hi-hi, each product and sum rounded to the dtype, added
// to the f32 sums acc (8 bf16 channels: bf16x2 products and sums, each the
// f32 operation rounded once: the f32 product of two bf16 values is exact,
// and an f32 sum rounded to bf16 is the bf16 sum, 24 >= 2 x 8 + 2 bits).
__device__ __forceinline__ void add_sample(const uint4& a, const uint4& b,
                                           const uint4& c, const uint4& d,
                                           const float4& q,
                                           float (&acc)[8]) {
  const __nv_bfloat162 qa = __float2bfloat162_rn(q.x);
  const __nv_bfloat162 qb = __float2bfloat162_rn(q.y);
  const __nv_bfloat162 qc = __float2bfloat162_rn(q.z);
  const __nv_bfloat162 qd = __float2bfloat162_rn(q.w);
  const __nv_bfloat162* A = reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162* B = reinterpret_cast<const __nv_bfloat162*>(&b);
  const __nv_bfloat162* Cc = reinterpret_cast<const __nv_bfloat162*>(&c);
  const __nv_bfloat162* D = reinterpret_cast<const __nv_bfloat162*>(&d);
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    __nv_bfloat162 t = __hadd2_rn(__hmul2_rn(A[p], qa), __hmul2_rn(B[p], qb));
    t = __hadd2_rn(t, __hmul2_rn(Cc[p], qc));
    t = __hadd2_rn(t, __hmul2_rn(D[p], qd));
    const float2 f = __bfloat1622float2(t);
    acc[2 * p] = __fadd_rn(acc[2 * p], f.x);
    acc[2 * p + 1] = __fadd_rn(acc[2 * p + 1], f.y);
  }
}
// 4 f32 channels: the same operations in f32 (no rounding between them).
__device__ __forceinline__ void add_sample(const uint4& a, const uint4& b,
                                           const uint4& c, const uint4& d,
                                           const float4& q,
                                           float (&acc)[4]) {
  const float* A = reinterpret_cast<const float*>(&a);
  const float* B = reinterpret_cast<const float*>(&b);
  const float* Cc = reinterpret_cast<const float*>(&c);
  const float* D = reinterpret_cast<const float*>(&d);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    float t = __fadd_rn(__fmul_rn(A[k], q.x), __fmul_rn(B[k], q.y));
    t = __fadd_rn(t, __fmul_rn(Cc[k], q.z));
    t = __fadd_rn(t, __fmul_rn(D[k], q.w));
    acc[k] = __fadd_rn(acc[k], t);
  }
}

// A block per (ROI, band of `band` output rows), a ROI's bands one after
// another (their rows and the ROI's columns meet in the L2): its column
// and row taps, the distinct table columns and rows they read, and its
// samples' weights go to shared memory once; then, slice by slice of FG x
// V channels (64 bytes), the cells (rows x columns x the slice) are
// copied in once with cp.async, 16 bytes a copy, and a thread per (output
// row, output column, group of V channels) adds its r x r samples from
// shared memory, 16-byte reads.
// R: the sampling ratio where it is 2, else 0 (read from r).
template <typename T, int R>
__global__ void __launch_bounds__(FWD_THREADS)
    roi_align_fwd_staged(const T* __restrict__ table, int C,
                         const float* __restrict__ rois,
                         const int* __restrict__ geom,
                         const float* __restrict__ scale,
                         const uint8_t* __restrict__ valid,
                         const int* __restrict__ order, T* __restrict__ out,
                         int o, int r_, int band) {
  constexpr int V = 16 / sizeof(T);
  const int r = R ? R : r_;
  extern __shared__ __align__(16) unsigned char smem[];
  const FwdSmem m = fwd_carve(smem, o, r, band);
  const int bands = (o + band - 1) / band;
  const int n = order ? order[blockIdx.x / bands] : blockIdx.x / bands;
  const int py0 = blockIdx.x % bands * band;
  const int rows = min(band, o - py0);
  const int os = o * r, bs = rows * r;
  const int grp = threadIdx.x % FG;
  const int px = threadIdx.x / FG % o, pyl = threadIdx.x / (FG * o);
  const int slices = (C + FG * V - 1) / (FG * V);
  const bool mine = pyl < rows;
  T* dst = out + (((size_t)n * o + py0 + pyl) * o + px) * C + grp * V;
  if (valid && !valid[n]) {
    for (int sl = 0; mine && sl < slices; ++sl)
      if (sl * FG * V + grp * V < C)
        *reinterpret_cast<uint4*>(dst + sl * FG * V) = make_uint4(0, 0, 0, 0);
    return;
  }
  {
    const float s = scale[n];
    const float x0 = __fmul_rn(rois[4 * n + 0], s);
    const float y0 = __fmul_rn(rois[4 * n + 1], s);
    const float x1 = __fmul_rn(rois[4 * n + 2], s);
    const float y1 = __fmul_rn(rois[4 * n + 3], s);
    const float bin_x = __fdiv_rn(fmaxf(__fsub_rn(x1, x0), 1.f), (float)o);
    const float bin_y = __fdiv_rn(fmaxf(__fsub_rn(y1, y0), 1.f), (float)o);
    const int h = geom[4 * n + 1], w = geom[4 * n + 2],
              pad = geom[4 * n + 3];
    for (int i = threadIdx.x; i < os + bs; i += blockDim.x) {
      if (i < os)
        m.xt[i] = axis_taps(sample_pos(x0, bin_x, i, r), w, pad);
      else
        m.yt[i - os] =
            axis_taps(sample_pos(y0, bin_y, py0 * r + i - os, r), h, pad);
    }
  }
  __syncthreads();
  const int warp = threadIdx.x / 32;
  if (warp == 0) rank_taps(m.xt, os, m.xr, m.colv, m.counts);
  else if (warp == 1) rank_taps(m.yt, bs, m.yr, m.rowv, m.counts + 1);
  for (int i = threadIdx.x; i < bs * os; i += blockDim.x) {
    const Taps ty = m.yt[i / os], tx = m.xt[i % os];
    m.wq[i] = make_float4(rnd<T>(__fmul_rn(ty.w_lo, tx.w_lo)),
                          rnd<T>(__fmul_rn(ty.w_lo, tx.w_hi)),
                          rnd<T>(__fmul_rn(ty.w_hi, tx.w_lo)),
                          rnd<T>(__fmul_rn(ty.w_hi, tx.w_hi)));
  }
  __syncthreads();
  const int ncols = m.counts[0], nrows = m.counts[1];
  const int row_units = ncols * FG;  // 16-byte units a staged row
  const size_t base = (size_t)geom[4 * n];
  const size_t row_step = (size_t)geom[4 * n + 2] * C;
  const int count_i = r * r;
  const float count = (float)count_i, inv = 1.f / count;
  const bool pow2 = (count_i & (count_i - 1)) == 0;
  for (int sl = 0; sl < slices; ++sl) {
    // the slice's cells: a thread takes (column, 16 bytes) pairs of a row
    // and walks down the rows, no division
    for (int it = threadIdx.x; it < row_units; it += blockDim.x) {
      const int c = (sl * FG + it % FG) * V;
      if (c >= C) continue;
      const T* src = table + (base + m.colv[it / FG]) * C + c;
      for (int ri = 0; ri < nrows; ++ri)
        cp_async16(m.cells + ri * row_units + it,
                   src + m.rowv[ri] * row_step);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    const int c0 = (sl * FG + grp) * V;
    if (mine && c0 < C) {
      float acc[V];
#pragma unroll
      for (int k = 0; k < V; ++k) acc[k] = 0.f;
#pragma unroll
      for (int sy = 0; sy < r; ++sy) {
        const int iy = pyl * r + sy;
        const int2 ry = m.yr[iy];
        const uint4* lo = m.cells + ry.x * row_units + grp;
        const uint4* hi = m.cells + ry.y * row_units + grp;
#pragma unroll
        for (int sx = 0; sx < r; ++sx) {
          const int jx = px * r + sx;
          const int2 rx = m.xr[jx];
          add_sample(lo[rx.x * FG], lo[rx.y * FG], hi[rx.x * FG],
                     hi[rx.y * FG], m.wq[iy * os + jx], acc);
        }
      }
#pragma unroll
      for (int k = 0; k < V; ++k)
        acc[k] = pow2 ? __fmul_rn(acc[k], inv) : __fdiv_rn(acc[k], count);
      store_vec<T, V>(dst + sl * FG * V, acc);
    }
    __syncthreads();
  }
}

// The order the staged forward takes the ROIs in: by the table row under
// each one's centre (its image and level, then raster order), so that
// ROIs that overlap run close together and their cells meet in the L2.
// One block sorts (key << 20 | ROI) bitonically, N <= FWD_SORT_MAX, for
// sites of at least FWD_SORT_MIN output pixels (the sort takes ~12 us).
constexpr int FWD_SORT_MAX = 4096;
constexpr long FWD_SORT_MIN = 1 << 20;
__global__ void __launch_bounds__(1024)
    roi_fwd_order(const float* __restrict__ rois,
                  const int* __restrict__ geom,
                  const float* __restrict__ scale, int N,
                  int* __restrict__ order) {
  __shared__ long long key[FWD_SORT_MAX];
  int p = 1;
  while (p < N) p <<= 1;
  for (int i = threadIdx.x; i < p; i += blockDim.x) {
    if (i >= N) {
      key[i] = LLONG_MAX;
      continue;
    }
    const float sc = scale[i];
    const int h = geom[4 * i + 1], w = geom[4 * i + 2], pad = geom[4 * i + 3];
    const float xc = (rois[4 * i] + rois[4 * i + 2]) * 0.5f * sc - pad;
    const float yc = (rois[4 * i + 1] + rois[4 * i + 3]) * 0.5f * sc - pad;
    const int x = min(max((int)xc, 0), w - 1), y = min(max((int)yc, 0), h - 1);
    key[i] = ((long long)geom[4 * i] + (long long)y * w + x) << 20 | i;
  }
  __syncthreads();
  for (int k = 2; k <= p; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < p; i += blockDim.x) {
        const int l = i ^ j;
        if (l > i && (key[i] > key[l]) == ((i & k) == 0)) {
          const long long t = key[i];
          key[i] = key[l];
          key[l] = t;
        }
      }
      __syncthreads();
    }
  }
  for (int i = threadIdx.x; i < N; i += blockDim.x)
    order[i] = (int)(key[i] & 0xfffff);
}

// The staged forward's output rows a block: enough that a block has about
// 128 threads, all of them when o is past 32.
static int fwd_band(int o) { return max(1, min(o, 128 / (o * FG))); }

template <typename T>
static cudaError_t launch_fwd_staged(const void* table, int C,
                                     const float* rois, const int* geom,
                                     const float* scale,
                                     const uint8_t* valid, int* order,
                                     void* out, int N, int o, int r,
                                     cudaStream_t s) {
  constexpr int V = 16 / sizeof(T);
  const int band = fwd_band(o);
  const int threads = max(64, (band * o * FG + 31) / 32 * 32);
  const size_t smem = fwd_smem(o, r, band);
  const dim3 grid(N * ((o + band - 1) / band));
  const auto kernel =
      r == 2 ? roi_align_fwd_staged<T, 2> : roi_align_fwd_staged<T, 0>;
  cudaError_t e = set_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  if (N > FWD_SORT_MAX || (long)N * o * o < FWD_SORT_MIN) {
    order = nullptr;
  } else {
    roi_fwd_order<<<1, 1024, 0, s>>>(rois, geom, scale, N, order);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
  }
  kernel<<<grid, threads, smem, s>>>((const T*)table, C, rois, geom, scale,
                                     valid, order, (T*)out, o, r, band);
  return cudaGetLastError();
}

static int threads_for(int C, int o, int V) {
  return min(MAX_THREADS, max(32, (C / V * o + 31) / 32 * 32));
}

// Launch one of a kernel's two forms, ``k4`` (4 channels a thread) where
// the channels and pointers allow 16-byte (f32) or 8-byte (bf16)
// accesses, else ``k1`` (one).
template <typename K, typename... A>
static cudaError_t launch(K k1, K k4, bool vec, int C, int N, int o, int r,
                          cudaStream_t s, A... args) {
  const dim3 grid(N, (o + BAND - 1) / BAND);
  const size_t smem = smem_for(o, r);
  const K kernel = vec ? k4 : k1;
  const cudaError_t e = set_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  kernel<<<grid, threads_for(C, o, vec ? 4 : 1), smem, s>>>(args...);
  return cudaGetLastError();
}

static bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

}  // namespace roi

// order: [N] int32 scratch (the staged forward's ROI order)
SIAMMOT_API int siammot_roi_align(const void* table, int dtype, int C,
                                  const float* rois, const int* geom,
                                  const float* scale, const uint8_t* valid,
                                  int* order, void* out, int N, int o, int r,
                                  void* stream) {
  if (N == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (C % (dtype == 1 ? 8 : 4) == 0 && roi::aligned(table, 16) &&
      roi::aligned(out, 16) && o * roi::FG <= roi::FWD_THREADS &&
      roi::fwd_smem(o, r, roi::fwd_band(o)) <= roi::SMEM_OPT_IN)
    return dtype == 1 ? roi::launch_fwd_staged<__nv_bfloat16>(
                            table, C, rois, geom, scale, valid, order, out, N,
                            o, r, s)
                      : roi::launch_fwd_staged<float>(table, C, rois, geom,
                                                      scale, valid, order,
                                                      out, N, o, r, s);
  const int vb = dtype == 1 ? 8 : 16;
  const bool vec = C % 4 == 0 && roi::aligned(table, vb) &&
                   roi::aligned(out, vb);
  if (dtype == 1)
    return roi::launch(roi::roi_align_fwd<__nv_bfloat16, 1>,
                       roi::roi_align_fwd<__nv_bfloat16, 4>, vec, C, N, o, r,
                       s, (const __nv_bfloat16*)table, C, rois, geom, scale,
                       valid, (__nv_bfloat16*)out, o, r);
  return roi::launch(roi::roi_align_fwd<float, 1>,
                     roi::roi_align_fwd<float, 4>, vec, C, N, o, r, s,
                     (const float*)table, C, rois, geom, scale, valid,
                     (float*)out, o, r);
}

// The table gradient in the table's dtype (out_dtype: 0 f32, 1 bf16; a
// bf16 gradient may also write f32, the sums before their rounding).
// blocks [nb][7]: the layout (ops/roi_align.py:bwd_plan); SH, SW the
// largest height and width of a block a ROI names; the workspace: taps
// [N][2][o * r] (16 bytes each), spans [N][SH + SW], rects [N][4], blk
// [N], masks [bands + columns][ceil(N / 32)], len and slot_of [tiles],
// part [ranges][12] and base [ranges] (ranges of 32 tiles), plan [2],
// work [parts][2], ws [parts][TILE * TILE][C] f32 (a long list's chunks'
// partial sums; parts may be 0: no list is cut).
SIAMMOT_API int siammot_roi_align_bwd(
    const void* grad, int dtype, int out_dtype, int C, const float* rois,
    const int* geom, const float* scale, const int* blocks, int nb,
    int n_tiles, int n_bands, int n_cols, int SH, int SW, void* taps,
    int* spans, int* rects, int* blk, unsigned* masks, int* len, int* part,
    int* base, int* plan, int* slot_of, int* work, float* ws, int parts,
    void* dtable, int N,
    int o, int r, void* stream) {
  if (N == 0 || n_tiles == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  roi::Taps* tp = (roi::Taps*)taps;
  int4* rc = (int4*)rects;
  const bool vec = C % (dtype == 1 ? 8 : 4) == 0 &&
                   roi::aligned(grad, 16) && roi::aligned(dtable, 16);
#define ROI_BWD(T, TO, V)                                                   \
  roi::launch_bwd<T, TO, V>(grad, C, rois, geom, scale, blocks, nb,         \
                            n_tiles, n_bands, n_cols, SH, SW, tp, spans, rc, \
                            blk, masks, len, part, base, plan, slot_of,     \
                            (int2*)work, ws, parts, dtable, N, o, r, s)
  if (dtype == 1 && out_dtype == 1)
    return vec ? ROI_BWD(__nv_bfloat16, __nv_bfloat16, 8)
               : ROI_BWD(__nv_bfloat16, __nv_bfloat16, 1);
  if (dtype == 1)
    return vec ? ROI_BWD(__nv_bfloat16, float, 8)
               : ROI_BWD(__nv_bfloat16, float, 1);
  return vec ? ROI_BWD(float, float, 4) : ROI_BWD(float, float, 1);
#undef ROI_BWD
}
