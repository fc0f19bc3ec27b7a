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
// Backward: the gradient in the table only (proposals are data), scattered
// as g / r^2 times each tap's weight (the forward's weight, in the dtype)
// into an f32 table by atomicAdd.  Atomics add in no fixed order, so the
// gradient is not bitwise the same from run to run.
//
// Bound on the H100: bytes, at every site.  An output element takes 4 r^2
// taps and about 8 r^2 operations, but the taps of neighbouring samples
// and ROIs overlap and hit the caches: what must move is the table rows
// under the taps, once, and the output.
//
// Design: one block per (ROI, band of BAND output rows); its threads take
// (channel group, output column) pairs, channels fastest, so a tap's
// C-vector is read by consecutive threads (coalesced) and a narrow channel
// count still fills the block.  A group is 4 channels where C and the
// pointers allow (one 16-byte f32 or 8-byte bf16 access a tap, and in the
// backward Hopper's 16-byte vector atomicAdd), else one.  The block
// computes its ROI's column taps, its band's row taps (index, two weights,
// the pad/inside masks folded into the weights) and every sample's four
// corner weights, rounded to the dtype, once into shared memory; a thread
// then only loads, multiplies and adds.  A dead ROI writes zeros and reads
// nothing.
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

// dtable[i .. i + V) += g[k] * w, one atomic for the V channels (Hopper's
// 16-byte vector atomicAdd for V = 4).
template <int V>
__device__ __forceinline__ void scatter(float* __restrict__ dtable,
                                        size_t i, const float (&g)[V],
                                        float w) {
  if (w == 0.f) return;
  if constexpr (V == 4) {
    atomicAdd(reinterpret_cast<float4*>(dtable + i),
              make_float4(__fmul_rn(g[0], w), __fmul_rn(g[1], w),
                          __fmul_rn(g[2], w), __fmul_rn(g[3], w)));
  } else {
    atomicAdd(dtable + i, __fmul_rn(g[0], w));
  }
}

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

template <typename T, int V>
__global__ void __launch_bounds__(MAX_THREADS)
    roi_align_bwd(const T* __restrict__ grad, int C,
                  const float* __restrict__ rois,
                  const int* __restrict__ geom,
                  const float* __restrict__ scale,
                  float* __restrict__ dtable, int o, int r) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Smem m = carve(smem, o, r);
  const int n = blockIdx.x;
  const int py0 = blockIdx.y * BAND;
  const int rows = min(BAND, o - py0);
  block_taps<T>(rois, geom, scale, n, o, r, py0, rows, m.xt, m.yt, m.wq);
  const size_t base = (size_t)geom[4 * n];
  const int w = geom[4 * n + 2];
  const float count = (float)(r * r);
  const size_t g0 = ((size_t)n * o + py0) * o * C;
  const int cv = C / V;
  for (int idx = threadIdx.x; idx < cv * o; idx += blockDim.x) {
    const int c = (idx % cv) * V, px = idx / cv;
    for (int py = 0; py < rows; ++py) {
      float g[V];
      Vec<T, V>::load(grad + g0 + ((size_t)py * o + px) * C + c, g);
      bool any = false;
#pragma unroll
      for (int k = 0; k < V; ++k) {
        g[k] = __fdiv_rn(g[k], count);
        any |= g[k] != 0.f;
      }
      if (!any) continue;
      for (int sy = 0; sy < r; ++sy) {
        const Taps ty = m.yt[py * r + sy];
        const size_t row_lo = base + (size_t)ty.lo * w;
        const size_t row_hi = base + (size_t)ty.hi * w;
        const float4* wrow = m.wq + (size_t)(py * r + sy) * o * r + px * r;
        for (int sx = 0; sx < r; ++sx) {
          const Taps tx = m.xt[px * r + sx];
          const float4 q = wrow[sx];
          scatter<V>(dtable, (row_lo + tx.lo) * C + c, g, q.x);
          scatter<V>(dtable, (row_lo + tx.hi) * C + c, g, q.y);
          scatter<V>(dtable, (row_hi + tx.lo) * C + c, g, q.z);
          scatter<V>(dtable, (row_hi + tx.hi) * C + c, g, q.w);
        }
      }
    }
  }
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

SIAMMOT_API int siammot_roi_align(const void* table, int dtype, int C,
                                  const float* rois, const int* geom,
                                  const float* scale, const uint8_t* valid,
                                  void* out, int N, int o, int r,
                                  void* stream) {
  if (N == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
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

SIAMMOT_API int siammot_roi_align_bwd(const void* grad, int dtype, int C,
                                      const float* rois, const int* geom,
                                      const float* scale, float* dtable,
                                      int N, int o, int r, void* stream) {
  if (N == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const bool vec = C % 4 == 0 && roi::aligned(grad, dtype == 1 ? 8 : 16) &&
                   roi::aligned(dtable, 16);
  if (dtype == 1)
    return roi::launch(roi::roi_align_bwd<__nv_bfloat16, 1>,
                       roi::roi_align_bwd<__nv_bfloat16, 4>, vec, C, N, o, r,
                       s, (const __nv_bfloat16*)grad, C, rois, geom, scale,
                       dtable, o, r);
  return roi::launch(roi::roi_align_bwd<float, 1>,
                     roi::roi_align_bwd<float, 4>, vec, C, N, o, r, s,
                     (const float*)grad, C, rois, geom, scale, dtable, o, r);
}
