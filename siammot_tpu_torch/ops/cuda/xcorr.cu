// Depthwise cross-correlation and its gradient: the CUDA counterparts of
// the Pallas kernel siammot_tpu/ops/pallas/xcorr.py:xcorr_depthwise_pallas
// with ``valid`` (_xcorr_kernel_masked, inference), without it
// (_xcorr_kernel, training), and of the two calls its custom VJP makes
// (siammot_tpu/ops/xcorr.py:_xcorr_bwd).
//
// xcorr:     out[k, oy, ox, c] = sum_i sum_j s[k, oy + i, ox + j, c]
//                                            * t[k, i, j, c]   (f32, i-major)
// conv_full: out[k, y, x, c]   = sum_i sum_j g[k, y - i, x - j, c]
//                                            * t[k, i, j, c]
//            over the taps that lie inside g: the gradient of xcorr with
//            respect to its search input.  JAX writes it as the xcorr of g
//            zero-padded by (ht - 1, wt - 1) with the flipped template; the
//            pad is never built here, and each output row visits only the
//            template rows whose g row exists (16 of 30 rows per tap at the
//            training shapes, where the padded form would stage a 44x44 map,
//            276 KB per 32 channels, over the 227 KB a block may use).
//
// Bound on the H100: operations on the CUDA cores (depthwise, so no
// tensor-core form): Ho*Wo*Ht*Wt multiply-adds per channel against a few
// hundred kilobytes per slot.  Simple design: one block per (slot, tile of
// 32 channels); both inputs are staged once in shared memory as f32, each
// thread owns one channel of one output row and keeps that row's
// accumulators in registers.  A warp spans the 32 channels of a tile, so
// shared-memory reads are conflict-free and output writes coalesced.  The
// two inputs may differ in dtype (the backward correlates the bf16 search
// with the f32 upstream gradient).  Masked: dead slots write zeros.
//
// Large outputs (a 61x61 response from a 75x75 search region, as
// SEARCH_REGION 5 gives): the whole search map no longer fits a block
// (75 x 75 x 32 f32 is 720 KB), so xcorr_band_kernel takes a band of
// BAND output rows per block and, for each template row i, stages only
// the BAND search rows that row meets; the sums run in the same (i, j)
// order, up to 64 accumulators a thread.
#include "common.cuh"

constexpr int CT = 32;      // channels per block
constexpr int WO_MAX = 32;  // accumulators per thread (output width)
constexpr int BAND = 8;     // output rows per block, banded form
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

// valid may be null: every slot is live
template <typename TS, typename TT>
__global__ void xcorr_kernel(const TS* __restrict__ search,
                             const TT* __restrict__ tmpl,
                             const uint8_t* __restrict__ valid,
                             float* __restrict__ out, int hs, int ws, int ht,
                             int wt, int C) {
  const int k = blockIdx.x;
  const int c0 = blockIdx.y * CT;
  const int ho = hs - ht + 1, wo = ws - wt + 1;
  const int c = threadIdx.x % CT;
  const int oy = threadIdx.x / CT;
  const bool has_c = c0 + c < C;
  float* out_row = out + (((size_t)k * ho + oy) * wo) * C + c0 + c;
  if (valid != nullptr && !valid[k]) {
    if (has_c)
      for (int ox = 0; ox < wo; ++ox) out_row[(size_t)ox * C] = 0.f;
    return;
  }
  extern __shared__ float smem[];
  float* s_s = smem;                  // [hs * ws][CT]
  float* t_s = smem + hs * ws * CT;   // [ht * wt][CT]
  stage(search + (size_t)k * hs * ws * C, tmpl + (size_t)k * ht * wt * C,
        s_s, t_s, hs * ws, ht * wt, C, c0);
  __syncthreads();
  float acc[WO_MAX];
#pragma unroll
  for (int ox = 0; ox < WO_MAX; ++ox) acc[ox] = 0.f;
  for (int i = 0; i < ht; ++i) {
    for (int j = 0; j < wt; ++j) {
      const float t = t_s[(i * wt + j) * CT + c];
      const float* srow = s_s + ((oy + i) * ws + j) * CT + c;
#pragma unroll
      for (int ox = 0; ox < WO_MAX; ++ox)
        if (ox < wo) acc[ox] += srow[ox * CT] * t;
    }
  }
  if (has_c) {
#pragma unroll
    for (int ox = 0; ox < WO_MAX; ++ox)
      if (ox < wo) out_row[(size_t)ox * C] = acc[ox];
  }
}

// banded form: block (slot, channel tile, band of BAND output rows)
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
        if (ox < wo) acc[ox] += srow[ox * CT] * t;
    }
  }
  if (has_c && has_row) {
#pragma unroll
    for (int ox = 0; ox < WO_BAND_MAX; ++ox)
      if (ox < wo) out_row[(size_t)ox * C] = acc[ox];
  }
}

template <typename TG, typename TT>
__global__ void __launch_bounds__(1024)
    conv_full_kernel(const TG* __restrict__ grad, const TT* __restrict__ tmpl,
                     float* __restrict__ out, int hg, int wg, int ht, int wt,
                     int C) {
  const int k = blockIdx.x;
  const int c0 = blockIdx.y * CT;
  const int ho = hg + ht - 1, wo = wg + wt - 1;
  const int c = threadIdx.x % CT;
  const int y = threadIdx.x / CT;
  extern __shared__ float smem[];
  float* g_s = smem;                  // [hg * wg][CT]
  float* t_s = smem + hg * wg * CT;   // [ht * wt][CT]
  stage(grad + (size_t)k * hg * wg * C, tmpl + (size_t)k * ht * wt * C, g_s,
        t_s, hg * wg, ht * wt, C, c0);
  __syncthreads();
  float acc[WO_MAX];
#pragma unroll
  for (int x = 0; x < WO_MAX; ++x) acc[x] = 0.f;
  // template rows i whose g row y - i exists
  const int i_lo = max(0, y - hg + 1), i_hi = min(ht - 1, y);
  for (int i = i_lo; i <= i_hi; ++i) {
    const float* grow = g_s + (y - i) * wg * CT + c;
    for (int j = 0; j < wt; ++j) {
      const float t = t_s[(i * wt + j) * CT + c];
#pragma unroll
      for (int x = 0; x < WO_MAX; ++x) {
        const int gx = x - j;
        if (x < wo && gx >= 0 && gx < wg) acc[x] += grow[gx * CT] * t;
      }
    }
  }
  if (c0 + c < C) {
    float* out_row = out + (((size_t)k * ho + y) * wo) * C + c0 + c;
#pragma unroll
    for (int x = 0; x < WO_MAX; ++x)
      if (x < wo) out_row[(size_t)x * C] = acc[x];
  }
}

template <typename TS, typename TT>
static int launch_xcorr(const void* search, const void* tmpl,
                        const uint8_t* valid, float* out, int K, int hs,
                        int ws, int ht, int wt, int C, cudaStream_t stream) {
  const int ho = hs - ht + 1, wo = ws - wt + 1;
  if (ho < 1 || wo < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(hs * ws + ht * wt) * CT * sizeof(float);
  if (ho * CT > 1024 || wo > WO_MAX || smem > 200 * 1024) {
    // large outputs: the banded form
    if (wo > WO_BAND_MAX) return (int)cudaErrorInvalidValue;
    const size_t bsmem = (size_t)(BAND * ws + wt) * CT * sizeof(float);
    cudaError_t err = set_smem(xcorr_band_kernel<TS, TT>, bsmem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid(K, (C + CT - 1) / CT, (ho + BAND - 1) / BAND);
    xcorr_band_kernel<TS, TT><<<grid, BAND * CT, bsmem, stream>>>(
        (const TS*)search, (const TT*)tmpl, valid, out, hs, ws, ht, wt, C);
    return (int)cudaGetLastError();
  }
  cudaError_t err = set_smem(xcorr_kernel<TS, TT>, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(K, (C + CT - 1) / CT);
  xcorr_kernel<TS, TT><<<grid, ho * CT, smem, stream>>>(
      (const TS*)search, (const TT*)tmpl, valid, out, hs, ws, ht, wt, C);
  return (int)cudaGetLastError();
}

template <typename TG, typename TT>
static int launch_full(const void* grad, const void* tmpl, float* out, int K,
                       int hg, int wg, int ht, int wt, int C,
                       cudaStream_t stream) {
  const int ho = hg + ht - 1, wo = wg + wt - 1;
  if (hg < 1 || wg < 1 || ho * CT > 1024 || wo > WO_MAX)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(hg * wg + ht * wt) * CT * sizeof(float);
  cudaError_t err = set_smem(conv_full_kernel<TG, TT>, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(K, (C + CT - 1) / CT);
  conv_full_kernel<TG, TT><<<grid, ho * CT, smem, stream>>>(
      (const TG*)grad, (const TT*)tmpl, out, hg, wg, ht, wt, C);
  return (int)cudaGetLastError();
}

// dtype codes: 0 = float32, 1 = bfloat16, one per input
#define SIAMMOT_DISPATCH2(d0, d1, FN, ...)                              \
  ((d0) == 1 ? ((d1) == 1 ? FN<__nv_bfloat16, __nv_bfloat16>(__VA_ARGS__) \
                          : FN<__nv_bfloat16, float>(__VA_ARGS__))        \
             : ((d1) == 1 ? FN<float, __nv_bfloat16>(__VA_ARGS__)         \
                          : FN<float, float>(__VA_ARGS__)))

SIAMMOT_API int siammot_xcorr_masked(const void* search, const void* tmpl,
                                     int dtype, const uint8_t* valid,
                                     float* out, int K, int hs, int ws,
                                     int ht, int wt, int C, void* stream) {
  if (K == 0) return 0;
  return SIAMMOT_DISPATCH2(dtype, dtype, launch_xcorr, search, tmpl, valid,
                           out, K, hs, ws, ht, wt, C, (cudaStream_t)stream);
}

// Unmasked xcorr: the training forward and the template gradient
// (xcorr of the search with the upstream gradient).
SIAMMOT_API int siammot_xcorr(const void* search, int search_dtype,
                              const void* tmpl, int tmpl_dtype, float* out,
                              int K, int hs, int ws, int ht, int wt, int C,
                              void* stream) {
  if (K == 0) return 0;
  return SIAMMOT_DISPATCH2(search_dtype, tmpl_dtype, launch_xcorr, search,
                           tmpl, nullptr, out, K, hs, ws, ht, wt, C,
                           (cudaStream_t)stream);
}

// Search gradient: the full convolution of the upstream gradient with the
// template, [K, hg + ht - 1, wg + wt - 1, C] f32.
SIAMMOT_API int siammot_xcorr_grad_search(const void* grad, int grad_dtype,
                                          const void* tmpl, int tmpl_dtype,
                                          float* out, int K, int hg, int wg,
                                          int ht, int wt, int C,
                                          void* stream) {
  if (K == 0) return 0;
  return SIAMMOT_DISPATCH2(grad_dtype, tmpl_dtype, launch_full, grad, tmpl,
                           out, K, hg, wg, ht, wt, C, (cudaStream_t)stream);
}
