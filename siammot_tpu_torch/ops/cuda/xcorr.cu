// Masked depthwise cross-correlation: the CUDA counterpart of the Pallas
// kernel siammot_tpu/ops/pallas/xcorr.py:xcorr_depthwise_pallas with
// ``valid`` (_xcorr_kernel_masked).
//
// out[k, oy, ox, c] = sum_i sum_j search[k, oy + i, ox + j, c]
//                                 * template[k, i, j, c]   (f32, i-major)
//
// Bound on the H100: operations on the CUDA cores (depthwise, so no
// tensor-core form): Ho*Wo*Ht*Wt multiply-adds per channel against a
// few hundred kilobytes per slot.  Simple design: one block per (live
// slot, tile of 32 channels); the search and template tiles are staged
// once in shared memory as f32, each thread owns one channel of one
// output row and keeps that row's accumulators in registers.  A warp
// spans the 32 channels of a tile, so shared-memory reads are
// conflict-free and output writes coalesced.  Dead slots write zeros.
#include "common.cuh"

constexpr int CT = 32;      // channels per block
constexpr int WO_MAX = 32;  // accumulators per thread (output width)

template <typename T>
__global__ void xcorr_masked_kernel(const T* __restrict__ search,
                                    const T* __restrict__ tmpl,
                                    const uint8_t* __restrict__ valid,
                                    float* __restrict__ out, int hs, int ws,
                                    int ht, int wt, int C) {
  const int k = blockIdx.x;
  const int c0 = blockIdx.y * CT;
  const int ho = hs - ht + 1, wo = ws - wt + 1;
  const int c = threadIdx.x % CT;
  const int oy = threadIdx.x / CT;
  const bool has_c = c0 + c < C;
  float* out_row = out + (((size_t)k * ho + oy) * wo) * C + c0 + c;
  if (!valid[k]) {
    if (has_c)
      for (int ox = 0; ox < wo; ++ox) out_row[(size_t)ox * C] = 0.f;
    return;
  }
  extern __shared__ float smem[];
  float* s_s = smem;                  // [hs * ws][CT]
  float* t_s = smem + hs * ws * CT;   // [ht * wt][CT]
  const T* s_g = search + (size_t)k * hs * ws * C;
  const T* t_g = tmpl + (size_t)k * ht * wt * C;
  for (int e = threadIdx.x; e < hs * ws * CT; e += blockDim.x) {
    const int cc = e % CT, p = e / CT;
    s_s[e] = c0 + cc < C ? load_f32(s_g, (size_t)p * C + c0 + cc) : 0.f;
  }
  for (int e = threadIdx.x; e < ht * wt * CT; e += blockDim.x) {
    const int cc = e % CT, p = e / CT;
    t_s[e] = c0 + cc < C ? load_f32(t_g, (size_t)p * C + c0 + cc) : 0.f;
  }
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

template <typename T>
static int launch(const void* search, const void* tmpl, const uint8_t* valid,
                  float* out, int K, int hs, int ws, int ht, int wt, int C,
                  cudaStream_t stream) {
  const int ho = hs - ht + 1, wo = ws - wt + 1;
  if (ho < 1 || wo < 1 || ho * CT > 1024 || wo > WO_MAX)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(hs * ws + ht * wt) * CT * sizeof(float);
  cudaError_t err = set_smem(xcorr_masked_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(K, (C + CT - 1) / CT);
  xcorr_masked_kernel<T><<<grid, ho * CT, smem, stream>>>(
      (const T*)search, (const T*)tmpl, valid, out, hs, ws, ht, wt, C);
  return (int)cudaGetLastError();
}

SIAMMOT_API int siammot_xcorr_masked(const void* search, const void* tmpl,
                                     int dtype, const uint8_t* valid,
                                     float* out, int K, int hs, int ws,
                                     int ht, int wt, int C, void* stream) {
  if (K == 0) return 0;
  if (dtype == 1)
    return launch<__nv_bfloat16>(search, tmpl, valid, out, K, hs, ws, ht, wt,
                                 C, (cudaStream_t)stream);
  return launch<float>(search, tmpl, valid, out, K, hs, ws, ht, wt, C,
                       (cudaStream_t)stream);
}
