// Masked EMM response decode: the CUDA counterpart of the Pallas kernel
// siammot_tpu/ops/pallas/decode.py:emm_decode_pallas with ``valid``, in
// its whole-map form (_decode_kernel through _gated_kernel).
//
// Per live slot, for the 4 channels x4 = (cls logit difference,
// centerness logit, l + r, t + b) of a [s, s] response:
//   up_c = U . x4_c . U^T                  (x16 bicubic, [s_hi, s_hi])
//   conf = sigmoid(up_0) * sigmoid(up_1)   (or sigmoid(up_0) alone)
//   sw = max(up_2 / w, w / up_2)...        (raw IEEE divisions)
//   p = conf * exp((1 - sw * sh) * 0.1) * (1 - sigma) + sigma * hann
// then the first-occurrence (lowest flat index) argmax of p and the cls
// probability there.  Dead slots return (0, 0).
//
// Bound on the H100: operations, and few of them: 4 x 256 x 256 x 16
// multiply-adds for the upsample plus ~30 flops per cell, against 4 KB
// of input per slot.  Simple design: one block per slot, one thread per
// (column q, every other row); U and the row factor
// T_c = U . x4_c ([s_hi, s]) sit in shared memory and the thread's row
// of U^T in registers.  Each thread keeps a running (value, index, cls)
// best, strict ">" so its lower row wins a tie, and a block reduction
// breaks ties toward the lower flat index.  NaN counts
// as the largest value, first NaN wins (jnp.argmax).  Built without
// --use_fast_math: a zero upsampled extent must give inf and exp(-inf)
// must give 0, as on the TPU.
#include "common.cuh"

struct Best {
  float v;
  int idx;
  float cls;
};

__device__ __forceinline__ bool better(const Best& a, const Best& b) {
  const bool an = isnan(a.v), bn = isnan(b.v);
  if (an != bn) return an;
  if (!an && a.v != b.v) return a.v > b.v;
  return a.idx < b.idx;
}

__device__ __forceinline__ float nan_max(float a, float b) {
  return (isnan(a) || isnan(b)) ? a + b : fmaxf(a, b);
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

constexpr int S_MAX = 32;   // largest response side the kernel takes
constexpr int ROW_GROUPS = 2;  // 512 threads: registers for all

__global__ void __launch_bounds__(512) decode_kernel(const float* __restrict__ x4,
                              const float* __restrict__ wh,
                              const float* __restrict__ U,
                              const float* __restrict__ window,
                              const uint8_t* __restrict__ valid,
                              int* __restrict__ idx_out,
                              float* __restrict__ score_out, int s, int s_hi,
                              float sigma, float one_minus_sigma,
                              int use_centerness) {
  const int k = blockIdx.x;
  const int t = threadIdx.x;
  if (!valid[k]) {
    if (t == 0) {
      idx_out[k] = 0;
      score_out[k] = 0.f;
    }
    return;
  }
  extern __shared__ float smem[];
  float* u_s = smem;                 // [s_hi, s]
  float* x_s = u_s + s_hi * s;       // [4, s, s]
  float* t_s = x_s + 4 * s * s;      // [4, s_hi, s]
  __shared__ Best warp_best[32];
  for (int e = t; e < s_hi * s; e += blockDim.x) u_s[e] = U[e];
  for (int e = t; e < 4 * s * s; e += blockDim.x)
    x_s[e] = x4[(size_t)k * 4 * s * s + e];
  __syncthreads();
  // T_c[r, w] = sum_h U[r, h] x4_c[h, w], w fastest across threads
  for (int e = t; e < 4 * s_hi * s; e += blockDim.x) {
    const int w = e % s, r = (e / s) % s_hi, c = e / (s * s_hi);
    float acc = 0.f;
    for (int h = 0; h < s; ++h)
      acc += u_s[r * s + h] * x_s[(c * s + h) * s + w];
    t_s[e] = acc;
  }
  __syncthreads();

  float bw = wh[2 * k], bh = wh[2 * k + 1];
  bw = bw == 0.f ? 1.f : bw;  // zero extents only on dead slots
  bh = bh == 0.f ? 1.f : bh;
  // thread = (row group, column q); the rows of a group ascend, so a
  // strict ">" keeps the lower flat index within a thread
  const int q = t % s_hi;
  const int rg = t / s_hi;
  float uq[S_MAX];
#pragma unroll
  for (int w = 0; w < S_MAX; ++w) uq[w] = w < s ? u_s[q * s + w] : 0.f;
  Best best{-INFINITY, s_hi * s_hi, -INFINITY};
  for (int r = rg; r < s_hi; r += ROW_GROUPS) {
    float up[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float* tr = t_s + (c * s_hi + r) * s;
      float acc = 0.f;
#pragma unroll
      for (int w = 0; w < S_MAX; ++w)
        if (w < s) acc += tr[w] * uq[w];
      up[c] = acc;
    }
    const float cls_prob = sigmoid(up[0]);
    const float conf =
        use_centerness ? __fmul_rn(cls_prob, sigmoid(up[1])) : cls_prob;
    float sw = __fdiv_rn(up[2], bw);
    float sh = __fdiv_rn(up[3], bh);
    sw = nan_max(sw, __fdiv_rn(1.f, sw));
    sh = nan_max(sh, __fdiv_rn(1.f, sh));
    const float pen = expf(__fmul_rn(__fadd_rn(-__fmul_rn(sw, sh), 1.f), 0.1f));
    const float p =
        __fadd_rn(__fmul_rn(__fmul_rn(conf, pen), one_minus_sigma),
                  __fmul_rn(sigma, window[(size_t)r * s_hi + q]));
    const Best cand{p, r * s_hi + q, cls_prob};
    if (better(cand, best)) best = cand;
  }
  // block reduction: warps by shuffle, then the first warp
  for (int off = 16; off > 0; off /= 2) {
    Best o{__shfl_down_sync(0xffffffff, best.v, off),
           __shfl_down_sync(0xffffffff, best.idx, off),
           __shfl_down_sync(0xffffffff, best.cls, off)};
    if (better(o, best)) best = o;
  }
  if (t % 32 == 0) warp_best[t / 32] = best;
  __syncthreads();
  if (t < 32) {
    const int nw = blockDim.x / 32;
    best = t < nw ? warp_best[t] : Best{-INFINITY, s_hi * s_hi, -INFINITY};
    for (int off = 16; off > 0; off /= 2) {
      Best o{__shfl_down_sync(0xffffffff, best.v, off),
             __shfl_down_sync(0xffffffff, best.idx, off),
             __shfl_down_sync(0xffffffff, best.cls, off)};
      if (better(o, best)) best = o;
    }
    if (t == 0) {
      idx_out[k] = best.idx;
      score_out[k] = best.cls;
    }
  }
}

SIAMMOT_API int siammot_emm_decode(const float* x4, const float* wh,
                                   const float* U, const float* window,
                                   const uint8_t* valid, int* idx,
                                   float* score, int K, int s, int s_hi,
                                   float sigma, float one_minus_sigma,
                                   int use_centerness, void* stream) {
  if (K == 0) return 0;
  if (s_hi % 32 || s_hi * ROW_GROUPS > 1024 || s > S_MAX)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(s_hi * s + 4 * s * s + 4 * s_hi * s) * 4;
  cudaError_t err = set_smem(decode_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  decode_kernel<<<K, s_hi * ROW_GROUPS, smem, (cudaStream_t)stream>>>(
      x4, wh, U, window, valid, idx, score, s, s_hi, sigma, one_minus_sigma,
      use_centerness);
  return (int)cudaGetLastError();
}
