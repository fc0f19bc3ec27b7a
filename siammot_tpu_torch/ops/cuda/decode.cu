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
// Bound on the H100: operations, and few of them: 4 x s_hi^2 x s
// multiply-adds for the upsample plus ~30 flops per cell, against 16 s^2
// bytes of input per slot.  Simple design: one block of 512 threads per
// slot; U and the input sit in shared memory, and the row factor
// T_c = U . x4_c ([s_hi, s]) is built there in chunks of rows that fit
// (all of it for the main path's s_hi 256; s_hi up to 512 and s up to
// 32, ragged sizes included, as the AOT recipe's 464).  Thread
// (row group, column thread) walks its columns (q, q + 256) and, per
// chunk, every other row, with the column's row of U^T in registers.
// Each thread keeps a running (value, index, cls) best and a block
// reduction picks the best with ties to the lower flat index, so the
// order of the walk does not matter.  NaN counts as the largest value,
// first NaN wins (jnp.argmax).  Built without --use_fast_math: a zero
// upsampled extent must give inf and exp(-inf) must give 0, as on the
// TPU.
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

constexpr int S_MAX = 32;      // largest response side the kernel takes
constexpr int S_HI_MAX = 512;  // largest upsampled side (whole-map form)
constexpr int ROW_GROUPS = 2;
constexpr int COL_THREADS = 256;
constexpr int THREADS = ROW_GROUPS * COL_THREADS;
constexpr size_t SMEM_CAP = 200 * 1024;

__global__ void __launch_bounds__(THREADS)
    decode_kernel(const float* __restrict__ x4, const float* __restrict__ wh,
                  const float* __restrict__ U,
                  const float* __restrict__ window,
                  const uint8_t* __restrict__ valid, int* __restrict__ idx_out,
                  float* __restrict__ score_out, int s, int s_hi, int rows,
                  float sigma, float one_minus_sigma, int use_centerness) {
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
  float* t_s = x_s + 4 * s * s;      // [4, rows, s]: one chunk of T
  __shared__ Best warp_best[32];
  for (int e = t; e < s_hi * s; e += THREADS) u_s[e] = U[e];
  for (int e = t; e < 4 * s * s; e += THREADS)
    x_s[e] = x4[(size_t)k * 4 * s * s + e];

  float bw = wh[2 * k], bh = wh[2 * k + 1];
  bw = bw == 0.f ? 1.f : bw;  // zero extents only on dead slots
  bh = bh == 0.f ? 1.f : bh;
  const int qt = t % COL_THREADS;
  const int rg = t / COL_THREADS;
  Best best{-INFINITY, s_hi * s_hi, -INFINITY};
  for (int r0 = 0; r0 < s_hi; r0 += rows) {
    const int nr = min(rows, s_hi - r0);
    __syncthreads();  // inputs staged / previous chunk consumed
    // T_c[r, w] = sum_h U[r, h] x4_c[h, w], w fastest across threads
    for (int e = t; e < 4 * nr * s; e += THREADS) {
      const int w = e % s, r = (e / s) % nr, c = e / (s * nr);
      float acc = 0.f;
      for (int h = 0; h < s; ++h)
        acc += u_s[(r0 + r) * s + h] * x_s[(c * s + h) * s + w];
      t_s[(c * rows + r) * s + w] = acc;
    }
    __syncthreads();
    for (int q = qt; q < s_hi; q += COL_THREADS) {
      float uq[S_MAX];
#pragma unroll
      for (int w = 0; w < S_MAX; ++w) uq[w] = w < s ? u_s[q * s + w] : 0.f;
      for (int r = rg; r < nr; r += ROW_GROUPS) {
        float up[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float* tr = t_s + (c * rows + r) * s;
          float acc = 0.f;
#pragma unroll
          for (int w = 0; w < S_MAX; ++w)
            if (w < s) acc += tr[w] * uq[w];
          up[c] = acc;
        }
        const int row = r0 + r;
        const float cls_prob = sigmoid(up[0]);
        const float conf =
            use_centerness ? __fmul_rn(cls_prob, sigmoid(up[1])) : cls_prob;
        float sw = __fdiv_rn(up[2], bw);
        float sh = __fdiv_rn(up[3], bh);
        sw = nan_max(sw, __fdiv_rn(1.f, sw));
        sh = nan_max(sh, __fdiv_rn(1.f, sh));
        const float pen =
            expf(__fmul_rn(__fadd_rn(-__fmul_rn(sw, sh), 1.f), 0.1f));
        const float p =
            __fadd_rn(__fmul_rn(__fmul_rn(conf, pen), one_minus_sigma),
                      __fmul_rn(sigma, window[(size_t)row * s_hi + q]));
        const Best cand{p, row * s_hi + q, cls_prob};
        if (better(cand, best)) best = cand;
      }
    }
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
    const int nw = THREADS / 32;
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
  if (s < 1 || s > S_MAX || s_hi < 1 || s_hi > S_HI_MAX)
    return (int)cudaErrorInvalidValue;
  // rows of T per chunk: all of them if they fit beside U and x4
  const size_t fixed = (size_t)(s_hi * s + 4 * s * s) * 4;
  int rows = (int)((SMEM_CAP - fixed) / ((size_t)4 * s * 4));
  rows = min(rows, s_hi);
  const size_t smem = fixed + (size_t)4 * rows * s * 4;
  cudaError_t err = set_smem(decode_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  decode_kernel<<<K, THREADS, smem, (cudaStream_t)stream>>>(
      x4, wh, U, window, valid, idx, score, s, s_hi, rows, sigma,
      one_minus_sigma, use_centerness);
  return (int)cudaGetLastError();
}
