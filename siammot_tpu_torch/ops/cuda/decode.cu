// EMM response decode: the CUDA counterparts of the Pallas kernel
// siammot_tpu/ops/pallas/decode.py:emm_decode_pallas in its three forms:
//   kernel 4   with ``valid``, whole map (_decode_kernel via _gated_kernel);
//   kernel 10  without ``valid``, whole map (_decode_kernel via
//              _plain_kernel): the same kernel with a null ``valid``, every
//              slot decoded (dead slots decode the maps they were given);
//   kernel 5   the row-striped form (_decode_kernel_striped), for upsampled
//              sides past the whole-map form's 512, with or without
//              ``valid``.
//
// Per slot, for the 4 channels x4 = (cls logit difference, centerness
// logit, l + r, t + b) of a [s, s] response:
//   up_c = U . x4_c . U^T                  (x16 bicubic, [s_hi, s_hi])
//   conf = sigmoid(up_0) * sigmoid(up_1)   (or sigmoid(up_0) alone)
//   sw = max(up_2 / w, w / up_2)...        (raw IEEE divisions)
//   p = conf * exp((1 - sw * sh) * 0.1) * (1 - sigma) + sigma * hann
// then the first-occurrence (lowest flat index) argmax of p and the cls
// probability there.  Gated dead slots return (0, 0).
//
// Every form computes a cell the same way: T_c = U . x4_c row by row as a
// fused multiply-add chain over h = 0..s-1, then up_c[r, q] as a chain
// over w = 0..s-1 of T_c[r, w] * U[q, w], then cell_value() below.  The
// argmax keeps (value, index, cls) bests and reduces them with better(),
// which is order-free (ties to the lower flat index), so the striped form
// returns bitwise the (idx, score) of the whole-map form, as the JAX
// package promises for its two kernels.  NaN counts as the largest value,
// first NaN wins (jnp.argmax).  Built without --use_fast_math: a zero
// upsampled extent must give inf and exp(-inf) must give 0, as on the TPU.
//
// Bound on the H100: operations, FFMA on the CUDA cores (no TF32: it would
// move the argmax): 4 x (s_hi s^2 + s_hi^2 s) multiply-adds plus ~30
// flops per cell, against 16 s^2 bytes of input per slot.
//
// Whole map (kernels 4 and 10; s <= 32, s_hi <= 512): one block of 512
// threads per slot; U and the input sit in shared memory, T is built
// there in chunks of rows that fit, and thread (row group, column thread)
// walks its columns (q, q + 256) and, per chunk, every other row, with
// the column's row of U in registers.
//
// Striped (kernel 5; s <= 64, any s_hi the stripe divides): U^T is
// s x s_hi (238 KB at s = 61) and does not fit a block beside the input,
// so the map is cut along rows: one block per (slot, band of whole
// stripes, at least 32 rows).  The block stages x4 (60 KB at s = 61) in
// shared memory, builds its band of T there, then each of its 256 threads
// takes one column q per pass over the band's rows, with U's row q read
// from global memory (L2) into registers.  Each block writes its band's
// best to a scratch row; a second launch reduces a slot's bands with
// better(), a running argmax over stripes.
#include <limits.h>

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

// the penalised confidence of one cell from its 4 upsampled channels
__device__ __forceinline__ Best cell_value(const float (&up)[4], float bw,
                                           float bh, float sigma,
                                           float one_minus_sigma,
                                           int use_centerness, float win,
                                           int flat) {
  const float cls_prob = sigmoid(up[0]);
  const float conf =
      use_centerness ? __fmul_rn(cls_prob, sigmoid(up[1])) : cls_prob;
  float sw = __fdiv_rn(up[2], bw);
  float sh = __fdiv_rn(up[3], bh);
  sw = nan_max(sw, __fdiv_rn(1.f, sw));
  sh = nan_max(sh, __fdiv_rn(1.f, sh));
  const float pen = expf(__fmul_rn(__fadd_rn(-__fmul_rn(sw, sh), 1.f), 0.1f));
  const float p = __fadd_rn(__fmul_rn(__fmul_rn(conf, pen), one_minus_sigma),
                            __fmul_rn(sigma, win));
  return Best{p, flat, cls_prob};
}

// zero template extents only occur on dead slots
__device__ __forceinline__ float extent(float v) { return v == 0.f ? 1.f : v; }

// block-wide reduction of each thread's best; the result in thread 0
__device__ __forceinline__ Best block_best(Best best, Best* warp_best) {
  for (int off = 16; off > 0; off /= 2) {
    Best o{__shfl_down_sync(0xffffffff, best.v, off),
           __shfl_down_sync(0xffffffff, best.idx, off),
           __shfl_down_sync(0xffffffff, best.cls, off)};
    if (better(o, best)) best = o;
  }
  const int t = threadIdx.x;
  if (t % 32 == 0) warp_best[t / 32] = best;
  __syncthreads();
  if (t < 32) {
    const int nw = blockDim.x / 32;
    best = t < nw ? warp_best[t] : Best{-INFINITY, INT_MAX, -INFINITY};
    for (int off = 16; off > 0; off /= 2) {
      Best o{__shfl_down_sync(0xffffffff, best.v, off),
             __shfl_down_sync(0xffffffff, best.idx, off),
             __shfl_down_sync(0xffffffff, best.cls, off)};
      if (better(o, best)) best = o;
    }
  }
  return best;
}

constexpr int S_MAX = 32;      // largest response side, whole-map form
constexpr int S_HI_MAX = 512;  // largest upsampled side, whole-map form
constexpr int ROW_GROUPS = 2;
constexpr int COL_THREADS = 256;
constexpr int THREADS = ROW_GROUPS * COL_THREADS;
constexpr size_t SMEM_CAP = 200 * 1024;

// valid may be null (kernel 10): every slot is decoded
__global__ void __launch_bounds__(THREADS)
    decode_kernel(const float* __restrict__ x4, const float* __restrict__ wh,
                  const float* __restrict__ U,
                  const float* __restrict__ window,
                  const uint8_t* __restrict__ valid, int* __restrict__ idx_out,
                  float* __restrict__ score_out, int s, int s_hi, int rows,
                  float sigma, float one_minus_sigma, int use_centerness) {
  const int k = blockIdx.x;
  const int t = threadIdx.x;
  if (valid != nullptr && !valid[k]) {
    if (t == 0) {
      idx_out[k] = 0;
      score_out[k] = 0.f;
    }
    return;
  }
  extern __shared__ __align__(16) float smem[];
  float* u_s = smem;                 // [s_hi, s]
  float* x_s = u_s + s_hi * s;       // [4, s, s]
  float* t_s = x_s + 4 * s * s;      // [4, rows, s]: one chunk of T
  __shared__ Best warp_best[32];
  for (int e = t; e < s_hi * s; e += THREADS) u_s[e] = U[e];
  for (int e = t; e < 4 * s * s; e += THREADS)
    x_s[e] = x4[(size_t)k * 4 * s * s + e];

  const float bw = extent(wh[2 * k]), bh = extent(wh[2 * k + 1]);
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
        acc = fmaf(u_s[(r0 + r) * s + h], x_s[(c * s + h) * s + w], acc);
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
            if (w < s) acc = fmaf(tr[w], uq[w], acc);
          up[c] = acc;
        }
        const int row = r0 + r;
        const Best cand =
            cell_value(up, bw, bh, sigma, one_minus_sigma, use_centerness,
                       window[(size_t)row * s_hi + q], row * s_hi + q);
        if (better(cand, best)) best = cand;
      }
    }
  }
  best = block_best(best, warp_best);
  if (t == 0) {
    idx_out[k] = best.idx;
    score_out[k] = best.cls;
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

// ---------------------------------------------------------------------------
// Kernel 5: the row-striped form.

constexpr int S_STRIPED_MAX = 64;  // largest response side, striped form
constexpr int STRIPED_THREADS = 256;

// x4 padded to a multiple of 4 floats per T row, for float4 loads
__host__ __device__ constexpr int t_stride(int s) { return (s + 3) & ~3; }

__global__ void __launch_bounds__(STRIPED_THREADS)
    decode_striped_kernel(const float* __restrict__ x4,
                          const float* __restrict__ wh,
                          const float* __restrict__ U,
                          const float* __restrict__ window,
                          const uint8_t* __restrict__ valid,
                          Best* __restrict__ partial, int s, int s_hi,
                          int band, float sigma, float one_minus_sigma,
                          int use_centerness) {
  const int k = blockIdx.x;
  if (valid != nullptr && !valid[k]) return;
  const int t = threadIdx.x;
  const int r0 = blockIdx.y * band;
  const int nr = min(band, s_hi - r0);
  const int sp = t_stride(s);
  extern __shared__ __align__(16) float smem[];
  float* t_s = smem;                  // [4, band, sp]
  float* x_s = t_s + 4 * band * sp;   // [4, s, s]
  __shared__ Best warp_best[STRIPED_THREADS / 32];
  for (int e = t; e < 4 * s * s; e += STRIPED_THREADS)
    x_s[e] = x4[(size_t)k * 4 * s * s + e];
  __syncthreads();
  // the band's rows of T_c = U . x4_c, the whole-map kernel's order; the
  // pad columns of each row are zero
  for (int e = t; e < 4 * nr * sp; e += STRIPED_THREADS) {
    const int w = e % sp, r = (e / sp) % nr, c = e / (sp * nr);
    float acc = 0.f;
    if (w < s) {
      const float* ur = U + (size_t)(r0 + r) * s;
      for (int h = 0; h < s; ++h)
        acc = fmaf(__ldg(ur + h), x_s[(c * s + h) * s + w], acc);
    }
    t_s[(c * band + r) * sp + w] = acc;
  }
  __syncthreads();

  const float bw = extent(wh[2 * k]), bh = extent(wh[2 * k + 1]);
  Best best{-INFINITY, s_hi * s_hi, -INFINITY};
  for (int q = t; q < s_hi; q += STRIPED_THREADS) {
    float uq[S_STRIPED_MAX];
    const float* ug = U + (size_t)q * s;
#pragma unroll
    for (int w = 0; w < S_STRIPED_MAX; ++w) uq[w] = w < s ? __ldg(ug + w) : 0.f;
    for (int r = 0; r < nr; ++r) {
      float up[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float4* tr = (const float4*)(t_s + (c * band + r) * sp);
        float acc = 0.f;
#pragma unroll
        for (int w4 = 0; w4 < S_STRIPED_MAX / 4; ++w4) {
          if (4 * w4 < s) {
            const float4 v = tr[w4];
            acc = fmaf(v.x, uq[4 * w4], acc);
            if (4 * w4 + 1 < s) acc = fmaf(v.y, uq[4 * w4 + 1], acc);
            if (4 * w4 + 2 < s) acc = fmaf(v.z, uq[4 * w4 + 2], acc);
            if (4 * w4 + 3 < s) acc = fmaf(v.w, uq[4 * w4 + 3], acc);
          }
        }
        up[c] = acc;
      }
      const int row = r0 + r;
      const Best cand =
          cell_value(up, bw, bh, sigma, one_minus_sigma, use_centerness,
                     window[(size_t)row * s_hi + q], row * s_hi + q);
      if (better(cand, best)) best = cand;
    }
  }
  best = block_best(best, warp_best);
  if (t == 0) partial[(size_t)k * gridDim.y + blockIdx.y] = best;
}

// one warp per slot: the running argmax over the slot's bands
__global__ void decode_reduce_kernel(const Best* __restrict__ partial,
                                     const uint8_t* __restrict__ valid,
                                     int* __restrict__ idx_out,
                                     float* __restrict__ score_out,
                                     int bands, int s_hi) {
  const int k = blockIdx.x;
  const int lane = threadIdx.x;
  if (valid != nullptr && !valid[k]) {
    if (lane == 0) {
      idx_out[k] = 0;
      score_out[k] = 0.f;
    }
    return;
  }
  Best best{-INFINITY, s_hi * s_hi, -INFINITY};
  for (int b = lane; b < bands; b += 32) {
    const Best o = partial[(size_t)k * bands + b];
    if (better(o, best)) best = o;
  }
  for (int off = 16; off > 0; off /= 2) {
    Best o{__shfl_down_sync(0xffffffff, best.v, off),
           __shfl_down_sync(0xffffffff, best.idx, off),
           __shfl_down_sync(0xffffffff, best.cls, off)};
    if (better(o, best)) best = o;
  }
  if (lane == 0) {
    idx_out[k] = best.idx;
    score_out[k] = best.cls;
  }
}

// partial: scratch of K * ceil(s_hi / band) x 12 bytes; band rows per block
// (a whole number of stripes, chosen by the caller)
SIAMMOT_API int siammot_emm_decode_striped(
    const float* x4, const float* wh, const float* U, const float* window,
    const uint8_t* valid, void* partial, int* idx, float* score, int K, int s,
    int s_hi, int band, float sigma, float one_minus_sigma,
    int use_centerness, void* stream) {
  if (K == 0) return 0;
  if (s < 1 || s > S_STRIPED_MAX || s_hi < 1 || band < 1 || band > 128)
    return (int)cudaErrorInvalidValue;
  const int bands = (s_hi + band - 1) / band;
  const size_t smem = ((size_t)4 * band * t_stride(s) + 4 * s * s) * 4;
  cudaError_t err = set_smem(decode_striped_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  decode_striped_kernel<<<dim3(K, bands), STRIPED_THREADS, smem,
                          (cudaStream_t)stream>>>(
      x4, wh, U, window, valid, (Best*)partial, s, s_hi, band, sigma,
      one_minus_sigma, use_centerness);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  decode_reduce_kernel<<<K, 32, 0, (cudaStream_t)stream>>>(
      (const Best*)partial, valid, idx, score, bands, s_hi);
  return (int)cudaGetLastError();
}
