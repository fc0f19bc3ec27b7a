// EMM response decode: the CUDA counterpart of the Pallas kernel
// siammot_tpu/ops/pallas/decode.py:emm_decode_pallas in its three forms,
// all run by one kernel here, decode_band_kernel:
//   kernel 4   with ``valid``, whole map (_decode_kernel via _gated_kernel);
//   kernel 10  without ``valid``, whole map (_decode_kernel via
//              _plain_kernel): a null ``valid``, every slot decoded (dead
//              slots decode the maps they were given);
//   kernel 5   the row-striped form (_decode_kernel_striped), which JAX
//              takes for upsampled sides past 512, with or without
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
// Every cell is computed one way: T_c = U . x4_c row by row as a fused
// multiply-add chain over h = 0..s-1, then up_c[r, q] as a chain over
// w = 0..s-1 of T_c[r, w] * U[q, w], then cell_value() below.  The argmax
// keeps (value, index, cls) bests and reduces them with better(), which is
// order-free (ties to the lower flat index), so any cut of the map into
// bands returns the same bits: the striped and whole-map forms are bitwise
// equal, as the JAX package promises for its two kernels.  NaN counts as
// the largest value, first NaN wins (jnp.argmax).  Built without
// --use_fast_math: a zero upsampled extent must give inf and exp(-inf)
// must give 0, as on the TPU.  No TF32 or tensor cores: a rounded upsample
// moves the argmax.
//
// Bound on the H100: operations on the CUDA cores, 4 (s_hi s^2 + s_hi^2 s)
// multiply-adds a slot for the upsample and, per cell, cell_value()'s 64
// FP32-pipe and 9 special-function (MUFU) instructions, as chip_smoke.py
// counts them in the machine code of decode_cell_probe, against 16 s^2
// bytes of input per slot.  At the default s_hi 256 the cell math is about
// half of the work.
//
// decode_band_kernel: a persistent grid walks (live slot, band of BAND
// rows) items, the slots ordered live first on the device by a warp ballot
// (no host sync; dead slots take no item).  Per item the block builds its
// band's rows of T in shared memory (U's band rows staged h-major), then
// passes over the map's columns in chunks of CHUNK: each thread holds 2
// rows x 4 columns x 4 channels of accumulators, and per 4 steps of w
// reads 8 float4s of T (a warp's 4 rows, broadcast) and 4 float4s of U's
// rows (8 rows a warp, in distinct banks) for 128 fmas.  Where all of U's
// rows fit in shared memory (s_hi <= 512) they stay there for the launch,
// and each item copies its slot's x4 beside them by cp.async; else x4 is
// read through L1, and two chunk buffers take U's rows, the next chunk's
// copied while the current one computes (the chunks are the same for every
// item, so the last chunk prefetches the next item's first).  Each item
// writes its band's best to a scratch row; a second launch reduces a
// slot's bands with better().
//
// What sets the pace on the card: the cell math where s is small, the
// upsample where it is large.  decode_cell_probe runs 158 instructions
// along its fast path: the 73 above, its own loads and stores, and the
// moves, branches and convergence barriers around six IEEE slow paths
// (division and the sigmoids' reciprocals), and the scheduler cannot
// interleave one cell's regions with the next's.
#include <limits.h>

#include <algorithm>

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

// One cell_value() a thread with the main path's centerness; never
// launched: chip_smoke.py counts its machine instructions for the bound.
__global__ void decode_cell_probe(const float4* __restrict__ up,
                                  const float* __restrict__ window,
                                  Best* __restrict__ out, float bw, float bh,
                                  float sigma, float one_minus_sigma) {
  const int t = threadIdx.x;
  const float4 v = up[t];
  const float u[4] = {v.x, v.y, v.z, v.w};
  out[t] = cell_value(u, bw, bh, sigma, one_minus_sigma, 1, window[t], t);
}

namespace dec {

constexpr int THREADS = 256;  // 8 warps: 2 down the band x 4 across
constexpr int BAND = 16;      // rows an item: 2 warps x 4 row groups x 2
constexpr int CHUNK = 128;    // columns a pass: 4 warps x 8 groups x 4
constexpr int S_MAX = 64;     // largest response side (the striped form's)
constexpr size_t RESIDENT_BYTES = 80 * 1024;  // U kept whole up to this

// Row stride of U and T in shared memory, floats: s rounded up to a
// multiple of 4 that is 4 mod 8, so that the 8 (4) rows a warp reads as
// float4s at one w fall in distinct banks.
__host__ __device__ constexpr int stride(int s) {
  return (s + 3) / 4 % 2 == 0 ? (s + 3) / 4 * 4 + 4 : (s + 3) / 4 * 4;
}

// the first column of the chunk the calling thread's warp evaluates
__device__ __forceinline__ int warp_col0() {
  return threadIdx.x / 32 % 4 * 32;
}

// rows [q0, q0 + n) of U into u (row stride us), 4-byte cp.async copies
__device__ __forceinline__ void stage_u(const float* __restrict__ U,
                                        float* u, int q0, int n, int s,
                                        int us) {
  for (int e = threadIdx.x; e < n * s; e += THREADS) {
    const int q = e / s, w = e % s;
    cp_async4(u + q * us + w, U + (size_t)(q0 + q) * s + w);
  }
  cp_async_commit();
}

// The cells of one chunk a thread evaluates: rows 8 wr + rg + 4i (i < 2)
// of the band and columns 32 wc + cg + 8j (j < 4) of the chunk, for warp
// (wr, wc) and lane 8 rg + cg.  t_s holds the band's T [4][BAND][us], uc
// the chunk's U rows [CHUNK][us]; acc gets up_c of each cell.
template <int S>
__device__ __forceinline__ void chunk_upsample(const float* t_s,
                                               const float* uc, int s_rt,
                                               int us,
                                               float (&acc)[4][2][4]) {
  const int s = S > 0 ? S : s_rt;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const float* tr = t_s + (warp / 4 * 8 + lane / 8) * us;
  const float* ur = uc + (warp % 4 * 32 + lane % 8) * us;
#pragma unroll
  for (int c = 0; c < 4; ++c)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[c][i][j] = 0.f;
  // w ascending for every accumulator: 4 at a time, then the tail
#pragma unroll 2
  for (int w4 = 0; w4 < s / 4; ++w4) {
    float4 uv[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      uv[j] = *(const float4*)(ur + 8 * j * us + 4 * w4);
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float4 tv =
            *(const float4*)(tr + (c * BAND + 4 * i) * us + 4 * w4);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float a = acc[c][i][j];
          a = fmaf(tv.x, uv[j].x, a);
          a = fmaf(tv.y, uv[j].y, a);
          a = fmaf(tv.z, uv[j].z, a);
          a = fmaf(tv.w, uv[j].w, a);
          acc[c][i][j] = a;
        }
      }
  }
  for (int w = s / 4 * 4; w < s; ++w) {
    float uv[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) uv[j] = ur[8 * j * us + w];
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float tv = tr[(c * BAND + 4 * i) * us + w];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[c][i][j] = fmaf(tv, uv[j], acc[c][i][j]);
      }
  }
}

// cell_value() of the thread's cells of a chunk, the best kept in `best`
__device__ __forceinline__ void chunk_cells(
    const float (&acc)[4][2][4], const float* __restrict__ window, int s_hi,
    int r0, int q0, float bw, float bh, float sigma, float one_minus_sigma,
    int use_centerness, Best& best) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int row0 = r0 + warp / 4 * 8 + lane / 8;
  const int col0 = q0 + warp % 4 * 32 + lane % 8;
  float win[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = row0 + 4 * i, col = col0 + 8 * j;
      win[i][j] = row < s_hi && col < s_hi
                      ? __ldg(window + (size_t)row * s_hi + col)
                      : 0.f;
    }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = row0 + 4 * i, col = col0 + 8 * j;
      if (row < s_hi && col < s_hi) {
        const float up[4] = {acc[0][i][j], acc[1][i][j], acc[2][i][j],
                             acc[3][i][j]};
        const Best cand =
            cell_value(up, bw, bh, sigma, one_minus_sigma, use_centerness,
                       win[i][j], row * s_hi + col);
        if (better(cand, best)) best = cand;
      }
    }
}

// valid may be null (kernel 10): every slot is decoded.  partial: [K,
// bands] bests, written for the decoded slots only.  resident: U's rows of
// every chunk stay in shared memory for the whole launch, and each item
// copies its slot's x4 there in one round trip; else x4 is read through
// L1, and two chunk buffers take U's rows, the next chunk (the same rows
// for every item) copied while the current one computes.
template <int S>
__global__ void __launch_bounds__(THREADS, 2)
    decode_band_kernel(const float* __restrict__ x4,
                       const float* __restrict__ wh,
                       const float* __restrict__ U,
                       const float* __restrict__ window,
                       const uint8_t* __restrict__ valid,
                       Best* __restrict__ partial, int K, int s_rt, int s_hi,
                       int bands, int chunks, int resident, float sigma,
                       float one_minus_sigma, int use_centerness) {
  const int s = S > 0 ? S : s_rt;
  const int us = stride(s);
  const int t = threadIdx.x;
  extern __shared__ __align__(16) float smem[];
  const int ucols = resident ? chunks * CHUNK : 2 * CHUNK;
  float* u_s = smem;                  // [ucols][us]: U's rows, the columns
  float* ub_s = u_s + ucols * us;     // [s][BAND]: the band's rows, h-major
  float* t_s = ub_s + s * BAND;       // [4][BAND][us]: the band's T
  float* x_s = t_s + 4 * BAND * us;   // [4][s][s]: the slot's x4 (resident)
  __shared__ Best warp_best[THREADS / 32];
  const int* order = nullptr;
  int n_live = K;
  if (valid != nullptr) {
    int* o = (int*)(x_s + (resident ? 4 * s * s : 0));
    n_live = live_order(valid, K, o);
    order = o;
  }
  const int items = n_live * bands;
  if (resident)
    stage_u(U, u_s, 0, s_hi, s, us);
  else if (blockIdx.x < items)
    stage_u(U, u_s, 0, min(CHUNK, s_hi), s, us);

  int step = 0;  // chunks computed so far: the buffer, when not resident
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int p = item / bands, band = item % bands;
    const int k = order != nullptr ? order[p] : p;
    const int r0 = band * BAND;
    __syncthreads();  // the previous item is done with ub_s, t_s, x_s
    const float* xk = x4 + (size_t)k * 4 * s * s;
    if (resident) {  // the slot's x4 in one round trip
      if ((uintptr_t)x4 % 16 == 0)
        for (int e = t; e < s * s; e += THREADS)
          cp_async16(x_s + 4 * e, xk + 4 * e);
      else
        for (int e = t; e < 4 * s * s; e += THREADS)
          cp_async4(x_s + e, xk + e);
      cp_async_commit();
    }
    for (int e = t; e < s * BAND; e += THREADS) {
      const int h = e / BAND, r = e % BAND;
      ub_s[e] = r0 + r < s_hi ? __ldg(U + (size_t)(r0 + r) * s + h) : 0.f;
    }
    if (resident) cp_async_wait<0>();
    __syncthreads();
    // T_c[r, w] = sum_h U[r0 + r, h] x4_c[h, w]: a thread 8 rows of one
    // (channel, w), w fastest across threads; x4 from shared memory where
    // U is resident, else through L1
    const float* xsrc = resident ? x_s : xk;
    for (int task = t; task < 8 * s; task += THREADS) {
      const int w = task % s, half = task / s % 2, c = task / (2 * s);
      const float* xg = xsrc + (c * s) * s + w;
      float acc[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[i] = 0.f;
      for (int h = 0; h < s; ++h) {
        const float xv = xg[h * s];
        const float4 ua = *(const float4*)(ub_s + h * BAND + half * 8);
        const float4 ub = *(const float4*)(ub_s + h * BAND + half * 8 + 4);
        acc[0] = fmaf(ua.x, xv, acc[0]);
        acc[1] = fmaf(ua.y, xv, acc[1]);
        acc[2] = fmaf(ua.z, xv, acc[2]);
        acc[3] = fmaf(ua.w, xv, acc[3]);
        acc[4] = fmaf(ub.x, xv, acc[4]);
        acc[5] = fmaf(ub.y, xv, acc[5]);
        acc[6] = fmaf(ub.z, xv, acc[6]);
        acc[7] = fmaf(ub.w, xv, acc[7]);
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
        t_s[(c * BAND + half * 8 + i) * us + w] = acc[i];
    }

    const float bw = extent(wh[2 * k]), bh = extent(wh[2 * k + 1]);
    Best best{-INFINITY, s_hi * s_hi, -INFINITY};
    for (int ch = 0; ch < chunks; ++ch, ++step) {
      const int q0 = ch * CHUNK;
      if (!resident || ch == 0) {
        cp_async_wait<0>();  // this chunk's U rows
        __syncthreads();     // ... for every thread; T built; the other
                             // buffer's chunk consumed
      }
      const float* uc = u_s + (resident ? q0 : (step & 1) * CHUNK) * us;
      if (!resident && (ch + 1 < chunks || item + gridDim.x < items)) {
        const int q1 = ch + 1 < chunks ? q0 + CHUNK : 0;
        stage_u(U, u_s + ((step + 1) & 1) * CHUNK * us, q1,
                min(CHUNK, s_hi - q1), s, us);
      }
      if (q0 + warp_col0() < s_hi) {
        float acc[4][2][4];
        chunk_upsample<S>(t_s, uc, s, us, acc);
        chunk_cells(acc, window, s_hi, r0, q0, bw, bh, sigma,
                    one_minus_sigma, use_centerness, best);
      }
    }
    best = block_best(best, warp_best);
    if (t == 0) partial[(size_t)k * bands + band] = best;
  }
  cp_async_wait<0>();
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

template <int S>
static int launch(const float* x4, const float* wh, const float* U,
                  const float* window, const uint8_t* valid, Best* partial,
                  int* idx, float* score, int K, int s, int s_hi,
                  float sigma, float one_minus_sigma, int use_centerness,
                  cudaStream_t stream) {
  auto kernel = decode_band_kernel<S>;
  const int us = stride(s);
  const int bands = (s_hi + BAND - 1) / BAND;
  const int chunks = (s_hi + CHUNK - 1) / CHUNK;
  const bool resident =
      (size_t)chunks * CHUNK * us * sizeof(float) <= RESIDENT_BYTES;
  const int ucols = resident ? chunks * CHUNK : 2 * CHUNK;
  const size_t smem =
      ((size_t)ucols * us + s * BAND + 4 * BAND * us +
       (resident ? 4 * s * s : 0)) * sizeof(float) +
      (valid != nullptr ? (size_t)(K + 1) * sizeof(int) : 0);
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = resident_blocks(kernel, THREADS, smem);
  if (blocks == 0) return (int)cudaErrorInvalidConfiguration;
  kernel<<<std::min(blocks, K * bands), THREADS, smem, stream>>>(
      x4, wh, U, window, valid, partial, K, s, s_hi, bands, chunks,
      resident, sigma, one_minus_sigma, use_centerness);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  decode_reduce_kernel<<<K, 32, 0, stream>>>(partial, valid, idx, score,
                                              bands, s_hi);
  return (int)cudaGetLastError();
}

}  // namespace dec

// Kernels 4, 10 and 5.  partial: scratch of K * ceil(s_hi / 16) x 12
// bytes (ops/decode.py:decode_bands); valid null decodes every slot.
SIAMMOT_API int siammot_emm_decode(const float* x4, const float* wh,
                                   const float* U, const float* window,
                                   const uint8_t* valid, void* partial,
                                   int* idx, float* score, int K, int s,
                                   int s_hi, float sigma,
                                   float one_minus_sigma, int use_centerness,
                                   void* stream) {
  if (K == 0) return 0;
  if (s < 1 || s > dec::S_MAX || s_hi < 1) return (int)cudaErrorInvalidValue;
  auto st = (cudaStream_t)stream;
  Best* part = (Best*)partial;
  switch (s) {  // the default response, the AOT recipe's, SEARCH_REGION 5's
    case 16:
      return dec::launch<16>(x4, wh, U, window, valid, part, idx, score, K,
                             s, s_hi, sigma, one_minus_sigma, use_centerness,
                             st);
    case 29:
      return dec::launch<29>(x4, wh, U, window, valid, part, idx, score, K,
                             s, s_hi, sigma, one_minus_sigma, use_centerness,
                             st);
    case 61:
      return dec::launch<61>(x4, wh, U, window, valid, part, idx, score, K,
                             s, s_hi, sigma, one_minus_sigma, use_centerness,
                             st);
    default:
      return dec::launch<0>(x4, wh, U, window, valid, part, idx, score, K, s,
                            s_hi, sigma, one_minus_sigma, use_centerness, st);
  }
}
