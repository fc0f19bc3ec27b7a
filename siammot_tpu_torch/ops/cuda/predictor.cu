// Masked EMM predictor: the CUDA counterpart of the Pallas kernel
// siammot_tpu/ops/pallas/predictor.py:emm_predictor_pallas
// (_predictor_kernel).  Two forms: the resident bf16 kernel below for
// the main path's [K, 16, 16, 128] bf16 responses, and a tiled form
// (further down) for any S, any C with C % 32 == 0, in f32 or bf16.  At
// the end, kernel 8, the slot-blocked form of
// emm_predictor_pallas_blocked, which shares the tiled form's head pass.
//
// Per live slot, over a [16, 16, 128] bf16 correlation response x:
//   tower(x) = bf16(relu(GN32(conv3x3(x) + b)))   (cls and reg towers)
//   cls, ctr = conv3x3(tower_cls) + b             (2 + 1 channels)
//   reg      = relu(conv3x3(tower_reg) + b)       (4 channels)
// Each 3x3 conv is nine shifted [256 x 128] . [128 x 128] products with
// f32 accumulation; GroupNorm takes f32 statistics over the whole map
// with var = E[x^2] - E[x]^2; the tower output is rounded to bf16 before
// the heads, as on the TPU.
//
// Bound on the H100: operations.  The towers are 2 x 37.7 M multiply-adds
// per slot on inputs of 64 KB, so the tensor cores set the pace.  Simple
// design: one block of 16 warps per live slot, everything resident in
// shared memory (opted in to 214 KB): the zero-padded input as bf16
// [18][18][128] and one f32 [256][128] tower buffer.  The tower convs
// run on the tensor cores through WMMA 16x16x16 bf16 fragments: warp w
// owns output channels 16*(w%8).. and output rows 8*(w/8)..+7, so each
// weight fragment is read from global memory (L2) once per warp and used
// for eight rows.  GroupNorm reduces in shared memory; the 7 head
// channels are small and run on the CUDA cores, one warp per position,
// normalising and rounding the tower to bf16 as they read it.  Dead
// slots write zeros.
#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

constexpr int S = 16;        // response size
constexpr int SP = S + 2;    // padded
constexpr int C = 128;       // channels
constexpr int G = 32;        // GroupNorm groups
constexpr int THREADS = 512; // 16 warps

constexpr size_t XP_BYTES = (size_t)SP * SP * C * 2;    // 82,944
constexpr size_t ACC_BYTES = (size_t)S * S * C * 4;     // 131,072
constexpr size_t PART_BYTES = (size_t)2 * 4 * C * 4;    // 4,096
constexpr size_t STAT_BYTES = (size_t)2 * G * 4;        // 256
constexpr size_t SMEM = XP_BYTES + ACC_BYTES + PART_BYTES + STAT_BYTES;

typedef __nv_bfloat16 bf16;

// conv3x3(xp) for one tower into acc (f32, [256][128], row-major)
__device__ void tower_conv(const bf16* xp, const bf16* __restrict__ w,
                           float* acc) {
  const int warp = threadIdx.x / 32;
  const int nt = warp % 8;        // output-channel tile
  const int y0 = (warp / 8) * 8;  // first of the warp's 8 output rows
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> out[8];
#pragma unroll
  for (int r = 0; r < 8; ++r) wmma::fill_fragment(out[r], 0.f);
  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
  wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b, bn;
  // step = (tap, 16-channel input chunk); HWIO weights: rows cin
  // kc*16.., columns cout nt*16..  The next step's weight fragment is
  // loaded before this step's products, to hide the L2 latency.
  constexpr int STEPS = 9 * (C / 16);
  auto w_at = [&](int step) {
    return w + ((size_t)(step / (C / 16)) * C + (step % (C / 16)) * 16) * C +
           nt * 16;
  };
  wmma::load_matrix_sync(bn, w_at(0), C);
  for (int step = 0; step < STEPS; ++step) {
    b = bn;
    if (step + 1 < STEPS) wmma::load_matrix_sync(bn, w_at(step + 1), C);
    const int tap = step / (C / 16), kc = step % (C / 16);
    const int dy = tap / 3, dx = tap % 3;
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      // A rows are the 16 x positions of output row y0 + r, shifted
      wmma::load_matrix_sync(a, xp + ((y0 + r + dy) * SP + dx) * C + kc * 16,
                             C);
      wmma::mma_sync(out[r], a, b, out[r]);
    }
  }
#pragma unroll
  for (int r = 0; r < 8; ++r)
    wmma::store_matrix_sync(acc + (y0 + r) * S * C + nt * 16, out[r], C,
                            wmma::mem_row_major);
}

// acc += bias; GroupNorm statistics of the tower into stat[0..G) (mean)
// and stat[G..2G) (1 / sqrt(var + eps)), var = E[x^2] - E[x]^2
__device__ void tower_stats(float* acc, const bf16* __restrict__ bias,
                            float* part, float* stat) {
  const int t = threadIdx.x;
  const int c = t % C;
  const int pb = t / C;  // 4 blocks of 64 positions
  const float bc = __bfloat162float(bias[c]);
  float s = 0.f, q = 0.f;
  for (int p = pb * 64; p < pb * 64 + 64; ++p) {
    const float v = acc[p * C + c] + bc;
    acc[p * C + c] = v;
    s += v;
    q += v * v;
  }
  part[pb * C + c] = s;
  part[4 * C + pb * C + c] = q;
  __syncthreads();
  if (t < G) {
    float gs = 0.f, gq = 0.f;
    for (int b = 0; b < 4; ++b)
      for (int cc = t * (C / G); cc < (t + 1) * (C / G); ++cc) {
        gs += part[b * C + cc];
        gq += part[4 * C + b * C + cc];
      }
    const float cnt = (float)(S * S * (C / G));
    const float mean = gs / cnt;
    const float var = gq / cnt - mean * mean;
    stat[t] = mean;
    stat[G + t] = 1.f / sqrtf(var + 1e-5f);
  }
  __syncthreads();
}

// 3x3 head of NOUT channels at one output position over the tower
// relu(GN(acc)) rounded to bf16 (zero outside the map), one warp per
// position: lane l owns input channels 4l..4l+3, which are exactly
// GroupNorm group l; a warp shuffle adds the lanes
template <int NOUT>
__device__ void head_conv(const float* acc, const float* stat,
                          const bf16* __restrict__ scale,
                          const bf16* __restrict__ shift,
                          const bf16* __restrict__ w, float (&out)[NOUT],
                          int py, int px) {
  const int lane = threadIdx.x % 32;
  const float mean = stat[lane], rstd = stat[G + lane];
  float sc[4], sh[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    sc[i] = __bfloat162float(scale[lane * 4 + i]);
    sh[i] = __bfloat162float(shift[lane * 4 + i]);
  }
  float sum[NOUT];
#pragma unroll
  for (int o = 0; o < NOUT; ++o) sum[o] = 0.f;
  for (int dy = 0; dy < 3; ++dy) {
    const int yy = py + dy - 1;
    if (yy < 0 || yy >= S) continue;
    for (int dx = 0; dx < 3; ++dx) {
      const int xx = px + dx - 1;
      if (xx < 0 || xx >= S) continue;
      const float4 v = *(const float4*)(acc + (yy * S + xx) * C + lane * 4);
      const float vin[4] = {v.x, v.y, v.z, v.w};
      const bf16* wt = w + ((size_t)(dy * 3 + dx) * C + lane * 4) * NOUT;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float tv = __bfloat162float(__float2bfloat16(
            fmaxf((vin[i] - mean) * rstd * sc[i] + sh[i], 0.f)));
#pragma unroll
        for (int o = 0; o < NOUT; ++o)
          sum[o] += tv * __bfloat162float(wt[i * NOUT + o]);
      }
    }
  }
#pragma unroll
  for (int o = 0; o < NOUT; ++o) {
    for (int off = 16; off > 0; off /= 2)
      sum[o] += __shfl_xor_sync(0xffffffff, sum[o], off);
    out[o] = sum[o];
  }
}

struct PredictorParams {
  const bf16 *wct, *bct, *sct, *oct;  // cls tower conv w/b, GN scale/bias
  const bf16 *wrt, *brt, *srt, *ort;  // reg tower
  const bf16 *wcls, *bcls;            // [3,3,C,2], [2]
  const bf16 *wctr, *bctr;            // [3,3,C,1], [1]
  const bf16 *wreg, *breg;            // [3,3,C,4], [4]
};

__global__ void __launch_bounds__(THREADS)
    predictor_kernel(const bf16* __restrict__ x,
                     const uint8_t* __restrict__ valid, PredictorParams P,
                     float* __restrict__ cls, float* __restrict__ ctr,
                     float* __restrict__ reg) {
  const int k = blockIdx.x;
  const int t = threadIdx.x;
  float* cls_k = cls + (size_t)k * S * S * 2;
  float* ctr_k = ctr + (size_t)k * S * S;
  float* reg_k = reg + (size_t)k * S * S * 4;
  if (!valid[k]) {
    for (int e = t; e < S * S * 4; e += THREADS) {
      reg_k[e] = 0.f;
      if (e < S * S * 2) cls_k[e] = 0.f;
      if (e < S * S) ctr_k[e] = 0.f;
    }
    return;
  }
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* xp = (bf16*)smem;
  float* acc = (float*)(smem + XP_BYTES);
  float* part = (float*)(smem + XP_BYTES + ACC_BYTES);
  float* stat = (float*)(smem + XP_BYTES + ACC_BYTES + PART_BYTES);

  const bf16* xk = x + (size_t)k * S * S * C;
  for (int e = t; e < SP * SP * C; e += THREADS) {
    const int c = e % C, p = e / C;
    const int py = p / SP - 1, px = p % SP - 1;
    xp[e] = (py >= 0 && py < S && px >= 0 && px < S)
                ? xk[(py * S + px) * C + c]
                : __float2bfloat16(0.f);
  }
  __syncthreads();

  // cls tower -> cls (2) + ctr (1) heads
  tower_conv(xp, P.wct, acc);
  __syncthreads();
  tower_stats(acc, P.bct, part, stat);
  const int warp = t / 32, lane = t % 32;
  for (int p = warp; p < S * S; p += THREADS / 32) {
    float c2[2], c1[1];
    head_conv<2>(acc, stat, P.sct, P.oct, P.wcls, c2, p / S, p % S);
    head_conv<1>(acc, stat, P.sct, P.oct, P.wctr, c1, p / S, p % S);
    if (lane == 0) {
      cls_k[p * 2] = c2[0] + __bfloat162float(P.bcls[0]);
      cls_k[p * 2 + 1] = c2[1] + __bfloat162float(P.bcls[1]);
      ctr_k[p] = c1[0] + __bfloat162float(P.bctr[0]);
    }
  }
  __syncthreads();

  // reg tower -> reg (4) head
  tower_conv(xp, P.wrt, acc);
  __syncthreads();
  tower_stats(acc, P.brt, part, stat);
  for (int p = warp; p < S * S; p += THREADS / 32) {
    float r4[4];
    head_conv<4>(acc, stat, P.srt, P.ort, P.wreg, r4, p / S, p % S);
    if (lane == 0)
      for (int o = 0; o < 4; ++o)
        reg_k[p * 4 + o] = fmaxf(r4[o] + __bfloat162float(P.breg[o]), 0.f);
  }
}

SIAMMOT_API int siammot_emm_predictor(
    const void* x, const uint8_t* valid, const void* wct, const void* bct,
    const void* sct, const void* oct, const void* wrt, const void* brt,
    const void* srt, const void* ort, const void* wcls, const void* bcls,
    const void* wctr, const void* bctr, const void* wreg, const void* breg,
    float* cls, float* ctr, float* reg, int K, void* stream) {
  if (K == 0) return 0;
  cudaError_t err = set_smem(predictor_kernel, SMEM);
  if (err != cudaSuccess) return (int)err;
  PredictorParams P{(const bf16*)wct,  (const bf16*)bct,  (const bf16*)sct,
                    (const bf16*)oct,  (const bf16*)wrt,  (const bf16*)brt,
                    (const bf16*)srt,  (const bf16*)ort,  (const bf16*)wcls,
                    (const bf16*)bcls, (const bf16*)wctr, (const bf16*)bctr,
                    (const bf16*)wreg, (const bf16*)breg};
  predictor_kernel<<<K, THREADS, SMEM, (cudaStream_t)stream>>>(
      (const bf16*)x, valid, P, cls, ctr, reg);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Tiled form: any response size S and channel count C (C % 32 == 0), f32
// or bf16.  A padded 31x31x128 bf16 map (246 KB) or a 16x16x128 f32 one
// (128 KB per buffer) does not fit one block's shared memory beside its
// tower buffer, so the work is split in two launches:
//   1. tower_conv_tiled: per (live slot, tower, 64 positions x 64 output
//      channels) an FFMA implicit GEMM over K = 9 taps x C in chunks of
//      16, the input tile gathered with its zero border, f32 sums; it
//      writes conv + bias (f32, pre-norm) to a scratch [2, K, S*S, C].
//   2. heads_tiled: per (slot, tower) one block takes the GroupNorm
//      statistics of the scratch map (one warp per group, f32,
//      var = E[x^2] - E[x]^2), then one warp per output position runs
//      the 3x3 head(s), normalising, applying ReLU and rounding to the
//      response dtype as it loads, as the resident kernel does.
// The products are exact in f32 for bf16 inputs, as on the tensor
// cores, so both forms compute the same function; only the order of the
// f32 sums differs.  Bound: operations (2 x 9 S^2 C^2 multiply-adds per
// live slot); this form is the simple one, on the CUDA cores.

constexpr int TP = 64;        // positions per conv tile
constexpr int TC = 64;        // output channels per conv tile
constexpr int TK = 16;        // input channels per chunk
constexpr int CONV_THREADS = 256;
constexpr int HEAD_THREADS = 512;
static_assert(TK * TP % CONV_THREADS == 0 && TK * TC % CONV_THREADS == 0,
              "tiles fill whole thread passes");

template <typename T>
__device__ __forceinline__ float round_to(float v);
template <>
__device__ __forceinline__ float round_to<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

template <typename T>
struct TiledParams {
  const T *w[2], *b[2], *scale[2], *shift[2];  // towers: cls, reg
  const T *wcls, *bcls, *wctr, *bctr, *wreg, *breg;
};

template <typename T>
__global__ void __launch_bounds__(CONV_THREADS)
    tower_conv_tiled(const T* __restrict__ x,
                     const uint8_t* __restrict__ valid, TiledParams<T> P,
                     float* __restrict__ pre, int K, int S, int Cc) {
  const int k = blockIdx.z >> 1, tower = blockIdx.z & 1;
  if (!valid[k]) return;
  __shared__ float As[TK][TP + 1];  // +1: no bank conflicts on the fill
  __shared__ float Bs[TK][TC];
  const int t = threadIdx.x;
  const int p0 = blockIdx.x * TP, c0 = blockIdx.y * TC;
  const int ty = t / 16, tx = t % 16;  // 4 positions x 4 channels each
  const int SS = S * S;
  const T* xk = x + (size_t)k * SS * Cc;
  // select by value: indexing the parameter struct with a runtime
  // tower index would copy it to local memory
  const T* w = tower ? P.w[1] : P.w[0];
  const T* bias = tower ? P.b[1] : P.b[0];
  float acc[4][4] = {};
  for (int tap = 0; tap < 9; ++tap) {
    const int dy = tap / 3 - 1, dx = tap % 3 - 1;
    for (int k0 = 0; k0 < Cc; k0 += TK) {
#pragma unroll
      for (int i = 0; i < TK * TP / CONV_THREADS; ++i) {
        const int e = t + i * CONV_THREADS;
        const int kk = e % TK, pp = e / TK;
        const int p = p0 + pp, ci = k0 + kk;
        float v = 0.f;
        if (p < SS && ci < Cc) {
          const int yy = p / S + dy, xx = p % S + dx;
          if (yy >= 0 && yy < S && xx >= 0 && xx < S)
            v = load_f32(xk, (size_t)(yy * S + xx) * Cc + ci);
        }
        As[kk][pp] = v;
      }
#pragma unroll
      for (int i = 0; i < TK * TC / CONV_THREADS; ++i) {
        const int e = t + i * CONV_THREADS;
        const int cc = e % TC, kk = e / TC;
        const int co = c0 + cc, ci = k0 + kk;
        Bs[kk][cc] = (co < Cc && ci < Cc)
                         ? load_f32(w, ((size_t)tap * Cc + ci) * Cc + co)
                         : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < TK; ++kk) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = As[kk][ty * 4 + i];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
  }
  float* out = pre + ((size_t)tower * K + k) * SS * Cc;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int p = p0 + ty * 4 + i;
    if (p >= SS) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int co = c0 + tx + 16 * j;
      if (co < Cc)
        out[(size_t)p * Cc + co] = acc[i][j] + load_f32(bias, co);
    }
  }
}

// one 3x3 head of NOUT channels at (py, px) over the normalised tower,
// one warp: lanes stride the input channels, a shuffle adds them
template <typename T, int NOUT>
__device__ void head_tiled(const float* __restrict__ map, const float* stat,
                           const T* __restrict__ scale,
                           const T* __restrict__ shift,
                           const T* __restrict__ w, float (&out)[NOUT],
                           int py, int px, int S, int Cc) {
  const int lane = threadIdx.x % 32;
  const int cpg = Cc / G;
#pragma unroll
  for (int o = 0; o < NOUT; ++o) out[o] = 0.f;
  for (int c = lane; c < Cc; c += 32) {
    const int g = c / cpg;
    const float mean = stat[g], rstd = stat[G + g];
    const float sc = load_f32(scale, c), sh = load_f32(shift, c);
    for (int dy = 0; dy < 3; ++dy) {
      const int yy = py + dy - 1;
      if (yy < 0 || yy >= S) continue;
      for (int dx = 0; dx < 3; ++dx) {
        const int xx = px + dx - 1;
        if (xx < 0 || xx >= S) continue;
        const float v = map[(size_t)(yy * S + xx) * Cc + c];
        const float tv =
            round_to<T>(fmaxf((v - mean) * rstd * sc + sh, 0.f));
        const size_t row = ((size_t)(dy * 3 + dx) * Cc + c) * NOUT;
#pragma unroll
        for (int o = 0; o < NOUT; ++o) out[o] += tv * load_f32(w, row + o);
      }
    }
  }
#pragma unroll
  for (int o = 0; o < NOUT; ++o)
    for (int off = 16; off > 0; off /= 2)
      out[o] += __shfl_xor_sync(0xffffffff, out[o], off);
}

template <typename T>
__global__ void __launch_bounds__(HEAD_THREADS)
    heads_tiled(const float* __restrict__ pre,
                const uint8_t* __restrict__ valid, TiledParams<T> P,
                float* __restrict__ cls, float* __restrict__ ctr,
                float* __restrict__ reg, int K, int S, int Cc) {
  const int k = blockIdx.x, tower = blockIdx.y;
  const int t = threadIdx.x, warp = t / 32, lane = t % 32;
  const int SS = S * S;
  float* cls_k = cls + (size_t)k * SS * 2;
  float* ctr_k = ctr + (size_t)k * SS;
  float* reg_k = reg + (size_t)k * SS * 4;
  if (!valid[k]) {
    for (int e = t; e < SS * 4; e += HEAD_THREADS) {
      if (tower == 1) {
        reg_k[e] = 0.f;
      } else {
        if (e < SS * 2) cls_k[e] = 0.f;
        if (e < SS) ctr_k[e] = 0.f;
      }
    }
    return;
  }
  __shared__ float stat[2 * G];
  const float* map = pre + ((size_t)tower * K + k) * SS * Cc;
  const int cpg = Cc / G;
  for (int g = warp; g < G; g += HEAD_THREADS / 32) {
    float s = 0.f, q = 0.f;
    for (int j = lane; j < SS * cpg; j += 32) {
      const float v = map[(size_t)(j / cpg) * Cc + g * cpg + j % cpg];
      s += v;
      q += v * v;
    }
    for (int off = 16; off > 0; off /= 2) {
      s += __shfl_xor_sync(0xffffffff, s, off);
      q += __shfl_xor_sync(0xffffffff, q, off);
    }
    if (lane == 0) {
      const float cnt = (float)(SS * cpg);
      const float mean = s / cnt;
      stat[g] = mean;
      stat[G + g] = 1.f / sqrtf(q / cnt - mean * mean + 1e-5f);
    }
  }
  __syncthreads();
  for (int p = warp; p < SS; p += HEAD_THREADS / 32) {
    const int py = p / S, px = p % S;
    if (tower == 0) {
      float c2[2], c1[1];
      head_tiled<T, 2>(map, stat, P.scale[0], P.shift[0], P.wcls, c2, py, px,
                       S, Cc);
      head_tiled<T, 1>(map, stat, P.scale[0], P.shift[0], P.wctr, c1, py, px,
                       S, Cc);
      if (lane == 0) {
        cls_k[p * 2] = c2[0] + load_f32(P.bcls, 0);
        cls_k[p * 2 + 1] = c2[1] + load_f32(P.bcls, 1);
        ctr_k[p] = c1[0] + load_f32(P.bctr, 0);
      }
    } else {
      float r4[4];
      head_tiled<T, 4>(map, stat, P.scale[1], P.shift[1], P.wreg, r4, py, px,
                       S, Cc);
      if (lane == 0)
        for (int o = 0; o < 4; ++o)
          reg_k[p * 4 + o] = fmaxf(r4[o] + load_f32(P.breg, o), 0.f);
    }
  }
}

template <typename T>
static int predictor_tiled(const void* x, const uint8_t* valid,
                           const void* const* p, float* pre, float* cls,
                           float* ctr, float* reg, int K, int S, int Cc,
                           void* stream) {
  TiledParams<T> P;
  for (int i = 0; i < 2; ++i) {
    P.w[i] = (const T*)p[4 * i];
    P.b[i] = (const T*)p[4 * i + 1];
    P.scale[i] = (const T*)p[4 * i + 2];
    P.shift[i] = (const T*)p[4 * i + 3];
  }
  P.wcls = (const T*)p[8];
  P.bcls = (const T*)p[9];
  P.wctr = (const T*)p[10];
  P.bctr = (const T*)p[11];
  P.wreg = (const T*)p[12];
  P.breg = (const T*)p[13];
  const dim3 grid((S * S + TP - 1) / TP, (Cc + TC - 1) / TC, 2 * K);
  tower_conv_tiled<T><<<grid, CONV_THREADS, 0, (cudaStream_t)stream>>>(
      (const T*)x, valid, P, pre, K, S, Cc);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  heads_tiled<T><<<dim3(K, 2), HEAD_THREADS, 0, (cudaStream_t)stream>>>(
      pre, valid, P, cls, ctr, reg, K, S, Cc);
  return (int)cudaGetLastError();
}

// params: the 14 tensors in the order of ops/predictor.py _NAMES; dtype
// 0 = float32, 1 = bfloat16; pre: f32 scratch [2, K, S*S, C]
SIAMMOT_API int siammot_emm_predictor_tiled(
    const void* x, const uint8_t* valid, const void* const* params,
    float* pre, float* cls, float* ctr, float* reg, int K, int S, int Cc,
    int dtype, void* stream) {
  if (K == 0) return 0;
  if (Cc % G || S < 1 || 2 * K > 65535) return (int)cudaErrorInvalidValue;
  return dtype == 0
             ? predictor_tiled<float>(x, valid, params, pre, cls, ctr, reg, K,
                                      S, Cc, stream)
             : predictor_tiled<__nv_bfloat16>(x, valid, params, pre, cls, ctr,
                                              reg, K, S, Cc, stream);
}

// ---------------------------------------------------------------------------
// Kernel 8, the slot-blocked form: the CUDA counterpart of
// siammot_tpu/ops/pallas/predictor.py:emm_predictor_pallas_blocked
// (_predictor_kernel_blocked).  It computes kernel 3's function with B
// slots per program: a block of slots with no live slot writes zeros, and
// the dead lanes of a live block emit zeros.
//
// The point of blocking on this card is weight traffic: the per-slot
// kernels stage (or re-read from L2) every tower weight once per slot.
// Here one block per (B-slot group, tower, 16 output channels) stages its
// weight slice [9, C, 16] once in shared memory (73.7 KB in f32 at C =
// 128) and runs the tower conv of every live slot of the group against it:
// B x less weight traffic.  Its four warp groups of 256 threads take the
// group's slots in turn, each with its own input tile and barrier, so a
// block keeps 32 warps in flight.  The conv is an FFMA implicit GEMM over
// 256 positions x 16 channels per pass (4 x 4 outputs a thread), the input
// tile gathered with its zero border in chunks of 16 input channels; dead
// lanes are skipped (their outputs are zeros either way, as the JAX kernel
// multiplies them by a zero mask).  It writes conv + bias (f32, pre-norm)
// to the scratch, and heads_tiled (above) normalises per slot and runs
// the heads, writing zeros for dead slots: f32 sums, bias, GroupNorm with
// var = E[x^2] - E[x]^2, ReLU, the tower rounded to the response dtype,
// as kernel 3.
constexpr int BP = 256;   // positions per pass
constexpr int BC = 16;    // output channels per block
constexpr int BK = 16;    // input channels per chunk
constexpr int WG = 256;   // threads of one warp group (one slot at a time)
constexpr int NWG = 4;    // warp groups per block
constexpr int BLOCKED_THREADS = NWG * WG;
constexpr int BPS = BP + 4;  // As row stride: 2-way bank conflicts at most
static_assert(BP * BC == 16 * WG, "4 x 4 outputs a thread");
static_assert(BK * BP % WG == 0, "whole fill passes");

// a barrier of one warp group (ids 1..NWG; 0 is __syncthreads)
__device__ __forceinline__ void group_sync(int wg) {
  asm volatile("bar.sync %0, %1;" ::"r"(wg + 1), "r"(WG) : "memory");
}

template <typename T>
__global__ void __launch_bounds__(BLOCKED_THREADS)
    tower_conv_blocked(const T* __restrict__ x,
                       const uint8_t* __restrict__ valid, TiledParams<T> P,
                       float* __restrict__ pre, int K, int S, int Cc, int B) {
  const int g = blockIdx.x, tower = blockIdx.y, c0 = blockIdx.z * BC;
  int live = 0;
  for (int b = 0; b < B; ++b) live += valid[g * B + b];
  if (live == 0) return;  // heads_tiled writes the block's zeros
  extern __shared__ __align__(128) unsigned char smem[];
  float* Ws = (float*)smem;               // [9 * Cc][BC]
  const T* w = tower ? P.w[1] : P.w[0];
  const T* bias = tower ? P.b[1] : P.b[0];
  for (int e = threadIdx.x; e < 9 * Cc * BC; e += BLOCKED_THREADS) {
    const int cc = e % BC, row = e / BC;  // row = tap * Cc + cin
    Ws[e] = load_f32(w, (size_t)row * Cc + c0 + cc);
  }
  __syncthreads();
  // each warp group takes every NWG-th slot of the block's B, with its
  // own input tile
  const int wg = threadIdx.x / WG, t = threadIdx.x % WG;
  float* As = Ws + 9 * Cc * BC + wg * BK * BPS;  // [BK][BPS]
  const int ty = t / 4, tx = t % 4;  // positions 4ty.., channels 4tx..
  float bj[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) bj[j] = load_f32(bias, c0 + tx * 4 + j);
  const int SS = S * S;
  for (int b = wg; b < B; b += NWG) {
    const int k = g * B + b;
    if (!valid[k]) continue;
    const T* xk = x + (size_t)k * SS * Cc;
    float* out = pre + ((size_t)tower * K + k) * SS * Cc;
    for (int p0 = 0; p0 < SS; p0 += BP) {
      float acc[4][4] = {};
      for (int tap = 0; tap < 9; ++tap) {
        const int dy = tap / 3 - 1, dx = tap % 3 - 1;
        for (int k0 = 0; k0 < Cc; k0 += BK) {
          group_sync(wg);  // previous chunk consumed
#pragma unroll
          for (int i = 0; i < BK * BP / WG; ++i) {
            const int e = t + i * WG;
            const int kk = e % BK, pp = e / BK;
            const int p = p0 + pp;
            float v = 0.f;
            if (p < SS) {
              const int yy = p / S + dy, xx = p % S + dx;
              if (yy >= 0 && yy < S && xx >= 0 && xx < S)
                v = load_f32(xk, (size_t)(yy * S + xx) * Cc + k0 + kk);
            }
            As[kk * BPS + pp] = v;
          }
          group_sync(wg);
          const float* wrow = Ws + ((size_t)tap * Cc + k0) * BC + tx * 4;
#pragma unroll
          for (int kk = 0; kk < BK; ++kk) {
            const float4 a = *(const float4*)(As + kk * BPS + ty * 4);
            const float4 bv = *(const float4*)(wrow + kk * BC);
            const float av[4] = {a.x, a.y, a.z, a.w};
            const float bw[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int j = 0; j < 4; ++j)
                acc[i][j] = fmaf(av[i], bw[j], acc[i][j]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int p = p0 + ty * 4 + i;
        if (p >= SS) continue;
        float4 o;
        o.x = acc[i][0] + bj[0];
        o.y = acc[i][1] + bj[1];
        o.z = acc[i][2] + bj[2];
        o.w = acc[i][3] + bj[3];
        *(float4*)(out + (size_t)p * Cc + c0 + tx * 4) = o;
      }
    }
  }
}

template <typename T>
static int predictor_blocked(const void* x, const uint8_t* valid,
                             const void* const* p, float* pre, float* cls,
                             float* ctr, float* reg, int K, int S, int Cc,
                             int B, void* stream) {
  TiledParams<T> P;
  for (int i = 0; i < 2; ++i) {
    P.w[i] = (const T*)p[4 * i];
    P.b[i] = (const T*)p[4 * i + 1];
    P.scale[i] = (const T*)p[4 * i + 2];
    P.shift[i] = (const T*)p[4 * i + 3];
  }
  P.wcls = (const T*)p[8];
  P.bcls = (const T*)p[9];
  P.wctr = (const T*)p[10];
  P.bctr = (const T*)p[11];
  P.wreg = (const T*)p[12];
  P.breg = (const T*)p[13];
  const size_t smem =
      ((size_t)9 * Cc * BC + NWG * BK * BPS) * sizeof(float);
  cudaError_t err = set_smem(tower_conv_blocked<T>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(K / B, 2, Cc / BC);
  tower_conv_blocked<T><<<grid, BLOCKED_THREADS, smem,
                          (cudaStream_t)stream>>>((const T*)x, valid, P, pre,
                                                  K, S, Cc, B);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  heads_tiled<T><<<dim3(K, 2), HEAD_THREADS, 0, (cudaStream_t)stream>>>(
      pre, valid, P, cls, ctr, reg, K, S, Cc);
  return (int)cudaGetLastError();
}

// params as for siammot_emm_predictor_tiled; B slots a block, K % B == 0
SIAMMOT_API int siammot_emm_predictor_blocked(
    const void* x, const uint8_t* valid, const void* const* params,
    float* pre, float* cls, float* ctr, float* reg, int K, int S, int Cc,
    int B, int dtype, void* stream) {
  if (K == 0) return 0;
  if (Cc % G || S < 1 || B < 2 || K % B || K > 65535)
    return (int)cudaErrorInvalidValue;
  return dtype == 0
             ? predictor_blocked<float>(x, valid, params, pre, cls, ctr, reg,
                                        K, S, Cc, B, stream)
             : predictor_blocked<__nv_bfloat16>(x, valid, params, pre, cls,
                                                ctr, reg, K, S, Cc, B,
                                                stream);
}
