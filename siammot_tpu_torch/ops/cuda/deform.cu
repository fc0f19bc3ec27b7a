// Deformable convolution (DCNv1) forward: the CUDA counterpart of the
// Pallas kernel siammot_tpu/ops/pallas/deform.py:deform_conv_pallas
// (_kernel), together with the exact patch form that its guard
// (siammot_tpu/ops/deform_conv.py:_pallas_guarded) falls back to.
//
//   out[p, co] = sum_{tap, c} sample(x, p, tap)[c] * w[tap, c, co]
//
// x [B, H, W, C] and out [B, Ho, Wo, Co] NHWC, offsets [B, Ho, Wo, 18]
// tap-major (dy, dx), w [3, 3, C, Co] HWIO, all in one dtype (f32 or
// bf16).  A sample is bilinear with out-of-range corners counting zero,
// by one of the reference's two routes (ops/deform_conv.py says which
// arithmetic each has); *route_a, a flag computed on the device, picks
// route A for the whole launch.  Samples are rounded to the input dtype,
// the sums over taps and channels are f32 and the output is rounded once.
//
// Bound on the H100: operations (2 x 9 C Co multiply-adds per output
// pixel against 2 C + 36 bytes of input), with an A operand that has to
// be gathered.  Simple design, an implicit GEMM: a block of 8 warps owns
// a tile of 64 output pixels x 64 output channels and walks K = 9 taps x
// C in chunks of 32 channels.  Per tap, the first 64 threads compute
// their pixel's four corner addresses and weights; per chunk, the block
// samples the 64 x 32 A tile into shared memory (four corner loads per
// element, neighbouring threads on neighbouring channels) and stages the
// 32 x 64 weight slice, then multiplies: bf16 on the tensor cores
// through WMMA 16x16x16 fragments (each warp one 16-row x 32-column
// piece), f32 with FFMA (each thread a 4 x 4 piece).  The card gathers
// per lane, so one kernel covers stride 1 and 2 and both routes: no
// halo, no window.
#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

namespace {

constexpr int BM = 64;    // output pixels per block
constexpr int BN = 64;    // output channels per block
constexpr int BK = 32;    // input channels per chunk
constexpr int THREADS = 256;
constexpr int LDA = BK + 8;   // bf16 tile strides (multiples of 8)
constexpr int LDB = BN + 8;
constexpr int LDC = BN + 4;
constexpr int LDAF = BM + 1;  // f32 A tile stride (no bank conflicts)

typedef __nv_bfloat16 bf16;

template <typename T>
__device__ __forceinline__ float rnd(float v);
template <>
__device__ __forceinline__ float rnd<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ float rnd<bf16>(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(bf16* p, float v) {
  *p = __float2bfloat16(v);
}

struct Geometry {
  int B, H, W, C, Ho, Wo, Co, stride, dil;
};

// The four corners of one (pixel, tap) sample: element offsets of the
// corner's channel 0 in x (-1 out of range) and the route's coefficients
// (route A: 1 - fy, fy, cx0, cx1; route B: w00, w01, w10, w11).
struct Corners {
  int at[4];
  float k[4];
};

template <typename T>
__device__ Corners corners(const T* __restrict__ off, const Geometry& g,
                           int n, int tap, bool route_a) {
  const int b = n / (g.Ho * g.Wo), rem = n % (g.Ho * g.Wo);
  const int py = rem / g.Wo, px = rem % g.Wo;
  const int gy = py * g.stride - g.dil + (tap / 3) * g.dil;
  const int gx = px * g.stride - g.dil + (tap % 3) * g.dil;
  const float oy = load_f32(off, (size_t)n * 18 + 2 * tap);
  const float ox = load_f32(off, (size_t)n * 18 + 2 * tap + 1);
  Corners r;
  int y0, x0;
  if (route_a) {
    // relative floor and fraction (exact); column weights rounded to the
    // input dtype, row weights f32, as the Pallas kernel's one-hot
    // matmul and row blend
    const float fly = floorf(oy), flx = floorf(ox);
    const float fy = oy - fly, fx = ox - flx;
    y0 = gy + (int)fly;
    x0 = gx + (int)flx;
    r.k[0] = __fsub_rn(1.f, fy);
    r.k[1] = fy;
    r.k[2] = rnd<T>(__fsub_rn(1.f, fx));
    r.k[3] = rnd<T>(fx);
  } else {
    // absolute coordinate in the offsets' dtype (int + bf16 -> bf16 in
    // JAX), corner weights as products in the input dtype
    const float cy = rnd<T>(rnd<T>((float)gy) + oy);
    const float cx = rnd<T>(rnd<T>((float)gx) + ox);
    const float fly = floorf(cy), flx = floorf(cx);
    const float fy = cy - fly, fx = cx - flx;
    y0 = (int)fly;
    x0 = (int)flx;
    const float ay = rnd<T>(1.f - fy), ax = rnd<T>(1.f - fx);
    r.k[0] = rnd<T>(ay * ax);
    r.k[1] = rnd<T>(ay * fx);
    r.k[2] = rnd<T>(fy * ax);
    r.k[3] = rnd<T>(fy * fx);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int yy = y0 + i / 2, xx = x0 + i % 2;
    r.at[i] = (yy >= 0 && yy < g.H && xx >= 0 && xx < g.W)
                  ? ((b * g.H + yy) * g.W + xx) * g.C
                  : -1;
  }
  return r;
}

template <typename T>
__device__ __forceinline__ float sample(const T* __restrict__ x,
                                        const int* at, const float* k, int c,
                                        bool route_a) {
  float v[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) v[i] = at[i] >= 0 ? load_f32(x, at[i] + c) : 0.f;
  if (route_a) {
    const float p0 = __fadd_rn(__fmul_rn(k[2], v[0]), __fmul_rn(k[3], v[1]));
    const float p1 = __fadd_rn(__fmul_rn(k[2], v[2]), __fmul_rn(k[3], v[3]));
    return rnd<T>(__fadd_rn(__fmul_rn(k[0], p0), __fmul_rn(k[1], p1)));
  }
  float s = __fmul_rn(k[0], v[0]);
  s = __fadd_rn(s, __fmul_rn(k[1], v[1]));
  s = __fadd_rn(s, __fmul_rn(k[2], v[2]));
  s = __fadd_rn(s, __fmul_rn(k[3], v[3]));
  return rnd<T>(s);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    deform_kernel(const T* __restrict__ x, const T* __restrict__ off,
                  const T* __restrict__ w, const int* __restrict__ route_a_p,
                  T* __restrict__ out, Geometry g) {
  constexpr bool TC = sizeof(T) == 2;  // bf16: tensor cores
  // A and B tiles: bf16 [BM][LDA] / [BK][LDB] for WMMA; f32 [BK][LDAF] /
  // [BK][BN] for FFMA (k-major, so a thread reads its 4 rows at once)
  __shared__ __align__(128) unsigned char a_raw[TC ? BM * LDA * 2
                                                   : BK * LDAF * 4];
  __shared__ __align__(128) unsigned char b_raw[TC ? BK * LDB * 2
                                                   : BK * BN * 4];
  __shared__ __align__(128) float c_tile[TC ? BM * LDC : 1];
  __shared__ int s_at[BM][4];
  __shared__ float s_k[BM][4];

  const int t = threadIdx.x;
  const int n0 = blockIdx.x * BM, co0 = blockIdx.y * BN;
  const int N = g.B * g.Ho * g.Wo;
  const bool route_a = *route_a_p != 0;
  const int warp = t / 32;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc_f[2];
  float acc[4][4] = {};
  if constexpr (TC) {
    wmma::fill_fragment(acc_f[0], 0.f);
    wmma::fill_fragment(acc_f[1], 0.f);
  }

  for (int tap = 0; tap < 9; ++tap) {
    __syncthreads();  // previous tap's corners consumed
    if (t < BM) {
      const int n = n0 + t;
      if (n < N) {
        const Corners cr = corners<T>(off, g, n, tap, route_a);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          s_at[t][i] = cr.at[i];
          s_k[t][i] = cr.k[i];
        }
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          s_at[t][i] = -1;
          s_k[t][i] = 0.f;
        }
      }
    }
    __syncthreads();
    for (int c0 = 0; c0 < g.C; c0 += BK) {
      // A: 64 pixels x 32 channels of samples, channels fastest
      for (int e = t; e < BM * BK; e += THREADS) {
        const int kk = e % BK, m = e / BK;
        const int c = c0 + kk;
        const float v =
            c < g.C ? sample<T>(x, s_at[m], s_k[m], c, route_a) : 0.f;
        if constexpr (TC)
          reinterpret_cast<bf16*>(a_raw)[m * LDA + kk] = __float2bfloat16(v);
        else
          reinterpret_cast<float*>(a_raw)[kk * LDAF + m] = v;
      }
      // B: the weight slice [tap, c0.., co0..], output channels fastest
      for (int e = t; e < BK * BN; e += THREADS) {
        const int nn = e % BN, kk = e / BN;
        const int c = c0 + kk, co = co0 + nn;
        const float v = (c < g.C && co < g.Co)
                            ? load_f32(w, ((size_t)tap * g.C + c) * g.Co + co)
                            : 0.f;
        if constexpr (TC)
          reinterpret_cast<bf16*>(b_raw)[kk * LDB + nn] = __float2bfloat16(v);
        else
          reinterpret_cast<float*>(b_raw)[kk * BN + nn] = v;
      }
      __syncthreads();
      if constexpr (TC) {
        const bf16* As = reinterpret_cast<const bf16*>(a_raw);
        const bf16* Bs = reinterpret_cast<const bf16*>(b_raw);
        const int row = (warp % 4) * 16, col = (warp / 4) * 32;
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bm;
#pragma unroll
        for (int ks = 0; ks < BK; ks += 16) {
          wmma::load_matrix_sync(a, As + row * LDA + ks, LDA);
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            wmma::load_matrix_sync(bm, Bs + ks * LDB + col + 16 * j, LDB);
            wmma::mma_sync(acc_f[j], a, bm, acc_f[j]);
          }
        }
      } else {
        const float* As = reinterpret_cast<const float*>(a_raw);
        const float* Bs = reinterpret_cast<const float*>(b_raw);
        const int ty = t / 16, tx = t % 16;
#pragma unroll 8
        for (int kk = 0; kk < BK; ++kk) {
          float av[4], bv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) av[i] = As[kk * LDAF + ty * 4 + i];
#pragma unroll
          for (int j = 0; j < 4; ++j) bv[j] = Bs[kk * BN + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
        }
      }
      __syncthreads();
    }
  }

  if constexpr (TC) {
    const int row = (warp % 4) * 16, col = (warp / 4) * 32;
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(c_tile + row * LDC + col + 16 * j, acc_f[j],
                              LDC, wmma::mem_row_major);
    __syncthreads();
    for (int e = t; e < BM * BN; e += THREADS) {
      const int nn = e % BN, m = e / BN;
      const int n = n0 + m, co = co0 + nn;
      if (n < N && co < g.Co) store(out + (size_t)n * g.Co + co, c_tile[m * LDC + nn]);
    }
  } else {
    const int ty = t / 16, tx = t % 16;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int n = n0 + ty * 4 + i;
      if (n >= N) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int co = co0 + tx + 16 * j;
        if (co < g.Co) store(out + (size_t)n * g.Co + co, acc[i][j]);
      }
    }
  }
}

}  // namespace

// dtype 1 = bfloat16 (tensor cores), 0 = float32 (FFMA)
SIAMMOT_API int siammot_deform_conv(const void* x, const void* offsets,
                                    const void* w, const int* route_a,
                                    void* out, int B, int H, int W, int C,
                                    int Ho, int Wo, int Co, int stride,
                                    int dilation, int dtype, void* stream) {
  const int N = B * Ho * Wo;
  if (N == 0 || Co == 0) return 0;
  if (C < 1 || stride < 1 || dilation < 1) return (int)cudaErrorInvalidValue;
  const Geometry g{B, H, W, C, Ho, Wo, Co, stride, dilation};
  const dim3 grid((N + BM - 1) / BM, (Co + BN - 1) / BN);
  if (dtype == 1)
    deform_kernel<bf16><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const bf16*)x, (const bf16*)offsets, (const bf16*)w, route_a,
        (bf16*)out, g);
  else
    deform_kernel<float><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)x, (const float*)offsets, (const float*)w, route_a,
        (float*)out, g);
  return (int)cudaGetLastError();
}
