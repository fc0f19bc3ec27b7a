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
// arithmetic each has).  Route A is taken for the whole launch where the
// geometry allows it and deform_window, run first in the same call,
// finds every offset's floor in [-R, R]: a flag on the device, so the
// host never waits.  Samples are rounded to the input dtype, the sums
// over taps and channels are f32 and the output is rounded once.
//
// Bound on the H100: operations (2 x 9 C Co multiply-adds per output
// pixel against 2 C + 36 bytes of input), with an A operand that has to
// be gathered: four corner loads and the route's arithmetic per element.
//
// bf16, deform_wgmma: an implicit GEMM on Hopper's warpgroup MMA
// (wgmma.cuh).  A block owns 128 output pixels x 128 output channels, or
// 64 x 256 where Co > 128, so each (pixel, tap, channel) is sampled once
// per block (once for every 256 outputs in DLA-102's stages 4 and 5),
// and walks its taps x C in chunks of 64 channels through a 3-stage
// ring.  Two
// producer warpgroups compute every (pixel, tap)'s corners and
// coefficients once (corners()), then gather 8 channels a 16-byte load
// per corner (NHWC keeps a pixel's channels together; a thread has its
// 16 loads in flight before it blends), apply blend() element by element,
// so every sample is bit for bit the FFMA form's, and write the bf16 A
// chunk into the ring beside the weight slice (cp.async); two consumer
// warpgroups run m64n128k16 wgmma on a chunk while the producers sample
// the next.  Where the (pixel, channel) tiles alone leave more than half
// the SMs idle (DLA-102's stages 4 and 5) the taps are split over 3 or 9
// blocks, each writing an f32 partial sum; deform_reduce adds them in
// order and rounds once.  Ragged C and Co are zero-filled chunks and
// masked stores; C or Co not a multiple of 8 take element loads.
//
// f32, deform_ffma: the simple implicit GEMM, 64 pixels x 64 channels a
// block of 8 warps, the A tile sampled into shared memory per chunk of
// 32 channels, FFMA with a 4 x 4 piece a thread.
#include "common.cuh"
#include "wgmma.cuh"

namespace {

constexpr int BM = 64;    // f32 form: output pixels per block
constexpr int BN = 64;    // output channels per block
constexpr int BK = 32;    // input channels per chunk
constexpr int THREADS = 256;
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

// one sample from its four corner values, in the route's arithmetic,
// before its rounding to the input dtype
__device__ __forceinline__ float blend(const float* v, const float* k,
                                       bool route_a) {
  if (route_a) {
    const float p0 = __fadd_rn(__fmul_rn(k[2], v[0]), __fmul_rn(k[3], v[1]));
    const float p1 = __fadd_rn(__fmul_rn(k[2], v[2]), __fmul_rn(k[3], v[3]));
    return __fadd_rn(__fmul_rn(k[0], p0), __fmul_rn(k[1], p1));
  }
  float s = __fmul_rn(k[0], v[0]);
  s = __fadd_rn(s, __fmul_rn(k[1], v[1]));
  s = __fadd_rn(s, __fmul_rn(k[2], v[2]));
  return __fadd_rn(s, __fmul_rn(k[3], v[3]));
}

template <typename T>
__device__ __forceinline__ float sample(const T* __restrict__ x,
                                        const int* at, const float* k, int c,
                                        bool route_a) {
  float v[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) v[i] = at[i] >= 0 ? load_f32(x, at[i] + c) : 0.f;
  return rnd<T>(blend(v, k, route_a));
}

__global__ void __launch_bounds__(THREADS)
    deform_ffma(const float* __restrict__ x, const float* __restrict__ off,
                const float* __restrict__ w, const int* __restrict__ outside,
                float* __restrict__ out, Geometry g) {
  __shared__ float As[BK * LDAF];  // k-major: a thread reads its 4 rows
  __shared__ float Bs[BK * BN];
  __shared__ int s_at[BM][4];
  __shared__ float s_k[BM][4];

  const int t = threadIdx.x;
  const int n0 = blockIdx.x * BM, co0 = blockIdx.y * BN;
  const int N = g.B * g.Ho * g.Wo;
  const bool route_a = outside && *outside == 0;
  const int ty = t / 16, tx = t % 16;
  float acc[4][4] = {};

  for (int tap = 0; tap < 9; ++tap) {
    __syncthreads();  // previous tap's corners consumed
    if (t < BM) {
      const int n = n0 + t;
      Corners cr;
      if (n < N) {
        cr = corners<float>(off, g, n, tap, route_a);
      } else {
        for (int i = 0; i < 4; ++i) cr.at[i] = -1, cr.k[i] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s_at[t][i] = cr.at[i];
        s_k[t][i] = cr.k[i];
      }
    }
    __syncthreads();
    for (int c0 = 0; c0 < g.C; c0 += BK) {
      // A: 64 pixels x 32 channels of samples, channels fastest
      for (int e = t; e < BM * BK; e += THREADS) {
        const int kk = e % BK, m = e / BK;
        const int c = c0 + kk;
        As[kk * LDAF + m] =
            c < g.C ? sample<float>(x, s_at[m], s_k[m], c, route_a) : 0.f;
      }
      // B: the weight slice [tap, c0.., co0..], output channels fastest
      for (int e = t; e < BK * BN; e += THREADS) {
        const int nn = e % BN, kk = e / BN;
        const int c = c0 + kk, co = co0 + nn;
        Bs[kk * BN + nn] = (c < g.C && co < g.Co)
                               ? w[((size_t)tap * g.C + c) * g.Co + co]
                               : 0.f;
      }
      __syncthreads();
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
      __syncthreads();
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = n0 + ty * 4 + i;
    if (n >= N) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int co = co0 + tx + 16 * j;
      if (co < g.Co) out[(size_t)n * g.Co + co] = acc[i][j];
    }
  }
}

// -- bf16: deform_wgmma -------------------------------------------------
// NT 128-column tiles of output channels a block: 1 for Co <= 128, else
// 2, each consumer warpgroup then taking one over the block's 64 pixels,
// so a pixel is sampled once for 256 outputs
template <int NT>
struct Dcn {
  static constexpr int BM = 128 / NT;           // output pixels a block
  static constexpr int KC = 64;                 // input channels a stage
  static constexpr int STAGES = 3;
  static constexpr int A_BYTES = BM * KC * 2;   // [pixel][64 ch], 128 B rows
  static constexpr int B_TILE = KC * wg::N * 2; // [64 ch][128 outputs]
  static constexpr int STAGE_BYTES = A_BYTES + NT * B_TILE;
  static constexpr int CONSUMER_WARPS = 8;      // two warpgroups
  static constexpr int PRODUCERS = 256;         // two warpgroups sample
  static constexpr int ITEMS = BM * 8 / PRODUCERS;  // (pixel, 8 ch) a thread
  static constexpr int THREADS = 32 * CONSUMER_WARPS + PRODUCERS;
  static constexpr int CORNER_BYTES = 9 * BM * 32;  // every tap's corners
  static constexpr size_t SMEM =
      (size_t)STAGES * STAGE_BYTES + CORNER_BYTES + 1024;
};

// flags: bit 0 x 16-byte loads (C % 8 == 0, x aligned), bit 1 weights by
// cp.async (Co % 8 == 0, w aligned)
template <int NT>
__global__ void __launch_bounds__(Dcn<NT>::THREADS, 1)
    deform_wgmma(const bf16* __restrict__ x, const bf16* __restrict__ off,
                 const bf16* __restrict__ w, const int* __restrict__ outside,
                 bf16* __restrict__ out, float* __restrict__ partial,
                 Geometry g, int splits, int flags) {
  using D = Dcn<NT>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring =
      (unsigned char*)(((uintptr_t)smem_raw + 1023) & ~(uintptr_t)1023);
  __shared__ uint64_t full[D::STAGES], empty[D::STAGES];
  // corners of (tap, pixel): element offsets and coefficients
  int4* s_at = (int4*)(ring + D::STAGES * D::STAGE_BYTES);
  float4* s_k = (float4*)(s_at + 9 * D::BM);

  const int t = threadIdx.x, warp = t / 32, lane = t % 32;
  const int n0 = blockIdx.x * D::BM, co0 = blockIdx.y * wg::N * NT;
  const int N = g.B * g.Ho * g.Wo;
  const int tap0 = blockIdx.z * 9 / splits;
  const int tap1 = (blockIdx.z + 1) * 9 / splits;
  const int chunks = (g.C + D::KC - 1) / D::KC;
  const uint32_t ring_at = wg::smem_addr(ring);
  if (t == 0) {
    for (int s = 0; s < D::STAGES; ++s) {
      wg::mbar_init(&full[s], 2 * D::PRODUCERS);  // A writes, B copies
      wg::mbar_init(&empty[s], D::CONSUMER_WARPS);
    }
    wg::mbar_init_fence();
  }
  __syncthreads();

  if (warp >= D::CONSUMER_WARPS) {
    // producers: first every (tap, pixel)'s corners, all their offset
    // loads in flight at once; then thread pt samples channels
    // 8 (pt % 8).. of pixels pt / 8 + (PRODUCERS / 8) i, all corner loads
    // in flight before the arithmetic
    const int pt = t - 32 * D::CONSUMER_WARPS, v = pt % 8;
    const bool route_a = outside && *outside == 0;
#pragma unroll 5
    for (int e = pt; e < (tap1 - tap0) * D::BM; e += D::PRODUCERS) {
      const int tap = tap0 + e / D::BM, n = n0 + e % D::BM;
      Corners cr;
      if (n < N) {
        cr = corners<bf16>(off, g, n, tap, route_a);
      } else {
        for (int i = 0; i < 4; ++i) cr.at[i] = -1, cr.k[i] = 0.f;
      }
      s_at[e] = make_int4(cr.at[0], cr.at[1], cr.at[2], cr.at[3]);
      s_k[e] = make_float4(cr.k[0], cr.k[1], cr.k[2], cr.k[3]);
    }
    wg::named_sync(1, D::PRODUCERS);
    int stage = 0;
    uint32_t phase = 1;
    for (int tap = tap0; tap < tap1; ++tap) {
      const int4* at_tap = s_at + (tap - tap0) * D::BM;
      const float4* k_tap = s_k + (tap - tap0) * D::BM;
      for (int ch = 0; ch < chunks; ++ch) {
        const int c0 = ch * D::KC;
        wg::mbar_wait(&empty[stage], phase);
        const uint32_t a_at = ring_at + stage * D::STAGE_BYTES;
        const uint32_t b_at = a_at + D::A_BYTES;
        // B: the weight slice [tap, c0.., co0..]
        if (flags & 2) {
          for (int e = pt; e < D::KC * 16 * NT; e += D::PRODUCERS) {
            const int r = e / (16 * NT), q = e % (16 * NT);
            const int ci = c0 + r, co = co0 + q * 8;
            const bool in = ci < g.C && co < g.Co;
            wg::cp_async16(
                b_at + (q / 16) * D::B_TILE + wg::b_offset(r, q % 16, D::KC),
                in ? w + ((size_t)tap * g.C + ci) * g.Co + co : w,
                in ? 16 : 0);
          }
        } else {
          bf16* b = (bf16*)(ring + stage * D::STAGE_BYTES + D::A_BYTES);
          for (int e = pt; e < D::KC * wg::N * NT; e += D::PRODUCERS) {
            const int r = e / (wg::N * NT), col = e % (wg::N * NT);
            const int ci = c0 + r, co = co0 + col;
            b[(col / wg::N) * D::B_TILE / 2 +
              wg::b_offset(r, col % wg::N / 8, D::KC) / 2 + col % 8] =
                ci < g.C && co < g.Co ? w[((size_t)tap * g.C + ci) * g.Co + co]
                                      : __float2bfloat16(0.f);
          }
        }
        wg::cp_async_arrive(&full[stage]);
        // A: 128 pixels x 64 channels of samples
        const int c = c0 + 8 * v;
        unsigned char* a_tile = ring + stage * D::STAGE_BYTES;
        if ((flags & 1) && c < g.C) {
          uint4 raw[D::ITEMS][4];
#pragma unroll
          for (int i = 0; i < D::ITEMS; ++i) {
            const int4 at = at_tap[pt / 8 + D::PRODUCERS / 8 * i];
            const int a4[4] = {at.x, at.y, at.z, at.w};
#pragma unroll
            for (int j = 0; j < 4; ++j)
              raw[i][j] = a4[j] >= 0 ? *(const uint4*)(x + a4[j] + c)
                                     : make_uint4(0, 0, 0, 0);
          }
#pragma unroll
          for (int i = 0; i < D::ITEMS; ++i) {
            const int m = pt / 8 + D::PRODUCERS / 8 * i;
            const float4 k4 = k_tap[m];
            const float k[4] = {k4.x, k4.y, k4.z, k4.w};
            // two samples a conversion: each rounds once, as rnd() does
            __align__(16) __nv_bfloat162 vals[4];
#pragma unroll
            for (int e = 0; e < 8; e += 2) {
              float cv[2][4];
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                const __nv_bfloat162 pair =
                    ((const __nv_bfloat162*)&raw[i][j])[e / 2];
                cv[0][j] = __low2float(pair);
                cv[1][j] = __high2float(pair);
              }
              vals[e / 2] = __floats2bfloat162_rn(blend(cv[0], k, route_a),
                                                  blend(cv[1], k, route_a));
            }
            *(uint4*)(a_tile + m * 128 + ((v ^ (m & 7)) << 4)) =
                *(const uint4*)vals;
          }
        } else {
          for (int i = 0; i < D::ITEMS; ++i) {
            const int m = pt / 8 + D::PRODUCERS / 8 * i;
            const int4 at4 = at_tap[m];
            const float4 k4 = k_tap[m];
            const int at[4] = {at4.x, at4.y, at4.z, at4.w};
            const float k[4] = {k4.x, k4.y, k4.z, k4.w};
            __align__(16) bf16 vals[8];
            for (int e = 0; e < 8; ++e)
              vals[e] = __float2bfloat16(
                  c + e < g.C ? sample<bf16>(x, at, k, c + e, route_a) : 0.f);
            *(uint4*)(a_tile + m * 128 + ((v ^ (m & 7)) << 4)) =
                *(const uint4*)vals;
          }
        }
        wg::mbar_arrive(&full[stage]);
        if (++stage == D::STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    wg::cp_async_wait<0>();  // leave no copy in flight
    return;
  }

  // consumers: with NT = 1 warpgroup gq owns pixels n0 + 64 gq .. and
  // all 128 columns, with NT = 2 the block's 64 pixels and columns
  // 128 gq ..; its warp wq the 16 rows from 16 wq
  const int gq = warp / 4, wq = warp % 4;
  const int row0 = NT == 1 ? 64 * gq : 0;
  const int b_off = D::A_BYTES + (NT == 1 ? 0 : gq * D::B_TILE);
  const int row = row0 + 16 * wq + (lane & 15);
  float d[wg::ACC];
#pragma unroll
  for (int i = 0; i < wg::ACC; ++i) d[i] = 0.f;
  int stage = 0;
  uint32_t phase = 0;
  for (int it = 0; it < (tap1 - tap0) * chunks; ++it) {
    wg::mbar_wait(&full[stage], phase);
    wg::fence_proxy_async();
    const uint32_t a_at = ring_at + stage * D::STAGE_BYTES;
    uint32_t a[D::KC / 16][4];
#pragma unroll
    for (int ks = 0; ks < D::KC / 16; ++ks) {
      const int q = 2 * ks + (lane >> 4);
      wg::ldmatrix_x4(a[ks], a_at + row * 128 + ((q ^ (row & 7)) << 4));
    }
    wg::fence();
#pragma unroll
    for (int ks = 0; ks < D::KC / 16; ++ks)
      wg::mma(d, a[ks], wg::b_desc(a_at + b_off + ks * 2048, D::KC));
    wg::commit();
    wg::wait<0>();
    wg::fence_acc(d);
    __syncwarp();
    if (lane == 0) wg::mbar_arrive(&empty[stage]);
    if (++stage == D::STAGES) {
      stage = 0;
      phase ^= 1;
    }
  }

  // two neighbouring columns a store where Co is even
  const int r0 = n0 + row0 + 16 * wq + lane / 4;
  const bool pairs = g.Co % 2 == 0;
#pragma unroll
  for (int i = 0; i < wg::ACC; i += 2) {
    const int n = r0 + 8 * ((i / 2) % 2);
    const int co = co0 + (NT == 1 ? 0 : wg::N * gq) + 8 * (i / 4) +
                   2 * (lane % 4);
    if (n >= N || co >= g.Co) continue;
    if (splits == 1) {
      bf16* o = out + (size_t)n * g.Co + co;
      if (pairs)
        *(__nv_bfloat162*)o = __floats2bfloat162_rn(d[i], d[i + 1]);
      else {
        o[0] = __float2bfloat16(d[i]);
        if (co + 1 < g.Co) o[1] = __float2bfloat16(d[i + 1]);
      }
    } else {
      float* o = partial + ((size_t)blockIdx.z * N + n) * g.Co + co;
      if (pairs)
        *(float2*)o = make_float2(d[i], d[i + 1]);
      else {
        o[0] = d[i];
        if (co + 1 < g.Co) o[1] = d[i + 1];
      }
    }
  }
}

// *outside = 1 if some offset's floor lies outside [-r, r] (or is NaN);
// the caller zeroes it first
template <typename T>
__global__ void __launch_bounds__(256)
    deform_window(const T* __restrict__ off, int count, int r,
                  int* __restrict__ outside) {
  bool out = false;
  const int step = gridDim.x * blockDim.x;
#pragma unroll 4
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < count; e += step) {
    const float f = floorf(load_f32(off, e));
    out |= !(f >= -r && f <= r);
  }
  if (__syncthreads_or(out) && threadIdx.x == 0) *outside = 1;
}

// out = bf16(sum over the splits of the partial sums), in split order
__global__ void deform_reduce(const float* __restrict__ partial,
                              bf16* __restrict__ out, size_t count,
                              int splits) {
  const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= count) return;
  float s = partial[e];
  for (int i = 1; i < splits; ++i) s += partial[i * count + e];
  out[e] = __float2bfloat16(s);
}

template <int NT>
static cudaError_t launch_wgmma(const void* x, const void* offsets,
                                const void* w, const int* outside, void* out,
                                float* partial, const Geometry& g, int splits,
                                int flags, cudaStream_t s) {
  using D = Dcn<NT>;
  static bool opted_in = false;  // once, outside any graph capture
  if (!opted_in) {
    const cudaError_t err = set_smem(deform_wgmma<NT>, D::SMEM);
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  const int N = g.B * g.Ho * g.Wo;
  const dim3 grid((N + D::BM - 1) / D::BM,
                  (g.Co + wg::N * NT - 1) / (wg::N * NT), splits);
  deform_wgmma<NT><<<grid, D::THREADS, D::SMEM, s>>>(
      (const bf16*)x, (const bf16*)offsets, (const bf16*)w, outside,
      (bf16*)out, partial, g, splits, flags);
  return cudaGetLastError();
}

}  // namespace

// dtype 1 = bfloat16 (tensor cores; taps split over `splits` in {1, 3,
// 9} blocks, partial: f32 [splits, N, Co] when splits > 1), 0 = float32
// (FFMA).  outside: an int scratch where the geometry allows route A
// (radius r), null where it does not.
SIAMMOT_API int siammot_deform_conv(const void* x, const void* offsets,
                                    const void* w, int* outside, int r,
                                    void* out, float* partial, int B, int H,
                                    int W, int C, int Ho, int Wo, int Co,
                                    int stride, int dilation, int dtype,
                                    int splits, void* stream) {
  const int N = B * Ho * Wo;
  if (N == 0 || Co == 0) return 0;
  if (C < 1 || stride < 1 || dilation < 1 || 9 % splits)
    return (int)cudaErrorInvalidValue;
  const Geometry g{B, H, W, C, Ho, Wo, Co, stride, dilation};
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  if (outside) {
    err = cudaMemsetAsync(outside, 0, sizeof(int), s);
    if (err != cudaSuccess) return (int)err;
    const int count = N * 18;
    const int blocks = count < 264 * 1024 ? (count + 1023) / 1024 : 264;
    if (dtype == 0)
      deform_window<<<blocks, 256, 0, s>>>((const float*)offsets, count, r,
                                           outside);
    else
      deform_window<<<blocks, 256, 0, s>>>((const bf16*)offsets, count, r,
                                           outside);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (dtype == 0) {
    const dim3 grid((N + BM - 1) / BM, (Co + BN - 1) / BN);
    deform_ffma<<<grid, THREADS, 0, s>>>((const float*)x,
                                         (const float*)offsets,
                                         (const float*)w, outside,
                                         (float*)out, g);
    return (int)cudaGetLastError();
  }
  const int flags = (C % 8 == 0 && (uintptr_t)x % 16 == 0 ? 1 : 0) |
                    (Co % 8 == 0 && (uintptr_t)w % 16 == 0 ? 2 : 0);
  err = Co > wg::N ? launch_wgmma<2>(x, offsets, w, outside, out, partial, g,
                                     splits, flags, s)
                   : launch_wgmma<1>(x, offsets, w, outside, out, partial, g,
                                     splits, flags, s);
  if (err != cudaSuccess || splits == 1) return (int)err;
  const size_t count = (size_t)N * Co;
  deform_reduce<<<(unsigned)((count + 255) / 256), 256, 0, s>>>(
      partial, (bf16*)out, count, splits);
  return (int)cudaGetLastError();
}
