// Deformable convolution (DCNv1) backward: the CUDA counterpart of the
// JAX package's siammot_tpu/ops/deform_conv.py:_pallas_guarded_bwd (line
// 236), the VJP of the exact patch form (route B) whichever route the
// forward took.  JAX leaves it to XLA; here, around cuBLAS's dS = G W^T:
//
//   dKernel = S^T G, S [N, 9C] route B's samples (bit for bit the plain
//               version's and JAX's).  bf16: deform_bwd_dk, an implicit
//               GEMM on Hopper's warpgroup MMA (wgmma.cuh) whose
//               producers sample S on the fly, so S is never written;
//               f32 partial sums over fixed chunks of pixels, added in
//               order and rounded once (deform_bwd_reduce).  f32:
//               deform_bwd_sample writes S and cuBLAS multiplies, f32
//               sums (the sample entry is also the card checks' window
//               onto the samples).
//   dOffsets    per (pixel, tap): the f32 sums over channels of dS times
//               each corner's values, times the f32 derivatives of the
//               corner weights, rounded once (deform_bwd_offsets).
//   dX          the scatter of dS times each corner weight onto the four
//               corners, as a gather: deform_bwd_corners counts the
//               in-range corners on each input pixel, deform_bwd_scan
//               turns the counts into each pixel's list, deform_bwd_corners
//               fills the lists (an integer atomic hands out slots, in
//               arrival order), deform_bwd_sort sorts each list by source
//               (pixel, tap, corner), and deform_bwd_gather sums it in
//               that order into an f32 accumulator, rounded once.  The
//               caller may run dS and the two last kernels over chunks of
//               source pixels, in order, carrying the f32 sums between
//               passes: the same sums, the same bits, half of dS alive.
//
// No float atomics: the gradients are bitwise the same from call to call.
// x [B, H, W, C] and dX NHWC, offsets and dOffsets [B, Ho, Wo, 18]
// tap-major (dy, dx), dS [N, 9C] with N = B Ho Wo, grad [N, Co], dKernel
// [9C, Co], all in one dtype (f32 or bf16).  The arithmetic is
// ops/deform_conv.py:deform_conv2d_bwd_plain's, operation for operation
// (explicit __fmul_rn / __fadd_rn where it matters: the samples and the
// products and sums of dX), but for the order of the f32 sums of the two
// products and of dOffsets' channel sums (fixed, so deterministic).
//
// Bound on the H100: operations, the two products (2 x 2 x 9 C Co
// multiply-adds a pixel).  A block of the product takes about 2.2 us a
// 64-pixel step, with 9 blocks on the card as with 132: without the
// corner loads a third less, without the blend or the MMAs a sixth less
// each; the rest is G's rows and the ring's hand-offs (PERF.md).  The
// offsets kernel and the gather read the corners and dS rows again, four
// times each (a sample's four corners), 8 or 16 bytes a lane, each
// (pixel, tap)'s corners computed once.
#include <limits.h>

#include "common.cuh"
#include "deform_common.cuh"
#include "wgmma.cuh"

namespace {

constexpr int BLOCK = 256;        // threads of the simple kernels
constexpr int SCAN_TILE = 2048;   // counts a scan block (8 a thread)

__device__ __forceinline__ void store(float* p, size_t i, float v) {
  p[i] = v;
}
__device__ __forceinline__ void store(bf16* p, size_t i, float v) {
  p[i] = __float2bfloat16(v);
}

// 16 bytes: 8 bf16 or 4 f32 values
template <typename T>
struct Vec {
  static constexpr int E = 16 / sizeof(T);
};
__device__ __forceinline__ void load_vec(const float* p, float* v) {
  const float4 r = *(const float4*)p;
  v[0] = r.x, v[1] = r.y, v[2] = r.z, v[3] = r.w;
}
__device__ __forceinline__ void load_vec(const bf16* p, float* v) {
  const uint4 r = *(const uint4*)p;
  const __nv_bfloat162* h = (const __nv_bfloat162*)&r;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __low2float(h[i]);
    v[2 * i + 1] = __high2float(h[i]);
  }
}
// each value rounded once to T
__device__ __forceinline__ void store_vec(float* p, const float* v) {
  *(float4*)p = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store_vec(bf16* p, const float* v) {
  __align__(16) __nv_bfloat162 h[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *(uint4*)p = *(const uint4*)h;
}

// E values (4 or 8 bf16, 4 f32): 8 or 16 bytes
template <int E>
__device__ __forceinline__ void load_n(const bf16* p, float* v) {
  if constexpr (E == 8) {
    load_vec(p, v);
  } else {
    const uint2 r = *(const uint2*)p;
    const __nv_bfloat162* h = (const __nv_bfloat162*)&r;
    v[0] = __low2float(h[0]), v[1] = __high2float(h[0]);
    v[2] = __low2float(h[1]), v[3] = __high2float(h[1]);
  }
}
template <int E>
__device__ __forceinline__ void load_n(const float* p, float* v) {
  load_vec(p, v);
}
template <int E>
__device__ __forceinline__ void store_n(bf16* p, const float* v) {
  if constexpr (E == 8) {
    store_vec(p, v);
  } else {
    __align__(8) __nv_bfloat162 h[2] = {
        __floats2bfloat162_rn(v[0], v[1]), __floats2bfloat162_rn(v[2], v[3])};
    *(uint2*)p = *(const uint2*)h;
  }
}
template <int E>
__device__ __forceinline__ void store_n(float* p, const float* v) {
  store_vec(p, v);
}

int grid_for(long long items, int per_block) {
  const long long blocks = (items + per_block - 1) / per_block;
  return (int)(blocks < (1 << 20) ? blocks : 1 << 20);
}

// -- S (f32 route, and the checks' window) --------------------------------
// S[n, tap, :] = route B's samples.  A block takes `ipb` (at most BLOCK)
// (pixel, tap) items at a time: as many threads compute one item's
// corners each into shared memory, then the block writes their rows, a
// 16-byte vector a thread where V.
template <typename T, bool V>
__global__ void __launch_bounds__(BLOCK)
    deform_bwd_sample(const T* __restrict__ x, const T* __restrict__ off,
                      T* __restrict__ s, Geometry g, int ipb) {
  constexpr int E = V ? Vec<T>::E : 1;
  __shared__ int4 s_at[BLOCK];
  __shared__ float4 s_k[BLOCK];
  const int t = threadIdx.x;
  const int items = g.B * g.Ho * g.Wo * 9, per = g.C / E;
  for (int base = blockIdx.x * ipb; base < items; base += gridDim.x * ipb) {
    __syncthreads();  // the last round's corners consumed
    if (t < ipb && base + t < items) {
      const int it = base + t;
      const Corners cr = corners<T>(off, g, it / 9, it % 9, false);
      s_at[t] = make_int4(cr.at[0], cr.at[1], cr.at[2], cr.at[3]);
      s_k[t] = make_float4(cr.k[0], cr.k[1], cr.k[2], cr.k[3]);
    }
    __syncthreads();
    const int live = min(ipb, items - base);
    for (int e = t; e < live * per; e += BLOCK) {
      const int j = e / per, c = (e % per) * E;
      const int4 a4 = s_at[j];
      const float4 k4 = s_k[j];
      const int at[4] = {a4.x, a4.y, a4.z, a4.w};
      const float k[4] = {k4.x, k4.y, k4.z, k4.w};
      T* row = s + (size_t)(base + j) * g.C;
      if constexpr (V) {
        float v[4][E], out[E];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (at[i] >= 0)
            load_vec(x + at[i] + c, v[i]);
          else
#pragma unroll
            for (int q = 0; q < E; ++q) v[i][q] = 0.f;
        }
#pragma unroll
        for (int q = 0; q < E; ++q) {
          const float cv[4] = {v[0][q], v[1][q], v[2][q], v[3][q]};
          out[q] = blend(cv, k, false);
        }
        store_vec(row + c, out);
      } else {
        store(row, c, sample<T>(x, at, k, c, false));
      }
    }
  }
}

// -- dKernel in bf16: deform_bwd_dk -------------------------------------
// dK[tap, c, co] = sum over pixels n of S[n, tap, c] G[n, co]: M = the
// (tap, channel) rows, N = Co, K = the pixels.  A block owns one tap's MC
// channels and NT 128-column tiles of Co (MC = 128, NT = 1 for Co <= 128;
// MC = 64, NT = 2 past it, so a sample is taken once for 256 columns),
// and one chunk of the pixels, which it walks 64 at a time through a
// 4-stage ring.  Two producer warpgroups make each pixel's corners for the
// tap once (corners()), gather 8 channels a 16-byte load per corner and
// blend() them element by element, so every sample is bit for bit the
// sample kernel's, and write the chunk [64 pixels][MC channels] (128-byte
// rows, 128-byte swizzle) beside G's rows [64 pixels][128 NT columns]
// (cp.async, wgmma.cuh's B layout as it lies in memory); two consumer
// warpgroups load A transposed (ldmatrix .trans: rows = channels) and run
// m64n128k16 wgmma.  The f32 sums go to a partial per chunk of pixels
// (deform_bwd_reduce adds them in chunk order), or straight to bf16 where
// there is one chunk.
template <int NT>
struct Dk {
  static constexpr int MC = 128 / NT;             // channels a block
  static constexpr int KP = 64;                   // pixels a stage
  static constexpr int STAGES = 4;
  static constexpr int A_HALF = KP * 64 * 2;      // [64 px][64 ch]
  static constexpr int A_BYTES = A_HALF * (MC / 64);
  static constexpr int B_TILE = KP * wg::N * 2;   // [64 px][128 co]
  static constexpr int STAGE_BYTES = A_BYTES + NT * B_TILE;
  static constexpr int CONSUMER_WARPS = 8;        // two warpgroups
  static constexpr int PRODUCERS = 256;           // two warpgroups sample
  static constexpr int VECS = MC / 8;             // 8-channel vectors
  static constexpr int ITEMS = KP * VECS / PRODUCERS;  // (pixel, vector)s
  static constexpr int THREADS = 32 * CONSUMER_WARPS + PRODUCERS;
  static constexpr size_t SMEM =
      (size_t)STAGES * STAGE_BYTES + 2 * KP * 32 + 1024;
};

// flags: bit 0 x 16-byte loads (C % 8 == 0, x aligned), bit 1 G by
// cp.async (Co % 8 == 0, grad aligned)
template <int NT>
__global__ void __launch_bounds__(Dk<NT>::THREADS, 1)
    deform_bwd_dk(const bf16* __restrict__ x, const bf16* __restrict__ off,
                  const bf16* __restrict__ grad, bf16* __restrict__ dk,
                  float* __restrict__ partial, Geometry g, int splits,
                  int flags) {
  using D = Dk<NT>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring =
      (unsigned char*)(((uintptr_t)smem_raw + 1023) & ~(uintptr_t)1023);
  __shared__ uint64_t full[D::STAGES], empty[D::STAGES];
  // two stages' corners of (pixel): element offsets and coefficients
  int4* s_at = (int4*)(ring + D::STAGES * D::STAGE_BYTES);
  float4* s_k = (float4*)(s_at + 2 * D::KP);

  const int t = threadIdx.x, warp = t / 32, lane = t % 32;
  const int cblocks = (g.C + D::MC - 1) / D::MC;
  const int tap = blockIdx.x / cblocks, c0 = blockIdx.x % cblocks * D::MC;
  const int co0 = blockIdx.y * wg::N * NT;
  const int N = g.B * g.Ho * g.Wo;
  const int kb = (N + D::KP - 1) / D::KP;
  const int kb0 = (int)((long long)blockIdx.z * kb / splits);
  const int steps = (int)((long long)(blockIdx.z + 1) * kb / splits) - kb0;
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
    // producers: thread pt samples channels c0 + 8 (pt % VECS).. of the
    // stage's pixels pt / VECS + (PRODUCERS / VECS) i.  Threads pt < KP
    // make the next step's corners while the step's corner loads are in
    // flight; a barrier of the producers ends each step (the corners
    // made are in, the buffer written next has been read).
    const int pt = t - 32 * D::CONSUMER_WARPS, v = pt % D::VECS;
    const int c = c0 + 8 * v;
    auto make_corners = [&](int s) {
      const int n = (kb0 + s) * D::KP + pt;
      Corners cr;
      if (n < N) {
        cr = corners<bf16>(off, g, n, tap, false);
      } else {
        for (int i = 0; i < 4; ++i) cr.at[i] = -1, cr.k[i] = 0.f;
      }
      s_at[(s & 1) * D::KP + pt] =
          make_int4(cr.at[0], cr.at[1], cr.at[2], cr.at[3]);
      s_k[(s & 1) * D::KP + pt] =
          make_float4(cr.k[0], cr.k[1], cr.k[2], cr.k[3]);
    };
    if (steps > 0 && pt < D::KP) make_corners(0);
    wg::named_sync(1, D::PRODUCERS);
    const bool vec = (flags & 1) && c < g.C;
    int stage = 0;
    uint32_t phase = 1;
    for (int s = 0; s < steps; ++s) {
      const int n0 = (kb0 + s) * D::KP;
      const int4* at_s = s_at + (s & 1) * D::KP;
      const float4* k_s = s_k + (s & 1) * D::KP;
      uint4 raw[D::ITEMS][4];
      if (vec) {
#pragma unroll
        for (int i = 0; i < D::ITEMS; ++i) {
          const int4 at = at_s[pt / D::VECS + D::PRODUCERS / D::VECS * i];
          const int a4[4] = {at.x, at.y, at.z, at.w};
#pragma unroll
          for (int j = 0; j < 4; ++j)
            raw[i][j] = a4[j] >= 0 ? *(const uint4*)(x + a4[j] + c)
                                   : make_uint4(0, 0, 0, 0);
        }
      }
      if (s + 1 < steps && pt < D::KP) make_corners(s + 1);
      wg::mbar_wait(&empty[stage], phase);
      const uint32_t b_at = ring_at + stage * D::STAGE_BYTES + D::A_BYTES;
      // B: G's rows n0.., columns co0..
      if (flags & 2) {
        for (int e = pt; e < D::KP * 16 * NT; e += D::PRODUCERS) {
          const int r = e / (16 * NT), q = e % (16 * NT);
          const int n = n0 + r, co = co0 + q * 8;
          const bool in = n < N && co < g.Co;
          wg::cp_async16(
              b_at + (q / 16) * D::B_TILE + wg::b_offset(r, q % 16, D::KP),
              in ? grad + (size_t)n * g.Co + co : grad, in ? 16 : 0);
        }
      } else {
        bf16* b = (bf16*)(ring + stage * D::STAGE_BYTES + D::A_BYTES);
        for (int e = pt; e < D::KP * wg::N * NT; e += D::PRODUCERS) {
          const int r = e / (wg::N * NT), col = e % (wg::N * NT);
          const int n = n0 + r, co = co0 + col;
          b[(col / wg::N) * D::B_TILE / 2 +
            wg::b_offset(r, col % wg::N / 8, D::KP) / 2 + col % 8] =
              n < N && co < g.Co ? grad[(size_t)n * g.Co + co]
                                 : __float2bfloat16(0.f);
        }
      }
      wg::cp_async_arrive(&full[stage]);
      // A: 64 pixels x MC channels of samples, [pixel][64 ch] halves
      unsigned char* a_tile =
          ring + stage * D::STAGE_BYTES + (v / 8) * D::A_HALF;
      const int chunk = v % 8;
      if (vec) {
#pragma unroll
        for (int i = 0; i < D::ITEMS; ++i) {
          const int m = pt / D::VECS + D::PRODUCERS / D::VECS * i;
          const float4 k4 = k_s[m];
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
            vals[e / 2] = __floats2bfloat162_rn(blend(cv[0], k, false),
                                                blend(cv[1], k, false));
          }
          *(uint4*)(a_tile + m * 128 + ((chunk ^ (m & 7)) << 4)) =
              *(const uint4*)vals;
        }
      } else {
        for (int i = 0; i < D::ITEMS; ++i) {
          const int m = pt / D::VECS + D::PRODUCERS / D::VECS * i;
          const int4 at4 = at_s[m];
          const float4 k4 = k_s[m];
          const int at[4] = {at4.x, at4.y, at4.z, at4.w};
          const float k[4] = {k4.x, k4.y, k4.z, k4.w};
          __align__(16) bf16 vals[8];
          for (int e = 0; e < 8; ++e)
            vals[e] = __float2bfloat16(
                c + e < g.C ? sample<bf16>(x, at, k, c + e, false) : 0.f);
          *(uint4*)(a_tile + m * 128 + ((chunk ^ (m & 7)) << 4)) =
              *(const uint4*)vals;
        }
      }
      wg::mbar_arrive(&full[stage]);
      if (++stage == D::STAGES) {
        stage = 0;
        phase ^= 1;
      }
      wg::named_sync(1, D::PRODUCERS);
    }
    wg::cp_async_wait<0>();  // leave no copy in flight
    return;
  }

  // consumers: warpgroup gq takes the A half gq (NT = 1) or the B tile gq
  // (NT = 2); its warp wq the 16 channels from 16 wq of that half.
  // ldmatrix .trans: lane l addresses pixel row 16 ks + l % 8 + 8 (l / 16)
  // at the 16-byte chunk of channels 16 wq + 8 (l / 8 % 2)
  const int gq = warp / 4, wq = warp % 4;
  const int a_off = NT == 1 ? gq * D::A_HALF : 0;
  const int b_off = D::A_BYTES + (NT == 1 ? 0 : gq * D::B_TILE);
  const int chunk = 2 * wq + (lane / 8) % 2;
  float d[wg::ACC];
#pragma unroll
  for (int i = 0; i < wg::ACC; ++i) d[i] = 0.f;
  int stage = 0;
  uint32_t phase = 0;
  for (int it = 0; it < steps; ++it) {
    wg::mbar_wait(&full[stage], phase);
    wg::fence_proxy_async();
    const uint32_t st_at = ring_at + stage * D::STAGE_BYTES;
    uint32_t a[D::KP / 16][4];
#pragma unroll
    for (int ks = 0; ks < D::KP / 16; ++ks) {
      const int row = 16 * ks + lane % 8 + 8 * (lane / 16);
      wg::ldmatrix_x4_trans(
          a[ks], st_at + a_off + row * 128 + ((chunk ^ (row & 7)) << 4));
    }
    wg::fence();
#pragma unroll
    for (int ks = 0; ks < D::KP / 16; ++ks)
      wg::mma(d, a[ks], wg::b_desc(st_at + b_off + ks * 2048, D::KP));
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

  // d[i]: channel row 16 wq + lane / 4 + 8 ((i / 2) % 2) of the
  // warpgroup's 64, column 8 (i / 4) + 2 (lane % 4) + i % 2
  const int cr0 = c0 + (NT == 1 ? 64 * gq : 0) + 16 * wq + lane / 4;
  const size_t rows = (size_t)9 * g.C;
#pragma unroll
  for (int i = 0; i < wg::ACC; i += 2) {
    const int c = cr0 + 8 * ((i / 2) % 2);
    const int co = co0 + (NT == 1 ? 0 : wg::N * gq) + 8 * (i / 4) +
                   2 * (lane % 4);
    if (c >= g.C || co >= g.Co) continue;
    const size_t at = ((size_t)tap * g.C + c) * g.Co + co;
    if (splits == 1) {
      dk[at] = __float2bfloat16(d[i]);
      if (co + 1 < g.Co) dk[at + 1] = __float2bfloat16(d[i + 1]);
    } else {
      float* o = partial + (size_t)blockIdx.z * rows * g.Co + at;
      o[0] = d[i];
      if (co + 1 < g.Co) o[1] = d[i + 1];
    }
  }
}

// dk = bf16(sum over the chunks of the partial sums), in chunk order
__global__ void deform_bwd_reduce(const float* __restrict__ partial,
                                  bf16* __restrict__ dk, size_t count,
                                  int splits) {
  const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= count) return;
  float s = partial[e];
  for (int i = 1; i < splits; ++i) s += partial[i * count + e];
  dk[e] = __float2bfloat16(s);
}

template <int NT>
cudaError_t dk_launch(const void* x, const void* offsets, const void* grad,
                      void* dk, float* partial, const Geometry& g,
                      int splits, int flags, cudaStream_t st) {
  using D = Dk<NT>;
  static bool opted_in = false;  // once, outside any graph capture
  if (!opted_in) {
    const cudaError_t err = set_smem(deform_bwd_dk<NT>, D::SMEM);
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  const dim3 grid(9 * ((g.C + D::MC - 1) / D::MC),
                  (g.Co + wg::N * NT - 1) / (wg::N * NT), splits);
  deform_bwd_dk<NT><<<grid, D::THREADS, D::SMEM, st>>>(
      (const bf16*)x, (const bf16*)offsets, (const bf16*)grad, (bf16*)dk,
      partial, g, splits, flags);
  return cudaGetLastError();
}

// -- the input gradient's lists -----------------------------------------
// Per (pixel, tap), a thread: with list null, count[pixel] += the
// in-range corners there; else the source id 4 (9 n + tap) + corner of
// each in-range corner put into its input pixel's list (count holds the
// counts and goes back to 0), and the four corner weights into coef.
// The lanes of a warp that hit one pixel with a corner share one atomic
// (the warp's items are neighbours: its 32 taps land on few pixels).
template <typename T>
__global__ void __launch_bounds__(BLOCK)
    deform_bwd_corners(const T* __restrict__ off, int* __restrict__ count,
                       const int* __restrict__ start, int* __restrict__ list,
                       float* __restrict__ coef, Geometry g) {
  const int items = g.B * g.Ho * g.Wo * 9, lane = threadIdx.x % 32;
  for (int base = (blockIdx.x * BLOCK + threadIdx.x) / 32 * 32; base < items;
       base += gridDim.x * BLOCK) {
    const int it = base + lane;
    Corners cr;
    for (int i = 0; i < 4; ++i) cr.at[i] = -1, cr.k[i] = 0.f;
    if (it < items) cr = corners<T>(off, g, it / 9, it % 9, false);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int q = cr.at[i] < 0 ? -1 : cr.at[i] / g.C;
      const unsigned same = __match_any_sync(0xffffffff, q);
      const int lead = __ffs(same) - 1;
      const int n = __popc(same), rank = __popc(same & ((1u << lane) - 1));
      int old = 0;
      if (q >= 0 && lane == lead)
        old = list ? atomicSub(&count[q], n) : atomicAdd(&count[q], n);
      old = __shfl_sync(0xffffffff, old, lead);
      if (q >= 0 && list) list[start[q] + old - 1 - rank] = 4 * it + i;
    }
    if (list && it < items)
      *(float4*)(coef + 4 * (size_t)it) =
          make_float4(cr.k[0], cr.k[1], cr.k[2], cr.k[3]);
  }
}

// the block's sum of one int a thread (every thread gets it)
__device__ int block_sum(int v, int* red) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffff, v, o);
  __syncthreads();  // red free
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = 0;
  for (int w = 0; w < BLOCK / 32; ++w) v += red[w];
  return v;
}

// sums[b] = the sum of count over tile b (SCAN_TILE counts)
__global__ void __launch_bounds__(BLOCK)
    deform_bwd_scan_sums(const int* __restrict__ count, int* __restrict__ sums,
                         int P) {
  __shared__ int red[BLOCK / 32];
  const int a = blockIdx.x * SCAN_TILE + threadIdx.x * (SCAN_TILE / BLOCK);
  int v = 0;
  for (int i = a; i < min(P, a + SCAN_TILE / BLOCK); ++i) v += count[i];
  v = block_sum(v, red);
  if (threadIdx.x == 0) sums[blockIdx.x] = v;
}

// start[0 .. P] = the exclusive prefix sums of count: tile b adds the sum
// of tiles 0 .. b-1 (a block reduce of sums) to its own scan (each thread
// a run of 8, then a scan of the runs over the block)
__global__ void __launch_bounds__(BLOCK)
    deform_bwd_scan(const int* __restrict__ count,
                    const int* __restrict__ sums, int* __restrict__ start,
                    int P) {
  constexpr int RUN = SCAN_TILE / BLOCK;
  __shared__ int red[BLOCK / 32];
  const int t = threadIdx.x, lane = t % 32, warp = t / 32;
  int before = 0;
  for (int b = t; b < blockIdx.x; b += BLOCK) before += sums[b];
  before = block_sum(before, red);
  const int a = blockIdx.x * SCAN_TILE + t * RUN;
  int v[RUN], run = 0;
#pragma unroll
  for (int i = 0; i < RUN; ++i) {
    v[i] = a + i < P ? count[a + i] : 0;
    run += v[i];
  }
  // inclusive scan of the runs: in the warp, then over the warps
  int inc = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(0xffffffff, inc, o);
    if (lane >= o) inc += u;
  }
  __syncthreads();  // red free
  if (lane == 31) red[warp] = inc;
  __syncthreads();
  int at = before + inc - run;
  for (int w = 0; w < warp; ++w) at += red[w];
#pragma unroll
  for (int i = 0; i < RUN; ++i) {
    if (a + i < P) start[a + i] = at;
    at += v[i];
  }
  if (a < P && a + RUN >= P) start[P] = at;  // the thread holding the end
}

// Per input pixel (a warp): its list sorted ascending.  Up to 64 entries
// in registers, two a lane (entry lane + 32 r), by a bitonic network over
// 64 with the missing tail +inf; longer lists by the same network in
// place in global memory.
__global__ void __launch_bounds__(BLOCK)
    deform_bwd_sort(const int* __restrict__ start, int* __restrict__ list,
                    int P) {
  const int lane = threadIdx.x % 32;
  constexpr int WARPS = BLOCK / 32;
  for (int q = blockIdx.x * WARPS + threadIdx.x / 32; q < P;
       q += gridDim.x * WARPS) {
    const int a = start[q], len = start[q + 1] - a;
    int* seg = list + a;
    if (len < 2) continue;
    if (len <= 64) {
      int v[2];
#pragma unroll
      for (int r = 0; r < 2; ++r)
        v[r] = lane + 32 * r < len ? seg[lane + 32 * r] : INT_MAX;
#pragma unroll
      for (int k = 2; k <= 64; k <<= 1)
#pragma unroll
        for (int j = k / 2; j; j >>= 1) {
          if (j == 32) {  // entries lane and lane + 32; k = 64: ascending
            const int lo = min(v[0], v[1]), hi = max(v[0], v[1]);
            v[0] = lo;
            v[1] = hi;
          } else {
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const int e = lane + 32 * r;
              const int o = __shfl_xor_sync(0xffffffff, v[r], j);
              const bool up = (e & k) == 0, first = (e & j) == 0;
              v[r] = first == up ? min(v[r], o) : max(v[r], o);
            }
          }
        }
#pragma unroll
      for (int r = 0; r < 2; ++r)
        if (lane + 32 * r < len) seg[lane + 32 * r] = v[r];
      continue;
    }
    for (int k = 2; k / 2 < len; k <<= 1)
      for (int j = k / 2; j; j >>= 1) {
        for (int i = lane; i < len; i += 32) {
          const int p = j == k / 2 ? i ^ (k - 1) : i ^ j;
          if (p > i && p < len) {
            const int u = seg[i], w = seg[p];
            if (u > w) {
              seg[i] = w;
              seg[p] = u;
            }
          }
        }
        __syncwarp();  // orders the warp's global accesses too
      }
  }
}

// -- dOffsets and dX from dS ---------------------------------------------
// Items item0 .. item1 (pixel n0's tap 0 up to pixel n1's), dS holding
// their rows from row 0.  A block takes BLOCK / lanes x rounds items at a
// time: each of as many threads computes one item's corners into shared
// memory; then groups of `lanes` lanes (a power of two) take one item
// each a round, a lane 16 bytes of channels at a time where V: gw[i] =
// the sum over channels of dS times corner i's values (0 where it is out
// of range), in f32, each lane's channels in order, then a shuffle tree
// over the group.  (Fewer rounds give a small layer more blocks.)
template <typename T, bool V>
__global__ void __launch_bounds__(BLOCK)
    deform_bwd_offsets(const T* __restrict__ x, const T* __restrict__ off,
                       const T* __restrict__ ds, T* __restrict__ doff,
                       Geometry g, int item0, int item1, int lanes,
                       int rounds) {
  constexpr int E = V ? Vec<T>::E : 1;
  __shared__ int4 s_at[BLOCK];
  __shared__ float2 s_f[BLOCK];
  const int t = threadIdx.x, gl = t % 32 % lanes;
  const int group = t / lanes, groups = BLOCK / lanes;
  const int per = groups * rounds;
  for (int base = item0 + blockIdx.x * per; base < item1;
       base += gridDim.x * per) {
    __syncthreads();  // the last round's corners consumed
    if (t < per && base + t < item1) {
      const int it = base + t;
      const Corners cr = corners<T>(off, g, it / 9, it % 9, false);
      s_at[t] = make_int4(cr.at[0], cr.at[1], cr.at[2], cr.at[3]);
      s_f[t] = make_float2(cr.f[0], cr.f[1]);
    }
    __syncthreads();
    for (int r = 0; r < rounds; ++r) {
      const int j = group + r * groups, it = base + j;
      float gw[4] = {0.f, 0.f, 0.f, 0.f};
      if (it < item1) {
        const int4 a4 = s_at[j];
        const int at[4] = {a4.x, a4.y, a4.z, a4.w};
        const T* drow = ds + (size_t)(it - item0) * g.C;
        for (int c = gl * E; c < g.C; c += lanes * E) {
          float d[E], v[E];
          if constexpr (V)
            load_vec(drow + c, d);
          else
            d[0] = load_f32(drow, c);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            if (at[i] < 0) continue;
            if constexpr (V)
              load_vec(x + at[i] + c, v);
            else
              v[0] = load_f32(x, at[i] + c);
#pragma unroll
            for (int q = 0; q < E; ++q) gw[i] = fmaf(d[q], v[q], gw[i]);
          }
        }
      }
      for (int o = lanes / 2; o; o >>= 1)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          gw[i] += __shfl_xor_sync(0xffffffff, gw[i], o);
      if (it < item1 && gl == 0) {
        // the corner weights (1-fy)(1-fx), (1-fy)fx, fy(1-fx), fy fx
        // differentiated in f32
        const float fy = s_f[j].x, fx = s_f[j].y;
        const float ay = __fsub_rn(1.f, fy), ax = __fsub_rn(1.f, fx);
        const float dy =
            __fsub_rn(__fadd_rn(__fmul_rn(gw[2], ax), __fmul_rn(gw[3], fx)),
                      __fadd_rn(__fmul_rn(gw[0], ax), __fmul_rn(gw[1], fx)));
        const float dx =
            __fsub_rn(__fadd_rn(__fmul_rn(gw[1], ay), __fmul_rn(gw[3], fy)),
                      __fadd_rn(__fmul_rn(gw[0], ay), __fmul_rn(gw[2], fy)));
        store(doff, (size_t)it * 2, rnd<T>(dy));
        store(doff, (size_t)it * 2 + 1, rnd<T>(dx));
      }
    }
  }
}

// Per input pixel q and chunk of 32 E channels (a warp): the entries of
// q's sorted list with source id in [lo, hi) (dS rows from item0), in
// order: dX[q, c] = acc + the sum of dS[source, c] * coef[source], from
// acc_in (or 0) in f32, to acc_out (f32) or to dx, rounded once.  A lane
// holds E channels: 8 or 16 bytes where V (so that 32 lanes cover C = 128
// in bf16), else 4 channels 32 apart; the list goes 32 entries at a time,
// 32 / E rows' loads in flight before their sums.
template <typename T, int E, bool V>
__global__ void __launch_bounds__(BLOCK)
    deform_bwd_gather(const T* __restrict__ ds, const int* __restrict__ start,
                      const int* __restrict__ list,
                      const float* __restrict__ coef,
                      const float* acc_in, float* acc_out,  // may alias
                      T* __restrict__ dx, int P, int C, int lo, int hi,
                      int item0) {
  constexpr int WARPS = BLOCK / 32, U = 32 / E;  // rows in flight
  const int lane = threadIdx.x % 32;
  const int chunks = (C + 32 * E - 1) / (32 * E);
  for (int unit = blockIdx.x * WARPS + threadIdx.x / 32; unit < P * chunks;
       unit += gridDim.x * WARPS) {
    const int q = unit / chunks, c0 = unit % chunks * 32 * E;
    const int a = start[q], len = start[q + 1] - a;
    const int* seg = list + a;
    // the entries below lo and below hi
    int i0 = 0, i1 = 0;
    for (int b = 0; b < len; b += 32) {
      const int id = b + lane < len ? seg[b + lane] : INT_MAX;
      const unsigned lo_m = __ballot_sync(0xffffffff, id < lo);
      const unsigned hi_m = __ballot_sync(0xffffffff, id < hi);
      i0 += __popc(lo_m);
      i1 += __popc(hi_m);
      if (hi_m != 0xffffffffu) break;
    }
    const int cl = V ? c0 + lane * E : c0 + lane;
    int ch[E];
    float acc[E];
#pragma unroll
    for (int e = 0; e < E; ++e) {
      ch[e] = V ? cl + e : cl + 32 * e;
      acc[e] = acc_in && ch[e] < C ? acc_in[(size_t)q * C + ch[e]] : 0.f;
    }
    for (int b = i0; b < i1; b += 32) {
      const int mine = b + lane < i1 ? seg[b + lane] : 0;
      const float w_mine = b + lane < i1 ? coef[mine] : 0.f;
      const int cnt = min(32, i1 - b);
      for (int j = 0; j < cnt; j += U) {
        float v[U][E], w[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int src = __shfl_sync(0xffffffff, mine, (j + u) & 31);
          w[u] = __shfl_sync(0xffffffff, w_mine, (j + u) & 31);
          const T* row = ds + (size_t)(src / 4 - item0) * C;
          if constexpr (V) {
            if (j + u < cnt && cl < C)
              load_n<E>(row + cl, v[u]);
            else
#pragma unroll
              for (int e = 0; e < E; ++e) v[u][e] = 0.f;
          } else {
#pragma unroll
            for (int e = 0; e < E; ++e)
              v[u][e] = j + u < cnt && ch[e] < C ? load_f32(row, ch[e])
                                                 : 0.f;
          }
        }
#pragma unroll
        for (int u = 0; u < U; ++u)
          if (j + u < cnt)
#pragma unroll
            for (int e = 0; e < E; ++e)
              acc[e] = __fadd_rn(acc[e], __fmul_rn(v[u][e], w[u]));
      }
    }
    if (acc_out) {
#pragma unroll
      for (int e = 0; e < E; ++e)
        if (ch[e] < C) acc_out[(size_t)q * C + ch[e]] = acc[e];
    } else if constexpr (V) {
      if (cl < C) store_n<E>(dx + (size_t)q * C + cl, acc);
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e)
        if (ch[e] < C) store(dx, (size_t)q * C + ch[e], acc[e]);
    }
  }
}

bool aligned16(const void* p) { return (uintptr_t)p % 16 == 0; }

template <typename T>
cudaError_t scatter_launch(const void* x, const void* offsets, const void* ds,
                           void* doff, const int* start, const int* list,
                           const float* coef, const float* acc_in,
                           float* acc_out, void* dx, const Geometry& g,
                           int n0, int n1, cudaStream_t st) {
  constexpr int E = Vec<T>::E;
  const bool vec = g.C % E == 0 && aligned16(x) && aligned16(ds) &&
                   (!dx || aligned16(dx));
  if (doff) {
    int lanes = 1;
    while (lanes < 32 && lanes * (vec ? E : 1) < g.C) lanes *= 2;
    // rounds: up to `lanes` (a corner a thread), fewer while that leaves
    // fewer than 4 blocks an SM
    const long long items = 9LL * (n1 - n0);
    int rounds = lanes;
    while (rounds > 1 &&
           (items + BLOCK / lanes * rounds - 1) / (BLOCK / lanes * rounds) <
               4 * 132)
      rounds /= 2;
    const int blocks = grid_for(items, BLOCK / lanes * rounds);
    if (vec)
      deform_bwd_offsets<T, true><<<blocks, BLOCK, 0, st>>>(
          (const T*)x, (const T*)offsets, (const T*)ds, (T*)doff, g, 9 * n0,
          9 * n1, lanes, rounds);
    else
      deform_bwd_offsets<T, false><<<blocks, BLOCK, 0, st>>>(
          (const T*)x, (const T*)offsets, (const T*)ds, (T*)doff, g, 9 * n0,
          9 * n1, lanes, rounds);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (acc_out || dx) {
    const int P = g.B * g.H * g.W;
    // 8 bytes a lane where 32 of them cover the channels, else 16
    const bool half = vec && E == 8 && g.C <= 128;
    const int width = 32 * (half || !vec ? 4 : E);
    const int blocks =
        grid_for((long long)P * ((g.C + width - 1) / width), BLOCK / 32);
    const T* d = (const T*)ds;
    if (half)
      deform_bwd_gather<T, 4, true><<<blocks, BLOCK, 0, st>>>(
          d, start, list, coef, acc_in, acc_out, (T*)dx, P, g.C, 36 * n0,
          36 * n1, 9 * n0);
    else if (vec)
      deform_bwd_gather<T, E, true><<<blocks, BLOCK, 0, st>>>(
          d, start, list, coef, acc_in, acc_out, (T*)dx, P, g.C, 36 * n0,
          36 * n1, 9 * n0);
    else
      deform_bwd_gather<T, 4, false><<<blocks, BLOCK, 0, st>>>(
          d, start, list, coef, acc_in, acc_out, (T*)dx, P, g.C, 36 * n0,
          36 * n1, 9 * n0);
    return cudaGetLastError();
  }
  return cudaSuccess;
}

}  // namespace

// Route B's samples s [N, 9C] (the f32 route's dKernel operand, and the
// checks' window onto the samples).  dtype 0 = float32, 1 = bfloat16.
SIAMMOT_API int siammot_deform_bwd_sample(const void* x, const void* offsets,
                                          void* s, int B, int H, int W, int C,
                                          int Ho, int Wo, int stride,
                                          int dilation, int dtype,
                                          void* stream) {
  if (C < 1 || stride < 1 || dilation < 1) return (int)cudaErrorInvalidValue;
  const Geometry g{B, H, W, C, Ho, Wo, 0, stride, dilation};
  cudaStream_t st = (cudaStream_t)stream;
  const long long items = (long long)B * Ho * Wo * 9;
  if (items == 0) return 0;
  // BLOCK items a block, fewer while that leaves fewer than 4 blocks an SM
  int ipb = BLOCK;
  while (ipb > 32 && (items + ipb - 1) / ipb < 4 * 132) ipb /= 2;
  const int blocks = grid_for(items, ipb);
  if (dtype) {
    if (C % 8 == 0 && aligned16(x) && aligned16(s))
      deform_bwd_sample<bf16, true><<<blocks, BLOCK, 0, st>>>(
          (const bf16*)x, (const bf16*)offsets, (bf16*)s, g, ipb);
    else
      deform_bwd_sample<bf16, false><<<blocks, BLOCK, 0, st>>>(
          (const bf16*)x, (const bf16*)offsets, (bf16*)s, g, ipb);
  } else {
    if (C % 4 == 0 && aligned16(x) && aligned16(s))
      deform_bwd_sample<float, true><<<blocks, BLOCK, 0, st>>>(
          (const float*)x, (const float*)offsets, (float*)s, g, ipb);
    else
      deform_bwd_sample<float, false><<<blocks, BLOCK, 0, st>>>(
          (const float*)x, (const float*)offsets, (float*)s, g, ipb);
  }
  return (int)cudaGetLastError();
}

// dKernel [9C, Co] in bf16 from x, offsets and grad [N, Co] (bf16): the
// pixels split over `splits` chunks, partial f32 [splits, 9C, Co] when
// splits > 1.
SIAMMOT_API int siammot_deform_bwd_dkernel(const void* x, const void* offsets,
                                           const void* grad, void* dk,
                                           float* partial, int B, int H,
                                           int W, int C, int Ho, int Wo,
                                           int Co, int stride, int dilation,
                                           int splits, void* stream) {
  if (C < 1 || Co < 1 || stride < 1 || dilation < 1 || splits < 1)
    return (int)cudaErrorInvalidValue;
  const Geometry g{B, H, W, C, Ho, Wo, Co, stride, dilation};
  cudaStream_t st = (cudaStream_t)stream;
  const int flags = (C % 8 == 0 && aligned16(x) ? 1 : 0) |
                    (Co % 8 == 0 && aligned16(grad) ? 2 : 0);
  cudaError_t err =
      Co > wg::N
          ? dk_launch<2>(x, offsets, grad, dk, partial, g, splits, flags, st)
          : dk_launch<1>(x, offsets, grad, dk, partial, g, splits, flags, st);
  if (err != cudaSuccess || splits == 1) return (int)err;
  const size_t count = (size_t)9 * C * Co;
  deform_bwd_reduce<<<(unsigned)((count + 255) / 256), 256, 0, st>>>(
      partial, (bf16*)dk, count, splits);
  return (int)cudaGetLastError();
}

// The input gradient's sorted lists: count int [B H W] (scratch), start
// int [B H W + 1 + scan tiles] (the prefix sums, then the tiles' sums),
// list int and coef float [36 N].
SIAMMOT_API int siammot_deform_bwd_lists(const void* offsets, int* count,
                                         int* start, int* list, float* coef,
                                         int B, int H, int W, int C, int Ho,
                                         int Wo, int stride, int dilation,
                                         int dtype, void* stream) {
  if (C < 1 || stride < 1 || dilation < 1) return (int)cudaErrorInvalidValue;
  const Geometry g{B, H, W, C, Ho, Wo, 0, stride, dilation};
  cudaStream_t st = (cudaStream_t)stream;
  const int P = B * H * W;
  if (P == 0) return 0;
  cudaError_t err = cudaMemsetAsync(count, 0, sizeof(int) * (size_t)P, st);
  if (err != cudaSuccess) return (int)err;
  const long long items = (long long)B * Ho * Wo * 9;
  const int blocks = grid_for(items, BLOCK);
  for (int pass = 0; pass < 2; ++pass) {
    if (pass == 1) {
      const int tiles = (P + SCAN_TILE - 1) / SCAN_TILE;
      int* sums = start + P + 1;
      deform_bwd_scan_sums<<<tiles, BLOCK, 0, st>>>(count, sums, P);
      if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
      deform_bwd_scan<<<tiles, BLOCK, 0, st>>>(count, sums, start, P);
      if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    }
    if (items) {
      if (dtype)
        deform_bwd_corners<bf16><<<blocks, BLOCK, 0, st>>>(
            (const bf16*)offsets, count, start, pass ? list : nullptr, coef,
            g);
      else
        deform_bwd_corners<float><<<blocks, BLOCK, 0, st>>>(
            (const float*)offsets, count, start, pass ? list : nullptr, coef,
            g);
      if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    }
  }
  deform_bwd_sort<<<grid_for(P, BLOCK / 32), BLOCK, 0, st>>>(start, list, P);
  return (int)cudaGetLastError();
}

// One pass over the source pixels n0 .. n1, after dS's rows of those
// pixels (ds [n1 - n0, 9C]): doff [B, Ho, Wo, 18] rows, or null; and,
// where acc_out or dx, dX's sums over the lists' entries from those
// pixels (start, list, coef from siammot_deform_bwd_lists), from acc_in
// (f32 [B H W, C], or null: 0) to acc_out (f32, the next pass's acc_in)
// or to dx [B, H, W, C].
SIAMMOT_API int siammot_deform_bwd_scatter(
    const void* x, const void* offsets, const void* ds, void* doff,
    const int* start, const int* list, const float* coef,
    const float* acc_in, float* acc_out, void* dx, int n0, int n1, int B,
    int H, int W, int C, int Ho, int Wo, int stride, int dilation, int dtype,
    void* stream) {
  if (C < 1 || stride < 1 || dilation < 1 || n0 < 0 || n1 < n0 ||
      n1 > B * Ho * Wo)
    return (int)cudaErrorInvalidValue;
  const Geometry g{B, H, W, C, Ho, Wo, 0, stride, dilation};
  cudaStream_t st = (cudaStream_t)stream;
  if ((long long)B * H * W == 0) return 0;
  return (int)(dtype ? scatter_launch<bf16>(x, offsets, ds, doff, start,
                                            list, coef, acc_in, acc_out, dx,
                                            g, n0, n1, st)
                     : scatter_launch<float>(x, offsets, ds, doff, start,
                                             list, coef, acc_in, acc_out, dx,
                                             g, n0, n1, st));
}
