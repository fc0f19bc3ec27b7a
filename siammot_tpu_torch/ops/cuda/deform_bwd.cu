// Deformable convolution (DCNv1) backward: the CUDA counterpart of the
// JAX package's siammot_tpu/ops/deform_conv.py:_pallas_guarded_bwd (line
// 236), the VJP of the exact patch form (route B) whichever route the
// forward took.  JAX leaves it to XLA; here it is three kernels around two
// matrix products:
//
//   S  [N, 9C]  route B's samples, bit for bit the plain version's (and
//               JAX's: the fractions rounded to the dtype, which the
//               forward's route B skips, deform_common.cuh):
//               deform_bwd_sample, which also counts the in-range corners
//               that land on each input pixel;
//   dKernel = S^T G and dS = G W^T, f32 sums: torch.matmul (as XLA's dot),
//               between the two launches here;
//   dOffsets    per (pixel, tap): the f32 sums over channels of dS times
//               each corner's values, times the f32 derivatives of the
//               corner weights, rounded once (deform_bwd_offsets);
//   dX          the scatter of dS times each corner weight onto the four
//               corners, as a gather: deform_bwd_scan turns the counts
//               into each input pixel's list, deform_bwd_offsets fills the
//               lists (an integer atomic hands out slots, in arrival
//               order), and deform_bwd_gather sorts each list by source
//               (pixel, tap, corner) and sums it in that order into an f32
//               accumulator, rounded once.  No float atomics: the gradient
//               is bitwise the same from call to call.
//
// x [B, H, W, C] and dX NHWC, offsets and dOffsets [B, Ho, Wo, 18]
// tap-major (dy, dx), S and dS [N, 9C] with N = B Ho Wo, all in one dtype
// (f32 or bf16).  The arithmetic is ops/deform_conv.py:
// deform_conv2d_bwd_plain's, operation for operation (explicit __fmul_rn /
// __fadd_rn where it matters: the products and sums of dX), but for the
// order of the channel sums of dOffsets (a warp's lanes, then a shuffle
// tree: fixed, so deterministic).
//
// Bound on the H100: operations, the two products (2 x 2 x 9 C Co
// multiply-adds a pixel), which stay on cuBLAS.  The kernels here move the
// samples' corners (4 x 9 C values a pixel, mostly from L2) and dS twice;
// a warp takes one (pixel, tap) or one input pixel with its lanes over
// channels, so every load of a C-vector is coalesced.  A list is sorted by
// its warp with a bitonic network in place (a pixel gets about 4 x 9 /
// stride^2 contributions; any number is right, a pile is slower).
#include "common.cuh"
#include "deform_common.cuh"

namespace {

constexpr int WARPS = 8;  // warps a block

__device__ __forceinline__ void store(float* p, size_t i, float v) {
  p[i] = v;
}
__device__ __forceinline__ void store(bf16* p, size_t i, float v) {
  p[i] = __float2bfloat16(v);
}

// S[n, tap, :] = route B's samples; count[pixel] += the in-range corners
// there.  s or count may be null.  round_frac 0 takes the forward's
// fractions (a check of ROADMAP section 3's gap; the backward rounds).
template <typename T>
__global__ void __launch_bounds__(32 * WARPS)
    deform_bwd_sample(const T* __restrict__ x, const T* __restrict__ off,
                      T* __restrict__ s, int* __restrict__ count,
                      Geometry g, bool round_frac) {
  const int lane = threadIdx.x % 32;
  const int items = g.B * g.Ho * g.Wo * 9;
  for (int it = blockIdx.x * WARPS + threadIdx.x / 32; it < items;
       it += gridDim.x * WARPS) {
    const Corners cr = corners<T>(off, g, it / 9, it % 9, false, round_frac);
    if (s)
      for (int c = lane; c < g.C; c += 32)
        store(s, (size_t)it * g.C + c, sample<T>(x, cr.at, cr.k, c, false));
    if (count) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (lane == i && cr.at[i] >= 0) atomicAdd(&count[cr.at[i] / g.C], 1);
    }
  }
}

// start[0 .. P] = the exclusive prefix sums of count[0 .. P): one block,
// each thread a contiguous run
__global__ void __launch_bounds__(1024)
    deform_bwd_scan(const int* __restrict__ count, int* __restrict__ start,
                    int P) {
  __shared__ int part[1024];
  const int t = threadIdx.x, per = (P + 1023) / 1024;
  const int a = min(P, t * per), b = min(P, a + per);
  int sum = 0;
  for (int i = a; i < b; ++i) sum += count[i];
  part[t] = sum;
  __syncthreads();
  for (int o = 1; o < 1024; o <<= 1) {
    const int v = t >= o ? part[t - o] : 0;
    __syncthreads();
    part[t] += v;
    __syncthreads();
  }
  int run = t ? part[t - 1] : 0;
  for (int i = a; i < b; ++i) {
    start[i] = run;
    run += count[i];
  }
  if (t == 1023) start[P] = part[1023];
}

// Per (pixel, tap): dOffsets (where doff is not null), and the source id
// 4 (9 n + tap) + corner of each in-range corner put into its input
// pixel's list, with the corner's weight in coef (where list is not null;
// count then holds the counts, and goes back to 0).
template <typename T>
__global__ void __launch_bounds__(32 * WARPS)
    deform_bwd_offsets(const T* __restrict__ x, const T* __restrict__ off,
                       const T* __restrict__ ds, T* __restrict__ doff,
                       int* __restrict__ count, const int* __restrict__ start,
                       int* __restrict__ list, float* __restrict__ coef,
                       Geometry g) {
  const int lane = threadIdx.x % 32;
  const int items = g.B * g.Ho * g.Wo * 9;
  for (int it = blockIdx.x * WARPS + threadIdx.x / 32; it < items;
       it += gridDim.x * WARPS) {
    const Corners cr = corners<T>(off, g, it / 9, it % 9, false, true);
    if (doff) {
      // gw[i] = sum over channels of dS times corner i's values (0 where
      // the corner is out of range)
      float gw[4] = {0.f, 0.f, 0.f, 0.f};
      for (int c = lane; c < g.C; c += 32) {
        const float d = load_f32(ds, (size_t)it * g.C + c);
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (cr.at[i] >= 0) gw[i] = fmaf(d, load_f32(x, cr.at[i] + c), gw[i]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int o = 16; o; o >>= 1)
          gw[i] += __shfl_xor_sync(0xffffffff, gw[i], o);
      if (lane == 0) {
        // the corner weights (1-fy)(1-fx), (1-fy)fx, fy(1-fx), fy fx
        // differentiated in f32
        const float fy = cr.f[0], fx = cr.f[1];
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
    if (list) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (lane == i && cr.at[i] >= 0) {
          const int q = cr.at[i] / g.C;
          const int slot = atomicSub(&count[q], 1) - 1;
          list[start[q] + slot] = 4 * it + i;
          coef[4 * it + i] = cr.k[i];
        }
    }
  }
}

// Per input pixel q (a warp): its list sorted ascending (a bitonic network
// over the next power of two, the missing tail counting as +inf, so a
// comparison with it never swaps), then dX[q, c] = the sum over the list,
// in that order, of dS[source, c] * coef[source], from 0 in f32, rounded
// once.  A pixel no corner reaches gets 0.
template <typename T>
__global__ void __launch_bounds__(32 * WARPS)
    deform_bwd_gather(const T* __restrict__ ds, const int* __restrict__ start,
                      int* __restrict__ list, const float* __restrict__ coef,
                      T* __restrict__ dx, int P, int C) {
  constexpr int V = 4;  // channels a lane holds, 32 apart
  const int lane = threadIdx.x % 32;
  for (int q = blockIdx.x * WARPS + threadIdx.x / 32; q < P;
       q += gridDim.x * WARPS) {
    const int a = start[q], len = start[q + 1] - a;
    int* seg = list + a;
    for (int k = 2; k / 2 < len; k <<= 1)
      for (int j = k / 2; j; j >>= 1) {
        for (int i = lane; i < len; i += 32) {
          const int p = j == k / 2 ? i ^ (k - 1) : i ^ j;
          if (p > i && p < len) {
            const int u = seg[i], v = seg[p];
            if (u > v) {
              seg[i] = v;
              seg[p] = u;
            }
          }
        }
        __syncwarp();  // orders the warp's global accesses too
      }
    for (int c0 = 0; c0 < C; c0 += 32 * V) {
      float acc[V];
#pragma unroll
      for (int v = 0; v < V; ++v) acc[v] = 0.f;
      for (int i = 0; i < len; ++i) {
        const int src = seg[i];
        const float w = coef[src];
        const size_t row = (size_t)(src / 4) * C;
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const int c = c0 + lane + 32 * v;
          if (c < C)
            acc[v] = __fadd_rn(acc[v], __fmul_rn(load_f32(ds, row + c), w));
        }
      }
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const int c = c0 + lane + 32 * v;
        if (c < C) store(dx, (size_t)q * C + c, acc[v]);
      }
    }
  }
}

// blocks of WARPS warps for one warp an item (the loops stride past 2^20)
int blocks_for(long long warps) {
  const long long blocks = (warps + WARPS - 1) / WARPS;
  return (int)(blocks < (1 << 20) ? blocks : 1 << 20);
}

template <typename T>
cudaError_t sample_launch(const void* x, const void* offsets, void* s,
                          int* count, const Geometry& g, bool round_frac,
                          cudaStream_t st) {
  deform_bwd_sample<T><<<blocks_for((long long)g.B * g.Ho * g.Wo * 9),
                         32 * WARPS, 0, st>>>(
      (const T*)x, (const T*)offsets, (T*)s, count, g, round_frac);
  return cudaGetLastError();
}

template <typename T>
cudaError_t scatter_launch(const void* x, const void* offsets, const void* ds,
                           void* doff, void* dx, int* count, int* start,
                           int* list, float* coef, const Geometry& g,
                           cudaStream_t st) {
  const int P = g.B * g.H * g.W;
  cudaError_t err;
  if (dx) {
    deform_bwd_scan<<<1, 1024, 0, st>>>(count, start, P);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if (doff || dx) {
    deform_bwd_offsets<T><<<blocks_for((long long)g.B * g.Ho * g.Wo * 9),
                            32 * WARPS, 0, st>>>(
        (const T*)x, (const T*)offsets, (const T*)ds, (T*)doff,
        dx ? count : nullptr, start, dx ? list : nullptr, coef, g);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if (dx) {
    deform_bwd_gather<T><<<blocks_for(P), 32 * WARPS, 0, st>>>(
        (const T*)ds, start, list, coef, (T*)dx, P, g.C);
    return cudaGetLastError();
  }
  return cudaSuccess;
}

}  // namespace

// Step 1.  dtype 0 = float32, 1 = bfloat16.  s: [N, 9C] samples, or null;
// count: int [B H W] zeroed here, or null (no input gradient); round_frac
// 1 (the backward's) or 0 (the forward's fractions).
SIAMMOT_API int siammot_deform_bwd_sample(const void* x, const void* offsets,
                                          void* s, int* count, int B, int H,
                                          int W, int C, int Ho, int Wo,
                                          int stride, int dilation, int dtype,
                                          int round_frac, void* stream) {
  if (C < 1 || stride < 1 || dilation < 1) return (int)cudaErrorInvalidValue;
  const Geometry g{B, H, W, C, Ho, Wo, 0, stride, dilation};
  cudaStream_t st = (cudaStream_t)stream;
  if (count) {
    const cudaError_t err =
        cudaMemsetAsync(count, 0, sizeof(int) * (size_t)B * H * W, st);
    if (err != cudaSuccess) return (int)err;
  }
  if ((long long)B * Ho * Wo == 0) return 0;
  return (int)(dtype ? sample_launch<bf16>(x, offsets, s, count, g,
                                           round_frac != 0, st)
                     : sample_launch<float>(x, offsets, s, count, g,
                                            round_frac != 0, st));
}

// Steps 3 and 4, after dS = G W^T.  doff: [B, Ho, Wo, 18] or null; dx:
// [B, H, W, C] or null, with count (step 1's), start int [B H W + 1], list
// int and coef float [36 N] as scratch.
SIAMMOT_API int siammot_deform_bwd_scatter(
    const void* x, const void* offsets, const void* ds, void* doff, void* dx,
    int* count, int* start, int* list, float* coef, int B, int H, int W,
    int C, int Ho, int Wo, int stride, int dilation, int dtype, void* stream) {
  if (C < 1 || stride < 1 || dilation < 1) return (int)cudaErrorInvalidValue;
  const Geometry g{B, H, W, C, Ho, Wo, 0, stride, dilation};
  cudaStream_t st = (cudaStream_t)stream;
  if ((long long)B * H * W == 0) return 0;
  return (int)(dtype ? scatter_launch<bf16>(x, offsets, ds, doff, dx, count,
                                            start, list, coef, g, st)
                     : scatter_launch<float>(x, offsets, ds, doff, dx, count,
                                             start, list, coef, g, st));
}
