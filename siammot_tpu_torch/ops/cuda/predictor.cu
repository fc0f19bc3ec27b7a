// Masked EMM predictor: the CUDA counterpart of the Pallas kernel
// siammot_tpu/ops/pallas/predictor.py:emm_predictor_pallas
// (_predictor_kernel), for any response size S and channel count C with
// C % 32 == 0, in bf16 or f32.  At the end, kernel 8, the slot-blocked
// form of emm_predictor_pallas_blocked, which shares the head pass.
//
// Per live slot, over an [S, S, C] correlation response x:
//   tower(x) = T(relu(GN32(conv3x3(x) + b)))   (cls and reg towers)
//   cls, ctr = conv3x3(tower_cls) + b          (2 + 1 channels)
//   reg      = relu(conv3x3(tower_reg) + b)    (4 channels)
// with T the rounding to the response dtype.  Each 3x3 conv is nine
// shifted [S^2 x C] . [C x C] products with f32 sums; GroupNorm takes f32
// statistics over the whole map with var = E[x^2] - E[x]^2.
//
// Bound on the H100: operations.  The towers are 2 x 9 S^2 C^2
// multiply-adds per live slot (2 x 37.7 M at the main path's 16x16x128,
// 2 x 549 M at SEARCH_REGION 5's 61x61) on inputs of 2 S^2 C bytes, so
// in bf16 the tensor cores set the pace.  Two launches:
//   1. the tower conv into an f32 scratch [2, K, S*S, C] (conv + bias,
//      pre-norm): in bf16 tower_conv_wgmma, on Hopper's warpgroup MMA
//      (wgmma.cuh); in f32 tower_conv_tiled, an FFMA implicit GEMM (the
//      f32 golden frames hold the JAX rows to 1e-2 px, which TF32 would
//      put at risk);
//   2. heads_tiled: per (slot, tower) the GroupNorm statistics of the
//      scratch map, then one warp per output position runs the 3x3
//      head(s), normalising, applying ReLU and rounding to the response
//      dtype as it loads.  Dead slots write zeros here.
// bf16 products are exact in f32, on the tensor cores as on the CUDA
// cores, so only the order of the f32 sums differs between the forms.
//
// tower_conv_wgmma: a block owns (live slot, tower, 128 output channels,
// a band of 128 consecutive output positions).  It stages its band of
// the response once, with a one-row halo and the zero border, in shared
// memory (pixel-major, each pixel's 16-byte channel chunks XOR-swizzled
// by the pixel index, so ldmatrix reads eight neighbouring pixels
// without bank conflicts); each of the nine taps reads A straight from
// there at shifted row addresses, so no im2col buffer exists.  One
// producer warp streams the [tap, 32 input channels, 128 output
// channels] weight slices through a 4-stage ring with cp.async (each
// copy marks its stage full as it lands), so the block reads each weight
// once; two consumer warpgroups of 64 positions
// each run m64n128k16 wgmma with f32 sums.  At 16x16 and 37 live slots
// that is 148 blocks (two a SM fit), at 61x61 2220.
#include "common.cuh"
#include "wgmma.cuh"

constexpr int G = 32;        // GroupNorm groups

typedef __nv_bfloat16 bf16;

// ---------------------------------------------------------------------------
// f32: tower_conv_tiled, per (live slot, tower, 64 positions x 64 output
// channels) an FFMA implicit GEMM over K = 9 taps x C in chunks of 16,
// the input tile gathered with its zero border.

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

// ---------------------------------------------------------------------------
// bf16: tower_conv_wgmma (see the note at the top)
namespace tconv {
constexpr int BM = 128;                 // output positions a block
constexpr int KC = 32;                  // input channels a stage
constexpr int STAGES = 4;
constexpr int B_BYTES = KC * wg::N * 2;   // one weight slice, 8 KB
constexpr int CONSUMER_WARPS = 8;         // two warpgroups
constexpr int THREADS = 32 * CONSUMER_WARPS + 32;  // + the producer warp

// rows of the response a band stages: those its positions span, plus
// the halo row above and below
__host__ __device__ inline int rows_staged(int S) {
  const int spanned = (BM - 1) / S + 2;  // rows BM positions can touch
  return (spanned < S ? spanned : S) + 2;
}
__host__ inline size_t smem_bytes(int S, int Cc) {
  return (size_t)STAGES * B_BYTES + (size_t)rows_staged(S) * (S + 2) * Cc * 2 +
         1024;  // + slack to align the ring to 1024 bytes
}
}  // namespace tconv

__global__ void __launch_bounds__(tconv::THREADS, 2)
    tower_conv_wgmma(const bf16* __restrict__ x,
                     const uint8_t* __restrict__ valid, TiledParams<bf16> P,
                     float* __restrict__ pre, int K, int S, int Cc) {
  const int k = blockIdx.z >> 1, tower = blockIdx.z & 1;
  if (!valid[k]) return;  // heads_tiled writes the dead slot's zeros
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring =
      (unsigned char*)(((uintptr_t)smem_raw + 1023) & ~(uintptr_t)1023);
  unsigned char* staged = ring + tconv::STAGES * tconv::B_BYTES;
  __shared__ uint64_t full[tconv::STAGES], empty[tconv::STAGES];

  const int t = threadIdx.x, warp = t / 32, lane = t % 32;
  const int SS = S * S, SP = S + 2, C8 = Cc / 8;
  const int mask = Cc % 64 ? 3 : 7;  // chunk swizzle within whole groups
  const int p0 = blockIdx.x * tconv::BM, co0 = blockIdx.y * wg::N;
  const int ylo = p0 / S;
  const int nrows = (min(p0 + tconv::BM, SS) - 1) / S - ylo + 3;
  const bf16* w = tower ? P.w[1] : P.w[0];
  if (t == 0) {
    for (int s = 0; s < tconv::STAGES; ++s) {
      wg::mbar_init(&full[s], 32);
      wg::mbar_init(&empty[s], tconv::CONSUMER_WARPS);
    }
    wg::mbar_init_fence();
  }
  // the band's response rows ylo - 1 .. with the zero border: staged
  // pixel sp = (row - ylo + 1) * (S + 2) + column + 1
  const bf16* xk = x + (size_t)k * SS * Cc;
  const uint32_t staged_at = wg::smem_addr(staged);
  for (int e = t; e < nrows * SP * C8; e += tconv::THREADS) {
    const int sp = e / C8, q = e % C8;
    const int yy = ylo - 1 + sp / SP, xx = sp % SP - 1;
    const bool in = yy >= 0 && yy < S && xx >= 0 && xx < S;
    wg::cp_async16(
        staged_at + (uint32_t)(sp * Cc * 2) + ((q ^ (sp & mask)) << 4),
        in ? xk + ((size_t)yy * S + xx) * Cc + q * 8 : xk, in ? 16 : 0);
  }
  wg::cp_async_commit();
  wg::cp_async_wait<0>();
  __syncthreads();

  const int kcn = Cc / tconv::KC;  // 32-channel chunks a tap
  const int steps = 9 * kcn;
  if (warp == tconv::CONSUMER_WARPS) {
    // producer: the weight slices [tap, ci0.., co0..] through the ring;
    // each lane's copies arrive on the stage's full barrier as they land
    const uint32_t ring_at = wg::smem_addr(ring);
    int stage = 0;
    uint32_t phase = 1;
    for (int it = 0; it < steps; ++it) {
      wg::mbar_wait(&empty[stage], phase);
      const int tap = it / kcn, ci0 = (it % kcn) * tconv::KC;
      const uint32_t b_at = ring_at + stage * tconv::B_BYTES;
      for (int e = lane; e < tconv::KC * 16; e += 32) {
        const int r = e / 16, q = e % 16;
        const int co = co0 + q * 8;
        wg::cp_async16(b_at + wg::b_offset(r, q, tconv::KC),
                       co < Cc ? w + ((size_t)tap * Cc + ci0 + r) * Cc + co
                               : w,
                       co < Cc ? 16 : 0);
      }
      wg::cp_async_arrive(&full[stage]);
      if (++stage == tconv::STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
    wg::cp_async_wait<0>();  // leave no copy in flight
    return;
  }

  // consumers: warpgroup g owns positions p0 + 64 g .., its warp w the
  // 16 from p0 + 64 g + 16 w; lane l gives position l % 16's row address
  const int g = warp / 4, wq = warp % 4;
  const int p = min(p0 + 64 * g + 16 * wq + (lane & 15), SS - 1);
  const int sp0 = (p / S - ylo) * SP + p % S;  // tap (0, 0)
  float d[wg::ACC];
#pragma unroll
  for (int i = 0; i < wg::ACC; ++i) d[i] = 0.f;
  const uint32_t ring_at = wg::smem_addr(ring);
  int stage = 0;
  uint32_t phase = 0;
  for (int it = 0; it < steps; ++it) {
    const int tap = it / kcn, q0 = (it % kcn) * (tconv::KC / 8);
    const int sp = sp0 + (tap / 3) * SP + tap % 3;
    const uint32_t row_at = staged_at + (uint32_t)(sp * Cc * 2);
    uint32_t a[2][4];
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      const int q = q0 + 2 * ks + (lane >> 4);
      wg::ldmatrix_x4(a[ks], row_at + ((q ^ (sp & mask)) << 4));
    }
    wg::mbar_wait(&full[stage], phase);
    wg::fence_proxy_async();
    wg::fence();
#pragma unroll
    for (int ks = 0; ks < 2; ++ks)
      wg::mma(d, a[ks],
              wg::b_desc(ring_at + stage * tconv::B_BYTES + ks * 2048,
                         tconv::KC));
    wg::commit();
    wg::wait<0>();
    wg::fence_acc(d);
    __syncwarp();
    if (lane == 0) wg::mbar_arrive(&empty[stage]);
    if (++stage == tconv::STAGES) {
      stage = 0;
      phase ^= 1;
    }
  }

  // conv + bias, f32, to the scratch
  const bf16* bias = tower ? P.b[1] : P.b[0];
  float* out = pre + ((size_t)tower * K + k) * SS * Cc;
  const int r0 = p0 + 64 * g + 16 * wq + lane / 4;
#pragma unroll
  for (int i = 0; i < wg::ACC; i += 2) {
    const int pos = r0 + 8 * ((i / 2) % 2);
    const int co = co0 + 8 * (i / 4) + 2 * (lane % 4);
    if (pos < SS && co < Cc) {
      float2 v;
      v.x = d[i] + __bfloat162float(bias[co]);
      v.y = d[i + 1] + __bfloat162float(bias[co + 1]);
      *(float2*)(out + (size_t)pos * Cc + co) = v;
    }
  }
}

template <typename T>
static TiledParams<T> tiled_params(const void* const* p) {
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
  return P;
}

// the dynamic shared memory a block of tower_conv_wgmma may opt in to:
// the card's per-block limit less the kernel's static barriers
static size_t tower_smem_limit() {
  int dev = 0, optin = 0;
  cudaFuncAttributes fa;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess ||
      cudaFuncGetAttributes(&fa, tower_conv_wgmma) != cudaSuccess)
    return 0;
  return (size_t)optin - fa.sharedSizeBytes;
}

// shared memory the bf16 tower conv needs at (S, C), or -1 past the
// card's limit (the wrapper raises)
SIAMMOT_API int siammot_emm_tower_smem(int S, int Cc) {
  const size_t need = tconv::smem_bytes(S, Cc);
  return need <= tower_smem_limit() ? (int)need : -1;
}

// params: the 14 tensors in the order of ops/predictor.py _NAMES; dtype
// 0 = float32, 1 = bfloat16 (16-byte aligned); pre: f32 scratch
// [2, K, S*S, C]
SIAMMOT_API int siammot_emm_predictor(
    const void* x, const uint8_t* valid, const void* const* params,
    float* pre, float* cls, float* ctr, float* reg, int K, int S, int Cc,
    int dtype, void* stream) {
  if (K == 0) return 0;
  if (Cc % G || S < 1 || 2 * K > 65535) return (int)cudaErrorInvalidValue;
  cudaError_t err;
  if (dtype == 1) {
    static size_t limit = 0;  // opted in once, outside any graph capture
    if (limit == 0) {
      limit = tower_smem_limit();
      err = set_smem(tower_conv_wgmma, limit);
      if (err != cudaSuccess) return (int)err;
    }
    const size_t smem = tconv::smem_bytes(S, Cc);
    if (smem > limit) return (int)cudaErrorInvalidValue;
    const TiledParams<bf16> P = tiled_params<bf16>(params);
    const dim3 grid((S * S + tconv::BM - 1) / tconv::BM,
                    (Cc + wg::N - 1) / wg::N, 2 * K);
    tower_conv_wgmma<<<grid, tconv::THREADS, smem, (cudaStream_t)stream>>>(
        (const bf16*)x, valid, P, pre, K, S, Cc);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    heads_tiled<bf16><<<dim3(K, 2), HEAD_THREADS, 0, (cudaStream_t)stream>>>(
        pre, valid, P, cls, ctr, reg, K, S, Cc);
  } else {
    const TiledParams<float> P = tiled_params<float>(params);
    const dim3 grid((S * S + TP - 1) / TP, (Cc + TC - 1) / TC, 2 * K);
    tower_conv_tiled<float><<<grid, CONV_THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)x, valid, P, pre, K, S, Cc);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    heads_tiled<float><<<dim3(K, 2), HEAD_THREADS, 0,
                         (cudaStream_t)stream>>>(pre, valid, P, cls, ctr, reg,
                                                 K, S, Cc);
  }
  return (int)cudaGetLastError();
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
  const TiledParams<T> P = tiled_params<T>(p);
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

// params as for siammot_emm_predictor; B slots a block, K % B == 0
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
