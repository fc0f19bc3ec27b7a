// Masked EMM predictor: the CUDA counterpart of the Pallas kernels
// siammot_tpu/ops/pallas/predictor.py:emm_predictor_pallas
// (_predictor_kernel, kernel 3) and emm_predictor_pallas_blocked
// (_predictor_kernel_blocked, kernel 8), for any response size S and
// channel count C with C % 32 == 0, in bf16 or f32.
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
// in bf16 the tensor cores set the pace.  Two launches, two passes over
// an f32 scratch of the towers' pre-norm maps:
//   1. the tower conv writes conv + bias to the scratch [2, K, C/16, S*S,
//      16] (16-channel planes, so a band of rows of one plane is one
//      contiguous run) and, from its epilogue, each tile's per-group
//      partial sum and sum of squares to [2, K, tiles, 32, 2], in a fixed
//      order (warp shuffles, then the tile's warps in turn; no atomics).
//      In bf16 tower_conv_wgmma, on Hopper's warpgroup MMA (wgmma.cuh); in
//      f32 tower_conv_tiled, an FFMA implicit GEMM (the f32 golden frames
//      hold the JAX rows to 1e-2 px, which TF32 would put at risk);
//   2. heads_band: a block per (slot, tower, band of consecutive output
//      positions) adds the slot's partials in tile order (two launches
//      give the same bits), copies its band's rows with a one-row halo
//      by cp.async, all 16-channel planes in one stage where they fit
//      (one round trip a block) or one a stage, normalises, applies ReLU
//      and rounds to the response dtype once per element in place, and
//      runs the tower's 3x3 head from shared memory: cls and centerness
//      as one head of 3 (+1 zero) outputs, as the JAX kernel's [C, 3]
//      head, reg as one of 4.  Four lanes share a position, one 4-channel
//      quad of a plane each, and add their sums with two shuffles.  Dead
//      slots write zeros here.  The head is FFMA from shared memory: in
//      bf16 with f32 sums (the products are exact, as in the plain
//      version), in f32 with f64 sums (see HeadSum).  Bands of 256
//      positions: a sweep of 64, 128 and 256 on the card found the
//      fewest, largest blocks fastest, as a block's fixed work (weights,
//      statistics) outweighs a fuller grid (PERF.md, section 6).
//
// The head pass moves the scratch once each way: at 61x61 with 37 live
// slots, 2 x 141 MB, 0.084 ms at 3.35 TB/s (the scratch outgrows the 50
// MB L2 there; at 16x16 it is 9.7 MB and stays in L2).
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
//
// Kernel 8 computes kernel 3's function with its slots in groups of B
// (the Pallas kernel's program of B slots, which amortises the TPU's
// weight loads).  On this card both towers' weights (590 KB in bf16) stay
// in L2, so the blocking saves nothing: kernel 8 launches kernel 3's
// kernels as they are (ops/predictor.py checks B).  A dead slot's tower
// blocks return at once and the head pass writes its zeros, so a group
// without a live slot does no work and emits zeros, as the JAX kernel.
#include "common.cuh"
#include "wgmma.cuh"

constexpr int G = 32;        // GroupNorm groups
constexpr int CH = 16;       // channels of one plane of the scratch

typedef __nv_bfloat16 bf16;

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

// offset of (position, channel) in one slot and tower's scratch map
__device__ __forceinline__ size_t scratch_at(int pos, int co, int SS) {
  return ((size_t)(co / CH) * SS + pos) * CH + co % CH;
}

// A tower conv block's slot: blockIdx.z = slot * 2 + tower; -1 for a
// dead slot
__device__ __forceinline__ int tower_slot(const uint8_t* __restrict__ valid) {
  const int k = blockIdx.z >> 1;
  return valid[k] ? k : -1;
}

// tower_conv_wgmma's epilogue: where A[j] of its column sums lies in d
__device__ constexpr int at(int j) {
  return 4 * (j / 4) + (j / 2) % 2 + 2 * (j % 2);
}

// one halving step over lane bit OFF: a lane keeps A[0, H) or A[H, 2H)
// as its bit says, adds its partner's copy of that half, and holds the
// result in A[0, H)
template <int H, int OFF>
__device__ __forceinline__ void halve(float (&d)[wg::ACC], int lane) {
  const bool up = lane & OFF;
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float lo = d[at(i)], hi = d[at(i + H)];
    d[at(i)] = (up ? hi : lo) + __shfl_xor_sync(0xffffffff, up ? lo : hi, OFF);
  }
}

// A tile's per-group partial sums and sums of squares, from per-warp
// column sums red[warp][channel - c0] (channels c0 .. c0 + width): thread
// g < 32 adds group g's channels of the tile in order, each over the
// warps in order, and writes (sum, sum of squares) to dst[g] (zeros for a
// group outside the tile)
__device__ __forceinline__ void tile_partials(const float2* red, int warps,
                                              int width, int c0, int Cc,
                                              float2* __restrict__ dst) {
  const int g = threadIdx.x;
  if (g >= G) return;
  const int cpg = Cc / G;
  const int lo = max(g * cpg, c0);
  const int hi = min(min((g + 1) * cpg, c0 + width), Cc);
  float s = 0.f, q = 0.f;
  for (int c = lo; c < hi; ++c)
    for (int w = 0; w < warps; ++w) {
      const float2 v = red[w * width + c - c0];
      s += v.x;
      q += v.y;
    }
  dst[g] = make_float2(s, q);
}

// ---------------------------------------------------------------------------
// f32: tower_conv_tiled, per (live slot, tower, 64 positions x 64 output
// channels) an FFMA implicit GEMM over K = 9 taps x C in chunks of 16,
// the input tile gathered with its zero border.

constexpr int TP = 64;        // positions per conv tile
constexpr int TC = 64;        // output channels per conv tile
constexpr int TK = 16;        // input channels per chunk
constexpr int CONV_THREADS = 256;
static_assert(TK * TP % CONV_THREADS == 0 && TK * TC % CONV_THREADS == 0,
              "tiles fill whole thread passes");

template <typename T>
__global__ void __launch_bounds__(CONV_THREADS)
    tower_conv_tiled(const T* __restrict__ x,
                     const uint8_t* __restrict__ valid, TiledParams<T> P,
                     float* __restrict__ pre, float2* __restrict__ part,
                     int K, int S, int Cc) {
  const int SS = S * S, band = blockIdx.x;
  const int k = tower_slot(valid), tower = blockIdx.z & 1;
  if (k < 0) return;  // heads_band writes the dead slot's zeros
  __shared__ float As[TK][TP + 1];  // +1: no bank conflicts on the fill
  __shared__ float Bs[TK][TC];
  __shared__ float2 red[CONV_THREADS / 32][TC];
  const int t = threadIdx.x;
  const int p0 = band * TP, c0 = blockIdx.y * TC;
  const int ty = t / 16, tx = t % 16;  // 4 positions x 4 channels each
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
  // conv + bias to the scratch; each channel's sum and sum of squares over
  // the thread's positions, then over the warp's two position rows
  float* out = pre + ((size_t)tower * K + k) * SS * Cc;
  float cs[4] = {}, cq[4] = {};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int p = p0 + ty * 4 + i;
    if (p >= SS) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int co = c0 + tx + 16 * j;
      if (co < Cc) {
        const float v = acc[i][j] + load_f32(bias, co);
        out[scratch_at(p, co, SS)] = v;
        cs[j] += v;
        cq[j] += v * v;
      }
    }
  }
  const int warp = t / 32, lane = t % 32;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    cs[j] += __shfl_xor_sync(0xffffffff, cs[j], 16);
    cq[j] += __shfl_xor_sync(0xffffffff, cq[j], 16);
  }
  if (lane < 16)
#pragma unroll
    for (int j = 0; j < 4; ++j) red[warp][tx + 16 * j] = make_float2(cs[j], cq[j]);
  __syncthreads();
  const int tiles = gridDim.x * gridDim.y;
  tile_partials(&red[0][0], CONV_THREADS / 32, TC, c0, Cc,
                part + (((size_t)tower * K + k) * tiles + band * gridDim.y +
                        blockIdx.y) * G);
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
static_assert(CONSUMER_WARPS * wg::N * 8 <= STAGES * B_BYTES,
              "the epilogue's column sums fit the ring");

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
                     float* __restrict__ pre, float2* __restrict__ part,
                     int K, int S, int Cc) {
  const int SS = S * S, band = blockIdx.x;
  const int k = tower_slot(valid), tower = blockIdx.z & 1;
  if (k < 0) return;  // heads_band writes the dead slot's zeros
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring =
      (unsigned char*)(((uintptr_t)smem_raw + 1023) & ~(uintptr_t)1023);
  unsigned char* staged = ring + tconv::STAGES * tconv::B_BYTES;
  __shared__ uint64_t full[tconv::STAGES], empty[tconv::STAGES];

  const int t = threadIdx.x, warp = t / 32, lane = t % 32;
  const int SP = S + 2, C8 = Cc / 8;
  const int mask = Cc % 64 ? 3 : 7;  // chunk swizzle within whole groups
  const int p0 = band * tconv::BM, co0 = blockIdx.y * wg::N;
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

  // conv + bias, f32, to the scratch; the values kept (zero past the
  // map) for the statistics
  const bf16* bias = tower ? P.b[1] : P.b[0];
  float* out = pre + ((size_t)tower * K + k) * SS * Cc;
  const int r0 = p0 + 64 * g + 16 * wq + lane / 4;
#pragma unroll
  for (int i = 0; i < wg::ACC; i += 2) {
    const int pos = r0 + 8 * ((i / 2) % 2);
    const int co = co0 + 8 * (i / 4) + 2 * (lane % 4);
    float2 v = make_float2(0.f, 0.f);
    if (pos < SS && co < Cc) {
      v.x = d[i] + __bfloat162float(bias[co]);
      v.y = d[i + 1] + __bfloat162float(bias[co + 1]);
      *(float2*)(out + scratch_at(pos, co, SS)) = v;
    }
    d[i] = v.x;
    d[i + 1] = v.y;
  }
  // each of the thread's 32 columns: its two rows' sum into d[4u + e],
  // their squares' into d[4u + 2 + e] (column 8u + 2 (lane % 4) + e)
#pragma unroll
  for (int u = 0; u < wg::ACC / 4; ++u)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float a = d[4 * u + e], b = d[4 * u + 2 + e];
      d[4 * u + e] = a + b;
      d[4 * u + 2 + e] = a * a + b * b;
    }
  // then over the warp's 16 rows (lane bits 2-4): as A[j] = d[at(j)],
  // j = 4u + 2e + (0 sum, 1 squares), each step a lane keeps the half of
  // A its bit selects and adds its partner's copy of that half, so lane
  // l ends with A[8 (l / 4) .. + 8) for the whole warp (56 shuffles)
  halve<32, 16>(d, lane);
  halve<16, 8>(d, lane);
  halve<8, 4>(d, lane);
  // the ring is free once both warpgroups' last wgmma has read it
  constexpr int CONSUMERS = 32 * tconv::CONSUMER_WARPS;
  wg::named_sync(1, CONSUMERS);
  wg::fence_proxy_async();
  float2* red = (float2*)ring;  // [consumer warp][128 columns]
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)  // column 4 (lane / 4) + kk of A's 32
    red[warp * wg::N + 16 * (lane / 4) + 8 * (kk / 2) + 2 * (lane % 4) +
        kk % 2] = make_float2(d[at(2 * kk)], d[at(2 * kk + 1)]);
  wg::named_sync(1, CONSUMERS);
  const int tiles = gridDim.x * gridDim.y;
  tile_partials(red, tconv::CONSUMER_WARPS, wg::N, co0, Cc,
                part + (((size_t)tower * K + k) * tiles + band * gridDim.y +
                        blockIdx.y) * G);
}

// ---------------------------------------------------------------------------
// The head pass (see the note at the top).  A block of THREADS threads
// takes BP = ITEMS x M consecutive output positions of one slot and
// tower; thread t computes positions p0 + t / 4 + ITEMS m over the
// channel quads t % 4 of each 16-channel plane.  The band's rows come in
// stages of `pps` planes by cp.async, are normalised in place and feed
// the heads; the plan takes all planes in one stage where they fit (one
// round trip a block), else one plane a stage (the most blocks an SM).
namespace heads {
constexpr int THREADS = 256;
constexpr int ITEMS = THREADS / 4;      // positions a pass
constexpr int M = 4;                    // passes a band
constexpr int BP = ITEMS * M;           // positions a band
constexpr int PARTS = THREADS / 32;     // warps adding the partials
// rows a band stages: those it spans and the halo
__host__ __device__ inline int rows_staged(int S) {
  const int spanned = (BP - 1) / S + 2;
  return (spanned < S ? spanned : S) + 2;
}
// bytes of one stage buffer: `pps` planes of the staged rows
__host__ __device__ inline int stage_bytes(int S, int pps) {
  return pps * rows_staged(S) * (S + 2) * CH * 4;
}
// dynamic shared memory of a block (ops/predictor.py:head_smem mirrors it)
__host__ inline size_t smem_bytes(int S, int Cc, int pps) {
  return (size_t)stage_bytes(S, pps)  // the staged planes
         + (size_t)9 * Cc * 16     // head weights, 4 outputs a channel
         + (size_t)4 * Cc * 4      // per channel mean, rstd, scale, shift
         + (size_t)PARTS * G * 8   // the partials' sums by warp
         + (size_t)2 * G * 4;      // per group mean, rstd
}
}  // namespace heads

// The heads' sums: f32 in bf16 (the products are exact, as in the plain
// version), f64 in f32, so the f32 logits are the correctly rounded sums.
// The f32 golden frames hold the JAX rows to 1e-2 px through the decode's
// argmax, and in the SEARCH_REGION 5 cut two neighbouring cells tie to the
// last bit of p_conf: an f32 sum in yet another order than the
// reference's tipped that tie (PERF.md, section 6).
template <typename T>
struct HeadSum {
  typedef float type;
};
template <>
struct HeadSum<float> {
  typedef double type;
};
__device__ __forceinline__ float madd(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double madd(double a, double b, double c) {
  return fma(a, b, c);
}

template <typename T>
__device__ __forceinline__ float normed(float v, float mean, float rstd,
                                        float sc, float sh) {
  return round_to<T>(fmaxf((v - mean) * rstd * sc + sh, 0.f));
}

template <typename T>
__global__ void __launch_bounds__(heads::THREADS)
    heads_band(const float* __restrict__ pre,
               const float2* __restrict__ part,
               const uint8_t* __restrict__ valid, TiledParams<T> P,
               float* __restrict__ cls, float* __restrict__ ctr,
               float* __restrict__ reg, int K, int S, int Cc, int tiles,
               int pps) {
  constexpr int M = heads::M, BP = heads::BP;
  constexpr int NT = heads::THREADS;
  constexpr int Q = CH / 4;  // float4s a pixel of a plane
  const int tower = blockIdx.y, k = blockIdx.z;
  const int t = threadIdx.x;
  const int SS = S * S;
  const int p0 = blockIdx.x * BP, p1 = min(p0 + BP, SS);
  if (!valid[k]) {
    if (tower == 0) {
      for (int e = t; e < (p1 - p0) * 2; e += NT)
        cls[((size_t)k * SS + p0) * 2 + e] = 0.f;
      for (int e = t; e < p1 - p0; e += NT) ctr[(size_t)k * SS + p0 + e] = 0.f;
    } else {
      for (int e = t; e < (p1 - p0) * 4; e += NT)
        reg[((size_t)k * SS + p0) * 4 + e] = 0.f;
    }
    return;
  }
  extern __shared__ float4 hsm[];
  const int SP = S + 2, C4 = Cc / 4;
  const int ya = p0 / S;                       // staged row 0 is ya - 1
  const int nrows = (p1 - 1) / S - ya + 3;
  const int plane_px = nrows * SP;             // pixels a staged plane
  float4* stage = hsm;  // [pps][nrows][S + 2][Q], the tower values
  float4* W4 = stage + heads::stage_bytes(S, pps) / 16;
  // W4: [tap][channel % 4][C / 4]
  float* cm = (float*)(W4 + 9 * Cc);
  float* cr = cm + Cc;
  float* csc = cr + Cc;
  float* csh = csc + Cc;
  float2* gsum = (float2*)(csh + Cc);  // [PARTS][G]
  float* gstat = (float*)(gsum + heads::PARTS * G);

  // stage s: rows ya - 1 .. of planes s pps .., contiguous in the scratch;
  // rows off the map come as zeros.  A thread stages float4 xq (pixel
  // xq / Q, quad xq % Q) of a row, the rows r0, r0 + rstep, .. of each
  // plane (and normalises the same elements)
  const float* map = pre + ((size_t)tower * K + k) * SS * Cc;
  const int SQ = S * Q;
  const int rstep = SQ >= NT ? 1 : NT / SQ;
  const int r0 = SQ >= NT ? 0 : t / SQ;
  const int xq0 = SQ >= NT ? t : (r0 < rstep ? t % SQ : SQ);
  auto fetch = [&](int s_) {
    const uint32_t dst = wg::smem_addr(stage);
    for (int xq = xq0; xq < SQ; xq += NT)
      for (int j = 0; j < pps; ++j) {
        const float* src = map + (size_t)(s_ * pps + j) * SS * CH +
                           (xq / Q) * CH + xq % Q * 4;
        for (int r = r0; r < nrows; r += rstep) {
          const int y = ya - 1 + r;
          const bool in = y >= 0 && y < S;
          wg::cp_async16(dst + (uint32_t)(((j * nrows + r) * SP + xq / Q +
                                           1) * Q + xq % Q) * 16,
                         src + (in ? y : 0) * S * CH, in ? 16 : 0);
        }
      }
    wg::cp_async_commit();
  };
  fetch(0);

  // the partials, warp w adding tiles w, w + PARTS, ..
  {
    const float2* pk = part + ((size_t)tower * K + k) * tiles * G;
    const int g = t % G, w = t / G;
    float s = 0.f, q = 0.f;
    for (int i = w; i < tiles; i += heads::PARTS) {
      const float2 v = pk[(size_t)i * G + g];
      s += v.x;
      q += v.y;
    }
    gsum[w * G + g] = make_float2(s, q);
  }
  // the tower's head weights, [C, 3] cls + ctr (and a zero) or [C, 4] reg
  for (int e = t; e < 9 * Cc; e += NT) {
    const int tap = e / Cc, c = e % Cc;
    float4 wv;
    if (tower == 0) {
      wv = make_float4(load_f32(P.wcls, (size_t)e * 2),
                       load_f32(P.wcls, (size_t)e * 2 + 1),
                       load_f32(P.wctr, e), 0.f);
    } else {
      wv = make_float4(load_f32(P.wreg, (size_t)e * 4),
                       load_f32(P.wreg, (size_t)e * 4 + 1),
                       load_f32(P.wreg, (size_t)e * 4 + 2),
                       load_f32(P.wreg, (size_t)e * 4 + 3));
    }
    W4[(tap * 4 + c % 4) * C4 + c / 4] = wv;
  }
  {
    const T* sc = tower ? P.scale[1] : P.scale[0];
    const T* sh = tower ? P.shift[1] : P.shift[0];
    for (int c = t; c < Cc; c += NT) {
      csc[c] = load_f32(sc, c);
      csh[c] = load_f32(sh, c);
    }
  }
  // the zero border columns
  for (int e = t; e < pps * nrows * 2 * Q; e += NT) {
    const int side = e / Q % 2, row = e / (2 * Q);  // row of all planes
    stage[(row * SP + side * (S + 1)) * Q + e % Q] =
        make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __syncthreads();
  if (t < G) {
    float s = 0.f, q = 0.f;
    for (int w = 0; w < heads::PARTS; ++w) {
      const float2 v = gsum[w * G + t];
      s += v.x;
      q += v.y;
    }
    const float cnt = (float)(SS * (Cc / G));
    const float mean = s / cnt;
    gstat[t] = mean;
    gstat[G + t] = 1.f / sqrtf(q / cnt - mean * mean + 1e-5f);
  }
  __syncthreads();
  for (int c = t; c < Cc; c += NT) {
    const int g = c / (Cc / G);
    cm[c] = gstat[g];
    cr[c] = gstat[G + g];
  }
  __syncthreads();

  const int q = t % 4, it = t / 4;
  int base[M];  // staged pixel of each position's tap (0, 0)
#pragma unroll
  for (int m = 0; m < M; ++m) {
    const int p = min(p0 + it + heads::ITEMS * m, p1 - 1);
    base[m] = (p / S - ya) * SP + p % S;
  }
  // f32 heads sum in f64 (see HeadSum)
  typedef typename HeadSum<T>::type A;
  A acc[M][4];
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int o = 0; o < 4; ++o) acc[m][o] = 0;
  const int stages = Cc / (CH * pps);
  for (int s_ = 0; s_ < stages; ++s_) {
    // this thread's copies of stage s_ are in; it normalises them in
    // place (rows on the map only: the padding stays zero)
    wg::cp_async_wait<0>();
    for (int xq = xq0; xq < SQ; xq += NT)
      for (int j = 0; j < pps; ++j) {
        const int c = (s_ * pps + j) * CH + xq % Q * 4;
        const float4 mu = *(const float4*)(cm + c);
        const float4 rs = *(const float4*)(cr + c);
        const float4 sc = *(const float4*)(csc + c);
        const float4 sh = *(const float4*)(csh + c);
        for (int r = r0; r < nrows; r += rstep) {
          const int y = ya - 1 + r;
          if (y < 0 || y >= S) continue;
          float4& v = stage[((j * nrows + r) * SP + xq / Q + 1) * Q + xq % Q];
          v.x = normed<T>(v.x, mu.x, rs.x, sc.x, sh.x);
          v.y = normed<T>(v.y, mu.y, rs.y, sc.y, sh.y);
          v.z = normed<T>(v.z, mu.z, rs.z, sc.z, sh.z);
          v.w = normed<T>(v.w, mu.w, rs.w, sc.w, sh.w);
        }
      }
    __syncthreads();
    for (int j = 0; j < pps; ++j) {
      const float4* pl = stage + j * plane_px * Q;
      const int c0 = (s_ * pps + j) * CH;
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const int off = (tap / 3) * SP + tap % 3;
        const float4* wr = W4 + tap * 4 * C4 + c0 / 4 + q;
        const float4 w0 = wr[0], w1 = wr[C4], w2 = wr[2 * C4],
                     w3 = wr[3 * C4];
#pragma unroll
        for (int m = 0; m < M; ++m) {
          const float4 a = pl[(base[m] + off) * Q + q];
          acc[m][0] = madd((A)a.w, (A)w3.x, madd((A)a.z, (A)w2.x,
                      madd((A)a.y, (A)w1.x, madd((A)a.x, (A)w0.x, acc[m][0]))));
          acc[m][1] = madd((A)a.w, (A)w3.y, madd((A)a.z, (A)w2.y,
                      madd((A)a.y, (A)w1.y, madd((A)a.x, (A)w0.y, acc[m][1]))));
          acc[m][2] = madd((A)a.w, (A)w3.z, madd((A)a.z, (A)w2.z,
                      madd((A)a.y, (A)w1.z, madd((A)a.x, (A)w0.z, acc[m][2]))));
          acc[m][3] = madd((A)a.w, (A)w3.w, madd((A)a.z, (A)w2.w,
                      madd((A)a.y, (A)w1.w, madd((A)a.x, (A)w0.w, acc[m][3]))));
        }
      }
    }
    if (s_ + 1 < stages) {
      __syncthreads();  // the stage's heads are done
      fetch(s_ + 1);
    }
  }
  // the four quads' sums (every lane gets the same bits), lane q writes
  // output q
#pragma unroll
  for (int m = 0; m < M; ++m) {
#pragma unroll
    for (int o = 0; o < 4; ++o) {
      acc[m][o] += __shfl_xor_sync(0xffffffff, acc[m][o], 1);
      acc[m][o] += __shfl_xor_sync(0xffffffff, acc[m][o], 2);
    }
    const float v = (float)(q == 0 ? acc[m][0]
                          : q == 1 ? acc[m][1]
                          : q == 2 ? acc[m][2]
                                   : acc[m][3]);
    const int p = p0 + it + heads::ITEMS * m;
    if (p >= p1) continue;
    if (tower == 0) {
      if (q < 2)
        cls[((size_t)k * SS + p) * 2 + q] = v + load_f32(P.bcls, q);
      else if (q == 2)
        ctr[(size_t)k * SS + p] = v + load_f32(P.bctr, 0);
    } else {
      reg[((size_t)k * SS + p) * 4 + q] = fmaxf(v + load_f32(P.breg, q), 0.f);
    }
  }
}

// ---------------------------------------------------------------------------
// host side

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

// The dynamic shared memory `Kern` may use: the card's per-block opt-in
// limit less the kernel's static shared memory, opted in at the first
// call (the wrappers run once before any CUDA graph capture; an opt-in
// inside one would fail); 0 if the card says no.
template <auto Kern>
static size_t optin_once() {
  static const size_t limit = [] {
    int dev = 0, optin = 0;
    cudaFuncAttributes fa;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev) != cudaSuccess ||
        cudaFuncGetAttributes(&fa, Kern) != cudaSuccess)
      return (size_t)0;
    const size_t l = (size_t)optin - fa.sharedSizeBytes;
    return set_smem(Kern, l) == cudaSuccess ? l : (size_t)0;
  }();
  return limit;
}

// shared memory the bf16 tower conv needs at (S, C), or -1 past the
// card's limit (the wrapper raises)
SIAMMOT_API int siammot_emm_tower_smem(int S, int Cc) {
  const size_t need = tconv::smem_bytes(S, Cc);
  return need <= optin_once<tower_conv_wgmma>() ? (int)need : -1;
}

// the head pass with `pps` planes a stage and `smem` bytes of shared
// memory (ops/predictor.py:head_plan)
template <typename T>
static cudaError_t launch_heads(const float* pre, const float2* part,
                                const uint8_t* valid,
                                const TiledParams<T>& P, float* cls,
                                float* ctr, float* reg, int K, int S, int Cc,
                                int tiles, int pps, size_t smem,
                                cudaStream_t st) {
  if (pps < 1 || Cc % (CH * pps) ||
      smem < heads::smem_bytes(S, Cc, pps) ||
      smem > optin_once<heads_band<T>>())
    return cudaErrorInvalidValue;
  const dim3 grid((S * S + heads::BP - 1) / heads::BP, 2, K);
  heads_band<T><<<grid, heads::THREADS, smem, st>>>(
      pre, part, valid, P, cls, ctr, reg, K, S, Cc, tiles, pps);
  return cudaGetLastError();
}

// Kernels 3 and 8.  params: the 14 tensors in the order of
// ops/predictor.py _NAMES; dtype 0 = float32, 1 = bfloat16 (16-byte
// aligned); pre: f32 scratch [2, K, C/16, S*S, 16]; part: f32 [2, K,
// tiles, 32, 2] (tiles: the tower conv's position tiles x channel tiles,
// ops/predictor.py:stat_tiles); head_pps, head_smem: the head pass's plan
// (ops/predictor.py:head_plan).
SIAMMOT_API int siammot_emm_predictor(
    const void* x, const uint8_t* valid, const void* const* params,
    float* pre, float* part, float* cls, float* ctr, float* reg, int K,
    int S, int Cc, int head_pps, int head_smem, int dtype, void* stream) {
  if (K == 0) return 0;
  if (Cc % G || S < 1 || 2 * K > 65535) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const int SS = S * S;
  float2* part2 = (float2*)part;
  cudaError_t err;
  if (dtype == 1) {
    const size_t smem = tconv::smem_bytes(S, Cc);
    if (smem > optin_once<tower_conv_wgmma>())
      return (int)cudaErrorInvalidValue;
    const TiledParams<bf16> P = tiled_params<bf16>(params);
    const dim3 grid((SS + tconv::BM - 1) / tconv::BM,
                    (Cc + wg::N - 1) / wg::N, 2 * K);
    tower_conv_wgmma<<<grid, tconv::THREADS, smem, st>>>(
        (const bf16*)x, valid, P, pre, part2, K, S, Cc);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    err = launch_heads<bf16>(pre, part2, valid, P, cls, ctr, reg, K, S, Cc,
                             grid.x * grid.y, head_pps, head_smem, st);
  } else {
    const TiledParams<float> P = tiled_params<float>(params);
    const dim3 grid((SS + TP - 1) / TP, (Cc + TC - 1) / TC, 2 * K);
    tower_conv_tiled<float><<<grid, CONV_THREADS, 0, st>>>(
        (const float*)x, valid, P, pre, part2, K, S, Cc);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    err = launch_heads<float>(pre, part2, valid, P, cls, ctr, reg, K, S, Cc,
                              grid.x * grid.y, head_pps, head_smem, st);
  }
  return (int)err;
}
