// Kernel 6's template gradient on the tensor cores: the CUDA counterpart
// of the Pallas kernel siammot_tpu/ops/pallas/xcorr.py:xcorr_depthwise_
// pallas without ``valid`` (_xcorr_kernel, pl.pallas_call at :80) as the
// JAX VJP reaches it for the template (siammot_tpu/ops/xcorr.py:
// _xcorr_bwd: d_template = xcorr(search, g)).
//
//   out[k, u, v, c] = sum_i sum_j g[k, i, j, c] * s[k, u + i, v + j, c]
//
// s [K, Hs, Ws, C] (the search region) and g [K, Hg, Wg, C] (the upstream
// gradient of the xcorr), each f32 or bf16; out [K, Ht, Wt, C] f32,
// Ht = Hs - Hg + 1, Wt = Ws - Wg + 1 <= 32 (the template).
//
// Bound on the H100: bytes.  The op is depthwise, but for one (slot,
// channel) and one search row r it is a small matrix product,
//   out[u, v] += sum_x A_r[u, x] B_r[x, v],
//   A_r[u, x] = g[r - u, x] (rows of g, shifted; M = Ht, K = Wg)
//   B_r[x, v] = s[r, x + v] (a Hankel matrix of one search row; N = Wt)
// summed over the Hs search rows, which mma.sync.m16n8k16 takes (bf16
// operands, f32 sums).  On the tensor cores the operations are a fraction
// of the time to read the inputs once and write the output once: 0.374 ms
// at SEARCH_REGION 5 (75x75 search, 61x61 g, N = 256, f32), 1.058 ms at
// a SEARCH_REGION 5 training step (N = 1024, bf16 search), 0.235 ms at
// the AOT recipe's step (35x35 search, 29x29 g, N = 1024), at 3.35 TB/s.
// The FFMA kernel it replaces (xcorr6_kernel, and a banded fallback past
// its shared memory) sat near the CUDA cores' rate, 0.82 ms at the first.
//
// The design:
// - Exact operands.  A bf16 input is used as it is; an f32 one is split
//   into three bf16 terms, x = hi + mid + lo (24 bits: exact), and the
//   products whose order is at most 2^-16 are summed
//   (three for f32 g with bf16 s, six for both f32, one for both bf16),
//   smallest first.  Two terms (16 bits) miss atol 1e-4 over the 3721
//   taps of SEARCH_REGION 5 (tests/test_torch_xcorr_grad.py shows it on
//   the CPU).
// - Compensated sums.  Each step's products go into fresh mma
//   accumulators, which are added into per-thread Kahan sums; the
//   epilogue adds the sums and their compensations in f64 and rounds once.
//   No float atomics: two launches give the same bits.
// - One A tile for P search rows.  The A tile holds g rows R - u' for
//   u' = 0..15; search row R - p meets it at rows u' = u + p, so for
//   Ht + P - 1 <= 16 it serves P rows (P = 2 at a 15-high template, 4 at
//   a 7-high one), each into its own accumulator set, realigned by p rows
//   in the epilogue.  This halves (quarters) the ldmatrix traffic of A,
//   which sets the pace with three terms of g.
// - Output tiles.  An output row of up to 8, 16 or 32 columns is one,
//   two or four n8 tiles.  Taller outputs than 16 rows are cut into row
//   blocks of equal height (at most 16: one m16 tile), each the product
//   of its own search rows with all of g, so POOLER_RESOLUTION up to 32
//   runs here too.
// - Shared memory.  A persistent grid walks (slot, row block, tile of 8
//   channels) items, a warp a channel, and each item's search rows in
//   bands of BR
//   (ops/xcorr.py:grad_template_plan).  A band's rows of s and g arrive
//   channels-last by 16-byte cp.async in a raw buffer while the previous
//   band computes; then the block splits them into per-channel planes of
//   bf16 terms: g into a ring of its last BR + 16 - P rows (128-byte rows
//   XOR-swizzled by 16-byte chunk, so ldmatrix's eight rows hit distinct
//   banks; a zero row stands for rows outside g), the search rows twice,
//   the second copy one element to the right, so that every Hankel
//   fragment (s[e], s[e + 1]) is one aligned 32-bit load.
// - The epilogue writes each warp's channel through shared memory, so
//   that an output pixel's 8 channels leave as 32 contiguous bytes.
#include <algorithm>

#include "common.cuh"

namespace k6g {

constexpr int TILE = 8;              // channels an item, a warp each
constexpr int THREADS = 32 * TILE;

// One launch's geometry and shared-memory layout (bytes; the zero row at
// offset 0).  Mirrored by ops/xcorr.py:grad_template_plan.
struct Geo {
  int hs, ws, hg, wg, ht, wt, C;  // hs, ht: a row block's rows
  int hs_in, ht_out, nbh;         // the search's and output's rows, blocks
  int tiles, items;
  int p, br, nb, ring;  // rows an A tile serves, search rows a band, bands,
                        // ring rows of g
  int ks, rb;           // k16 steps over wg; bytes of a ring row
  int key_shift, key_mask;  // chunk swizzle of g row y: (y >> shift) & mask
  int srow, copy;       // bytes of a search row; copy 0 to copy 1
  int g_plane, s_plane; // bytes of a (term, channel) plane
  int off_ring, off_s, off_raw_g, off_raw_s, smem;
  int vec;              // 16-byte cp.async staging
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void sts128(uint32_t addr, const uint32_t (&v)[4]) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "r"(v[0]), "r"(v[1]), "r"(v[2]), "r"(v[3])
               : "memory");
}

// d += a * b: m16n8k16, bf16 in, f32 sums
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d = a * b: the same from zero
__device__ __forceinline__ void mma_bf16_zero(float (&d)[4],
                                              const uint32_t (&a)[4],
                                              uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.f));
}

template <typename T>
__host__ __device__ constexpr int terms_of() {
  return sizeof(T) == 4 ? 3 : 1;
}

// The pair (a, b) as three bf16x2 terms: hi = x rounded to bf16 (to
// nearest, ties away: 0x8000 added to the f32 bits, the low 16 bits
// cleared), mid the same of x - hi, lo = x - hi - mid (at most 8
// significant bits left, so a bf16 exactly); each difference is exact in
// f32 and hi + mid + lo = x, 24 bits.  A term packs the upper halves of
// a's and b's f32 bits.
__device__ __forceinline__ void split3(float a, float b, uint32_t (&w)[3]) {
#pragma unroll
  for (int t = 0; t < 3; ++t) {
    uint32_t ua = __float_as_uint(a), ub = __float_as_uint(b);
    if (t < 2) {
      ua = (ua + 0x8000u) & 0xffff0000u;
      ub = (ub + 0x8000u) & 0xffff0000u;
      a -= __uint_as_float(ua);
      b -= __uint_as_float(ub);
    }
    w[t] = __byte_perm(ua, ub, 0x7632);
  }
}

// The raw buffer: a band's rows channels-last, TILE channels a pixel, in
// 16-byte units XOR-swizzled within each group of 8, so that the split's
// reads of a unit at 8 pixels apart spread over the banks.
__device__ __forceinline__ int raw_off(int byte) {
  const int u = byte >> 4;
  return ((u ^ ((u >> 3) & 7)) << 4) | (byte & 15);
}

// the 32-bit word at element `i` (of `size` bytes) of the raw buffer, and
// the 64-bit word of an f32 channel pair
__device__ __forceinline__ uint32_t raw_word(const unsigned char* raw, int i,
                                            int size) {
  return *(const uint32_t*)(raw + raw_off(i * size));
}

__device__ __forceinline__ uint2 raw_pair(const unsigned char* raw, int i) {
  return *(const uint2*)(raw + raw_off(i * 4));
}

// Stage rows [y0, y1) of one slot's [h, w, C] input, channels [c0, c0 +
// TILE), into the raw buffer: 16-byte cp.async copies, or element loads
// with zeros past C.
template <typename T>
__device__ __forceinline__ void stage_raw(const T* __restrict__ src, int y0,
                                          int y1, int w, int C, int c0,
                                          bool vec, unsigned char* raw) {
  const T* base = src + (size_t)y0 * w * C + c0;
  const int px = (y1 - y0) * w;
  if (vec) {
    constexpr int UPX = TILE * (int)sizeof(T) / 16;  // units a pixel
    constexpr int E = 16 / (int)sizeof(T);
    for (int e = threadIdx.x; e < px * UPX; e += THREADS)
      cp_async16(raw + raw_off(e << 4),
                 base + (size_t)(e / UPX) * C + (e % UPX) * E);
  } else {
    for (int e = threadIdx.x; e < px * TILE; e += THREADS) {
      const int ch = e % TILE, p = e / TILE;
      *(T*)(raw + raw_off(e * (int)sizeof(T))) =
          c0 + ch < C ? base[(size_t)p * C + ch] : zero_of<T>();
    }
  }
}

// Split a band from the raw buffer into the planes, one unit of work a
// 16-byte chunk (8 columns) of one row and one channel pair (f32: three
// terms each): g rows [y0, y1g) into the ring, zeros past wg; search rows
// [y0, y1s) into the band's planes, copy 0 holding s[x] at x and copy 1
// at x + 1, zeros outside the row and in the band's rows past y1s.  A
// thread keeps one channel pair and steps its (row, chunk) without
// dividing.
template <typename TS_T, typename TG_T>
__device__ __forceinline__ void split_band(const Geo& G, unsigned char* smem,
                                           int y0, int y1g, int y1s) {
  constexpr bool GF = sizeof(TG_T) == 4, SF = sizeof(TS_T) == 4;
  constexpr int U = TILE / 2;       // units a chunk: channel pairs
  constexpr int Q = THREADS / U;    // (row, chunk) a pass
  const unsigned char* raw_g = smem + G.off_raw_g;
  const unsigned char* raw_s = smem + G.off_raw_s;
  const int nchg = G.rb >> 4, nchs = G.srow >> 4;
  const uint32_t ring = smem_addr(smem + G.off_ring);
  const uint32_t planes = smem_addr(smem + G.off_s);
  const int m = threadIdx.x % U, q = threadIdx.x / U;  // channels 2m, 2m + 1
  {
    const int slot0 = y0 % G.ring;
    int c = q % nchg, yr = q / nchg;
    const int dc = Q % nchg, dy = Q / nchg;
    for (; y0 + yr < y1g; c += dc, yr += dy) {
      if (c >= nchg) c -= nchg, ++yr;
      if (y0 + yr >= y1g) break;
      const int y = y0 + yr, key = (y >> G.key_shift) & G.key_mask;
      const int slot = slot0 + yr - (slot0 + yr >= G.ring ? G.ring : 0);
      const uint32_t dst = ring + (uint32_t)(slot * G.rb + ((c ^ key) << 4));
      // columns 8c .. 8c + 7 of channels 2m, 2m + 1
      uint32_t v0[8], v1[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int x = 8 * c + j;
        const int i = (yr * G.wg + x) * TILE + 2 * m;
        if constexpr (GF) {
          const uint2 u = x < G.wg ? raw_pair(raw_g, i) : make_uint2(0, 0);
          v0[j] = u.x, v1[j] = u.y;
        } else {
          v0[j] = x < G.wg ? raw_word(raw_g, i, 2) : 0u;
        }
      }
      if constexpr (GF) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {  // channel 2m + h
          const uint32_t(&v)[8] = h ? v1 : v0;
          uint32_t t3[4][3];
#pragma unroll
          for (int j = 0; j < 4; ++j)
            split3(__uint_as_float(v[2 * j]), __uint_as_float(v[2 * j + 1]),
                   t3[j]);
#pragma unroll
          for (int t = 0; t < 3; ++t)
            sts128(dst + (uint32_t)((t * TILE + 2 * m + h) * G.g_plane),
                   {t3[0][t], t3[1][t], t3[2][t], t3[3][t]});
        }
      } else {
#pragma unroll
        for (int h = 0; h < 2; ++h) {  // channel 2m + h
          const uint32_t sel = h ? 0x7632 : 0x5410;
          uint32_t o[4];
#pragma unroll
          for (int j = 0; j < 4; ++j)
            o[j] = __byte_perm(v0[2 * j], v0[2 * j + 1], sel);
          sts128(dst + (uint32_t)((2 * m + h) * G.g_plane), o);
        }
      }
    }
  }
  int c = q % nchs, y = q / nchs;
  const int dc = Q % nchs, dy = Q / nchs;
  for (; y < G.br; c += dc, y += dy) {
    if (c >= nchs) c -= nchs, ++y;
    if (y >= G.br) break;
    const uint32_t dst = planes + (uint32_t)(y * G.srow + (c << 4));
    // columns 8c - 1 .. 8c + 7 of channels 2m, 2m + 1
    uint32_t v0[9], v1[9];
#pragma unroll
    for (int j = 0; j < 9; ++j) {
      const int x = 8 * c + j - 1;
      const bool in = x >= 0 && x < G.ws && y0 + y < y1s;
      const int i = (y * G.ws + x) * TILE + 2 * m;
      if constexpr (SF) {
        const uint2 u = in ? raw_pair(raw_s, i) : make_uint2(0, 0);
        v0[j] = u.x, v1[j] = u.y;
      } else {
        v0[j] = in ? raw_word(raw_s, i, 2) : 0u;
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // channel 2m + h
      if constexpr (SF) {
        const uint32_t(&v)[9] = h ? v1 : v0;
        uint32_t c0[4][3], first[3];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          split3(__uint_as_float(v[2 * j + 1]), __uint_as_float(v[2 * j + 2]),
                 c0[j]);
        split3(__uint_as_float(v[0]), 0.f, first);
#pragma unroll
        for (int t = 0; t < 3; ++t) {
          const uint32_t d =
              dst + (uint32_t)((t * TILE + 2 * m + h) * G.s_plane);
          sts128(d, {c0[0][t], c0[1][t], c0[2][t], c0[3][t]});
          sts128(d + (uint32_t)G.copy,
                 {__byte_perm(first[t], c0[0][t], 0x5410),
                  __byte_perm(c0[0][t], c0[1][t], 0x5432),
                  __byte_perm(c0[1][t], c0[2][t], 0x5432),
                  __byte_perm(c0[2][t], c0[3][t], 0x5432)});
        }
      } else {
        const uint32_t sel = h ? 0x7632 : 0x5410;
        uint32_t o0[4], o1[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          o0[j] = __byte_perm(v0[2 * j + 1], v0[2 * j + 2], sel);
          o1[j] = __byte_perm(v0[2 * j], v0[2 * j + 1], sel);
        }
        const uint32_t d = dst + (uint32_t)((2 * m + h) * G.s_plane);
        sts128(d, o0);
        sts128(d + (uint32_t)G.copy, o1);
      }
    }
  }
}

// The persistent kernel.  Block b takes items b, b + grid, ...; the
// (item, band) stream's next band is in flight (cp.async) while the
// current one computes.  PMAX accumulator sets of NT n-tiles a warp; the
// k-steps unrolled in segments of KSC (G.ks of them in all).
template <int NT, int KSC, typename TS_T, typename TG_T>
__global__ void __launch_bounds__(THREADS, 2)
    xcorr_grad_template_mma(const TS_T* __restrict__ search,
                            const TG_T* __restrict__ grad,
                            float* __restrict__ out, const Geo G) {
  constexpr int PMAX = 4 / NT;
  constexpr bool KAHAN = KSC == 4;
  constexpr int TS = terms_of<TS_T>(), TG = terms_of<TG_T>();
  extern __shared__ __align__(128) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const uint32_t sbase = smem_addr(smem);

  for (int e = threadIdx.x; e < G.rb / 4; e += THREADS)
    ((uint32_t*)smem)[e] = 0u;  // the zero row

  // ldmatrix: lane supplies row u' = (lane & 7) + 8 ((lane >> 3) & 1) of
  // the A tile, k-chunk (lane >> 4) of the k-step
  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8, a_h = lane >> 4;
  // Hankel fragments: lane reads word 4q + tig + (gid + 1) / 2 of copy
  // gid & 1 for q = 2 ks + h + nt
  const unsigned char* b_lane =
      smem + G.off_s + warp * G.s_plane + (gid & 1) * G.copy +
      4 * (tig + ((gid + 1) >> 1));
  const uint32_t a_plane = sbase + G.off_ring + (uint32_t)(warp * G.g_plane);

  float sum[PMAX][NT][4], comp[PMAX][NT][4];
#pragma unroll
  for (int p = 0; p < PMAX; ++p)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) sum[p][n][i] = comp[p][n][i] = 0.f;

  auto item_of = [&](int s) { return blockIdx.x + (s / G.nb) * gridDim.x; };
  // an item's slot, first output row (its row block) and first channel
  auto where = [&](int item, int& k, int& u0, int& ch0) {
    const int kb = item / G.tiles;
    k = kb / G.nbh, u0 = (kb % G.nbh) * G.ht, ch0 = (item % G.tiles) * TILE;
  };
  // the end of band y0's search rows: the block's, within the search
  auto band_end = [&](int u0, int y0) {
    return min(min(G.hs, G.hs_in - u0), y0 + G.br);
  };
  auto stage = [&](int s) {
    int k, u0, ch0;
    where(item_of(s), k, u0, ch0);
    const int y0 = (s % G.nb) * G.br;
    if (y0 < G.hg)
      stage_raw(grad + (size_t)k * G.hg * G.wg * G.C, y0,
                min(G.hg, y0 + G.br), G.wg, G.C, ch0, G.vec,
                smem + G.off_raw_g);
    stage_raw(search + ((size_t)k * G.hs_in + u0) * G.ws * G.C, y0,
              band_end(u0, y0), G.ws, G.C, ch0, G.vec, smem + G.off_raw_s);
    cp_async_commit();
  };

  if (item_of(0) < G.items) stage(0);
  for (int s = 0; item_of(s) < G.items; ++s) {
    const int item = item_of(s), band = s % G.nb, y0 = band * G.br;
    int k, u0, ch0;
    where(item, k, u0, ch0);
    const int y1 = band_end(u0, y0);
    cp_async_wait<0>();
    __syncthreads();  // the raw band is in; the previous band is done
    split_band<TS_T, TG_T>(G, smem, y0, min(G.hg, y0 + G.br), y1);
    __syncthreads();
    if (item_of(s + 1) < G.items) stage(s + 1);

    // the band's steps: anchor R, search rows R - p; this lane's A row
    // is g row R - a_row, at ring slot `slot`
    int slot = (y0 + G.p - 1 - a_row) % G.ring;
    slot += slot < 0 ? G.ring : 0;
    for (int R = y0 + G.p - 1; R - G.p + 1 < y1; R += G.p) {
      const int gy = R - a_row;
      const bool in_g = gy >= 0 && gy < G.hg;
      const uint32_t a_row_addr =
          in_g ? a_plane + (uint32_t)(slot * G.rb) : sbase;
      const int key = in_g ? (gy >> G.key_shift) & G.key_mask : 0;
      slot += G.p - (slot + G.p >= G.ring ? G.ring : 0);
      // fresh sums a step: the step's first product starts from zero.
      // Without the Kahan sums' registers, the next k-step's fragments
      // load while this one's products run.
      float acc[PMAX][NT][4];
      uint32_t a[KAHAN ? 1 : 2][TG][4], b[KAHAN ? 1 : 2][PMAX][TS][NT + 1];
      auto load = [&](int ks, uint32_t (&af)[TG][4],
                      uint32_t (&bf)[PMAX][TS][NT + 1]) {
        const uint32_t chunk = (uint32_t)(((2 * ks + a_h) ^ key) << 4);
#pragma unroll
        for (int tg = 0; tg < TG; ++tg)
          ldsm_x4(af[tg], a_row_addr + chunk +
                              (in_g ? (uint32_t)(tg * TILE * G.g_plane) : 0u));
        // each set's Hankel fragments (rows past the band's last search
        // row are zeros)
#pragma unroll
        for (int p = 0; p < PMAX; ++p) {
          if (p >= G.p) continue;
          const unsigned char* brow = b_lane + (R - p - y0) * G.srow + 32 * ks;
#pragma unroll
          for (int ts = 0; ts < TS; ++ts)
#pragma unroll
            for (int q = 0; q <= NT; ++q)
              bf[p][ts][q] =
                  *(const uint32_t*)(brow + ts * TILE * G.s_plane + 16 * q);
        }
      };
      load(0, a[0], b[0]);
      for (int k0 = 0; k0 < G.ks; k0 += KSC) {
#pragma unroll
        for (int kk = 0; kk < KSC; ++kk) {
          const int ks = k0 + kk, cur = KAHAN ? 0 : kk & 1;
          if (KSC > 2 && ks >= G.ks) break;
          if constexpr (KAHAN) {
            if (ks > 0) load(ks, a[0], b[0]);
          } else if (ks + 1 < G.ks) {
            load(ks + 1, a[cur ^ 1], b[cur ^ 1]);
          }
          // the products, smallest first (order ts + tg = 2, 1, 0), the
          // sets' chains interleaved
          bool first = ks == 0;
#pragma unroll
          for (int o = 2; o >= 0; --o)
#pragma unroll
            for (int ts = 0; ts < TS; ++ts)
#pragma unroll
              for (int tg = 0; tg < TG; ++tg) {
                if (ts + tg != o) continue;
#pragma unroll
                for (int p = 0; p < PMAX; ++p) {
                  if (p >= G.p) continue;
#pragma unroll
                  for (int n = 0; n < NT; ++n)
                    if (first)
                      mma_bf16_zero(acc[p][n], a[cur][tg], b[cur][p][ts][n],
                                    b[cur][p][ts][n + 1]);
                    else
                      mma_bf16(acc[p][n], a[cur][tg], b[cur][p][ts][n],
                               b[cur][p][ts][n + 1]);
                }
                first = false;
              }
        }
      }
      // into the running sums: compensated (Kahan) for g past 32 wide
      // (SEARCH_REGION 5's 3721 taps), where an f32 sum's rounding would
      // show beside the tolerance
#pragma unroll
      for (int p = 0; p < PMAX; ++p) {
        if (p >= G.p) continue;
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            if constexpr (KAHAN) {
              const float y = acc[p][n][i] - comp[p][n][i];
              const float t = sum[p][n][i] + y;
              comp[p][n][i] = (t - sum[p][n][i]) - y;
              sum[p][n][i] = t;
            } else {
              sum[p][n][i] += acc[p][n][i];
            }
          }
      }
    }
    if (band != G.nb - 1) continue;

    // epilogue: out[u, v] = sum_p (sum - comp)_p[u + p, v] in f64, the
    // rows realigned by shuffles; through shared memory (the planes)
    __syncthreads();
    float* e_out = (float*)(smem + G.off_s);
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        double lo = 0.0, hi = 0.0;  // rows gid and gid + 8
#pragma unroll
        for (int p = 0; p < PMAX; ++p) {
          const int src = ((gid + p) & 7) * 4 + tig;
          const bool wrap = gid + p >= 8;
          const float s0 = __shfl_sync(~0u, sum[p][n][j], src);
          const float c0 = __shfl_sync(~0u, comp[p][n][j], src);
          const float s2 = __shfl_sync(~0u, sum[p][n][2 + j], src);
          const float c2 = __shfl_sync(~0u, comp[p][n][2 + j], src);
          if (p >= G.p) continue;
          lo += wrap ? (double)s2 - (double)c2 : (double)s0 - (double)c0;
          if (!wrap) hi += (double)s2 - (double)c2;
        }
        const int v = 8 * n + 2 * tig + j;
        if (v < G.wt) {
          if (gid < G.ht) e_out[(gid * G.wt + v) * TILE + warp] = (float)lo;
          if (gid + 8 < G.ht)
            e_out[((gid + 8) * G.wt + v) * TILE + warp] = (float)hi;
        }
      }
#pragma unroll
    for (int p = 0; p < PMAX; ++p)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) sum[p][n][i] = comp[p][n][i] = 0.f;
    __syncthreads();
    float* o = out + ((size_t)k * G.ht_out + u0) * G.wt * G.C + ch0;
    const int npx = min(G.ht, G.ht_out - u0) * G.wt;
    if (G.vec) {
      for (int e = threadIdx.x; e < npx * 2; e += THREADS)
        *(float4*)(o + (size_t)(e >> 1) * G.C + 4 * (e & 1)) =
            *(const float4*)(e_out + 4 * e);
    } else {
      for (int e = threadIdx.x; e < npx * TILE; e += THREADS)
        if (ch0 + e % TILE < G.C)
          o[(size_t)(e / TILE) * G.C + e % TILE] = e_out[e];
    }
  }
  cp_async_wait<0>();
}

// The layout of one launch (ops/xcorr.py:grad_template_plan mirrors it);
// false for shapes the kernel does not take.
static bool geometry(Geo& G, int K, int hs, int ws, int hg, int wg, int C,
                     int s_size, int g_size, int band_rows) {
  G = Geo{};
  G.hs_in = hs, G.ws = ws, G.hg = hg, G.wg = wg, G.C = C;
  G.ht_out = hs - hg + 1, G.wt = ws - wg + 1;
  if (hg < 1 || wg < 1 || G.ht_out < 1 || G.wt < 1 || G.wt > 32)
    return false;
  G.nbh = (G.ht_out + 15) / 16;  // row blocks of equal height, <= 16
  G.ht = (G.ht_out + G.nbh - 1) / G.nbh;
  G.hs = G.ht + hg - 1;
  const int nt = G.wt <= 8 ? 1 : G.wt <= 16 ? 2 : 4;
  G.p = std::min(4 / nt, 17 - G.ht);
  if (band_rows < G.p || band_rows % G.p) return false;
  G.br = band_rows;
  G.nb = (G.hs + G.br - 1) / G.br;
  G.ks = (wg + 15) / 16;
  const int ksp = G.ks <= 2 ? G.ks : (G.ks + 3) / 4 * 4;
  G.rb = 32 * ksp;
  const int nch = std::min(G.rb / 16, 8);
  const int key_div = 8 / nch;  // the ring's rows a multiple of it
  G.key_shift = key_div == 4 ? 2 : key_div == 2 ? 1 : 0;
  G.key_mask = nch - 1;
  G.ring = (G.br + 16 - G.p + key_div - 1) / key_div * key_div;
  const int s_elems = std::max(ws + 1, 8 * (2 * G.ks + nt - 2) + 16);
  G.srow = (2 * s_elems + 15) / 16 * 16;
  G.copy = G.br * G.srow;
  G.copy += ((64 - G.copy % 128) + 128) % 128;  // copy 1 at +64 mod 128
  G.s_plane = 2 * G.copy + 16;
  G.g_plane = G.ring * G.rb + 16;
  const int tg = g_size == 4 ? 3 : 1, ts = s_size == 4 ? 3 : 1;
  G.off_ring = G.rb;
  G.off_s = G.off_ring + tg * TILE * G.g_plane;
  const int s_bytes = std::max(ts * TILE * G.s_plane, G.ht * G.wt * TILE * 4);
  G.off_raw_g = G.off_s + (s_bytes + 15) / 16 * 16;
  G.off_raw_s =
      G.off_raw_g + (G.br * wg * TILE * g_size + 127) / 128 * 128;
  G.smem = G.off_raw_s + (G.br * ws * TILE * s_size + 127) / 128 * 128;
  G.tiles = (C + TILE - 1) / TILE;
  G.items = K * G.nbh * G.tiles;
  return true;
}

template <int NT, int KSC, typename TS_T, typename TG_T>
static int launch(const void* s, const void* g, float* out, const Geo& G,
                  cudaStream_t stream) {
  auto kernel = xcorr_grad_template_mma<NT, KSC, TS_T, TG_T>;
  cudaError_t err = set_smem(kernel, G.smem);
  if (err != cudaSuccess) return (int)err;
  const int resident = resident_blocks(kernel, THREADS, G.smem);
  if (resident == 0) return (int)cudaErrorInvalidConfiguration;
  kernel<<<std::min(G.items, resident), THREADS, G.smem, stream>>>(
      (const TS_T*)s, (const TG_T*)g, out, G);
  return (int)cudaGetLastError();
}

// k-steps a segment 1, 2 or 4 (rows of g up to 16, 32 or any width)
template <int NT, typename TS_T, typename TG_T>
static int launch_nt(const void* s, const void* g, float* out, const Geo& G,
                     cudaStream_t stream) {
  return G.ks == 1   ? launch<NT, 1, TS_T, TG_T>(s, g, out, G, stream)
         : G.ks == 2 ? launch<NT, 2, TS_T, TG_T>(s, g, out, G, stream)
                     : launch<NT, 4, TS_T, TG_T>(s, g, out, G, stream);
}

// n-tiles 1 (Wt <= 8), 2 (Wt <= 16) or 4
template <typename TS_T, typename TG_T>
static int launch_dt(const void* s, const void* g, float* out, Geo& G,
                     cudaStream_t stream) {
  G.vec = G.C % TILE == 0 && (uintptr_t)s % 16 == 0 &&
          (uintptr_t)g % 16 == 0 && (uintptr_t)out % 16 == 0;
  return G.wt <= 8    ? launch_nt<1, TS_T, TG_T>(s, g, out, G, stream)
         : G.wt <= 16 ? launch_nt<2, TS_T, TG_T>(s, g, out, G, stream)
                      : launch_nt<4, TS_T, TG_T>(s, g, out, G, stream);
}

}  // namespace k6g

// Kernel 6's template gradient: xcorr(search, grad) -> [K, hs - hg + 1,
// ws - wg + 1, C] f32, the search rows in bands of `band_rows`
// (ops/xcorr.py:grad_template_plan).  dtype codes: 0 f32, 1 bf16.
SIAMMOT_API int siammot_xcorr_grad_template(const void* search,
                                            int search_dtype,
                                            const void* grad, int grad_dtype,
                                            float* out, int K, int hs, int ws,
                                            int hg, int wg, int C,
                                            int band_rows, void* stream) {
  if (K == 0) return 0;
  k6g::Geo G;
  if (!k6g::geometry(G, K, hs, ws, hg, wg, C, search_dtype ? 2 : 4,
                     grad_dtype ? 2 : 4, band_rows))
    return (int)cudaErrorInvalidValue;
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  if (G.smem > optin) return (int)cudaErrorInvalidValue;
  return SIAMMOT_DISPATCH2(search_dtype, grad_dtype, k6g::launch_dt, search,
                           grad, out, G, (cudaStream_t)stream);
}
