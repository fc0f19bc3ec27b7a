// Windowed ROIAlign pool (kernel 1): the CUDA counterpart of the Pallas
// kernel siammot_tpu/ops/pallas/window_pool.py:window_pool_pallas
// (_kernel).
//
// out[n, i, j, c] = sum_y wy[n, i, y] * sum_x wx[n, j, x]
//                   * table[row0[n] + y, col0[n] + x, c]
// with the bin average already folded into wy / wx (roi_align_windowed);
// f32 sums, x first, taps with a zero weight skipped.
//
// Bound on the H100: bytes.  Each row of wy / wx holds at most
// 2 * sampling_ratio non-zero taps, so the work is a few fmas per output,
// and the table cells under the taps, the weights and the f32 output
// (N * S * S * C * 4 bytes) are what must move.
//
// Design: one block per (ROI, band of BAND output rows, channel tile).
// Bands are short (4 rows) because the inference sites are latency-bound:
// 37 of 128 ROIs live make less than one wave, so more, shorter blocks
// finish sooner (measured on an H100 at every inference site; 8-row bands
// were a little faster only at the training search-region site).
// - The block stages its ROI's wx rows and its band's wy rows once
//   (16-byte loads), finds every row's non-zero span in parallel (a warp
//   reduction a row), then lists the table rows its band covers (a warp
//   ballot over the rows).
// - It streams those covered rows in ascending order, each row segment
//   [first, last covered column) x channel tile read from global memory
//   once with 16-byte cp.async copies, in chunks of as many rows as fill a
//   window-wide shared buffer (one round trip for several rows), double-
//   buffered: the next chunk's copies are in flight while the current one
//   computes.
// - Separable sums: thread (j, four channels) forms p = sum_x wx[j, x] *
//   t[y, x, c] once for each covered row y, then adds wy[i, y] * p to each
//   of its band's accumulators in registers.  Every output therefore sums
//   the same products in the same order as a direct loop (x inside, y
//   outside, zero taps skipped), with one f32 fma each.
// - 16-byte stores of four f32 channels.  A dead ROI writes zeros and
//   reads nothing; outputs stay in slot order (no compaction).  A null
//   ``valid`` marks every ROI live (the training forward).
// Only taps with a non-zero weight are read, and those lie inside their
// FPN level, so the table needs none of the padding the dense form needs.
#include <algorithm>

#include "common.cuh"

namespace k1 {

constexpr int BAND = 4;           // output rows a block
constexpr int MAX_THREADS = 512;

__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p,
                                      float (&v)[4]) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&q.x));
  const float2 hi = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&q.y));
  v[0] = lo.x, v[1] = lo.y, v[2] = hi.x, v[3] = hi.y;
}

// Shared memory of a block: two row buffers [win][ctp] T, then wx [S][win]
// and the band's wy [BAND][win] f32, each row's span, the covered rows.
template <typename T>
static size_t smem_bytes(int S, int win, int ctp) {
  return 2 * (size_t)win * ctp * sizeof(T) +
         (size_t)(S + BAND) * win * sizeof(float) +
         (size_t)(2 * (S + BAND) + win + 8) * sizeof(int);
}

template <typename T>
__global__ void __launch_bounds__(MAX_THREADS, 2)
    window_pool_band(const T* __restrict__ table, int R, int Wmax, int C,
                     const int* __restrict__ origins,
                     const float* __restrict__ wy,
                     const float* __restrict__ wx,
                     const uint8_t* __restrict__ valid,
                     float* __restrict__ out, int S, int win, int ctp,
                     int vec) {
  const int n = blockIdx.x;
  const int y0 = blockIdx.y * BAND;
  const int nb = min(BAND, S - y0);
  const int c0 = blockIdx.z * ctp;
  const int lanes = ctp / 4;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  // thread (j, q): output column j, channels c .. c + 3; threads past
  // j = S - 1 (the block is a whole number of warps) only stage
  const int q = tid % lanes, j = tid / lanes;
  const int c = c0 + 4 * q;
  const bool owner = j < S;
  float acc[BAND][4];
#pragma unroll
  for (int i = 0; i < BAND; ++i)
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[i][k] = 0.f;

  if (valid == nullptr || valid[n]) {
    extern __shared__ __align__(16) unsigned char k1_smem[];
    T* buf = (T*)k1_smem;
    float* w_s = (float*)(k1_smem + 2 * (size_t)win * ctp * sizeof(T));
    const float* wx_s = w_s;              // [S][win]
    const float* wy_s = w_s + S * win;    // [BAND][win]
    int* lo = (int*)(w_s + (S + BAND) * win);  // [S + BAND]
    int* hi = lo + S + BAND;
    int* rows = hi + S + BAND;            // [win]
    int* meta = rows + win;               // first column, columns, rows
    const int row0 = origins[2 * n], col0 = origins[2 * n + 1];
    // wx rows, then the band's wy rows (contiguous in both places)
    const float* wxg = wx + (size_t)n * S * win;
    const float* wyg = wy + ((size_t)n * S + y0) * win;
    if (win % 4 == 0) {
      const int nx = S * win / 4, nw = (S + nb) * win / 4;
      for (int e = tid; e < nw; e += blockDim.x)
        reinterpret_cast<float4*>(w_s)[e] =
            e < nx ? reinterpret_cast<const float4*>(wxg)[e]
                   : reinterpret_cast<const float4*>(wyg)[e - nx];
    } else {
      for (int e = tid; e < (S + nb) * win; e += blockDim.x)
        w_s[e] = e < S * win ? wxg[e] : wyg[e - S * win];
    }
    __syncthreads();
    // each weight row's non-zero span [lo, hi), a warp a row
    for (int r = warp; r < S + nb; r += blockDim.x / 32) {
      int l = win, h = 0;
      for (int x = lane; x < win; x += 32)
        if (w_s[r * win + x] != 0.f) l = min(l, x), h = x + 1;
      l = __reduce_min_sync(0xffffffffu, l);
      h = __reduce_max_sync(0xffffffffu, h);
      if (lane == 0) lo[r] = l, hi[r] = h;
    }
    __syncthreads();
    if (warp == 0) {
      // the columns any wx row covers, the band's y span, and the covered
      // table rows: inside the table, a non-zero wy in the band
      int xl = win, xh = 0, yl = win, yh = 0;
      for (int r = lane; r < S + nb; r += 32) {
        if (hi[r] <= lo[r]) continue;
        if (r < S) xl = min(xl, lo[r]), xh = max(xh, hi[r]);
        else yl = min(yl, lo[r]), yh = max(yh, hi[r]);
      }
      xl = __reduce_min_sync(0xffffffffu, xl);
      xh = __reduce_max_sync(0xffffffffu, xh);
      yl = __reduce_min_sync(0xffffffffu, yl);
      yh = __reduce_max_sync(0xffffffffu, yh);
      int count = 0;
      for (int base = yl; base < yh; base += 32) {
        const int y = base + lane;
        bool f = false;
        if (y < yh && row0 + y >= 0 && row0 + y < R)
          for (int i = 0; i < nb; ++i) f |= wy_s[i * win + y] != 0.f;
        const unsigned bal = __ballot_sync(0xffffffffu, f);
        if (f) rows[count + __popc(bal & ((1u << lane) - 1))] = y;
        count += __popc(bal);
      }
      if (lane == 0) meta[0] = xl, meta[1] = xh - xl, meta[2] = count;
    }
    __syncthreads();
    const int xlo = meta[0], len = meta[1];
    const int nrows = len > 0 ? meta[2] : 0;
    // a chunk: as many covered rows' segments as fill a window-wide buffer
    const int rpc = len > 0 ? win / len : 1;
    const int nchunks = (nrows + rpc - 1) / rpc;

    // chunk m's row segments into buffer m % 2, [row][len][ctp]
    auto stage = [&](int m) {
      T* dst = buf + (m & 1) * win * ctp;
      const int r0 = m * rpc, nr = min(rpc, nrows - r0);
      if (vec) {
        // qn 16-byte pieces a pixel (a power of two dividing the block):
        // thread tid copies piece tid % qn of pixels p, p + step, ...
        constexpr int E = 16 / sizeof(T);
        const int qn = ctp / E, qq = tid % qn, step = blockDim.x / qn;
        const int drl = step / len, dx = step % len;
        int p = tid / qn, rl = p / len, x = p % len;
        for (; p < nr * len; p += step) {
          const int col = col0 + xlo + x;
          if (col >= 0 && col < Wmax)
            cp_async16(dst + (rl * len + x) * ctp + qq * E,
                       table + ((long long)(row0 + rows[r0 + rl]) * Wmax +
                                col) * C + c0 + qq * E);
          rl += drl, x += dx;
          if (x >= len) x -= len, ++rl;
        }
      } else {
        const int per_row = len * ctp;
        for (int e = tid; e < nr * per_row; e += blockDim.x) {
          const int rl = e / per_row, rem = e % per_row;
          const int x = rem / ctp, cc = rem % ctp, col = col0 + xlo + x;
          if (col >= 0 && col < Wmax)
            dst[(rl * len + x) * ctp + cc] =
                c0 + cc < C
                    ? table[((long long)(row0 + rows[r0 + rl]) * Wmax + col) *
                                C + c0 + cc]
                    : zero_of<T>();
        }
      }
    };
    if (nchunks > 0) stage(0);
    cp_async_commit();
    const int xl = owner ? lo[j] : 0, xh = owner ? hi[j] : 0;
    const float* wxj = wx_s + j * win;
    for (int m = 0; m < nchunks; ++m) {
      if (m + 1 < nchunks) stage(m + 1);
      cp_async_commit();
      cp_async_wait<1>();  // chunk m is in
      __syncthreads();
      const int r0 = m * rpc, nr = min(rpc, nrows - r0);
      for (int rl = 0; rl < nr; ++rl) {
        const T* seg = buf + (m & 1) * win * ctp + rl * len * ctp + 4 * q;
        const int y = rows[r0 + rl];
        float p[4] = {0.f, 0.f, 0.f, 0.f};
        for (int x = xl; x < xh; ++x) {
          const float b = wxj[x];
          const int col = col0 + x;
          if (b == 0.f || col < 0 || col >= Wmax) continue;
          float v[4];
          load4(seg + (x - xlo) * ctp, v);
#pragma unroll
          for (int k = 0; k < 4; ++k) p[k] = fmaf(b, v[k], p[k]);
        }
#pragma unroll
        for (int i = 0; i < BAND; ++i) {
          if (i >= nb) continue;
          const float a = wy_s[i * win + y];
          if (a == 0.f) continue;
#pragma unroll
          for (int k = 0; k < 4; ++k) acc[i][k] = fmaf(a, p[k], acc[i][k]);
        }
      }
      __syncthreads();  // before chunk m + 2 overwrites this buffer
    }
    cp_async_wait<0>();
  }

  if (!owner || c >= C) return;
#pragma unroll
  for (int i = 0; i < BAND; ++i) {
    if (i >= nb) continue;
    float* o = out + (((size_t)n * S + y0 + i) * S + j) * C + c;
    if (C % 4 == 0) {
      *reinterpret_cast<float4*>(o) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (c + k < C) o[k] = acc[i][k];
    }
  }
}

template <typename T>
static int launch(const void* table, int R, int Wmax, int C,
                  const int* origins, const float* wy, const float* wx,
                  const uint8_t* valid, float* out, int N, int S, int win,
                  cudaStream_t stream) {
  if (S < 1 || win < 1 || S > MAX_THREADS - 31)
    return (int)cudaErrorInvalidValue;
  // channel tile: the widest power of two up to 128 that keeps the block
  // (S x tile / 4 threads, in whole warps) within MAX_THREADS, at most C
  // rounded up to 4
  int ctp = 128;
  while (ctp > 4 && (S * (ctp / 4) + 31) / 32 * 32 > MAX_THREADS) ctp /= 2;
  ctp = std::min(ctp, (C + 3) / 4 * 4);
  const int vec = (C * sizeof(T)) % 16 == 0 && (ctp * sizeof(T)) % 16 == 0 &&
                  (ctp & (ctp - 1)) == 0 && C % ctp == 0 &&
                  (uintptr_t)table % 16 == 0;
  const size_t smem = smem_bytes<T>(S, win, ctp);
  cudaError_t err = set_smem(window_pool_band<T>, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(N, (S + BAND - 1) / BAND, (C + ctp - 1) / ctp);
  const int threads = (S * (ctp / 4) + 31) / 32 * 32;
  window_pool_band<T><<<grid, threads, smem, stream>>>(
      (const T*)table, R, Wmax, C, origins, wy, wx, valid, out, S, win, ctp,
      vec);
  return (int)cudaGetLastError();
}

}  // namespace k1

SIAMMOT_API int siammot_window_pool(const void* table, int dtype, int R,
                                    int Wmax, int C, const int* origins,
                                    const float* wy, const float* wx,
                                    const uint8_t* valid, float* out, int N,
                                    int S, int win, void* stream) {
  if (N == 0) return 0;
  if (dtype == 1)
    return k1::launch<__nv_bfloat16>(table, R, Wmax, C, origins, wy, wx,
                                     valid, out, N, S, win,
                                     (cudaStream_t)stream);
  return k1::launch<float>(table, R, Wmax, C, origins, wy, wx, valid, out,
                           N, S, win, (cudaStream_t)stream);
}
