// Gradient of the windowed ROIAlign pool with respect to its table: the
// CUDA counterpart of the Pallas kernel
// siammot_tpu/ops/pallas/window_pool.py:window_pool_pallas_bwd
// (_bwd_kernel).
//
// dtable[row0[n] + y, col0[n] + x, c] +=
//     sum_i sum_j wy[n, i, y] * wx[n, j, x] * g[n, i, j, c]
//
// The TPU kernel walks the ROIs in order and read-modify-writes each
// window stripe with DMAs, which is race-free on its sequential grid.
// Here blocks run in parallel and the windows of training ROIs overlap, so
// the scatter uses f32 atomicAdd: the sums then run in an order that
// changes from run to run, and the last bits with it.
//
// Bound on the H100: bytes (the zeroed f32 table the gradient is written
// into, and g).  A weight row has at most 2 * sampling_ratio non-zero
// taps, so a dense Wy^T G Wx would waste nearly all its work and one
// atomic per (tap, bin) would issue about S^2 * taps atomics per channel.
// Simple design: one block per (ROI, slice of window rows).  The block
// stages its wy and wx in shared memory, finds for every window row y the
// span of output rows i with a non-zero wy[i, y] (and for every column x
// the span of j), lists the rows and columns that some tap touches, and
// each thread forms sum_i wy * sum_j wx * g over those short spans for its
// (y, x, c), in f32, then adds it to the table once.  Neighbouring threads
// take neighbouring channels, so g reads and the atomics are coalesced.
// Dead ROIs (``valid`` False; null = all live) add nothing.  The caller
// zeroes dtable.
#include "common.cuh"

constexpr int THREADS = 256;
constexpr int ROW_SLICES = 4;   // blocks per ROI, each taking every 4th row

__global__ void window_pool_bwd_kernel(const float* __restrict__ g,
                                       const int* __restrict__ origins,
                                       const float* __restrict__ wy,
                                       const float* __restrict__ wx,
                                       const uint8_t* __restrict__ valid,
                                       float* __restrict__ dtable, int R,
                                       int Wmax, int C, int S, int win) {
  const int n = blockIdx.x;
  if (valid != nullptr && !valid[n]) return;
  extern __shared__ float smem[];
  float* wy_s = smem;                       // [S, win]
  float* wx_s = wy_s + S * win;             // [S, win]
  int* span = (int*)(wx_s + S * win);       // [2 * win][2]: rows y, cols x
  int* rows = span + 4 * win;               // [win] touched rows y
  int* cols = rows + win;                   // [win] touched cols x
  int* count = cols + win;                  // [2]
  const float* wy_g = wy + (size_t)n * S * win;
  const float* wx_g = wx + (size_t)n * S * win;
  for (int e = threadIdx.x; e < S * win; e += blockDim.x) {
    wy_s[e] = wy_g[e];
    wx_s[e] = wx_g[e];
  }
  __syncthreads();
  const int row0 = origins[2 * n];
  const int col0 = origins[2 * n + 1];
  for (int t = threadIdx.x; t < 2 * win; t += blockDim.x) {
    const float* w = t < win ? wy_s : wx_s;
    const int p = t % win;
    const int base = t < win ? row0 : col0;
    const int limit = t < win ? R : Wmax;
    int lo = S, hi = 0;
    if (base + p >= 0 && base + p < limit) {
      for (int i = 0; i < S; ++i) {
        if (w[i * win + p] != 0.f) {
          lo = min(lo, i);
          hi = i + 1;
        }
      }
    }
    span[2 * t] = lo;
    span[2 * t + 1] = hi;
  }
  __syncthreads();
  if (threadIdx.x < 2) {   // compact the touched rows (0) and columns (1)
    const int off = threadIdx.x * win;
    int* list = threadIdx.x == 0 ? rows : cols;
    int m = 0;
    for (int p = 0; p < win; ++p)
      if (span[2 * (off + p)] < span[2 * (off + p) + 1]) list[m++] = p;
    count[threadIdx.x] = m;
  }
  __syncthreads();
  const int ny = count[0], nx = count[1];
  const float* g_n = g + (size_t)n * S * S * C;
  for (int yi = blockIdx.y; yi < ny; yi += gridDim.y) {
    const int y = rows[yi];
    const int i_lo = span[2 * y], i_hi = span[2 * y + 1];
    float* drow = dtable + ((size_t)(row0 + y) * Wmax + col0) * C;
    for (int e = threadIdx.x; e < nx * C; e += blockDim.x) {
      const int c = e % C;
      const int x = cols[e / C];
      const int j_lo = span[2 * (win + x)], j_hi = span[2 * (win + x) + 1];
      float acc = 0.f;
      for (int i = i_lo; i < i_hi; ++i) {
        const float a = wy_s[i * win + y];
        if (a == 0.f) continue;
        const float* g_i = g_n + (size_t)i * S * C + c;
        float accx = 0.f;
        for (int j = j_lo; j < j_hi; ++j) {
          const float b = wx_s[j * win + x];
          if (b != 0.f) accx += b * g_i[(size_t)j * C];
        }
        acc += a * accx;
      }
      atomicAdd(drow + (size_t)x * C + c, acc);
    }
  }
}

SIAMMOT_API int siammot_window_pool_bwd(const float* g, const int* origins,
                                        const float* wy, const float* wx,
                                        const uint8_t* valid, float* dtable,
                                        int R, int Wmax, int C, int N, int S,
                                        int win, void* stream) {
  if (N == 0) return 0;
  const size_t smem = (size_t)2 * S * win * sizeof(float) +
                      (size_t)(6 * win + 2) * sizeof(int);
  cudaError_t err = set_smem(window_pool_bwd_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(N, ROW_SLICES);
  window_pool_bwd_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      g, origins, wy, wx, valid, dtable, R, Wmax, C, S, win);
  return (int)cudaGetLastError();
}
