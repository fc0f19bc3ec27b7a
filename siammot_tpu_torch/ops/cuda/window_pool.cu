// Windowed ROIAlign pool: the CUDA counterpart of the Pallas kernel
// siammot_tpu/ops/pallas/window_pool.py:window_pool_pallas (_kernel).
//
// out[n, i, j, c] = sum_y wy[n, i, y] * sum_x wx[n, j, x]
//                   * table[row0[n] + y, col0[n] + x, c]
// with the bin average already folded into wy / wx (roi_align_windowed).
//
// Bound on the H100: bytes.  Each row of wy / wx holds at most
// 2 * sampling_ratio non-zero taps, so the work is a few multiply-adds
// per output, and the table window, the weights and the f32 output are
// what must move.  Simple design: one block per (ROI, output row i); the
// block stages its wy row and all of wx in shared memory, finds the
// non-zero span of each row, and each thread sums only the taps inside
// those spans for its (j, c) outputs, in f32, x first and then y.
// Neighbouring threads take neighbouring channels, so table reads and
// output writes are coalesced.  A dead ROI writes zeros and reads
// nothing; outputs stay in the caller's slot order (no compaction).
// Only taps with a non-zero weight are read, and those lie inside their
// FPN level, so the table needs none of the padding the dense form needs.
#include "common.cuh"

template <typename T>
__global__ void window_pool_kernel(const T* __restrict__ table, int R,
                                   int Wmax, int C,
                                   const int* __restrict__ origins,
                                   const float* __restrict__ wy,
                                   const float* __restrict__ wx,
                                   const uint8_t* __restrict__ valid,
                                   float* __restrict__ out, int S, int win) {
  const int n = blockIdx.x;
  const int i = blockIdx.y;
  float* out_row = out + ((size_t)n * S + i) * S * C;
  if (!valid[n]) {
    for (int e = threadIdx.x; e < S * C; e += blockDim.x) out_row[e] = 0.f;
    return;
  }
  extern __shared__ float smem[];
  float* wy_s = smem;                 // [win]
  float* wx_s = smem + win;           // [S, win]
  int* span = (int*)(wx_s + S * win); // [S + 1][2]: rows j of wx, then wy
  const float* wy_g = wy + ((size_t)n * S + i) * win;
  const float* wx_g = wx + (size_t)n * S * win;
  for (int e = threadIdx.x; e < win; e += blockDim.x) wy_s[e] = wy_g[e];
  for (int e = threadIdx.x; e < S * win; e += blockDim.x) wx_s[e] = wx_g[e];
  __syncthreads();
  for (int r = threadIdx.x; r <= S; r += blockDim.x) {
    const float* w = r < S ? wx_s + r * win : wy_s;
    int lo = win, hi = 0;
    for (int t = 0; t < win; ++t) {
      if (w[t] != 0.f) {
        lo = min(lo, t);
        hi = t + 1;
      }
    }
    span[2 * r] = lo;
    span[2 * r + 1] = hi;
  }
  __syncthreads();
  const int row0 = origins[2 * n];
  const int col0 = origins[2 * n + 1];
  const int ylo = span[2 * S], yhi = span[2 * S + 1];
  for (int e = threadIdx.x; e < S * C; e += blockDim.x) {
    const int c = e % C;
    const int j = e / C;
    const int xlo = span[2 * j], xhi = span[2 * j + 1];
    const float* wxj = wx_s + j * win;
    float acc = 0.f;
    for (int y = ylo; y < yhi; ++y) {
      const float a = wy_s[y];
      const int row = row0 + y;
      if (a == 0.f || row < 0 || row >= R) continue;
      float accx = 0.f;
      for (int x = xlo; x < xhi; ++x) {
        const float b = wxj[x];
        const int col = col0 + x;
        if (b == 0.f || col < 0 || col >= Wmax) continue;
        accx += b * load_f32(table, ((size_t)row * Wmax + col) * C + c);
      }
      acc += a * accx;
    }
    out_row[e] = acc;
  }
}

template <typename T>
static int launch(const void* table, int R, int Wmax, int C,
                  const int* origins, const float* wy, const float* wx,
                  const uint8_t* valid, float* out, int N, int S, int win,
                  cudaStream_t stream) {
  const size_t smem = (size_t)(win + S * win) * sizeof(float) +
                      (size_t)2 * (S + 1) * sizeof(int);
  cudaError_t err = set_smem(window_pool_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(N, S);
  window_pool_kernel<T><<<grid, 256, smem, stream>>>(
      (const T*)table, R, Wmax, C, origins, wy, wx, valid, out, S, win);
  return (int)cudaGetLastError();
}

SIAMMOT_API int siammot_window_pool(const void* table, int dtype, int R,
                                    int Wmax, int C, const int* origins,
                                    const float* wy, const float* wx,
                                    const uint8_t* valid, float* out, int N,
                                    int S, int win, void* stream) {
  if (N == 0) return 0;
  if (dtype == 1)
    return launch<__nv_bfloat16>(table, R, Wmax, C, origins, wy, wx, valid,
                                 out, N, S, win, (cudaStream_t)stream);
  return launch<float>(table, R, Wmax, C, origins, wy, wx, valid, out, N, S,
                       win, (cudaStream_t)stream);
}
