// Shared helpers of the port's CUDA kernels (plain C interface, bound
// from Python with ctypes; no PyTorch headers).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define SIAMMOT_API extern "C" __attribute__((visibility("default")))

// dtype codes passed from Python: 0 = float32, 1 = bfloat16; FN<T0, T1>
// for the codes of two inputs
#define SIAMMOT_DISPATCH2(d0, d1, FN, ...)                              \
  ((d0) == 1 ? ((d1) == 1 ? FN<__nv_bfloat16, __nv_bfloat16>(__VA_ARGS__) \
                          : FN<__nv_bfloat16, float>(__VA_ARGS__))        \
             : ((d1) == 1 ? FN<float, __nv_bfloat16>(__VA_ARGS__)         \
                          : FN<float, float>(__VA_ARGS__)))

__device__ __forceinline__ float load_f32(const float* p, size_t i) {
  return p[i];
}
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}

// A zero of the element type (for staging past the last channel).
template <typename T>
__device__ __forceinline__ T zero_of();
template <>
__device__ __forceinline__ float zero_of<float>() {
  return 0.f;
}
template <>
__device__ __forceinline__ __nv_bfloat16 zero_of<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}

// Opt a kernel in to more than 48 KB of dynamic shared memory.
template <typename K>
static cudaError_t set_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// 16 bytes global -> shared, asynchronously (cp.async, L2 only); the copies
// a thread issued so far form a group with cp_async_commit, and
// cp_async_wait<N> waits until at most N of its groups are in flight
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// 4 bytes global -> shared, asynchronously (cp.async through L1), for
// rows that are not 16-byte aligned
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Blocks of `threads` threads with `smem` bytes of dynamic shared memory
// that fit on all of the card's SMs at once (a persistent grid); 0 if none
// fits.
template <typename K>
static int resident_blocks(K kernel, int threads, size_t smem) {
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                    smem) != cudaSuccess)
    return 0;
  return per_sm * sms;
}

// order[0 .. K) = the live slots ascending, then the dead ones; returns
// the number live.  The first warp (all of it, or the whole block when it
// is smaller) ballots that many slots at a time.
__device__ __forceinline__ int live_order(const uint8_t* __restrict__ valid,
                                          int K, int* order) {
  const int lanes = min(32, (int)blockDim.x);
  if (threadIdx.x < lanes) {
    const int lane = threadIdx.x;
    const unsigned mask = lanes == 32 ? ~0u : (1u << lanes) - 1;
    const unsigned below = (1u << lane) - 1;
    int n_live = 0;
    for (int base = 0; base < K; base += lanes)
      n_live += __popc(__ballot_sync(mask, base + lane < K &&
                                               valid[base + lane]));
    int lp = 0, dp = n_live;
    for (int base = 0; base < K; base += lanes) {
      const bool in = base + lane < K;
      const bool v = in && valid[base + lane];
      const unsigned bl = __ballot_sync(mask, v);
      const unsigned bd = __ballot_sync(mask, in && !v);
      if (v) order[lp + __popc(bl & below)] = base + lane;
      else if (in) order[dp + __popc(bd & below)] = base + lane;
      lp += __popc(bl);
      dp += __popc(bd);
    }
    if (lane == 0) order[K] = n_live;
  }
  __syncthreads();
  return order[K];
}
