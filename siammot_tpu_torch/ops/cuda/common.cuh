// Shared helpers of the port's CUDA kernels (plain C interface, bound
// from Python with ctypes; no PyTorch headers).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define SIAMMOT_API extern "C" __attribute__((visibility("default")))

// dtype codes passed from Python: 0 = float32, 1 = bfloat16
__device__ __forceinline__ float load_f32(const float* p, size_t i) {
  return p[i];
}
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}

// Opt a kernel in to more than 48 KB of dynamic shared memory.
template <typename K>
static cudaError_t set_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}
