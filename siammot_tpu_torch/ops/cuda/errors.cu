#include "common.cuh"

// Text of a CUDA error code returned by one of the entry points.
SIAMMOT_API const char* siammot_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
