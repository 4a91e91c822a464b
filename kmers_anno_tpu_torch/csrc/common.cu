// Shared C entry points of libkan_cuda.so.
#include <cuda_runtime.h>

extern "C" const char* kan_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
