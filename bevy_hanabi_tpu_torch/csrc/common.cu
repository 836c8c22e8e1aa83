// Error reporting shared by the kernels' C entry points.

#include <cuda_runtime.h>

extern "C" const char* hanabi_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
