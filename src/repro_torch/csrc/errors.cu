// Error strings for the Python wrappers (every entry point returns a cudaError_t).
#include <cuda_runtime.h>

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
