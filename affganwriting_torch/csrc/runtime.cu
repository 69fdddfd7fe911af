// Error text for the cudaError_t codes the kernels' entry points return.
#include <cuda_runtime.h>

extern "C" const char* affg_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
