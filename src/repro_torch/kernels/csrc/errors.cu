// Error strings for the codes the kernel entry points return
// (kernels/_build.py `check`).
#include <cuda_runtime.h>

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
