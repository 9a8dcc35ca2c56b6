// Shared by every kernel source: the C export macro and the error
// string lookup that ops/_build.py binds in each library.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define PPV_EXPORT extern "C" __attribute__((visibility("default")))

PPV_EXPORT const char* ppv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Opt a kernel into more than 48 KB of dynamic shared memory.
template <typename Kernel>
static cudaError_t ppv_allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}
