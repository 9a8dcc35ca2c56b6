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

// Four 8x8 b16 matrices from shared memory; lanes 8i..8i+7 address the
// rows of matrix i.  `.trans` hands each thread a column pair instead.
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const __nv_bfloat16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}
__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4], const __nv_bfloat16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}
// d += a (16x16, row-major) * b (16x8, column-major), bf16 in, f32 acc.
__device__ __forceinline__ void mma_16816(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                          unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
