// Shared helpers for the port's CUDA kernels: element conversions between
// the storage types the wrappers accept (float32, bfloat16) and the float32
// every kernel computes in, and the dtype codes of the C interface.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace w2l {

// dtype codes passed by the Python wrappers (kernels/_build.py: DTYPE_CODES)
constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Lets a kernel use more than the default 48 KB of dynamic shared memory.
// An error here is left in cudaGetLastError() for the caller to report.
template <typename Kernel>
inline void allow_smem(Kernel kernel, size_t bytes) {
  if (bytes > 48 * 1024) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(bytes));
  }
}

}  // namespace w2l
