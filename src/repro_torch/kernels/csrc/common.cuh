// Shared helpers of the attention kernels: element conversions and the
// error code every C entry point returns.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace cronus {

// dtype codes the Python wrappers pass: 0 = float32, 1 = bfloat16
constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;

// masked-score sentinel of the reference (kernels/ref.py NEG_INF)
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Set the kernel's dynamic shared memory limit, launch, and return the
// first error of the two (a refused launch never runs, so the caller must
// see cudaGetLastError()).
template <typename Kernel, typename... Args>
cudaError_t launch_with_smem(Kernel kernel, dim3 grid, dim3 block,
                             size_t smem, cudaStream_t stream,
                             Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<grid, block, smem, stream>>>(args...);
  return cudaGetLastError();
}

}  // namespace cronus
