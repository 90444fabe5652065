// Shared helpers of the port's hand-written Hopper kernels.
//
// Every kernel reads f32 or bf16 operands, computes in f32 on the CUDA
// cores (no TF32: the f32 variant tolerance of 3e-4 is tighter than
// TF32's ~1e-3 mantissa), reduces in a fixed order (no atomics, so a run
// is bitwise reproducible) and writes in the operand dtype.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace bident {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's .to()
}

// Round an f32 value through the operand dtype (identity for f32).
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

// Opt the kernel into `bytes` of dynamic shared memory (above 48 KB the
// launch is refused without it).
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace bident
