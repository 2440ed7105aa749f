// Shared helpers for the hand-written Hopper kernels of vidseg_diffusion_tpu_torch.
//
// Every kernel is exported through a plain C function that takes raw device
// pointers, sizes and the CUDA stream, launches on that stream, and returns
// cudaGetLastError() (0 = success) so the Python wrapper can raise on a
// refused launch. Negative return codes are argument errors detected here.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace vs {

// dtype codes shared with ops/_cuda.py
constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;

// error codes below zero (cudaError_t values are >= 0)
constexpr int kErrUnsupported = -1;  // dtype / head dim / tap count not built
constexpr int kErrBadArgument = -2;  // sizes out of range

template <typename T>
__device__ __forceinline__ float to_f(T x);
template <>
__device__ __forceinline__ float to_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as JAX's astype
}

// Round an fp32 value to T's precision and back: reproduces the places where
// the JAX kernels hold a value in the input dtype (q pre-scale, the p that
// feeds P.V).
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f<T>(from_f<T>(x));
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

}  // namespace vs

extern "C" const char* vs_error_string(int code);
