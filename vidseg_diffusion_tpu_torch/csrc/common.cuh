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

#include <initializer_list>

namespace vs {

// dtype codes shared with ops/_cuda.py
constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;

// error codes below zero (cudaError_t values are >= 0)
constexpr int kErrUnsupported = -1;  // dtype / head dim / tap count not built
constexpr int kErrBadArgument = -2;  // sizes out of range

// the `route` the split-TF32 tensor-core kernels report (the fp32 attention at D = 512 of
// tf32x3_attention.cuh, K5 in fp32 at D = 64, K11 in fp32, K6 in fp32 at D = 512)
constexpr int kRouteTf32x3 = 7;
// the `route` K2 and K6 report past 32 frames (temporal_attention_long.cu)
constexpr int kRouteLong = 8;
// the `route` K2 at D = 512 and K6 in fp32 at D = 64 report up to 32 frames on the tensor-core kernels of
// temporal_attention_long_tc.cu
constexpr int kRouteShortTc = 9;

// every base 16-byte aligned (what TMA and 16-byte vector accesses need)
inline bool aligned16(std::initializer_list<const void*> ptrs) {
  for (const void* x : ptrs)
    if (reinterpret_cast<uintptr_t>(x) % 16) return false;
  return true;
}

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

// The one head dim of the wide temporal kernels (K2 and K6 at the VideoDecoder's
// VideoAttnBlock), whose lanes split a row of 512 channels between them.
constexpr int kWideD = 512;

// 8 elements of T from / to a 16-byte aligned address (one 16-byte vector in
// bf16, two in fp32), as fp32
template <typename T>
__device__ __forceinline__ void wide_load(const T* p, float* out);
template <>
__device__ __forceinline__ void wide_load<__nv_bfloat16>(const __nv_bfloat16* p, float* out) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat16* x = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
  for (int u = 0; u < 8; ++u) out[u] = __bfloat162float(x[u]);
}
template <>
__device__ __forceinline__ void wide_load<float>(const float* p, float* out) {
  const float4 a = reinterpret_cast<const float4*>(p)[0], b = reinterpret_cast<const float4*>(p)[1];
  out[0] = a.x, out[1] = a.y, out[2] = a.z, out[3] = a.w, out[4] = b.x, out[5] = b.y, out[6] = b.z, out[7] = b.w;
}

template <typename T>
__device__ __forceinline__ void wide_store(T* p, const float* in);   // each value rounded to T once
template <>
__device__ __forceinline__ void wide_store<__nv_bfloat16>(__nv_bfloat16* p, const float* in) {
  uint4 raw;
  __nv_bfloat16* x = reinterpret_cast<__nv_bfloat16*>(&raw);
#pragma unroll
  for (int u = 0; u < 8; ++u) x[u] = __float2bfloat16(in[u]);
  *reinterpret_cast<uint4*>(p) = raw;
}
template <>
__device__ __forceinline__ void wide_store<float>(float* p, const float* in) {
  reinterpret_cast<float4*>(p)[0] = make_float4(in[0], in[1], in[2], in[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(in[4], in[5], in[6], in[7]);
}

}  // namespace vs

extern "C" const char* vs_error_string(int code);
