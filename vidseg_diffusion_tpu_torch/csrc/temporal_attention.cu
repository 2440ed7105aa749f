// K2 temporal_attention_direct: softmax attention across the t frames of each
// (video, spatial token, head), read straight from the UNet's spatial token
// layout [(b t), s, H*D] — no (b t) s c <-> (b s) t c transpose.
//
// Replaces (TPU): vidseg_diffusion_tpu/ops/attention.py:_temporal_direct_kernel
// (via _temporal_direct_impl) and the temporal sites that the TPU sends to
// _small_seq_kernel when s is not a multiple of 16 (the GPU has no such
// tiling rule, so every s runs here).
//
// What bounds it on the H100: each problem is a t x t (t <= 32, 14 on the
// main path) softmax over 64-dim heads, ~4*t*t*D flops for 4*t*D elements
// moved, so it is bound by memory traffic (reading q, k, v and writing o once)
// and by latency. Design: one warp per problem, four problems per block; the
// warp stages the problem's t rows of k and v in shared memory (coalesced
// along the head dim), then lane i (< t) keeps query row i and its t logits
// in registers, computes the base-2 softmax with the same dtype roundings as
// the JAX kernel (q pre-scale and p in the input dtype) and writes its output
// row. Nothing but q, k, v and o touches device memory.
#include "common.cuh"

namespace vs {

constexpr int kMaxFrames = 32;
constexpr int kWarpsPerBlock = 4;

template <typename T, int D>
__global__ void __launch_bounds__(32 * kWarpsPerBlock) temporal_attn_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, int nvid, int t, int S, int H, float qscale) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long prob = (long long)blockIdx.x * kWarpsPerBlock + warp;
  if (prob >= (long long)nvid * S * H) return;  // only warp-level sync below
  const int h = (int)(prob % H);
  const long long rest = prob / H;
  const int s = (int)(rest % S);
  const int b = (int)(rest / S);

  float* Ks = smem + (size_t)warp * 2 * t * D;  // [t][D]
  float* Vs = Ks + t * D;                       // [t][D]
  const long long hd = (long long)H * D;
  const long long frame_stride = (long long)S * hd;
  const long long base = (long long)b * t * frame_stride + (long long)s * hd + (long long)h * D;

  for (int e = lane; e < t * D; e += 32) {
    const int i = e / D, d = e % D;
    const long long off = base + i * frame_stride + d;
    Ks[e] = to_f<T>(k[off]);
    Vs[e] = to_f<T>(v[off]);
  }
  __syncwarp();
  if (lane >= t) return;

  const long long qoff = base + lane * frame_stride;
  float qv[D];
#pragma unroll
  for (int d = 0; d < D; ++d) qv[d] = round_to<T>(to_f<T>(q[qoff + d]) * qscale);

  float sc[kMaxFrames];
  float m = -INFINITY;
#pragma unroll
  for (int j = 0; j < kMaxFrames; ++j) {
    if (j < t) {
      float a = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) a = fmaf(qv[d], Ks[j * D + d], a);
      sc[j] = a;
      m = fmaxf(m, a);
    }
  }
  float l = 0.f;
#pragma unroll
  for (int j = 0; j < kMaxFrames; ++j) {
    if (j < t) {
      const float p = round_to<T>(exp2f(sc[j] - m));
      sc[j] = p;
      l += p;
    }
  }
  float ov[D];
#pragma unroll
  for (int d = 0; d < D; ++d) ov[d] = 0.f;
#pragma unroll
  for (int j = 0; j < kMaxFrames; ++j) {
    if (j < t) {
#pragma unroll
      for (int d = 0; d < D; ++d) ov[d] = fmaf(sc[j], Vs[j * D + d], ov[d]);
    }
  }
#pragma unroll
  for (int d = 0; d < D; ++d) o[qoff + d] = from_f<T>(ov[d] / l);
}

template <typename T, int D>
int launch_temporal(const void* q, const void* k, const void* v, void* o, int nvid, int t,
                    int S, int H, float qscale, cudaStream_t stream) {
  auto kern = temporal_attn_kernel<T, D>;
  const size_t smem = sizeof(float) * kWarpsPerBlock * 2 * t * D;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)(sizeof(float) * kWarpsPerBlock * 2 * kMaxFrames * D));
  if (err != cudaSuccess) return (int)err;
  const long long nprob = (long long)nvid * S * H;
  const long long blocks = (nprob + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > 0x7fffffffLL) return kErrBadArgument;
  kern<<<(unsigned)blocks, 32 * kWarpsPerBlock, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), nvid, t, S, H, qscale);
  return (int)cudaGetLastError();
}

template <typename T>
int temporal_dispatch(int D, const void* q, const void* k, const void* v, void* o, int nvid,
                      int t, int S, int H, float qscale, cudaStream_t stream) {
  switch (D) {
    case 64:
      return launch_temporal<T, 64>(q, k, v, o, nvid, t, S, H, qscale, stream);
    default:
      return kErrUnsupported;
  }
}

}  // namespace vs

// q, k, v, o: contiguous [(nvid*t), S, H*D]
extern "C" int vs_temporal_attention_direct(int dtype, int D, const void* q, const void* k,
                                            const void* v, void* o, int nvid, int t, int S,
                                            int H, float qscale, void* stream) {
  if (nvid <= 0 || S <= 0 || H <= 0 || t <= 0 || t > vs::kMaxFrames)
    return vs::kErrBadArgument;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == vs::kBFloat16)
    return vs::temporal_dispatch<__nv_bfloat16>(D, q, k, v, o, nvid, t, S, H, qscale, s);
  if (dtype == vs::kFloat32)
    return vs::temporal_dispatch<float>(D, q, k, v, o, nvid, t, S, H, qscale, s);
  return vs::kErrUnsupported;
}
