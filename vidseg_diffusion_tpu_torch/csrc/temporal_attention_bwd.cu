// K6 temporal_attention_direct_bwd: the backward of K2, dq/dk/dv of the
// t-length softmax attention of each (video, spatial token, head), read and
// written in the UNet's spatial token layout [(b t), s, H*D].
//
// Replaces (TPU): vidseg_diffusion_tpu/ops/attention.py:_small_seq_bwd_kernel
// (via _small_batched_attention_bwd_impl, reached from _tad_bwd). The JAX
// backward first transposes q, k, v, out and g to the canonical [(b s), t,
// H, D] layout and the three gradients back (attention.py:1514-1515, :1531);
// this kernel reads the direct layout itself, so those five plus three
// transposes do not exist.
//
// Math (the JAX kernel's): qf = q*scale*log2(e) rounded to the input dtype,
// the softmax recomputed as the true weights p = e / sum(e), e = exp2(qf k^T
// - max), in fp32; delta = rowsum(g o); ds = p (g v^T - delta); ds rounded
// to the input dtype before dq = scale * ds k and dk = ds^T qf / log2(e), p
// rounded before dv = p^T g.
//
// What bounds it on the H100: each problem is t x t (t = 14 on the training
// path) over 64-dim heads: ~10*t*t*D flops for 8*t*D elements moved, so
// memory traffic and latency, as for K2. Design: one warp per problem, four
// per block. The warp stages the problem's t rows of qf, k, v, g and o in
// shared memory (loads coalesced along the head dim; rows padded to D + 1
// floats so the per-lane row reads below are conflict-free). Lane i (< t)
// then owns query row i: it recomputes the softmax in registers (t <= 32
// logits), forms ds, writes dq row i and the rounded p and ds rows to shared
// memory; after a warp barrier lane j owns key row j and sums dk and dv over
// the t queries. The warp writes the three gradients back coalesced. Nothing
// but q, k, v, o, g and the gradients touches device memory.
#include "common.cuh"

namespace vs {

constexpr int kBwdFrames = 32;
constexpr int kBwdWarps = 4;

__host__ __device__ constexpr int bwd_warp_floats(int t, int D) {
  return 5 * t * (D + 1) + 2 * t * (t + 1);
}

template <typename T, int D>
__global__ void __launch_bounds__(32 * kBwdWarps) temporal_attn_bwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ o, const T* __restrict__ g, T* __restrict__ dq, T* __restrict__ dk,
    T* __restrict__ dv, int nvid, int t, int S, int H, float qscale, float scale) {
  constexpr int DP = D + 1;
  constexpr float kInvLog2E = 0.6931471805599453f;
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long prob = (long long)blockIdx.x * kBwdWarps + warp;
  if (prob >= (long long)nvid * S * H) return;  // only warp-level sync below
  const int h = (int)(prob % H);
  const long long rest = prob / H;
  const int s = (int)(rest % S);
  const int b = (int)(rest / S);

  const int TP = t + 1;
  float* Qs = smem + (size_t)warp * bwd_warp_floats(t, D);  // [t][DP] qf
  float* Ks = Qs + t * DP;   // k; after the query pass, dk
  float* Vs = Ks + t * DP;   // v; after the query pass, dv
  float* Gs = Vs + t * DP;   // g
  float* Os = Gs + t * DP;   // o; row i becomes dq once lane i has its delta
  float* Ps = Os + t * DP;   // [t][TP] p rounded to T
  float* DSs = Ps + t * TP;  // [t][TP] ds rounded to T

  const long long hd = (long long)H * D;
  const long long frame_stride = (long long)S * hd;
  const long long base = (long long)b * t * frame_stride + (long long)s * hd + (long long)h * D;

  for (int e = lane; e < t * D; e += 32) {
    const int i = e / D, d = e % D;
    const long long off = base + i * frame_stride + d;
    Qs[i * DP + d] = round_to<T>(to_f<T>(q[off]) * qscale);
    Ks[i * DP + d] = to_f<T>(k[off]);
    Vs[i * DP + d] = to_f<T>(v[off]);
    Gs[i * DP + d] = to_f<T>(g[off]);
    Os[i * DP + d] = to_f<T>(o[off]);
  }
  __syncwarp();

  if (lane < t) {  // query row i = lane
    const int i = lane;
    float delta = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) delta = fmaf(Gs[i * DP + d], Os[i * DP + d], delta);
    float sc[kBwdFrames];
    float m = -INFINITY;
#pragma unroll
    for (int j = 0; j < kBwdFrames; ++j) {
      if (j < t) {
        float a = 0.f;
#pragma unroll 8
        for (int d = 0; d < D; ++d) a = fmaf(Qs[i * DP + d], Ks[j * DP + d], a);
        sc[j] = a;
        m = fmaxf(m, a);
      }
    }
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < kBwdFrames; ++j) {
      if (j < t) {
        sc[j] = exp2f(sc[j] - m);
        sum += sc[j];
      }
    }
#pragma unroll
    for (int j = 0; j < kBwdFrames; ++j) {
      if (j < t) {
        float dp = 0.f;
#pragma unroll 8
        for (int d = 0; d < D; ++d) dp = fmaf(Gs[i * DP + d], Vs[j * DP + d], dp);
        const float p = sc[j] / sum;
        Ps[i * TP + j] = round_to<T>(p);
        sc[j] = round_to<T>(p * (dp - delta));  // ds
        DSs[i * TP + j] = sc[j];
      }
    }
#pragma unroll 2
    for (int d = 0; d < D; ++d) {
      float a = 0.f;
#pragma unroll
      for (int j = 0; j < kBwdFrames; ++j)
        if (j < t) a = fmaf(sc[j], Ks[j * DP + d], a);
      Os[i * DP + d] = a * scale;  // dq
    }
  }
  __syncwarp();

  if (lane < t) {  // key row j = lane: every read of k and v is done
    const int j = lane;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float ak = 0.f, av = 0.f;
      for (int i = 0; i < t; ++i) {
        ak = fmaf(DSs[i * TP + j], Qs[i * DP + d], ak);
        av = fmaf(Ps[i * TP + j], Gs[i * DP + d], av);
      }
      Ks[j * DP + d] = ak * kInvLog2E;  // dk
      Vs[j * DP + d] = av;              // dv
    }
  }
  __syncwarp();

  for (int e = lane; e < t * D; e += 32) {
    const int i = e / D, d = e % D;
    const long long off = base + i * frame_stride + d;
    dq[off] = from_f<T>(Os[i * DP + d]);
    dk[off] = from_f<T>(Ks[i * DP + d]);
    dv[off] = from_f<T>(Vs[i * DP + d]);
  }
}

template <typename T, int D>
int launch_temporal_bwd(const void* q, const void* k, const void* v, const void* o,
                        const void* g, void* dq, void* dk, void* dv, int nvid, int t, int S,
                        int H, float qscale, float scale, cudaStream_t stream) {
  auto kern = temporal_attn_bwd_kernel<T, D>;
  const size_t smem = sizeof(float) * kBwdWarps * bwd_warp_floats(t, D);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)(sizeof(float) * kBwdWarps * bwd_warp_floats(kBwdFrames, D)));
  if (err != cudaSuccess) return (int)err;
  const long long nprob = (long long)nvid * S * H;
  const long long blocks = (nprob + kBwdWarps - 1) / kBwdWarps;
  if (blocks > 0x7fffffffLL) return kErrBadArgument;
  kern<<<(unsigned)blocks, 32 * kBwdWarps, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(o), static_cast<const T*>(g), static_cast<T*>(dq),
      static_cast<T*>(dk), static_cast<T*>(dv), nvid, t, S, H, qscale, scale);
  return (int)cudaGetLastError();
}

}  // namespace vs

// q, k, v, o, g, dq, dk, dv: contiguous [(nvid*t), S, H*D]
extern "C" int vs_temporal_attention_direct_bwd(int dtype, int D, const void* q, const void* k,
                                                const void* v, const void* o, const void* g,
                                                void* dq, void* dk, void* dv, int nvid, int t,
                                                int S, int H, float qscale, float scale,
                                                void* stream) {
  if (nvid <= 0 || S <= 0 || H <= 0 || t <= 0 || t > vs::kBwdFrames) return vs::kErrBadArgument;
  if (D != 64) return vs::kErrUnsupported;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == vs::kBFloat16)
    return vs::launch_temporal_bwd<__nv_bfloat16, 64>(q, k, v, o, g, dq, dk, dv, nvid, t, S, H,
                                                      qscale, scale, st);
  if (dtype == vs::kFloat32)
    return vs::launch_temporal_bwd<float, 64>(q, k, v, o, g, dq, dk, dv, nvid, t, S, H, qscale,
                                              scale, st);
  return vs::kErrUnsupported;
}
