// K2 and K6 past 32 frames at D = 16 (the tiny configs' 16-dim heads): the
// temporal softmax attention of each (video, spatial token, head) over t > 32
// frames, and its backward, on the UNet's direct layout [(b t), s, H * 16] in
// bf16 and fp32. The C entries of temporal_attention.cu and
// temporal_attention_bwd.cu send every t > 32 at D = 16 here; D = 64 and 512
// run the tensor-core kernels of temporal_attention_long_tc.cu.
//
// Replaces (TPU): vidseg_diffusion_tpu/ops/attention.py:1375
// _temporal_direct_kernel (via _temporal_direct_impl's pallas_call at :1458,
// which takes any t with a 16-token tile past 32 frames) and, under a
// gradient, :_small_seq_bwd_kernel via _tad_bwd (:1506-1533), past 32 frames.
//
// The arithmetic is JAX's at every t, with no running softmax:
// - forward: qf = round(q * scale * log2(e)); a first walk over the keys takes
//   the row max over all t logits; a second takes e = exp2(s - max), the
//   denominator as the fp32 sum of the unrounded e, and O = round(e) V / sum;
// - backward: qf as above; delta = rowsum(g o); a walk for the max and one for
//   the sum give p = e / sum(e) in fp32 over every key; ds = round(p (g v^T -
//   delta)); dq = scale ds k, dk = ds^T qf / log2(e), dv = round(p)^T g.
// A softmax that rescales a running sum would round p against a stale max.
//
// Layout: one block a problem, eight warps. A warp takes a query row (then, in
// the backward, a key row) at a time, the rows dealt out in turns; lanes 0-15
// hold one channel each (lanes 16-31 zeros), so every logit and dP is a lane's
// product and a warp sum, whose butterfly leaves the same bits on every lane.
// Keys are walked one frame at a time from device memory; a problem's rows
// stay in L1 / L2 while its warps walk them. The backward first runs the query
// rows (delta, the max and the sum of each row into a scratch of three floats
// a row, and dq over the key walk), then, after a barrier, the key rows: each
// recomputes the logits and dP of its column with the same lanes and the same
// order of products, so p and ds are the bits the query rows saw, and sums dk
// and dv over the query walk. Nothing is summed across blocks or with atomics:
// the same inputs give the same bits.
//
// What bounds it on the H100: not the bytes (8 t D bytes forward, 16 t D
// backward) but the walks: t^2 warp sums a logit pass, two passes forward and
// five backward. It runs on no default path (svd_tiny.yaml's 16-dim heads past
// 32 frames only).
#include "common.cuh"

namespace vs {
namespace longt {

constexpr int kWarps = 8;
constexpr float kInvLog2E = 0.6931471805599453f;

// the channel of a row that lane `lane` holds, as fp32: lanes 0-15 one each, lanes 16-31 none (zeros, which
// add nothing to a sum and are not stored)
template <typename T, int D>
struct Row {
  static_assert(D == 16, "the frame walk's head dim");
  static constexpr int CPL = 1;
  __device__ static __forceinline__ void load(const T* row, int lane, float (&x)[CPL]) {
    x[0] = lane < D ? to_f<T>(row[lane]) : 0.f;
  }
  __device__ static __forceinline__ void store(T* row, int lane, const float (&x)[CPL]) {
    if (lane < D) row[lane] = from_f<T>(x[0]);
  }
  // qf = round(q * qscale) to T
  __device__ static __forceinline__ void load_qf(const T* row, int lane, float qscale, float (&x)[CPL]) {
    load(row, lane, x);
    x[0] = round_to<T>(x[0] * qscale);
  }
  // the row product a . b: the lane's product, then the warp's butterfly
  __device__ static __forceinline__ float dot(const float (&a)[CPL], const float (&b)[CPL]) {
    return warp_sum(a[0] * b[0]);
  }
};

struct Problem {
  long long base, frame;  // the problem's first row, and the elements from one frame's row to the next
};

__device__ __forceinline__ Problem problem(int t, int S, int H, int D) {
  const int h = (int)(blockIdx.x % H);
  const long long rest = blockIdx.x / H;
  const int s = (int)(rest % S);
  const long long b = rest / S;
  const long long frame = (long long)S * H * D;
  return {b * t * frame + (long long)s * H * D + (long long)h * D, frame};
}

template <typename T, int D>
__global__ void __launch_bounds__(32 * kWarps) temporal_attn_long_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v, T* __restrict__ o, int t, int S,
    int H, float qscale) {
  using R = Row<T, D>;
  constexpr int CPL = R::CPL;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const Problem p = problem(t, S, H, D);
  for (int i = warp; i < t; i += kWarps) {
    float qf[CPL];
    R::load_qf(q + p.base + i * p.frame, lane, qscale, qf);
    float m = -INFINITY;
#pragma unroll 4
    for (int j = 0; j < t; ++j) {   // the row max over every key
      float kv[CPL];
      R::load(k + p.base + j * p.frame, lane, kv);
      m = fmaxf(m, R::dot(qf, kv));
    }
    float l = 0.f, acc[CPL];
#pragma unroll
    for (int c = 0; c < CPL; ++c) acc[c] = 0.f;
#pragma unroll 4
    for (int j = 0; j < t; ++j) {
      float kv[CPL], vv[CPL];
      R::load(k + p.base + j * p.frame, lane, kv);
      R::load(v + p.base + j * p.frame, lane, vv);
      const float e = exp2f(R::dot(qf, kv) - m);
      l += e;                         // the fp32 sum of the unrounded p
      const float pr = round_to<T>(e);  // the p of P V
#pragma unroll
      for (int c = 0; c < CPL; ++c) acc[c] = fmaf(pr, vv[c], acc[c]);
    }
#pragma unroll
    for (int c = 0; c < CPL; ++c) acc[c] /= l;
    R::store(o + p.base + i * p.frame, lane, acc);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(32 * kWarps) temporal_attn_bwd_long_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v, const T* __restrict__ o,
    const T* __restrict__ g, T* __restrict__ dq, T* __restrict__ dk, T* __restrict__ dv, float* __restrict__ stats,
    int t, int S, int H, float qscale, float scale) {
  using R = Row<T, D>;
  constexpr int CPL = R::CPL;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const Problem p = problem(t, S, H, D);
  float* st = stats + (long long)blockIdx.x * t * 3;   // a query row's max, sum and delta

  // query rows: delta, the max and the sum over every key, then dq = scale ds k over the key walk
  for (int i = warp; i < t; i += kWarps) {
    const long long off = p.base + i * p.frame;
    float qf[CPL], gv[CPL], ov[CPL];
    R::load_qf(q + off, lane, qscale, qf);
    R::load(g + off, lane, gv);
    R::load(o + off, lane, ov);
    const float delta = R::dot(gv, ov);
    float m = -INFINITY;
#pragma unroll 4
    for (int j = 0; j < t; ++j) {
      float kv[CPL];
      R::load(k + p.base + j * p.frame, lane, kv);
      m = fmaxf(m, R::dot(qf, kv));
    }
    float l = 0.f;
#pragma unroll 4
    for (int j = 0; j < t; ++j) {
      float kv[CPL];
      R::load(k + p.base + j * p.frame, lane, kv);
      l += exp2f(R::dot(qf, kv) - m);
    }
    float acc[CPL];
#pragma unroll
    for (int c = 0; c < CPL; ++c) acc[c] = 0.f;
#pragma unroll 4
    for (int j = 0; j < t; ++j) {
      float kv[CPL], vv[CPL];
      R::load(k + p.base + j * p.frame, lane, kv);
      R::load(v + p.base + j * p.frame, lane, vv);
      const float pj = exp2f(R::dot(qf, kv) - m) / l;
      const float ds = round_to<T>(pj * (R::dot(gv, vv) - delta));
#pragma unroll
      for (int c = 0; c < CPL; ++c) acc[c] = fmaf(ds, kv[c], acc[c]);
    }
#pragma unroll
    for (int c = 0; c < CPL; ++c) acc[c] *= scale;
    R::store(dq + off, lane, acc);
    if (lane == 0) st[3 * i] = m, st[3 * i + 1] = l, st[3 * i + 2] = delta;
  }
  __syncthreads();   // every query row's max, sum and delta, for the key rows

  // key rows: dk = ds^T qf / log2(e) and dv = round(p)^T g over the query walk
  for (int j = warp; j < t; j += kWarps) {
    const long long off = p.base + j * p.frame;
    float kv[CPL], vv[CPL], ak[CPL], av[CPL];
    R::load(k + off, lane, kv);
    R::load(v + off, lane, vv);
#pragma unroll
    for (int c = 0; c < CPL; ++c) ak[c] = av[c] = 0.f;
#pragma unroll 2
    for (int i = 0; i < t; ++i) {
      const long long qoff = p.base + i * p.frame;
      float qf[CPL], gv[CPL];
      R::load_qf(q + qoff, lane, qscale, qf);
      R::load(g + qoff, lane, gv);
      const float m = st[3 * i], l = st[3 * i + 1], delta = st[3 * i + 2];
      const float pj = exp2f(R::dot(qf, kv) - m) / l;
      const float ds = round_to<T>(pj * (R::dot(gv, vv) - delta));
      const float pr = round_to<T>(pj);
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        ak[c] = fmaf(ds, qf[c], ak[c]);
        av[c] = fmaf(pr, gv[c], av[c]);
      }
    }
#pragma unroll
    for (int c = 0; c < CPL; ++c) ak[c] *= kInvLog2E;
    R::store(dk + off, lane, ak);
    R::store(dv + off, lane, av);
  }
}

template <typename T, int D>
int launch_fwd(const void* q, const void* k, const void* v, void* o, long long nprob, int t, int S, int H,
               float qscale, cudaStream_t stream) {
  temporal_attn_long_kernel<T, D><<<(unsigned)nprob, 32 * kWarps, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), static_cast<T*>(o), t, S, H,
      qscale);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_bwd(const void* q, const void* k, const void* v, const void* o, const void* g, void* dq, void* dk,
               void* dv, float* stats, long long nprob, int t, int S, int H, float qscale, float scale,
               cudaStream_t stream) {
  temporal_attn_bwd_long_kernel<T, D><<<(unsigned)nprob, 32 * kWarps, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), static_cast<const T*>(o),
      static_cast<const T*>(g), static_cast<T*>(dq), static_cast<T*>(dk), static_cast<T*>(dv), stats, t, S, H,
      qscale, scale);
  return (int)cudaGetLastError();
}

}  // namespace longt

// K2 past 32 frames at D = 16, bf16 / fp32
int launch_temporal_long(int dtype, int D, const void* q, const void* k, const void* v, void* o, int nvid, int t,
                         int S, int H, float qscale, cudaStream_t stream) {
  const long long nprob = (long long)nvid * S * H;
  if (nprob > 0x7fffffffLL) return kErrBadArgument;
  if (D != 16 || (dtype != kBFloat16 && dtype != kFloat32)) return kErrUnsupported;
  return dtype == kBFloat16 ? longt::launch_fwd<__nv_bfloat16, 16>(q, k, v, o, nprob, t, S, H, qscale, stream)
                            : longt::launch_fwd<float, 16>(q, k, v, o, nprob, t, S, H, qscale, stream);
}

// K6 past 32 frames at D = 16; stats: fp32 scratch of nvid * S * H * t * 3 floats
int launch_temporal_bwd_long(int dtype, int D, const void* q, const void* k, const void* v, const void* o,
                             const void* g, void* dq, void* dk, void* dv, void* stats, int nvid, int t, int S, int H,
                             float qscale, float scale, cudaStream_t stream) {
  const long long nprob = (long long)nvid * S * H;
  if (nprob > 0x7fffffffLL || stats == nullptr) return kErrBadArgument;
  if (D != 16 || (dtype != kBFloat16 && dtype != kFloat32)) return kErrUnsupported;
  float* st = static_cast<float*>(stats);
  return dtype == kBFloat16
             ? longt::launch_bwd<__nv_bfloat16, 16>(q, k, v, o, g, dq, dk, dv, st, nprob, t, S, H, qscale, scale, stream)
             : longt::launch_bwd<float, 16>(q, k, v, o, g, dq, dk, dv, st, nprob, t, S, H, qscale, scale, stream);
}

}  // namespace vs
