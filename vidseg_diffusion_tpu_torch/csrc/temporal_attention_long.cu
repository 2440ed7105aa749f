// K2 and K6 past 32 frames: the temporal softmax attention of each (video,
// spatial token, head) over t > 32 frames, and its backward, on the UNet's
// direct layout [(b t), s, H * D] at every head dim the configs produce (16,
// 64, 512) in bf16 and fp32. The C entries of temporal_attention.cu and
// temporal_attention_bwd.cu send every t > 32 here; their tiles (a 16- or
// 32-frame box, a row of logits in registers, a problem's rows in shared
// memory) stop at 32 frames, and a 64-frame box would not fit a block.
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
// the backward, a key row) at a time, the rows dealt out in turns; its lanes
// split the row's channels (D = 512: 16 a lane, 64: 2, 16: one a lane on
// lanes 0-15), so every logit and dP is a lane's partial product and a warp
// sum, whose butterfly leaves the same bits on every lane. Keys are walked one
// frame at a time from device memory; a problem's rows (t x D, at most 5 t KB
// in bf16 at D = 512) stay in L1 / L2 while its warps walk them. The backward
// first runs the query rows (delta, the max and the sum of each row into a
// scratch of three floats a row, and dq over the key walk), then, after a
// barrier, the key rows: each recomputes the logits and dP of its column with
// the same lanes and the same order of products, so p and ds are the bits the
// query rows saw, and sums dk and dv over the query walk. Nothing is summed
// across blocks or with atomics: the same inputs give the same bits.
//
// What bounds it on the H100: not the bytes (8 t D bytes forward, 16 t D
// backward, each read once from device memory) but the walks: t^2 warp sums a
// logit pass, two passes forward and five backward. A simple kernel first; it
// runs on no default path (PERF.md row 27).
#include <initializer_list>

#include "common.cuh"

namespace vs {
namespace longt {

constexpr int kWarps = 8;
constexpr float kInvLog2E = 0.6931471805599453f;

// the channels of a row that lane `lane` holds, as fp32: [CPL lane, CPL lane + CPL) for D >= 32; at D = 16
// lanes 0-15 one each and lanes 16-31 none (zeros, which add nothing to a sum and are not stored)
template <typename T, int D>
struct Row {
  static constexpr int CPL = D >= 32 ? D / 32 : 1;
  __device__ static __forceinline__ void load(const T* row, int lane, float (&x)[CPL]) {
    if constexpr (CPL == 16) {   // D = 512: two 16-byte aligned runs of 8 (the C entries check the bases)
      wide_load<T>(row + 16 * lane, x);
      wide_load<T>(row + 16 * lane + 8, x + 8);
    } else {
#pragma unroll
      for (int c = 0; c < CPL; ++c) x[c] = (D >= 32 || lane < D) ? to_f<T>(row[CPL * lane + c]) : 0.f;
    }
  }
  __device__ static __forceinline__ void store(T* row, int lane, const float (&x)[CPL]) {
    if constexpr (CPL == 16) {
      wide_store<T>(row + 16 * lane, x);
      wide_store<T>(row + 16 * lane + 8, x + 8);
    } else {
#pragma unroll
      for (int c = 0; c < CPL; ++c)
        if (D >= 32 || lane < D) row[CPL * lane + c] = from_f<T>(x[c]);
    }
  }
  // qf = round(q * qscale) to T
  __device__ static __forceinline__ void load_qf(const T* row, int lane, float qscale, float (&x)[CPL]) {
    load(row, lane, x);
#pragma unroll
    for (int c = 0; c < CPL; ++c) x[c] = round_to<T>(x[c] * qscale);
  }
  // the row product a . b: the lane's partial products in channel order, then the warp's butterfly
  __device__ static __forceinline__ float dot(const float (&a)[CPL], const float (&b)[CPL]) {
    float s = 0.f;
#pragma unroll
    for (int c = 0; c < CPL; ++c) s = fmaf(a[c], b[c], s);
    return warp_sum(s);
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

// D = 512 reads and writes 16-byte vectors
inline bool aligned(int D, std::initializer_list<const void*> ptrs) {
  if (D != kWideD) return true;
  for (const void* x : ptrs)
    if (reinterpret_cast<uintptr_t>(x) % 16) return false;
  return true;
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

// K2 past 32 frames, any D of {16, 64, 512} in bf16 / fp32 (D = 512: bases 16-byte aligned)
int launch_temporal_long(int dtype, int D, const void* q, const void* k, const void* v, void* o, int nvid, int t,
                         int S, int H, float qscale, cudaStream_t stream) {
  const long long nprob = (long long)nvid * S * H;
  if (nprob > 0x7fffffffLL || !longt::aligned(D, {q, k, v, o})) return kErrBadArgument;
  using bf = __nv_bfloat16;
  const bool b16 = dtype == kBFloat16;
  if (!b16 && dtype != kFloat32) return kErrUnsupported;
  switch (D) {
    case 16:
      return b16 ? longt::launch_fwd<bf, 16>(q, k, v, o, nprob, t, S, H, qscale, stream)
                 : longt::launch_fwd<float, 16>(q, k, v, o, nprob, t, S, H, qscale, stream);
    case 64:
      return b16 ? longt::launch_fwd<bf, 64>(q, k, v, o, nprob, t, S, H, qscale, stream)
                 : longt::launch_fwd<float, 64>(q, k, v, o, nprob, t, S, H, qscale, stream);
    case kWideD:
      return b16 ? longt::launch_fwd<bf, kWideD>(q, k, v, o, nprob, t, S, H, qscale, stream)
                 : longt::launch_fwd<float, kWideD>(q, k, v, o, nprob, t, S, H, qscale, stream);
  }
  return kErrUnsupported;
}

// K6 past 32 frames; stats: fp32 scratch of nvid * S * H * t * 3 floats
int launch_temporal_bwd_long(int dtype, int D, const void* q, const void* k, const void* v, const void* o,
                             const void* g, void* dq, void* dk, void* dv, void* stats, int nvid, int t, int S, int H,
                             float qscale, float scale, cudaStream_t stream) {
  const long long nprob = (long long)nvid * S * H;
  if (nprob > 0x7fffffffLL || stats == nullptr || !longt::aligned(D, {q, k, v, o, g, dq, dk, dv}))
    return kErrBadArgument;
  using bf = __nv_bfloat16;
  const bool b16 = dtype == kBFloat16;
  if (!b16 && dtype != kFloat32) return kErrUnsupported;
  float* st = static_cast<float*>(stats);
#define VS_LONG_BWD(T, DD) \
  longt::launch_bwd<T, DD>(q, k, v, o, g, dq, dk, dv, st, nprob, t, S, H, qscale, scale, stream)
  switch (D) {
    case 16:
      return b16 ? VS_LONG_BWD(bf, 16) : VS_LONG_BWD(float, 16);
    case 64:
      return b16 ? VS_LONG_BWD(bf, 64) : VS_LONG_BWD(float, 64);
    case kWideD:
      return b16 ? VS_LONG_BWD(bf, kWideD) : VS_LONG_BWD(float, kWideD);
  }
#undef VS_LONG_BWD
  return kErrUnsupported;
}

}  // namespace vs
