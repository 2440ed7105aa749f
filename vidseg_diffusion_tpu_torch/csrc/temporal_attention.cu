// K2 temporal_attention_direct: softmax attention across the t frames of each
// (video, spatial token, head), read straight from the UNet's spatial token
// layout [(b t), s, H*D] — no (b t) s c <-> (b s) t c transpose.
//
// Replaces (TPU): vidseg_diffusion_tpu/ops/attention.py:1375
// _temporal_direct_kernel (reached from _temporal_direct_impl's pallas_call at
// :1458) and the temporal sites that the TPU sends to _small_seq_kernel when s
// is not a multiple of 16 (the GPU has no such tiling rule, so every s runs
// here). Math as the JAX kernel: q pre-scaled by scale * log2(e) and rounded to
// the input dtype, a base-2 softmax, p rounded to the input dtype where it
// feeds P V, and the denominator the fp32 sum of the unrounded p
// (attention.py:1398-1403).
//
// What bounds it on the H100: bytes. Each problem is a t x t softmax over
// 64-dim heads (t = 14 on the main path): 4 t^2 D flops for 8 t D bytes of
// q, k, v and o, about 7 flops a byte against the card's ~295 at its peak, so
// the least time is reading q, k, v once and writing o once (0.125 ms at ds1,
// [28, 5824, 5, 64]).
//
// bf16 (every main-path site) runs temporal_attn_mma_kernel on the shared
// tile of temporal_tile.cuh: TMA brings a unit of 8 tokens x 16 frames of one
// head of q, k and v per box (frames t..15 and tokens past s as zeros) into a
// two-stage ring, so loads run ahead of the math and the rows a problem needs
// arrive as whole 128-byte lines. One warp per problem on mma.sync.m16n8k16:
// S = Qf K^T (2 key n-tiles x 4 k-steps, Qf = round(q * qscale) applied to the
// A fragments), columns >= t masked to -inf, the base-2 softmax's row max and
// sum over the quad's shuffles, the rounded p repacked in registers as the A
// operand of O = P V (8 n-tiles x 1 k-step, V through ldmatrix.trans), O / l
// staged in the problem's q rows and written back by a TMA store (frames >= t
// and tokens past s dropped). 16 < t <= 32 takes 32-frame boxes and two m16
// row tiles. That tile is built for 64-dim heads; the other head dims the
// configs produce run kernels templated on D, one warp per problem on CUDA
// cores: D = 16 (the tiny configs) in both dtypes and fp32 at 64 (the
// card-vs-CPU checks) on temporal_attn_kernel, lane i keeping query row i.
// D = 512 (the VideoDecoder's VideoAttnBlock) runs, from kTc512FwdMinFrames*
// frames, the team kernel of temporal_attention_long_tc.cu (route 9: eight
// warps a problem, each its own 64 channels by its own TMA boxes, S partials
// met in warp order, bf16 mma.sync.m16n8k16, fp32 split TF32), and below them
// temporal_attn_wide_kernel, lanes across the head dim. All of these stop at
// kMaxFrames = 32 (a 32-frame box, a row's logits in registers); past 32
// frames D = 64 and 512 run the tensor-core kernels of
// temporal_attention_long_tc.cu and D = 16 the frame-walking kernel of
// temporal_attention_long.cu (both route 8), which keeps this arithmetic with
// a walk over all t keys for the row max before a second for the sum and P V.
#include <algorithm>

#include "common.cuh"
#include "temporal_tile.cuh"

namespace vs {

constexpr int kMaxFrames = 32;
constexpr int kWarpsPerBlock = 4;

// ---- CUDA cores: fp32 at D = 64, both dtypes at the other head dims ----------
//
// temporal_attn_kernel<T, D> (D <= 64: fp32 at 64, bf16 and fp32 at 16): one
// warp per problem, four a block; the warp stages the problem's t rows of k and
// v in shared memory as fp32, then lane i (< t) keeps query row i (scaled by
// qscale and rounded to T) and its t logits in registers, takes the base-2
// softmax, rounds p to T for P V and sums the unrounded p in fp32, and writes
// its output row.

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
      const float e = exp2f(sc[j] - m);
      l += e;                  // the fp32 sum of the unrounded p
      sc[j] = round_to<T>(e);  // the p of P V
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
int launch_temporal_cores(const void* q, const void* k, const void* v, void* o, int nvid, int t, int S, int H,
                          float qscale, cudaStream_t stream) {
  auto kern = temporal_attn_kernel<T, D>;
  const size_t smem = sizeof(float) * kWarpsPerBlock * 2 * t * D;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)(sizeof(float) * kWarpsPerBlock * 2 * kMaxFrames * D));
  if (attr != cudaSuccess) return (int)attr;
  const long long nprob = (long long)nvid * S * H;
  const long long blocks = (nprob + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > 0x7fffffffLL) return kErrBadArgument;
  kern<<<(unsigned)blocks, 32 * kWarpsPerBlock, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), nvid, t, S, H, qscale);
  return (int)cudaGetLastError();
}

// ---- D = 512: one warp per problem, lanes across the head dim ---------------
//
// The VideoDecoder's VideoAttnBlock mixes frames over one 512-dim head ([bt,
// 5824, 1, 512] at t = 7 or 14 on svd.yaml's decode); this kernel takes the t
// below the C entry's crossover (kTc512FwdMinFrames*), the team kernel of
// temporal_attention_long_tc.cu the rest up to 32. A query row is too wide
// for one lane, so lane L owns the 16 channels [8L, 8L + 8) and [256 + 8L,
// 256 + 8L + 8) of every row: each logit is a 16-term partial dot product per
// lane and a warp sum; p, its fp32 sum and the rounding as above; each lane
// accumulates its 16 output channels over the t frames. The problem's t rows of
// k and v wait in shared memory in the input dtype (2 t 512 elements a warp: 28
// KB at t = 14 in bf16, 57 KB in fp32), as many warps a block as fit in 192 KB
// (at most 4). Loads are 16-byte vectors, so every row must be 16-byte aligned.
// Bound by bytes like the other temporal sites: q, k, v read and o written once.

constexpr int kWideMaxWarps = 4;
constexpr size_t kWideSmemBudget = 192 * 1024;

template <typename T>
__global__ void __launch_bounds__(32 * kWideMaxWarps) temporal_attn_wide_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v, T* __restrict__ o, int nvid,
    int t, int S, int H, float qscale, int warps) {
  constexpr int D = kWideD, VEC = 16 / sizeof(T);  // elements per 16-byte vector
  extern __shared__ __align__(16) unsigned char wide_smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long prob = (long long)blockIdx.x * warps + warp;
  if (prob >= (long long)nvid * S * H) return;  // only warp-level sync below
  const int h = (int)(prob % H);
  const long long rest = prob / H;
  const int s = (int)(rest % S);
  const int b = (int)(rest / S);

  T* Ks = reinterpret_cast<T*>(wide_smem) + (size_t)warp * 2 * t * D;  // [t][D]
  T* Vs = Ks + t * D;                                                  // [t][D]
  const long long hd = (long long)H * D;
  const long long frame_stride = (long long)S * hd;
  const long long base = (long long)b * t * frame_stride + (long long)s * hd + (long long)h * D;
  for (int e = lane; e < t * (D / VEC); e += 32) {
    const int i = e / (D / VEC), c = (e % (D / VEC)) * VEC;
    const long long off = base + i * frame_stride + c;
    *reinterpret_cast<uint4*>(Ks + i * D + c) = *reinterpret_cast<const uint4*>(k + off);
    *reinterpret_cast<uint4*>(Vs + i * D + c) = *reinterpret_cast<const uint4*>(v + off);
  }
  __syncwarp();

  const int c0 = 8 * lane, c1 = 256 + 8 * lane;  // this lane's two runs of 8 channels
  for (int i = 0; i < t; ++i) {
    const long long qoff = base + i * frame_stride;
    float qv[16];
    wide_load<T>(q + qoff + c0, qv);
    wide_load<T>(q + qoff + c1, qv + 8);
#pragma unroll
    for (int u = 0; u < 16; ++u) qv[u] = round_to<T>(qv[u] * qscale);
    float sc[kMaxFrames];
    float m = -INFINITY;
#pragma unroll
    for (int j = 0; j < kMaxFrames; ++j) {
      if (j < t) {
        float kv[16];
        wide_load<T>(Ks + j * D + c0, kv);
        wide_load<T>(Ks + j * D + c1, kv + 8);
        float a = 0.f;
#pragma unroll
        for (int u = 0; u < 16; ++u) a = fmaf(qv[u], kv[u], a);
        sc[j] = warp_sum(a);
        m = fmaxf(m, sc[j]);
      }
    }
    float l = 0.f;
#pragma unroll
    for (int j = 0; j < kMaxFrames; ++j) {
      if (j < t) {
        const float e = exp2f(sc[j] - m);
        l += e;                  // the fp32 sum of the unrounded p
        sc[j] = round_to<T>(e);  // the p of P V
      }
    }
    float ov[16];
#pragma unroll
    for (int u = 0; u < 16; ++u) ov[u] = 0.f;
#pragma unroll
    for (int j = 0; j < kMaxFrames; ++j) {
      if (j < t) {
        float vv[16];
        wide_load<T>(Vs + j * D + c0, vv);
        wide_load<T>(Vs + j * D + c1, vv + 8);
#pragma unroll
        for (int u = 0; u < 16; ++u) ov[u] = fmaf(sc[j], vv[u], ov[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < 16; ++u) o[qoff + (u < 8 ? c0 + u : c1 + u - 8)] = from_f<T>(ov[u] / l);
  }
}

template <typename T>
int launch_temporal_wide(const void* q, const void* k, const void* v, void* o, int nvid, int t, int S, int H,
                         float qscale, cudaStream_t stream) {
  const uintptr_t bases = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                          reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o);
  if (bases % 16) return kErrBadArgument;
  const size_t per_warp = sizeof(T) * 2 * (size_t)t * kWideD;
  const int warps = (int)std::min<size_t>(kWideMaxWarps, kWideSmemBudget / per_warp);
  static const cudaError_t attr = cudaFuncSetAttribute(
      temporal_attn_wide_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kWideSmemBudget);
  if (attr != cudaSuccess) return (int)attr;
  const long long nprob = (long long)nvid * S * H;
  const long long blocks = (nprob + warps - 1) / warps;
  if (blocks > 0x7fffffffLL) return kErrBadArgument;
  temporal_attn_wide_kernel<T><<<(unsigned)blocks, 32 * warps, per_warp * warps, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), static_cast<T*>(o), nvid, t,
      S, H, qscale, warps);
  return (int)cudaGetLastError();
}

// ---- bf16: tensor cores, TMA-fed tiles ------------------------------------------

// inputs q, k, v; output o in q's slot. Units of 8 tokens (8 compute warps):
// 48 KB a stage at 16 frames, two stages, two blocks an SM.
template <int FR>
using K2Tile = DirectTile<3, 1, FR, 8, 2, 0>;

template <int FR>
struct K2Problem {
  int t;
  float qscale;
  static constexpr __device__ int out_slot(int) { return 0; }

  __device__ __forceinline__ void operator()(const uint32_t (&slot)[3], uint32_t, int lane) const {
    constexpr int NK = FR / 8;  // key n-tiles
    const uint32_t sq = slot[0], sk = slot[1], sv = slot[2];
    const int gid = lane >> 2, tig = lane & 3;
#pragma unroll
    for (int mi = 0; mi < FR / 16; ++mi) {
      float s[NK][4];
#pragma unroll
      for (int n = 0; n < NK; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        uint32_t a[4];
        tt_ldsm(a, tt_a_addr(sq, 16 * mi, ks, lane));
#pragma unroll
        for (int j = 0; j < 4; ++j)  // Qf = q * qscale, rounded to bf16
          a[j] = tt_pack(tt_lo(a[j]) * qscale, tt_hi(a[j]) * qscale);
#pragma unroll
        for (int np = 0; np < NK / 2; ++np) {
          uint32_t b[4];
          tt_ldsm(b, tt_bt_addr(sk, 16 * np, ks, lane));
          tt_mma(s[2 * np], a, b[0], b[1]);
          tt_mma(s[2 * np + 1], a, b[2], b[3]);
        }
      }
      // base-2 softmax on the accumulators: s[n][0..1] row gid, s[n][2..3] row
      // gid + 8, at key columns 8 n + 2 tig + {0, 1}; keys >= t are masked
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int n = 0; n < NK; ++n)
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (8 * n + 2 * tig + (u & 1) >= t) s[n][u] = -INFINITY;
          mx[u >> 1] = fmaxf(mx[u >> 1], s[n][u]);
        }
      float l[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      }
#pragma unroll
      for (int n = 0; n < NK; ++n)
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          s[n][u] = exp2f(s[n][u] - mx[u >> 1]);
          l[u >> 1] += s[n][u];  // the fp32 p, before its rounding
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      }
      // O = P V: p rounded to bf16 as the A operand, 16 keys a k-step
      float acc[8][4];
#pragma unroll
      for (int n = 0; n < 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < NK / 2; ++kk) {
        const uint32_t pa[4] = {tt_pack(s[2 * kk][0], s[2 * kk][1]), tt_pack(s[2 * kk][2], s[2 * kk][3]),
                                tt_pack(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                                tt_pack(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          uint32_t b[4];
          tt_ldsm_trans(b, tt_b_addr(sv, 16 * kk, np, lane));
          tt_mma(acc[2 * np], pa, b[0], b[1]);
          tt_mma(acc[2 * np + 1], pa, b[2], b[3]);
        }
      }
      // O / l over this row tile's q rows (read by the ldmatrix above, done)
      const int r0 = 16 * mi + gid;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        tt_st32(sq + sw128(r0, n) + 4 * tig, tt_pack(acc[n][0] / l[0], acc[n][1] / l[0]));
        tt_st32(sq + sw128(r0 + 8, n) + 4 * tig, tt_pack(acc[n][2] / l[1], acc[n][3] / l[1]));
      }
    }
  }
};

template <int FR>
__global__ void __launch_bounds__(K2Tile<FR>::THREADS, FR == 16 ? 2 : 1) temporal_attn_mma_kernel(
    const __grid_constant__ DirectMaps<4> maps, int units, int H, int ntiles, int t, float qscale) {
  extern __shared__ unsigned char temporal_smem[];
  direct_walk<K2Tile<FR>>(maps, units, H, ntiles, temporal_smem, K2Problem<FR>{t, qscale});
}

int launch_temporal_bf16(const void* q, const void* k, const void* v, void* o, int nvid, int t, int S, int H,
                         float qscale, cudaStream_t stream) {
  const void* tensors[4] = {q, k, v, o};
  if (t <= 16)
    return launch_direct<K2Tile<16>>(temporal_attn_mma_kernel<16>, tensors, nvid, t, S, H, stream, t, qscale);
  return launch_direct<K2Tile<32>>(temporal_attn_mma_kernel<32>, tensors, nvid, t, S, H, stream, t, qscale);
}

// past kMaxFrames: D = 16 the frame-walking kernel of temporal_attention_long.cu, D = 64 and 512 the
// tensor-core kernels of temporal_attention_long_tc.cu
int launch_temporal_long(int dtype, int D, const void* q, const void* k, const void* v, void* o, int nvid, int t,
                         int S, int H, float qscale, cudaStream_t stream);
int launch_temporal_long_tc(int dtype, int D, const void* q, const void* k, const void* v, void* o, int nvid, int t,
                            int S, int H, float qscale, cudaStream_t stream);

// D = 512 up to kMaxFrames: the team kernel of temporal_attention_long_tc.cu from these frames, the wide kernel
// below them. The team kernel's block a problem takes about the same time at any t up to 16 (bf16 0.107-0.113
// ms at t = 1-5, fp32 0.246-0.262 at 1-7), the wide kernel grows with t: bf16 0.031 / 0.062 / 0.095 / 0.113 /
// 0.158 at t = 1-5, fp32 0.049-0.241 at 1-6 and 0.289 at 7 (device time, [t, 5824, 1, 512], NVIDIA H100 80GB
// HBM3, 700.00 W, scripts/time_kernels.py --only short; PERF.md row 23). At t = 4 in bf16 the two tie (0.1118 /
// 0.1128), so the wide kernel keeps it.
constexpr int kTc512FwdMinFramesBf16 = 5, kTc512FwdMinFramesF32 = 7;
int launch_temporal_short_tc(int dtype, const void* q, const void* k, const void* v, void* o, int nvid, int t, int S,
                             int H, float qscale, cudaStream_t stream);

}  // namespace vs

// q, k, v, o: contiguous [(nvid*t), S, H*D], D in {16, 64, 512} (bf16 at 64,
// every D at 512 and D = 64 past 32 frames: 16-byte aligned), any t > 0. Up to
// 32 frames bf16 at D = 64 runs the tensor-core kernel, D = 512 the team
// kernel of temporal_attention_long_tc.cu from kTc512FwdMinFrames* frames (the
// dtype's) and the wide kernel below them, the rest the CUDA-core kernel; past
// 32 frames D = 64 and 512 the tensor-core kernels of
// temporal_attention_long_tc.cu, D = 16 the frame-walking kernel of
// temporal_attention_long.cu. route (or NULL) receives the kernel that ran: 1
// mma.sync, 9 the team kernel up to 32 frames, 4 the wide kernel, 0 CUDA
// cores, 8 past 32 frames.
extern "C" int vs_temporal_attention_direct(int dtype, int D, const void* q, const void* k,
                                            const void* v, void* o, int nvid, int t, int S,
                                            int H, float qscale, int* route, void* stream) {
  if (nvid <= 0 || S <= 0 || H <= 0 || t <= 0) return vs::kErrBadArgument;
  if (D != 16 && D != 64 && D != vs::kWideD) return vs::kErrUnsupported;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf = __nv_bfloat16;
  const bool bf16 = dtype == vs::kBFloat16;
  if (!bf16 && dtype != vs::kFloat32) return vs::kErrUnsupported;
  int r = 0, rc;
  if (t > vs::kMaxFrames) {
    r = vs::kRouteLong;
    rc = D == 16 ? vs::launch_temporal_long(dtype, D, q, k, v, o, nvid, t, S, H, qscale, s)
                 : vs::launch_temporal_long_tc(dtype, D, q, k, v, o, nvid, t, S, H, qscale, s);
  } else if (D == vs::kWideD && t >= (bf16 ? vs::kTc512FwdMinFramesBf16 : vs::kTc512FwdMinFramesF32)) {
    r = vs::kRouteShortTc;
    rc = vs::launch_temporal_short_tc(dtype, q, k, v, o, nvid, t, S, H, qscale, s);
  } else if (D == vs::kWideD) {
    r = 4;
    rc = bf16 ? vs::launch_temporal_wide<bf>(q, k, v, o, nvid, t, S, H, qscale, s)
              : vs::launch_temporal_wide<float>(q, k, v, o, nvid, t, S, H, qscale, s);
  } else if (bf16 && D == 64) {
    r = 1;
    rc = vs::launch_temporal_bf16(q, k, v, o, nvid, t, S, H, qscale, s);
  } else if (D == 64) {
    rc = vs::launch_temporal_cores<float, 64>(q, k, v, o, nvid, t, S, H, qscale, s);
  } else {
    rc = bf16 ? vs::launch_temporal_cores<bf, 16>(q, k, v, o, nvid, t, S, H, qscale, s)
              : vs::launch_temporal_cores<float, 16>(q, k, v, o, nvid, t, S, H, qscale, s);
  }
  if (route != nullptr) *route = r;
  return rc;
}
