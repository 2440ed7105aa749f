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
// What bounds it on the H100: bytes. Each problem is t x t (t = 14 on the
// training path) over 64-dim heads: 5 products of 2 t^2 D flops for 16 t D
// bytes (q, k, v, o, g read, dq, dk, dv written once), about 9 flops a byte
// against the card's ~295, so the least time is the traffic (0.250 ms at ds1,
// [28, 5824, 5, 64]).
//
// bf16 (the training path) runs temporal_attn_bwd_mma_kernel on the tile of
// temporal_tile.cuh that K2 uses: TMA brings a unit of 4 tokens x 16 frames of
// one head of the five inputs (bf16 in shared memory, frames t..15 and tokens
// past s as zeros) into a two-stage ring, and takes the three gradients out
// from the slots of inputs that are no longer read. One warp per problem on
// mma.sync.m16n8k16, every product 16 x 16 x 64 at t <= 16: q is scaled and
// rounded in place (Qf); S = Qf K^T with columns >= t masked, p = e / sum(e) in
// fp32 on the accumulators (quad shuffles); delta = rowsum(g o) from shared
// memory; dP = G V^T; ds = round(p (dP - delta)); dQ = ds K * scale with ds
// repacked as the A operand (dq leaves through o's rows); round(p) and ds go
// to a small per-warp tile, from which ldmatrix.trans reads p^T and ds^T as A
// operands of dV = round(p)^T G (through v's rows) and dK = ds^T Qf / log2(e)
// (through k's rows). 16 < t <= 32 takes 32-frame boxes and two row tiles per
// product. That tile is built for 64-dim heads and bf16; fp32 at D = 64 (the
// UNet trained or checked with --dtype float32) runs from 2 frames, on 16-byte
// aligned bases, the resident kernel of temporal_attention_long_tc.cu (route 9:
// a block of one warp on 16 rows up to 16 frames, of two on 32 rows past them,
// every product as three split-TF32 mma.sync.m16n8k8, p and ds handed from the
// query side to the key side through shared memory). D = 16 (the tiny configs'
// heads) in both dtypes, and fp32 at D = 64 at one frame (where dq and dk are
// the rounding of dP - delta, which the split products and an FMA delta would
// not round alike) or on a base off 16 bytes, run
// temporal_attn_bwd_kernel, templated on the dtype and D: one warp per problem
// on CUDA cores, the inputs staged as fp32 rows (qf rounded to the dtype; p and
// ds rounded where they feed products), lane i owning query row i and then key
// row i. D = 512 (the VideoDecoder's VideoAttnBlock, trained with the SVD
// first stage) runs, by t:
// temporal_attn_bwd_wide_kernel below 4 frames in bf16 (5 in fp32), lanes
// across the head dim (below), where it reads faster; the tensor-core kernels
// of temporal_attention_bwd_512.cu from there to 32 frames in both dtypes (a
// block a problem: 8- and 16-row tiles of frames up to 16, a 32-row tile with
// v and o streamed through a smaller buffer from 17 to 32). All of these stop
// at 32 frames; past 32 D = 64 and 512 run the tensor-core kernels of
// temporal_attention_long_tc.cu and D = 16 the frame-walking kernel of
// temporal_attention_long.cu (both route 8), which keep this arithmetic over
// all t keys; the frame-walking kernel reads a scratch of three floats a query
// row.
#include <algorithm>

#include "common.cuh"
#include "temporal_tile.cuh"
#include "tf32x3_attention.cuh"

namespace vs {

constexpr int kBwdFrames = 32;
constexpr int kWideBwdFrames = 4;   // the D = 512 problems the wide kernel takes (the C entry's route by t)
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
int launch_temporal_bwd_cores(const void* q, const void* k, const void* v, const void* o,
                              const void* g, void* dq, void* dk, void* dv, int nvid, int t, int S,
                              int H, float qscale, float scale, cudaStream_t stream) {
  auto kern = temporal_attn_bwd_kernel<T, D>;
  const size_t smem = sizeof(float) * kBwdWarps * bwd_warp_floats(t, D);
  static const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)(sizeof(float) * kBwdWarps * bwd_warp_floats(kBwdFrames, D)));
  if (attr != cudaSuccess) return (int)attr;
  const long long nprob = (long long)nvid * S * H;
  const long long blocks = (nprob + kBwdWarps - 1) / kBwdWarps;
  if (blocks > 0x7fffffffLL) return kErrBadArgument;
  kern<<<(unsigned)blocks, 32 * kBwdWarps, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(o), static_cast<const T*>(g), static_cast<T*>(dq),
      static_cast<T*>(dk), static_cast<T*>(dv), nvid, t, S, H, qscale, scale);
  return (int)cudaGetLastError();
}

// ---- D = 512: one warp per problem, lanes across the head dim ---------------
//
// The backward of K2's wide kernel (temporal_attention.cu), for the
// VideoAttnBlock's time mix over one 512-dim head below 4 (bf16) or 5 (fp32)
// frames (from there the tensor-core kernels of temporal_attention_bwd_512.cu
// run; PERF.md row 26 has both times). Lane L
// owns the 16 channels [8L, 8L + 8) and [256 + 8L, 256 + 8L + 8) of every row,
// as in the forward. The warp stages the problem's t rows of k, v, g and qf =
// round(q * qscale) in shared memory in the input dtype; each lane reads and
// writes only its own channels there, so the stage is lane-private and needs
// only __syncwarp. Query pass, row i: delta = rowsum(g o), the t logits qf k^T
// and the t dP = g v^T are 16-term partial products per lane and a warp sum
// (the butterfly leaves the same bits on every lane); p = e / sum(e) in fp32,
// round(p) and ds = round(p (dP - delta)) kept as [t][t] fp32 tiles (written by
// lane 0); dq_i = scale * ds_i k on the lane's channels, stored. Key pass, row
// j: dk_j = ds^T_j qf / log2(e) and dv_j = round(p)^T_j g over the staged rows,
// no cross-lane sum. A warp's stage is 4 t 512 elements + 2 t^2 floats (16 KB
// at t = 4 in bf16, 32 KB in fp32), as many warps a block as fit in the budget
// (at most 8). Bound by bytes: q, k, v, o, g read and dq, dk, dv written once
// (t^2 D work a problem).

constexpr int kWideBwdMaxWarps = 8;
constexpr size_t kWideBwdSmemBudget = 224 * 1024;

// a warp's stage, rounded up to 16 bytes so that every warp's rows stay aligned
__host__ __device__ constexpr size_t wide_bwd_warp_bytes(int t, size_t item) {
  return (4 * (size_t)t * kWideD * item + 2 * (size_t)t * t * sizeof(float) + 15) / 16 * 16;
}

template <typename T>
__global__ void __launch_bounds__(32 * kWideBwdMaxWarps) temporal_attn_bwd_wide_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v, const T* __restrict__ o,
    const T* __restrict__ g, T* __restrict__ dq, T* __restrict__ dk, T* __restrict__ dv, int nvid, int t, int S,
    int H, float qscale, float scale, int warps) {
  constexpr int D = kWideD;
  constexpr float kInvLog2E = 0.6931471805599453f;
  extern __shared__ __align__(16) unsigned char wide_bwd_smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long prob = (long long)blockIdx.x * warps + warp;
  if (prob >= (long long)nvid * S * H) return;  // only warp-level sync below
  const int h = (int)(prob % H);
  const long long rest = prob / H;
  const int s = (int)(rest % S);
  const int b = (int)(rest / S);

  T* Qs = reinterpret_cast<T*>(wide_bwd_smem + (size_t)warp * wide_bwd_warp_bytes(t, sizeof(T)));  // [t][D] qf
  T* Ks = Qs + t * D;
  T* Vs = Ks + t * D;
  T* Gs = Vs + t * D;
  float* Ps = reinterpret_cast<float*>(Gs + t * D);  // [t][t] round(p)
  float* DSs = Ps + t * t;                            // [t][t] ds
  const long long hd = (long long)H * D;
  const long long frame_stride = (long long)S * hd;
  const long long base = (long long)b * t * frame_stride + (long long)s * hd + (long long)h * D;
  const int cs[2] = {8 * lane, 256 + 8 * lane};  // this lane's two runs of 8 channels

  for (int i = 0; i < t; ++i) {
    const long long off = base + i * frame_stride;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float x[8];
      wide_load<T>(q + off + cs[r], x);
#pragma unroll
      for (int u = 0; u < 8; ++u) x[u] *= qscale;
      wide_store<T>(Qs + i * D + cs[r], x);  // qf, rounded to T
      wide_load<T>(k + off + cs[r], x);
      wide_store<T>(Ks + i * D + cs[r], x);
      wide_load<T>(v + off + cs[r], x);
      wide_store<T>(Vs + i * D + cs[r], x);
      wide_load<T>(g + off + cs[r], x);
      wide_store<T>(Gs + i * D + cs[r], x);
    }
  }
  __syncwarp();

  // query pass
  for (int i = 0; i < t; ++i) {
    const long long off = base + i * frame_stride;
    float qv[16], gv[16], ov[16];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      wide_load<T>(Qs + i * D + cs[r], qv + 8 * r);
      wide_load<T>(Gs + i * D + cs[r], gv + 8 * r);
      wide_load<T>(o + off + cs[r], ov + 8 * r);
    }
    float part = 0.f;
#pragma unroll
    for (int u = 0; u < 16; ++u) part = fmaf(gv[u], ov[u], part);
    const float delta = warp_sum(part);
    float sc[kWideBwdFrames], dp[kWideBwdFrames];
    float m = -INFINITY;
#pragma unroll
    for (int j = 0; j < kWideBwdFrames; ++j) {
      if (j < t) {
        float kv[16], vv[16];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          wide_load<T>(Ks + j * D + cs[r], kv + 8 * r);
          wide_load<T>(Vs + j * D + cs[r], vv + 8 * r);
        }
        float a = 0.f, c = 0.f;
#pragma unroll
        for (int u = 0; u < 16; ++u) {
          a = fmaf(qv[u], kv[u], a);
          c = fmaf(gv[u], vv[u], c);
        }
        sc[j] = warp_sum(a);
        dp[j] = warp_sum(c);
        m = fmaxf(m, sc[j]);
      }
    }
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < kWideBwdFrames; ++j) {
      if (j < t) {
        sc[j] = exp2f(sc[j] - m);
        sum += sc[j];
      }
    }
    float acc[16];
#pragma unroll
    for (int u = 0; u < 16; ++u) acc[u] = 0.f;
#pragma unroll
    for (int j = 0; j < kWideBwdFrames; ++j) {
      if (j < t) {
        const float p = sc[j] / sum;
        const float ds = round_to<T>(p * (dp[j] - delta));
        if (lane == 0) {
          Ps[i * t + j] = round_to<T>(p);
          DSs[i * t + j] = ds;
        }
        float kv[16];
#pragma unroll
        for (int r = 0; r < 2; ++r) wide_load<T>(Ks + j * D + cs[r], kv + 8 * r);
#pragma unroll
        for (int u = 0; u < 16; ++u) acc[u] = fmaf(ds, kv[u], acc[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < 16; ++u) acc[u] *= scale;
#pragma unroll
    for (int r = 0; r < 2; ++r) wide_store<T>(dq + off + cs[r], acc + 8 * r);
  }
  __syncwarp();

  // key pass: every read of the stage's k and v is done; qf and g are read here
  for (int j = 0; j < t; ++j) {
    float ak[16], av[16];
#pragma unroll
    for (int u = 0; u < 16; ++u) ak[u] = av[u] = 0.f;
    for (int i = 0; i < t; ++i) {
      const float ds = DSs[i * t + j], p = Ps[i * t + j];
      float qv[16], gv[16];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        wide_load<T>(Qs + i * D + cs[r], qv + 8 * r);
        wide_load<T>(Gs + i * D + cs[r], gv + 8 * r);
      }
#pragma unroll
      for (int u = 0; u < 16; ++u) {
        ak[u] = fmaf(ds, qv[u], ak[u]);
        av[u] = fmaf(p, gv[u], av[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < 16; ++u) ak[u] *= kInvLog2E;
    const long long off = base + j * frame_stride;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      wide_store<T>(dk + off + cs[r], ak + 8 * r);
      wide_store<T>(dv + off + cs[r], av + 8 * r);
    }
  }
}

template <typename T>
int launch_temporal_bwd_wide(const void* q, const void* k, const void* v, const void* o, const void* g, void* dq,
                             void* dk, void* dv, int nvid, int t, int S, int H, float qscale, float scale,
                             cudaStream_t stream) {
  const uintptr_t bases = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                          reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o) |
                          reinterpret_cast<uintptr_t>(g) | reinterpret_cast<uintptr_t>(dq) |
                          reinterpret_cast<uintptr_t>(dk) | reinterpret_cast<uintptr_t>(dv);
  if (bases % 16 || t > kWideBwdFrames) return kErrBadArgument;
  const size_t per_warp = wide_bwd_warp_bytes(t, sizeof(T));
  const int warps = (int)std::min<size_t>(kWideBwdMaxWarps, kWideBwdSmemBudget / per_warp);
  static const cudaError_t attr = cudaFuncSetAttribute(
      temporal_attn_bwd_wide_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kWideBwdSmemBudget);
  if (attr != cudaSuccess) return (int)attr;
  const long long nprob = (long long)nvid * S * H;
  const long long blocks = (nprob + warps - 1) / warps;
  if (blocks > 0x7fffffffLL) return kErrBadArgument;
  temporal_attn_bwd_wide_kernel<T><<<(unsigned)blocks, 32 * warps, per_warp * warps, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), static_cast<const T*>(o),
      static_cast<const T*>(g), static_cast<T*>(dq), static_cast<T*>(dk), static_cast<T*>(dv), nvid, t, S, H,
      qscale, scale, warps);
  return (int)cudaGetLastError();
}

// ---- bf16: tensor cores, TMA-fed tiles ------------------------------------------

// inputs q, k, v, o, g; outputs dq (in o's slot), dk (k's), dv (v's). Units of 4
// tokens (4 compute warps): 40 KB a stage at 16 frames, two stages, two blocks an
// SM; per warp a bf16 tile of round(p) and one of ds, [FR][FR + 8] (rows padded
// so that ldmatrix.trans and the pair stores hit distinct banks).
template <int FR>
using K6Tile = DirectTile<5, 3, FR, 4, 2, 2 * FR * (FR + 8) * 2>;

template <int FR>
struct K6Problem {
  int t;
  float qscale, scale;
  static constexpr __device__ int out_slot(int j) { return j == 0 ? 3 : j; }

  __device__ __forceinline__ void operator()(const uint32_t (&slot)[5], uint32_t scratch, int lane) const {
    constexpr int MT = FR / 16, NK = FR / 8, PITCH = (FR + 8) * 2;  // bytes a row of the p / ds tiles
    constexpr float kInvLog2E = 0.6931471805599453f;
    const uint32_t sq = slot[0], sk = slot[1], sv = slot[2], so = slot[3], sg = slot[4];
    const uint32_t sp = scratch, sds = scratch + FR * PITCH;
    const int gid = lane >> 2, tig = lane & 3;

    // Qf = round(q * qscale) in place: it is an operand of S and of dK
    for (int c = lane; c < FR * 8; c += 32) {
      uint4 x = tt_ld128(sq + 16 * c);
      uint32_t* w = reinterpret_cast<uint32_t*>(&x);
#pragma unroll
      for (int j = 0; j < 4; ++j) w[j] = tt_pack(tt_lo(w[j]) * qscale, tt_hi(w[j]) * qscale);
      tt_st128(sq + 16 * c, x);
    }
    __syncwarp();

    // per row tile of queries: p, ds, and dq
#pragma unroll
    for (int mi = 0; mi < MT; ++mi) {
      const int r0 = 16 * mi + gid;  // this lane's rows: r0, r0 + 8
      float p[NK][4], ds[NK][4];
#pragma unroll
      for (int n = 0; n < NK; ++n)
#pragma unroll
        for (int u = 0; u < 4; ++u) p[n][u] = ds[n][u] = 0.f;
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {  // S = Qf K^T into p, dP = G V^T into ds
        uint32_t aq[4], ag[4];
        tt_ldsm(aq, tt_a_addr(sq, 16 * mi, ks, lane));
        tt_ldsm(ag, tt_a_addr(sg, 16 * mi, ks, lane));
#pragma unroll
        for (int np = 0; np < NK / 2; ++np) {
          uint32_t bk[4], bv[4];
          tt_ldsm(bk, tt_bt_addr(sk, 16 * np, ks, lane));
          tt_ldsm(bv, tt_bt_addr(sv, 16 * np, ks, lane));
          tt_mma(p[2 * np], aq, bk[0], bk[1]);
          tt_mma(p[2 * np + 1], aq, bk[2], bk[3]);
          tt_mma(ds[2 * np], ag, bv[0], bv[1]);
          tt_mma(ds[2 * np + 1], ag, bv[2], bv[3]);
        }
      }
      // the true softmax p = e / sum(e) in fp32; keys >= t masked
      float mx[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
      for (int n = 0; n < NK; ++n)
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (8 * n + 2 * tig + (u & 1) >= t) p[n][u] = -INFINITY;
          mx[u >> 1] = fmaxf(mx[u >> 1], p[n][u]);
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      }
#pragma unroll
      for (int n = 0; n < NK; ++n)
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          p[n][u] = exp2f(p[n][u] - mx[u >> 1]);
          l[u >> 1] += p[n][u];
        }
      // delta = rowsum(g o): this lane's 16 channels of each of its rows, then the quad's
      float delta[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
        float d = 0.f;
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const uint4 gv = tt_ld128(sg + sw128(r0 + 8 * r, 2 * tig + c));
          const uint4 ov = tt_ld128(so + sw128(r0 + 8 * r, 2 * tig + c));
          const uint32_t* gw = reinterpret_cast<const uint32_t*>(&gv);
          const uint32_t* ow = reinterpret_cast<const uint32_t*>(&ov);
#pragma unroll
          for (int j = 0; j < 4; ++j) d += tt_lo(gw[j]) * tt_lo(ow[j]) + tt_hi(gw[j]) * tt_hi(ow[j]);
        }
        d += __shfl_xor_sync(0xffffffffu, d, 1);
        delta[r] = d + __shfl_xor_sync(0xffffffffu, d, 2);
      }
      // ds = round(p (dP - delta)); round(p) and ds to this warp's tiles
#pragma unroll
      for (int n = 0; n < NK; ++n) {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          p[n][u] /= l[u >> 1];
          ds[n][u] = p[n][u] * (ds[n][u] - delta[u >> 1]);
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const uint32_t off = (r0 + 8 * r) * PITCH + (8 * n + 2 * tig) * 2;
          tt_st32(sp + off, tt_pack(p[n][2 * r], p[n][2 * r + 1]));
          tt_st32(sds + off, tt_pack(ds[n][2 * r], ds[n][2 * r + 1]));
        }
      }
      // dQ = ds K * scale, ds repacked as the A operand (16 keys a k-step)
      float acc[8][4];
#pragma unroll
      for (int n = 0; n < 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < NK / 2; ++kk) {
        const uint32_t a[4] = {tt_pack(ds[2 * kk][0], ds[2 * kk][1]), tt_pack(ds[2 * kk][2], ds[2 * kk][3]),
                               tt_pack(ds[2 * kk + 1][0], ds[2 * kk + 1][1]),
                               tt_pack(ds[2 * kk + 1][2], ds[2 * kk + 1][3])};
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          uint32_t b[4];
          tt_ldsm_trans(b, tt_b_addr(sk, 16 * kk, np, lane));
          tt_mma(acc[2 * np], a, b[0], b[1]);
          tt_mma(acc[2 * np + 1], a, b[2], b[3]);
        }
      }
      // dq leaves through o's rows of this tile, once every lane's delta has read them
      __syncwarp();
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        tt_st32(so + sw128(r0, n) + 4 * tig, tt_pack(acc[n][0] * scale, acc[n][1] * scale));
        tt_st32(so + sw128(r0 + 8, n) + 4 * tig, tt_pack(acc[n][2] * scale, acc[n][3] * scale));
      }
    }
    __syncwarp();  // the p and ds tiles are whole; k and v are read no more

    // per row tile of keys: dV = round(p)^T G into v's rows, dK = ds^T Qf / log2(e) into k's
#pragma unroll
    for (int mj = 0; mj < MT; ++mj) {
      const int r0 = 16 * mj + gid;
#pragma unroll
      for (int which = 0; which < 2; ++which) {
        const uint32_t tile = which == 0 ? sp : sds, rhs = which == 0 ? sg : sq, dst = which == 0 ? sv : sk;
        const float mul = which == 0 ? 1.f : kInvLog2E;
        float acc[8][4];
#pragma unroll
        for (int n = 0; n < 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
#pragma unroll
        for (int kq = 0; kq < MT; ++kq) {  // 16 queries a k-step
          uint32_t a[4];  // rows of the tile's transpose: keys 16 mj.., queries 16 kq..
          tt_ldsm_trans(a, tile + (16 * kq + (lane & 7) + 8 * (lane >> 4)) * PITCH +
                               (16 * mj + 8 * ((lane >> 3) & 1)) * 2);
#pragma unroll
          for (int np = 0; np < 4; ++np) {
            uint32_t b[4];
            tt_ldsm_trans(b, tt_b_addr(rhs, 16 * kq, np, lane));
            tt_mma(acc[2 * np], a, b[0], b[1]);
            tt_mma(acc[2 * np + 1], a, b[2], b[3]);
          }
        }
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          tt_st32(dst + sw128(r0, n) + 4 * tig, tt_pack(acc[n][0] * mul, acc[n][1] * mul));
          tt_st32(dst + sw128(r0 + 8, n) + 4 * tig, tt_pack(acc[n][2] * mul, acc[n][3] * mul));
        }
      }
    }
  }
};

template <int FR>
__global__ void __launch_bounds__(K6Tile<FR>::THREADS) temporal_attn_bwd_mma_kernel(
    const __grid_constant__ DirectMaps<8> maps, int units, int H, int ntiles, int t, float qscale, float scale) {
  extern __shared__ unsigned char temporal_bwd_smem[];
  direct_walk<K6Tile<FR>>(maps, units, H, ntiles, temporal_bwd_smem, K6Problem<FR>{t, qscale, scale});
}

// temporal_attention_bwd_512.cu: D = 512 on the tensor cores, t from kTc512MinFrames* up to
// kBwdFrames. Shorter problems keep the wide kernel, which read faster there (0.030-0.091 ms
// against 0.099-0.105 at t = 1-3 in bf16, 0.050-0.253 against 0.254-0.261 at t = 1-4 in fp32,
// [t, 5824, 1, 512], NVIDIA H100 80GB HBM3, PERF.md row 26): the tensor-core kernel's block of
// four warps a problem takes a time of its own that few frames do not fill.
constexpr int kTc512MinFramesBf16 = 4, kTc512MinFramesF32 = 5;
static_assert(kTc512MinFramesBf16 - 1 <= kWideBwdFrames && kTc512MinFramesF32 - 1 <= kWideBwdFrames, "routes");
int launch_temporal_bwd_tc512(int dtype, const void* q, const void* k, const void* v, const void* o, const void* g,
                              void* dq, void* dk, void* dv, int nvid, int t, int S, int H, float qscale, float scale,
                              cudaStream_t stream);

// past kBwdFrames: D = 16 the frame-walking kernel of temporal_attention_long.cu (on a scratch of three
// floats a query row), D = 64 and 512 the tensor-core kernels of temporal_attention_long_tc.cu
int launch_temporal_bwd_long(int dtype, int D, const void* q, const void* k, const void* v, const void* o,
                             const void* g, void* dq, void* dk, void* dv, void* stats, int nvid, int t, int S, int H,
                             float qscale, float scale, cudaStream_t stream);
int launch_temporal_bwd_long_tc(int dtype, int D, const void* q, const void* k, const void* v, const void* o,
                                const void* g, void* dq, void* dk, void* dv, void* work, int nvid, int t, int S, int H,
                                float qscale, float scale, cudaStream_t stream);
// fp32 at D = 64 up to kBwdFrames (16-byte aligned bases): the resident kernel of temporal_attention_long_tc.cu
int launch_temporal_bwd_short_tc(const void* q, const void* k, const void* v, const void* o, const void* g, void* dq,
                                 void* dk, void* dv, int nvid, int t, int S, int H, float qscale, float scale,
                                 cudaStream_t stream);

int launch_temporal_bwd_bf16(const void* q, const void* k, const void* v, const void* o, const void* g,
                             void* dq, void* dk, void* dv, int nvid, int t, int S, int H, float qscale,
                             float scale, cudaStream_t stream) {
  const void* tensors[8] = {q, k, v, o, g, dq, dk, dv};
  if (t <= 16)
    return launch_direct<K6Tile<16>>(temporal_attn_bwd_mma_kernel<16>, tensors, nvid, t, S, H, stream, t,
                                     qscale, scale);
  return launch_direct<K6Tile<32>>(temporal_attn_bwd_mma_kernel<32>, tensors, nvid, t, S, H, stream, t, qscale,
                                   scale);
}

}  // namespace vs

// q, k, v, o, g, dq, dk, dv: contiguous [(nvid*t), S, H*D], D in {16, 64, 512}
// (bf16 at 64 and every D at 512, and D = 64 past 32 frames: 16-byte aligned),
// any t > 0; work: fp32 scratch of nvid * S * H * t * 3 floats past kBwdFrames
// frames (NULL up to them), each query row's max, sum and delta for the frame
// walk (D = 16) and for the tensor-core kernels where shared memory cannot hold
// them. Up to 32 frames bf16 at D = 64 runs the tensor-core kernel; fp32 at
// D = 64 from 2 frames the resident kernel of temporal_attention_long_tc.cu
// where all eight bases are 16-byte aligned (TMA reads and the 16-byte
// stores), the CUDA-core kernel at one frame and where a base is not (the
// route by alignment; the wrapper counts both as `fma`); D = 512 the
// tensor-core kernels of temporal_attention_bwd_512.cu from 4 (bf16) or 5
// (fp32) frames (bf16 mma.sync, fp32 split TF32) and the wide kernel below
// them; D = 16 the CUDA-core kernel. Past 32 frames D = 64 and 512 run the
// tensor-core kernels of temporal_attention_long_tc.cu, D = 16 the
// frame-walking kernel of temporal_attention_long.cu.
// route (or NULL) receives the kernel that ran: 1 mma.sync (bf16 at 64 and 512),
// 7 split TF32 (fp32 at 512), 9 split TF32 on the resident kernel (fp32 at 64),
// 4 the wide kernel, 0 CUDA cores, 8 past 32 frames.
extern "C" int vs_temporal_attention_direct_bwd(int dtype, int D, const void* q, const void* k,
                                                const void* v, const void* o, const void* g,
                                                void* dq, void* dk, void* dv, void* work, int nvid,
                                                int t, int S, int H, float qscale, float scale,
                                                int* route, void* stream) {
  if (nvid <= 0 || S <= 0 || H <= 0 || t <= 0) return vs::kErrBadArgument;
  if (D != 16 && D != 64 && D != vs::kWideD) return vs::kErrUnsupported;
  if (dtype != vs::kBFloat16 && dtype != vs::kFloat32) return vs::kErrUnsupported;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  using bf = __nv_bfloat16;
  const bool bf16 = dtype == vs::kBFloat16;
  int r, rc;
  if (t > vs::kBwdFrames) {
    r = vs::kRouteLong;
    rc = D == 16 ? vs::launch_temporal_bwd_long(dtype, D, q, k, v, o, g, dq, dk, dv, work, nvid, t, S, H, qscale,
                                                scale, st)
                 : vs::launch_temporal_bwd_long_tc(dtype, D, q, k, v, o, g, dq, dk, dv, work, nvid, t, S, H, qscale,
                                                   scale, st);
  } else if (D == vs::kWideD && t >= (bf16 ? vs::kTc512MinFramesBf16 : vs::kTc512MinFramesF32)) {
    r = bf16 ? 1 : vs::kRouteTf32x3;
    rc = vs::launch_temporal_bwd_tc512(dtype, q, k, v, o, g, dq, dk, dv, nvid, t, S, H, qscale, scale, st);
  } else if (D == vs::kWideD) {
    r = 4;
    rc = bf16 ? vs::launch_temporal_bwd_wide<bf>(q, k, v, o, g, dq, dk, dv, nvid, t, S, H, qscale, scale, st)
              : vs::launch_temporal_bwd_wide<float>(q, k, v, o, g, dq, dk, dv, nvid, t, S, H, qscale, scale, st);
  } else if (bf16 && D == 64) {
    r = 1;
    rc = vs::launch_temporal_bwd_bf16(q, k, v, o, g, dq, dk, dv, nvid, t, S, H, qscale, scale, st);
  } else if (D == 64 && t > 1 && vs::aligned16({q, k, v, o, g, dq, dk, dv})) {
    r = vs::kRouteShortTc;
    rc = vs::launch_temporal_bwd_short_tc(q, k, v, o, g, dq, dk, dv, nvid, t, S, H, qscale, scale, st);
  } else {
    r = 0;
    rc = bf16 ? vs::launch_temporal_bwd_cores<bf, 16>(q, k, v, o, g, dq, dk, dv, nvid, t, S, H, qscale, scale, st)
         : D == 64 ? vs::launch_temporal_bwd_cores<float, 64>(q, k, v, o, g, dq, dk, dv, nvid, t, S, H, qscale,
                                                              scale, st)
                   : vs::launch_temporal_bwd_cores<float, 16>(q, k, v, o, g, dq, dk, dv, nvid, t, S, H, qscale,
                                                              scale, st);
  }
  if (route != nullptr) *route = r;
  return rc;
}
