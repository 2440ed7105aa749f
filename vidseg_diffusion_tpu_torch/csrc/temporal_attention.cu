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
// row tiles. fp32 (the card-vs-CPU checks only) runs temporal_attn_kernel:
// one warp per problem on CUDA cores, lane i keeping query row i.
#include "common.cuh"
#include "temporal_tile.cuh"

namespace vs {

constexpr int kMaxFrames = 32;
constexpr int kWarpsPerBlock = 4;

// ---- fp32: CUDA cores ---------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(32 * kWarpsPerBlock) temporal_attn_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    float* __restrict__ o, int nvid, int t, int S, int H, float qscale) {
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
    Ks[e] = k[off];
    Vs[e] = v[off];
  }
  __syncwarp();
  if (lane >= t) return;

  const long long qoff = base + lane * frame_stride;
  float qv[D];
#pragma unroll
  for (int d = 0; d < D; ++d) qv[d] = q[qoff + d] * qscale;

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
      sc[j] = exp2f(sc[j] - m);
      l += sc[j];
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
  for (int d = 0; d < D; ++d) o[qoff + d] = ov[d] / l;
}

int launch_temporal_fp32(const void* q, const void* k, const void* v, void* o, int nvid, int t, int S, int H,
                         float qscale, cudaStream_t stream) {
  constexpr int D = 64;
  auto kern = temporal_attn_kernel<D>;
  const size_t smem = sizeof(float) * kWarpsPerBlock * 2 * t * D;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)(sizeof(float) * kWarpsPerBlock * 2 * kMaxFrames * D));
  if (err != cudaSuccess) return (int)err;
  const long long nprob = (long long)nvid * S * H;
  const long long blocks = (nprob + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > 0x7fffffffLL) return kErrBadArgument;
  kern<<<(unsigned)blocks, 32 * kWarpsPerBlock, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), nvid, t, S, H, qscale);
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

}  // namespace vs

// q, k, v, o: contiguous [(nvid*t), S, H*D], D = 64 (bf16: 16-byte aligned).
// route (or NULL) receives the kernel that ran: 1 mma.sync (bf16), 0 CUDA cores (fp32).
extern "C" int vs_temporal_attention_direct(int dtype, int D, const void* q, const void* k,
                                            const void* v, void* o, int nvid, int t, int S,
                                            int H, float qscale, int* route, void* stream) {
  if (nvid <= 0 || S <= 0 || H <= 0 || t <= 0 || t > vs::kMaxFrames)
    return vs::kErrBadArgument;
  if (D != 64) return vs::kErrUnsupported;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int r = -1, rc = vs::kErrUnsupported;
  if (dtype == vs::kBFloat16) {
    r = 1;
    rc = vs::launch_temporal_bf16(q, k, v, o, nvid, t, S, H, qscale, s);
  } else if (dtype == vs::kFloat32) {
    r = 0;
    rc = vs::launch_temporal_fp32(q, k, v, o, nvid, t, S, H, qscale, s);
  }
  if (route != nullptr) *route = r;
  return rc;
}
