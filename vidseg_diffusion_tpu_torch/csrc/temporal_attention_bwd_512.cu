// K6 temporal_attention_direct_bwd at D = 512 on the tensor cores: the
// VideoAttnBlock's time-mix backward (one 512-dim head, t = 7 on svd.yaml's
// 7-frame training clip, 14 on a decode of 14 latents) in bf16 and fp32, from
// 4 (bf16) / 5 (fp32) to 32 frames. The C entry (vs_temporal_attention_direct_bwd
// in temporal_attention_bwd.cu) sends those problems here, shorter ones to the
// wide kernel there and longer ones to the tensor-core kernels of
// temporal_attention_long_tc.cu. Two kernels, by t: up to 16 frames an 8- or
// 16-row tile of frames with every input resident (below), from 17 to 32 a
// 32-row tile with v and o streamed (temporal_attn_bwd_tc512_r32_kernel, after
// it).
//
// Replaces (TPU): vidseg_diffusion_tpu/ops/attention.py:_small_seq_bwd_kernel
// (via _small_batched_attention_bwd_impl, reached from _tad_bwd) at one
// 512-dim head, on the direct layout [(b t), s, H * 512] as K6's other kernels.
//
// Math (temporal_attention_bwd.cu's, every rounding point in place): qf =
// round(q * qscale); p = e / sum(e), e = exp2(qf k^T - max), in fp32; delta =
// rowsum(g o); ds = round(p (g v^T - delta)); dq = scale ds k, dk = ds^T qf /
// log2(e), dv = round(p)^T g.
//
// What bounds it on the H100: bytes. A problem (video, token, head) is t x t
// over 512 channels: 10 t^2 512 flops on 16 t 512 bytes in bf16 (q, k, v, o, g
// read, dq, dk, dv written once; 32 t 512 in fp32), t / 1.6 flops a byte, far
// under the ~295 of bf16 products (~49 of fp32-class ones at 165 TFLOP/s).
//
// What held the wide kernel (one warp a problem, lanes across the channels): a
// stage of 4 t 512 elements a warp left 1 to 7 warps an SM, each copying its rows
// through registers 16 bytes a lane, so an SM had a few KB in flight; and
// every S and dP element was a five-level warp sum. Up to 16 frames:
// - one block a problem, four warps (eight past 8 frames). Its five inputs' t rows land in shared
//   memory by 16-byte cp.async copies all issued at once (35 KB at t = 7 in
//   bf16, 140 KB at t = 14 in fp32), as panels of FR (8 for t <= 8, else 16)
//   rows x 128 bytes (a row's 64 bf16 or 32 fp32 channels) under the 128-byte
//   swizzle, rows t..FR-1 zero. One to four blocks an SM (one in fp32 past 8
//   frames) keep tens of KB in flight an SM while others compute, and q, k and
//   g stay resident between the two passes (nothing is read twice);
// - warp w owns its share of the panels. It scales its q panels in place (qf),
//   then S = qf K^T, dP = g V^T and the row sums of g o over its channels on
//   mma.sync, the padded 16-row tile of frames as the M side. The
//   warps' partials meet in shared memory and every warp adds them in the same
//   order (the same bits on every warp) and forms p and ds on [16 x 16]
//   register fragments: no warp sum;
// - then its channels of dq = ds K, dk = ds^T qf and dv = round(p)^T g,
//   [16 x 16] x [16 x 64 (or 32)] products, each written over the panel it read
//   (k, q, g) and copied out 16 bytes a lane, neighbouring lanes on
//   neighbouring bytes.
// bf16 runs mma.sync.m16n8k16, ds^T and p^T by movmatrix. fp32 runs
// mma.sync.m16n8k8 in TF32 as three products of split operands, hi = x cut to
// TF32 (its low 13 bits dropped), lo = x - hi rounded to TF32, hi lo + lo hi +
// hi hi (tf32x3_attention.cuh's split); each chain on the tensor cores is at
// most 32 terms long (a panel's channels, or the keys) and is added in fp32
// registers (the tensor cores' fp32 sums truncate); ds^T and p^T through a
// small shared tile a warp.
#include "common.cuh"
#include "temporal_tile.cuh"
#include "tf32x3_attention.cuh"

namespace vs {
namespace k6tc {

constexpr int RED_FLOATS = 18 * 32;  // a warp's partials, per lane: S and dP (up to 8 each), delta (2)
constexpr int TPITCH = 20;           // floats a row of the fp32 p / ds tile (conflict-free fragment reads)
constexpr float kInvLog2E = 0.6931471805599453f;

template <typename T, int FR>
struct Cfg {
  static constexpr int WARPS = FR == 16 ? 8 : 4;             // the warps of a problem
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int NCH = kWideD * (int)sizeof(T) / 128;  // 128-byte panels a row: 8 (bf16), 16 (fp32)
  static constexpr int CPW = NCH / WARPS;                    // panels a warp
  static constexpr int NT = FR / 8;                          // 8-frame tiles of keys
  static constexpr int PANEL = FR * 128;
  static constexpr int RED = 5 * NCH * PANEL;                // after q, k, v, o, g
  static constexpr int TILE = RED + WARPS * RED_FLOATS * 4;  // fp32: each warp's p and ds tiles
  static constexpr int SMEM = TILE + (sizeof(T) == 4 ? WARPS * 2 * 16 * TPITCH * 4 : 0) + 128;
  static_assert(SMEM <= 232448, "shared memory");
};

// fragment addresses in a panel of 16 rows (FR = 8: the x2 forms, rows 0-7):
// the A operand (rows x 16 bf16 / 8 fp32 columns of 16-byte pair kk), the B
// operand read as columns (B = rows^T: the keys of S = Q K^T), and the B
// operand read through the transpose (B = rows: the contraction over frames)
template <int FR>
__device__ __forceinline__ void ld_a(uint32_t (&a)[4], uint32_t panel, int kk, int lane) {
  if constexpr (FR == 16) {
    tt_ldsm(a, tt_a_addr(panel, 0, kk, lane));
  } else {
    tt_ldsm_x2(a[0], a[2], panel + sw128(lane & 7, 2 * kk + ((lane >> 3) & 1)));
    a[1] = a[3] = 0u;
  }
}
template <int FR>
__device__ __forceinline__ void ld_bt(uint32_t (&b)[4], uint32_t panel, int kk, int lane) {
  if constexpr (FR == 16) {
    tt_ldsm(b, tt_bt_addr(panel, 0, kk, lane));
  } else {
    tt_ldsm_x2(b[0], b[1], panel + sw128(lane & 7, 2 * kk + ((lane >> 3) & 1)));
    b[2] = b[3] = 0u;
  }
}
template <int FR>
__device__ __forceinline__ void ld_b(uint32_t (&b)[4], uint32_t panel, int np, int lane) {
  if constexpr (FR == 16) {
    tt_ldsm_trans(b, tt_b_addr(panel, 0, np, lane));
  } else {
    tt_ldsm_x2_trans(b[0], b[2], panel + sw128(lane & 7, 2 * np + ((lane >> 3) & 1)));
    b[1] = b[3] = 0u;
  }
}

// x (fp32 bits) = hi + lo: hi cut to TF32, lo the rest rounded to TF32
__device__ __forceinline__ void split_cut(uint32_t x, uint32_t& hi, uint32_t& lo) {
  hi = x & 0xffffe000u;
  lo = tf32_lo(__uint_as_float(x));
}
template <int N>
__device__ __forceinline__ void split_cut(const uint32_t (&x)[N], uint32_t (&hi)[N], uint32_t (&lo)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) split_cut(x[i], hi[i], lo[i]);
}
// c += a b from the split parts, small terms first
__device__ __forceinline__ void mma_x3(float (&c)[4], const uint32_t (&ah)[4], const uint32_t (&al)[4], uint32_t bh0,
                                       uint32_t bh1, uint32_t bl0, uint32_t bl1) {
  tt_mma_tf32(c, ah, bl0, bl1);
  tt_mma_tf32(c, al, bh0, bh1);
  tt_mma_tf32(c, ah, bh0, bh1);
}

template <typename T, int FR>
__global__ void __launch_bounds__(Cfg<T, FR>::THREADS) temporal_attn_bwd_tc512_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v, const T* __restrict__ o,
    const T* __restrict__ g, T* __restrict__ dq, T* __restrict__ dk, T* __restrict__ dv, int t, int S, int H,
    float qscale, float scale) {
  using C = Cfg<T, FR>;
  constexpr bool F32 = sizeof(T) == 4;
  constexpr int NT = C::NT, WARPS = C::WARPS, THREADS = C::THREADS;
  extern __shared__ unsigned char k6tc_smem[];
  const uint32_t base = (smem_u32(k6tc_smem) + 127u) & ~127u;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, gid = lane >> 2, tig = lane & 3;
  const int h = (int)(blockIdx.x % H);
  const long long rest = blockIdx.x / H;
  const int s = (int)(rest % S);
  const long long b = rest / S;
  const long long frame = (long long)S * H * kWideD;  // elements from one frame's row to the next
  const long long off0 = b * t * frame + (long long)s * H * kWideD + (long long)h * kWideD;
  auto panel = [&](int x, int c) { return base + (uint32_t)((x * C::NCH + c) * C::PANEL); };

  // rows t..FR-1 of every panel: zeros (the padded rows of the 16-row tiles)
  const int pad = FR - t;
  for (int e = tid; e < 5 * C::NCH * pad * 8; e += THREADS) {
    const int pr = e >> 3;
    tt_st128(base + (uint32_t)((pr / pad) * C::PANEL) + (uint32_t)((t + pr % pad) * 128 + (e & 7) * 16),
             make_uint4(0u, 0u, 0u, 0u));
  }
  {  // q, k, v, o, g: every row of the problem, 16 bytes a copy
    const T* const src[5] = {q, k, v, o, g};
#pragma unroll
    for (int x = 0; x < 5; ++x) {
      const char* row0 = reinterpret_cast<const char*>(src[x] + off0);
      for (int e = tid; e < t * C::NCH * 8; e += THREADS) {
        const int r = e / (C::NCH * 8), c = (e >> 3) % C::NCH, piece = e & 7;
        tt_cp16(panel(x, c) + sw128(r, piece), row0 + r * frame * (long long)sizeof(T) + c * 128 + piece * 16);
      }
    }
    tt_cp_commit();
    tt_cp_wait<0>();
  }
  __syncthreads();

  // qf = round(q * qscale) in place on this warp's panels
#pragma unroll
  for (int cc = 0; cc < C::CPW; ++cc) {
    const uint32_t pq = panel(0, warp * C::CPW + cc);
    for (int e = lane; e < t * 8; e += 32) {
      const uint32_t addr = pq + sw128(e >> 3, e & 7);
      uint4 x = tt_ld128(addr);
      uint32_t* w = reinterpret_cast<uint32_t*>(&x);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        w[j] = F32 ? __float_as_uint(__uint_as_float(w[j]) * qscale) : tt_pack(tt_lo(w[j]) * qscale, tt_hi(w[j]) * qscale);
      tt_st128(addr, x);
    }
  }
  __syncwarp();

  // pass 1 over this warp's channels: S = qf K^T, dP = g V^T, row sums of g o
  float sacc[NT][4], pacc[NT][4], dl[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int u = 0; u < 4; ++u) sacc[n][u] = pacc[n][u] = 0.f;
#pragma unroll
  for (int cc = 0; cc < C::CPW; ++cc) {
    const int c = warp * C::CPW + cc;
    const uint32_t pq = panel(0, c), pk = panel(1, c), pv = panel(2, c), po = panel(3, c), pg = panel(4, c);
    float st[NT][4], pt[NT][4];  // fp32: this panel's sums, on the tensor cores from zero
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int u = 0; u < 4; ++u) st[n][u] = pt[n][u] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {  // 16 bf16 / 8 fp32 channels
      uint32_t aq[4], ag[4], ao[4], bk[4], bv[4];
      ld_a<FR>(aq, pq, kk, lane);
      ld_a<FR>(ag, pg, kk, lane);
      ld_a<FR>(ao, po, kk, lane);
      ld_bt<FR>(bk, pk, kk, lane);
      ld_bt<FR>(bv, pv, kk, lane);
#pragma unroll
      for (int j = 0; j < 4; ++j)  // a[0], a[2]: row gid; a[1], a[3]: row gid + 8
        dl[j & 1] += F32 ? __uint_as_float(ag[j]) * __uint_as_float(ao[j])
                         : tt_lo(ag[j]) * tt_lo(ao[j]) + tt_hi(ag[j]) * tt_hi(ao[j]);
      if constexpr (F32) {
        uint32_t qh[4], ql[4], gh[4], gl[4], kh[4], kl[4], vh[4], vl[4];
        split_cut(aq, qh, ql);
        split_cut(ag, gh, gl);
        split_cut(bk, kh, kl);
        split_cut(bv, vh, vl);
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          mma_x3(st[n], qh, ql, kh[2 * n], kh[2 * n + 1], kl[2 * n], kl[2 * n + 1]);
          mma_x3(pt[n], gh, gl, vh[2 * n], vh[2 * n + 1], vl[2 * n], vl[2 * n + 1]);
        }
      } else {
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          tt_mma(sacc[n], aq, bk[2 * n], bk[2 * n + 1]);
          tt_mma(pacc[n], ag, bv[2 * n], bv[2 * n + 1]);
        }
      }
    }
    if constexpr (F32) {
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int u = 0; u < 4; ++u) sacc[n][u] += st[n][u], pacc[n][u] += pt[n][u];
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    dl[r] += __shfl_xor_sync(0xffffffffu, dl[r], 1);
    dl[r] += __shfl_xor_sync(0xffffffffu, dl[r], 2);
  }

  // the four warps' partials, added in warp order by every warp
  {
    const uint32_t mine = base + C::RED + (uint32_t)(warp * RED_FLOATS * 4);
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        x3::stsf(mine + 4 * ((4 * n + u) * 32 + lane), sacc[n][u]);
        x3::stsf(mine + 4 * ((8 + 4 * n + u) * 32 + lane), pacc[n][u]);
      }
    x3::stsf(mine + 4 * (16 * 32 + lane), dl[0]);
    x3::stsf(mine + 4 * (17 * 32 + lane), dl[1]);
  }
  __syncthreads();
  float sv[NT][4], dp[NT][4], delta[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int u = 0; u < 4; ++u) sv[n][u] = dp[n][u] = 0.f;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    const uint32_t red = base + C::RED + (uint32_t)(w * RED_FLOATS * 4);
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        sv[n][u] += x3::lds(red + 4 * ((4 * n + u) * 32 + lane));
        dp[n][u] += x3::lds(red + 4 * ((8 + 4 * n + u) * 32 + lane));
      }
    delta[0] += x3::lds(red + 4 * (16 * 32 + lane));
    delta[1] += x3::lds(red + 4 * (17 * 32 + lane));
  }

  // the true softmax p = e / sum(e) in fp32, keys >= t masked; frames >= t get p = ds = 0;
  // ds = p (dP - delta). sv[n][u]: frame gid + 8 (u >> 1), key 8 n + 2 tig + (u & 1)
  float mx[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (8 * n + 2 * tig + (u & 1) >= t) sv[n][u] = -INFINITY;
      mx[u >> 1] = fmaxf(mx[u >> 1], sv[n][u]);
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
  }
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      sv[n][u] = exp2f(sv[n][u] - mx[u >> 1]);
      l[u >> 1] += sv[n][u];
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  float p[NT][4], ds[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      p[n][u] = gid + 8 * (u >> 1) < t ? sv[n][u] / l[u >> 1] : 0.f;
      ds[n][u] = p[n][u] * (dp[n][u] - delta[u >> 1]);
    }

  // pass 2 over this warp's channels: dq = scale ds K into k's panel, dk = ds^T qf / log2(e)
  // into q's, dv = round(p)^T g into g's; then those rows go out
  auto copy_out = [&](int c, const uint32_t (&src)[3]) {
    T* const dst[3] = {dq, dk, dv};
#pragma unroll
    for (int x = 0; x < 3; ++x) {
      char* row0 = reinterpret_cast<char*>(dst[x] + off0) + c * 128;
      for (int e = lane; e < t * 8; e += 32) {
        const int r = e >> 3, piece = e & 7;
        *reinterpret_cast<uint4*>(row0 + r * frame * (long long)sizeof(T) + piece * 16) =
            tt_ld128(src[x] + sw128(r, piece));
      }
    }
  };
  if constexpr (!F32) {
    // ds (frames x keys, one k16 step) and round(p), and their transposes (keys x frames)
    uint32_t ads[4], ap[4];
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        ads[2 * n + r] = n < NT ? tt_pack(ds[n < NT ? n : 0][2 * r], ds[n < NT ? n : 0][2 * r + 1]) : 0u;
        ap[2 * n + r] = n < NT ? tt_pack(p[n < NT ? n : 0][2 * r], p[n < NT ? n : 0][2 * r + 1]) : 0u;
      }
    const uint32_t adst[4] = {tt_movt(ads[0]), tt_movt(ads[2]), tt_movt(ads[1]), tt_movt(ads[3])};
    const uint32_t apt[4] = {tt_movt(ap[0]), tt_movt(ap[2]), tt_movt(ap[1]), tt_movt(ap[3])};
    // out (+)= A B over this panel's 64 channels, B from `src` read as the contraction
    auto product = [&](const uint32_t (&a)[4], uint32_t src, float mul) {
      float acc[8][4];
#pragma unroll
      for (int n = 0; n < 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bb[4];
        ld_b<FR>(bb, src, np, lane);
        tt_mma(acc[2 * np], a, bb[0], bb[1]);
        tt_mma(acc[2 * np + 1], a, bb[2], bb[3]);
      }
      __syncwarp();  // every lane's reads of the panel are done: the output goes over it
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        if (gid < t) tt_st32(src + sw128(gid, n) + 4 * tig, tt_pack(acc[n][0] * mul, acc[n][1] * mul));
        if (gid + 8 < t) tt_st32(src + sw128(gid + 8, n) + 4 * tig, tt_pack(acc[n][2] * mul, acc[n][3] * mul));
      }
    };
#pragma unroll
    for (int cc = 0; cc < C::CPW; ++cc) {
      const int c = warp * C::CPW + cc;
      const uint32_t out[3] = {panel(1, c), panel(0, c), panel(4, c)};  // dq, dk, dv
      product(ads, out[0], scale);
      product(adst, out[1], kInvLog2E);
      product(apt, out[2], 1.f);
      __syncwarp();
      copy_out(c, out);
    }
  } else {
    // ds as the A operand of dq (frames x keys; k-step slot tig <-> key 2 tig, tig + 4 <-> 2 tig + 1),
    // and ds^T, p^T (keys x frames, the same slots over frames) through this warp's tile
    uint32_t dsh[NT][4], dsl[NT][4], dth[NT][4], dtl[NT][4], pth[NT][4], ptl[NT][4];
    const uint32_t tile = base + C::TILE + (uint32_t)(warp * 2 * 16 * TPITCH * 4), tds = tile + 16 * TPITCH * 4;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const uint32_t x[4] = {__float_as_uint(ds[n][0]), __float_as_uint(ds[n][2]), __float_as_uint(ds[n][1]),
                             __float_as_uint(ds[n][3])};
      split_cut(x, dsh[n], dsl[n]);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const uint32_t at = 4 * ((gid + 8 * r) * TPITCH + 8 * n + 2 * tig);
        asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" ::"r"(tile + at), "f"(p[n][2 * r]), "f"(p[n][2 * r + 1])
                     : "memory");
        asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" ::"r"(tds + at), "f"(ds[n][2 * r]), "f"(ds[n][2 * r + 1])
                     : "memory");
      }
    }
    __syncwarp();
#pragma unroll
    for (int kk = 0; kk < NT; ++kk) {
      const int f0 = 8 * kk + 2 * tig;  // the frames of slots tig, tig + 4
      auto at = [&](uint32_t t_, int f, int key) {
        return NT == 2 || key < 8 ? __float_as_uint(x3::lds(t_ + 4 * (f * TPITCH + key))) : 0u;
      };
      const uint32_t xd[4] = {at(tds, f0, gid), at(tds, f0, gid + 8), at(tds, f0 + 1, gid), at(tds, f0 + 1, gid + 8)};
      const uint32_t xp[4] = {at(tile, f0, gid), at(tile, f0, gid + 8), at(tile, f0 + 1, gid),
                              at(tile, f0 + 1, gid + 8)};
      split_cut(xd, dth[kk], dtl[kk]);
      split_cut(xp, pth[kk], ptl[kk]);
    }
    // out = A B over this panel's 32 channels, B from `src` (frames x channels) in the slots' frames
    auto product = [&](const uint32_t (&ah)[NT][4], const uint32_t (&al)[NT][4], uint32_t src, float mul) {
      float acc[4][4];
#pragma unroll
      for (int n = 0; n < 4; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < NT; ++kk)
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          uint32_t bh0, bl0, bh1, bl1;
          split_cut(__float_as_uint(x3::lds(src + x3::sw(8 * kk + 2 * tig, 8 * n + gid))), bh0, bl0);
          split_cut(__float_as_uint(x3::lds(src + x3::sw(8 * kk + 2 * tig + 1, 8 * n + gid))), bh1, bl1);
          mma_x3(acc[n], ah[kk], al[kk], bh0, bh1, bl0, bl1);
        }
      __syncwarp();
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int r = 0; r < 2; ++r)
          if (gid + 8 * r < t)
            asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" ::"r"(src + x3::sw(gid + 8 * r, 8 * n + 2 * tig)),
                         "f"(acc[n][2 * r] * mul), "f"(acc[n][2 * r + 1] * mul)
                         : "memory");
    };
#pragma unroll
    for (int cc = 0; cc < C::CPW; ++cc) {
      const int c = warp * C::CPW + cc;
      const uint32_t out[3] = {panel(1, c), panel(0, c), panel(4, c)};  // dq, dk, dv
      product(dsh, dsl, out[0], scale);
      product(dth, dtl, out[1], kInvLog2E);
      product(pth, ptl, out[2], 1.f);
      __syncwarp();
      copy_out(c, out);
    }
  }
}

template <typename T, int FR>
int launch(const void* q, const void* k, const void* v, const void* o, const void* g, void* dq, void* dk, void* dv,
           int nvid, int t, int S, int H, float qscale, float scale, cudaStream_t stream) {
  using C = Cfg<T, FR>;
  auto kern = temporal_attn_bwd_tc512_kernel<T, FR>;
  static const cudaError_t attr = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (attr != cudaSuccess) return (int)attr;
  const long long nprob = (long long)nvid * S * H;
  if (nprob > 0x7fffffffLL) return kErrBadArgument;
  kern<<<(unsigned)nprob, C::THREADS, C::SMEM, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), static_cast<const T*>(o),
      static_cast<const T*>(g), static_cast<T*>(dq), static_cast<T*>(dk), static_cast<T*>(dv), t, S, H, qscale, scale);
  return (int)cudaGetLastError();
}

// ---- 17 to 32 frames: a 32-row tile of frames ------------------------------------
//
// Two m16 row tiles of frames and 32 keys. Every input resident would take 5 x
// 32 x 1 KB in bf16, 320 KB in fp32, over a block's 227 KB. v and o are read
// only for dP = g V^T and delta = rowsum(g o), so q, k and g stay resident
// (96 KB / 192 KB; each read by both passes) and v and o walk through a ring
// of two chunk buffers, the next chunk's copies in flight while one is read:
// one panel a chunk in bf16, which then fits two blocks an SM (115 KB; 5-7 %
// faster than every row at once at 17-28 frames, PERF.md row 26), two panels
// in fp32 (one block an SM, 224 KB). The split of pass 1
// changes too: a channel split would leave each warp 2 x 32 x 32 partial sums
// to meet in shared memory (64 KB for eight warps, more than is left in fp32),
// so here the warps split the outputs instead. Warps 0-3 each own a 16 x 16
// region of S = qf K^T (frames 16 mi.., keys 16 nj..) and warps 4-7 the same
// region of dP = g V^T, each summed over all 512 channels by one warp (fp32:
// chains of one panel's 32 channels on the tensor cores, added in registers);
// every warp also sums g o over the channels of four rows (a lane a 16-byte
// piece, the eight pieces by butterfly). No element is summed by two warps,
// so every warp sees the same bits with no partials. S and dP meet in shared
// memory (over the spent chunk buffers); warp w forms the softmax of rows w,
// w + 8, ... (a lane a key, keys >= t masked, rows >= t zero): p = e / sum(e)
// and ds = p (dP - delta) into two [32 x 40] tiles, rounded to T (bf16: the
// rounding of round(p) and ds). Pass 2 is the channel split of up to 16
// frames: warp w's panels of dq = scale ds K, dk = ds^T qf / log2(e) and dv =
// round(p)^T g, [32 x 32] x [32 x 64 (fp32: 32)] products (bf16: ldmatrix and
// ldmatrix.trans on the tiles, mma.sync.m16n8k16; fp32: split TF32
// m16n8k8, one chain over the 32 keys or frames), written over the panel each
// read (k, q, g) and copied out.

template <typename T>
struct Cfg32 {
  static constexpr bool F32 = sizeof(T) == 4;
  static constexpr int FR = 32, WARPS = 8, THREADS = 32 * WARPS;
  static constexpr int NCH = kWideD * (int)sizeof(T) / 128;  // 128-byte panels a row: 8 (bf16), 16 (fp32)
  static constexpr int PANEL = FR * 128;
  static constexpr int CP = F32 ? 2 : 1;                     // v (and o) panels a chunk
  static constexpr int NBUF = 2;                             // chunk buffers
  static constexpr int MIN_BLOCKS = F32 ? 1 : 2;             // bf16: 115 KB, two blocks an SM
  static constexpr int NCHUNK = NCH / CP;
  static constexpr int CPW = NCH / WARPS;                    // pass 2: panels a warp
  static constexpr int Q = 0, K = NCH * PANEL, G = 2 * NCH * PANEL, VO = 3 * NCH * PANEL;
  static constexpr int BUF = 2 * CP * PANEL;                 // a chunk buffer: CP panels of v, then CP of o
  static constexpr int DELTA = VO + NBUF * BUF;              // rowsum(g o), 32 floats
  static constexpr int SMEM = DELTA + FR * 4 + 128;
  // over the chunk buffers once the walk is done: S and dP (fp32 [32][32]), then the round(p) and ds tiles
  static constexpr int XS = VO, XD = VO + FR * FR * 4, TPITCH = 40;  // tile rows: 40 elements
  static constexpr int TP = VO + 2 * FR * FR * 4, TILE = FR * TPITCH * (int)sizeof(T), TDS = TP + TILE;
  static_assert(TDS + TILE <= DELTA, "the p and ds tiles fit the chunk buffers");
  static_assert(SMEM <= 232448, "shared memory");
};

template <typename T>
__global__ void __launch_bounds__(Cfg32<T>::THREADS, Cfg32<T>::MIN_BLOCKS) temporal_attn_bwd_tc512_r32_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v, const T* __restrict__ o,
    const T* __restrict__ g, T* __restrict__ dq, T* __restrict__ dk, T* __restrict__ dv, int t, int S, int H,
    float qscale, float scale) {
  using C = Cfg32<T>;
  constexpr bool F32 = C::F32;
  constexpr int NCH = C::NCH, CP = C::CP, NBUF = C::NBUF, PANEL = C::PANEL;
  extern __shared__ unsigned char k6r32_smem[];
  const uint32_t base = (smem_u32(k6r32_smem) + 127u) & ~127u;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, gid = lane >> 2, tig = lane & 3;
  const int h = (int)(blockIdx.x % H);
  const long long rest = blockIdx.x / H;
  const int s = (int)(rest % S);
  const long long b = rest / S;
  const long long frame = (long long)S * H * kWideD * (long long)sizeof(T);  // bytes from a frame's row to the next
  const long long off0 = (b * t * S * H + (long long)s * H + h) * kWideD;
  const uint32_t q_at = base + C::Q, k_at = base + C::K, g_at = base + C::G;

  // rows t..31 of every panel (q, k, g and the chunk buffers, contiguous): zeros
  const int pad = C::FR - t;
  for (int e = tid; e < (3 * NCH + NBUF * 2 * CP) * pad * 8; e += C::THREADS) {
    const int pr = e >> 3;
    tt_st128(base + (uint32_t)((pr / pad) * PANEL + (t + pr % pad) * 128 + (e & 7) * 16), make_uint4(0u, 0u, 0u, 0u));
  }
  {  // q, k, g: every row, 16 bytes a copy
    const T* const src[3] = {q, k, g};
    const uint32_t dst[3] = {q_at, k_at, g_at};
#pragma unroll
    for (int x = 0; x < 3; ++x) {
      const char* row0 = reinterpret_cast<const char*>(src[x] + off0);
      for (int e = tid; e < t * NCH * 8; e += C::THREADS) {
        const int r = e / (NCH * 8), c = (e >> 3) % NCH, piece = e & 7;
        tt_cp16(dst[x] + c * PANEL + sw128(r, piece), row0 + r * frame + c * 128 + piece * 16);
      }
    }
    tt_cp_commit();
  }
  // v and o panels ch CP .. ch CP + CP - 1 into buffer ch % NBUF; a group committed for every chunk buffer
  auto load_chunk = [&](int ch) {
    const uint32_t buf = base + C::VO + (ch % NBUF) * C::BUF;
    for (int e = tid; e < 2 * t * CP * 8; e += C::THREADS) {
      const int x = e / (t * CP * 8), rem = e % (t * CP * 8);
      const int r = rem / (CP * 8), j = (rem >> 3) % CP, piece = rem & 7;
      const char* row0 = reinterpret_cast<const char*>((x ? o : v) + off0);
      tt_cp16(buf + (x * CP + j) * PANEL + sw128(r, piece), row0 + r * frame + (ch * CP + j) * 128 + piece * 16);
    }
  };
#pragma unroll
  for (int ch = 0; ch < NBUF; ++ch) {
    if (ch < C::NCHUNK) load_chunk(ch);
    tt_cp_commit();
  }
  tt_cp_wait<NBUF>();  // this thread's copies of q, k and g
  __syncthreads();
  // qf = round(q * qscale) in place, every panel (the walk's first barrier orders it before the products)
  for (int e = tid; e < NCH * t * 8; e += C::THREADS) {
    const int c = e / (t * 8), r = (e >> 3) % t;
    const uint32_t addr = q_at + c * PANEL + sw128(r, e & 7);
    uint4 x = tt_ld128(addr);
    uint32_t* w = reinterpret_cast<uint32_t*>(&x);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      w[j] = F32 ? __float_as_uint(__uint_as_float(w[j]) * qscale) : tt_pack(tt_lo(w[j]) * qscale, tt_hi(w[j]) * qscale);
    tt_st128(addr, x);
  }

  // pass 1: warps 0-3 S and warps 4-7 dP over their 16 x 16 region; every warp rowsum(g o) of four rows
  const bool s_warp = warp < 4;
  const int mi = (warp & 3) >> 1, nj = warp & 1;
  const int drow = 4 * warp + (lane >> 3), dpiece = lane & 7;
  float acc[2][4], dsum = 0.f;
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int u = 0; u < 4; ++u) acc[n][u] = 0.f;
  for (int ch = 0; ch < C::NCHUNK; ++ch) {
    tt_cp_wait<NBUF - 1>();  // this chunk's copies
    __syncthreads();
    const uint32_t buf = base + C::VO + (ch % NBUF) * C::BUF;
#pragma unroll
    for (int j = 0; j < CP; ++j) {
      const int c = ch * CP + j;
      const uint32_t pa = (s_warp ? q_at : g_at) + c * PANEL, pb = s_warp ? k_at + c * PANEL : buf + j * PANEL;
      float pt[2][4];  // fp32: this panel's sums, on the tensor cores from zero
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int u = 0; u < 4; ++u) pt[n][u] = 0.f;
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {  // 16 bf16 / 8 fp32 channels
        uint32_t a[4], bb[4];
        tt_ldsm(a, tt_a_addr(pa, 16 * mi, ks, lane));
        tt_ldsm(bb, tt_bt_addr(pb, 16 * nj, ks, lane));
        if constexpr (F32) {
          uint32_t ah[4], al[4], bh[4], bl[4];
          split_cut(a, ah, al);
          split_cut(bb, bh, bl);
          mma_x3(pt[0], ah, al, bh[0], bh[1], bl[0], bl[1]);
          mma_x3(pt[1], ah, al, bh[2], bh[3], bl[2], bl[3]);
        } else {
          tt_mma(acc[0], a, bb[0], bb[1]);
          tt_mma(acc[1], a, bb[2], bb[3]);
        }
      }
      if constexpr (F32) {
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int u = 0; u < 4; ++u) acc[n][u] += pt[n][u];
      }
      if (drow < t) {
        const uint4 gv = tt_ld128(g_at + c * PANEL + sw128(drow, dpiece));
        const uint4 ov = tt_ld128(buf + (CP + j) * PANEL + sw128(drow, dpiece));
        const uint32_t* gw = reinterpret_cast<const uint32_t*>(&gv);
        const uint32_t* ow = reinterpret_cast<const uint32_t*>(&ov);
#pragma unroll
        for (int u = 0; u < 4; ++u)
          dsum += F32 ? __uint_as_float(gw[u]) * __uint_as_float(ow[u])
                      : tt_lo(gw[u]) * tt_lo(ow[u]) + tt_hi(gw[u]) * tt_hi(ow[u]);
      }
    }
    __syncthreads();  // every warp is done with this buffer
    if (ch + NBUF < C::NCHUNK) load_chunk(ch + NBUF);
    tt_cp_commit();
  }

  // S and dP over the spent buffers, rowsum(g o) by butterfly over a row's eight pieces
  {
    const uint32_t x = base + (s_warp ? C::XS : C::XD);
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" ::"r"(
                         x + 4 * ((16 * mi + gid + 8 * r) * C::FR + 16 * nj + 8 * n + 2 * tig)),
                     "f"(acc[n][2 * r]), "f"(acc[n][2 * r + 1])
                     : "memory");
#pragma unroll
    for (int m = 1; m < 8; m <<= 1) dsum += __shfl_xor_sync(0xffffffffu, dsum, m);
    if (dpiece == 0) x3::stsf(base + C::DELTA + 4 * drow, dsum);
  }
  __syncthreads();
  // the softmax of rows warp, warp + 8, ..., a lane a key: p = e / sum(e), ds = p (dP - delta), rows >= t zero
#pragma unroll
  for (int rr = 0; rr < 4; ++rr) {
    const int i = warp + 8 * rr;
    float pv = 0.f, dsv = 0.f;
    if (i < t) {
      const float sij = lane < t ? x3::lds(base + C::XS + 4 * (i * C::FR + lane)) : -INFINITY;
      const float e = exp2f(sij - warp_max(sij));
      pv = e / warp_sum(e);
      dsv = pv * (x3::lds(base + C::XD + 4 * (i * C::FR + lane)) - x3::lds(base + C::DELTA + 4 * i));
    }
    const uint32_t at = (uint32_t)((i * C::TPITCH + lane) * sizeof(T));
    if constexpr (F32) {
      x3::stsf(base + C::TP + at, pv);
      x3::stsf(base + C::TDS + at, dsv);
    } else {
      const __nv_bfloat16 pb = __float2bfloat16(pv), db = __float2bfloat16(dsv);
      asm volatile("st.shared.b16 [%0], %1;\n" ::"r"(base + C::TP + at), "h"(*reinterpret_cast<const uint16_t*>(&pb))
                   : "memory");
      asm volatile("st.shared.b16 [%0], %1;\n" ::"r"(base + C::TDS + at), "h"(*reinterpret_cast<const uint16_t*>(&db))
                   : "memory");
    }
  }
  __syncthreads();

  // pass 2 over this warp's panels: dq = scale ds K into k's panel, dk = ds^T qf / log2(e) into q's,
  // dv = round(p)^T g into g's; then those rows go out
  auto copy_out = [&](int c, const uint32_t (&src)[3]) {
    T* const dst[3] = {dq, dk, dv};
#pragma unroll
    for (int x = 0; x < 3; ++x) {
      char* row0 = reinterpret_cast<char*>(dst[x] + off0) + c * 128;
      for (int e = lane; e < t * 8; e += 32) {
        const int r = e >> 3, piece = e & 7;
        *reinterpret_cast<uint4*>(row0 + r * frame + piece * 16) = tt_ld128(src[x] + sw128(r, piece));
      }
    }
  };
  const uint32_t tp = base + C::TP, tds = base + C::TDS;
  if constexpr (!F32) {
    constexpr int PB = C::TPITCH * 2;  // bytes a tile row
    // out = A B over this panel's 64 channels, A [32 x 32] from a tile (trans: the tile's transpose), B from `src`
    // read as the contraction (rows = keys or frames)
    auto product = [&](uint32_t tile, bool trans, uint32_t src, float mul) {
      float out[2][8][4];
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int n = 0; n < 8; ++n) out[m][n][0] = out[m][n][1] = out[m][n][2] = out[m][n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {  // 16 keys / frames a k-step
        uint32_t a[2][4];
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          if (trans)
            tt_ldsm_trans(a[m], tile + (16 * kk + (lane & 7) + 8 * (lane >> 4)) * PB + (16 * m + 8 * ((lane >> 3) & 1)) * 2);
          else
            tt_ldsm(a[m], tile + (16 * m + (lane & 7) + 8 * ((lane >> 3) & 1)) * PB + (16 * kk + 8 * (lane >> 4)) * 2);
        }
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          uint32_t bb[4];
          tt_ldsm_trans(bb, tt_b_addr(src, 16 * kk, np, lane));
#pragma unroll
          for (int m = 0; m < 2; ++m) {
            tt_mma(out[m][2 * np], a[m], bb[0], bb[1]);
            tt_mma(out[m][2 * np + 1], a[m], bb[2], bb[3]);
          }
        }
      }
      __syncwarp();  // every lane's reads of the panel are done: the output goes over it
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          tt_st32(src + sw128(16 * m + gid, n) + 4 * tig, tt_pack(out[m][n][0] * mul, out[m][n][1] * mul));
          tt_st32(src + sw128(16 * m + gid + 8, n) + 4 * tig, tt_pack(out[m][n][2] * mul, out[m][n][3] * mul));
        }
    };
#pragma unroll
    for (int cc = 0; cc < C::CPW; ++cc) {
      const int c = warp * C::CPW + cc;
      const uint32_t out[3] = {k_at + c * PANEL, q_at + c * PANEL, g_at + c * PANEL};  // dq, dk, dv
      product(tds, false, out[0], scale);
      product(tds, true, out[1], kInvLog2E);
      product(tp, true, out[2], 1.f);
      __syncwarp();
      copy_out(c, out);
    }
  } else {
    // k-step slot tig <-> key / frame 2 tig, slot tig + 4 <-> 2 tig + 1 (conflict-free B reads under the swizzle)
    auto ld = [&](uint32_t tile, int r, int c) { return __float_as_uint(x3::lds(tile + 4 * (r * C::TPITCH + c))); };
    auto product = [&](uint32_t tile, bool trans, uint32_t src, float mul) {
      float out[2][4][4];
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int n = 0; n < 4; ++n) out[m][n][0] = out[m][n][1] = out[m][n][2] = out[m][n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {  // 8 keys / frames a k-step: one chain of 32 terms
        uint32_t ah[2][4], al[2][4];
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          const int r0 = 16 * m + gid, k0 = 8 * kk + 2 * tig;
          // a[0] (row r0, slot tig), a[1] (r0 + 8, tig), a[2] (r0, tig + 4), a[3] (r0 + 8, tig + 4)
          uint32_t x[4];
          if (trans) {
            x[0] = ld(tile, k0, r0), x[1] = ld(tile, k0, r0 + 8), x[2] = ld(tile, k0 + 1, r0);
            x[3] = ld(tile, k0 + 1, r0 + 8);
          } else {
            x[0] = ld(tile, r0, k0), x[1] = ld(tile, r0 + 8, k0), x[2] = ld(tile, r0, k0 + 1);
            x[3] = ld(tile, r0 + 8, k0 + 1);
          }
          split_cut(x, ah[m], al[m]);
        }
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          uint32_t bh0, bl0, bh1, bl1;
          split_cut(__float_as_uint(x3::lds(src + x3::sw(8 * kk + 2 * tig, 8 * n + gid))), bh0, bl0);
          split_cut(__float_as_uint(x3::lds(src + x3::sw(8 * kk + 2 * tig + 1, 8 * n + gid))), bh1, bl1);
#pragma unroll
          for (int m = 0; m < 2; ++m) mma_x3(out[m][n], ah[m], al[m], bh0, bh1, bl0, bl1);
        }
      }
      __syncwarp();
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int r = 0; r < 2; ++r)
            asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" ::"r"(src + x3::sw(16 * m + gid + 8 * r, 8 * n + 2 * tig)),
                         "f"(out[m][n][2 * r] * mul), "f"(out[m][n][2 * r + 1] * mul)
                         : "memory");
    };
#pragma unroll
    for (int cc = 0; cc < C::CPW; ++cc) {
      const int c = warp * C::CPW + cc;
      const uint32_t out[3] = {k_at + c * PANEL, q_at + c * PANEL, g_at + c * PANEL};  // dq, dk, dv
      product(tds, false, out[0], scale);
      product(tds, true, out[1], kInvLog2E);
      product(tp, true, out[2], 1.f);
      __syncwarp();
      copy_out(c, out);
    }
  }
}

template <typename T>
int launch32(const void* q, const void* k, const void* v, const void* o, const void* g, void* dq, void* dk, void* dv,
             int nvid, int t, int S, int H, float qscale, float scale, cudaStream_t stream) {
  using C = Cfg32<T>;
  auto kern = temporal_attn_bwd_tc512_r32_kernel<T>;
  static const cudaError_t attr = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (attr != cudaSuccess) return (int)attr;
  const long long nprob = (long long)nvid * S * H;
  if (nprob > 0x7fffffffLL) return kErrBadArgument;
  kern<<<(unsigned)nprob, C::THREADS, C::SMEM, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), static_cast<const T*>(o),
      static_cast<const T*>(g), static_cast<T*>(dq), static_cast<T*>(dk), static_cast<T*>(dv), t, S, H, qscale, scale);
  return (int)cudaGetLastError();
}

}  // namespace k6tc

// K6 at D = 512, t <= 32, on the tensor cores (bf16 mma.sync, fp32 split TF32);
// contiguous [(nvid t), S, H * 512], bases 16-byte aligned
int launch_temporal_bwd_tc512(int dtype, const void* q, const void* k, const void* v, const void* o, const void* g,
                              void* dq, void* dk, void* dv, int nvid, int t, int S, int H, float qscale, float scale,
                              cudaStream_t stream) {
  const uintptr_t bases = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                          reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o) |
                          reinterpret_cast<uintptr_t>(g) | reinterpret_cast<uintptr_t>(dq) |
                          reinterpret_cast<uintptr_t>(dk) | reinterpret_cast<uintptr_t>(dv);
  if (bases % 16 || t < 1 || t > 32) return kErrBadArgument;
  using bf = __nv_bfloat16;
  if (dtype == kBFloat16)
    return t <= 8    ? k6tc::launch<bf, 8>(q, k, v, o, g, dq, dk, dv, nvid, t, S, H, qscale, scale, stream)
           : t <= 16 ? k6tc::launch<bf, 16>(q, k, v, o, g, dq, dk, dv, nvid, t, S, H, qscale, scale, stream)
                     : k6tc::launch32<bf>(q, k, v, o, g, dq, dk, dv, nvid, t, S, H, qscale, scale, stream);
  if (dtype == kFloat32)
    return t <= 8    ? k6tc::launch<float, 8>(q, k, v, o, g, dq, dk, dv, nvid, t, S, H, qscale, scale, stream)
           : t <= 16 ? k6tc::launch<float, 16>(q, k, v, o, g, dq, dk, dv, nvid, t, S, H, qscale, scale, stream)
                     : k6tc::launch32<float>(q, k, v, o, g, dq, dk, dv, nvid, t, S, H, qscale, scale, stream);
  return kErrUnsupported;
}

}  // namespace vs
