// K6 temporal_attention_direct_bwd at D = 512 on the tensor cores: the
// VideoAttnBlock's time-mix backward (one 512-dim head, t = 7 on svd.yaml's
// 7-frame training clip, 14 on a decode of 14 latents) in bf16 and fp32, for
// t <= 16 frames. The C entry (vs_temporal_attention_direct_bwd in
// temporal_attention_bwd.cu) sends those problems here and longer ones to the
// wide kernel there.
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
// every S and dP element was a five-level warp sum. Here:
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
  lo = x3::split_lo(__uint_as_float(x));
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

}  // namespace k6tc

// K6 at D = 512, t <= kTc512Frames, on the tensor cores (bf16 mma.sync, fp32 split TF32);
// contiguous [(nvid t), S, H * 512], bases 16-byte aligned
int launch_temporal_bwd_tc512(int dtype, const void* q, const void* k, const void* v, const void* o, const void* g,
                              void* dq, void* dk, void* dv, int nvid, int t, int S, int H, float qscale, float scale,
                              cudaStream_t stream) {
  const uintptr_t bases = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                          reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o) |
                          reinterpret_cast<uintptr_t>(g) | reinterpret_cast<uintptr_t>(dq) |
                          reinterpret_cast<uintptr_t>(dk) | reinterpret_cast<uintptr_t>(dv);
  if (bases % 16 || t < 1 || t > 16) return kErrBadArgument;
  using bf = __nv_bfloat16;
  if (dtype == kBFloat16)
    return t <= 8 ? k6tc::launch<bf, 8>(q, k, v, o, g, dq, dk, dv, nvid, t, S, H, qscale, scale, stream)
                  : k6tc::launch<bf, 16>(q, k, v, o, g, dq, dk, dv, nvid, t, S, H, qscale, scale, stream);
  if (dtype == kFloat32)
    return t <= 8 ? k6tc::launch<float, 8>(q, k, v, o, g, dq, dk, dv, nvid, t, S, H, qscale, scale, stream)
                  : k6tc::launch<float, 16>(q, k, v, o, g, dq, dk, dv, nvid, t, S, H, qscale, scale, stream);
  return kErrUnsupported;
}

}  // namespace vs
