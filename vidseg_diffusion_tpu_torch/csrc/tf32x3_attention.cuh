// fp32 attention at D = 512 on the tensor cores with split-precision products:
// the forward of K3 (and of K1 at one 512-dim head) and the three backward
// kernels of K13 (and of K5 at one 512-dim head). The __global__ wrappers live
// in flash_attention.cu (the forward) and flash_attention_bhld_bwd.cu (the
// backward); this header holds the kernel body they share.
//
// Replaces (TPU): vidseg_diffusion_tpu/ops/attention.py:_flash_kernel (via
// _flash_attention_impl) and _flash_kernel_packed at heads = 1 in fp32; and the
// backward kernels _flash_packed_bwd_dq_kernel / _flash_packed_bwd_dkv_kernel
// (the pallas_calls at :993 and :1025, through _fa_bwd at heads = 1) in fp32.
//
// Arithmetic. Every product runs on wgmma in TF32 (10 explicit mantissa bits)
// as three products of split operands: x = hi + lo with hi = x cut to TF32
// (its low 13 bits dropped: what the tensor cores read of an fp32 value, so hi
// is x itself wherever x is stored) and lo = x - hi (exact in fp32) rounded to
// TF32 (nearest, ties away from zero, as cvt.rna.tf32.f32 rounds), and a b ~
// hi_a lo_b + lo_a hi_b + hi_a hi_b, accumulated in fp32 (small terms first).
// The dropped lo lo term and lo's rounding sit near 2^-21 of each product:
// fp32-class, where one TF32 pass is off by about 2^-10 (emulated in
// tests/test_torch_fp32_split.py).
// The tensor cores' fp32 sums round toward zero: a chain over all 512
// columns, or over every key, read 4e-6 to 4e-5 relative RMS against fp64 on
// the card, so each 32-column load (phase A) and each 64-row load (phase B)
// sums on the tensor cores from zero and is added in fp32 registers.
//
// What bounds it on the H100: the products, 4 L^2 D flops (forward) or 16 L^2
// D executed (backward: 10 needed) per (batch, head) on O(L D) bytes; in
// fp32-class products the card runs 495 / 3 = 165 TFLOP/s of tensor-core
// TF32. The design is set by the width: a 64-row tile of a 512-dim fp32
// operand is 128 KB, so no operand stays resident beside the 64 x 512 fp32
// output (128 registers a thread in each of two warpgroups).
//
// Design, one body for four roles. A block owns 64 "own" rows (queries for the
// forward and dq, keys for dk and dv) and walks the "other" rows in tiles of
// BT (keys, or queries). Per tile:
// - phase A contracts over the 512 columns in sixteen 32-column loads:
//   X = own . other^T, the own operand from registers (A of wgmma: the
//   register fragment comes from shared memory by ldmatrix, scaled, split),
//   the other operand from shared memory (B: its lo part written beside it by
//   the warpgroup that reads it, a scaled q in place). One contraction
//   (forward: S; dv: S^T) splits the BT columns over the two warpgroups, or,
//   where the other side is one 64-row tile (SPLIT), the head dim (eight loads);
//   two (dq: S and dP, dk: S^T and dP^T) give one to each warpgroup;
// - E, the [64 own][BT other] operand of the second product, is formed in
//   registers (forward: the online softmax in base 2, the row maxima swapped
//   between the warpgroups; dv: p^T; dq / dk: ds = p (dp - delta), p handed
//   from warpgroup 0 to 1; SPLIT: warpgroup 0's half of X handed to 1) and
//   written split into shared memory;
// - phase B: Out^T (+)= C^T E^T for each warpgroup's 256 output columns, C
//   (forward V, dq K, dk qf, dv g) read in 64-row x 64-column loads as
//   register fragments (it is MN-major: TF32 wgmma takes no transposed
//   operand from shared memory), E^T as the K-major B operand. The
//   contraction index of each 8-step is permuted (slot s <-> row 2 s, and
//   2 (s - 4) + 1 for s >= 4) so that E is written from the accumulator
//   layout and C's fragments load without bank conflicts.
// All tiles reach shared memory by TMA (rank-4 tiled maps over the (batch,
// row, head) strides, 128-byte swizzle, zeros past a length) through a ring of
// STAGES stages (`full` / `empty` mbarriers) that thread 0 refills once both
// warpgroups have released a stage. The own operand is re-read from L2 for
// every tile (BT = 128 keys for one contraction halves that traffic).
//
// What bounds it, read on the card (PERF.md §6): the products at 165
// TFLOP/s would take 2.95 ms of the forward's 7.5 at [7, 5824, 512], and with
// the products removed the kernel still took 3.98 ms: the two warpgroups' other
// work (the splits, the fragment loads, the softmax, the barriers) and their
// products barely overlap. Tried and dropped: clusters of two sharing the
// other / C tiles by TMA multicast (half the L2 traffic, the same time); a
// producer that issued loads without waiting for the slower warpgroup (15-25 %
// slower: the warpgroups drift apart and the issue waits for a release).
#pragma once

#include "wgmma_tile.cuh"

namespace vs {

namespace x3 {

enum Role { kFwd = 0, kDq = 1, kDk = 2, kDv = 3 };

// SPLIT (forward and dv, where the other side is one 64-row tile): each
// warpgroup contracts one half of the head dim over all the tile's columns, 8
// loads instead of 16, and the halves meet in shared memory (the two
// contractions' hand-over): a short walk takes half the steps
template <int ROLE, bool SPLIT = false>
struct Cfg {
  static_assert(!SPLIT || ROLE == kFwd || ROLE == kDv, "split head dim: forward and dv");
  static constexpr int NC = (ROLE == kDq || ROLE == kDk || SPLIT) ? 2 : 1;  // contractions in phase A
  static constexpr int BT = NC == 2 ? 64 : 128;                      // other rows a tile
  static constexpr int THREADS = 256;
  static constexpr int PANEL = 64 * 128;                  // 64 rows x 32 fp32, 128-byte swizzle
  static constexpr int A_LOADS = SPLIT ? 8 : 16, B_LOADS = 4 * (BT / 64), LOADS = A_LOADS + B_LOADS;
  // phase A stage: NC = 1: own, other (BT rows), other's lo; NC = 2: own1, own2,
  // other1, its lo, other2, its lo. Phase B stage: four C panels (2 a warpgroup).
  static constexpr int STAGE = NC == 2 ? 6 * PANEL : PANEL + 2 * BT * 128;
  static constexpr int A_TX = NC == 2 ? 4 * PANEL : PANEL + BT * 128, B_TX = 4 * PANEL;   // bytes a load brings
  static constexpr int STAGES = NC == 2 ? 3 : 4;
  static constexpr int E_PLANE = 64 * BT * 4;             // E hi, then E lo: BT / 32 panels each
  static constexpr int EP = STAGES * STAGE;
  static constexpr int XP = EP + 2 * E_PLANE;             // NC = 2: the p hand-over, 64 x 64 fp32
  static constexpr int ROWS = XP + (NC == 2 ? 64 * 64 * 4 : 0);  // 320 floats of row vectors
  static constexpr int BAR = ROWS + 320 * 4;
  static constexpr int SMEM = BAR + 16 * STAGES + 1024;
  static_assert(SMEM <= 232448, "shared memory");
};

struct Args {
  int H, Lown, Loth, lq_pad;
  float qscale;    // scale * log2(e), where q enters: qf = q * qscale in fp32
  float out_mul;   // dq: scale; dk: 1 / log2(e); dv: 1 (the forward divides by l)
  float* out;
  long long osb, osl, osh;  // the output's (batch, row, head) element strides
  float* lse;               // forward: written [B, Lq, H] (or null); backward: read
  const float* delta;       // dq, dk: rowsum(g o) as [B * H][lq_pad]
};

// x = hi + lo as register operands (hi is x: the tensor cores cut it)
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x);
  lo = tf32_lo(x);
}

// byte offset of fp32 column c (0-31) of row r in a panel of 128-byte rows under the 128-byte swizzle
__device__ __forceinline__ uint32_t sw(int r, int c) {
  return static_cast<uint32_t>(r * 128 + (((c >> 2) ^ (r & 7)) << 4) + ((c & 3) << 2));
}

// four 8 x 4 fp32 matrices (8 x 8 b16 to ldmatrix): lane L gives the row address
// of matrix L / 8, and gets element (row L / 4, column L % 4) of each
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ float lds(uint32_t addr) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(addr) : "memory");
  return v;
}
__device__ __forceinline__ void sts(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}
__device__ __forceinline__ void stsf(uint32_t addr, float v) { sts(addr, __float_as_uint(v)); }

// D (64 x 64 fp32) (+)= A (64 x 8 TF32, the m16n8k8 A fragment of each warp's
// 16 rows in registers) * B (8 x 64, K-major TF32 in shared memory)
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d)
      : "memory");
}

// d (+)= a b over one 8-step from the split parts: hi lo, lo hi, hi hi
__device__ __forceinline__ void wgmma_x3(float (&d)[32], const uint32_t (&ah)[4], const uint32_t (&al)[4],
                                         uint32_t bhi, uint32_t blo, int scale_d) {
  wgmma_tf32_rs(d, ah, wgmma_desc(blo, 16, 1024), scale_d);
  wgmma_tf32_rs(d, al, wgmma_desc(bhi, 16, 1024), 1);
  wgmma_tf32_rs(d, ah, wgmma_desc(bhi, 16, 1024), 1);
}

// d = the sum over NK 8-steps of a b from the split parts, on the tensor cores
// from zero: the A fragments of step kk come from load(kk, hi, lo) while step
// kk - 1 multiplies (two register buffers), B's hi part at bhi(kk) and its lo
// part lo_delta beyond; tail() runs while the last step multiplies
template <int NK, class Load, class BHi, class Tail>
__device__ __forceinline__ void chain_x3(float (&d)[32], const Load& load, const BHi& bhi, uint32_t lo_delta,
                                         const Tail& tail) {
  uint32_t f[2][2][4];
#pragma unroll
  for (int kk = 0; kk < NK; ++kk) {
    load(kk, f[kk & 1][0], f[kk & 1][1]);
    wgmma_fence();
    const uint32_t b = bhi(kk);
    wgmma_x3(d, f[kk & 1][0], f[kk & 1][1], b, b + lo_delta, kk != 0);
    wgmma_commit();
    if (kk + 1 < NK) wgmma_wait<1>();   // step kk - 1 is done: its buffer is free
  }
  tail();
  wgmma_wait<0>();
  wgmma_fence_regs(d);
}

// 64 rows x 32 fp32 of a landed panel: times `mul` in place (when `scaled`: the
// hi part is the value itself), lo at the same offsets of `lo`; the `t`-th of 128
// threads
__device__ __forceinline__ void split_panel(uint32_t hi, uint32_t lo, int t, bool scaled, float mul) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int c = t + 128 * k;
    float4 v;
    asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
                 : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
                 : "r"(hi + 16 * c)
                 : "memory");
    if (scaled) {
      v.x *= mul, v.y *= mul, v.z *= mul, v.w *= mul;
      asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(hi + 16 * c), "f"(v.x), "f"(v.y), "f"(v.z),
                   "f"(v.w)
                   : "memory");
    }
    const uint32_t l[4] = {tf32_lo(v.x), tf32_lo(v.y), tf32_lo(v.z), tf32_lo(v.w)};
    asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(lo + 16 * c), "r"(l[0]), "r"(l[1]), "r"(l[2]),
                 "r"(l[3])
                 : "memory");
  }
}

// E from the accumulator layout (x[e]: own row 16 warp + gid + 8 ((e >> 1) & 1),
// other column col0 + 8 (e >> 2) + 2 tig + (e & 1)) into the split planes, at
// k-position 8 (column / 8) + tig + 4 (e & 1) of the permuted 8-steps
__device__ __forceinline__ void write_e(uint32_t ehi, uint32_t elo, const float (&x)[32], int col0, int warp,
                                       int gid, int tig) {
#pragma unroll
  for (int e = 0; e < 32; ++e) {
    const int r = 16 * warp + gid + 8 * ((e >> 1) & 1);
    const int pos = col0 + 8 * (e >> 2) + tig + 4 * (e & 1);
    const uint32_t off = (pos >> 5) * (64 * 128) + sw(r, pos & 31);
    uint32_t hi, lo;
    split(x[e], hi, lo);
    sts(ehi + off, hi);
    sts(elo + off, lo);
  }
}

template <int ROLE, bool SPLIT = false>
__device__ __forceinline__ void attention_body(const CUtensorMap* own1, const CUtensorMap* own2,
                                               const CUtensorMap* oth1, const CUtensorMap* oth2,
                                               const CUtensorMap* cmap, const Args& a) {
  using C = Cfg<ROLE, SPLIT>;
  constexpr int NC = C::NC, BT = C::BT, PANEL = C::PANEL, STAGES = C::STAGES, LOADS = C::LOADS;
  constexpr float NEG_INF = -INFINITY;
  extern __shared__ unsigned char x3_smem[];
  const uint32_t base = smem_u32(smem_align_1024(x3_smem));
  const uint32_t ring = base, ehi = base + C::EP, elo = ehi + C::E_PLANE, sxp = base + C::XP;
  const uint32_t srow = base + C::ROWS, full_bar = base + C::BAR, empty_bar = full_bar + 8 * STAGES;
  const int tid = threadIdx.x, wg = tid >> 7, t = tid & 127, warp = t >> 5, lane = t & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int own0 = blockIdx.x * 64;
  const int ntiles = (a.Loth + BT - 1) / BT, nloads = LOADS * ntiles;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full_bar + 8 * s, 1);
      mbar_init(empty_bar + 8 * s, 2);
    }
    mbar_init_fence();
  }
  __syncthreads();

  // load i: per tile, A_LOADS phase-A loads (32 columns each), then B_LOADS
  // phase-B loads (C: 64 other rows x the 64 columns of slice m, both warpgroups)
  auto issue = [&](int i) {
    const int stage = i % STAGES, j = i / LOADS, n = i % LOADS;
    const uint32_t st = ring + stage * C::STAGE, bar = full_bar + 8 * stage;
    if (n < C::A_LOADS) {
      const int d2 = SPLIT ? 256 + 32 * n : 32 * n;   // the second contraction's columns
      mbar_expect_tx(bar, C::A_TX);
      tma_load_4d(st, own1, bar, 32 * n, own0, h, b);
      if (NC == 2) {
        tma_load_4d(st + PANEL, own2, bar, d2, own0, h, b);
        tma_load_4d(st + 2 * PANEL, oth1, bar, 32 * n, BT * j, h, b);
        tma_load_4d(st + 4 * PANEL, oth2, bar, d2, BT * j, h, b);
      } else {
        tma_load_4d(st + PANEL, oth1, bar, 32 * n, BT * j, h, b);
      }
    } else {
      const int m = (n - C::A_LOADS) / (BT / 64), hb = (n - C::A_LOADS) % (BT / 64);
      mbar_expect_tx(bar, C::B_TX);
#pragma unroll
      for (int w = 0; w < 2; ++w)
#pragma unroll
        for (int p = 0; p < 2; ++p)
          tma_load_4d(st + (2 * w + p) * PANEL, cmap, bar, 256 * w + 64 * m + 32 * p, BT * j + 64 * hb, h, b);
    }
  };
  auto wait_full = [&](int i) { mbar_wait(full_bar + 8 * (i % STAGES), (i / STAGES) & 1); };
  // this warpgroup is done with load i; thread 0 refills its stage with load
  // i + STAGES once the other warpgroup is too
  auto release = [&](int i) {
    const int stage = i % STAGES;
    if (t == 0) mbar_arrive(empty_bar + 8 * stage);
    if (tid == 0 && i + STAGES < nloads) {
      mbar_wait(empty_bar + 8 * stage, (i / STAGES) & 1);
      issue(i + STAGES);
    }
  };
  if (tid == 0)
    for (int i = 0; i < STAGES && i < nloads; ++i) issue(i);

  // this warpgroup's phase-A operands within a stage; who scales by qscale
  const uint32_t own_off = NC == 2 ? wg * PANEL : 0;
  const uint32_t oth_off = NC == 2 ? (2 + 2 * wg) * PANEL : PANEL + wg * PANEL;
  const uint32_t lo_off = NC == 2 ? PANEL : BT * 128;
  const bool scale_own = ROLE == kFwd || (ROLE == kDq && wg == 0);
  const bool scale_oth = ROLE == kDv || (ROLE == kDk && wg == 0);
  const int col0 = NC == 2 ? 0 : 64 * wg;  // this warpgroup's first other column of X

  float lse_r[2] = {0.f, 0.f}, del_r[2] = {0.f, 0.f};  // dq: the own rows' LSE and delta
  if (ROLE == kDq) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = own0 + 16 * warp + gid + 8 * i;
      if (row < a.Lown) {
        lse_r[i] = a.lse[((long long)b * a.Lown + row) * a.H + h];
        del_r[i] = a.delta[(long long)bh * a.lq_pad + row];
      }
    }
  }
  float m_run[2] = {NEG_INF, NEG_INF}, l_part[2] = {0.f, 0.f};  // forward: rows 16 warp + gid (+ 8)

  float acc[4][32];  // Out^T: slice m, element e at column 256 wg + 64 m + 16 warp + gid + 8 ((e >> 1) & 1),
                     // own row 8 (e >> 2) + 2 tig + (e & 1)
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[m][e] = 0.f;

  for (int j = 0; j < ntiles; ++j) {
    if (ROLE == kDk || ROLE == kDv) {  // the tile's query rows: LSE (+inf past Lq: p = 0) and delta
      if (tid < BT) {
        const int q = BT * j + tid;
        stsf(srow + 4 * tid, q < a.Loth ? a.lse[((long long)b * a.Loth + q) * a.H + h] : INFINITY);
        if (ROLE == kDk) stsf(srow + 4 * (128 + tid), q < a.Loth ? a.delta[(long long)bh * a.lq_pad + q] : 0.f);
      }
    }

    // phase A: x = own . other^T over the 512 columns, each load's 32 columns
    // summed on the tensor cores into xp and added to x in fp32
    // (the other rows of the next load are split while this one multiplies)
    auto split_load = [&](int i) {
      const uint32_t st = ring + (i % STAGES) * C::STAGE + oth_off;
      wait_full(i);
      split_panel(st, st + lo_off, t, scale_oth, a.qscale);
      fence_proxy_async();
    };
    float x[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) x[e] = 0.f;
    split_load(LOADS * j);
#pragma unroll 1
    for (int c = 0; c < C::A_LOADS; ++c) {
      const int i = LOADS * j + c;
      const uint32_t st = ring + (i % STAGES) * C::STAGE;
      bar_sync(1 + wg, 128);  // the warpgroup's split other rows are in place
      // lane L addresses row 16 warp + L % 16 of the own panel at the 16-byte chunk of
      // columns 8 kk + 4 (L / 16) ..: ldmatrix's four matrices are the A fragment
      const int lr = 16 * warp + (lane & 15);
      const uint32_t so = st + own_off + lr * 128;
      float xp[32];
      chain_x3<4>(
          xp,
          [&](int kk, uint32_t(&hi)[4], uint32_t(&lo)[4]) {
            uint32_t r[4];
            ldsm_x4(r, so + (((2 * kk + (lane >> 4)) ^ (lr & 7)) << 4));
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              const float v = __uint_as_float(r[u]);
              split(scale_own ? v * a.qscale : v, hi[u], lo[u]);
            }
          },
          [&](int kk) { return st + oth_off + 32 * kk; }, lo_off,
          [&] {
            if (c + 1 < C::A_LOADS) split_load(i + 1);
          });
      release(i);
#pragma unroll
      for (int e = 0; e < 32; ++e) x[e] += xp[e];
    }

    // E, then the hand-over barriers: 3 after phase A (and after every phase B
    // of the tile before), 4 once E is written. x[e]: own row 16 warp + gid + 8
    // ((e >> 1) & 1), other column col0 + 8 (e >> 2) + 2 tig + (e & 1) of the tile
    const auto colof = [&](int e) { return col0 + 8 * (e >> 2) + 2 * tig + (e & 1); };
    if (NC == 2) {   // warpgroup 0 hands its x (or p) to warpgroup 1, which forms E on all 64 columns
      if (wg == 0) {
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          float v = x[e];
          if (ROLE == kDq) v = 64 * j + colof(e) < a.Loth ? exp2f(x[e] - lse_r[(e >> 1) & 1]) : 0.f;
          if (ROLE == kDk) v = exp2f(x[e] - lds(srow + 4 * colof(e)));
          stsf(sxp + 4 * (128 * e + t), v);
        }
      }
      bar_sync(3, 256);
      if (wg == 1) {
        float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          const float w = lds(sxp + 4 * (128 * e + t));
          if (ROLE == kDq || ROLE == kDk) {   // ds = p (dp - delta)
            const float delta = ROLE == kDq ? del_r[(e >> 1) & 1] : lds(srow + 4 * (128 + colof(e)));
            x[e] = w * (x[e] - delta);
          } else if (ROLE == kDv) {           // p^T from the two halves of S^T
            x[e] = exp2f(x[e] + w - lds(srow + 4 * colof(e)));
          } else {                            // the forward: S from its two halves
            x[e] += w;
            if (BT * j + colof(e) >= a.Loth) x[e] = NEG_INF;
            mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], x[e]);
          }
        }
        if (ROLE == kFwd) {   // the online softmax on all the tile's columns
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
            mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
            const float m_new = fmaxf(m_run[i], mx[i]);   // finite: key BT j is live
            const float alpha = exp2f(m_run[i] - m_new);  // 0 on the first tile
            m_run[i] = m_new;
            l_part[i] *= alpha;
            if (tig == 0) stsf(srow + 4 * (128 + 16 * warp + gid + 8 * i), alpha);
          }
#pragma unroll
          for (int e = 0; e < 32; ++e) {
            x[e] = exp2f(x[e] - m_run[(e >> 1) & 1]);
            l_part[(e >> 1) & 1] += x[e];
          }
        }
        write_e(ehi, elo, x, 0, warp, gid, tig);
        fence_proxy_async();
      }
      bar_sync(4, 256);
    } else if (ROLE == kFwd) {   // each warpgroup its 64 columns; the row maxima swapped
      float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        if (BT * j + colof(e) >= a.Loth) x[e] = NEG_INF;
        mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], x[e]);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        if (tig == 0) stsf(srow + 4 * (64 * wg + 16 * warp + gid + 8 * i), mx[i]);
      }
      bar_sync(3, 256);
      float alpha[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float other = lds(srow + 4 * (64 * (1 - wg) + 16 * warp + gid + 8 * i));
        const float m_new = fmaxf(m_run[i], fmaxf(mx[i], other));  // finite: key BT j is live
        alpha[i] = exp2f(m_run[i] - m_new);                        // 0 on the first tile
        m_run[i] = m_new;
        l_part[i] *= alpha[i];
      }
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        x[e] = exp2f(x[e] - m_run[(e >> 1) & 1]);
        l_part[(e >> 1) & 1] += x[e];
      }
      write_e(ehi, elo, x, col0, warp, gid, tig);
      if (wg == 0 && tig == 0)
#pragma unroll
        for (int i = 0; i < 2; ++i) stsf(srow + 4 * (128 + 16 * warp + gid + 8 * i), alpha[i]);
      fence_proxy_async();
      bar_sync(4, 256);
    } else {   // dv: each warpgroup p^T on its 64 columns
      bar_sync(3, 256);
#pragma unroll
      for (int e = 0; e < 32; ++e) x[e] = exp2f(x[e] - lds(srow + 4 * colof(e)));
      write_e(ehi, elo, x, col0, warp, gid, tig);
      fence_proxy_async();
      bar_sync(4, 256);
    }
    if (ROLE == kFwd) {
#pragma unroll
      for (int n = 0; n < 8; ++n) {  // Out^T *= alpha of its own rows
        float a0, a1;
        asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n"
                     : "=f"(a0), "=f"(a1)
                     : "r"(srow + 4 * (128 + 8 * n + 2 * tig))
                     : "memory");
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          acc[m][4 * n] *= a0;
          acc[m][4 * n + 1] *= a1;
          acc[m][4 * n + 2] *= a0;
          acc[m][4 * n + 3] *= a1;
        }
      }
    }

    // phase B: Out^T slice m += C^T E^T, 64 other rows a load
#pragma unroll
    for (int s = 0; s < C::B_LOADS; ++s) {
      const int m = s / (BT / 64), hb = s % (BT / 64);
      const int i = LOADS * j + C::A_LOADS + s, stage = i % STAGES;
      wait_full(i);
      const uint32_t cp = ring + stage * C::STAGE + (2 * wg + (warp >> 1)) * PANEL;
      const int dd = 16 * (warp & 1) + gid;  // this thread's first column in the warp's panel
      float tp[32];  // the load's 64 rows summed on the tensor cores, added to acc[m] in fp32
      chain_x3<8>(
          tp,
          [&](int kk, uint32_t(&hi)[4], uint32_t(&lo)[4]) {
            const int kappa = 8 * kk + 2 * tig;  // slots tig and tig + 4: rows kappa, kappa + 1
            const float v[4] = {lds(cp + sw(kappa, dd)), lds(cp + sw(kappa, dd + 8)), lds(cp + sw(kappa + 1, dd)),
                                lds(cp + sw(kappa + 1, dd + 8))};
#pragma unroll
            for (int u = 0; u < 4; ++u) split(ROLE == kDk ? v[u] * a.qscale : v[u], hi[u], lo[u]);
          },
          [&](int kk) {
            const int ke = 8 * hb + kk;  // the 8-step of E
            return ehi + (ke >> 2) * PANEL + (ke & 3) * 32;
          },
          C::E_PLANE, [] {});
      release(i);
#pragma unroll
      for (int e = 0; e < 32; ++e) acc[m][e] += tp[e];
    }
  }

  float* ob = a.out + b * a.osb + h * a.osh;
  if (ROLE == kFwd) {  // l = l0 + l1 over the two warpgroups' columns (SPLIT: l1); the LSE
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l_part[i] += __shfl_xor_sync(0xffffffffu, l_part[i], 1);
      l_part[i] += __shfl_xor_sync(0xffffffffu, l_part[i], 2);
      if (tig == 0) stsf(srow + 4 * (192 + 64 * wg + 16 * warp + gid + 8 * i), l_part[i]);
    }
    bar_sync(3, 256);
    if (a.lse != nullptr && wg == (SPLIT ? 1 : 0) && tig == 0)   // the warpgroup that ran the softmax
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = 16 * warp + gid + 8 * i;
        const float l = lds(srow + 4 * (192 + r)) + lds(srow + 4 * (256 + r));
        if (own0 + r < a.Lown) a.lse[((long long)b * a.Lown + own0 + r) * a.H + h] = m_run[i] + log2f(l);
      }
  }
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int r = 8 * n + 2 * tig + u, row = own0 + r;
      if (row >= a.Lown) continue;
      float* orow = ob + (long long)row * a.osl + 256 * wg + 16 * warp + gid;
      if (ROLE == kFwd) {
        const float l = lds(srow + 4 * (192 + r)) + lds(srow + 4 * (256 + r));
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          orow[64 * m] = acc[m][4 * n + u] / l;
          orow[64 * m + 8] = acc[m][4 * n + 2 + u] / l;
        }
      } else {
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          orow[64 * m] = acc[m][4 * n + u] * a.out_mul;
          orow[64 * m + 8] = acc[m][4 * n + 2 + u] * a.out_mul;
        }
      }
    }
}

// fp32 [B, H, L, 512] through its (batch, row, head) element strides: boxes of 32
// columns x `rows` rows under the 128-byte swizzle
inline int tiled_map(const void* base, const long long* s, int L, int H, int B, int rows, CUtensorMap* map) {
  const cuuint64_t dims[4] = {512, (cuuint64_t)L, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)s[1] * 4, (cuuint64_t)s[2] * 4, (cuuint64_t)s[0] * 4};
  const cuuint32_t box[4] = {32, (cuuint32_t)rows, 1, 1};
  return tma_tiled_map(CU_TENSOR_MAP_DATA_TYPE_FLOAT32, CU_TENSOR_MAP_SWIZZLE_128B, base, 4, dims, strides, box, map);
}

// Launches a kernel of this header: a block per 64 own rows by B * H
template <int ROLE, bool SPLIT, class... Params, class... Actual>
int launch(void (*kernel)(Params...), int Lown, int BH, cudaStream_t stream, const Actual&... params) {
  static const cudaError_t attr = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                       Cfg<ROLE, SPLIT>::SMEM);
  if (attr != cudaSuccess) return (int)attr;
  kernel<<<dim3((Lown + 63) / 64, BH), Cfg<ROLE, SPLIT>::THREADS, Cfg<ROLE, SPLIT>::SMEM, stream>>>(params...);
  return (int)cudaGetLastError();
}

// TMA reads the inputs in place: bases 16-byte aligned, strides whole 16-byte rows
inline bool rows_ok(const void* const* bases, int n, const long long* strides, int nstrides) {
  for (int i = 0; i < n; ++i)
    if (reinterpret_cast<uintptr_t>(bases[i]) % 16) return false;
  for (int i = 0; i < nstrides; ++i)
    if (strides[i] % 4) return false;
  return true;
}

}  // namespace x3
}  // namespace vs
