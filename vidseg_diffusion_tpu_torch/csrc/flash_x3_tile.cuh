// The split-TF32 attention tile at D = 64 on mma.sync m16n8k8, shared by K1's
// fp32 forward (flash_attention_x3.cu) and K5's fp32 backward
// (flash_attention_bwd_x3.cu): a block's own rows (K5: eight warps of 16 rows;
// K1: four warps of 32) are held in shared memory as resident hi and lo planes
// (two 32-column panels of 128-byte rows under the 128-byte swizzle, read as A
// fragments by ldmatrix); the walked side arrives in 32-row tiles through a TMA
// ring (K5 four stages, K1 two: RingT) and is split in registers by each warp as
// it reads it. Every product is three TF32
// products of split operands, x = hi + lo with hi x as stored (the tensor cores
// read its top 19 bits) and lo = x - hi rounded to TF32 (wgmma_tile.cuh's
// tf32_lo), small terms first; the tensor cores' fp32 sums round toward zero
// (PERF.md section 6), so each chain is one 32-column panel (own x walked^T) or
// one walked tile (C fragments x walked rows) long, starts from zero and is
// added in fp32 registers.
#pragma once

#include "common.cuh"
#include "temporal_tile.cuh"
#include "tf32x3_attention.cuh"

namespace vs {
namespace fx3 {

constexpr int WARPS = 8, THREADS = 32 * WARPS, OWN = 16 * WARPS;  // own rows a block
constexpr int BT = 32, STAGES = 4;                                 // walked rows a tile, ring stages
constexpr int OWN_PANEL = OWN * 128;                               // 128 rows x 32 fp32
constexpr int WALK_PANEL = BT * 128;                               // 32 rows x 32 fp32
constexpr int STAGE = 4 * WALK_PANEL;                              // 2 tensors x 2 panels: 16 KB

// ldmatrix address of the A fragment of k-step kk (8 columns) of a warp's 16 rows
// (row0..) in a panel of 128-byte rows: lane L reads row row0 + L % 16 at the
// 16-byte chunk 2 kk + L / 16 (x3::ldsm_x4 then gives a0..a3)
__device__ __forceinline__ uint32_t a_addr(uint32_t panel, int row0, int kk, int lane) {
  const int r = row0 + (lane & 15), c = 2 * kk + (lane >> 4);
  return panel + r * 128 + ((c ^ (r & 7)) << 4);
}
// the B fragments (b0, b1) of two 8-row n-tiles (rows row0.. and row0 + 8..) at
// k-step kk, the rows read as columns (the walked rows of S = own walked^T)
__device__ __forceinline__ uint32_t bt_addr(uint32_t panel, int row0, int kk, int lane) {
  const int r = row0 + (lane & 7) + 8 * (lane >> 4), c = 2 * kk + ((lane >> 3) & 1);
  return panel + r * 128 + ((c ^ (r & 7)) << 4);
}

// 2^x on the MUFU (ex2.approx.ftz: 2 ulp, results below 2^-126 flushed to zero): p and ds for both walks
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// c[n] += a b[n] over N n-tiles from the split parts, small terms first: the
// products are issued term by term across the n-tiles (an mma waits on the one
// before it on the same accumulator; N independent ones lie between). b[n] =
// {hi b0, hi b1, lo b0, lo b1}. QF_FIRST: a is the query side (qf or g) and b the
// key side (k or v); otherwise a is the key side, and the cross terms are issued
// in the order QF_FIRST gives them (qf_hi k_lo, then qf_lo k_hi), so both kernels
// form the same S and dP.
template <bool QF_FIRST, int N>
__device__ __forceinline__ void mma_x3(float (&c)[N][4], const uint32_t (&ah)[4], const uint32_t (&al)[4],
                                       const uint32_t (&b)[N][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n) {
    if (QF_FIRST) tt_mma_tf32(c[n], ah, b[n][2], b[n][3]);
    else tt_mma_tf32(c[n], al, b[n][0], b[n][1]);
  }
#pragma unroll
  for (int n = 0; n < N; ++n) {
    if (QF_FIRST) tt_mma_tf32(c[n], al, b[n][0], b[n][1]);
    else tt_mma_tf32(c[n], ah, b[n][2], b[n][3]);
  }
#pragma unroll
  for (int n = 0; n < N; ++n) tt_mma_tf32(c[n], ah, b[n][0], b[n][1]);
}

// x[4 n-tiles] = a b^T over the 64 columns: a the warp's 16 own rows of an own
// tensor (hi plane `ahi`, its lo plane LO bytes beyond; two panels OWN_PANEL
// apart), b the tile's 32 walked rows (panels WALK_PANEL apart from `bhi`),
// times `bmul` (qscale for a walked q, else 1) and split here; one chain a
// 32-column panel, from zero, the second added in fp32
template <bool QF_FIRST, int LO>
__device__ __forceinline__ void own_walked(float (&x)[4][4], uint32_t ahi, uint32_t bhi, float bmul, int row0,
                                           int lane) {
  float part[4][4];
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int u = 0; u < 4; ++u) x[n][u] = part[n][u] = 0.f;
  // k-step ks (8 columns; panel ks / 4) software-pipelined: its fragments were loaded during step ks - 1, and
  // the next step's loads and splits are issued between this step's three rounds of products
  uint32_t ah[2][4], al[2][4], bh[2][4], b[2][4][4];
  auto fetch = [&](int ks, int buf) {
    const uint32_t pa = ahi + (ks >> 2) * OWN_PANEL, pb = bhi + (ks >> 2) * WALK_PANEL;
    x3::ldsm_x4(ah[buf], a_addr(pa, row0, ks & 3, lane));
    x3::ldsm_x4(al[buf], a_addr(pa + LO, row0, ks & 3, lane));
#pragma unroll
    for (int np = 0; np < 2; ++np) x3::ldsm_x4(bh[np], bt_addr(pb, 16 * np, ks & 3, lane));
  };
  auto prep = [&](int buf, int np) {   // n-tiles 2 np, 2 np + 1 (rows 16 np.. of the tile): times bmul, split
#pragma unroll
    for (int o = 0; o < 2; ++o)
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const float v = __uint_as_float(bh[np][2 * o + u]) * bmul;
        b[buf][2 * np + o][u] = __float_as_uint(v);
        b[buf][2 * np + o][2 + u] = tf32_lo(v);
      }
  };
  fetch(0, 0);
  prep(0, 0);
  prep(0, 1);
#pragma unroll
  for (int ks = 0; ks < 8; ++ks) {
    const int cur = ks & 1, nxt = cur ^ 1;
    float(&acc)[4][4] = ks < 4 ? x : part;
    if (ks + 1 < 8) fetch(ks + 1, nxt);
#pragma unroll
    for (int n = 0; n < 4; ++n) {   // the cross terms in QF order, then hi hi (mma_x3's order)
      if (QF_FIRST) tt_mma_tf32(acc[n], ah[cur], b[cur][n][2], b[cur][n][3]);
      else tt_mma_tf32(acc[n], al[cur], b[cur][n][0], b[cur][n][1]);
    }
    if (ks + 1 < 8) prep(nxt, 0);
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      if (QF_FIRST) tt_mma_tf32(acc[n], al[cur], b[cur][n][0], b[cur][n][1]);
      else tt_mma_tf32(acc[n], ah[cur], b[cur][n][2], b[cur][n][3]);
    }
    if (ks + 1 < 8) prep(nxt, 1);
#pragma unroll
    for (int n = 0; n < 4; ++n) tt_mma_tf32(acc[n], ah[cur], b[cur][n][0], b[cur][n][1]);
  }
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int u = 0; u < 4; ++u) x[n][u] += part[n][u];
}

// out[8 n-tiles of the 64 columns] += e c: e [16 own rows][32 walked] as C
// fragments (k-step slot tig <-> walked row 2 tig, slot tig + 4 <-> 2 tig + 1,
// so a C fragment is an A fragment), c the tile's walked rows (panels
// WALK_PANEL apart from `chi`) times `cmul` as the contraction, read as scalars
// and split here; one chain over the tile, from zero, added in fp32
__device__ __forceinline__ void walked_product(float (&out)[8][4], const float (&e)[4][4], uint32_t chi, float cmul,
                                               int gid, int tig) {
  float part[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int u = 0; u < 4; ++u) part[n][u] = 0.f;
  // k-step kk's B values (rows r, r + 1 of each n-tile's column) are loaded while step kk - 1 multiplies
  float c[8][2];
  auto fetch = [&](int kk) {
    const int r = 8 * kk + 2 * tig;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const uint32_t at = chi + (n >> 2) * WALK_PANEL;
      const int col = 8 * (n & 3) + gid;
      c[n][0] = x3::lds(at + x3::sw(r, col));
      c[n][1] = x3::lds(at + x3::sw(r + 1, col));
    }
  };
  fetch(0);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint32_t ah[4] = {__float_as_uint(e[kk][0]), __float_as_uint(e[kk][2]), __float_as_uint(e[kk][1]),
                            __float_as_uint(e[kk][3])};
    uint32_t al[4], b[8][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) al[i] = tf32_lo(__uint_as_float(ah[i]));
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const float v = c[n][u] * cmul;
        b[n][u] = __float_as_uint(v);
        b[n][2 + u] = tf32_lo(v);
      }
    if (kk + 1 < 4) fetch(kk + 1);
    mma_x3<true>(part, ah, al, b);
  }
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int u = 0; u < 4; ++u) out[n][u] += part[n][u];
}

// `n16` 16-byte chunks from `hi` on: their lo parts at the same offsets from
// `lo`, the first `nscaled` chunks multiplied by `mul` in place first; all threads
// (the own planes, once)
template <int NT = THREADS>
__device__ __forceinline__ void split_chunks(uint32_t hi, uint32_t lo, int n16, int nscaled, float mul) {
#pragma unroll 4
  for (int c = threadIdx.x; c < n16; c += NT) {
    float4 v;
    asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
                 : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
                 : "r"(hi + 16 * c)
                 : "memory");
    if (c < nscaled) {
      v.x *= mul, v.y *= mul, v.z *= mul, v.w *= mul;
      asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(hi + 16 * c), "f"(v.x), "f"(v.y), "f"(v.z),
                   "f"(v.w)
                   : "memory");
    }
    asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(lo + 16 * c), "r"(tf32_lo(v.x)),
                 "r"(tf32_lo(v.y)), "r"(tf32_lo(v.z)), "r"(tf32_lo(v.w))
                 : "memory");
  }
}

// the accumulators of a warp's 16 rows x 64 columns times `mul` to rows row0.. of
// dst (`rows` of them exist): each thread's column pairs as 8-byte stores
__device__ __forceinline__ void store_rows(const float (&acc)[8][4], float mul, float* dst, long long row_stride,
                                           int row0, int rows, int gid, int tig) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row0 + gid + 8 * h;
    if (r >= rows) continue;
    float* d = dst + (long long)r * row_stride + 2 * tig;
#pragma unroll
    for (int n = 0; n < 8; ++n)
      *reinterpret_cast<float2*>(d + 8 * n) = make_float2(acc[n][2 * h] * mul, acc[n][2 * h + 1] * mul);
  }
}

// own boxes a block loads: the 32-row boxes of its rows that hold a row of the tensor
__device__ __forceinline__ int own_boxes(int row0, int L) { return min(OWN / BT, (L - row0 + BT - 1) / BT); }


// A warp is done with walked tile j (its stage): the last of the block's warps to
// say so refills the stage with tile j + NS (the stage's counter of warps
// done counts them; a warp waits for the tile's `full` barrier before it counts,
// so no warp counts a round early); NW warps, NS stages
template <int NW, int NS>
struct RingT {
  uint32_t full, count;   // NS mbarriers, NS u32 counters
  int ntiles, lane;
  __device__ __forceinline__ void wait(int j) const {
    mbar_wait(full + 8 * (j % NS), (j / NS) & 1);
  }
  template <class Load>
  __device__ __forceinline__ void release(int j, const Load& load) const {
    __syncwarp();
    if (lane != 0) return;
    const uint32_t c = count + 4 * (j % NS);
    uint32_t done;
    __threadfence_block();
    asm volatile("atom.shared.add.u32 %0, [%1], 1;\n" : "=r"(done) : "r"(c) : "memory");
    if (done != NW - 1) return;
    asm volatile("st.shared.u32 [%0], 0;\n" ::"r"(c) : "memory");
    __threadfence_block();
    if (j + NS < ntiles) load(j % NS, j + NS);
  }
};
using Ring = RingT<WARPS, STAGES>;


// fp32 [B, L, H, 64] through its (batch, row, head) element strides: boxes of 32
// columns x 32 rows under the 128-byte swizzle (rows past L arrive as zeros)
inline int tile_map(const void* base, const long long* s, int L, int H, int B, CUtensorMap* map) {
  const cuuint64_t dims[4] = {64, (cuuint64_t)L, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)s[1] * 4, (cuuint64_t)s[2] * 4, (cuuint64_t)s[0] * 4};
  const cuuint32_t box[4] = {32, (cuuint32_t)BT, 1, 1};
  return tma_tiled_map(CU_TENSOR_MAP_DATA_TYPE_FLOAT32, CU_TENSOR_MAP_SWIZZLE_128B, base, 4, dims, strides, box, map);
}

}  // namespace fx3
}  // namespace vs
