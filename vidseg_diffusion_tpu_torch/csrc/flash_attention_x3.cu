// K1 (and K3 on its bhld strides) in fp32 at D = 64 (the UNet's spatial heads
// under `--dtype float32`, the fp32 UNet checks and the fp32 training step's
// forward) on the tensor cores with split-TF32 products. flash_attention.cu's
// fp32 entry sends D = 64 calls here (route 7, "tf32x3") when TMA can address
// q, k and v (16-byte aligned bases, strides in whole 16-byte rows; the others
// keep its FMA kernel, route 0, as D = 16 and 80 do).
//
// Replaces (TPU): vidseg_diffusion_tpu/ops/attention.py:_flash_kernel_packed
// (the pallas_call at :527 of _flash_attention_packed_impl), _small_seq_kernel
// (:687, K1's short spatial sites) and _flash_kernel (:297, K3) in fp32 at D = 64.
// In fp32 every rounding of the bf16 kernels is the identity, so one kernel
// serves every sum mode: qf = q * qscale in fp32, a base-2 online softmax over
// the key tiles, O = sum p V / l, and under a gradient the LSE m + log2 l as fp32
// [B, Lq, H], from which flash_attention_bwd_x3.cu recomputes p.
//
// What bounds it on the H100: 4 Lq Lk D flops per (batch, head) on O((Lq + Lk) D)
// bytes, each product three TF32 products at 495 TFLOP/s (165 TFLOP/s
// fp32-class): the tensor cores, plus an exp2 and a few fp32 operations per
// (query, key) pair and the splits of each walked tile.
//
// Design: the tile of flash_x3_tile.cuh (K5's), on mma.sync m16n8k8, not PR 19's
// transposed-output wgmma (tf32x3_attention.cuh phase B). P V contracts over the
// keys and V's tile is stored [key][d], so V is an MN-major B operand, which TF32
// wgmma cannot read from shared memory (K-major only); on wgmma p would have to be
// written split into two fp32 planes of the warpgroup's rows beside the resident
// q planes. Register fragments take any layout: the C fragments of S go straight
// into P V's A operands (k-step slot tig <-> key 2 tig, slot tig + 4 <-> 2 tig + 1)
// and V's rows are read as B fragments in place.
// - A block is four warps and owns 128 query rows, 32 a warp as two 16-row
//   tiles: each K and V value a warp reads and splits feeds both tiles' products
//   (at 16 rows a warp the splits were as many instructions as the products
//   fed; PERF.md section 6). q reaches shared memory by TMA once (32-row boxes),
//   is scaled in place (qf = q qscale) and split into resident hi and lo planes
//   (64 KB); each warp reads its A fragments by ldmatrix.
// - K and V come in 32-key tiles through a two-stage TMA ring (rank-4 tiled
//   maps over the (batch, row, head) strides, 128-byte swizzle, keys past Lk
//   arrive as zeros and are masked to -inf); each warp splits the values it
//   reads in registers, and the last of the four warps done with a stage refills
//   it (flash_x3_tile.cuh's RingT: no block barrier in the walk).
// - S (16 rows x 32 keys a tile) is one chain per 32-column panel of the head
//   dim, the same products in the same order as K5's dq role, so the backward
//   recomputes the forward's S bit for bit. The running max and each thread's
//   partial sums of p live in registers (the max met across the row's quad by
//   shuffles, the sums once at the end); P V is one chain per key tile added to
//   the rescaled O, in two halves of the 64 columns.
// - Occupancy: two blocks an SM (97 KB of shared memory and 231 registers a
//   thread each), eight warps. Eight warps of 32 rows in one block (256 rows,
//   four stages, one block an SM) read 1-2 % faster at the ds1 slice [2, 5824, 5 x
//   64] but 2.5 % slower at the CFG batch and 21-52 % slower where a head has few
//   rows (ds4, mid, the 77-key cross-attention, 256 tokens): fewer blocks, more of
//   their rows past Lq. At ds1 the 460 blocks are 1.74 rounds of the card's 264.
// Ragged query rows compute on zero q and are not stored. Outputs leave each
// thread's column pairs as 8-byte stores.
#include "flash_x3_tile.cuh"

namespace vs {
namespace k1x {

using namespace fx3;

// A block is four warps of 32 query rows (two 16-row tiles) with a two-stage ring, two blocks an SM
constexpr int WARPS_Q = 4, THREADS_Q = 32 * WARPS_Q, ROWS_W = 32, OWN_Q = WARPS_Q * ROWS_W;
constexpr int STAGES_Q = 2, BLOCKS_SM = 2;
constexpr int QPANEL = OWN_Q * 128;                  // 128 rows x 32 fp32
constexpr int Q_LO = 2 * QPANEL;                     // q's lo planes after its two hi panels
constexpr int RING = 2 * Q_LO;                       // 64 KB of resident q
constexpr int BAR = RING + STAGES_Q * STAGE;         // own, STAGES_Q full mbarriers, STAGES_Q counters
constexpr int SMEM = BAR + 8 * (1 + STAGES_Q) + 4 * STAGES_Q + 1024;
static_assert(BLOCKS_SM * (SMEM + 1024) <= 233472, "shared memory of two blocks an SM");

struct Params {
  int H, Lq, Lk, nq;   // nq: blocks a (batch, head)
  float qscale;
  float* o;
  long long os[3];     // the output's (batch, row, head) element strides
  float* lse;          // [B, Lq, H] or null
};

// x[r][n] = the qf k^T of the warp's row tile r (rows row0 + 16 r..) and the tile's
// 32 keys (n-tiles of 8), over the 64 columns: one chain a 32-column panel, from
// zero, the second added in fp32; per accumulator the products of own_walked<true>
// in its order (qf_hi k_lo, qf_lo k_hi, qf_hi k_hi), so K5 recomputes the same S.
// Each k-step's K fragments are loaded and split once for both row tiles, and the
// next step's loads and splits are issued between this step's three rounds.
__device__ __forceinline__ void qk_tile(float (&x)[2][4][4], uint32_t qhi, uint32_t khi, int row0, int lane) {
  float part[2][4][4];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int u = 0; u < 4; ++u) x[r][n][u] = part[r][n][u] = 0.f;
  uint32_t ah[2][2][4], al[2][2][4], bh[2][4], b[2][4][4];
  auto fetch = [&](int ks, int buf) {
    const uint32_t pa = qhi + (ks >> 2) * QPANEL, pb = khi + (ks >> 2) * WALK_PANEL;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      x3::ldsm_x4(ah[buf][r], a_addr(pa, row0 + 16 * r, ks & 3, lane));
      x3::ldsm_x4(al[buf][r], a_addr(pa + Q_LO, row0 + 16 * r, ks & 3, lane));
    }
#pragma unroll
    for (int np = 0; np < 2; ++np) x3::ldsm_x4(bh[np], bt_addr(pb, 16 * np, ks & 3, lane));
  };
  auto prep = [&](int buf, int np) {   // n-tiles 2 np, 2 np + 1: hi as loaded, lo split here
#pragma unroll
    for (int o = 0; o < 2; ++o)
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        b[buf][2 * np + o][u] = bh[np][2 * o + u];
        b[buf][2 * np + o][2 + u] = tf32_lo(__uint_as_float(bh[np][2 * o + u]));
      }
  };
  fetch(0, 0);
  prep(0, 0);
  prep(0, 1);
#pragma unroll
  for (int ks = 0; ks < 8; ++ks) {
    const int cur = ks & 1, nxt = cur ^ 1;
    float(&acc)[2][4][4] = ks < 4 ? x : part;
    if (ks + 1 < 8) fetch(ks + 1, nxt);
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int n = 0; n < 4; ++n) tt_mma_tf32(acc[r][n], ah[cur][r], b[cur][n][2], b[cur][n][3]);
    if (ks + 1 < 8) prep(nxt, 0);
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int n = 0; n < 4; ++n) tt_mma_tf32(acc[r][n], al[cur][r], b[cur][n][0], b[cur][n][1]);
    if (ks + 1 < 8) prep(nxt, 1);
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int n = 0; n < 4; ++n) tt_mma_tf32(acc[r][n], ah[cur][r], b[cur][n][0], b[cur][n][1]);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int u = 0; u < 4; ++u) x[r][n][u] += part[r][n][u];
}

// out[r][8 n-tiles] += p[r] V over the tile's 32 keys: p as C fragments (k-step
// slot tig <-> key 2 tig, slot tig + 4 <-> 2 tig + 1, so a C fragment is an A
// fragment), V's rows read as scalar B values (panels WALK_PANEL apart from
// `vhi`), split once for both row tiles; one chain over the tile, from zero, added
// in fp32. The 64 output columns go in two halves (V's two panels), which keeps
// one half's chains in registers beside the output.
__device__ __forceinline__ void pv_tile(float (&out)[2][8][4], const float (&e)[2][4][4], uint32_t vhi, int gid,
                                        int tig) {
  uint32_t al[2][4][4];   // p's lo parts, A-fragment order
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      al[r][kk][0] = tf32_lo(e[r][kk][0]);
      al[r][kk][1] = tf32_lo(e[r][kk][2]);
      al[r][kk][2] = tf32_lo(e[r][kk][1]);
      al[r][kk][3] = tf32_lo(e[r][kk][3]);
    }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const uint32_t panel = vhi + half * WALK_PANEL;
    float part[2][4][4];
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int u = 0; u < 4; ++u) part[r][n][u] = 0.f;
    float c[4][2];   // k-step kk's B values (keys 8 kk + 2 tig, + 1 of column 8 n + gid), loaded a step ahead
    auto fetch = [&](int kk) {
      const int row = 8 * kk + 2 * tig;
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        c[n][0] = x3::lds(panel + x3::sw(row, 8 * n + gid));
        c[n][1] = x3::lds(panel + x3::sw(row + 1, 8 * n + gid));
      }
    };
    fetch(0);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t b[4][4];
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          b[n][u] = __float_as_uint(c[n][u]);
          b[n][2 + u] = tf32_lo(c[n][u]);
        }
      if (kk + 1 < 4) fetch(kk + 1);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const uint32_t ah[4] = {__float_as_uint(e[r][kk][0]), __float_as_uint(e[r][kk][2]),
                                __float_as_uint(e[r][kk][1]), __float_as_uint(e[r][kk][3])};
        mma_x3<true>(part[r], ah, al[r][kk], b);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int u = 0; u < 4; ++u) out[r][4 * half + n][u] += part[r][n][u];
  }
}

}  // namespace k1x

__global__ void __launch_bounds__(k1x::THREADS_Q, k1x::BLOCKS_SM) flash_fwd_x3_kernel(
    const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
    const __grid_constant__ CUtensorMap vmap, const k1x::Params a) {
  using namespace k1x;
  extern __shared__ unsigned char k1x_smem[];
  const uint32_t base = smem_u32(smem_align_1024(k1x_smem));
  const uint32_t ring = base + RING, own_bar = base + BAR, full_bar = own_bar + 8;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, gid = lane >> 2, tig = lane & 3;
  const int bh = blockIdx.x / a.nq, q0 = blockIdx.x % a.nq * OWN_Q;
  const int b = bh / a.H, h = bh % a.H;
  const int ntiles = (a.Lk + BT - 1) / BT;
  const RingT<WARPS_Q, STAGES_Q> rg{full_bar, full_bar + 8 * STAGES_Q, ntiles, lane};
  auto load = [&](int stage, int j) {   // key tile j: K then V, two 32-column panels each
    const uint32_t st = ring + stage * STAGE, bar = full_bar + 8 * stage;
    mbar_expect_tx(bar, 4 * WALK_PANEL);
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int p = 0; p < 2; ++p) tma_load_4d(st + (2 * t + p) * WALK_PANEL, t == 0 ? &kmap : &vmap, bar, 32 * p,
                                              BT * j, h, b);
  };
  const int nbox = min(OWN_Q / BT, (a.Lq - q0 + BT - 1) / BT);   // the 32-row boxes that hold a query row
  if (tid == 0) {
    mbar_init(own_bar, 1);
#pragma unroll
    for (int s = 0; s < STAGES_Q; ++s) {
      mbar_init(full_bar + 8 * s, 1);
      asm volatile("st.shared.u32 [%0], 0;\n" ::"r"(full_bar + 8 * STAGES_Q + 4 * s) : "memory");
    }
    mbar_init_fence();
    mbar_expect_tx(own_bar, 2 * nbox * WALK_PANEL);
#pragma unroll
    for (int p = 0; p < 2; ++p)
      for (int i = 0; i < nbox; ++i)
        tma_load_4d(base + p * QPANEL + i * WALK_PANEL, &qmap, own_bar, 32 * p, q0 + BT * i, h, b);
    for (int j = 0; j < STAGES_Q && j < ntiles; ++j) load(j, j);
  }
  __syncthreads();   // the barriers are initialised
  mbar_wait(own_bar, 0);
#pragma unroll
  for (int p = 0; p < 2; ++p) {   // qf = q qscale in place, then its lo parts
    const int n16 = nbox * WALK_PANEL / 16;
    split_chunks<THREADS_Q>(base + p * QPANEL, base + p * QPANEL + Q_LO, n16, n16, a.qscale);
  }
  __syncthreads();   // the own planes are in place

  // a warp whose 32 rows all lie past Lq only counts the tiles; its rows lie in the loaded boxes otherwise
  const bool live = q0 + ROWS_W * warp < a.Lq;
  float acc[2][8][4], m[2][2], l[2][2];   // row tile r: rows gid (m[r][0]) and gid + 8 (m[r][1]) of its 16
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int i = 0; i < 2; ++i) m[r][i] = -INFINITY, l[r][i] = 0.f;
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int u = 0; u < 4; ++u) acc[r][n][u] = 0.f;
  }
  for (int j = 0; j < ntiles; ++j) {
    const uint32_t st = ring + (j % STAGES_Q) * STAGE;
    rg.wait(j);
    if (live) {
      float s[2][4][4];
      qk_tile(s, base, st, ROWS_W * warp, lane);   // base-2 logits
      // s[r][n][u]: row gid + 8 (u >> 1) of row tile r, key BT j + 8 n + 2 tig + (u & 1)
      const bool tail = BT * j + BT > a.Lk;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (tail) {
#pragma unroll
          for (int n = 0; n < 4; ++n)
#pragma unroll
            for (int u = 0; u < 4; ++u)
              if (BT * j + 8 * n + 2 * tig + (u & 1) >= a.Lk) s[r][n][u] = -INFINITY;
        }
        float alpha[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float mx = m[r][i];
#pragma unroll
          for (int n = 0; n < 4; ++n) mx = fmaxf(mx, fmaxf(s[r][n][2 * i], s[r][n][2 * i + 1]));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));   // finite: every tile holds a key
          alpha[i] = fx3::ex2(m[r][i] - mx);                       // 0 on the first tile
          m[r][i] = mx;
          l[r][i] *= alpha[i];
        }
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const float p = fx3::ex2(s[r][n][u] - m[r][u >> 1]);
            s[r][n][u] = p;
            l[r][u >> 1] += p;
          }
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int u = 0; u < 4; ++u) acc[r][n][u] *= alpha[u >> 1];
      }
      pv_tile(acc, s, st + 2 * WALK_PANEL, gid, tig);   // O += p V, one chain over the tile
    }
    rg.release(j, load);
  }
  if (!live) return;
  float* ob = a.o + b * a.os[0] + h * a.os[2];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float sum = l[r][i];   // the quad's partial sums of the row
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      const int row = q0 + ROWS_W * warp + 16 * r + gid + 8 * i;
      if (row >= a.Lq) continue;
      const float inv = 1.f / sum;
      float* d = ob + (long long)row * a.os[1] + 2 * tig;
#pragma unroll
      for (int n = 0; n < 8; ++n)
        *reinterpret_cast<float2*>(d + 8 * n) = make_float2(acc[r][n][2 * i] * inv, acc[r][n][2 * i + 1] * inv);
      if (a.lse != nullptr && tig == 0) a.lse[((long long)b * a.Lq + row) * a.H + h] = m[r][i] + log2f(sum);
    }
}

// Whether TMA can read q, k, v in place (16-byte aligned bases, (batch, row,
// head) strides in whole 16-byte rows) and o takes 8-byte stores.
bool fwd_x3_addressable(const void* q, const void* k, const void* v, const void* o, const long long* st) {
  const void* bases[3] = {q, k, v};
  if (!x3::rows_ok(bases, 3, st, 9) || reinterpret_cast<uintptr_t>(o) % 8) return false;
  for (int i = 9; i < 12; ++i)
    if (st[i] % 2) return false;
  return true;
}

// q, k, v, o [B, L, H, 64] fp32 through `st` (12 element strides, as the entry's);
// lse null or fp32 [B, Lq, H].
int launch_flash_fwd_x3(const void* q, const void* k, const void* v, void* o, float* lse, int B, int H, int Lq,
                        int Lk, const long long* st, float qscale, cudaStream_t stream) {
  using namespace k1x;
  static const cudaError_t attr =
      cudaFuncSetAttribute(flash_fwd_x3_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (attr != cudaSuccess) return (int)attr;
  CUtensorMap qmap, kmap, vmap;
  if (const int rc = fx3::tile_map(q, st + 0, Lq, H, B, &qmap)) return rc;
  if (const int rc = fx3::tile_map(k, st + 3, Lk, H, B, &kmap)) return rc;
  if (const int rc = fx3::tile_map(v, st + 6, Lk, H, B, &vmap)) return rc;
  Params a;
  a.H = H, a.Lq = Lq, a.Lk = Lk, a.nq = (Lq + OWN_Q - 1) / OWN_Q, a.qscale = qscale;
  a.o = static_cast<float*>(o), a.lse = lse;
  for (int i = 0; i < 3; ++i) a.os[i] = st[9 + i];
  if ((long long)B * H * a.nq > 0x7fffffffLL) return kErrBadArgument;
  flash_fwd_x3_kernel<<<B * H * a.nq, THREADS_Q, SMEM, stream>>>(qmap, kmap, vmap, a);
  return (int)cudaGetLastError();
}

}  // namespace vs
