// K5 in fp32 at D = 64 (the UNet's spatial self-attention heads, under an fp32
// gradient: `--dtype float32` fine-tuning, the fp32 UNet checks) on the tensor
// cores with split-TF32 products. flash_attention_bwd.cu's entry sends fp32
// D = 64 calls here (route 7, "tf32x3") when TMA can address q, k, v and g (16-byte
// aligned bases, strides in whole 16-byte rows; the others keep its FMA kernels).
//
// Replaces (TPU): vidseg_diffusion_tpu/ops/attention.py:
//   _flash_packed_bwd_dq_kernel and _flash_packed_bwd_dkv_kernel (the
//   pallas_calls at :993 and :1025 of _flash_attention_packed_bwd_impl) in fp32
//   at D = 64.
//
// Math (the JAX kernels', as the FMA kernels): qf = q * scale * log2(e) in fp32,
// p = exp2(qf k^T - lse) from K1's base-2 LSE (0 past Lk), delta = rowsum(g o)
// in fp32, ds = p (g v^T - delta); dq = scale ds k, dk = ds^T qf / log2(e),
// dv = p^T g. The two walks of JAX and the bf16 design: dq walks the key tiles
// of its query rows, dk / dv walk the query tiles of their keys; each block is
// the only writer of its outputs, with no atomics, so repeats give the same
// bits. A delta pass first writes each query row's delta and LSE to the scratch,
// from which both walks read them; then one launch holds both walks, every
// dk / dv block (the longer) before every dq block (flash_bwd_x3_kernel). Two
// launches, dq then dk / dv, each left a half-idle fourth wave at the ds1 slice
// [2, 5824, 5 x 64] (460 blocks of one an SM): 5.76 ms there against 5.28 for
// the one launch, and 4.88 with the dk / dv blocks first and p = exp2(s - lse)
// on ex2.approx.ftz (2 ulp) in place of exp2f (PERF.md §6).
//
// Arithmetic. Every product (S, dP, dQ, dK, dV) runs in TF32 as three products
// of split operands, x = hi + lo with hi x as stored (the tensor cores read its
// top 19 bits) and lo = x - hi rounded to TF32, a b ~ hi_a lo_b + lo_a hi_b +
// hi_a hi_b (wgmma_tile.cuh's tf32_lo; emulated in tests/test_torch_fp32_split.py).
// The tensor cores' fp32 sums round toward zero (PERF.md §6), so each
// chain is one load long, starts from zero and is added in fp32 registers: S
// and dP over each 32-column panel of the head dim (two chains), dQ, dK and dV
// over each 32-row walked tile. The key side sees the query side's p and ds:
// both kernels form S (and dP) from the same operands with the same three
// products in the same order (qf_hi k_lo, qf_lo k_hi, qf_hi k_hi; the dk / dv
// kernel holds k as the A operand, so it issues them as (k_lo, qf_hi),
// (k_hi, qf_lo), (k_hi, qf_hi)) over the same panels, from the same LSE and
// delta, through one exp2.
//
// What bounds it on the H100: 10 L^2 D flops per (batch, head) in the five
// products (S and dP recomputed in both kernels: 14 L^2 D executed), each three
// TF32 products at 495 TFLOP/s (165 TFLOP/s fp32-class), on O(L D) bytes: the
// tensor cores. Per (query, key) pair each kernel also spends an exp2 and a
// few fp32 operations, and the splits of its walked tile.
//
// Design: mma.sync m16n8k8 (TF32) for every product, the second of the two
// precedents in the tree (temporal_attention_long_tc.cu), not transposed
// outputs on wgmma (tf32x3_attention.cuh's phase B). TF32 wgmma reads both
// shared-memory operands K-major only, and three of the five products here
// contract over the walked rows (dQ += ds K, dV += p^T g, dK += ds^T qf), whose
// tiles are [row][d]: on wgmma each would need its p / ds written split into two
// fp32 planes of the warpgroup's 64 rows (32 KB, 64 KB for dk / dv) beside the
// resident own rows' hi and lo parts (64 KB a warpgroup), which leaves no room
// for a ring; register fragments take any layout, so p and ds go from the C
// fragments of S and dP straight into the A operands of the next product
// (k-step slot tig <-> walked row 2 tig, slot tig + 4 <-> 2 tig + 1) and the
// walked tile's rows are read as B fragments in place.
// - A block is eight warps and owns 128 rows (queries for dq, keys for dk / dv),
//   16 a warp. Its two own tensors (qf and g, or k and v) reach shared memory by
//   TMA once (the 32-row boxes that hold a row of the tensor) and are split there
//   into resident hi and lo planes (128 KB; qf scaled in place first); each warp
//   reads its A fragments by ldmatrix. A warp whose rows all lie past the length
//   only counts the walked tiles.
// - The walked side comes in tiles of 32 rows (k and v, or q and g with the
//   rows' LSE and delta) through a ring of four stages filled by TMA (rank-4
//   tiled maps over the (batch, row, head) strides, boxes of 32 columns x 32
//   rows, 128-byte swizzle; rows past a length arrive as zeros). Each warp
//   splits the walked values it reads in registers (q scaled first), so the
//   warps never meet in the walk: each waits for a tile's `full` mbarrier, and
//   the last of the eight to finish with a stage (a counter in shared memory)
//   asks TMA for the tile four ahead into it.
// - S and dP (16 own rows x 32 walked) take B fragments of the walked tile by
//   ldmatrix; the output products (16 own rows x 64 columns over the tile's
//   32 rows) read the walked tile's values as B fragments with scalar loads,
//   free of bank conflicts under the swizzle.
// - An mma.sync waits on the one before it on the same accumulator, so the three
//   products of every n-tile are issued term by term across the n-tiles (four
//   or eight independent ones between two on one accumulator).
// Ragged rows need one predicate: the dq kernel masks p past Lk (k is zero
// there, and exp2(-lse) alone could overflow); a query row past Lq has zero q
// and g, so whatever its p it adds nothing to dk or dv. Outputs leave each
// thread's column pairs as 8-byte stores, rows past a length not stored.
#include "flash_x3_tile.cuh"

namespace vs {
namespace k5x {

using namespace fx3;

constexpr float kInvLog2E = 0.6931471805599453f;
constexpr int OWN_LO = 4 * OWN_PANEL;                              // hi: 2 tensors x 2 panels, then lo
constexpr int RING = 2 * OWN_LO;                                   // 128 KB
constexpr int ROWS = RING + STAGES * STAGE;                        // row vectors (1 KB)
constexpr int BAR = ROWS + 1024;                                   // own, STAGES full mbarriers, STAGES counters
constexpr int SMEM = BAR + 8 * (1 + STAGES) + 4 * STAGES + 1024;
static_assert(SMEM <= 232448, "shared memory of one block");

// the own rows' two tensors: TMA boxes of 32 rows x 32 columns into the hi planes, `nbox` of them a panel
__device__ __forceinline__ void load_own(uint32_t base, const CUtensorMap* a, const CUtensorMap* b, uint32_t bar,
                                         int row0, int nbox, int h, int bidx) {
  mbar_expect_tx(bar, 4 * nbox * WALK_PANEL);
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int p = 0; p < 2; ++p)
      for (int i = 0; i < nbox; ++i)
        tma_load_4d(base + (2 * t + p) * OWN_PANEL + i * WALK_PANEL, t == 0 ? a : b, bar, 32 * p, row0 + BT * i, h,
                    bidx);
}

// the own planes' lo parts over the loaded boxes (qf scaled in place first, `scale_first`)
__device__ __forceinline__ void split_own(uint32_t base, int nbox, bool scale_first, float qscale) {
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const uint32_t hi = base + (2 * t + p) * OWN_PANEL, n16 = nbox * WALK_PANEL / 16;
      split_chunks(hi, hi + OWN_LO, n16, scale_first && t == 0 ? n16 : 0, qscale);
    }
}

// walked tile j of two tensors into `stage` (and, with `rowmap`, the rows' LSE and delta into `rows`)
__device__ __forceinline__ void load_walked(uint32_t stage, const CUtensorMap* a, const CUtensorMap* b,
                                            const CUtensorMap* rowmap, uint32_t rows, uint32_t bar, int j, int h,
                                            int bidx, int bh) {
  mbar_expect_tx(bar, 4 * WALK_PANEL + (rowmap != nullptr ? 2 * BT * 4 : 0));
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int p = 0; p < 2; ++p)
      tma_load_4d(stage + (2 * t + p) * WALK_PANEL, t == 0 ? a : b, bar, 32 * p, BT * j, h, bidx);
  if (rowmap != nullptr) tma_load_3d(rows, rowmap, bar, BT * j, bh, 0);
}

// The walked side's tensor maps, the scratch's rows map and the arguments both roles share.
struct Params {
  int H, BH, Lq, Lk, lq_pad, nkv, nq;   // nkv, nq: blocks a (batch, head) of the dk / dv and dq roles
  float qscale, scale;
  float *dq, *dk, *dv;
  long long dqs[3], dks[3], dvs[3];   // (batch, row, head) element strides
};

// dq: the block's 128 query rows against every key tile
__device__ __forceinline__ void dq_role(uint32_t base, const CUtensorMap* qmap, const CUtensorMap* kmap,
                                        const CUtensorMap* vmap, const CUtensorMap* gmap, const float* scratch,
                                        const Params& a, int bh, int q0) {
  const uint32_t ring = base + RING, own_bar = base + BAR, full_bar = own_bar + 8;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, gid = lane >> 2, tig = lane & 3;
  const int b = bh / a.H, h = bh % a.H;
  const int ntiles = (a.Lk + BT - 1) / BT;
  const Ring rg{full_bar, full_bar + 8 * STAGES, ntiles, lane};
  auto load = [&](int stage, int j) {
    load_walked(ring + stage * STAGE, kmap, vmap, nullptr, 0, full_bar + 8 * stage, j, h, b, bh);
  };
  const int nbox = own_boxes(q0, a.Lq);
  const bool live = q0 + 16 * warp < a.Lq;   // a warp whose 16 rows all lie past Lq only counts the tiles
  if (tid == 0) {
    load_own(base, qmap, gmap, own_bar, q0, nbox, h, b);
    for (int j = 0; j < STAGES && j < ntiles; ++j) load(j, j);
  }
  float lse_r[2], del_r[2];   // the warp's rows' LSE and delta, from the delta pass
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + 16 * warp + gid + 8 * i;
    lse_r[i] = row < a.Lq ? scratch[(long long)bh * a.lq_pad + row] : 0.f;
    del_r[i] = row < a.Lq ? scratch[((long long)a.BH + bh) * a.lq_pad + row] : 0.f;
  }
  mbar_wait(own_bar, 0);
  split_own(base, nbox, true, a.qscale);   // qf = q qscale, then g
  __syncthreads();                          // the own planes are in place

  float acc[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int u = 0; u < 4; ++u) acc[n][u] = 0.f;
  for (int j = 0; j < ntiles; ++j) {
    const uint32_t st = ring + (j % STAGES) * STAGE;
    rg.wait(j);
    if (live) {
      float s[4][4], dp[4][4];
      own_walked<true, OWN_LO>(s, base, st, 1.f, 16 * warp, lane);                                     // qf k^T
      own_walked<true, OWN_LO>(dp, base + 2 * OWN_PANEL, st + 2 * WALK_PANEL, 1.f, 16 * warp, lane);   // g v^T
      // s[n][u]: own row gid + 8 (u >> 1) of the warp's 16, key BT j + 8 n + 2 tig + (u & 1)
      const bool tail = BT * j + BT > a.Lk;
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          float p = ex2(s[n][u] - lse_r[u >> 1]);
          if (tail && BT * j + 8 * n + 2 * tig + (u & 1) >= a.Lk) p = 0.f;
          s[n][u] = p * (dp[n][u] - del_r[u >> 1]);
        }
      walked_product(acc, s, st, 1.f, gid, tig);   // dQ += ds k
    }
    rg.release(j, load);
  }
  store_rows(acc, a.scale, a.dq + b * a.dqs[0] + h * a.dqs[2], a.dqs[1], q0 + 16 * warp, a.Lq, gid, tig);
}

// dk / dv: the block's 128 keys against every query tile
__device__ __forceinline__ void dkv_role(uint32_t base, const CUtensorMap* qmap, const CUtensorMap* kmap,
                                         const CUtensorMap* vmap, const CUtensorMap* gmap,
                                         const CUtensorMap* rowmap, const Params& a, int bh, int k0) {
  const uint32_t ring = base + RING, srows = base + ROWS, own_bar = base + BAR, full_bar = own_bar + 8;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, gid = lane >> 2, tig = lane & 3;
  const int b = bh / a.H, h = bh % a.H;
  const int ntiles = (a.Lq + BT - 1) / BT;
  const Ring rg{full_bar, full_bar + 8 * STAGES, ntiles, lane};
  auto load = [&](int stage, int j) {
    load_walked(ring + stage * STAGE, qmap, gmap, rowmap, srows + stage * 2 * BT * 4, full_bar + 8 * stage, j, h, b,
                bh);
  };
  const int nbox = own_boxes(k0, a.Lk);
  const bool live = k0 + 16 * warp < a.Lk;   // a warp whose 16 keys all lie past Lk only counts the tiles
  if (tid == 0) {
    load_own(base, kmap, vmap, own_bar, k0, nbox, h, b);
    for (int j = 0; j < STAGES && j < ntiles; ++j) load(j, j);
  }
  mbar_wait(own_bar, 0);
  split_own(base, nbox, false, 1.f);   // k, v
  __syncthreads();                      // the own planes are in place

  float dk_acc[8][4], dv_acc[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int u = 0; u < 4; ++u) dk_acc[n][u] = dv_acc[n][u] = 0.f;
  for (int j = 0; j < ntiles; ++j) {
    const uint32_t st = ring + (j % STAGES) * STAGE, rows = srows + (j % STAGES) * 2 * BT * 4;
    rg.wait(j);
    if (live) {
      float s[4][4], dp[4][4];
      own_walked<false, OWN_LO>(s, base, st, a.qscale, 16 * warp, lane);                               // k qf^T = S^T
      own_walked<false, OWN_LO>(dp, base + 2 * OWN_PANEL, st + 2 * WALK_PANEL, 1.f, 16 * warp, lane);  // v g^T = dP^T
      // s[n][u]: own key gid + 8 (u >> 1) of the warp's 16, query BT j + 8 n + 2 tig + (u & 1)
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        float l[2], d[2];
        asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n" : "=f"(l[0]), "=f"(l[1]) : "r"(rows + 4 * (8 * n + 2 * tig)));
        asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n"
                     : "=f"(d[0]), "=f"(d[1])
                     : "r"(rows + 4 * (BT + 8 * n + 2 * tig)));
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float p = ex2(s[n][u] - l[u & 1]);
          s[n][u] = p;
          dp[n][u] = p * (dp[n][u] - d[u & 1]);
        }
      }
      walked_product(dv_acc, s, st + 2 * WALK_PANEL, 1.f, gid, tig);   // dV += p^T g
      walked_product(dk_acc, dp, st, a.qscale, gid, tig);              // dK += ds^T qf
    }
    rg.release(j, load);
  }
  store_rows(dk_acc, kInvLog2E, a.dk + b * a.dks[0] + h * a.dks[2], a.dks[1], k0 + 16 * warp, a.Lk, gid, tig);
  store_rows(dv_acc, 1.f, a.dv + b * a.dvs[0] + h * a.dvs[2], a.dvs[1], k0 + 16 * warp, a.Lk, gid, tig);
}

}  // namespace k5x

// The delta pass: delta = rowsum(g o) of every query row in fp32 (d in order, a warp's lanes two columns each,
// then the lanes' sums by shuffles) and the row's LSE, both to the scratch [2][B*H][lq_pad], one warp a row.
__global__ void __launch_bounds__(256) flash_bwd_x3_delta_kernel(const float* __restrict__ o,
                                                                 const float* __restrict__ g,
                                                                 const float* __restrict__ lse,
                                                                 float* __restrict__ scratch, int H, int Lq,
                                                                 int lq_pad, long long osb, long long osl,
                                                                 long long osh, long long gsb, long long gsl,
                                                                 long long gsh) {
  const int bh = blockIdx.y, b = bh / H, h = bh % H, lane = threadIdx.x & 31;
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5);
  if (row >= Lq) return;
  const float2 ov = *reinterpret_cast<const float2*>(o + b * osb + h * osh + (long long)row * osl + 2 * lane);
  const float2 gv = *reinterpret_cast<const float2*>(g + b * gsb + h * gsh + (long long)row * gsl + 2 * lane);
  const float acc = warp_sum(gv.x * ov.x + gv.y * ov.y);
  if (lane == 0) {
    scratch[(long long)bh * lq_pad + row] = lse[((long long)b * Lq + row) * H + h];
    scratch[((long long)gridDim.y + bh) * lq_pad + row] = acc;
  }
}

// Both roles in one launch: the first B H nkv blocks take dk / dv, the others dq. Two launches (dq, then dk / dv) each
// left the card 3.48 waves of blocks at the ds1 slice [2, 5824, 5 x 64] (460 blocks of one an SM): a fourth
// round half idle twice; one launch packs 920 blocks of two lengths.
__global__ void __launch_bounds__(k5x::THREADS, 1) flash_bwd_x3_kernel(
    const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
    const __grid_constant__ CUtensorMap vmap, const __grid_constant__ CUtensorMap gmap,
    const __grid_constant__ CUtensorMap rowmap, const float* __restrict__ scratch, const k5x::Params a) {
  using namespace k5x;
  extern __shared__ unsigned char k5x_smem[];
  const uint32_t base = smem_u32(smem_align_1024(k5x_smem));
  const uint32_t own_bar = base + BAR, full_bar = own_bar + 8;
  if (threadIdx.x == 0) {
    mbar_init(own_bar, 1);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full_bar + 8 * s, 1);
      asm volatile("st.shared.u32 [%0], 0;\n" ::"r"(full_bar + 8 * STAGES + 4 * s) : "memory");
    }
    mbar_init_fence();
  }
  __syncthreads();
  const int i = blockIdx.x, kv = a.BH * a.nkv;   // every dk / dv block (the longer) before every dq block
  if (i < kv)
    dkv_role(base, &qmap, &kmap, &vmap, &gmap, &rowmap, a, i / a.nkv, i % a.nkv * OWN);
  else
    dq_role(base, &qmap, &kmap, &vmap, &gmap, scratch, a, (i - kv) / a.nq, (i - kv) % a.nq * OWN);
}

// Whether TMA can read q, k, v, g (and the delta pass o) in place: 16-byte
// aligned bases, (batch, row, head) strides in whole 16-byte rows.
bool bwd_x3_addressable(const void* q, const void* k, const void* v, const void* o, const void* g,
                        const long long* st) {
  const void* bases[5] = {q, k, v, o, g};
  return x3::rows_ok(bases, 5, st, 15);
}

// q, k, v, o, g [B, L, H, 64] fp32 through `st` (24 element strides, as the
// entry's); scratch [2, B*H, Lq rounded up to 4] fp32 (the rows' LSE, then
// delta); dq, dk, dv the wrapper's own outputs.
int launch_bwd_x3(const void* q, const void* k, const void* v, const void* o, const void* g, const float* lse,
                  float* scratch, void* dq, void* dk, void* dv, int B, int H, int Lq, int Lk, const long long* st,
                  float qscale, float scale, cudaStream_t stream) {
  using namespace k5x;
  if (reinterpret_cast<uintptr_t>(scratch) % 16) return kErrBadArgument;
  for (int i = 15; i < 24; ++i)   // dq, dk, dv: 8-byte stores
    if (st[i] % 2) return kErrBadArgument;
  static const cudaError_t attr =
      cudaFuncSetAttribute(flash_bwd_x3_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (attr != cudaSuccess) return (int)attr;
  CUtensorMap qmap, kmap, vmap, gmap;
  if (const int rc = fx3::tile_map(q, st + 0, Lq, H, B, &qmap)) return rc;
  if (const int rc = fx3::tile_map(k, st + 3, Lk, H, B, &kmap)) return rc;
  if (const int rc = fx3::tile_map(v, st + 6, Lk, H, B, &vmap)) return rc;
  if (const int rc = fx3::tile_map(g, st + 12, Lq, H, B, &gmap)) return rc;
  const int lq_pad = (Lq + 3) / 4 * 4;
  CUtensorMap rowmap;   // the scratch's rows: [2][B*H][lq_pad], boxes of BT rows x both
  {
    const cuuint64_t dims[3] = {(cuuint64_t)Lq, (cuuint64_t)B * H, 2};
    const cuuint64_t strides[2] = {(cuuint64_t)lq_pad * 4, (cuuint64_t)B * H * lq_pad * 4};
    const cuuint32_t box[3] = {(cuuint32_t)BT, 1, 2};
    if (const int rc = tma_tiled_map(CU_TENSOR_MAP_DATA_TYPE_FLOAT32, CU_TENSOR_MAP_SWIZZLE_NONE, scratch, 3, dims,
                                     strides, box, &rowmap))
      return rc;
  }
  flash_bwd_x3_delta_kernel<<<dim3((Lq + 7) / 8, B * H), 256, 0, stream>>>(
      static_cast<const float*>(o), static_cast<const float*>(g), lse, scratch, H, Lq, lq_pad, st[9], st[10], st[11],
      st[12], st[13], st[14]);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  Params a;
  a.H = H, a.BH = B * H, a.Lq = Lq, a.Lk = Lk, a.lq_pad = lq_pad, a.nkv = (Lk + OWN - 1) / OWN;
  a.nq = (Lq + OWN - 1) / OWN;
  a.qscale = qscale, a.scale = scale;
  a.dq = static_cast<float*>(dq), a.dk = static_cast<float*>(dk), a.dv = static_cast<float*>(dv);
  for (int i = 0; i < 3; ++i) a.dqs[i] = st[15 + i], a.dks[i] = st[18 + i], a.dvs[i] = st[21 + i];
  if ((long long)B * H * (a.nkv + a.nq) > 0x7fffffffLL) return kErrBadArgument;
  flash_bwd_x3_kernel<<<B * H * (a.nkv + a.nq), THREADS, SMEM, stream>>>(
      qmap, kmap, vmap, gmap, rowmap, scratch, a);
  return (int)cudaGetLastError();
}

}  // namespace vs
