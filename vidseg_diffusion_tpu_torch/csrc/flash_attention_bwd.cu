// K5 flash_attention_packed_bwd: the backward of K1 on packed [B, L, H*D]
// projections, from the base-2 LSE that K1 saved.
//
// Replaces (TPU): vidseg_diffusion_tpu/ops/attention.py:
//   _flash_packed_bwd_dq_kernel and _flash_packed_bwd_dkv_kernel (via
//   _flash_attention_packed_bwd_impl, reached from _fap_bwd). The port also
//   sends the short spatial sites (ds4, mid) here: their forward is K1, so
//   their backward is K5, not the TPU's folded _small_seq_bwd_kernel.
//
// Math (the JAX kernels'): qf = q*scale*log2(e) rounded to the input dtype
// (the forward's prescale), p = exp2(qf k^T - lse), delta = rowsum(g o) per
// head in fp32, ds = p (g v^T - delta). ds is rounded to the input dtype
// before dq = scale * ds k and dk = ds^T qf / log2(e); p is rounded before
// dv = p^T g. Two kernels, like the TPU's, each the only writer of its
// outputs: dq walks the key tiles of its 64 query rows (and writes delta for
// the second kernel), dk/dv walk the query tiles of their 64 keys; no
// atomics, so every run gives the same result. Both read q/k/v/o/g through
// (batch, row, head) element strides, as K1 does. The ragged key tail gets
// p = 0; ragged query rows compute on zeros and are never stored.
//
// What bounds it on the H100: 10 L^2 D flops per (batch, head) in the five
// products (S and g v^T are recomputed in both kernels: 14 L^2 D executed) on
// O(L D) bytes, so arithmetic, as for K1; the [L, L] logits never reach device
// memory. At D = 64 each (query, key) pair also costs two exp2 (one a kernel)
// on the MUFU, as much time as its products on the tensor cores, so the design
// keeps two warpgroups a block, one's exponentials beside the other's wgmmas.
// bf16 at D = 64 runs on wgmma fed by TMA (below: two warpgroups of 64 rows a
// block, the walked side in 128-row tiles through a four-stage ring); bf16 at
// D = 16 (the tiny configs' heads, on no full-width path) on mma.sync fed by
// cp.async (at the end); fp32 at D = 64 runs split-TF32 mma.sync kernels
// (flash_attention_bwd_x3.cu) where TMA can address q, k, v and g, otherwise
// (and at D = 16) FMAs on shared-memory tiles, templated on D.
#include <string.h>

#include "common.cuh"
#include "temporal_tile.cuh"
#include "wgmma_tile.cuh"

namespace vs {

// element strides (batch, row, head) of the eight tensors, in this order
struct BwdStrides {
  long long q[3], k[3], v[3], o[3], g[3], dq[3], dk[3], dv[3];
};
static_assert(sizeof(BwdStrides) == 24 * sizeof(long long), "packed strides");

constexpr int BW_T = 64;          // query rows and key rows per tile
constexpr int BW_P = BW_T + 1;    // padded fp32 smem row of a [query][key] tile
constexpr float kInvLog2E = 0.6931471805599453f;

// ---------------------------------------------------------------------------
// The FMA kernels, fp32, templated on the head dim D (a multiple of 16: the
// fp32 UNet check's 16 and 64; bf16 runs the wgmma and mma.sync kernels
// below). 256 threads as a 16x16 grid, 4 x (D / 16) register micro-tiles
// (rows ty + 16 i, columns tx + 16 j); d rows padded to D + 1 floats in shared
// memory.

template <int D>
__global__ void __launch_bounds__(256) flash_bwd_dq_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ o, const float* __restrict__ g, const float* __restrict__ lse,
    float* __restrict__ delta, float* __restrict__ dq, int H, int Lq, int Lk, BwdStrides st,
    float qscale, float scale) {
  constexpr int DS = D + 1, RD = D / 16;
  static_assert(D % 16 == 0, "head dim");
  extern __shared__ float smem[];
  float* Qs = smem;                  // [BW_T][DS] qf
  float* Gs = Qs + BW_T * DS;        // g
  float* Ks = Gs + BW_T * DS;
  float* Vs = Ks + BW_T * DS;
  float* Ds = Vs + BW_T * DS;        // [BW_T][BW_P] ds
  float* row_lse = Ds + BW_T * BW_P;
  float* row_delta = row_lse + BW_T;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int q0 = blockIdx.x * BW_T;
  const float* qb = q + b * st.q[0] + h * st.q[2];
  const float* kb = k + b * st.k[0] + h * st.k[2];
  const float* vb = v + b * st.v[0] + h * st.v[2];
  const float* ob = o + b * st.o[0] + h * st.o[2];
  const float* gb = g + b * st.g[0] + h * st.g[2];
  float* dqb = dq + b * st.dq[0] + h * st.dq[2];

  for (int e = tid; e < BW_T * D; e += 256) {
    const int r = e / D, d = e % D;
    float qv = 0.f, gv = 0.f;
    if (q0 + r < Lq) {
      qv = qb[(long long)(q0 + r) * st.q[1] + d] * qscale;
      gv = gb[(long long)(q0 + r) * st.g[1] + d];
    }
    Qs[r * DS + d] = qv;
    Gs[r * DS + d] = gv;
  }
  for (int r = warp; r < BW_T; r += 8) {  // delta: one warp per row
    const int row = q0 + r;
    float acc = 0.f;
    if (row < Lq)
      for (int d = lane; d < D; d += 32)
        acc += gb[(long long)row * st.g[1] + d] * ob[(long long)row * st.o[1] + d];
    acc = warp_sum(acc);
    if (lane == 0) {
      row_delta[r] = acc;
      row_lse[r] = row < Lq ? lse[((long long)b * Lq + row) * H + h] : 0.f;
      if (row < Lq) delta[((long long)b * Lq + row) * H + h] = acc;
    }
  }

  float acc[4][RD];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < RD; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < Lk; k0 += BW_T) {
    __syncthreads();  // previous tile's reads done (and the staging above)
    for (int e = tid; e < BW_T * D; e += 256) {
      const int r = e / D, d = e % D;
      float kv = 0.f, vv = 0.f;
      if (k0 + r < Lk) {
        kv = kb[(long long)(k0 + r) * st.k[1] + d];
        vv = vb[(long long)(k0 + r) * st.v[1] + d];
      }
      Ks[r * DS + d] = kv;
      Vs[r * DS + d] = vv;
    }
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], gv[4], kv[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = Qs[(ty + 16 * i) * DS + d];
        gv[i] = Gs[(ty + 16 * i) * DS + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kv[j] = Ks[(tx + 16 * j) * DS + d];
        vv[j] = Vs[(tx + 16 * j) * DS + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(gv[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const float l = row_lse[r], dl = row_delta[r];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const float p = (k0 + c < Lk) ? exp2f(s[i][j] - l) : 0.f;
        Ds[r * BW_P + c] = p * (dp[i][j] - dl);
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BW_T; ++kk) {
      float dsv[4], kv[RD];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = Ds[(ty + 16 * i) * BW_P + kk];
#pragma unroll
      for (int j = 0; j < RD; ++j) kv[j] = Ks[kk * DS + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < RD; ++j) acc[i][j] = fmaf(dsv[i], kv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= Lq) continue;
    float* drow = dqb + (long long)row * st.dq[1];
#pragma unroll
    for (int j = 0; j < RD; ++j) drow[tx + 16 * j] = acc[i][j] * scale;
  }
}

template <int D>
__global__ void __launch_bounds__(256) flash_bwd_dkv_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ g, const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dk, float* __restrict__ dv, int H, int Lq, int Lk, BwdStrides st,
    float qscale) {
  constexpr int DS = D + 1, RD = D / 16;
  static_assert(D % 16 == 0, "head dim");
  extern __shared__ float smem[];
  float* Ks = smem;                  // [BW_T][DS] this block's keys
  float* Vs = Ks + BW_T * DS;
  float* Qs = Vs + BW_T * DS;        // qf of the current query tile
  float* Gs = Qs + BW_T * DS;
  float* Ps = Gs + BW_T * DS;        // [BW_T][BW_P] p [query][key]
  float* Ds = Ps + BW_T * BW_P;      // ds [query][key]
  float* row_lse = Ds + BW_T * BW_P;
  float* row_delta = row_lse + BW_T;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int k0 = blockIdx.x * BW_T;
  const float* qb = q + b * st.q[0] + h * st.q[2];
  const float* kb = k + b * st.k[0] + h * st.k[2];
  const float* vb = v + b * st.v[0] + h * st.v[2];
  const float* gb = g + b * st.g[0] + h * st.g[2];

  for (int e = tid; e < BW_T * D; e += 256) {
    const int r = e / D, d = e % D;
    float kv = 0.f, vv = 0.f;
    if (k0 + r < Lk) {
      kv = kb[(long long)(k0 + r) * st.k[1] + d];
      vv = vb[(long long)(k0 + r) * st.v[1] + d];
    }
    Ks[r * DS + d] = kv;
    Vs[r * DS + d] = vv;
  }

  float acc_dk[4][RD], acc_dv[4][RD];  // rows: keys ty + 16 i; columns: d = tx + 16 j
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < RD; ++j) acc_dk[i][j] = acc_dv[i][j] = 0.f;

  for (int q0 = 0; q0 < Lq; q0 += BW_T) {
    __syncthreads();
    for (int e = tid; e < BW_T * D; e += 256) {
      const int r = e / D, d = e % D;
      float qv = 0.f, gv = 0.f;
      if (q0 + r < Lq) {
        qv = qb[(long long)(q0 + r) * st.q[1] + d] * qscale;
        gv = gb[(long long)(q0 + r) * st.g[1] + d];
      }
      Qs[r * DS + d] = qv;
      Gs[r * DS + d] = gv;
    }
    if (tid < BW_T) {
      const int row = q0 + tid;
      const long long idx = ((long long)b * Lq + row) * H + h;
      row_lse[tid] = row < Lq ? lse[idx] : INFINITY;  // ragged rows: p = 0
      row_delta[tid] = row < Lq ? delta[idx] : 0.f;
    }
    __syncthreads();

    // S and g v^T for (query ty + 16 i, key tx + 16 j)
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], gv[4], kv[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = Qs[(ty + 16 * i) * DS + d];
        gv[i] = Gs[(ty + 16 * i) * DS + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kv[j] = Ks[(tx + 16 * j) * DS + d];
        vv[j] = Vs[(tx + 16 * j) * DS + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(gv[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const float l = row_lse[r], dl = row_delta[r];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const float p = (k0 + c < Lk) ? exp2f(s[i][j] - l) : 0.f;
        Ps[r * BW_P + c] = p;
        Ds[r * BW_P + c] = p * (dp[i][j] - dl);
      }
    }
    __syncthreads();

    // dv += p^T g, dk += ds^T qf over this tile's queries
#pragma unroll 4
    for (int qq = 0; qq < BW_T; ++qq) {
      float pv[4], dsv[4], gv[RD], qv[RD];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pv[i] = Ps[qq * BW_P + ty + 16 * i];
        dsv[i] = Ds[qq * BW_P + ty + 16 * i];
      }
#pragma unroll
      for (int j = 0; j < RD; ++j) {
        gv[j] = Gs[qq * DS + tx + 16 * j];
        qv[j] = Qs[qq * DS + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < RD; ++j) {
          acc_dv[i][j] = fmaf(pv[i], gv[j], acc_dv[i][j]);
          acc_dk[i][j] = fmaf(dsv[i], qv[j], acc_dk[i][j]);
        }
    }
  }

  float* dkb = dk + b * st.dk[0] + h * st.dk[2];
  float* dvb = dv + b * st.dv[0] + h * st.dv[2];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + ty + 16 * i;
    if (key >= Lk) continue;
#pragma unroll
    for (int j = 0; j < RD; ++j) {
      dkb[(long long)key * st.dk[1] + tx + 16 * j] = acc_dk[i][j] * kInvLog2E;
      dvb[(long long)key * st.dv[1] + tx + 16 * j] = acc_dv[i][j];
    }
  }
}

template <int D>
int launch_bwd_fma(const void* q, const void* k, const void* v, const void* o, const void* g,
                   const float* lse, float* delta, void* dq, void* dk, void* dv, int B, int H,
                   int Lq, int Lk, const BwdStrides& st, float qscale, float scale,
                   cudaStream_t stream) {
  const size_t smem_dq = sizeof(float) * (4 * BW_T * (D + 1) + BW_T * BW_P + 2 * BW_T);
  const size_t smem_dkv = sizeof(float) * (4 * BW_T * (D + 1) + 2 * BW_T * BW_P + 2 * BW_T);
  static const cudaError_t attr_dq = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_dq);
  static const cudaError_t attr_dkv = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_dkv);
  if (attr_dq != cudaSuccess) return (int)attr_dq;
  if (attr_dkv != cudaSuccess) return (int)attr_dkv;
  const float* qt = static_cast<const float*>(q);
  const float* kt = static_cast<const float*>(k);
  const float* vt = static_cast<const float*>(v);
  const float* gt = static_cast<const float*>(g);
  flash_bwd_dq_kernel<D><<<dim3((Lq + BW_T - 1) / BW_T, B * H), 256, smem_dq, stream>>>(
      qt, kt, vt, static_cast<const float*>(o), gt, lse, delta, static_cast<float*>(dq), H, Lq, Lk, st,
      qscale, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dkv_kernel<D><<<dim3((Lk + BW_T - 1) / BW_T, B * H), 256, smem_dkv, stream>>>(
      qt, kt, vt, gt, lse, delta, static_cast<float*>(dk), static_cast<float*>(dv), H, Lq, Lk, st,
      qscale);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 on wgmma fed by TMA. Both kernels are blocks of NWG = 2 warpgroups (64
// rows each, 256 threads: a producer warp of its own would leave ptxas 168
// registers a thread, and a warpgroup's S and dP tiles of 128 columns, its
// accumulators and the A operands of its products take 225-254) and a ring of STAGES stages (`full` / `empty`
// mbarriers) that the last warpgroup's first thread refills by TMA once both
// have handed a stage back (the turns below make that warpgroup the last to
// finish with a stage, so it never waits); q, k,
// v and g are read in place through rank-4 tiled maps over their (batch, row,
// head) strides, one 128-row x 64-d box (16 KB, 128-byte rows under the
// 128-byte swizzle) a tile; rows past Lq or Lk arrive as zeros. The walked side
// comes in 128-row tiles, so S and dP are m64n128k16 products from shared
// memory (a 64-wide B would make them as bound by shared-memory reads as by the
// tensor cores).
// - dq (flash_bwd_dq_wgmma_kernel): a block owns 64 NWG query rows of one head,
//   their q and g resident; each warpgroup scales its q rows by scale * log2(e)
//   in shared memory, rounded to bf16 once (then a proxy fence: wgmma reads
//   through the async proxy), computes delta = rowsum(g o) of its rows and writes
//   it with the rows' LSE to the scratch ([2, B*H, Lq rounded up to 4] fp32, for
//   the dk/dv kernel's TMA), then per key tile of the ring (K and V) S = qf K^T
//   and dP = g V^T (8 x m64n128k16), p = exp2(s - lse) (0 past Lk), ds = p (dp -
//   delta) rounded into the register A operand of dQ += ds K (8 x m64n64k16, K
//   the MN-major B operand: its rows are the contraction);
// - dk/dv (flash_bwd_dkv_wgmma_kernel): a block owns 64 NWG keys of one head,
//   each warpgroup 64 with their K and V rows resident; the ring brings q, g and
//   the rows' LSE and delta (a [2][128] fp32 box of the scratch) per query tile;
//   each warpgroup scales its half of the rows of the next q tile in place while
//   its products of this tile run, and hands the half over through an
//   arrive-early named barrier that the other waits on only before that tile's
//   products, so neither waits for the other; then S^T = K qf^T and dP^T = V g^T (the
//   transposes are the operands' major-ness: both K-major), p^T = exp2(s^T -
//   lse) and ds^T in registers, dV += round(p^T) g and dK += ds^T qf with the A
//   operand from registers and g / qf the MN-major B operand. dK and dV (64 x 64
//   fp32 each a warpgroup) stay in registers for the whole walk.
// The two warpgroups take turns to issue their wgmmas (named barriers, as in K1's
// forward), one turn a walked tile: the output products of tile j - 1 and S / dP
// of tile j as one burst (dq: both in flight together; dk/dv: S^T and dP^T once
// the products are done, since their registers and the products' A operands do
// not fit together), so one warpgroup's exponentials run while the other's burst
// does. With separate turns for S / dP and for the products the elementwise work
// was not hidden: taking it out of the kernels saved 23-40 % of their time.
// Ragged rows need no predicate but one: a query row past Lq has zero q and g,
// so it adds nothing to dK or dV whatever its p; a key past Lk is zero in K and
// V, and the dq kernel masks its p to 0 (exp2(-lse) alone could overflow).
// Outputs are staged through the warpgroup's own spent tile and stored 16 bytes
// a thread, rows past the end not stored.
namespace k5w {
constexpr int NWG = 2, THREADS = 128 * NWG;
constexpr int T64 = 64 * 128, T128 = 2 * T64;           // 64- and 128-row x 64-d bf16 tiles
constexpr int DQ_STAGES = 4, DQ_STAGE = 2 * T128;       // K, V
constexpr int DQ_RES = 2 * T128;                        // q and g of the block's 128 rows
constexpr int DQ_ROWS = DQ_RES + DQ_STAGES * DQ_STAGE;  // each warpgroup's rows' LSE and delta
constexpr int DQ_BAR = DQ_ROWS + NWG * 64 * 8;
constexpr int DQ_SMEM = DQ_BAR + 8 * (1 + 2 * DQ_STAGES) + 1024;
constexpr int DKV_STAGES = 4, DKV_STAGE = 2 * T128 + 1024;  // q, g, the rows' LSE and delta (1 KB)
constexpr int DKV_RES = 2 * T128;                           // K and V of the block's 128 keys
constexpr int DKV_BAR = DKV_RES + DKV_STAGES * DKV_STAGE;   // res, full, empty
constexpr int DKV_SMEM = DKV_BAR + 8 * (1 + 2 * DKV_STAGES) + 1024;
// named barriers: 1..NWG the turns, 3, 4 each warpgroup's own, 5 + 2 w + parity
// warpgroup w's half of a q tile scaled
constexpr int SCALED_BAR = 5;
}  // namespace k5w

__device__ __forceinline__ void bw_ld_shared_v4(uint32_t addr, uint4& v) {
  asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr)
               : "memory");
}
__device__ __forceinline__ void bw_st_shared_v4(uint32_t addr, const uint4& v) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

__device__ __forceinline__ float bw_ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Turns between the NWG warpgroups of a block to issue their wgmmas (named
// barriers 1..NWG, one a warpgroup): wait for this warpgroup's turn, then hand
// it to the next; the last hand-over of the block is skipped, so no barrier is
// left half arrived when the block exits.
struct BwTurns {
  int wg, nwg;
  __device__ __forceinline__ void start() const {
    if (wg == nwg - 1) bar_arrive(1, 128 * nwg);   // warpgroup 0 takes the first turn
  }
  __device__ __forceinline__ void take() const { bar_sync(1 + wg, 128 * nwg); }
  __device__ __forceinline__ void pass(bool last) const {
    if (!(last && wg == nwg - 1)) bar_arrive(1 + (wg + 1) % nwg, 128 * nwg);
  }
};

__device__ __forceinline__ uint32_t bw_pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // round to nearest even
  return *reinterpret_cast<uint32_t*>(&v);
}

// `n` 16-byte chunks of shared memory from `addr` on, multiplied by `mul` (a
// bf16 value: the rounded q prescale) and rounded to bf16 in place, `i`-th of
// `stride` threads. bf16x2 products: the exact product of two bf16 values fits
// in fp32, so one rounding to bf16 gives the bits of JAX's fp32 product rounded
// to bf16.
__device__ __forceinline__ void bw_scale_chunks(uint32_t addr, int n, int i, int stride, float mul) {
  const __nv_bfloat162 m2 = __float2bfloat162_rn(mul);
#pragma unroll 4
  for (int c = i; c < n; c += stride) {
    uint4 val;
    bw_ld_shared_v4(addr + 16 * c, val);
    __nv_bfloat162* x = reinterpret_cast<__nv_bfloat162*>(&val);
#pragma unroll
    for (int u = 0; u < 4; ++u) x[u] = __hmul2(x[u], m2);
    bw_st_shared_v4(addr + 16 * c, val);
  }
}

// a warpgroup's 64 x 16 KS fp32 accumulator (rows 16 warp + gid (+ 8), columns
// 8 n + 2 tig (+ 1)) as the register A operand of KS k16 steps, rounded
template <int KS>
__device__ __forceinline__ void bw_pack_a(uint32_t (&a)[KS][4], const float (&x)[8 * KS]) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
#pragma unroll
    for (int q = 0; q < 4; ++q) a[kk][q] = bw_pack(x[8 * kk + 2 * q], x[8 * kk + 2 * q + 1]);
}

// a warpgroup's 64 x 64 accumulator times `mul`, rounded, through its own
// 1024-aligned spent tile `stage` (swizzled chunks) to rows row0.. of dst
// (`rows` of them exist), 16 bytes a thread; `bar`: the warpgroup's barrier
__device__ __forceinline__ void bw_store_tile(const float (&acc)[32], float mul, uint32_t stage, int bar,
                                              __nv_bfloat16* dst, long long row_stride, int row0, int rows,
                                              int t) {
  const int warp = t >> 5, gid = (t & 31) >> 2, tig = t & 3;
  bar_sync(bar, 128);  // every warp of the warpgroup is done with the tile
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const uint32_t v = bw_pack(acc[4 * n + 2 * r] * mul, acc[4 * n + 2 * r + 1] * mul);
      asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(stage + sw128(warp * 16 + gid + 8 * r, n) + tig * 4), "r"(v)
                   : "memory");
    }
  bar_sync(bar, 128);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int idx = t + 128 * i, row = idx >> 3, c = idx & 7;
    if (row0 + row >= rows) continue;
    uint4 val;
    bw_ld_shared_v4(stage + sw128(row, c), val);
    *reinterpret_cast<uint4*>(dst + (long long)(row0 + row) * row_stride + c * 8) = val;
  }
}

__global__ void __launch_bounds__(k5w::THREADS, 1) flash_bwd_dq_wgmma_kernel(
    const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
    const __grid_constant__ CUtensorMap vmap, const __grid_constant__ CUtensorMap gmap,
    const __nv_bfloat16* __restrict__ o, const float* __restrict__ lse, float* __restrict__ scratch,
    __nv_bfloat16* __restrict__ dq, int H, int Lq, int Lk, int lq_pad, long long osb, long long osl,
    long long osh, long long dqsb, long long dqsl, long long dqsh, float qscale, float scale) {
  using namespace k5w;
  extern __shared__ unsigned char bw_smem[];
  const uint32_t base = smem_u32(smem_align_1024(bw_smem));
  const uint32_t sring = base + DQ_RES, srows = base + DQ_ROWS;
  const uint32_t res_bar = base + DQ_BAR, full_bar = res_bar + 8, empty_bar = full_bar + 8 * DQ_STAGES;
  const int tid = threadIdx.x, wg = tid >> 7;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int q0 = blockIdx.x * 64 * NWG;
  const int ntiles = (Lk + 127) / 128;

  if (tid == 0) {
    mbar_init(res_bar, 1);
#pragma unroll
    for (int s = 0; s < DQ_STAGES; ++s) {
      mbar_init(full_bar + 8 * s, 1);
      mbar_init(empty_bar + 8 * s, NWG);
    }
    mbar_init_fence();
  }
  __syncthreads();

  auto issue = [&](int j) {  // key tile j: K and V
    const int stage = j % DQ_STAGES;
    const uint32_t st = sring + stage * DQ_STAGE, bar = full_bar + 8 * stage;
    mbar_expect_tx(bar, DQ_STAGE);
    tma_load_4d(st, &kmap, bar, 0, 128 * j, h, b);
    tma_load_4d(st + T128, &vmap, bar, 0, 128 * j, h, b);
  };
  if (tid == 0) {
    mbar_expect_tx(res_bar, DQ_RES);
    tma_load_4d(base, &qmap, res_bar, 0, q0, h, b);
    tma_load_4d(base + T128, &gmap, res_bar, 0, q0, h, b);
    for (int j = 0; j < DQ_STAGES && j < ntiles; ++j) issue(j);
  }

  const int t = tid & 127, warp = t >> 5, lane = t & 31, gid = lane >> 2, tig = lane & 3;
  const int wbar = 1 + NWG + wg;  // this warpgroup's own named barrier; 1..NWG are the turns
  const BwTurns turns{wg, NWG};
  const uint32_t sq = base + wg * T64, sg = base + T128 + wg * T64, srow = srows + wg * 64 * 8;
  const int row0 = q0 + 64 * wg;  // this warpgroup's first query row
  mbar_wait(res_bar, 0);
  bw_scale_chunks(sq, T64 / 16, t, 128, qscale);
  fence_proxy_async();
  {  // delta = rowsum(g o): two threads a row, 32 elements each; g from shared memory
    const int r = t >> 1, half = t & 1, row = row0 + r;
    float acc = 0.f;
    if (row < Lq) {
      const __nv_bfloat16* orow = o + b * osb + h * osh + (long long)row * osl;
#pragma unroll
      for (int c = 4 * half; c < 4 * half + 4; ++c) {
        uint4 gv;
        bw_ld_shared_v4(sg + sw128(r, c), gv);
        const uint4 ov = *reinterpret_cast<const uint4*>(orow + 8 * c);
        const __nv_bfloat16* gx = reinterpret_cast<const __nv_bfloat16*>(&gv);
        const __nv_bfloat16* ox = reinterpret_cast<const __nv_bfloat16*>(&ov);
#pragma unroll
        for (int u = 0; u < 8; ++u) acc += __bfloat162float(gx[u]) * __bfloat162float(ox[u]);
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (half == 0) {
      const float l = row < Lq ? lse[((long long)b * Lq + row) * H + h] : 0.f;
      asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" ::"r"(srow + 8 * r), "f"(l), "f"(acc) : "memory");
      if (row < Lq) {
        float* sc = scratch + (long long)blockIdx.y * lq_pad + row;
        sc[0] = l;
        sc[(long long)gridDim.y * lq_pad] = acc;
      }
    }
  }
  bar_sync(wbar, 128);  // q is scaled, the rows' LSE and delta are in
  float lse_r[2], del_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r)
    asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n"
                 : "=f"(lse_r[r]), "=f"(del_r[r])
                 : "r"(srow + 8 * (warp * 16 + gid + 8 * r)));

  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  uint32_t a[8][4];  // ds of the last key tile, rounded, as the A operand of dQ += ds K
  float s[64], dp[64];
  auto stage_of = [&](int j) { return sring + (j % DQ_STAGES) * DQ_STAGE; };
  auto issue_s = [&](int j) {  // S = qf K^T and dP = g V^T of key tile j, one group
    const uint32_t sk = stage_of(j), sv = sk + T128;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_m64n128k16_ss(s, wgmma_desc(sq + kk * 32, 16, 1024), wgmma_desc(sk + kk * 32, 16, 1024), kk);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_m64n128k16_ss(dp, wgmma_desc(sg + kk * 32, 16, 1024), wgmma_desc(sv + kk * 32, 16, 1024), kk);
    wgmma_commit();
  };
  auto issue_dq = [&](int j) {  // dQ += ds K of key tile j, one group
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
      wgmma_m64n64k16_rs_tb(acc, a[kk], wgmma_desc(stage_of(j) + kk * 2048, T128, 1024), 1);
    wgmma_commit();
  };
  auto release = [&](int j) {  // key tile j's stage goes back; the last warpgroup refills it
    const int stage = j % DQ_STAGES;
    if (t == 0) mbar_arrive(empty_bar + 8 * stage);
    if (wg == NWG - 1 && t == 0 && j + DQ_STAGES < ntiles) {
      mbar_wait(empty_bar + 8 * stage, (j / DQ_STAGES) & 1);
      issue(j + DQ_STAGES);
    }
  };
  auto form_ds = [&](int j) {  // p = exp2(s - lse) (0 past Lk), ds = p (dp - delta) into a
    wgmma_fence_regs(s);
    wgmma_fence_regs(dp);
    // s[4 n + 0..1] row gid, s[4 n + 2..3] row gid + 8 of the warp's 16, key 128 j + 8 n + 2 tig (+ 1)
    if (128 * j + 128 > Lk) {
#pragma unroll
      for (int e = 0; e < 64; ++e) {
        const int r = (e >> 1) & 1;
        const float p = 128 * j + (e >> 2) * 8 + tig * 2 + (e & 1) < Lk ? bw_ex2(s[e] - lse_r[r]) : 0.f;
        s[e] = p * (dp[e] - del_r[r]);
      }
    } else {
#pragma unroll
      for (int e = 0; e < 64; ++e) {
        const int r = (e >> 1) & 1;
        s[e] = bw_ex2(s[e] - lse_r[r]) * (dp[e] - del_r[r]);
      }
    }
    bw_pack_a<8>(a, s);
  };
  // one turn a key tile: dQ of tile j - 1 and S, dP of tile j issued together, so this
  // warpgroup's exponentials of tile j run while the other's products do
  turns.start();
  mbar_wait(full_bar, 0);
  turns.take();
  wgmma_fence();
  issue_s(0);
  turns.pass(false);
  wgmma_wait<0>();
  form_ds(0);
  for (int j = 1; j < ntiles; ++j) {
    mbar_wait(full_bar + 8 * (j % DQ_STAGES), (j / DQ_STAGES) & 1);
    turns.take();
    wgmma_fence();
    issue_dq(j - 1);
    issue_s(j);
    turns.pass(false);
    wgmma_wait<1>();
    release(j - 1);
    wgmma_wait<0>();
    form_ds(j);
  }
  turns.take();
  wgmma_fence();
  issue_dq(ntiles - 1);
  turns.pass(true);
  wgmma_wait<0>();
  wgmma_fence_regs(acc);
  release(ntiles - 1);
  bw_store_tile(acc, scale, sq, wbar, dq + b * dqsb + h * dqsh, dqsl, row0, Lq, t);
}

__global__ void __launch_bounds__(k5w::THREADS, 1) flash_bwd_dkv_wgmma_kernel(
    const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
    const __grid_constant__ CUtensorMap vmap, const __grid_constant__ CUtensorMap gmap,
    const __grid_constant__ CUtensorMap rowmap, __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
    int H, int Lq, int Lk, long long dksb, long long dksl, long long dksh, long long dvsb, long long dvsl,
    long long dvsh, float qscale) {
  using namespace k5w;
  extern __shared__ unsigned char bw_smem[];
  const uint32_t base = smem_u32(smem_align_1024(bw_smem));
  const uint32_t sring = base + DKV_RES;
  const uint32_t res_bar = base + DKV_BAR, full_bar = res_bar + 8, empty_bar = full_bar + 8 * DKV_STAGES;
  const int tid = threadIdx.x, wg = tid >> 7;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int k0 = blockIdx.x * 64 * NWG;
  const int ntiles = (Lq + 127) / 128;

  if (tid == 0) {
    mbar_init(res_bar, 1);
#pragma unroll
    for (int s = 0; s < DKV_STAGES; ++s) {
      mbar_init(full_bar + 8 * s, 1);
      mbar_init(empty_bar + 8 * s, NWG);
    }
    mbar_init_fence();
  }
  __syncthreads();

  auto issue = [&](int j) {  // query tile j: q, g and the rows' LSE and delta
    const int stage = j % DKV_STAGES;
    const uint32_t st = sring + stage * DKV_STAGE, bar = full_bar + 8 * stage;
    mbar_expect_tx(bar, DKV_STAGE);
    tma_load_4d(st, &qmap, bar, 0, 128 * j, h, b);
    tma_load_4d(st + T128, &gmap, bar, 0, 128 * j, h, b);
    tma_load_3d(st + 2 * T128, &rowmap, bar, 128 * j, blockIdx.y, 0);
  };
  if (tid == 0) {
    mbar_expect_tx(res_bar, DKV_RES);
    tma_load_4d(base, &kmap, res_bar, 0, k0, h, b);
    tma_load_4d(base + T128, &vmap, res_bar, 0, k0, h, b);
    for (int j = 0; j < DKV_STAGES && j < ntiles; ++j) issue(j);
  }

  const int t = tid & 127, tig = t & 3;
  const uint32_t sk = base + wg * T64, sv = base + T128 + wg * T64;  // this warpgroup's 64 keys
  const BwTurns turns{wg, NWG};
  // qf = round(q * qscale) of tile j in place: this warpgroup's 64 of its 128 rows, then
  // the half is handed over (arrive-early barrier 5 + 2 wg + j % 2, which the other waits on)
  auto scale_half = [&](int j) {
    const int stage = j % DKV_STAGES;
    mbar_wait(full_bar + 8 * stage, (j / DKV_STAGES) & 1);
    bw_scale_chunks(sring + stage * DKV_STAGE + wg * T64, T64 / 16, t, 128, qscale);
    fence_proxy_async();
    bar_arrive(SCALED_BAR + 2 * wg + (j & 1), 256);
  };
  float dk_acc[32], dv_acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dk_acc[i] = dv_acc[i] = 0.f;
  uint32_t ap[8][4], as[8][4];  // round(p^T) and round(ds^T) of the last query tile
  float st[64], dpt[64];        // S^T, dP^T: rows the warpgroup's keys, columns the tile's queries
  auto stage_of = [&](int j) { return sring + (j % DKV_STAGES) * DKV_STAGE; };
  auto issue_s = [&](int j) {  // S^T = K qf^T and dP^T = V g^T of query tile j, one group
    const uint32_t sq = stage_of(j), sg = sq + T128;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_m64n128k16_ss(st, wgmma_desc(sk + kk * 32, 16, 1024), wgmma_desc(sq + kk * 32, 16, 1024), kk);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_m64n128k16_ss(dpt, wgmma_desc(sv + kk * 32, 16, 1024), wgmma_desc(sg + kk * 32, 16, 1024), kk);
    wgmma_commit();
  };
  auto issue_dkv = [&](int j) {  // dV += round(p^T) g and dK += ds^T qf of query tile j, one group
    const uint32_t sq = stage_of(j), sg = sq + T128;
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) wgmma_m64n64k16_rs_tb(dv_acc, ap[kk], wgmma_desc(sg + kk * 2048, T128, 1024), 1);
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) wgmma_m64n64k16_rs_tb(dk_acc, as[kk], wgmma_desc(sq + kk * 2048, T128, 1024), 1);
    wgmma_commit();
  };
  auto release = [&](int j) {  // query tile j's stage goes back; the last warpgroup refills it
    const int stage = j % DKV_STAGES;
    if (t == 0) mbar_arrive(empty_bar + 8 * stage);
    if (wg == NWG - 1 && t == 0 && j + DKV_STAGES < ntiles) {
      mbar_wait(empty_bar + 8 * stage, (j / DKV_STAGES) & 1);
      issue(j + DKV_STAGES);
    }
  };
  auto form_ds = [&](int j) {  // p^T = exp2(s^T - lse), ds^T = p^T (dp^T - delta) into ap, as
    wgmma_fence_regs(st);
    wgmma_fence_regs(dpt);
    const uint32_t srow = stage_of(j) + 2 * T128;
    // element e: key 16 warp + gid + 8 ((e >> 1) & 1), query 8 (e >> 2) + 2 tig + (e & 1)
#pragma unroll
    for (int n = 0; n < 16; ++n) {
      float l0, l1, d0, d1;
      asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n" : "=f"(l0), "=f"(l1) : "r"(srow + 4 * (8 * n + 2 * tig)));
      asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n"
                   : "=f"(d0), "=f"(d1)
                   : "r"(srow + 512 + 4 * (8 * n + 2 * tig)));
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int e = 4 * n + u;
        const float p = bw_ex2(st[e] - ((u & 1) ? l1 : l0));
        st[e] = p;
        dpt[e] = p * (dpt[e] - ((u & 1) ? d1 : d0));
      }
    }
    bw_pack_a<8>(ap, st);
    bw_pack_a<8>(as, dpt);
  };
  // one turn a query tile: dV, dK of tile j - 1, then (once they are done and their A
  // operands' registers free) S^T, dP^T of tile j, so each warpgroup's products run as one
  // burst while the other forms its p^T and ds^T
  mbar_wait(res_bar, 0);
  scale_half(0);
  turns.start();
  bar_sync(SCALED_BAR + 2 * (1 - wg), 256);  // the other half of qf of tile 0 is in place
  turns.take();
  wgmma_fence();
  issue_s(0);
  turns.pass(false);
  if (ntiles > 1) scale_half(1);
  wgmma_wait<0>();
  form_ds(0);
  for (int j = 1; j < ntiles; ++j) {
    bar_sync(SCALED_BAR + 2 * (1 - wg) + (j & 1), 256);  // the other half of qf of tile j is in place
    turns.take();
    wgmma_fence();
    issue_dkv(j - 1);
    wgmma_wait<0>();
    wgmma_fence();
    issue_s(j);
    turns.pass(false);
    release(j - 1);
    if (j + 1 < ntiles) scale_half(j + 1);  // while the products run
    wgmma_wait<0>();
    form_ds(j);
  }
  turns.take();
  wgmma_fence();
  issue_dkv(ntiles - 1);
  turns.pass(true);
  wgmma_wait<0>();
  wgmma_fence_regs(dv_acc);
  wgmma_fence_regs(dk_acc);
  release(ntiles - 1);
  const int key0 = k0 + 64 * wg;
  bw_store_tile(dk_acc, kInvLog2E, sk, 1 + NWG + wg, dk + b * dksb + h * dksh, dksl, key0, Lk, t);
  bw_store_tile(dv_acc, 1.f, sv, 1 + NWG + wg, dv + b * dvsb + h * dvsh, dvsl, key0, Lk, t);
}

// q, k, v, o, g [B, L, H, 64] through their strides; bases 16-byte aligned and
// strides in whole 16-byte rows (the wrapper checks q/k/v/o/g; dq/dk/dv are its
// own contiguous outputs, checked here). delta: the [2, B*H, Lq rounded up to 4]
// fp32 scratch.
int launch_bwd_wgmma(const void* q, const void* k, const void* v, const void* o, const void* g, const float* lse,
                     float* scratch, void* dq, void* dk, void* dv, int B, int H, int Lq, int Lk,
                     const long long* st, float qscale, float scale, cudaStream_t stream) {
  using namespace k5w;
  const uintptr_t bases = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                          reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o) |
                          reinterpret_cast<uintptr_t>(g) | reinterpret_cast<uintptr_t>(dq) |
                          reinterpret_cast<uintptr_t>(dk) | reinterpret_cast<uintptr_t>(dv) |
                          reinterpret_cast<uintptr_t>(scratch);
  if (bases % 16) return kErrBadArgument;
  for (int i = 0; i < 24; ++i)
    if (st[i] % 8) return kErrBadArgument;
  static const cudaError_t attr_dq =
      cudaFuncSetAttribute(flash_bwd_dq_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, DQ_SMEM);
  static const cudaError_t attr_dkv =
      cudaFuncSetAttribute(flash_bwd_dkv_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, DKV_SMEM);
  if (attr_dq != cudaSuccess) return (int)attr_dq;
  if (attr_dkv != cudaSuccess) return (int)attr_dkv;
  // q, k, v, g: boxes of 64 d x 128 rows
  CUtensorMap maps[4];
  const void* srcs[4] = {q, k, v, g};
  const int rows[4] = {Lq, Lk, Lk, Lq}, which[4] = {0, 1, 2, 4};
  for (int i = 0; i < 4; ++i) {
    const long long* s = st + 3 * which[i];
    const cuuint64_t dims[4] = {64, (cuuint64_t)rows[i], (cuuint64_t)H, (cuuint64_t)B};
    const cuuint64_t strides[3] = {(cuuint64_t)s[1] * 2, (cuuint64_t)s[2] * 2, (cuuint64_t)s[0] * 2};
    const cuuint32_t box[4] = {64, 128, 1, 1};
    if (const int rc = wgmma_tiled_map(srcs[i], 4, dims, strides, box, &maps[i])) return rc;
  }
  // the scratch's LSE and delta rows: [2][B*H][lq_pad] fp32, boxes of 128 rows x both
  const int lq_pad = (Lq + 3) / 4 * 4;
  CUtensorMap rowmap;
  {
    const cuuint64_t dims[3] = {(cuuint64_t)Lq, (cuuint64_t)B * H, 2};
    const cuuint64_t strides[2] = {(cuuint64_t)lq_pad * 4, (cuuint64_t)B * H * lq_pad * 4};
    const cuuint32_t box[3] = {128, 1, 2};
    if (const int rc = tma_tiled_map(CU_TENSOR_MAP_DATA_TYPE_FLOAT32, CU_TENSOR_MAP_SWIZZLE_NONE, scratch, 3, dims,
                                     strides, box, &rowmap))
      return rc;
  }
  using bf = __nv_bfloat16;
  flash_bwd_dq_wgmma_kernel<<<dim3((Lq + 64 * NWG - 1) / (64 * NWG), B * H), THREADS, DQ_SMEM, stream>>>(
      maps[0], maps[1], maps[2], maps[3], static_cast<const bf*>(o), lse, scratch, static_cast<bf*>(dq), H, Lq,
      Lk, lq_pad, st[9], st[10], st[11], st[15], st[16], st[17], qscale, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dkv_wgmma_kernel<<<dim3((Lk + 64 * NWG - 1) / (64 * NWG), B * H), THREADS, DKV_SMEM, stream>>>(
      maps[0], maps[1], maps[2], maps[3], rowmap, static_cast<bf*>(dk), static_cast<bf*>(dv), H, Lq, Lk, st[18],
      st[19], st[20], st[21], st[22], st[23], qscale);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 at D = 16 (the tiny configs' 16-dim heads; K13 at D = 16 comes here on
// K3's strides) on mma.sync.m16n8k16. At D = 16 the products are small (S and
// dP are one k16 step) and what bounds a good kernel is the exponentials: one
// exp2 per (query, key) pair in each kernel, at 16 a clock an SM on the MUFU,
// against which the FMA kernels above spent a shared-memory load per FMA and
// three __syncthreads a tile. Two kernels as above, each the only writer of its
// outputs, blocks of four warps, each warp 16 rows of the block's 64:
// - dq (flash_bwd_dq_mma16_kernel): a warp holds its 16 query rows' qf and g
//   as register A operands, computes their delta = rowsum(g o) and writes it
//   with the rows' LSE to the scratch ([2, B*H, Lq rounded up to 4] fp32) for
//   the second kernel, then walks 64-key tiles of K and V: S = qf K^T and
//   dP = g V^T (8 + 8 m16n8k16), p = exp2(s - lse) (0 past Lk), ds = p (dp -
//   delta) rounded into the A operand of dQ += ds K (8 more, K read through
//   ldmatrix.trans);
// - dk/dv (flash_bwd_dkv_mma16_kernel): a warp holds its 16 keys' K and V as A
//   operands and walks 64-query tiles of q, g and the rows' LSE and delta: S^T
//   = K qf^T, dP^T = V g^T, p^T and ds^T in registers, dV += round(p^T) g and
//   dK += ds^T qf; qf = q * qscale rounded by bf16x2 products of the fragments
//   (the exact product of two bf16 values fits in fp32, so one rounding gives
//   JAX's fp32 product rounded to bf16).
// Tiles reach shared memory by 16-byte cp.async copies (rows of 32 bytes, the
// two 16-byte halves swapped on rows 4-7 of every 8 so that ldmatrix is free of
// bank conflicts) through a four-stage ring, one __syncthreads a tile; rows past
// Lq or Lk arrive as zeros. Ragged rows need no predicate but one, as in the
// wgmma kernels: the dq kernel masks p past Lk. Tried and dropped: S and dP
// accumulators starting from -lse and -delta (two subtractions an element fewer)
// read 2-6 % slower (the dq kernel took 126 registers, not 115; PERF.md §6).
namespace k5s {
constexpr int WARPS = 4, THREADS = 32 * WARPS, TILE = 64, STAGES = 4;
constexpr int ROWS = TILE * 32;                         // bytes of a 64-row x 16-d bf16 tile
constexpr int DQ_STAGE = 2 * ROWS;                      // K, V
constexpr int DKV_STAGE = 2 * ROWS + 2 * TILE * 4;      // q, g, the rows' LSE and delta
constexpr int DQ_SMEM = STAGES * DQ_STAGE + 128, DKV_SMEM = STAGES * DKV_STAGE + 128;

// byte offset of 16-byte half `c` of row `r` in a tile of 32-byte rows
__device__ __forceinline__ uint32_t sw32(int r, int c) { return (uint32_t)(r * 32 + ((c ^ ((r >> 2) & 1)) << 4)); }
// the B operands of two n-tiles from rows r0..r0+15 read as columns (the keys of S = Q K^T)
__device__ __forceinline__ uint32_t bt_addr(uint32_t tile, int r0, int lane) {
  return tile + sw32(r0 + (lane & 7) + 8 * (lane >> 4), (lane >> 3) & 1);
}
// the B operands of both 8-d n-tiles from rows r0..r0+15 read as the contraction (ldmatrix.trans)
__device__ __forceinline__ uint32_t b_addr(uint32_t tile, int r0, int lane) {
  return tile + sw32(r0 + (lane & 7) + 8 * ((lane >> 3) & 1), lane >> 4);
}
__device__ __forceinline__ void scale2(uint32_t (&x)[4], __nv_bfloat162 m) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    __nv_bfloat162 v = *reinterpret_cast<__nv_bfloat162*>(&x[i]);
    v = __hmul2(v, m);
    x[i] = *reinterpret_cast<uint32_t*>(&v);
  }
}
// a warp's 16 x 64 fp32 accumulator (8 n-tiles) as the A operands of four k16 steps, rounded
__device__ __forceinline__ void pack_a(uint32_t (&a)[4][4], const float (&x)[8][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    a[kk][0] = tt_pack(x[2 * kk][0], x[2 * kk][1]);
    a[kk][1] = tt_pack(x[2 * kk][2], x[2 * kk][3]);
    a[kk][2] = tt_pack(x[2 * kk + 1][0], x[2 * kk + 1][1]);
    a[kk][3] = tt_pack(x[2 * kk + 1][2], x[2 * kk + 1][3]);
  }
}
// the A fragment of rows r0..r0+15 (16 d) from device memory: a[0] row gid, a[1]
// row gid + 8, a[2] / a[3] d 8.. ; zeros past `rows`
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const __nv_bfloat16* x, long long row_stride, int r0,
                                       int rows, int gid, int tig) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + gid + 8 * (i & 1);
    a[i] = r < rows ? *reinterpret_cast<const uint32_t*>(x + r * row_stride + 2 * tig + 8 * (i >> 1)) : 0u;
  }
}
// a warp's 16 x 16 accumulator (two n-tiles) times `mul`, rounded, to rows r0.. of x (`rows` exist)
__device__ __forceinline__ void store_c(const float (&c)[2][4], float mul, __nv_bfloat16* x, long long row_stride,
                                        int r0, int rows, int gid, int tig) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + gid + 8 * i;
    if (r >= rows) continue;
#pragma unroll
    for (int n = 0; n < 2; ++n)
      *reinterpret_cast<uint32_t*>(x + r * row_stride + 8 * n + 2 * tig) =
          tt_pack(c[n][2 * i] * mul, c[n][2 * i + 1] * mul);
  }
}
}  // namespace k5s

__global__ void __launch_bounds__(k5s::THREADS) flash_bwd_dq_mma16_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k, const __nv_bfloat16* __restrict__ v,
    const __nv_bfloat16* __restrict__ o, const __nv_bfloat16* __restrict__ g, const float* __restrict__ lse,
    float* __restrict__ scratch, __nv_bfloat16* __restrict__ dq, int H, int Lq, int Lk, int lq_pad, BwdStrides st,
    float qscale, float scale) {
  using namespace k5s;
  extern __shared__ unsigned char k5s_smem[];
  const uint32_t base = (smem_u32(k5s_smem) + 127u) & ~127u;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, gid = lane >> 2, tig = lane & 3;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int row0 = blockIdx.x * TILE + 16 * warp;  // this warp's first query row
  const __nv_bfloat16* kb = k + b * st.k[0] + h * st.k[2];
  const __nv_bfloat16* vb = v + b * st.v[0] + h * st.v[2];
  const int ntiles = (Lk + TILE - 1) / TILE;

  auto issue = [&](int j) {  // key tile j: one 16-byte half of a K row and of a V row a thread
    const uint32_t sk = base + (j % STAGES) * DQ_STAGE;
    const int r = tid >> 1, c = tid & 1, key = TILE * j + r;
    const long long kr = key < Lk ? key : 0;
    const int n = key < Lk ? 16 : 0;
    tt_cp16_zfill(sk + sw32(r, c), kb + kr * st.k[1] + 8 * c, n);
    tt_cp16_zfill(sk + ROWS + sw32(r, c), vb + kr * st.v[1] + 8 * c, n);
  };
#pragma unroll
  for (int j = 0; j < STAGES - 1; ++j) {
    if (j < ntiles) issue(j);
    tt_cp_commit();
  }

  // this warp's rows: qf and g as A operands; delta = rowsum(g o), the rows' LSE, both to the scratch
  uint32_t aq[4], ag[4], ao[4];
  load_a(aq, q + b * st.q[0] + h * st.q[2], st.q[1], row0, Lq, gid, tig);
  load_a(ag, g + b * st.g[0] + h * st.g[2], st.g[1], row0, Lq, gid, tig);
  load_a(ao, o + b * st.o[0] + h * st.o[2], st.o[1], row0, Lq, gid, tig);
  float lse_r[2], del_r[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    aq[i] = tt_pack(tt_lo(aq[i]) * qscale, tt_hi(aq[i]) * qscale);
    del_r[i & 1] += tt_lo(ag[i]) * tt_lo(ao[i]) + tt_hi(ag[i]) * tt_hi(ao[i]);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    del_r[i] += __shfl_xor_sync(0xffffffffu, del_r[i], 1);
    del_r[i] += __shfl_xor_sync(0xffffffffu, del_r[i], 2);
    const int row = row0 + gid + 8 * i;
    lse_r[i] = row < Lq ? lse[((long long)b * Lq + row) * H + h] : 0.f;
    if (tig == 0 && row < Lq) {
      scratch[(long long)bh * lq_pad + row] = lse_r[i];
      scratch[((long long)gridDim.y + bh) * lq_pad + row] = del_r[i];
    }
  }

  float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
  for (int j = 0; j < ntiles; ++j) {
    tt_cp_wait<STAGES - 2>();
    __syncthreads();  // tile j is in; every warp is done with tile j - 1, whose stage is refilled
    if (j + STAGES - 1 < ntiles) issue(j + STAGES - 1);
    tt_cp_commit();
    const uint32_t sk = base + (j % STAGES) * DQ_STAGE, sv = sk + ROWS;
    float s[8][4], dp[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int u = 0; u < 4; ++u) s[n][u] = dp[n][u] = 0.f;
#pragma unroll
    for (int grp = 0; grp < 4; ++grp) {  // 16 keys: S = qf K^T, dP = g V^T
      uint32_t bk[4], bv[4];
      tt_ldsm(bk, bt_addr(sk, 16 * grp, lane));
      tt_ldsm(bv, bt_addr(sv, 16 * grp, lane));
      tt_mma(s[2 * grp], aq, bk[0], bk[1]);
      tt_mma(s[2 * grp + 1], aq, bk[2], bk[3]);
      tt_mma(dp[2 * grp], ag, bv[0], bv[1]);
      tt_mma(dp[2 * grp + 1], ag, bv[2], bv[3]);
    }
    // s[n][u]: row gid + 8 (u >> 1), key 64 j + 8 n + 2 tig + (u & 1)
    const bool tail = TILE * j + TILE > Lk;
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float p = bw_ex2(s[n][u] - lse_r[u >> 1]);
        if (tail && TILE * j + 8 * n + 2 * tig + (u & 1) >= Lk) p = 0.f;
        s[n][u] = p * (dp[n][u] - del_r[u >> 1]);
      }
    uint32_t a[4][4];
    k5s::pack_a(a, s);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {  // dQ += ds K, 16 keys a step
      uint32_t bb[4];
      tt_ldsm_trans(bb, b_addr(sk, 16 * kk, lane));
      tt_mma(acc[0], a[kk], bb[0], bb[1]);
      tt_mma(acc[1], a[kk], bb[2], bb[3]);
    }
  }
  store_c(acc, scale, dq + b * st.dq[0] + h * st.dq[2], st.dq[1], row0, Lq, gid, tig);
}

__global__ void __launch_bounds__(k5s::THREADS) flash_bwd_dkv_mma16_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k, const __nv_bfloat16* __restrict__ v,
    const __nv_bfloat16* __restrict__ g, const float* __restrict__ scratch, __nv_bfloat16* __restrict__ dk,
    __nv_bfloat16* __restrict__ dv, int H, int Lq, int Lk, int lq_pad, BwdStrides st, float qscale) {
  using namespace k5s;
  extern __shared__ unsigned char k5s_smem[];
  const uint32_t base = (smem_u32(k5s_smem) + 127u) & ~127u;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, gid = lane >> 2, tig = lane & 3;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int key0 = blockIdx.x * TILE + 16 * warp;  // this warp's first key
  const __nv_bfloat16* qb = q + b * st.q[0] + h * st.q[2];
  const __nv_bfloat16* gb = g + b * st.g[0] + h * st.g[2];
  const float* lrow = scratch + (long long)bh * lq_pad;
  const float* drow = scratch + ((long long)gridDim.y + bh) * lq_pad;
  const int ntiles = (Lq + TILE - 1) / TILE;

  auto issue = [&](int j) {  // query tile j: q and g halves; threads 0-31 the rows' LSE and delta (16 bytes each)
    const uint32_t sq = base + (j % STAGES) * DKV_STAGE;
    const int r = tid >> 1, c = tid & 1, row = TILE * j + r;
    const long long qr = row < Lq ? row : 0;
    const int n = row < Lq ? 16 : 0;
    tt_cp16_zfill(sq + sw32(r, c), qb + qr * st.q[1] + 8 * c, n);
    tt_cp16_zfill(sq + ROWS + sw32(r, c), gb + qr * st.g[1] + 8 * c, n);
    if (tid < 32) {
      const int i = tid & 15, first = TILE * j + 4 * i;
      const int bytes = first < Lq ? 4 * min(4, Lq - first) : 0;
      tt_cp16_zfill(sq + 2 * ROWS + (tid >> 4) * TILE * 4 + 16 * i, (tid < 16 ? lrow : drow) + (bytes ? first : 0),
                    bytes);
    }
  };
#pragma unroll
  for (int j = 0; j < STAGES - 1; ++j) {
    if (j < ntiles) issue(j);
    tt_cp_commit();
  }

  uint32_t ak[4], av[4];  // this warp's 16 keys as A operands
  load_a(ak, k + b * st.k[0] + h * st.k[2], st.k[1], key0, Lk, gid, tig);
  load_a(av, v + b * st.v[0] + h * st.v[2], st.v[1], key0, Lk, gid, tig);
  const __nv_bfloat162 qs2 = __float2bfloat162_rn(qscale);
  float dk_acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
  float dv_acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
  for (int j = 0; j < ntiles; ++j) {
    tt_cp_wait<STAGES - 2>();
    __syncthreads();
    if (j + STAGES - 1 < ntiles) issue(j + STAGES - 1);
    tt_cp_commit();
    const uint32_t sq = base + (j % STAGES) * DKV_STAGE, sg = sq + ROWS, srow = sq + 2 * ROWS;
    float s[8][4], dp[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int u = 0; u < 4; ++u) s[n][u] = dp[n][u] = 0.f;
#pragma unroll
    for (int grp = 0; grp < 4; ++grp) {  // 16 queries: S^T = K qf^T, dP^T = V g^T
      uint32_t bq[4], bg[4];
      tt_ldsm(bq, bt_addr(sq, 16 * grp, lane));
      scale2(bq, qs2);
      tt_ldsm(bg, bt_addr(sg, 16 * grp, lane));
      tt_mma(s[2 * grp], ak, bq[0], bq[1]);
      tt_mma(s[2 * grp + 1], ak, bq[2], bq[3]);
      tt_mma(dp[2 * grp], av, bg[0], bg[1]);
      tt_mma(dp[2 * grp + 1], av, bg[2], bg[3]);
    }
    // s[n][u]: key gid + 8 (u >> 1), query 64 j + 8 n + 2 tig + (u & 1)
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      float l0, l1, d0, d1;
      asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n" : "=f"(l0), "=f"(l1) : "r"(srow + 4 * (8 * n + 2 * tig)));
      asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n"
                   : "=f"(d0), "=f"(d1)
                   : "r"(srow + TILE * 4 + 4 * (8 * n + 2 * tig)));
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float p = bw_ex2(s[n][u] - ((u & 1) ? l1 : l0));
        s[n][u] = p;
        dp[n][u] = p * (dp[n][u] - ((u & 1) ? d1 : d0));
      }
    }
    uint32_t ap[4][4], as[4][4];
    k5s::pack_a(ap, s);
    k5s::pack_a(as, dp);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {  // dV += round(p^T) g, dK += ds^T qf, 16 queries a step
      uint32_t bg[4], bq[4];
      tt_ldsm_trans(bg, b_addr(sg, 16 * kk, lane));
      tt_mma(dv_acc[0], ap[kk], bg[0], bg[1]);
      tt_mma(dv_acc[1], ap[kk], bg[2], bg[3]);
      tt_ldsm_trans(bq, b_addr(sq, 16 * kk, lane));
      scale2(bq, qs2);
      tt_mma(dk_acc[0], as[kk], bq[0], bq[1]);
      tt_mma(dk_acc[1], as[kk], bq[2], bq[3]);
    }
  }
  store_c(dk_acc, kInvLog2E, dk + b * st.dk[0] + h * st.dk[2], st.dk[1], key0, Lk, gid, tig);
  store_c(dv_acc, 1.f, dv + b * st.dv[0] + h * st.dv[2], st.dv[1], key0, Lk, gid, tig);
}

// bf16 D = 16: q, k, v, o, g and dq, dk, dv through their strides (16-byte aligned
// bases, strides in whole 16-byte rows); scratch [2, B*H, Lq rounded up to 4]
int launch_bwd_mma16(const void* q, const void* k, const void* v, const void* o, const void* g, const float* lse,
                     float* scratch, void* dq, void* dk, void* dv, int B, int H, int Lq, int Lk,
                     const long long* strides, float qscale, float scale, cudaStream_t stream) {
  using namespace k5s;
  using bf = __nv_bfloat16;
  BwdStrides st;
  memcpy(&st, strides, sizeof(st));
  const uintptr_t bases = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                          reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o) |
                          reinterpret_cast<uintptr_t>(g) | reinterpret_cast<uintptr_t>(dq) |
                          reinterpret_cast<uintptr_t>(dk) | reinterpret_cast<uintptr_t>(dv) |
                          reinterpret_cast<uintptr_t>(scratch);
  if (bases % 16) return kErrBadArgument;
  for (int i = 0; i < 24; ++i)
    if (strides[i] % 8) return kErrBadArgument;
  const int lq_pad = (Lq + 3) / 4 * 4;
  flash_bwd_dq_mma16_kernel<<<dim3((Lq + TILE - 1) / TILE, B * H), THREADS, DQ_SMEM, stream>>>(
      static_cast<const bf*>(q), static_cast<const bf*>(k), static_cast<const bf*>(v), static_cast<const bf*>(o),
      static_cast<const bf*>(g), lse, scratch, static_cast<bf*>(dq), H, Lq, Lk, lq_pad, st, qscale, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dkv_mma16_kernel<<<dim3((Lk + TILE - 1) / TILE, B * H), THREADS, DKV_SMEM, stream>>>(
      static_cast<const bf*>(q), static_cast<const bf*>(k), static_cast<const bf*>(v), static_cast<const bf*>(g),
      scratch, static_cast<bf*>(dk), static_cast<bf*>(dv), H, Lq, Lk, lq_pad, st, qscale);
  return (int)cudaGetLastError();
}

// flash_attention_bwd_x3.cu: fp32 at D = 64 on split-TF32 mma.sync kernels
bool bwd_x3_addressable(const void* q, const void* k, const void* v, const void* o, const void* g,
                        const long long* st);
int launch_bwd_x3(const void* q, const void* k, const void* v, const void* o, const void* g, const float* lse,
                  float* scratch, void* dq, void* dk, void* dv, int B, int H, int Lq, int Lk, const long long* st,
                  float qscale, float scale, cudaStream_t stream);

}  // namespace vs

// q, k, v, o, g: [B, L, H*D] read through `strides` (24 element strides:
// (batch, row, head) of q, k, v, o, g, dq, dk, dv; head-dim stride 1);
// lse: fp32 [B, Lq, H] from K1; delta: fp32 scratch of 2 * B * H * (Lq rounded
// up to 4) (the dq kernel writes each row's delta there, and in bf16 its LSE,
// for the dk/dv kernel on the same stream; fp32 at D = 64: the delta pass). D in {16, 64}: bf16 runs the wgmma
// kernels at 64 and the mma.sync kernels at 16, fp32 the split-TF32 kernels at 64
// (where TMA can address q, k, v, o and g) and the FMA kernels otherwise. route
// (or NULL) receives the kernels that ran: 2 wgmma, 1 mma.sync, 7 split TF32, 0
// FMAs.
extern "C" int vs_flash_attention_packed_bwd(int dtype, int D, const void* q, const void* k,
                                             const void* v, const void* o, const void* g,
                                             const void* lse, void* delta, void* dq, void* dk,
                                             void* dv, int B, int H, int Lq, int Lk,
                                             const long long* strides, float qscale,
                                             float scale, int* route, void* stream) {
  if (D != 16 && D != 64) return vs::kErrUnsupported;
  if (B <= 0 || H <= 0 || Lq <= 0 || Lk <= 0 || B * H > 65535) return vs::kErrBadArgument;
  vs::BwdStrides st;
  memcpy(&st, strides, sizeof(st));
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int r = -1, rc = vs::kErrUnsupported;
  if (dtype == vs::kBFloat16 && D == 64) {
    r = 2;
    rc = vs::launch_bwd_wgmma(q, k, v, o, g, l, dl, dq, dk, dv, B, H, Lq, Lk, strides, qscale, scale, s);
  } else if (dtype == vs::kBFloat16) {
    r = 1;
    rc = vs::launch_bwd_mma16(q, k, v, o, g, l, dl, dq, dk, dv, B, H, Lq, Lk, strides, qscale, scale, s);
  } else if (dtype == vs::kFloat32 && D == 64 && vs::bwd_x3_addressable(q, k, v, o, g, strides)) {
    r = vs::kRouteTf32x3;
    rc = vs::launch_bwd_x3(q, k, v, o, g, l, dl, dq, dk, dv, B, H, Lq, Lk, strides, qscale, scale, s);
  } else if (dtype == vs::kFloat32) {
    r = 0;
    rc = D == 64 ? vs::launch_bwd_fma<64>(q, k, v, o, g, l, dl, dq, dk, dv, B, H, Lq, Lk, st, qscale, scale, s)
                 : vs::launch_bwd_fma<16>(q, k, v, o, g, l, dl, dq, dk, dv, B, H, Lq, Lk, st, qscale, scale, s);
  }
  if (route != nullptr) *route = r;
  return rc;
}
