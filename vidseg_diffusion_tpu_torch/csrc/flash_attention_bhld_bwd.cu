// K13 flash_attention_backward (bhld): the backward of K3 at D = 512 (the
// VAE's one-head mid attention, the only bhld site that trains) and D = 80,
// from the base-2 LSE that K3 writes under a gradient.
//
// Replaces (TPU): vidseg_diffusion_tpu/ops/attention.py:_fa_bwd, the custom
//   VJP of flash_attention, which reshapes [B, H, L, D] to [B*H, L, D] and runs
//   _flash_attention_packed_bwd_impl with heads = 1 (_flash_packed_bwd_dq_kernel
//   and _flash_packed_bwd_dkv_kernel, the pl.pallas_call sites at :993 and
//   :1025). At D = 64 the port's wrapper sends the same gradient to K5
//   (flash_attention_bwd.cu), whose tiles are built around 64 columns.
//
// Math (the JAX kernels', as K5): qf = q*scale*log2(e) rounded to the input
// dtype (the forward's prescale), p = exp2(qf k^T - lse), delta = rowsum(g o)
// in fp32, ds = p (g v^T - delta) rounded to the input dtype, dv = round(p)^T g,
// dq = scale * ds k, dk = ds^T qf / log2(e). q/k/v/o/g and the outputs are read
// and written through (batch, row, head) element strides, as K3 reads them.
//
// What bounds it on the H100: 10 L^2 D flops per (batch, head) (S, dP, dV, dQ,
// dK) on O(L D) bytes, so arithmetic: at the autoencoder step's [2, 1, 5824,
// 512] 3.47e11 flops, 0.351 ms at the bf16 tensor-core peak.
//
// Design. Two kernels, as on the TPU, each the only writer of its outputs (no
// atomics: the same result every run). bf16 at D = 512 runs on wgmma fed by
// TMA (below, before the fp32 kernels): at D = 512 a dk + dv tile of 64 keys
// would be 256 KB of fp32, every register of an SM, so the dk/dv kernel splits
// the head dim of its outputs over two blocks and recomputes S^T and dP^T for
// each. bf16 at D = 80 (CLIP, which no path trains) keeps the simple mma.sync
// kernels that follow: a block owns 16 rows (one mma row tile), the 16 x 64 S
// and dP tiles are parked in shared memory as fp32, and the head dim is spread
// over eight warps; the row-major operands of the second products come through
// ldmatrix.trans. fp32 at D = 512 runs three kernels on the tensor cores with
// split TF32 products (tf32x3_attention.cuh, below the bf16 kernels: dq,
// dk and dv each the only writer of its output, after a delta kernel); fp32 at
// D = 80 runs FMAs on the mma.sync kernels' tiling.
#include <string.h>

#include "common.cuh"
#include "tf32x3_attention.cuh"
#include "wgmma_tile.cuh"

namespace vs {
namespace k13 {

// element strides (batch, row, head) of q, k, v, o, g, dq, dk, dv in that order
struct Strides {
  long long q[3], k[3], v[3], o[3], g[3], dq[3], dk[3], dv[3];
};
static_assert(sizeof(Strides) == 24 * sizeof(long long), "packed strides");

constexpr int THREADS = 256;   // eight warps
constexpr int TR = 16;         // rows a block owns (queries for dq, keys for dk/dv)
constexpr int TW = 64;         // rows of the tiles it walks
constexpr float kInvLog2E = 0.6931471805599453f;

using bf16 = __nv_bfloat16;

// ---------------------------------------------------------------------------
// bf16 on the tensor cores

__device__ __forceinline__ void mma(float c[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t r[4], const void* smem_ptr) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(smem_ptr));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) { return *reinterpret_cast<const uint32_t*>(p); }

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // round to nearest even
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int D>
struct Shape {
  static constexpr int DP = D + 8;   // padded smem row (16 bytes): conflict-free fragments
  static constexpr int V8 = D / 8;   // 16-byte vectors per row
  static constexpr int NT = D / 8;   // mma n-tiles over the head dim
  static constexpr int NPW = ((NT + 7) / 8 + 1) & ~1;  // n-tiles a warp owns (even: x4 loads)
  static constexpr int SP = TW + 4;  // fp32 S / dP row
  static constexpr int AP = TW + 8;  // bf16 p / ds row (A operand)
  static_assert(D % 16 == 0 && NT % 2 == 0, "head dim");
};

// `n` rows x D of a strided bf16 tensor -> padded smem rows (zeros past
// `rows`), optionally multiplied by `mul` and rounded to bf16 (the q prescale)
template <int D>
__device__ __forceinline__ void stage(bf16* tile, const bf16* src, long long row_stride, int r_begin,
                                      int n, int rows, bool scaled, float mul) {
  using S = Shape<D>;
  for (int e = threadIdx.x; e < n * S::V8; e += THREADS) {
    const int r = e / S::V8, c = (e % S::V8) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r_begin + r < rows) {
      val = *reinterpret_cast<const uint4*>(src + (long long)(r_begin + r) * row_stride + c);
      if (scaled) {
        bf16* x = reinterpret_cast<bf16*>(&val);
#pragma unroll
        for (int u = 0; u < 8; ++u) x[u] = __float2bfloat16(__bfloat162float(x[u]) * mul);
      }
    }
    *reinterpret_cast<uint4*>(&tile[r * S::DP + c]) = val;
  }
}

// c = A X^T for one 16 x 8 tile: A = 16 smem rows, X = 8 smem rows, both
// D long (the contraction), row stride DP
template <int D>
__device__ __forceinline__ void product_xt(float c[4], const bf16* a, const bf16* x, int gid, int tig) {
  using S = Shape<D>;
  c[0] = c[1] = c[2] = c[3] = 0.f;
#pragma unroll 8
  for (int ks = 0; ks < D / 16; ++ks) {
    const int col = ks * 16 + tig * 2;
    const uint32_t af[4] = {ld32(a + gid * S::DP + col), ld32(a + (gid + 8) * S::DP + col),
                            ld32(a + gid * S::DP + col + 8), ld32(a + (gid + 8) * S::DP + col + 8)};
    const bf16* xr = x + gid * S::DP + col;
    mma(c, af, ld32(xr), ld32(xr + 8));
  }
}

// acc += A X on this warp's n-tiles nt0 .. nt0 + NPW - 1 of the head dim:
// A = 16 smem rows x TW (the contraction, row stride AP), X = TW smem rows x D
// (row stride DP), its B fragments through ldmatrix.trans
template <int D>
__device__ __forceinline__ void product_ax(float acc[][4], const bf16* a, const bf16* x, int nt0, int lane) {
  using S = Shape<D>;
  const int gid = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int kk = 0; kk < TW / 16; ++kk) {
    const int col = kk * 16 + tig * 2;
    const uint32_t af[4] = {ld32(a + gid * S::AP + col), ld32(a + (gid + 8) * S::AP + col),
                            ld32(a + gid * S::AP + col + 8), ld32(a + (gid + 8) * S::AP + col + 8)};
    // lanes 8i..8i+7 address matrix i: rows kk*16 + (i&1)*8 + (lane&7) at
    // columns (n + (i>>1))*8, the B fragments of n-tiles n and n + 1
    const int mrow = kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7);
#pragma unroll
    for (int j = 0; j < S::NPW; j += 2) {
      const int n = nt0 + j;
      if (n < S::NT) {  // warp-uniform
        uint32_t bx[4];
        ldsm_x4_trans(bx, x + mrow * S::DP + (n + (lane >> 4)) * 8);
        mma(acc[j], af, bx[0], bx[1]);
        mma(acc[j + 1], af, bx[2], bx[3]);
      }
    }
  }
}

// Two of the sixteen 16 x 8 products of a tile for this warp: products 0-7
// are n-tiles of A1 X1^T into f1, 8-15 of A2 X2^T into f2 ([16][SP] fp32).
template <int D>
__device__ __forceinline__ void two_products(const bf16* a1, const bf16* x1, float* f1, const bf16* a2,
                                             const bf16* x2, float* f2, int warp, int lane) {
  using S = Shape<D>;
  const int gid = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int p = warp * 2 + i;
    const bool second = p >= 8;  // warp-uniform
    const int nt = p & 7;
    float c[4];
    product_xt<D>(c, second ? a2 : a1, (second ? x2 : x1) + nt * 8 * S::DP, gid, tig);
    float* f = (second ? f2 : f1) + nt * 8 + tig * 2;
    f[gid * S::SP] = c[0];
    f[gid * S::SP + 1] = c[1];
    f[(gid + 8) * S::SP] = c[2];
    f[(gid + 8) * S::SP + 1] = c[3];
  }
}

// rows row_base + gid (+ 8) of this warp's n-tiles, times `mul`, as bf16 pairs
template <int D>
__device__ __forceinline__ void store_rows(bf16* dst, long long row_stride, int row_base, int rows,
                                           float acc[][4], int nt0, int lane, float mul) {
  using S = Shape<D>;
  const int gid = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int j = 0; j < S::NPW; ++j) {
    const int n = nt0 + j;
    if (n >= S::NT) continue;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row_base + gid + 8 * i;
      if (row < rows)
        *reinterpret_cast<uint32_t*>(dst + (long long)row * row_stride + n * 8 + tig * 2) =
            pack(acc[j][2 * i] * mul, acc[j][2 * i + 1] * mul);
    }
  }
}

template <int D>
struct DqSmem {
  using S = Shape<D>;
  static constexpr size_t bytes = sizeof(bf16) * (2 * TR * S::DP + 2 * TW * S::DP + TR * S::AP) +
                                  sizeof(float) * (2 * TR * S::SP + 2 * TR);
};

template <int D>
__global__ void __launch_bounds__(THREADS) bhld_bwd_dq_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ o, const bf16* __restrict__ g, const float* __restrict__ lse,
    float* __restrict__ delta, bf16* __restrict__ dq, int H, int Lq, int Lk, Strides st, float qscale,
    float scale) {
  using S = Shape<D>;
  extern __shared__ __align__(16) unsigned char k13_smem[];
  bf16* Qs = reinterpret_cast<bf16*>(k13_smem);  // [TR][DP] qf
  bf16* Gs = Qs + TR * S::DP;                    // [TR][DP] g
  bf16* Ks = Gs + TR * S::DP;                    // [TW][DP] this key tile
  bf16* Vs = Ks + TW * S::DP;
  bf16* Ds = Vs + TW * S::DP;                    // [TR][AP] ds, rounded
  float* Sf = reinterpret_cast<float*>(Ds + TR * S::AP);  // [TR][SP] s
  float* Pf = Sf + TR * S::SP;                   // [TR][SP] g v^T
  float* row_lse = Pf + TR * S::SP;
  float* row_delta = row_lse + TR;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int q0 = blockIdx.x * TR;
  const bf16* kb = k + b * st.k[0] + h * st.k[2];
  const bf16* vb = v + b * st.v[0] + h * st.v[2];
  const bf16* ob = o + b * st.o[0] + h * st.o[2];
  const bf16* gb = g + b * st.g[0] + h * st.g[2];

  stage<D>(Qs, q + b * st.q[0] + h * st.q[2], st.q[1], q0, TR, Lq, true, qscale);
  stage<D>(Gs, gb, st.g[1], q0, TR, Lq, false, 1.f);
  for (int r = warp; r < TR; r += THREADS / 32) {  // delta = rowsum(g o): a warp per row
    const int row = q0 + r;
    float acc = 0.f;
    if (row < Lq)
      for (int d = lane; d < D; d += 32)
        acc += __bfloat162float(gb[(long long)row * st.g[1] + d]) * __bfloat162float(ob[(long long)row * st.o[1] + d]);
    acc = warp_sum(acc);
    if (lane == 0) {
      const long long idx = ((long long)b * Lq + row) * H + h;
      row_delta[r] = acc;
      row_lse[r] = row < Lq ? lse[idx] : 0.f;  // ragged rows: g = 0, so ds = 0
      if (row < Lq) delta[idx] = acc;
    }
  }

  const int nt0 = warp * S::NPW;
  float acc[S::NPW][4];
#pragma unroll
  for (int j = 0; j < S::NPW; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int k0 = 0; k0 < Lk; k0 += TW) {
    __syncthreads();  // every warp is done with the previous tile (and the staging above)
    stage<D>(Ks, kb, st.k[1], k0, TW, Lk, false, 1.f);
    stage<D>(Vs, vb, st.v[1], k0, TW, Lk, false, 1.f);
    __syncthreads();
    two_products<D>(Qs, Ks, Sf, Gs, Vs, Pf, warp, lane);  // s = qf k^T, g v^T
    __syncthreads();
    for (int e = tid; e < TR * TW; e += THREADS) {
      const int r = e / TW, c = e % TW;
      const float p = (k0 + c < Lk) ? exp2f(Sf[r * S::SP + c] - row_lse[r]) : 0.f;
      Ds[r * S::AP + c] = __float2bfloat16(p * (Pf[r * S::SP + c] - row_delta[r]));
    }
    __syncthreads();
    product_ax<D>(acc, Ds, Ks, nt0, lane);  // dq += ds k
  }
  store_rows<D>(dq + b * st.dq[0] + h * st.dq[2], st.dq[1], q0, Lq, acc, nt0, lane, scale);
}

template <int D>
struct DkvSmem {
  using S = Shape<D>;
  static constexpr size_t bytes = sizeof(bf16) * (2 * TR * S::DP + 2 * TW * S::DP + 2 * TR * S::AP) +
                                  sizeof(float) * (2 * TR * S::SP + 2 * TW);
};

template <int D>
__global__ void __launch_bounds__(THREADS) bhld_bwd_dkv_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ g, const float* __restrict__ lse, const float* __restrict__ delta,
    bf16* __restrict__ dk, bf16* __restrict__ dv, int H, int Lq, int Lk, Strides st, float qscale) {
  using S = Shape<D>;
  extern __shared__ __align__(16) unsigned char k13_smem[];
  bf16* Ks = reinterpret_cast<bf16*>(k13_smem);  // [TR][DP] this block's keys
  bf16* Vs = Ks + TR * S::DP;
  bf16* Qs = Vs + TR * S::DP;                    // [TW][DP] qf of the query tile
  bf16* Gs = Qs + TW * S::DP;
  bf16* Pt = Gs + TW * S::DP;                    // [TR][AP] p^T, rounded
  bf16* Dt = Pt + TR * S::AP;                    // [TR][AP] ds^T, rounded
  float* St = reinterpret_cast<float*>(Dt + TR * S::AP);  // [TR][SP] s^T (keys x queries)
  float* Pf = St + TR * S::SP;                   // [TR][SP] (g v^T)^T
  float* row_lse = Pf + TR * S::SP;              // [TW]
  float* row_delta = row_lse + TW;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int k0 = blockIdx.x * TR;
  const bf16* qb = q + b * st.q[0] + h * st.q[2];
  const bf16* gb = g + b * st.g[0] + h * st.g[2];

  stage<D>(Ks, k + b * st.k[0] + h * st.k[2], st.k[1], k0, TR, Lk, false, 1.f);
  stage<D>(Vs, v + b * st.v[0] + h * st.v[2], st.v[1], k0, TR, Lk, false, 1.f);

  const int nt0 = warp * S::NPW;
  float acc_dk[S::NPW][4], acc_dv[S::NPW][4];
#pragma unroll
  for (int j = 0; j < S::NPW; ++j)
#pragma unroll
    for (int u = 0; u < 4; ++u) acc_dk[j][u] = acc_dv[j][u] = 0.f;

  for (int q0 = 0; q0 < Lq; q0 += TW) {
    __syncthreads();  // every warp is done with the previous tile (and the staging above)
    stage<D>(Qs, qb, st.q[1], q0, TW, Lq, true, qscale);
    stage<D>(Gs, gb, st.g[1], q0, TW, Lq, false, 1.f);
    if (tid < TW) {
      const int row = q0 + tid;
      const long long idx = ((long long)b * Lq + row) * H + h;
      row_lse[tid] = row < Lq ? lse[idx] : INFINITY;  // ragged rows: p = 0
      row_delta[tid] = row < Lq ? delta[idx] : 0.f;
    }
    __syncthreads();
    two_products<D>(Ks, Qs, St, Vs, Gs, Pf, warp, lane);  // s^T = k qf^T, (g v^T)^T = v g^T
    __syncthreads();
    for (int e = tid; e < TR * TW; e += THREADS) {
      const int r = e / TW, c = e % TW;  // key r, query c
      const float p = (k0 + r < Lk) ? exp2f(St[r * S::SP + c] - row_lse[c]) : 0.f;
      Pt[r * S::AP + c] = __float2bfloat16(p);
      Dt[r * S::AP + c] = __float2bfloat16(p * (Pf[r * S::SP + c] - row_delta[c]));
    }
    __syncthreads();
    product_ax<D>(acc_dv, Pt, Gs, nt0, lane);  // dv += p^T g
    product_ax<D>(acc_dk, Dt, Qs, nt0, lane);  // dk += ds^T qf
  }
  store_rows<D>(dk + b * st.dk[0] + h * st.dk[2], st.dk[1], k0, Lk, acc_dk, nt0, lane, kInvLog2E);
  store_rows<D>(dv + b * st.dv[0] + h * st.dv[2], st.dv[1], k0, Lk, acc_dv, nt0, lane, 1.f);
}

template <int D>
int launch_mma(const void* q, const void* k, const void* v, const void* o, const void* g, const float* lse,
               float* delta, void* dq, void* dk, void* dv, int B, int H, int Lq, int Lk,
               const long long* strides, const Strides& st, float qscale, float scale, cudaStream_t stream) {
  const uintptr_t bases = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                          reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o) |
                          reinterpret_cast<uintptr_t>(g);
  const uintptr_t outs = reinterpret_cast<uintptr_t>(dq) | reinterpret_cast<uintptr_t>(dk) |
                         reinterpret_cast<uintptr_t>(dv);
  if (bases % 16 || outs % 4) return kErrBadArgument;
  for (int i = 0; i < 24; ++i)
    if (strides[i] % (i < 15 ? 8 : 2)) return kErrBadArgument;
  // more than 48 KB of shared memory is opted into once per process
  static const cudaError_t attr_dq = cudaFuncSetAttribute(
      bhld_bwd_dq_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)DqSmem<D>::bytes);
  static const cudaError_t attr_dkv = cudaFuncSetAttribute(
      bhld_bwd_dkv_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)DkvSmem<D>::bytes);
  if (attr_dq != cudaSuccess) return (int)attr_dq;
  if (attr_dkv != cudaSuccess) return (int)attr_dkv;
  const bf16* qt = static_cast<const bf16*>(q);
  const bf16* kt = static_cast<const bf16*>(k);
  const bf16* vt = static_cast<const bf16*>(v);
  const bf16* gt = static_cast<const bf16*>(g);
  bhld_bwd_dq_mma_kernel<D><<<dim3((Lq + TR - 1) / TR, B * H), THREADS, DqSmem<D>::bytes, stream>>>(
      qt, kt, vt, static_cast<const bf16*>(o), gt, lse, delta, static_cast<bf16*>(dq), H, Lq, Lk, st, qscale,
      scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bhld_bwd_dkv_mma_kernel<D><<<dim3((Lk + TR - 1) / TR, B * H), THREADS, DkvSmem<D>::bytes, stream>>>(
      qt, kt, vt, gt, lse, delta, static_cast<bf16*>(dk), static_cast<bf16*>(dv), H, Lq, Lk, st, qscale);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 at D = 512 on wgmma fed by TMA. A 64-row tile of a 512-dim operand is
// eight 64 x 64 panels (8 KB each, 128-byte rows under the 128-byte swizzle);
// q, k, v and g are read in place through rank-4 tiled maps over their (batch,
// row, head) strides; rows past Lq or Lk arrive as zeros. Each block is two
// warpgroups of the same 64 rows (256 threads: a producer warp of its own would
// leave ptxas 168 registers a thread, and a warpgroup's 64 x 256 fp32 output is
// 128 of them) and a ring of STAGES panel stages (`full` / `empty` mbarriers):
// thread 0 asks TMA for the first STAGES loads, and refills a stage with the
// load STAGES later once both warpgroups have handed it back.
// - dq (bhld_bwd_dq_wgmma_kernel): a block owns 64 query rows, their q (scaled
//   and rounded in place once) and g resident (128 KB). Per key tile of 64:
//   phase A walks the eight (K, V) panel pairs, warpgroup 0 contracting S = qf
//   K^T and warpgroup 1 dP = g V^T over the 512 columns (32 x m64n64k16 each);
//   warpgroup 0 turns S into p = exp2(s - lse) (0 past Lk) and hands it to
//   warpgroup 1 in fp32 through shared memory, which forms ds = p (dp - delta),
//   rounds it into the register A operand of dQ += ds K and hands that back;
//   phase B walks the eight K panels again, each warpgroup multiplying ds into
//   its four 64-column panels of dQ (alternate panels: both work on every pair
//   of stages). The 64 x 512 fp32 dQ tile is 128 registers a thread in each
//   warpgroup. S, dP and dQ: 3 L^2 D flops a pair, nothing recomputed.
// - dk/dv (bhld_bwd_dkv_wgmma_kernel): a block owns 64 keys, their K and V
//   resident (128 KB), and one half of the head dim for its outputs: dV and dK
//   of 64 keys x 512 would be 256 KB of fp32, every register of an SM, so each
//   of the two warpgroups holds one 64 x 256 output (128 registers a thread),
//   warpgroup 0 dV, warpgroup 1 dK. Per query tile of 64: phase A walks the
//   eight (q, g) panel pairs, warpgroup 0 contracting S^T = K qf^T (scaling each
//   q panel in place first) and warpgroup 1 dP^T = V g^T; warpgroup 0 forms p^T
//   = exp2(s^T - lse) and hands it to warpgroup 1, which forms ds^T; phase B
//   walks the four (q, g) panels of the block's half again (the first with the
//   tile's LSE and delta, a [2][64] fp32 box of the scratch): dV += round(p^T) g
//   and dK += ds^T qf. S^T and dP^T are recomputed for each half: the dq
//   kernel runs 3 of the L x L x D products a (batch, head) and the dk/dv
//   kernel 2 x (2 + 1), 9 in all, 18 L^2 D flops against the 10 L^2 D of the
//   five products the math needs (PERF.md writes both beside the bound).
// Ragged rows: a query row past Lq has zero q and g and adds nothing; a key past
// Lk is zero in K and V, and the dq kernel masks its p to 0.
namespace w512 {
constexpr int D = 512, PANELS = 8, THREADS = 256, STAGES = 4;
constexpr int PANEL = 64 * 128;                 // 64 rows x 64 d bf16
constexpr int TILE = PANELS * PANEL;            // 64 rows x 512
constexpr int XP_BYTES = 32 * 128 * 4;          // a warpgroup's 64 x 64 fp32 tile, thread-major
constexpr int XA_BYTES = 16 * 128 * 4;          // its register A operand (4 k16 steps)
// dq: q, g resident; stages of a K and a V panel; the p and ds hand-overs; rows
constexpr int DQ_STAGE = 2 * PANEL;
constexpr int DQ_RING = 2 * TILE, DQ_XP = DQ_RING + STAGES * DQ_STAGE, DQ_XA = DQ_XP + XP_BYTES;
constexpr int DQ_ROWS = DQ_XA + XA_BYTES, DQ_BAR = DQ_ROWS + 64 * 8;
constexpr int DQ_SMEM = DQ_BAR + 8 * (1 + 2 * STAGES) + 1024;
// dk/dv: K, V resident; stages of a q and a g panel and a slot for the rows' LSE and delta
constexpr int DKV_STAGE = 2 * PANEL + 1024;
constexpr int DKV_RING = 2 * TILE, DKV_XP = DKV_RING + STAGES * DKV_STAGE, DKV_BAR = DKV_XP + XP_BYTES;
constexpr int DKV_SMEM = DKV_BAR + 8 * (1 + 2 * STAGES) + 1024;
static_assert(DQ_SMEM <= 232448 && DKV_SMEM <= 232448, "shared memory");
}  // namespace w512

__device__ __forceinline__ void ld_v4(uint32_t addr, uint4& v) {
  asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr)
               : "memory");
}

// `n` 16-byte chunks from `addr` on times `mul` (a bf16 value: the rounded q
// prescale), rounded to bf16 in place, the `i`-th of `stride` threads; bf16x2
// products round once, as JAX's fp32 product rounded to bf16 does (K5's
// bw_scale_chunks)
__device__ __forceinline__ void scale_chunks(uint32_t addr, int n, int i, int stride, float mul) {
  const __nv_bfloat162 m2 = __float2bfloat162_rn(mul);
  for (int c = i; c < n; c += stride) {
    uint4 val;
    ld_v4(addr + 16 * c, val);
    __nv_bfloat162* x = reinterpret_cast<__nv_bfloat162*>(&val);
#pragma unroll
    for (int u = 0; u < 4; ++u) x[u] = __hmul2(x[u], m2);
    asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr + 16 * c), "r"(val.x), "r"(val.y),
                 "r"(val.z), "r"(val.w)
                 : "memory");
  }
}

__device__ __forceinline__ void pack_a(uint32_t (&a)[4][4], const float (&x)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int q = 0; q < 4; ++q) a[kk][q] = pack(x[8 * kk + 2 * q], x[8 * kk + 2 * q + 1]);
}

// acc (64 rows x 64 columns a panel, rows 16 warp + gid (+ 8)) times `mul` to
// rows row0.. of dst (`rows` of them exist) at the columns col(m) of panel m
template <class Col>
__device__ __forceinline__ void store_panels(const float (&acc)[4][32], float mul, bf16* dst, long long row_stride,
                                             int row0, int rows, const Col& col, int t) {
  const int warp = t >> 5, gid = (t & 31) >> 2, tig = t & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + warp * 16 + gid + 8 * r;
    if (row >= rows) continue;
    bf16* drow = dst + (long long)row * row_stride;
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int n = 0; n < 8; ++n)
        *reinterpret_cast<uint32_t*>(drow + col(m) + 8 * n + 2 * tig) =
            pack(acc[m][4 * n + 2 * r] * mul, acc[m][4 * n + 2 * r + 1] * mul);
  }
}

__global__ void __launch_bounds__(w512::THREADS, 1) bhld_bwd_dq_wgmma_kernel(
    const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
    const __grid_constant__ CUtensorMap vmap, const __grid_constant__ CUtensorMap gmap, const bf16* __restrict__ o,
    const float* __restrict__ lse, float* __restrict__ scratch, bf16* __restrict__ dq, int H, int Lq, int Lk,
    int lq_pad, long long osb, long long osl, long long osh, long long dqsb, long long dqsl, long long dqsh,
    float qscale, float scale) {
  using namespace w512;
  extern __shared__ unsigned char k13_smem[];
  const uint32_t base = smem_u32(smem_align_1024(k13_smem));
  const uint32_t sq = base, sg = base + TILE, sring = base + DQ_RING;
  const uint32_t sxp = base + DQ_XP, sxa = base + DQ_XA, srows = base + DQ_ROWS;
  const uint32_t res_bar = base + DQ_BAR, full_bar = res_bar + 8, empty_bar = full_bar + 8 * STAGES;
  const int tid = threadIdx.x, wg = tid >> 7;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int q0 = blockIdx.x * 64;
  const int ntiles = (Lk + 63) / 64;

  if (tid == 0) {
    mbar_init(res_bar, 1);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full_bar + 8 * s, 1);
      mbar_init(empty_bar + 8 * s, 2);
    }
    mbar_init_fence();
  }
  __syncthreads();

  // load i of the ring: per key tile (K, V) panels 0-7, then K panels 0-7 again
  const int nloads = 16 * ntiles;
  auto issue = [&](int i) {
    const int stage = i % STAGES, j = i / 16, p = i % 8;
    const uint32_t st = sring + stage * DQ_STAGE, bar = full_bar + 8 * stage;
    const bool with_v = (i % 16) < 8;
    mbar_expect_tx(bar, with_v ? 2 * PANEL : PANEL);
    tma_load_4d(st, &kmap, bar, 64 * p, 64 * j, h, b);
    if (with_v) tma_load_4d(st + PANEL, &vmap, bar, 64 * p, 64 * j, h, b);
  };
  // this warpgroup is done with load i; thread 0 refills its stage with load
  // i + STAGES once the other warpgroup is too
  auto release = [&](int i) {
    const int stage = i % STAGES;
    if ((tid & 127) == 0) mbar_arrive(empty_bar + 8 * stage);
    if (tid == 0 && i + STAGES < nloads) {
      mbar_wait(empty_bar + 8 * stage, (i / STAGES) & 1);
      issue(i + STAGES);
    }
  };
  if (tid == 0) {
    mbar_expect_tx(res_bar, 2 * TILE);
    for (int p = 0; p < PANELS; ++p) {
      tma_load_4d(sq + p * PANEL, &qmap, res_bar, 64 * p, q0, h, b);
      tma_load_4d(sg + p * PANEL, &gmap, res_bar, 64 * p, q0, h, b);
    }
    for (int i = 0; i < STAGES && i < nloads; ++i) issue(i);
  }

  const int t = tid & 127, warp = t >> 5, lane = t & 31, gid = lane >> 2, tig = lane & 3;
  mbar_wait(res_bar, 0);
  scale_chunks(sq, TILE / 16, tid, 256, qscale);
  fence_proxy_async();
  {  // delta = rowsum(g o): four threads a row, 128 elements each; g from shared memory
    const int r = tid >> 2, quarter = tid & 3, row = q0 + r;
    float acc = 0.f;
    if (row < Lq) {
      const bf16* orow = o + b * osb + h * osh + (long long)row * osl;
#pragma unroll 4
      for (int c = 16 * quarter; c < 16 * quarter + 16; ++c) {
        uint4 gv;
        ld_v4(sg + (c >> 3) * PANEL + sw128(r, c & 7), gv);
        const uint4 ov = *reinterpret_cast<const uint4*>(orow + 8 * c);
        const bf16* gx = reinterpret_cast<const bf16*>(&gv);
        const bf16* ox = reinterpret_cast<const bf16*>(&ov);
#pragma unroll
        for (int u = 0; u < 8; ++u) acc += __bfloat162float(gx[u]) * __bfloat162float(ox[u]);
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    if (quarter == 0) {
      const float l = row < Lq ? lse[((long long)b * Lq + row) * H + h] : 0.f;
      asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" ::"r"(srows + 8 * r), "f"(l), "f"(acc) : "memory");
      if (row < Lq) {
        float* sc = scratch + (long long)blockIdx.y * lq_pad + row;
        sc[0] = l;
        sc[(long long)gridDim.y * lq_pad] = acc;
      }
    }
  }
  bar_sync(1, 256);  // qf is in place; the rows' LSE and delta are in
  float lse_r[2], del_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r)
    asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n"
                 : "=f"(lse_r[r]), "=f"(del_r[r])
                 : "r"(srows + 8 * (warp * 16 + gid + 8 * r)));
  // hand-overs (named barriers of both warpgroups): 3 p written, 4 p read, 5 ds
  // written, 6 ds read; each buffer starts empty
  if (wg == 1) bar_arrive(4, 256);
  if (wg == 0) bar_arrive(6, 256);

  const uint32_t sx = wg == 0 ? sq : sg;  // this warpgroup's A operand in phase A
  float acc[4][32];                       // dQ panels 2 m + wg
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[m][i] = 0.f;
  for (int j = 0; j < ntiles; ++j) {
    const bool last = j == ntiles - 1;
    float x[32];  // warpgroup 0: S, warpgroup 1: dP
#pragma unroll
    for (int p = 0; p < PANELS; ++p) {
      const int i = 16 * j + p, stage = i % STAGES;
      const uint32_t st = sring + stage * DQ_STAGE + wg * PANEL;  // K or V panel p
      mbar_wait(full_bar + 8 * stage, (i / STAGES) & 1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_m64n64k16_ss(x, wgmma_desc(sx + p * PANEL + kk * 32, 16, 1024), wgmma_desc(st + kk * 32, 16, 1024),
                           p | kk);
      wgmma_commit();
      wgmma_wait<1>();
      if (p > 0) release(i - 1);
    }
    wgmma_wait<0>();
    wgmma_fence_regs(x);
    release(16 * j + 7);
    uint32_t a[4][4];
    // element e: row 16 warp + gid + 8 ((e >> 1) & 1), key 64 j + 8 (e >> 2) + 2 tig + (e & 1)
    if (wg == 0) {
      const bool tail = 64 * j + 64 > Lk;
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        x[e] = exp2f(x[e] - lse_r[(e >> 1) & 1]);
        if (tail && 64 * j + (e >> 2) * 8 + tig * 2 + (e & 1) >= Lk) x[e] = 0.f;
      }
      bar_sync(4, 256);  // warpgroup 1 has read the last p
#pragma unroll
      for (int e = 0; e < 32; ++e)
        asm volatile("st.shared.f32 [%0], %1;\n" ::"r"(sxp + 4 * (128 * e + t)), "f"(x[e]) : "memory");
      bar_arrive(3, 256);
      bar_sync(5, 256);  // ds is in
#pragma unroll
      for (int e = 0; e < 16; ++e)
        asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(a[e >> 2][e & 3]) : "r"(sxa + 4 * (128 * e + t)) : "memory");
      if (!last) bar_arrive(6, 256);
    } else {
      bar_sync(3, 256);  // p is in
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        float p;
        asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(p) : "r"(sxp + 4 * (128 * e + t)) : "memory");
        x[e] = p * (x[e] - del_r[(e >> 1) & 1]);  // ds
      }
      if (!last) bar_arrive(4, 256);
      pack_a(a, x);
      bar_sync(6, 256);  // warpgroup 0 has read the last ds
#pragma unroll
      for (int e = 0; e < 16; ++e)
        asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(sxa + 4 * (128 * e + t)), "r"(a[e >> 2][e & 3]) : "memory");
      bar_arrive(5, 256);
    }
    // phase B: dQ panel 2 m + wg += ds K[:, panel], K panels 0..7 of the tile again
#pragma unroll
    for (int p = 0; p < PANELS; ++p) {
      const int i = 16 * j + 8 + p, stage = i % STAGES;
      mbar_wait(full_bar + 8 * stage, (i / STAGES) & 1);
      if ((p & 1) == wg) {
        const uint32_t sk = sring + stage * DQ_STAGE;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_m64n64k16_rs_tb(acc[p >> 1], a[kk], wgmma_desc(sk + kk * 2048, PANEL, 1024), 1);
        wgmma_commit();
        wgmma_wait<0>();
        wgmma_fence_regs(acc[p >> 1]);
      }
      release(i);
    }
  }
  store_panels(acc, scale, dq + b * dqsb + h * dqsh, dqsl, q0, Lq, [&](int m) { return 64 * (2 * m + wg); }, t);
}

__global__ void __launch_bounds__(w512::THREADS, 1) bhld_bwd_dkv_wgmma_kernel(
    const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
    const __grid_constant__ CUtensorMap vmap, const __grid_constant__ CUtensorMap gmap,
    const __grid_constant__ CUtensorMap rowmap, bf16* __restrict__ dk, bf16* __restrict__ dv, int H, int Lq,
    int Lk, long long dksb, long long dksl, long long dksh, long long dvsb, long long dvsl, long long dvsh,
    float qscale) {
  using namespace w512;
  extern __shared__ unsigned char k13_smem[];
  const uint32_t base = smem_u32(smem_align_1024(k13_smem));
  const uint32_t sk = base, sv = base + TILE, sring = base + DKV_RING, sxp = base + DKV_XP;
  const uint32_t res_bar = base + DKV_BAR, full_bar = res_bar + 8, empty_bar = full_bar + 8 * STAGES;
  const int tid = threadIdx.x, wg = tid >> 7;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int k0 = blockIdx.x * 64, half = blockIdx.z;  // the block's 256 output columns: 256 half ..
  const int ntiles = (Lq + 63) / 64;

  if (tid == 0) {
    mbar_init(res_bar, 1);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full_bar + 8 * s, 1);
      mbar_init(empty_bar + 8 * s, 2);
    }
    mbar_init_fence();
  }
  __syncthreads();

  // load i of the ring: per query tile (q, g) panels 0-7, then the half's four
  // (q, g) panels again, the first with the tile's LSE and delta
  const int nloads = 12 * ntiles;
  auto issue = [&](int i) {
    const int stage = i % STAGES, j = i / 12, n = i % 12;
    const int p = n < 8 ? n : 4 * half + n - 8;
    const uint32_t st = sring + stage * DKV_STAGE, bar = full_bar + 8 * stage;
    mbar_expect_tx(bar, 2 * PANEL + (n == 8 ? 512 : 0));
    tma_load_4d(st, &qmap, bar, 64 * p, 64 * j, h, b);
    tma_load_4d(st + PANEL, &gmap, bar, 64 * p, 64 * j, h, b);
    if (n == 8) tma_load_3d(st + 2 * PANEL, &rowmap, bar, 64 * j, blockIdx.y, 0);
  };
  auto release = [&](int i) {  // as in the dq kernel
    const int stage = i % STAGES;
    if ((tid & 127) == 0) mbar_arrive(empty_bar + 8 * stage);
    if (tid == 0 && i + STAGES < nloads) {
      mbar_wait(empty_bar + 8 * stage, (i / STAGES) & 1);
      issue(i + STAGES);
    }
  };
  if (tid == 0) {
    mbar_expect_tx(res_bar, 2 * TILE);
    for (int p = 0; p < PANELS; ++p) {
      tma_load_4d(sk + p * PANEL, &kmap, res_bar, 64 * p, k0, h, b);
      tma_load_4d(sv + p * PANEL, &vmap, res_bar, 64 * p, k0, h, b);
    }
    for (int i = 0; i < STAGES && i < nloads; ++i) issue(i);
  }

  const int t = tid & 127, tig = t & 3;
  const int wbar = 1 + wg;  // this warpgroup's own barrier
  mbar_wait(res_bar, 0);
  if (wg == 1) bar_arrive(4, 256);  // the p hand-over starts empty

  const uint32_t sa = wg == 0 ? sk : sv;  // this warpgroup's A operand in phase A
  float acc[4][32];                       // warpgroup 0: dV, 1: dK, columns 256 half + 64 m ..
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[m][i] = 0.f;
  for (int j = 0; j < ntiles; ++j) {
    const bool last = j == ntiles - 1;
    float x[32];  // warpgroup 0: S^T, warpgroup 1: dP^T (rows keys, columns the tile's queries)
#pragma unroll
    for (int p = 0; p < PANELS; ++p) {
      const int i = 12 * j + p, stage = i % STAGES;
      const uint32_t st = sring + stage * DKV_STAGE;
      mbar_wait(full_bar + 8 * stage, (i / STAGES) & 1);
      if (wg == 0) {  // qf = round(q * qscale), panel p, in place
        scale_chunks(st, PANEL / 16, t, 128, qscale);
        fence_proxy_async();
        bar_sync(wbar, 128);
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_m64n64k16_ss(x, wgmma_desc(sa + p * PANEL + kk * 32, 16, 1024),
                           wgmma_desc(st + wg * PANEL + kk * 32, 16, 1024), p | kk);
      wgmma_commit();
      wgmma_wait<1>();
      if (p > 0) release(i - 1);
    }
    wgmma_wait<0>();
    wgmma_fence_regs(x);
    release(12 * j + 7);
    // phase B's first stage carries the tile's LSE (and delta 256 bytes on)
    const int i8 = 12 * j + 8;
    const uint32_t srow = sring + (i8 % STAGES) * DKV_STAGE + 2 * PANEL;
    mbar_wait(full_bar + 8 * (i8 % STAGES), (i8 / STAGES) & 1);
    uint32_t a[4][4];
    // element e: key 16 warp + gid + 8 ((e >> 1) & 1), query 8 (e >> 2) + 2 tig + (e & 1)
    if (wg == 0) {
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        float l0, l1;
        asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n" : "=f"(l0), "=f"(l1) : "r"(srow + 4 * (8 * n + 2 * tig)));
#pragma unroll
        for (int u = 0; u < 4; ++u) x[4 * n + u] = exp2f(x[4 * n + u] - ((u & 1) ? l1 : l0));
      }
      bar_sync(4, 256);  // warpgroup 1 has read the last p^T
#pragma unroll
      for (int e = 0; e < 32; ++e)
        asm volatile("st.shared.f32 [%0], %1;\n" ::"r"(sxp + 4 * (128 * e + t)), "f"(x[e]) : "memory");
      bar_arrive(3, 256);
    } else {
      bar_sync(3, 256);  // p^T is in
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        float d0, d1;
        asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n"
                     : "=f"(d0), "=f"(d1)
                     : "r"(srow + 256 + 4 * (8 * n + 2 * tig)));
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int e = 4 * n + u;
          float p;
          asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(p) : "r"(sxp + 4 * (128 * e + t)) : "memory");
          x[e] = p * (x[e] - ((u & 1) ? d1 : d0));  // ds^T
        }
      }
      if (!last) bar_arrive(4, 256);
    }
    pack_a(a, x);
    // phase B: dV (warpgroup 0) += round(p^T) g, dK (1) += ds^T qf, panels 4 half + m
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int i = i8 + m, stage = i % STAGES;
      const uint32_t st = sring + stage * DKV_STAGE;
      if (m > 0) mbar_wait(full_bar + 8 * stage, (i / STAGES) & 1);
      if (wg == 1) {  // qf of this panel, in place
        scale_chunks(st, PANEL / 16, t, 128, qscale);
        fence_proxy_async();
        bar_sync(wbar, 128);
      }
      const uint32_t sb = wg == 0 ? st + PANEL : st;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_m64n64k16_rs_tb(acc[m], a[kk], wgmma_desc(sb + kk * 2048, PANEL, 1024), 1);
      wgmma_commit();
      wgmma_wait<0>();
      wgmma_fence_regs(acc[m]);
      release(i);
    }
  }
  if (wg == 0)
    store_panels(acc, 1.f, dv + b * dvsb + h * dvsh, dvsl, k0, Lk, [&](int m) { return 256 * half + 64 * m; }, t);
  else
    store_panels(acc, kInvLog2E, dk + b * dksb + h * dksh, dksl, k0, Lk,
                 [&](int m) { return 256 * half + 64 * m; }, t);
}

// q, k, v, o, g [B, H, L, 512] through their strides (bases 16-byte aligned,
// strides in whole 16-byte rows); scratch: [2, B*H, Lq rounded up to 4] fp32.
int launch_wgmma512(const void* q, const void* k, const void* v, const void* o, const void* g, const float* lse,
                    float* scratch, void* dq, void* dk, void* dv, int B, int H, int Lq, int Lk, const long long* st,
                    float qscale, float scale, cudaStream_t stream) {
  using namespace w512;
  const uintptr_t bases = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                          reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o) |
                          reinterpret_cast<uintptr_t>(g) | reinterpret_cast<uintptr_t>(scratch);
  const uintptr_t outs = reinterpret_cast<uintptr_t>(dq) | reinterpret_cast<uintptr_t>(dk) |
                         reinterpret_cast<uintptr_t>(dv);
  if (bases % 16 || outs % 4) return kErrBadArgument;
  for (int i = 0; i < 24; ++i)
    if (st[i] % (i < 15 ? 8 : 2)) return kErrBadArgument;
  static const cudaError_t attr_dq =
      cudaFuncSetAttribute(bhld_bwd_dq_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, DQ_SMEM);
  static const cudaError_t attr_dkv =
      cudaFuncSetAttribute(bhld_bwd_dkv_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, DKV_SMEM);
  if (attr_dq != cudaSuccess) return (int)attr_dq;
  if (attr_dkv != cudaSuccess) return (int)attr_dkv;
  // q, k, v, g: boxes of 64 d x 64 rows
  CUtensorMap maps[4];
  const void* srcs[4] = {q, k, v, g};
  const int rows[4] = {Lq, Lk, Lk, Lq}, which[4] = {0, 1, 2, 4};
  for (int i = 0; i < 4; ++i) {
    const long long* s = st + 3 * which[i];
    const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)rows[i], (cuuint64_t)H, (cuuint64_t)B};
    const cuuint64_t strides[3] = {(cuuint64_t)s[1] * 2, (cuuint64_t)s[2] * 2, (cuuint64_t)s[0] * 2};
    const cuuint32_t box[4] = {64, 64, 1, 1};
    if (const int rc = wgmma_tiled_map(srcs[i], 4, dims, strides, box, &maps[i])) return rc;
  }
  const int lq_pad = (Lq + 3) / 4 * 4;
  CUtensorMap rowmap;  // the scratch's LSE and delta rows: boxes of 64 rows x both
  {
    const cuuint64_t dims[3] = {(cuuint64_t)Lq, (cuuint64_t)B * H, 2};
    const cuuint64_t strides[2] = {(cuuint64_t)lq_pad * 4, (cuuint64_t)B * H * lq_pad * 4};
    const cuuint32_t box[3] = {64, 1, 2};
    if (const int rc = tma_tiled_map(CU_TENSOR_MAP_DATA_TYPE_FLOAT32, CU_TENSOR_MAP_SWIZZLE_NONE, scratch, 3, dims,
                                     strides, box, &rowmap))
      return rc;
  }
  bhld_bwd_dq_wgmma_kernel<<<dim3((Lq + 63) / 64, B * H), w512::THREADS, DQ_SMEM, stream>>>(
      maps[0], maps[1], maps[2], maps[3], static_cast<const bf16*>(o), lse, scratch, static_cast<bf16*>(dq), H, Lq,
      Lk, lq_pad, st[9], st[10], st[11], st[15], st[16], st[17], qscale, scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bhld_bwd_dkv_wgmma_kernel<<<dim3((Lk + 63) / 64, B * H, 2), w512::THREADS, DKV_SMEM, stream>>>(
      maps[0], maps[1], maps[2], maps[3], rowmap, static_cast<bf16*>(dk), static_cast<bf16*>(dv), H, Lq, Lk,
      st[18], st[19], st[20], st[21], st[22], st[23], qscale);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// fp32 at D = 512 on split TF32 products (tf32x3_attention.cuh). Three kernels,
// each the only writer of its output: dq (own rows the queries: S and dP, then
// dQ += dS K), dk (own rows the keys: S^T and dP^T, then dK += dS^T qf) and dv
// (S^T alone, then dV += P^T g; up to 64 queries with the head dim split over
// its warpgroups): 16 L^2 D flops executed against the 10 the math needs (S
// three times, dP twice); a 64 x 512 fp32 output is all two warpgroups'
// accumulators, so dk and dv do not share a block. delta = rowsum(g o) comes
// first, one warp a row, into the scratch.
__global__ void __launch_bounds__(256) bhld_bwd_delta_kernel(const float* __restrict__ o, const float* __restrict__ g,
                                                             float* __restrict__ delta, int H, int Lq, int lq_pad,
                                                             long long osb, long long osl, long long osh,
                                                             long long gsb, long long gsl, long long gsh) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * 8 + warp, bh = blockIdx.y, b = bh / H, h = bh % H;
  if (row >= Lq) return;
  const float4* orow = reinterpret_cast<const float4*>(o + b * osb + h * osh + (long long)row * osl);
  const float4* grow = reinterpret_cast<const float4*>(g + b * gsb + h * gsh + (long long)row * gsl);
  float acc = 0.f;
#pragma unroll
  for (int c = lane; c < 128; c += 32) {
    const float4 x = orow[c], y = grow[c];
    acc += x.x * y.x + x.y * y.y + x.z * y.z + x.w * y.w;
  }
  acc = warp_sum(acc);
  if (lane == 0) delta[(long long)bh * lq_pad + row] = acc;
}

template <int ROLE, bool SPLIT>
__global__ void __launch_bounds__(256, 1) bhld_bwd_tf32x3_kernel(
    const __grid_constant__ CUtensorMap own1, const __grid_constant__ CUtensorMap own2,
    const __grid_constant__ CUtensorMap oth1, const __grid_constant__ CUtensorMap oth2,
    const __grid_constant__ CUtensorMap cmap, const x3::Args args) {
  x3::attention_body<ROLE, SPLIT>(&own1, &own2, &oth1, &oth2, &cmap, args);
}

// q, k, v, o, g fp32 [B, H, L, 512] through their strides (bases 16-byte
// aligned, strides whole 16-byte rows); scratch: [B*H, Lq rounded up to 4] fp32
// for delta.
int launch_tf32x3(const void* q, const void* k, const void* v, const void* o, const void* g, const float* lse,
                  float* scratch, void* dq, void* dk, void* dv, int B, int H, int Lq, int Lk, const long long* st,
                  float qscale, float scale, cudaStream_t stream) {
  const void* bases[6] = {q, k, v, o, g, scratch};
  if (!x3::rows_ok(bases, 6, st, 15)) return kErrBadArgument;
  // q, k, v, g: boxes of 32 columns x 64 rows; q also x 128 (the dv kernel's other rows)
  CUtensorMap q64, q128, k64, v64, g64;
  if (const int rc = x3::tiled_map(q, st, Lq, H, B, 64, &q64)) return rc;
  if (const int rc = x3::tiled_map(q, st, Lq, H, B, 128, &q128)) return rc;
  if (const int rc = x3::tiled_map(k, st + 3, Lk, H, B, 64, &k64)) return rc;
  if (const int rc = x3::tiled_map(v, st + 6, Lk, H, B, 64, &v64)) return rc;
  if (const int rc = x3::tiled_map(g, st + 12, Lq, H, B, 64, &g64)) return rc;
  const int lq_pad = (Lq + 3) / 4 * 4;
  bhld_bwd_delta_kernel<<<dim3((Lq + 7) / 8, B * H), 256, 0, stream>>>(
      static_cast<const float*>(o), static_cast<const float*>(g), scratch, H, Lq, lq_pad, st[9], st[10], st[11],
      st[12], st[13], st[14]);
  if (const cudaError_t err = cudaGetLastError()) return (int)err;
  float* l = const_cast<float*>(lse);
  // the maps of each role: own1, own2, other1, other2, C
  const x3::Args aq{H, Lq, Lk, lq_pad, qscale, scale, static_cast<float*>(dq), st[15], st[16], st[17], l, scratch};
  if (const int rc = x3::launch<x3::kDq, false>(bhld_bwd_tf32x3_kernel<x3::kDq, false>, Lq, B * H, stream, q64, g64,
                                                k64, v64, k64, aq))
    return rc;
  const x3::Args ak{H, Lk, Lq, lq_pad, qscale, kInvLog2E, static_cast<float*>(dk), st[18], st[19], st[20], l, scratch};
  if (const int rc = x3::launch<x3::kDk, false>(bhld_bwd_tf32x3_kernel<x3::kDk, false>, Lk, B * H, stream, k64, v64,
                                                q64, g64, q64, ak))
    return rc;
  const x3::Args av{H, Lk, Lq, lq_pad, qscale, 1.f, static_cast<float*>(dv), st[21], st[22], st[23], l, nullptr};
  // up to 64 queries the dv kernel splits the head dim over its warpgroups (half the steps)
  return Lq <= 64 ? x3::launch<x3::kDv, true>(bhld_bwd_tf32x3_kernel<x3::kDv, true>, Lk, B * H, stream, k64, k64,
                                              q64, q64, g64, av)
                  : x3::launch<x3::kDv, false>(bhld_bwd_tf32x3_kernel<x3::kDv, false>, Lk, B * H, stream, k64, k64,
                                               q128, q128, g64, av);
}

// ---------------------------------------------------------------------------
// fp32 at D = 80 on FMAs, the same tiling with 16-row tiles on both sides: 256 threads as
// 16 rows x 16 column groups; a thread owns row r and the head-dim columns
// cg + 16 j. fp32 rows are padded by one float (conflict-free columns).

template <int D>
struct FmaSmem {
  static constexpr int DS = D + 1;
  static constexpr int PS = TR + 1;
  static constexpr size_t bytes = sizeof(float) * (4 * TR * DS + 2 * TR * PS + 2 * TR);
};

template <int D>
__device__ __forceinline__ void stage_f32(float* tile, const float* src, long long row_stride, int r_begin,
                                          int rows, bool scaled, float mul) {
  for (int e = threadIdx.x; e < TR * D; e += THREADS) {
    const int r = e / D, d = e % D;
    float val = 0.f;
    if (r_begin + r < rows) {
      val = src[(long long)(r_begin + r) * row_stride + d];
      if (scaled) val *= mul;
    }
    tile[r * FmaSmem<D>::DS + d] = val;
  }
}

// the dot products of row r of a and of row c of x, and of row r of a2 and of
// row c of x2, over D
template <int D>
__device__ __forceinline__ void dot2(const float* a, const float* x, const float* a2, const float* x2, int r,
                                     int c, float& s1, float& s2) {
  constexpr int DS = FmaSmem<D>::DS;
  s1 = s2 = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    s1 = fmaf(a[r * DS + d], x[c * DS + d], s1);
    s2 = fmaf(a2[r * DS + d], x2[c * DS + d], s2);
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS) bhld_bwd_dq_fma_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ o, const float* __restrict__ g, const float* __restrict__ lse,
    float* __restrict__ delta, float* __restrict__ dq, int H, int Lq, int Lk, Strides st, float qscale,
    float scale) {
  using S = FmaSmem<D>;
  extern __shared__ __align__(16) unsigned char k13_smem[];
  float* Qs = reinterpret_cast<float*>(k13_smem);
  float* Gs = Qs + TR * S::DS;
  float* Ks = Gs + TR * S::DS;
  float* Vs = Ks + TR * S::DS;
  float* Ds = Vs + TR * S::DS;  // [TR][PS] ds
  float* row_lse = Ds + TR * S::PS;
  float* row_delta = row_lse + TR;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int r = tid >> 4, cg = tid & 15;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int q0 = blockIdx.x * TR;
  const float* kb = k + b * st.k[0] + h * st.k[2];
  const float* vb = v + b * st.v[0] + h * st.v[2];
  const float* ob = o + b * st.o[0] + h * st.o[2];
  const float* gb = g + b * st.g[0] + h * st.g[2];

  stage_f32<D>(Qs, q + b * st.q[0] + h * st.q[2], st.q[1], q0, Lq, true, qscale);
  stage_f32<D>(Gs, gb, st.g[1], q0, Lq, false, 1.f);
  for (int rr = warp; rr < TR; rr += THREADS / 32) {
    const int row = q0 + rr;
    float acc = 0.f;
    if (row < Lq)
      for (int d = lane; d < D; d += 32) acc += gb[(long long)row * st.g[1] + d] * ob[(long long)row * st.o[1] + d];
    acc = warp_sum(acc);
    if (lane == 0) {
      const long long idx = ((long long)b * Lq + row) * H + h;
      row_delta[rr] = acc;
      row_lse[rr] = row < Lq ? lse[idx] : 0.f;
      if (row < Lq) delta[idx] = acc;
    }
  }

  float acc[D / 16];
#pragma unroll
  for (int j = 0; j < D / 16; ++j) acc[j] = 0.f;
  for (int k0 = 0; k0 < Lk; k0 += TR) {
    __syncthreads();
    stage_f32<D>(Ks, kb, st.k[1], k0, Lk, false, 1.f);
    stage_f32<D>(Vs, vb, st.v[1], k0, Lk, false, 1.f);
    __syncthreads();
    float s, dp;
    dot2<D>(Qs, Ks, Gs, Vs, r, cg, s, dp);
    const float p = (k0 + cg < Lk) ? exp2f(s - row_lse[r]) : 0.f;
    Ds[r * S::PS + cg] = p * (dp - row_delta[r]);
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < TR; ++c) {
      const float ds = Ds[r * S::PS + c];
#pragma unroll
      for (int j = 0; j < D / 16; ++j) acc[j] = fmaf(ds, Ks[c * S::DS + cg + 16 * j], acc[j]);
    }
  }
  const int row = q0 + r;
  if (row < Lq) {
    float* drow = dq + b * st.dq[0] + h * st.dq[2] + (long long)row * st.dq[1];
#pragma unroll
    for (int j = 0; j < D / 16; ++j) drow[cg + 16 * j] = acc[j] * scale;
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS) bhld_bwd_dkv_fma_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ g, const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dk, float* __restrict__ dv, int H, int Lq, int Lk, Strides st, float qscale) {
  using S = FmaSmem<D>;
  extern __shared__ __align__(16) unsigned char k13_smem[];
  float* Ks = reinterpret_cast<float*>(k13_smem);
  float* Vs = Ks + TR * S::DS;
  float* Qs = Vs + TR * S::DS;
  float* Gs = Qs + TR * S::DS;
  float* Pt = Gs + TR * S::DS;  // [TR keys][PS] p^T
  float* Dt = Pt + TR * S::PS;  // ds^T
  float* row_lse = Dt + TR * S::PS;
  float* row_delta = row_lse + TR;

  const int tid = threadIdx.x;
  const int r = tid >> 4, cg = tid & 15;  // key r; in the products, query cg
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int k0 = blockIdx.x * TR;
  const float* qb = q + b * st.q[0] + h * st.q[2];
  const float* gb = g + b * st.g[0] + h * st.g[2];

  stage_f32<D>(Ks, k + b * st.k[0] + h * st.k[2], st.k[1], k0, Lk, false, 1.f);
  stage_f32<D>(Vs, v + b * st.v[0] + h * st.v[2], st.v[1], k0, Lk, false, 1.f);
  float acc_dk[D / 16], acc_dv[D / 16];
#pragma unroll
  for (int j = 0; j < D / 16; ++j) acc_dk[j] = acc_dv[j] = 0.f;
  for (int q0 = 0; q0 < Lq; q0 += TR) {
    __syncthreads();
    stage_f32<D>(Qs, qb, st.q[1], q0, Lq, true, qscale);
    stage_f32<D>(Gs, gb, st.g[1], q0, Lq, false, 1.f);
    if (tid < TR) {
      const int row = q0 + tid;
      const long long idx = ((long long)b * Lq + row) * H + h;
      row_lse[tid] = row < Lq ? lse[idx] : INFINITY;  // ragged rows: p = 0
      row_delta[tid] = row < Lq ? delta[idx] : 0.f;
    }
    __syncthreads();
    float s, dp;
    dot2<D>(Ks, Qs, Vs, Gs, r, cg, s, dp);
    const float p = (k0 + r < Lk) ? exp2f(s - row_lse[cg]) : 0.f;
    Pt[r * S::PS + cg] = p;
    Dt[r * S::PS + cg] = p * (dp - row_delta[cg]);
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < TR; ++c) {
      const float pv = Pt[r * S::PS + c], ds = Dt[r * S::PS + c];
#pragma unroll
      for (int j = 0; j < D / 16; ++j) {
        acc_dv[j] = fmaf(pv, Gs[c * S::DS + cg + 16 * j], acc_dv[j]);
        acc_dk[j] = fmaf(ds, Qs[c * S::DS + cg + 16 * j], acc_dk[j]);
      }
    }
  }
  const int key = k0 + r;
  if (key < Lk) {
    float* dkrow = dk + b * st.dk[0] + h * st.dk[2] + (long long)key * st.dk[1];
    float* dvrow = dv + b * st.dv[0] + h * st.dv[2] + (long long)key * st.dv[1];
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      dkrow[cg + 16 * j] = acc_dk[j] * kInvLog2E;
      dvrow[cg + 16 * j] = acc_dv[j];
    }
  }
}

template <int D>
int launch_fma(const void* q, const void* k, const void* v, const void* o, const void* g, const float* lse,
               float* delta, void* dq, void* dk, void* dv, int B, int H, int Lq, int Lk, const Strides& st,
               float qscale, float scale, cudaStream_t stream) {
  static const cudaError_t attr_dq = cudaFuncSetAttribute(
      bhld_bwd_dq_fma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)FmaSmem<D>::bytes);
  static const cudaError_t attr_dkv = cudaFuncSetAttribute(
      bhld_bwd_dkv_fma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)FmaSmem<D>::bytes);
  if (attr_dq != cudaSuccess) return (int)attr_dq;
  if (attr_dkv != cudaSuccess) return (int)attr_dkv;
  const float* qt = static_cast<const float*>(q);
  const float* kt = static_cast<const float*>(k);
  const float* vt = static_cast<const float*>(v);
  const float* gt = static_cast<const float*>(g);
  bhld_bwd_dq_fma_kernel<D><<<dim3((Lq + TR - 1) / TR, B * H), THREADS, FmaSmem<D>::bytes, stream>>>(
      qt, kt, vt, static_cast<const float*>(o), gt, lse, delta, static_cast<float*>(dq), H, Lq, Lk, st,
      qscale, scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bhld_bwd_dkv_fma_kernel<D><<<dim3((Lk + TR - 1) / TR, B * H), THREADS, FmaSmem<D>::bytes, stream>>>(
      qt, kt, vt, gt, lse, delta, static_cast<float*>(dk), static_cast<float*>(dv), H, Lq, Lk, st, qscale);
  return (int)cudaGetLastError();
}

}  // namespace k13
}  // namespace vs

// q, k, v, o, g: [B, H, L, D] read through `strides` (24 element strides:
// (batch, row, head) of q, k, v, o, g, dq, dk, dv; head-dim stride 1); lse:
// fp32 [B, Lq, H] from K3; delta: fp32 scratch of 2 * B * H * (Lq rounded up
// to 4) (written by the dq kernel, read by the dk/dv kernel, on the same
// stream). D in {80, 512}; route (or NULL) receives the kernels that ran: 2
// wgmma (bf16 D = 512), 1 mma.sync (bf16 D = 80), 7 split TF32 on wgmma (fp32
// D = 512; 16-byte aligned rows, or kErrBadArgument), 0 fp32 FMAs (D = 80).
extern "C" int vs_flash_attention_bhld_bwd(int dtype, int D, const void* q, const void* k, const void* v,
                                           const void* o, const void* g, const void* lse, void* delta,
                                           void* dq, void* dk, void* dv, int B, int H, int Lq, int Lk,
                                           const long long* strides, float qscale, float scale, int* route,
                                           void* stream) {
  using namespace vs::k13;
  if (B <= 0 || H <= 0 || Lq <= 0 || Lk <= 0 || B * H > 65535) return vs::kErrBadArgument;
  Strides st;
  memcpy(&st, strides, sizeof(st));
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int r = -1, rc = vs::kErrUnsupported;
  if (dtype == vs::kBFloat16 && D == 512) {
    r = 2;
    rc = launch_wgmma512(q, k, v, o, g, l, dl, dq, dk, dv, B, H, Lq, Lk, strides, qscale, scale, s);
  } else if (dtype == vs::kBFloat16 && D == 80) {
    r = 1;
    rc = launch_mma<80>(q, k, v, o, g, l, dl, dq, dk, dv, B, H, Lq, Lk, strides, st, qscale, scale, s);
  } else if (dtype == vs::kFloat32 && D == 512) {
    r = vs::kRouteTf32x3;
    rc = launch_tf32x3(q, k, v, o, g, l, dl, dq, dk, dv, B, H, Lq, Lk, strides, qscale, scale, s);
  } else if (dtype == vs::kFloat32 && D == 80) {
    r = 0;
    rc = launch_fma<80>(q, k, v, o, g, l, dl, dq, dk, dv, B, H, Lq, Lk, st, qscale, scale, s);
  }
  if (route != nullptr) *route = r;
  return rc;
}
