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
// Design. K5 keeps a warp's 16 rows x 64 accumulators in registers; at D = 512
// a dk + dv tile of 64 keys would be 256 KB, more than an SM's shared memory.
// Here the head dim is spread over the block's eight warps instead, and the
// row tiles are 16 rows (one mma row tile). Two kernels, as on the TPU, each
// the only writer of its outputs (no atomics: the same result every run):
// - dq: a block owns 16 query rows (qf and g staged once, delta = rowsum(g o)
//   written for the second kernel) and walks the keys in tiles of 64;
// - dk/dv: a block owns 16 keys and walks the queries in tiles of 64.
// Per tile the 16 x 64 S and dP tiles are 16 products of one mma n-tile each
// (contracted over D), two per warp, written to shared memory in fp32; all
// threads then form p and ds elementwise (rounded to the input dtype, the JAX
// rounding points); then each warp multiplies them into its own D / 8 output
// columns (dq += ds k; dv += p^T g, dk += ds^T qf). bf16 runs on the tensor
// cores (mma.sync.m16n8k16, fp32 accumulate; the row-major operands of the
// second products come through ldmatrix.trans); fp32 runs FMAs on the same
// tiling (the card-vs-CPU checks). S and dP are computed in both kernels
// (14 L^2 D flops in all), every block re-reads the other side's tiles from
// L2, and copies do not overlap the products yet: a simple kernel that is
// right first; a wgmma / TMA design is later work.
#include <string.h>

#include "common.cuh"

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
// fp32 on FMAs, the same tiling with 16-row tiles on both sides: 256 threads as
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
// fp32 [B, Lq, H] from K3; delta: fp32 [B, Lq, H] scratch (written by the dq
// kernel, read by the dk/dv kernel, on the same stream). D in {80, 512}.
extern "C" int vs_flash_attention_bhld_bwd(int dtype, int D, const void* q, const void* k, const void* v,
                                           const void* o, const void* g, const void* lse, void* delta,
                                           void* dq, void* dk, void* dv, int B, int H, int Lq, int Lk,
                                           const long long* strides, float qscale, float scale,
                                           void* stream) {
  using namespace vs::k13;
  if (B <= 0 || H <= 0 || Lq <= 0 || Lk <= 0 || B * H > 65535) return vs::kErrBadArgument;
  Strides st;
  memcpy(&st, strides, sizeof(st));
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == vs::kBFloat16) {
    if (D == 512) return launch_mma<512>(q, k, v, o, g, l, dl, dq, dk, dv, B, H, Lq, Lk, strides, st, qscale, scale, s);
    if (D == 80) return launch_mma<80>(q, k, v, o, g, l, dl, dq, dk, dv, B, H, Lq, Lk, strides, st, qscale, scale, s);
    return vs::kErrUnsupported;
  }
  if (dtype == vs::kFloat32) {
    if (D == 512) return launch_fma<512>(q, k, v, o, g, l, dl, dq, dk, dv, B, H, Lq, Lk, st, qscale, scale, s);
    if (D == 80) return launch_fma<80>(q, k, v, o, g, l, dl, dq, dk, dv, B, H, Lq, Lk, st, qscale, scale, s);
  }
  return vs::kErrUnsupported;
}
