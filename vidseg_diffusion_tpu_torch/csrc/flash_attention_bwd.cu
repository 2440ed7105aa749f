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
// the second kernel), dk/dv walk the query tiles of their 64 keys. Both read
// q/k/v/o/g through (batch, row, head) element strides, as K1 does. The
// ragged key tail gets p = 0; ragged query rows compute on zeros (lse = +inf
// in the dk/dv kernel, so their p is 0) and are never stored.
//
// What bounds it on the H100: ~14*D flops per (query, key) pair (S and
// g v^T recomputed in both kernels, plus the three products) on O(L*D)
// bytes, so arithmetic, as for K1; the [L, L] logits never reach device
// memory. bf16 runs on the tensor cores (mma.sync.m16n8k16, FA2 register
// layout: an accumulator tile becomes the A operand of the next product,
// the transposed operands come from ldmatrix.trans); fp32 runs fp32 FMAs on
// shared-memory tiles (the fp32 UNet check). No copy/compute overlap yet.
#include <string.h>

#include "common.cuh"

namespace vs {

// element strides (batch, row, head) of the eight tensors, in this order
struct BwdStrides {
  long long q[3], k[3], v[3], o[3], g[3], dq[3], dk[3], dv[3];
};
static_assert(sizeof(BwdStrides) == 24 * sizeof(long long), "packed strides");

constexpr int BW_D = 64;         // head dim (every spatial UNet site)
constexpr int BW_T = 64;         // query rows and key rows per tile
constexpr int BW_S = BW_D + 1;   // padded fp32 smem row: conflict-free columns
constexpr float kInvLog2E = 0.6931471805599453f;

// ---------------------------------------------------------------------------
// fp32: FMAs on shared-memory tiles, 256 threads as a 16x16 grid, 4x4
// register micro-tiles (rows ty + 16 i, columns tx + 16 j).

template <typename T>
__global__ void __launch_bounds__(256) flash_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ o, const T* __restrict__ g, const float* __restrict__ lse,
    float* __restrict__ delta, T* __restrict__ dq, int H, int Lq, int Lk, BwdStrides st,
    float qscale, float scale) {
  extern __shared__ float smem[];
  float* Qs = smem;                  // [BW_T][BW_S] qf
  float* Gs = Qs + BW_T * BW_S;      // g
  float* Ks = Gs + BW_T * BW_S;
  float* Vs = Ks + BW_T * BW_S;
  float* Ds = Vs + BW_T * BW_S;      // ds, rounded to T
  float* row_lse = Ds + BW_T * BW_S;
  float* row_delta = row_lse + BW_T;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int q0 = blockIdx.x * BW_T;
  const T* qb = q + b * st.q[0] + h * st.q[2];
  const T* kb = k + b * st.k[0] + h * st.k[2];
  const T* vb = v + b * st.v[0] + h * st.v[2];
  const T* ob = o + b * st.o[0] + h * st.o[2];
  const T* gb = g + b * st.g[0] + h * st.g[2];
  T* dqb = dq + b * st.dq[0] + h * st.dq[2];

  for (int e = tid; e < BW_T * BW_D; e += 256) {
    const int r = e / BW_D, d = e % BW_D;
    float qv = 0.f, gv = 0.f;
    if (q0 + r < Lq) {
      qv = round_to<T>(to_f<T>(qb[(long long)(q0 + r) * st.q[1] + d]) * qscale);
      gv = to_f<T>(gb[(long long)(q0 + r) * st.g[1] + d]);
    }
    Qs[r * BW_S + d] = qv;
    Gs[r * BW_S + d] = gv;
  }
  for (int r = warp; r < BW_T; r += 8) {  // delta: one warp per row
    const int row = q0 + r;
    float acc = 0.f;
    if (row < Lq)
      for (int d = lane; d < BW_D; d += 32)
        acc += to_f<T>(gb[(long long)row * st.g[1] + d]) * to_f<T>(ob[(long long)row * st.o[1] + d]);
    acc = warp_sum(acc);
    if (lane == 0) {
      row_delta[r] = acc;
      row_lse[r] = row < Lq ? lse[((long long)b * Lq + row) * H + h] : 0.f;
      if (row < Lq) delta[((long long)b * Lq + row) * H + h] = acc;
    }
  }

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < Lk; k0 += BW_T) {
    __syncthreads();  // previous tile's reads done (and the staging above)
    for (int e = tid; e < BW_T * BW_D; e += 256) {
      const int r = e / BW_D, d = e % BW_D;
      float kv = 0.f, vv = 0.f;
      if (k0 + r < Lk) {
        kv = to_f<T>(kb[(long long)(k0 + r) * st.k[1] + d]);
        vv = to_f<T>(vb[(long long)(k0 + r) * st.v[1] + d]);
      }
      Ks[r * BW_S + d] = kv;
      Vs[r * BW_S + d] = vv;
    }
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < BW_D; ++d) {
      float qv[4], gv[4], kv[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = Qs[(ty + 16 * i) * BW_S + d];
        gv[i] = Gs[(ty + 16 * i) * BW_S + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kv[j] = Ks[(tx + 16 * j) * BW_S + d];
        vv[j] = Vs[(tx + 16 * j) * BW_S + d];
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
        Ds[r * BW_S + c] = round_to<T>(p * (dp[i][j] - dl));
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BW_T; ++kk) {
      float dsv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = Ds[(ty + 16 * i) * BW_S + kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[kk * BW_S + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(dsv[i], kv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= Lq) continue;
    T* drow = dqb + (long long)row * st.dq[1];
#pragma unroll
    for (int j = 0; j < 4; ++j) drow[tx + 16 * j] = from_f<T>(acc[i][j] * scale);
  }
}

template <typename T>
__global__ void __launch_bounds__(256) flash_bwd_dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ g, const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dk, T* __restrict__ dv, int H, int Lq, int Lk, BwdStrides st,
    float qscale) {
  extern __shared__ float smem[];
  float* Ks = smem;                  // [BW_T][BW_S] this block's keys
  float* Vs = Ks + BW_T * BW_S;
  float* Qs = Vs + BW_T * BW_S;      // qf of the current query tile
  float* Gs = Qs + BW_T * BW_S;
  float* Ps = Gs + BW_T * BW_S;      // p [query][key], rounded to T
  float* Ds = Ps + BW_T * BW_S;      // ds [query][key], rounded to T
  float* row_lse = Ds + BW_T * BW_S;
  float* row_delta = row_lse + BW_T;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int k0 = blockIdx.x * BW_T;
  const T* qb = q + b * st.q[0] + h * st.q[2];
  const T* kb = k + b * st.k[0] + h * st.k[2];
  const T* vb = v + b * st.v[0] + h * st.v[2];
  const T* gb = g + b * st.g[0] + h * st.g[2];

  for (int e = tid; e < BW_T * BW_D; e += 256) {
    const int r = e / BW_D, d = e % BW_D;
    float kv = 0.f, vv = 0.f;
    if (k0 + r < Lk) {
      kv = to_f<T>(kb[(long long)(k0 + r) * st.k[1] + d]);
      vv = to_f<T>(vb[(long long)(k0 + r) * st.v[1] + d]);
    }
    Ks[r * BW_S + d] = kv;
    Vs[r * BW_S + d] = vv;
  }

  float acc_dk[4][4], acc_dv[4][4];  // rows: keys ty + 16 i; columns: d = tx + 16 j
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc_dk[i][j] = acc_dv[i][j] = 0.f;

  for (int q0 = 0; q0 < Lq; q0 += BW_T) {
    __syncthreads();
    for (int e = tid; e < BW_T * BW_D; e += 256) {
      const int r = e / BW_D, d = e % BW_D;
      float qv = 0.f, gv = 0.f;
      if (q0 + r < Lq) {
        qv = round_to<T>(to_f<T>(qb[(long long)(q0 + r) * st.q[1] + d]) * qscale);
        gv = to_f<T>(gb[(long long)(q0 + r) * st.g[1] + d]);
      }
      Qs[r * BW_S + d] = qv;
      Gs[r * BW_S + d] = gv;
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
    for (int d = 0; d < BW_D; ++d) {
      float qv[4], gv[4], kv[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = Qs[(ty + 16 * i) * BW_S + d];
        gv[i] = Gs[(ty + 16 * i) * BW_S + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kv[j] = Ks[(tx + 16 * j) * BW_S + d];
        vv[j] = Vs[(tx + 16 * j) * BW_S + d];
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
        Ps[r * BW_S + c] = round_to<T>(p);
        Ds[r * BW_S + c] = round_to<T>(p * (dp[i][j] - dl));
      }
    }
    __syncthreads();

    // dv += p^T g, dk += ds^T qf over this tile's queries
#pragma unroll 4
    for (int qq = 0; qq < BW_T; ++qq) {
      float pv[4], dsv[4], gv[4], qv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pv[i] = Ps[qq * BW_S + ty + 16 * i];
        dsv[i] = Ds[qq * BW_S + ty + 16 * i];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        gv[j] = Gs[qq * BW_S + tx + 16 * j];
        qv[j] = Qs[qq * BW_S + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc_dv[i][j] = fmaf(pv[i], gv[j], acc_dv[i][j]);
          acc_dk[i][j] = fmaf(dsv[i], qv[j], acc_dk[i][j]);
        }
    }
  }

  T* dkb = dk + b * st.dk[0] + h * st.dk[2];
  T* dvb = dv + b * st.dv[0] + h * st.dv[2];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + ty + 16 * i;
    if (key >= Lk) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      dkb[(long long)key * st.dk[1] + tx + 16 * j] = from_f<T>(acc_dk[i][j] * kInvLog2E);
      dvb[(long long)key * st.dv[1] + tx + 16 * j] = from_f<T>(acc_dv[i][j]);
    }
  }
}

template <typename T>
int launch_bwd_fma(const void* q, const void* k, const void* v, const void* o, const void* g,
                   const float* lse, float* delta, void* dq, void* dk, void* dv, int B, int H,
                   int Lq, int Lk, const BwdStrides& st, float qscale, float scale,
                   cudaStream_t stream) {
  const size_t smem_dq = sizeof(float) * (5 * BW_T * BW_S + 2 * BW_T);
  const size_t smem_dkv = sizeof(float) * (6 * BW_T * BW_S + 2 * BW_T);
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_dq);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_dkv);
  if (err != cudaSuccess) return (int)err;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* gt = static_cast<const T*>(g);
  flash_bwd_dq_kernel<T><<<dim3((Lq + BW_T - 1) / BW_T, B * H), 256, smem_dq, stream>>>(
      qt, kt, vt, static_cast<const T*>(o), gt, lse, delta, static_cast<T*>(dq), H, Lq, Lk, st,
      qscale, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dkv_kernel<T><<<dim3((Lk + BW_T - 1) / BW_T, B * H), 256, smem_dkv, stream>>>(
      qt, kt, vt, gt, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), H, Lq, Lk, st,
      qscale);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores: mma.sync.m16n8k16 (bf16 in, fp32 accumulate),
// 4 warps per block, each owning 16 rows of the block's 64 (query rows in
// the dq kernel, key rows in the dk/dv kernel). Fragment layouts as in K1
// (flash_attention.cu): an A fragment of rows r0 = 16*warp + lane/4 and
// r0 + 8 is read from a padded smem row; a B fragment for X^T comes straight
// from X's rows; a B fragment of a row-major X (the k dim along rows) comes
// from ldmatrix.trans. 16-byte global loads: row strides in whole 8-element
// vectors and 16-byte aligned bases (the wrapper and the entry check).

__device__ __forceinline__ void bw_mma(float c[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void bw_ldmatrix_x4_trans(uint32_t r[4], const void* smem_ptr) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(smem_ptr));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ uint32_t bw_pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // round to nearest even
  return *reinterpret_cast<uint32_t*>(&v);
}

constexpr int MB_DP = BW_D + 8;   // padded bf16 smem row (16 bytes)
constexpr int MB_V8 = BW_D / 8;   // 16-byte vectors per row
constexpr int MB_KS = BW_D / 16;  // k-steps over the head dim
constexpr int MB_NT = BW_T / 8;   // n-tiles over a 64-row tile
constexpr int MB_NO = BW_D / 8;   // n-tiles over the head dim

// A fragments (16 rows of this warp x 64) from a padded smem tile
__device__ __forceinline__ void bw_load_a(uint32_t f[MB_KS][4], const __nv_bfloat16* tile, int r0,
                                          int tig) {
#pragma unroll
  for (int ks = 0; ks < MB_KS; ++ks) {
    const int c = ks * 16 + tig * 2;
    f[ks][0] = *reinterpret_cast<const uint32_t*>(&tile[r0 * MB_DP + c]);
    f[ks][1] = *reinterpret_cast<const uint32_t*>(&tile[(r0 + 8) * MB_DP + c]);
    f[ks][2] = *reinterpret_cast<const uint32_t*>(&tile[r0 * MB_DP + c + 8]);
    f[ks][3] = *reinterpret_cast<const uint32_t*>(&tile[(r0 + 8) * MB_DP + c + 8]);
  }
}

// c[j] += A * X^T for the 8 n-tiles of the 64 rows of X (smem tile)
__device__ __forceinline__ void bw_mma_xt(float c[MB_NT][4], uint32_t a[MB_KS][4],
                                          const __nv_bfloat16* x, int gid, int tig) {
#pragma unroll
  for (int ks = 0; ks < MB_KS; ++ks) {
#pragma unroll
    for (int j = 0; j < MB_NT; ++j) {
      const __nv_bfloat16* row = &x[(j * 8 + gid) * MB_DP + ks * 16 + tig * 2];
      bw_mma(c[j], a[ks], *reinterpret_cast<const uint32_t*>(row),
             *reinterpret_cast<const uint32_t*>(row + 8));
    }
  }
}

// acc += A * X with A from accumulator tiles c (16 rows x 64, the k dim) and
// X a row-major smem tile [64 k rows][64]
__device__ __forceinline__ void bw_mma_ax(float acc[MB_NO][4], float c[MB_NT][4],
                                          const __nv_bfloat16* x, int lane) {
#pragma unroll
  for (int kk = 0; kk < BW_T / 16; ++kk) {
    const uint32_t a[4] = {bw_pack(c[2 * kk][0], c[2 * kk][1]), bw_pack(c[2 * kk][2], c[2 * kk][3]),
                           bw_pack(c[2 * kk + 1][0], c[2 * kk + 1][1]),
                           bw_pack(c[2 * kk + 1][2], c[2 * kk + 1][3])};
    const int mrow = kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7);
#pragma unroll
    for (int n = 0; n < MB_NO; n += 2) {
      uint32_t bx[4];
      bw_ldmatrix_x4_trans(bx, &x[mrow * MB_DP + (n + (lane >> 4)) * 8]);
      bw_mma(acc[n], a, bx[0], bx[1]);
      bw_mma(acc[n + 1], a, bx[2], bx[3]);
    }
  }
}

// 64 rows x 64 of a strided global tensor -> padded smem (zeros past `rows`),
// optionally multiplied by `mul` and rounded to bf16 (the q prescale)
__device__ __forceinline__ void bw_stage(__nv_bfloat16* tile, const __nv_bfloat16* src,
                                         long long row_stride, int r_begin, int rows, int tid,
                                         bool scaled, float mul) {
  for (int e = tid; e < BW_T * MB_V8; e += 128) {
    const int r = e / MB_V8, c = (e % MB_V8) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r_begin + r < rows) {
      val = *reinterpret_cast<const uint4*>(src + (long long)(r_begin + r) * row_stride + c);
      if (scaled) {
        __nv_bfloat16* x = reinterpret_cast<__nv_bfloat16*>(&val);
#pragma unroll
        for (int u = 0; u < 8; ++u) x[u] = __float2bfloat16(__bfloat162float(x[u]) * mul);
      }
    }
    *reinterpret_cast<uint4*>(&tile[r * MB_DP + c]) = val;
  }
}

__device__ __forceinline__ void bw_store_rows(__nv_bfloat16* dst, long long row_stride, int row_base,
                                              int r0, int rows, float acc[MB_NO][4], int tig,
                                              float mul) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row_base + r0 + 8 * i;
    if (row >= rows) continue;
    __nv_bfloat16* drow = dst + (long long)row * row_stride;
#pragma unroll
    for (int n = 0; n < MB_NO; ++n)
      *reinterpret_cast<uint32_t*>(drow + n * 8 + tig * 2) =
          bw_pack(acc[n][2 * i] * mul, acc[n][2 * i + 1] * mul);
  }
}

__global__ void __launch_bounds__(128) flash_bwd_dq_mma_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ o,
    const __nv_bfloat16* __restrict__ g, const float* __restrict__ lse,
    float* __restrict__ delta, __nv_bfloat16* __restrict__ dq, int H, int Lq, int Lk,
    BwdStrides st, float qscale, float scale) {
  __shared__ __align__(16) __nv_bfloat16 Qs[BW_T * MB_DP];
  __shared__ __align__(16) __nv_bfloat16 Gs[BW_T * MB_DP];
  __shared__ __align__(16) __nv_bfloat16 Ks[BW_T * MB_DP];
  __shared__ __align__(16) __nv_bfloat16 Vs[BW_T * MB_DP];
  __shared__ float row_lse[BW_T], row_delta[BW_T];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int q0 = blockIdx.x * BW_T;
  const __nv_bfloat16* qb = q + b * st.q[0] + h * st.q[2];
  const __nv_bfloat16* kb = k + b * st.k[0] + h * st.k[2];
  const __nv_bfloat16* vb = v + b * st.v[0] + h * st.v[2];
  const __nv_bfloat16* ob = o + b * st.o[0] + h * st.o[2];
  const __nv_bfloat16* gb = g + b * st.g[0] + h * st.g[2];

  bw_stage(Qs, qb, st.q[1], q0, Lq, tid, true, qscale);
  bw_stage(Gs, gb, st.g[1], q0, Lq, tid, false, 1.f);
  {  // delta = rowsum(g o): two threads per row, 32 elements each
    const int r = tid >> 1, half = tid & 1, row = q0 + r;
    float acc = 0.f;
    if (row < Lq) {
#pragma unroll
      for (int c = half * 32; c < half * 32 + 32; c += 8) {
        const uint4 gv = *reinterpret_cast<const uint4*>(gb + (long long)row * st.g[1] + c);
        const uint4 ov = *reinterpret_cast<const uint4*>(ob + (long long)row * st.o[1] + c);
        const __nv_bfloat16* gx = reinterpret_cast<const __nv_bfloat16*>(&gv);
        const __nv_bfloat16* ox = reinterpret_cast<const __nv_bfloat16*>(&ov);
#pragma unroll
        for (int u = 0; u < 8; ++u) acc += __bfloat162float(gx[u]) * __bfloat162float(ox[u]);
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (half == 0) {
      const long long idx = ((long long)b * Lq + row) * H + h;
      row_delta[r] = acc;
      row_lse[r] = row < Lq ? lse[idx] : 0.f;
      if (row < Lq) delta[idx] = acc;
    }
  }
  __syncthreads();

  const int r0 = warp * 16 + gid;
  uint32_t qf[MB_KS][4], gf[MB_KS][4];
  bw_load_a(qf, Qs, r0, tig);
  bw_load_a(gf, Gs, r0, tig);
  const float lse_r[2] = {row_lse[r0], row_lse[r0 + 8]};
  const float del_r[2] = {row_delta[r0], row_delta[r0 + 8]};

  float acc[MB_NO][4];
#pragma unroll
  for (int n = 0; n < MB_NO; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int k0 = 0; k0 < Lk; k0 += BW_T) {
    __syncthreads();  // every warp is done with the previous K/V tile
    bw_stage(Ks, kb, st.k[1], k0, Lk, tid, false, 1.f);
    bw_stage(Vs, vb, st.v[1], k0, Lk, tid, false, 1.f);
    __syncthreads();

    float s[MB_NT][4], dp[MB_NT][4];
#pragma unroll
    for (int j = 0; j < MB_NT; ++j)
#pragma unroll
      for (int u = 0; u < 4; ++u) s[j][u] = dp[j][u] = 0.f;
    bw_mma_xt(s, qf, Ks, gid, tig);   // qf k^T
    bw_mma_xt(dp, gf, Vs, gid, tig);  // g v^T
    // s[j][0..1]: row r0, s[j][2..3]: row r0 + 8, keys k0 + 8j + 2 tig + {0, 1}
#pragma unroll
    for (int j = 0; j < MB_NT; ++j)
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float p = (k0 + j * 8 + tig * 2 + (u & 1) < Lk) ? exp2f(s[j][u] - lse_r[u >> 1]) : 0.f;
        s[j][u] = p * (dp[j][u] - del_r[u >> 1]);  // ds; rounded to bf16 in bw_mma_ax
      }
    bw_mma_ax(acc, s, Ks, lane);  // dq += ds k
  }
  bw_store_rows(dq + b * st.dq[0] + h * st.dq[2], st.dq[1], q0, r0, Lq, acc, tig, scale);
}

__global__ void __launch_bounds__(128) flash_bwd_dkv_mma_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ g,
    const float* __restrict__ lse, const float* __restrict__ delta,
    __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int H, int Lq, int Lk,
    BwdStrides st, float qscale) {
  __shared__ __align__(16) __nv_bfloat16 Qs[BW_T * MB_DP];
  __shared__ __align__(16) __nv_bfloat16 Gs[BW_T * MB_DP];
  __shared__ float row_lse[BW_T], row_delta[BW_T];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int k0 = blockIdx.x * BW_T;
  const __nv_bfloat16* qb = q + b * st.q[0] + h * st.q[2];
  const __nv_bfloat16* gb = g + b * st.g[0] + h * st.g[2];

  // this warp's 16 keys (rows r0, r0 + 8) as A fragments, staged through Qs/Gs
  bw_stage(Qs, k + b * st.k[0] + h * st.k[2], st.k[1], k0, Lk, tid, false, 1.f);
  bw_stage(Gs, v + b * st.v[0] + h * st.v[2], st.v[1], k0, Lk, tid, false, 1.f);
  __syncthreads();
  const int r0 = warp * 16 + gid;
  uint32_t kf[MB_KS][4], vf[MB_KS][4];
  bw_load_a(kf, Qs, r0, tig);
  bw_load_a(vf, Gs, r0, tig);
  const bool key_ok[2] = {k0 + r0 < Lk, k0 + r0 + 8 < Lk};

  float acc_dk[MB_NO][4], acc_dv[MB_NO][4];
#pragma unroll
  for (int n = 0; n < MB_NO; ++n)
#pragma unroll
    for (int u = 0; u < 4; ++u) acc_dk[n][u] = acc_dv[n][u] = 0.f;

  for (int q0 = 0; q0 < Lq; q0 += BW_T) {
    __syncthreads();  // every warp is done with the previous tile (or the K/V staging)
    bw_stage(Qs, qb, st.q[1], q0, Lq, tid, true, qscale);
    bw_stage(Gs, gb, st.g[1], q0, Lq, tid, false, 1.f);
    if (tid < BW_T) {
      const int row = q0 + tid;
      const long long idx = ((long long)b * Lq + row) * H + h;
      row_lse[tid] = row < Lq ? lse[idx] : INFINITY;  // ragged rows: p = 0
      row_delta[tid] = row < Lq ? delta[idx] : 0.f;
    }
    __syncthreads();

    // transposed tiles: rows = keys, columns = this tile's queries
    float s[MB_NT][4], dp[MB_NT][4];
#pragma unroll
    for (int j = 0; j < MB_NT; ++j)
#pragma unroll
      for (int u = 0; u < 4; ++u) s[j][u] = dp[j][u] = 0.f;
    bw_mma_xt(s, kf, Qs, gid, tig);   // k qf^T
    bw_mma_xt(dp, vf, Gs, gid, tig);  // v g^T
#pragma unroll
    for (int j = 0; j < MB_NT; ++j)
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int qc = j * 8 + tig * 2 + (u & 1);
        const float p = key_ok[u >> 1] ? exp2f(s[j][u] - row_lse[qc]) : 0.f;
        s[j][u] = p;                                  // rounded to bf16 in bw_mma_ax
        dp[j][u] = p * (dp[j][u] - row_delta[qc]);    // ds
      }
    bw_mma_ax(acc_dv, s, Gs, lane);   // dv += p^T g
    bw_mma_ax(acc_dk, dp, Qs, lane);  // dk += ds^T qf
  }
  bw_store_rows(dk + b * st.dk[0] + h * st.dk[2], st.dk[1], k0, r0, Lk, acc_dk, tig, kInvLog2E);
  bw_store_rows(dv + b * st.dv[0] + h * st.dv[2], st.dv[1], k0, r0, Lk, acc_dv, tig, 1.f);
}

int launch_bwd_mma(const void* q, const void* k, const void* v, const void* o, const void* g,
                   const float* lse, float* delta, void* dq, void* dk, void* dv, int B, int H,
                   int Lq, int Lk, const long long* strides, const BwdStrides& st, float qscale,
                   float scale, cudaStream_t stream) {
  const uintptr_t bases = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                          reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o) |
                          reinterpret_cast<uintptr_t>(g);
  const uintptr_t outs = reinterpret_cast<uintptr_t>(dq) | reinterpret_cast<uintptr_t>(dk) |
                         reinterpret_cast<uintptr_t>(dv);
  if (bases % 16 || outs % 4) return kErrBadArgument;
  for (int i = 0; i < 24; ++i)
    if (strides[i] % (i < 15 ? 8 : 2)) return kErrBadArgument;
  using bf = __nv_bfloat16;
  const bf* qt = static_cast<const bf*>(q);
  const bf* kt = static_cast<const bf*>(k);
  const bf* vt = static_cast<const bf*>(v);
  const bf* gt = static_cast<const bf*>(g);
  flash_bwd_dq_mma_kernel<<<dim3((Lq + BW_T - 1) / BW_T, B * H), 128, 0, stream>>>(
      qt, kt, vt, static_cast<const bf*>(o), gt, lse, delta, static_cast<bf*>(dq), H, Lq, Lk, st,
      qscale, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dkv_mma_kernel<<<dim3((Lk + BW_T - 1) / BW_T, B * H), 128, 0, stream>>>(
      qt, kt, vt, gt, lse, delta, static_cast<bf*>(dk), static_cast<bf*>(dv), H, Lq, Lk, st,
      qscale);
  return (int)cudaGetLastError();
}

}  // namespace vs

// q, k, v, o, g: [B, L, H*D] read through `strides` (24 element strides:
// (batch, row, head) of q, k, v, o, g, dq, dk, dv; head-dim stride 1);
// lse: fp32 [B, Lq, H] from K1; delta: fp32 [B, Lq, H] scratch (written by
// the dq kernel, read by the dk/dv kernel, on the same stream).
extern "C" int vs_flash_attention_packed_bwd(int dtype, int D, const void* q, const void* k,
                                             const void* v, const void* o, const void* g,
                                             const void* lse, void* delta, void* dq, void* dk,
                                             void* dv, int B, int H, int Lq, int Lk,
                                             const long long* strides, float qscale,
                                             float scale, void* stream) {
  if (D != vs::BW_D) return vs::kErrUnsupported;
  if (B <= 0 || H <= 0 || Lq <= 0 || Lk <= 0 || B * H > 65535) return vs::kErrBadArgument;
  vs::BwdStrides st;
  memcpy(&st, strides, sizeof(st));
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == vs::kBFloat16)
    return vs::launch_bwd_mma(q, k, v, o, g, l, dl, dq, dk, dv, B, H, Lq, Lk, strides, st, qscale,
                              scale, s);
  if (dtype == vs::kFloat32)
    return vs::launch_bwd_fma<float>(q, k, v, o, g, l, dl, dq, dk, dv, B, H, Lq, Lk, st, qscale,
                                     scale, s);
  return vs::kErrUnsupported;
}
