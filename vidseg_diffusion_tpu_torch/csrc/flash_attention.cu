// K1 flash_attention_packed and K3 flash_attention (bhld): one strided
// online-softmax attention kernel.
//
// Replaces (TPU):
//   K1: vidseg_diffusion_tpu/ops/attention.py:_flash_kernel_packed
//       (via _flash_attention_packed_impl) and, for the spatial sites with
//       L < 512, _small_seq_kernel (via _small_batched_attention_impl).
//   K3: vidseg_diffusion_tpu/ops/attention.py:_flash_kernel
//       (via _flash_attention_impl).
//
// Both read q/k/v through (batch, row, head) element strides, so the packed
// [B, L, H*D] projections (K1) and the head-major [B, H, L, D] layout (K3) run
// with no transpose. Math follows the JAX kernels: q is pre-scaled by
// scale*log2(e) and rounded to the input dtype, the softmax is base 2, and
// the p that feeds P.V is rounded to the input dtype. The denominator is the
// one of the JAX kernel the call replaces, a compile-time flag of every bf16
// kernel here (SUM_ROUNDED; the entries take it as `psum_rounded`): the sum of
// the rounded p (_flash_kernel_packed with fused_psum, which takes it from a
// ones column in P.V: K1 at the long sites, K3 under a gradient) or the fp32
// sum of p before the rounding (_small_seq_kernel at K1's short sites,
// _flash_kernel for K3 without a gradient). Rounding to fp32 is the identity,
// so the fp32 kernel has no flag.
//
// Normalise first (sum mode 2 of the entries: flash_fwd_nf64_resident_kernel
// and flash_fwd_nf80_resident_kernel where K and V fit in shared memory, else
// the MODE template argument 2 of flash_fwd_mma_kernel and
// flash_fwd_wgmma64_nf_kernel, which stream the keys): the sites that the JAX
// package's TPU dispatch sends to no Pallas kernel but to mha_reference
// (attention.py:75-100, :1623-1644: lengths on both sides of 512, bhld shorter
// than 512) compute S from the unscaled bf16 q with fp32 accumulation, multiply
// it by scale * log2(e) in fp32 (the `qscale` of that mode), take the row max m
// and l = sum exp2(s - m) in fp32, round p = exp2(s - m) / l to bf16, and sum
// P.V in fp32 with no division after it. m and l come before any p is rounded:
// from the one key tile where it holds every key, else from a first walk over
// the keys (the resident ones, or K alone read from device memory).
//
// What bounds it on the H100: at the main-path shapes (ds1 [28, 5824, 5*64],
// VAE [n, 1, 5824, 512]) the work is ~4*L^2*D flops per (batch, head) with
// only O(L*D) bytes, far above the card's ops:byte ridge, so it is bound by
// arithmetic. Each (q-tile, head) block walks the keys in key tiles,
// keeping the running max, denominator and output on chip, so no logits ever
// reach device memory. The ragged key tail is masked to -inf; ragged query
// rows compute on zeros and are not stored. Four kernels:
// - bf16 at D = 64 (K1 at every spatial UNet site, K3 at D = 64) runs on wgmma
//   fed by TMA (flash_fwd_wgmma64_kernel, below): consumer warpgroups whose
//   softmax and products interleave, K/V tiles through a ring filled by a
//   producer warp;
// - bf16 K3 at D = 80 (CLIP's heads) runs on the tensor cores with mma.sync
//   (flash_fwd_mma_kernel), and so do K1 and K3 at D = 16 (the tiny configs'
//   heads: the same template, instanced at D = 16);
// - bf16 K3 at D = 512 (the VAE's one-head mid attention), and K1 at one
//   512-dim head (the VideoDecoder VideoAttnBlock's attn2, whose packed
//   [B, L, 512] rows are K3's [B, 1, L, 512]) run on wgmma
//   (flash_fwd_wgmma512_kernel, below): a 64 x 512 fp32 output tile is 128
//   accumulator registers a thread over 256 threads, so two warpgroups each
//   own 256 output columns and keys arrive in 32-key tiles through a two-stage
//   ring that one thread fills by TMA while the previous tile multiplies;
// - fp32 inputs (the card-vs-CPU checks and `--dtype float32`) run at D = 512
//   on the tensor cores with split TF32 products (flash_fwd_tf32x3_kernel,
//   tf32x3_attention.cuh: 3 products of hi / lo parts, fp32-class), at D = 64
//   on mma.sync with split TF32 products (flash_fwd_x3_kernel,
//   flash_attention_x3.cu) where TMA can address q, k and v, and otherwise
//   (D = 16, 80, unaligned D = 64) on flash_fwd_kernel, fp32 FMAs on
//   shared-memory tiles (4x4 register micro-tiles per thread for S = Q K^T and
//   for P V).
//
// Training: with a non-null `lse` the kernels also write each row's base-2
// logsumexp m + log2(l) per head, fp32 [B, Lq, H] (the JAX kernel's save_lse
// output, attention.py:404-405, :431-433; for K3's one VAE head that is
// [B*H, Lq], the layout of JAX's heads=1 forward under a gradient), from the
// final running max m and the denominator l (summed as SUM_ROUNDED says). The
// backwards recompute p = exp2(s - lse) from it: K5 (flash_attention_bwd.cu)
// for K1 and for K3 at D = 16 and 64, K13 (flash_attention_bhld_bwd.cu) for K3 at
// D = 512 and 80.
#include "common.cuh"
#include "tf32x3_attention.cuh"
#include "wgmma_tile.cuh"

namespace vs {

template <int D, int BQ, int BK>
struct FlashSmem {
  static constexpr int QS = D + 1;   // padded row strides: no bank conflicts
  static constexpr int KS = D + 1;
  static constexpr int PS = BK + 1;
  static constexpr int floats = BQ * QS + BK * KS + BK * D + BQ * PS + 3 * BQ;
  static constexpr size_t bytes = sizeof(float) * floats;
};

template <typename T, int D, int BQ, int BK>
__global__ void __launch_bounds__(256) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, float* __restrict__ lse, int H, int Lq, int Lk,
    long long qsb, long long qsl, long long qsh,
    long long ksb, long long ksl, long long ksh,
    long long vsb, long long vsl, long long vsh,
    long long osb, long long osl, long long osh, float qscale) {
  using S = FlashSmem<D, BQ, BK>;
  static_assert(D % 16 == 0 && BQ % 16 == 0 && BK % 16 == 0, "tile shape");
  constexpr int RQ = BQ / 16;  // query rows per thread
  constexpr int RK = BK / 16;  // key columns per thread (S tile)
  constexpr int RD = D / 16;   // output columns per thread
  constexpr float NEG_INF = -INFINITY;

  extern __shared__ float smem[];
  float* Qs = smem;                 // [BQ][QS]
  float* Ks = Qs + BQ * S::QS;      // [BK][KS]
  float* Vs = Ks + BK * S::KS;      // [BK][D]
  float* Ps = Vs + BK * D;          // [BQ][PS]
  float* row_m = Ps + BQ * S::PS;   // running max (base-2 logits)
  float* row_l = row_m + BQ;        // running denominator
  float* row_a = row_l + BQ;        // this tile's rescale factor

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int q0 = blockIdx.x * BQ;

  const T* qb = q + b * qsb + h * qsh;
  const T* kb = k + b * ksb + h * ksh;
  const T* vb = v + b * vsb + h * vsh;
  T* ob = o + b * osb + h * osh;

  for (int e = tid; e < BQ * D; e += 256) {
    const int r = e / D, d = e % D;
    float val = 0.f;
    if (q0 + r < Lq) val = round_to<T>(to_f<T>(qb[(long long)(q0 + r) * qsl + d]) * qscale);
    Qs[r * S::QS + d] = val;
  }
  if (tid < BQ) {
    row_m[tid] = NEG_INF;
    row_l[tid] = 0.f;
  }

  float acc[RQ][RD];
#pragma unroll
  for (int i = 0; i < RQ; ++i)
#pragma unroll
    for (int j = 0; j < RD; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < Lk; k0 += BK) {
    __syncthreads();  // previous tile's Ks/Vs/Ps reads are done
    for (int e = tid; e < BK * D; e += 256) {
      const int r = e / D, d = e % D;
      float kv = 0.f, vv = 0.f;
      if (k0 + r < Lk) {
        kv = to_f<T>(kb[(long long)(k0 + r) * ksl + d]);
        vv = to_f<T>(vb[(long long)(k0 + r) * vsl + d]);
      }
      Ks[r * S::KS + d] = kv;
      Vs[r * D + d] = vv;
    }
    __syncthreads();

    // S = Q K^T for this key tile (already in base-2 units via qscale)
    float s[RQ][RK];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < RK; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[RQ], kv[RK];
#pragma unroll
      for (int i = 0; i < RQ; ++i) qv[i] = Qs[(ty + 16 * i) * S::QS + d];
#pragma unroll
      for (int j = 0; j < RK; ++j) kv[j] = Ks[(tx + 16 * j) * S::KS + d];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < RK; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < RK; ++j) {
        const int c = tx + 16 * j;
        Ps[(ty + 16 * i) * S::PS + c] = (k0 + c < Lk) ? s[i][j] : NEG_INF;
      }
    __syncthreads();

    // online softmax: one warp per row, 8 warps
    for (int r = warp; r < BQ; r += 8) {
      float* prow = Ps + r * S::PS;
      float mx = NEG_INF;
      for (int c = lane; c < BK; c += 32) mx = fmaxf(mx, prow[c]);
      mx = warp_max(mx);
      const float m_old = row_m[r];
      const float m_new = fmaxf(m_old, mx);  // finite: every tile has a live key
      float sum = 0.f;
      for (int c = lane; c < BK; c += 32) {
        const float p = round_to<T>(exp2f(prow[c] - m_new));
        prow[c] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = exp2f(m_old - m_new);  // 0 on the first tile
        row_l[r] = alpha * row_l[r] + sum;
        row_m[r] = m_new;
        row_a[r] = alpha;
      }
    }
    __syncthreads();

    // acc = alpha * acc + P V
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const float a = row_a[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < RD; ++j) acc[i][j] *= a;
    }
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float pv[RQ], vv[RD];
#pragma unroll
      for (int i = 0; i < RQ; ++i) pv[i] = Ps[(ty + 16 * i) * S::PS + kk];
#pragma unroll
      for (int j = 0; j < RD; ++j) vv[j] = Vs[kk * D + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < RD; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

  if (lse != nullptr && tid < BQ && q0 + tid < Lq)
    lse[((long long)b * Lq + q0 + tid) * H + h] = row_m[tid] + log2f(row_l[tid]);
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int r = ty + 16 * i;
    if (q0 + r < Lq) {
      const float l = row_l[r];
      T* orow = ob + (long long)(q0 + r) * osl;
#pragma unroll
      for (int j = 0; j < RD; ++j) orow[tx + 16 * j] = from_f<T>(acc[i][j] / l);
    }
  }
}

template <typename T, int D, int BQ, int BK>
int launch_flash(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                 int H, int Lq, int Lk, const long long* st, float qscale,
                 cudaStream_t stream) {
  using S = FlashSmem<D, BQ, BK>;
  auto kern = flash_fwd_kernel<T, D, BQ, BK>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)S::bytes);
  if (attr != cudaSuccess) return (int)attr;
  dim3 grid((Lq + BQ - 1) / BQ, B * H);
  kern<<<grid, 256, S::bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, H, Lq, Lk, st[0], st[1], st[2], st[3], st[4], st[5],
      st[6], st[7], st[8], st[9], st[10], st[11], qscale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_head_dim(int D, const void* q, const void* k, const void* v, void* o,
                      float* lse, int B, int H, int Lq, int Lk, const long long* st,
                      float qscale, cudaStream_t stream) {
  switch (D) {
    case 16:
      return launch_flash<T, 16, 64, 64>(q, k, v, o, lse, B, H, Lq, Lk, st, qscale, stream);
    case 64:
      return launch_flash<T, 64, 64, 64>(q, k, v, o, lse, B, H, Lq, Lk, st, qscale, stream);
    case 80:
      return launch_flash<T, 80, 64, 64>(q, k, v, o, lse, B, H, Lq, Lk, st, qscale, stream);
    default:
      return kErrUnsupported;
  }
}

// fp32 at D = 512 (K3 at the VAE's mid attention, K1 at one 512-dim head): the
// split-TF32 kernel of tf32x3_attention.cuh in its forward role (own rows the
// queries, 128-key tiles: BT 128 halves the re-reads of the q tile from L2; up
// to 64 keys, SPLIT: the head dim split over the warpgroups, half the steps).
template <bool SPLIT>
__global__ void __launch_bounds__(256, 1) flash_fwd_tf32x3_kernel(const __grid_constant__ CUtensorMap qmap,
                                                                  const __grid_constant__ CUtensorMap kmap,
                                                                  const __grid_constant__ CUtensorMap vmap,
                                                                  const x3::Args args) {
  x3::attention_body<x3::kFwd, SPLIT>(&qmap, &qmap, &kmap, &kmap, &vmap, args);
}

int launch_flash_tf32x3(const void* q, const void* k, const void* v, void* o, float* lse, int B, int H, int Lq,
                        int Lk, const long long* st, float qscale, cudaStream_t stream) {
  const void* bases[3] = {q, k, v};
  if (!x3::rows_ok(bases, 3, st, 9)) return kErrBadArgument;
  const bool split = Lk <= 64;
  CUtensorMap qmap, kmap, vmap;
  if (const int rc = x3::tiled_map(q, st, Lq, H, B, 64, &qmap)) return rc;
  if (const int rc = x3::tiled_map(k, st + 3, Lk, H, B, split ? 64 : x3::Cfg<x3::kFwd>::BT, &kmap)) return rc;
  if (const int rc = x3::tiled_map(v, st + 6, Lk, H, B, 64, &vmap)) return rc;
  const x3::Args args{H, Lq, Lk, 0, qscale, 1.f, static_cast<float*>(o), st[9], st[10], st[11], lse, nullptr};
  return split ? x3::launch<x3::kFwd, true>(flash_fwd_tf32x3_kernel<true>, Lq, B * H, stream, qmap, kmap, vmap, args)
               : x3::launch<x3::kFwd, false>(flash_fwd_tf32x3_kernel<false>, Lq, B * H, stream, qmap, kmap, vmap,
                                             args);
}

// flash_attention_x3.cu: fp32 at D = 64 on split-TF32 mma.sync products
bool fwd_x3_addressable(const void* q, const void* k, const void* v, const void* o, const long long* st);
int launch_flash_fwd_x3(const void* q, const void* k, const void* v, void* o, float* lse, int B, int H, int Lq,
                        int Lk, const long long* st, float qscale, cudaStream_t stream);

// The fp32 route of both entry points: route 7 (split TF32 products) at D = 512
// (wgmma) and at D = 64 where TMA can address q, k and v (mma.sync,
// flash_attention_x3.cu); 0 (FMAs) at the others (D = 16, 80, unaligned D = 64).
int flash_entry_fp32(int D, const void* q, const void* k, const void* v, void* o, float* lse, int B,
                     int H, int Lq, int Lk, const long long* strides, float qscale, void* stream, int* route) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 512) {
    *route = kRouteTf32x3;
    return launch_flash_tf32x3(q, k, v, o, lse, B, H, Lq, Lk, strides, qscale, s);
  }
  if (D == 64 && fwd_x3_addressable(q, k, v, o, strides)) {
    *route = kRouteTf32x3;
    return launch_flash_fwd_x3(q, k, v, o, lse, B, H, Lq, Lk, strides, qscale, s);
  }
  *route = 0;
  return dispatch_head_dim<float>(D, q, k, v, o, lse, B, H, Lq, Lk, strides, qscale, s);
}

// ---------------------------------------------------------------------------
// bf16 K3 at D = 80 on the tensor cores: mma.sync.m16n8k16 (bf16 in, fp32
// accumulate).
//
// Four warps per block, each owning 16 of the block's 64 query rows. Q (pre-
// scaled, rounded to bf16) stays in registers as A fragments for the whole
// key loop. Per 64-key tile: S = Q K^T with K's rows read straight from
// shared memory as B fragments; the online softmax runs on the S
// accumulators in registers (a row's 4 owning lanes reduce with shuffles);
// p is rounded to bf16 and repacked in place as the A operand of P V (the
// m16n8 accumulator layout equals the m16k16 A layout), and V's B fragments
// come from ldmatrix.trans. Shared-memory rows are padded by 16 bytes, so
// fragment loads and ldmatrix hit 32 distinct banks. Global loads are
// 16-byte vectors: every row stride must be a multiple of 8 elements and the
// base pointers 16-byte aligned (the wrapper checks; the projections are
// contiguous). Copies are not yet overlapped with the math (no cp.async).

__device__ __forceinline__ void mma_bf16_16816(float c[4], const uint32_t a[4], uint32_t b0,
                                               uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4], const void* smem_ptr) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(smem_ptr));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int D, int MODE>
__global__ void __launch_bounds__(128) flash_fwd_mma_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
    float* __restrict__ lse, int H, int Lq, int Lk,
    long long qsb, long long qsl, long long qsh,
    long long ksb, long long ksl, long long ksh,
    long long vsb, long long vsl, long long vsh,
    long long osb, long long osl, long long osh, float qscale) {
  constexpr int BQ = 64, BK = 64;
  constexpr int DP = D + 8;       // padded smem row, in elements
  constexpr int V8 = D / 8;       // 16-byte vectors per row
  constexpr int KS = D / 16;      // k-steps of S = Q K^T
  constexpr int NS = BK / 8;      // n-tiles of S
  constexpr int NO = D / 8;       // n-tiles of O
  static_assert(D % 16 == 0 && NO % 2 == 0, "head dim");
  constexpr float NEG_INF = -INFINITY;
  constexpr bool SUM_ROUNDED = MODE == 1, NF = MODE == 2;  // NF: qscale multiplies the fp32 logits

  __shared__ __align__(16) __nv_bfloat16 Qs[BQ * DP];
  __shared__ __align__(16) __nv_bfloat16 Ks[BK * DP];
  __shared__ __align__(16) __nv_bfloat16 Vs[BK * DP];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int q0 = blockIdx.x * BQ;
  const __nv_bfloat16* qb = q + b * qsb + h * qsh;
  const __nv_bfloat16* kb = k + b * ksb + h * ksh;
  const __nv_bfloat16* vb = v + b * vsb + h * vsh;
  __nv_bfloat16* ob = o + b * osb + h * osh;

  for (int e = tid; e < BQ * V8; e += 128) {
    const int r = e / V8, c = (e % V8) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (q0 + r < Lq) {
      val = *reinterpret_cast<const uint4*>(qb + (long long)(q0 + r) * qsl + c);
      __nv_bfloat16* x = reinterpret_cast<__nv_bfloat16*>(&val);
#pragma unroll
      for (int u = 0; u < 8; ++u)
        if (!NF) x[u] = __float2bfloat16(__bfloat162float(x[u]) * qscale);
    }
    *reinterpret_cast<uint4*>(&Qs[r * DP + c]) = val;
  }
  __syncthreads();

  const int r0 = warp * 16 + gid;  // this lane's two query rows: r0, r0 + 8
  uint32_t qf[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const int c = ks * 16 + tig * 2;
    qf[ks][0] = *reinterpret_cast<const uint32_t*>(&Qs[r0 * DP + c]);
    qf[ks][1] = *reinterpret_cast<const uint32_t*>(&Qs[(r0 + 8) * DP + c]);
    qf[ks][2] = *reinterpret_cast<const uint32_t*>(&Qs[r0 * DP + c + 8]);
    qf[ks][3] = *reinterpret_cast<const uint32_t*>(&Qs[(r0 + 8) * DP + c + 8]);
  }

  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m_run[2] = {NEG_INF, NEG_INF};
  float l_part[2] = {0.f, 0.f};  // this lane's share of the row denominators

  // S = Q K^T of the key tile in Ks for this warp's 16 rows; normalise first:
  // times qscale in fp32; keys past Lk masked to -inf
  auto tile_s = [&](float (&s)[NS][4], int k0) {
#pragma unroll
    for (int j = 0; j < NS; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        const __nv_bfloat16* krow = &Ks[(j * 8 + gid) * DP + ks * 16 + tig * 2];
        mma_bf16_16816(s[j], qf[ks], *reinterpret_cast<const uint32_t*>(krow),
                       *reinterpret_cast<const uint32_t*>(krow + 8));
      }
    }
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (NF) s[j][u] *= qscale;
        if (k0 + j * 8 + tig * 2 + (u & 1) >= Lk) s[j][u] = NEG_INF;
      }
  };
  if constexpr (NF) {
    // the first walk: K alone, the row max and the fp32 sum of exp2(s - m)
    for (int k0 = 0; k0 < Lk; k0 += BK) {
      __syncthreads();
      for (int e = tid; e < BK * V8; e += 128) {
        const int r = e / V8, c = (e % V8) * 8;
        uint4 kv = make_uint4(0, 0, 0, 0);
        if (k0 + r < Lk) kv = *reinterpret_cast<const uint4*>(kb + (long long)(k0 + r) * ksl + c);
        *reinterpret_cast<uint4*>(&Ks[r * DP + c]) = kv;
      }
      __syncthreads();
      float s[NS][4];
      tile_s(s, k0);
      float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int u = 0; u < 4; ++u) mx[u >> 1] = fmaxf(mx[u >> 1], s[j][u]);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        const float m_new = fmaxf(m_run[i], mx[i]);  // finite: key k0 is live
        l_part[i] *= exp2f(m_run[i] - m_new);
        m_run[i] = m_new;
      }
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int u = 0; u < 4; ++u) l_part[u >> 1] += exp2f(s[j][u] - m_run[u >> 1]);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {  // the whole row's sum in every lane of its quad
      l_part[i] += __shfl_xor_sync(0xffffffffu, l_part[i], 1);
      l_part[i] += __shfl_xor_sync(0xffffffffu, l_part[i], 2);
    }
  }

  for (int k0 = 0; k0 < Lk; k0 += BK) {
    __syncthreads();  // every warp is done reading the previous K/V tile
    for (int e = tid; e < BK * V8; e += 128) {
      const int r = e / V8, c = (e % V8) * 8;
      uint4 kv = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
      if (k0 + r < Lk) {
        kv = *reinterpret_cast<const uint4*>(kb + (long long)(k0 + r) * ksl + c);
        vv = *reinterpret_cast<const uint4*>(vb + (long long)(k0 + r) * vsl + c);
      }
      *reinterpret_cast<uint4*>(&Ks[r * DP + c]) = kv;
      *reinterpret_cast<uint4*>(&Vs[r * DP + c]) = vv;
    }
    __syncthreads();

    float s[NS][4];
    tile_s(s, k0);
    // s[j][0..1] are row r0, s[j][2..3] row r0 + 8, at key columns
    // k0 + 8j + 2 tig + {0, 1}
    if constexpr (NF) {  // p = exp2(s - m) / l (times the reciprocal), rounded; nothing to rescale
      const float inv[2] = {1.f / l_part[0], 1.f / l_part[1]};
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int u = 0; u < 4; ++u) s[j][u] = exp2f(s[j][u] - m_run[u >> 1]) * inv[u >> 1];
    } else {  // online softmax on the accumulators
      float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int u = 0; u < 4; ++u) mx[u >> 1] = fmaxf(mx[u >> 1], s[j][u]);
      float alpha[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        const float m_new = fmaxf(m_run[i], mx[i]);  // finite: key k0 is live
        alpha[i] = exp2f(m_run[i] - m_new);          // 0 on the first tile
        m_run[i] = m_new;
        l_part[i] *= alpha[i];
      }
#pragma unroll
      for (int j = 0; j < NS; ++j) {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float e = exp2f(s[j][u] - m_run[u >> 1]);
          const float p = round_to<__nv_bfloat16>(e);
          s[j][u] = p;
          l_part[u >> 1] += SUM_ROUNDED ? p : e;
        }
      }
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        acc[n][0] *= alpha[0];
        acc[n][1] *= alpha[0];
        acc[n][2] *= alpha[1];
        acc[n][3] *= alpha[1];
      }
    }

    // acc += P V, 16 keys per k-step
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t pa[4] = {
          pack_bf16x2(s[2 * kk][0], s[2 * kk][1]), pack_bf16x2(s[2 * kk][2], s[2 * kk][3]),
          pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      // ldmatrix x4: lanes 8i..8i+7 address matrix i = rows kk*16 + (i&1)*8 + (lane&7)
      // at columns (n + (i>>1))*8, i.e. B fragments of n-tiles n and n + 1
      const int mrow = kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7);
#pragma unroll
      for (int n = 0; n < NO; n += 2) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, &Vs[mrow * DP + (n + (lane >> 4)) * 8]);
        mma_bf16_16816(acc[n], pa, bv[0], bv[1]);
        mma_bf16_16816(acc[n + 1], pa, bv[2], bv[3]);
      }
    }
  }

  if constexpr (!NF) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l_part[i] += __shfl_xor_sync(0xffffffffu, l_part[i], 1);
      l_part[i] += __shfl_xor_sync(0xffffffffu, l_part[i], 2);
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + r0 + 8 * i;
    if (row >= Lq) continue;
    const float l = NF ? 1.f : l_part[i];  // normalise first: p was divided already
    if (lse != nullptr && tig == 0) lse[((long long)b * Lq + row) * H + h] = m_run[i] + log2f(l);
    __nv_bfloat16* orow = ob + (long long)row * osl;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      *reinterpret_cast<uint32_t*>(orow + n * 8 + tig * 2) =
          pack_bf16x2(acc[n][2 * i] / l, acc[n][2 * i + 1] / l);
    }
  }
}

// q/k/v rows are read as 16-byte vectors (aligned bases, strides in whole
// vectors); o is written as bf16 pairs.
bool flash_bf16_rows_ok(const void* q, const void* k, const void* v, const void* o,
                        const long long* st) {
  const uintptr_t bases = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                          reinterpret_cast<uintptr_t>(v);
  if (bases % 16 || reinterpret_cast<uintptr_t>(o) % 4) return false;
  for (int i = 0; i < 12; ++i)
    if (st[i] % (i < 9 ? 8 : 2)) return false;
  return true;
}

template <int D, int MODE>
int launch_flash_mma(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                     int H, int Lq, int Lk, const long long* st, float qscale,
                     cudaStream_t stream) {
  if (!flash_bf16_rows_ok(q, k, v, o, st)) return kErrBadArgument;
  dim3 grid((Lq + 63) / 64, B * H);
  flash_fwd_mma_kernel<D, MODE><<<grid, 128, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), lse, H, Lq, Lk,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11],
      qscale);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 K3 at D = 512 on wgmma. One block of two warpgroups per 64 query rows.
//
// Shared memory (193 KB, one block per SM): Q, pre-scaled and rounded to bf16,
// stays for the whole key loop as eight [64 rows][64 d] panels; K and V tiles
// of 32 keys arrive as eight [32 keys][64 d] panels each, in a ring of two
// stages. Thread 0 asks TMA for the sixteen boxes of a tile (rank-4 tiled maps
// over k and v through their batch, head and row strides; a key past Lk arrives
// as zeros) once both warpgroups have handed the stage back (`empty`
// mbarrier); the boxes report to the stage's `full` mbarrier, and the tile
// after this one lands while this one multiplies. 16-byte cp.async copies from all threads fill shared memory at a
// quarter of TMA's rate and took as long as the products. Every panel has
// 128-byte rows under the 128-byte swizzle, the layout wgmma's descriptors
// read: Q and K K-major (d contiguous) for S = Q K^T, V MN-major (its rows are
// keys, the contraction index of P V).
//
// Per key tile both consumer warpgroups compute the whole S tile (32 x
// m64n32k16 from shared memory) and its online softmax in registers, as the
// mma.sync kernel does (the accumulator layout is the same: each warp owns 16
// rows), so the rounded p never leaves the registers: it is repacked in place
// as the A operand of P V, and each warpgroup multiplies it into its own 256 of
// the 512 output columns (2 x m64n256k16, 128 accumulator registers a thread).
// S is computed twice per block; what that buys is no exchange of p and no
// barrier between the warpgroups beyond handing the stages back. What holds it
// now is the chain inside a warpgroup: 32 small wgmmas for S, a wait, the
// softmax, 2 wgmmas for P V, a wait; filling the ring by 16-byte cp.async
// copies from all threads instead of TMA gave the same time. (A producer
// warpgroup of its own leaves 168 registers a thread at the launch bound;
// ptxas sizes the consumers by that bound, not by what setmaxnreg grants.)
namespace f512 {
constexpr int D = 512, BQ = 64, BK = 32, PANELS = D / 64, STAGES = 2;
constexpr int THREADS = 256;
constexpr int Q_PANEL = BQ * 128, KV_PANEL = BK * 128;
constexpr int Q_BYTES = PANELS * Q_PANEL, KV_BYTES = PANELS * KV_PANEL;
constexpr int STAGE_BYTES = 2 * KV_BYTES;
constexpr int BAR_OFFSET = Q_BYTES + STAGES * STAGE_BYTES;  // full and empty mbarriers after the ring
constexpr int SMEM_BYTES = BAR_OFFSET + 16 * STAGES + 1024;
}  // namespace f512

template <bool SUM_ROUNDED>
__global__ void __launch_bounds__(f512::THREADS, 1) flash_fwd_wgmma512_kernel(
    const __nv_bfloat16* __restrict__ q, const __grid_constant__ CUtensorMap kmap,
    const __grid_constant__ CUtensorMap vmap, __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
    int H, int Lq, int Lk,
    long long qsb, long long qsl, long long qsh, long long osb, long long osl, long long osh,
    float qscale) {
  using namespace f512;
  constexpr float NEG_INF = -INFINITY;
  extern __shared__ unsigned char flash_smem[];
  const uint32_t sq = smem_u32(smem_align_1024(flash_smem));
  const uint32_t sring = sq + Q_BYTES;
  const uint32_t full_bar = sq + BAR_OFFSET, empty_bar = full_bar + 8 * STAGES;

  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int q0 = blockIdx.x * BQ;
  const int ntiles = (Lk + BK - 1) / BK;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full_bar + 8 * s, 1);
      mbar_init(empty_bar + 8 * s, THREADS / 128);
    }
    mbar_init_fence();
  }
  __syncthreads();

  // one thread asks TMA for the sixteen boxes of key tile j
  auto load_kv = [&](int j) {
    const int stage = j % STAGES;
    const uint32_t sk = sring + stage * STAGE_BYTES, sv = sk + KV_BYTES, bar = full_bar + 8 * stage;
    mbar_expect_tx(bar, STAGE_BYTES);
#pragma unroll
    for (int p = 0; p < PANELS; ++p) {
      tma_load_4d(sk + p * KV_PANEL, &kmap, bar, p * 64, j * BK, h, b);
      tma_load_4d(sv + p * KV_PANEL, &vmap, bar, p * 64, j * BK, h, b);
    }
  };
  if (tid == 0) {
    for (int j = 0; j < STAGES && j < ntiles; ++j) load_kv(j);
  }

  const __nv_bfloat16* qb = q + b * qsb + h * qsh;
  __nv_bfloat16* ob = o + b * osb + h * osh;
  // 16-byte chunk c (0-63) of row r goes to panel c / 8, swizzled chunk c % 8
#pragma unroll 4
  for (int i = 0; i < BQ * 64 / THREADS; ++i) {
    const int idx = tid + THREADS * i, r = idx >> 6, c = idx & 63;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (q0 + r < Lq) {
      val = *reinterpret_cast<const uint4*>(qb + (long long)(q0 + r) * qsl + c * 8);
      __nv_bfloat16* x = reinterpret_cast<__nv_bfloat16*>(&val);
#pragma unroll
      for (int u = 0; u < 8; ++u) x[u] = __float2bfloat16(__bfloat162float(x[u]) * qscale);
    }
    const uint32_t dst = sq + (c >> 3) * Q_PANEL + sw128(r, c & 7);
    asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(dst), "r"(val.x), "r"(val.y),
                 "r"(val.z), "r"(val.w)
                 : "memory");
  }
  fence_proxy_async();
  __syncthreads();  // Q is in place for both warpgroups' wgmmas

  float acc[128];  // rows 16 warp + gid (+ 8), columns 256 wg + 8 n + 2 tig (+ 1)
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
  float m_run[2] = {NEG_INF, NEG_INF};
  float l_part[2] = {0.f, 0.f};  // this lane's share of the row denominators

  for (int j = 0; j < ntiles; ++j) {
    const int k0 = j * BK, stage = j % STAGES;
    mbar_wait(full_bar + 8 * stage, (j / STAGES) & 1);
    const uint32_t sk = sring + stage * STAGE_BYTES, sv = sk + KV_BYTES;

    float s[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) s[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int p = 0; p < PANELS; ++p) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_m64n32k16_ss(s, wgmma_desc(sq + p * Q_PANEL + kk * 32, 16, 1024),
                           wgmma_desc(sk + p * KV_PANEL + kk * 32, 16, 1024), (p | kk) != 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    wgmma_fence_regs(s);

    // online softmax on the accumulators: s[4 n + 0..1] are row gid, s[4 n + 2..3]
    // row gid + 8, at key columns k0 + 8 n + 2 tig + {0, 1}
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int n = 0; n < 4; ++n) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (k0 + n * 8 + tig * 2 + (u & 1) >= Lk) s[4 * n + u] = NEG_INF;
        mx[u >> 1] = fmaxf(mx[u >> 1], s[4 * n + u]);
      }
    }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m_run[i], mx[i]);  // finite: key k0 is live
      alpha[i] = exp2f(m_run[i] - m_new);          // 0 on the first tile
      m_run[i] = m_new;
      l_part[i] *= alpha[i];
    }
#pragma unroll
    for (int n = 0; n < 4; ++n) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float e = exp2f(s[4 * n + u] - m_run[u >> 1]);
        const float p = round_to<__nv_bfloat16>(e);
        s[4 * n + u] = p;
        l_part[u >> 1] += SUM_ROUNDED ? p : e;
      }
    }
#pragma unroll
    for (int n = 0; n < 64; ++n) {
      acc[4 * n] *= alpha[0];
      acc[4 * n + 1] *= alpha[0];
      acc[4 * n + 2] *= alpha[1];
      acc[4 * n + 3] *= alpha[1];
    }

    // acc += P V on this warpgroup's four 64-column panels, 16 keys per step
    uint32_t pa[2][4];
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      pa[kk][0] = pack_bf16x2(s[8 * kk], s[8 * kk + 1]);
      pa[kk][1] = pack_bf16x2(s[8 * kk + 2], s[8 * kk + 3]);
      pa[kk][2] = pack_bf16x2(s[8 * kk + 4], s[8 * kk + 5]);
      pa[kk][3] = pack_bf16x2(s[8 * kk + 6], s[8 * kk + 7]);
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
      wgmma_m64n256k16_rs_tb(acc, pa[kk], wgmma_desc(sv + wg * 4 * KV_PANEL + kk * 16 * 128, KV_PANEL, 1024),
                             1);
    wgmma_commit();
    wgmma_wait<0>();
    wgmma_fence_regs(acc);
    if ((tid & 127) == 0) mbar_arrive(empty_bar + 8 * stage);  // this warpgroup is done with the stage
    if (tid == 0 && j + STAGES < ntiles) {  // and once both are, the tile after next goes there
      mbar_wait(empty_bar + 8 * stage, (j / STAGES) & 1);
      load_kv(j + STAGES);
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_part[i] += __shfl_xor_sync(0xffffffffu, l_part[i], 1);
    l_part[i] += __shfl_xor_sync(0xffffffffu, l_part[i], 2);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + warp * 16 + gid + 8 * i;
    if (row >= Lq) continue;
    const float l = l_part[i];
    // both warpgroups hold the same row max and sum: the first writes the LSE
    if (lse != nullptr && wg == 0 && tig == 0) lse[((long long)b * Lq + row) * H + h] = m_run[i] + log2f(l);
    __nv_bfloat16* orow = ob + (long long)row * osl + wg * 256 + tig * 2;
#pragma unroll
    for (int n = 0; n < 32; ++n)
      *reinterpret_cast<uint32_t*>(orow + n * 8) =
          pack_bf16x2(acc[4 * n + 2 * i] / l, acc[4 * n + 2 * i + 1] / l);
  }
}

template <bool SUM_ROUNDED>
int launch_flash_wgmma512(const void* q, const void* k, const void* v, void* o, float* lse, int B, int H,
                          int Lq, int Lk, const long long* st, float qscale, cudaStream_t stream) {
  if (!flash_bf16_rows_ok(q, k, v, o, st)) return kErrBadArgument;
  // more than 48 KB of shared memory is opted into once per process
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_wgmma512_kernel<SUM_ROUNDED>, cudaFuncAttributeMaxDynamicSharedMemorySize, f512::SMEM_BYTES);
  if (attr != cudaSuccess) return (int)attr;
  // k and v as [B, H, Lk, 512] through their (batch, row, head) strides: boxes of 64 d x 32 keys
  CUtensorMap maps[2];
  const void* bases[2] = {k, v};
  for (int i = 0; i < 2; ++i) {
    const long long* s = st + 3 * (i + 1);
    const cuuint64_t dims[4] = {(cuuint64_t)f512::D, (cuuint64_t)Lk, (cuuint64_t)H, (cuuint64_t)B};
    const cuuint64_t strides[3] = {(cuuint64_t)s[1] * 2, (cuuint64_t)s[2] * 2, (cuuint64_t)s[0] * 2};
    const cuuint32_t box[4] = {64, f512::BK, 1, 1};
    if (const int rc = wgmma_tiled_map(bases[i], 4, dims, strides, box, &maps[i])) return rc;
  }
  dim3 grid((Lq + f512::BQ - 1) / f512::BQ, B * H);
  flash_fwd_wgmma512_kernel<SUM_ROUNDED><<<grid, f512::THREADS, f512::SMEM_BYTES, stream>>>(
      static_cast<const __nv_bfloat16*>(q), maps[0], maps[1], static_cast<__nv_bfloat16*>(o), lse, H, Lq, Lk,
      st[0], st[1], st[2], st[9], st[10], st[11], qscale);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 at D = 64 (K1 at every spatial UNet site, K3 at D = 64) on wgmma fed by
// TMA. A block holds NWG consumer warpgroups (64 query rows each) and one
// producer warp.
//
// What bounds it: at D = 64 one score costs 4 * 64 = 256 tensor-core flops,
// 1/16 of an SM clock at 4096 bf16 flops per clock and SM, and its exp2 costs
// 1/16 of an SM clock too (16 MUFU results per clock and SM): the softmax is as
// costly as the two products, so the bound on the tensor cores is reached only
// when one warpgroup's exp2s run while another's wgmmas do. Design:
// - the producer warp's first thread asks TMA for the block's Q box (rank-4
//   tiled maps over q, k and v through their (batch, row, head) strides, read
//   in place; a 64-element row is one 128-byte swizzled box row), then for the
//   K and V tiles of BK keys through a ring of STAGES stages (`full` / `empty`
//   mbarriers); rows past Lq or Lk arrive as zeros;
// - each consumer warpgroup scales its 64 Q rows by scale * log2(e) in shared
//   memory, rounded to bf16 once (then a proxy fence: wgmma reads through the
//   async proxy), and per key tile computes S = Q K^T (4 x m64nBKk16 from
//   shared memory, BK / 2 fp32 registers a thread), the online softmax in base
//   2 on the accumulators (the ragged key tail masked to -inf), p rounded to
//   bf16 and summed as rounded or before the rounding (SUM_ROUNDED), and
//   O += P V with p as the register A operand
//   (BK / 16 x m64n64k16, V the MN-major B operand);
// - inside a warpgroup, S of tile j and P V of tile j - 1 are issued together,
//   so the softmax of tile j runs while P V of tile j - 1 multiplies; with two
//   warpgroups, named barriers hand the turn to issue wgmmas round robin, which
//   keeps one warpgroup's exp2s beside the other's products; with one, three
//   blocks share an SM and interleave the same way on their own;
// - the epilogue divides by the row sums, stages the 64 x 64 tile in the
//   warpgroup's own Q rows and stores it 16 bytes a thread, ragged query rows
//   not stored; with `lse` it writes m + log2(l).
// Measured and dropped (PERF.md): three warpgroups a block (ptxas leaves 128
// registers a thread at 416 threads and spills), two warpgroups with 64-key
// tiles at two blocks an SM (96 registers, spills), four one-warpgroup blocks
// an SM (wgmmas serialized for want of registers).
template <int NWG_, int BK_, int STAGES_, int MINB_>
struct F64 {
  static constexpr int D = 64, BK = BK_, NWG = NWG_, BQ = 64 * NWG, STAGES = STAGES_, MINB = MINB_;
  static constexpr int THREADS = 128 * NWG + 32;   // consumer warpgroups, then the producer warp
  static constexpr int WG_Q_BYTES = 64 * 128, Q_BYTES = NWG * WG_Q_BYTES;
  static constexpr int KV_BYTES = BK * 128, STAGE_BYTES = 2 * KV_BYTES;
  static constexpr int BAR_OFFSET = Q_BYTES + STAGES * STAGE_BYTES;  // q, STAGES full, STAGES empty
  static constexpr int SMEM_BYTES = BAR_OFFSET + 8 * (1 + 2 * STAGES) + 1024;
  static_assert(BK == 64 || BK == 128, "key tile");
};

__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <class C, bool SUM_ROUNDED>
__global__ void __launch_bounds__(C::THREADS, C::MINB) flash_fwd_wgmma64_kernel(
    const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
    const __grid_constant__ CUtensorMap vmap, __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
    int H, int Lq, int Lk, long long osb, long long osl, long long osh, float qscale) {
  constexpr int D = C::D, BK = C::BK, NWG = C::NWG, BQ = C::BQ, STAGES = C::STAGES;
  constexpr int WG_Q_BYTES = C::WG_Q_BYTES, Q_BYTES = C::Q_BYTES, KV_BYTES = C::KV_BYTES;
  constexpr int STAGE_BYTES = C::STAGE_BYTES, BAR_OFFSET = C::BAR_OFFSET;
  constexpr int NS = BK / 2;  // S accumulator registers a thread
  constexpr float NEG_INF = -INFINITY;
  extern __shared__ unsigned char flash_smem[];
  const uint32_t sq = smem_u32(smem_align_1024(flash_smem));
  const uint32_t sring = sq + Q_BYTES;
  const uint32_t q_bar = sq + BAR_OFFSET, full_bar = q_bar + 8, empty_bar = full_bar + 8 * STAGES;
  const int tid = threadIdx.x, wg = tid >> 7;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int q0 = blockIdx.x * BQ;
  const int ntiles = (Lk + BK - 1) / BK;

  if (tid == 0) {
    mbar_init(q_bar, 1);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full_bar + 8 * s, 1);
      mbar_init(empty_bar + 8 * s, NWG);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == NWG) {
    // the producer warp: one thread asks for Q, then keeps the K/V ring full
    if (tid == 128 * NWG) {
      mbar_expect_tx(q_bar, Q_BYTES);
      tma_load_4d(sq, &qmap, q_bar, 0, q0, h, b);
      for (int j = 0; j < ntiles; ++j) {
        const int stage = j % STAGES;
        if (j >= STAGES) mbar_wait(empty_bar + 8 * stage, ((j / STAGES) + 1) & 1);
        const uint32_t sk = sring + stage * STAGE_BYTES, bar = full_bar + 8 * stage;
        mbar_expect_tx(bar, STAGE_BYTES);
        tma_load_4d(sk, &kmap, bar, 0, j * BK, h, b);
        tma_load_4d(sk + KV_BYTES, &vmap, bar, 0, j * BK, h, b);
      }
    }
    return;
  }

  const int t = tid & 127, warp = t >> 5, lane = tid & 31, gid = lane >> 2, tig = lane & 3;
  const int wsync = 1 + NWG + wg;  // this warpgroup's own named barrier; 1..NWG are the turns
  const uint32_t sqw = sq + wg * WG_Q_BYTES;

  // Q: this warpgroup's 64 rows scaled in place and rounded to bf16 once
  mbar_wait(q_bar, 0);
#pragma unroll
  for (int i = 0; i < WG_Q_BYTES / 16 / 128; ++i) {
    const uint32_t addr = sqw + (t + 128 * i) * 16;
    uint4 val;
    asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(val.x), "=r"(val.y), "=r"(val.z), "=r"(val.w)
                 : "r"(addr));
    __nv_bfloat16* x = reinterpret_cast<__nv_bfloat16*>(&val);
#pragma unroll
    for (int u = 0; u < 8; ++u) x[u] = __float2bfloat16(__bfloat162float(x[u]) * qscale);
    asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "r"(val.x), "r"(val.y),
                 "r"(val.z), "r"(val.w)
                 : "memory");
  }
  fence_proxy_async();
  bar_sync(wsync, 128);

  float s[NS];      // S tile: rows 16 warp + gid (+ 8), key columns 8 n + 2 tig (+ 1)
  float acc[32];    // O tile: the same rows, columns 8 n + 2 tig (+ 1)
  uint32_t pa[BK / 16][4];  // the rounded p of the previous tile as the A operand of P V
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  float m_run[2] = {NEG_INF, NEG_INF};
  float l_part[2] = {0.f, 0.f};  // this lane's share of the row denominators

  auto issue_s = [&](int stage) {
    const uint32_t sk = sring + stage * STAGE_BYTES;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      if constexpr (BK == 128)
        wgmma_m64n128k16_ss(s, wgmma_desc(sqw + kk * 32, 16, 1024), wgmma_desc(sk + kk * 32, 16, 1024), kk);
      else
        wgmma_m64n64k16_ss(s, wgmma_desc(sqw + kk * 32, 16, 1024), wgmma_desc(sk + kk * 32, 16, 1024), kk);
    }
    wgmma_commit();
  };
  auto issue_pv = [&](int stage) {
    const uint32_t sv = sring + stage * STAGE_BYTES + KV_BYTES;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_m64n64k16_rs_tb(acc, pa[kk], wgmma_desc(sv + kk * 16 * 128, KV_BYTES, 1024), 1);
    wgmma_commit();
  };
  // the online softmax of key tile j on the accumulators: p = exp2(s - m) in
  // place (fp32, not yet rounded); returns the rescale of the rows' old sums
  auto softmax = [&](int j, float (&alpha)[2]) {
    const int k0 = j * BK;
    if (k0 + BK > Lk) {
#pragma unroll
      for (int i = 0; i < NS; ++i)
        if (k0 + (i >> 2) * 8 + tig * 2 + (i & 1) >= Lk) s[i] = NEG_INF;
    }
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int i = 0; i < NS; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_run[r], mx[r]);  // finite: key k0 is live
      alpha[r] = ex2_approx(m_run[r] - m_new);      // 0 on the first tile
      m_run[r] = m_new;
    }
#pragma unroll
    for (int i = 0; i < NS; ++i) s[i] = ex2_approx(s[i] - m_run[(i >> 1) & 1]);
  };
  // p rounded to bf16 into the A fragments (16 keys a k-step), summed as
  // rounded or before the rounding
  auto pack_p = [&]() {
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const uint32_t v = pack_bf16x2(s[8 * kk + 2 * q], s[8 * kk + 2 * q + 1]);
        pa[kk][q] = v;
        if constexpr (SUM_ROUNDED)
          l_part[q & 1] += __uint_as_float(v << 16) + __uint_as_float(v & 0xffff0000u);
        else
          l_part[q & 1] += s[8 * kk + 2 * q] + s[8 * kk + 2 * q + 1];
      }
    }
  };
  auto turn_sync = [&]() {
    if constexpr (NWG > 1) bar_sync(1 + wg, 256);
  };
  auto turn_arrive = [&](bool last) {
    if constexpr (NWG > 1) {
      if (!(last && wg == NWG - 1)) bar_arrive(1 + (wg + 1) % NWG, 256);
    }
  };
  if constexpr (NWG > 1) {
    if (wg == NWG - 1) bar_arrive(1, 256);  // warpgroup 0 takes the first turn
  }

  // key tile 0: S alone
  mbar_wait(full_bar, 0);
  turn_sync();
  wgmma_fence();
  issue_s(0);
  turn_arrive(ntiles == 1);
  wgmma_wait<0>();
  wgmma_fence_regs(s);
  {
    float alpha[2];
    softmax(0, alpha);
  }
  pack_p();
  for (int j = 1; j < ntiles; ++j) {
    const int stage = j % STAGES, prev = (j - 1) % STAGES;
    mbar_wait(full_bar + 8 * stage, (j / STAGES) & 1);
    turn_sync();
    wgmma_fence();
    issue_s(stage);    // S of tile j ...
    issue_pv(prev);    // ... and P V of tile j - 1, in flight together
    turn_arrive(j == ntiles - 1);
    wgmma_wait<1>();   // S is in
    wgmma_fence_regs(s);
    float alpha[2];
    softmax(j, alpha);
    wgmma_wait<0>();   // P V of tile j - 1 is done: its stage goes back, p's registers are free
    wgmma_fence_regs(acc);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int q = 0; q < 4; ++q) asm volatile("" : "+r"(pa[kk][q])::"memory");
    if (t == 0) mbar_arrive(empty_bar + 8 * prev);
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] *= alpha[(i >> 1) & 1];
    l_part[0] *= alpha[0];
    l_part[1] *= alpha[1];
    pack_p();
  }
  wgmma_fence();
  issue_pv((ntiles - 1) % STAGES);
  wgmma_wait<0>();
  wgmma_fence_regs(acc);

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_part[r] += __shfl_xor_sync(0xffffffffu, l_part[r], 1);
    l_part[r] += __shfl_xor_sync(0xffffffffu, l_part[r], 2);
  }
  const int r_lo = warp * 16 + gid;  // this lane's rows in the warpgroup's 64: r_lo, r_lo + 8
  const int row_base = q0 + wg * 64;
  if (lse != nullptr && tig == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row_base + r_lo + 8 * r;
      if (row < Lq) lse[((long long)b * Lq + row) * H + h] = m_run[r] + log2f(l_part[r]);
    }
  }
  // O / l into this warpgroup's Q rows (swizzled 16-byte chunks), then 16-byte stores
  bar_sync(wsync, 128);  // every warp of the warpgroup is done with Q
#pragma unroll
  for (int n = 0; n < 8; ++n) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r_lo + 8 * r;
      const uint32_t v = pack_bf16x2(acc[4 * n + 2 * r] / l_part[r], acc[4 * n + 2 * r + 1] / l_part[r]);
      asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(sqw + sw128(row, n) + tig * 4), "r"(v) : "memory");
    }
  }
  bar_sync(wsync, 128);
  __nv_bfloat16* ob = o + b * osb + h * osh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int idx = t + 128 * i, row = idx >> 3, c = idx & 7;
    if (row_base + row >= Lq) continue;
    uint4 val;
    asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(val.x), "=r"(val.y), "=r"(val.z), "=r"(val.w)
                 : "r"(sqw + sw128(row, c))
                 : "memory");
    *reinterpret_cast<uint4*>(ob + (long long)(row_base + row) * osl + c * 8) = val;
  }
}

// the maps of the D = 64 kernels: q, k, v [B, L, H, 64] through their (batch,
// row, head) strides, boxes of 64 d x `rows` rows (Q: bq, K and V: bk)
inline int flash64_maps(const void* q, const void* k, const void* v, int B, int H, int Lq, int Lk,
                        const long long* st, int bq, int bk, CUtensorMap* maps) {
  const void* bases[3] = {q, k, v};
  const int rows[3] = {Lq, Lk, Lk}, box_rows[3] = {bq, bk, bk};
  for (int i = 0; i < 3; ++i) {
    const long long* s = st + 3 * i;
    const cuuint64_t dims[4] = {64, (cuuint64_t)rows[i], (cuuint64_t)H, (cuuint64_t)B};
    const cuuint64_t strides[3] = {(cuuint64_t)s[1] * 2, (cuuint64_t)s[2] * 2, (cuuint64_t)s[0] * 2};
    const cuuint32_t box[4] = {64, (cuuint32_t)box_rows[i], 1, 1};
    if (const int rc = wgmma_tiled_map(bases[i], 4, dims, strides, box, &maps[i])) return rc;
  }
  return 0;
}

// q, k, v and o rows move as 16-byte vectors or TMA boxes (aligned bases, strides in whole vectors)
inline bool flash_vec_rows_ok(const void* q, const void* k, const void* v, const void* o, const long long* st) {
  return flash_bf16_rows_ok(q, k, v, o, st) && reinterpret_cast<uintptr_t>(o) % 16 == 0 && st[9] % 8 == 0 &&
         st[10] % 8 == 0 && st[11] % 8 == 0;
}

// q, k, v through rank-4 tiled maps (flash64_maps), o written 16 bytes a thread.
template <class C, bool SUM_ROUNDED>
int launch_flash_wgmma64_cfg(const void* q, const void* k, const void* v, void* o, float* lse, int B, int H,
                             int Lq, int Lk, const long long* st, float qscale, cudaStream_t stream) {
  if (!flash_vec_rows_ok(q, k, v, o, st)) return kErrBadArgument;
  // more than 48 KB of shared memory is opted into once per process
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_wgmma64_kernel<C, SUM_ROUNDED>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM_BYTES);
  if (attr != cudaSuccess) return (int)attr;
  CUtensorMap maps[3];
  if (const int rc = flash64_maps(q, k, v, B, H, Lq, Lk, st, C::BQ, C::BK, maps)) return rc;
  dim3 grid((Lq + C::BQ - 1) / C::BQ, B * H);
  flash_fwd_wgmma64_kernel<C, SUM_ROUNDED><<<grid, C::THREADS, C::SMEM_BYTES, stream>>>(
      maps[0], maps[1], maps[2], static_cast<__nv_bfloat16*>(o), lse, H, Lq, Lk, st[9], st[10], st[11],
      qscale);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 at D = 64 in the normalise-first mode with the keys streamed from device
// memory: what runs where one product of the resident kernel below does not
// hold every key (Lk > 128: ViT-L/14's 257 tokens; Lq < 512 <= Lk, which
// site_route allows and no path has), and, as sum mode 3, the yardstick the
// resident kernel is timed against (it was the only normalise-first kernel at
// D = 64 before the resident one). One consumer warpgroup of 64 query rows and
// a producer warp, 128-key tiles. With more keys than a tile the producer walks
// the key tiles twice: K alone first (the row max and the fp32 sum, rescaled
// online), then K and V. Per tile S = Q K^T
// from the unscaled q (4 x m64n128k16), times qscale in fp32, p = exp2(s - m)
// times 1 / l in fp32 rounded to bf16 into the A fragments (the product with
// the correctly rounded reciprocal is within one fp32 ulp of the quotient; a
// division per score tripled the kernel's time), O += P V (8 x m64n64k16); the
// output is O rounded once. Three blocks share an SM, so one block's loads and
// epilogue overlap the others' products.
using F64Nf = F64<1, 128, 2, 3>;

__global__ void __launch_bounds__(F64Nf::THREADS, F64Nf::MINB) flash_fwd_wgmma64_nf_kernel(
    const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
    const __grid_constant__ CUtensorMap vmap, __nv_bfloat16* __restrict__ o, int H, int Lq, int Lk,
    long long osb, long long osl, long long osh, float qscale) {
  using C = F64Nf;
  constexpr int BK = C::BK, STAGES = C::STAGES, KV_BYTES = C::KV_BYTES, STAGE_BYTES = C::STAGE_BYTES;
  constexpr int NS = BK / 2;
  constexpr float NEG_INF = -INFINITY;
  extern __shared__ unsigned char flash_smem[];
  const uint32_t sq = smem_u32(smem_align_1024(flash_smem));
  const uint32_t sring = sq + C::Q_BYTES;
  const uint32_t q_bar = sq + C::BAR_OFFSET, full_bar = q_bar + 8, empty_bar = full_bar + 8 * STAGES;
  const int tid = threadIdx.x;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int q0 = blockIdx.x * 64;
  const int ntiles = (Lk + BK - 1) / BK;
  const int first = ntiles > 1 ? ntiles : 0;  // loads of the first walk (K alone)

  if (tid == 0) {
    mbar_init(q_bar, 1);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full_bar + 8 * s, 1);
      mbar_init(empty_bar + 8 * s, 1);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (tid >= 128) {  // the producer warp
    if (tid == 128) {
      mbar_expect_tx(q_bar, C::Q_BYTES);
      tma_load_4d(sq, &qmap, q_bar, 0, q0, h, b);
      for (int i = 0; i < first + ntiles; ++i) {
        const int stage = i % STAGES, j = i < first ? i : i - first;
        if (i >= STAGES) mbar_wait(empty_bar + 8 * stage, ((i / STAGES) + 1) & 1);
        const uint32_t sk = sring + stage * STAGE_BYTES, bar = full_bar + 8 * stage;
        mbar_expect_tx(bar, i < first ? KV_BYTES : STAGE_BYTES);
        tma_load_4d(sk, &kmap, bar, 0, j * BK, h, b);
        if (i >= first) tma_load_4d(sk + KV_BYTES, &vmap, bar, 0, j * BK, h, b);
      }
    }
    return;
  }

  const int warp = tid >> 5, lane = tid & 31, gid = lane >> 2, tig = lane & 3;
  float s[NS];
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  float m_run[2] = {NEG_INF, NEG_INF};
  float l_run[2] = {0.f, 0.f};
  mbar_wait(q_bar, 0);

  // S of load i in s: times qscale, keys past Lk at -inf; its stage stays full
  auto tile_s = [&](int i, int j) {
    const int stage = i % STAGES;
    mbar_wait(full_bar + 8 * stage, (i / STAGES) & 1);
    const uint32_t sk = sring + stage * STAGE_BYTES;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_m64n128k16_ss(s, wgmma_desc(sq + kk * 32, 16, 1024), wgmma_desc(sk + kk * 32, 16, 1024), kk);
    wgmma_commit();
    wgmma_wait<0>();
    wgmma_fence_regs(s);
#pragma unroll
    for (int e = 0; e < NS; ++e) {
      s[e] *= qscale;
      if (j * BK + (e >> 2) * 8 + tig * 2 + (e & 1) >= Lk) s[e] = NEG_INF;
    }
  };
  // the rows' max and fp32 sum of exp2(s - m) over the tile in s, merged
  // online; with `keep` s is left holding exp2(s - m)
  auto accumulate_ml = [&](bool keep) {
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int e = 0; e < NS; ++e) mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], s[e]);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_run[r], mx[r]);  // finite: the tile's first key is live
      l_run[r] *= exp2f(m_run[r] - m_new);
      m_run[r] = m_new;
    }
#pragma unroll
    for (int e = 0; e < NS; ++e) {
      const float x = exp2f(s[e] - m_run[(e >> 1) & 1]);
      l_run[(e >> 1) & 1] += x;
      if (keep) s[e] = x;
    }
  };
  auto finish_l = [&]() {  // the whole row's sum in every lane of its quad
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
      l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
    }
  };

  for (int i = 0; i < first; ++i) {  // the first walk: m and l
    tile_s(i, i);
    if (tid == 0) mbar_arrive(empty_bar + 8 * (i % STAGES));
    accumulate_ml(false);
  }
  if (first) finish_l();
  for (int j = 0; j < ntiles; ++j) {
    const int i = first + j, stage = i % STAGES;
    tile_s(i, j);
    if (first) {
#pragma unroll
      for (int e = 0; e < NS; ++e) s[e] = exp2f(s[e] - m_run[(e >> 1) & 1]);
    } else {  // one tile holds every key
      accumulate_ml(true);
      finish_l();
    }
    const float inv[2] = {1.f / l_run[0], 1.f / l_run[1]};
    uint32_t pa[BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int qq = 0; qq < 4; ++qq) {
        const int e = 8 * kk + 2 * qq, r = qq & 1;
        pa[kk][qq] = pack_bf16x2(s[e] * inv[r], s[e + 1] * inv[r]);
      }
    const uint32_t sv = sring + stage * STAGE_BYTES + KV_BYTES;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_m64n64k16_rs_tb(acc, pa[kk], wgmma_desc(sv + kk * 16 * 128, KV_BYTES, 1024), 1);
    wgmma_commit();
    wgmma_wait<0>();
    wgmma_fence_regs(acc);
    if (tid == 0) mbar_arrive(empty_bar + 8 * stage);
  }

  // O rounded once into the Q rows (swizzled 16-byte chunks), then 16-byte stores
  const int r_lo = warp * 16 + gid;
  bar_sync(1, 128);  // every warp is done with Q
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const uint32_t v = pack_bf16x2(acc[4 * n + 2 * r], acc[4 * n + 2 * r + 1]);
      asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(sq + sw128(r_lo + 8 * r, n) + tig * 4), "r"(v) : "memory");
    }
  bar_sync(1, 128);
  __nv_bfloat16* ob = o + b * osb + h * osh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int idx = tid + 128 * i, row = idx >> 3, c = idx & 7;
    if (q0 + row >= Lq) continue;
    uint4 val;
    asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(val.x), "=r"(val.y), "=r"(val.z), "=r"(val.w)
                 : "r"(sq + sw128(row, c))
                 : "memory");
    *reinterpret_cast<uint4*>(ob + (long long)(q0 + row) * osl + c * 8) = val;
  }
}

int launch_flash_wgmma64_nf(const void* q, const void* k, const void* v, void* o, int B, int H, int Lq, int Lk,
                            const long long* st, float qscale, cudaStream_t stream) {
  using C = F64Nf;
  if (!flash_vec_rows_ok(q, k, v, o, st)) return kErrBadArgument;
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_wgmma64_nf_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM_BYTES);
  if (attr != cudaSuccess) return (int)attr;
  CUtensorMap maps[3];
  if (const int rc = flash64_maps(q, k, v, B, H, Lq, Lk, st, 64, C::BK, maps)) return rc;
  dim3 grid((Lq + 63) / 64, B * H);
  flash_fwd_wgmma64_nf_kernel<<<grid, C::THREADS, C::SMEM_BYTES, stream>>>(
      maps[0], maps[1], maps[2], static_cast<__nv_bfloat16*>(o), H, Lq, Lk, st[9], st[10], st[11], qscale);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The normalise-first kernels with K and V resident in shared memory: bf16 at
// D = 64 where one S product holds every key (Lk <= NF64_RESIDENT_KEYS: K1 at
// the SD 2.1 / SDXL cross-attention's 77 keys) and at D = 80 where the keys fit
// (Lk <= NF80_RESIDENT_KEYS: K3 at CLIP ViT-H's 257 tokens). Same arithmetic as
// the streaming kernels (mode 2 above); what they change:
// - the 77-key sites are bound by bytes (ds1 [28, 5824 x 77, 5 x 64]: 1.6 GFLOP
//   against 211 MB of Q read and O written). The streaming D = 64 kernel ran
//   one serial chain a 64-row block (its barriers, Q by TMA, the (b, h)'s whole
//   K / V tile fetched again by each of its 91 blocks, S, softmax, P V, then
//   16-byte stores), and nothing in a block overlapped its loads and stores
//   with its math. The resident D = 64 kernel is persistent: one block an SM
//   walks a contiguous run of (b, h, 64-row tile) work items, (b, h) major,
//   so K / V of a (b, h) are loaded once a block (into two buffers: the next
//   (b, h) loads while this one runs) and cut to the live keys (80 for 77: one
//   m64n80k16 a k-step of S, five m64n64k16 of P V); a producer warp keeps a
//   ring of Q tiles full by TMA; consumer warpgroups take the tiles in turn, so
//   one's softmax runs beside another's products and loads; O goes through a
//   staging tile (two a warpgroup) to a TMA store, which overlaps the next
//   tiles. With more keys than one product the streaming kernel stays: at
//   ViT-L/14's 257 (five query tiles a head) a resident first walk read slower
//   than it (PERF.md section 6).
// - the streaming D = 80 kernel read K twice and V once a 64-row block in
//   64-key tiles by plain loads between block barriers, on 80 blocks for 132
//   SMs, each warp's walks one long serial chain. The resident one takes
//   32-row tiles (9 x 16 = 144 blocks at CLIP, two an SM in 108 KB each); one
//   thread asks TMA for the tile's q and the head's K and V, each row as a
//   128-byte panel (d 0..63, 128-byte swizzle) and a 32-byte one (d 64..79,
//   32-byte swizzle), so every ldmatrix is conflict-free, one mbarrier a 32-key
//   step of K and of V, so the walks start on the first step to land. Four
//   warps on mma.sync: two row halves of the tile times two halves of the key
//   steps; the halves' m and l meet in shared memory before the second walk,
//   their P V sums after it (added in a fixed order); O stored 16 bytes a lane.
constexpr int NF64_RESIDENT_KEYS = 128, NF80_RESIDENT_KEYS = 512;
// the route codes the entries report for these kernels (ops/_cuda.py::ROUTES)
constexpr int kRouteWgmmaResident = 5, kRouteMmaResident = 6;
constexpr int kMaxSmem = 232448;  // shared memory a block can have on the H100

template <int NC_>
struct NfRes64 {
  static constexpr int NC = NC_;                  // the keys of the S product
  static constexpr int NWG = NC == 80 ? 3 : 2;    // consumer warpgroups (a register cap of 152 / 224)
  static constexpr int THREADS = 128 * NWG + 32;  // then the producer warp
  static constexpr int STAGES = 3 * NWG;          // Q tiles in the ring; a multiple of NWG, so a stage's
                                                  // tiles are one warpgroup's and its parity is never stale
  static constexpr int TILE = 64 * 128;           // a 64-row Q or O tile of 128-byte rows
  static constexpr int OBUFS = 2;                 // O staging tiles a warpgroup
  static constexpr int KV_BYTES = NC * 128;       // K or V of a (b, h)
  static constexpr int RING = STAGES * TILE, OUT = NWG * OBUFS * TILE, KV = RING + OUT;  // two K / V buffers
  static constexpr int BARS = KV + 4 * KV_BYTES;  // full, empty [STAGES]; kv_full, kv_empty [2]
  static constexpr int SMEM = 1024 + BARS + 8 * (2 * STAGES + 4);
  static_assert(STAGES % NWG == 0 && KV_BYTES % 1024 == 0 && SMEM <= kMaxSmem, "layout");
};

template <class C>
__global__ void __launch_bounds__(C::THREADS, 1) flash_fwd_nf64_resident_kernel(
    const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
    const __grid_constant__ CUtensorMap vmap, const __grid_constant__ CUtensorMap omap, int H, int Lk, int qtiles,
    long long items, float qscale) {
  constexpr int NC = C::NC, NWG = C::NWG, STAGES = C::STAGES, TILE = C::TILE, OBUFS = C::OBUFS;
  constexpr int NS = NC / 2, KSTEPS = NC / 16, KV_BYTES = C::KV_BYTES;
  constexpr float NEG_INF = -INFINITY;
  extern __shared__ unsigned char flash_smem[];
  const uint32_t ring = smem_u32(smem_align_1024(flash_smem));
  const uint32_t obase = ring + C::RING, kvbase = ring + C::KV;  // buffer i: K at kvbase + 2 i KV_BYTES, then V
  const uint32_t full_bar = ring + C::BARS, empty_bar = full_bar + 8 * STAGES;
  const uint32_t kv_full = empty_bar + 8 * STAGES, kv_empty = kv_full + 16;
  const int tid = threadIdx.x, wg = tid >> 7;
  // this block's run of work items: (b, h) major, then the 64-row query tiles
  const long long first = items * blockIdx.x / gridDim.x, last = items * (blockIdx.x + 1) / gridDim.x;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full_bar + 8 * s, 1);
      mbar_init(empty_bar + 8 * s, 1);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mbar_init(kv_full + 8 * i, 1);
      mbar_init(kv_empty + 8 * i, NWG);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == NWG) {
    // the producer warp: its first thread loads each (b, h)'s K and V once, into
    // the buffer its last user but one has handed back, and keeps the Q ring full
    if (tid == 128 * NWG) {
      int gen = -1, cur = -1;
      for (long long it = first; it < last; ++it) {
        const int bh = (int)(it / qtiles), tile = (int)(it - (long long)bh * qtiles), b = bh / H, h = bh - b * H;
        if (bh != cur) {
          cur = bh;
          ++gen;
          const int buf = gen & 1;
          if (gen >= 2) mbar_wait(kv_empty + 8 * buf, (gen / 2 - 1) & 1);
          const uint32_t sk = kvbase + buf * 2 * KV_BYTES, bar = kv_full + 8 * buf;
          mbar_expect_tx(bar, 2 * KV_BYTES);
          tma_load_4d(sk, &kmap, bar, 0, 0, h, b);
          tma_load_4d(sk + KV_BYTES, &vmap, bar, 0, 0, h, b);
        }
        const int i = (int)(it - first), stage = i % STAGES;
        if (i >= STAGES) mbar_wait(empty_bar + 8 * stage, (i / STAGES - 1) & 1);
        mbar_expect_tx(full_bar + 8 * stage, TILE);
        tma_load_4d(ring + stage * TILE, &qmap, full_bar + 8 * stage, 0, tile * 64, h, b);
      }
    }
    return;
  }

  const int t = tid & 127, warp = t >> 5, lane = tid & 31, gid = lane >> 2, tig = lane & 3;
  const int wsync = 1 + wg;          // this warpgroup's named barrier
  const int r_lo = warp * 16 + gid;  // this lane's rows of a tile: r_lo, r_lo + 8
  float s[NS], acc[32];
  int gen = -1, cur = -1, done = 0;
  for (long long it = first; it < last; ++it) {
    const int bh = (int)(it / qtiles);
    if (bh != cur) {
      // every warpgroup passes every (b, h) of the run: done with the last one's
      // K / V, it waits for this one's, so an arrival for a buffer never runs
      // ahead of the phase it belongs to
      if (gen >= 0 && t == 0) mbar_arrive(kv_empty + 8 * (gen & 1));
      cur = bh;
      ++gen;
      mbar_wait(kv_full + 8 * (gen & 1), (gen / 2) & 1);
    }
    const int i = (int)(it - first);
    if (i % NWG != wg) continue;  // the warpgroups take the run's tiles in turn
    const int tile = (int)(it - (long long)bh * qtiles), b = bh / H, h = bh - b * H, stage = i % STAGES;
    const uint32_t sq = ring + stage * TILE, sk = kvbase + (gen & 1) * 2 * KV_BYTES, sv = sk + KV_BYTES;
    mbar_wait(full_bar + 8 * stage, (i / STAGES) & 1);

    // S = Q K^T from the unscaled q (s[e]: row r_lo + 8 ((e >> 1) & 1), key
    // 8 (e >> 2) + 2 tig + (e & 1)), then the Q tile goes back to the ring
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t da = wgmma_desc(sq + kk * 32, 16, 1024), db = wgmma_desc(sk + kk * 32, 16, 1024);
      if constexpr (NC == 80)
        wgmma_m64n80k16_ss(s, da, db, kk);
      else
        wgmma_m64n128k16_ss(s, da, db, kk);
    }
    wgmma_commit();
    wgmma_wait<0>();
    wgmma_fence_regs(s);
    if (t == 0) mbar_arrive(empty_bar + 8 * stage);
    // times qscale in fp32, keys past Lk at -inf; the rows' max m and fp32 sum
    // l of exp2(s - m), all before any p is rounded
    const int live = Lk - tig * 2;  // this lane's columns below it hold keys
    float mx[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
#pragma unroll
    for (int e = 0; e < NS; ++e) {
      s[e] *= qscale;
      if ((e >> 2) * 8 + (e & 1) >= live) s[e] = NEG_INF;
      mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], s[e]);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    }
#pragma unroll
    for (int e = 0; e < NS; ++e) {
      s[e] = exp2f(s[e] - mx[(e >> 1) & 1]);
      l[(e >> 1) & 1] += s[e];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {  // the whole row's sum in every lane of its quad
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
    // p = exp2(s - m) times 1 / l in fp32, rounded to bf16 into the A fragments; O = P V
    const float inv[2] = {1.f / l[0], 1.f / l[1]};
    uint32_t pa[KSTEPS][4];
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk)
#pragma unroll
      for (int qq = 0; qq < 4; ++qq) {
        const int e = 8 * kk + 2 * qq, r = qq & 1;
        pa[kk][qq] = pack_bf16x2(s[e] * inv[r], s[e + 1] * inv[r]);
      }
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[e] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk)
      wgmma_m64n64k16_rs_tb(acc, pa[kk], wgmma_desc(sv + kk * 16 * 128, KV_BYTES, 1024), 1);
    wgmma_commit();
    wgmma_wait<0>();
    wgmma_fence_regs(acc);
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk)  // p's registers stay untouched until the products have read them
#pragma unroll
      for (int qq = 0; qq < 4; ++qq) asm volatile("" : "+r"(pa[kk][qq])::"memory");

    // O rounded once into one of this warpgroup's staging tiles (swizzled 16-byte
    // chunks, the box layout), then one TMA store: rows past Lq are dropped
    const uint32_t so = obase + (wg * OBUFS + done % OBUFS) * TILE;
    ++done;
    if (t == 0) tma_store_wait_read<OBUFS - 1>();  // the store that read this staging tile last is done with it
    bar_sync(wsync, 128);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const uint32_t val = pack_bf16x2(acc[4 * n + 2 * r], acc[4 * n + 2 * r + 1]);
        asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(so + sw128(r_lo + 8 * r, n) + tig * 4), "r"(val) : "memory");
      }
    fence_proxy_async();
    bar_sync(wsync, 128);
    if (t == 0) {
      tma_store_4d(&omap, so, 0, tile * 64, h, b);
      tma_store_commit();
    }
  }
  if (t == 0) tma_store_wait_read();  // the staging tiles are read; the stores complete with the grid
}

// o [B, L, H, 64] through its (batch, row, head) strides: boxes of 64 d x 64 rows
inline int flash64_out_map(void* o, int B, int H, int Lq, const long long* s, CUtensorMap* map) {
  const cuuint64_t dims[4] = {64, (cuuint64_t)Lq, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)s[1] * 2, (cuuint64_t)s[2] * 2, (cuuint64_t)s[0] * 2};
  const cuuint32_t box[4] = {64, 64, 1, 1};
  return wgmma_tiled_map(o, 4, dims, strides, box, map);
}

template <int NC>
int launch_nf64_resident(const void* q, const void* k, const void* v, void* o, int B, int H, int Lq, int Lk,
                         const long long* st, float qscale, cudaStream_t stream) {
  using C = NfRes64<NC>;
  if (!flash_vec_rows_ok(q, k, v, o, st)) return kErrBadArgument;
  static const cudaError_t attr = cudaFuncSetAttribute(flash_fwd_nf64_resident_kernel<C>,
                                                       cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (attr != cudaSuccess) return (int)attr;
  int sms = 0;
  if (const int rc = device_sms(&sms)) return rc;
  CUtensorMap maps[4];
  if (const int rc = flash64_maps(q, k, v, B, H, Lq, Lk, st, 64, NC, maps)) return rc;
  if (const int rc = flash64_out_map(o, B, H, Lq, st + 9, &maps[3])) return rc;
  const int qtiles = (Lq + 63) / 64;
  const long long items = (long long)B * H * qtiles;
  const int grid = items < sms ? (int)items : sms;  // a block an SM, or one a work item
  flash_fwd_nf64_resident_kernel<C><<<grid, C::THREADS, C::SMEM, stream>>>(maps[0], maps[1], maps[2], maps[3], H, Lk,
                                                                          qtiles, items, qscale);
  return (int)cudaGetLastError();
}

namespace nf80 {
constexpr int D = 80, BQ = 32, KB = 32, KSPLIT = 2, THREADS = 64 * KSPLIT;
constexpr int KS = D / 16, NO = D / 8, PART = D + 8;  // k-steps of S, n-tiles of O, a partial row in floats
__host__ __device__ inline int steps(int lk) { return (lk + KB - 1) / KB; }
// Shared memory for n key steps, byte offsets past a 1024-byte aligned base:
// q, K and V each as two panels, d 0..63 (128-byte rows under the 128-byte
// swizzle) and d 64..79 (32-byte rows under the 32-byte swizzle); the fp32
// partial outputs of key splits 1.. (then this block's bf16 output); each
// split's row max and sum; the mbarriers (q, then K of each step, V of each).
struct Smem {
  int qa, ka, va, qb, kb, vb, part, ml, bars, bytes;
  __host__ __device__ explicit Smem(int n)
      : qa(0), ka(BQ * 128), va(ka + n * KB * 128), qb(va + n * KB * 128), kb(qb + BQ * 32), vb(kb + n * KB * 32),
        part(vb + n * KB * 32), ml(part + (KSPLIT - 1) * BQ * PART * 4), bars(ml + KSPLIT * BQ * 2 * 4),
        bytes(bars + 8 * (1 + 2 * n) + 1024) {}
};
}  // namespace nf80

// Byte address of 16-byte chunk c (0..9) of row r of a panel pair: chunks 0..7
// in the 128-byte-row panel at a, 8..9 in the 32-byte-row panel at b.
__device__ __forceinline__ uint32_t nf80_chunk(uint32_t a, uint32_t b, int r, int c) {
  return c < 8 ? a + sw128(r, c) : b + r * 32 + (((c - 8) ^ ((r >> 2) & 1)) << 4);
}

__device__ __forceinline__ void ldsm_x4(uint32_t r[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t r[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__global__ void __launch_bounds__(nf80::THREADS) flash_fwd_nf80_resident_kernel(
    const __grid_constant__ CUtensorMap qa_map, const __grid_constant__ CUtensorMap qb_map,
    const __grid_constant__ CUtensorMap ka_map, const __grid_constant__ CUtensorMap kb_map,
    const __grid_constant__ CUtensorMap va_map, const __grid_constant__ CUtensorMap vb_map,
    __nv_bfloat16* __restrict__ o, int H, int Lq, int Lk, long long osb, long long osl, long long osh,
    float qscale) {
  using namespace nf80;
  constexpr float NEG_INF = -INFINITY;
  extern __shared__ unsigned char flash_smem[];
  unsigned char* base = smem_align_1024(flash_smem);
  const uint32_t sb = smem_u32(base);
  const int nsteps = steps(Lk);
  const Smem L(nsteps);
  const uint32_t q_bar = sb + L.bars, k_bar = q_bar + 8, v_bar = k_bar + 8 * nsteps;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, gid = lane >> 2, tig = lane & 3;
  const int rg = warp & 1, kh = warp >> 1;  // this warp's 16 rows of the tile, and its share of the key steps
  const int b = blockIdx.y / H, h = blockIdx.y % H, q0 = blockIdx.x * BQ;

  if (tid == 0) {
    mbar_init(q_bar, 1);
    for (int j = 0; j < 2 * nsteps; ++j) mbar_init(k_bar + 8 * j, 1);
    mbar_init_fence();
    // the tile's q, then each key step's K, then each one's V (rows past L arrive as zeros)
    mbar_expect_tx(q_bar, BQ * D * 2);
    tma_load_4d(sb + L.qa, &qa_map, q_bar, 0, q0, h, b);
    tma_load_4d(sb + L.qb, &qb_map, q_bar, 64, q0, h, b);
    for (int j = 0; j < nsteps; ++j) {
      mbar_expect_tx(k_bar + 8 * j, KB * D * 2);
      tma_load_4d(sb + L.ka + j * KB * 128, &ka_map, k_bar + 8 * j, 0, j * KB, h, b);
      tma_load_4d(sb + L.kb + j * KB * 32, &kb_map, k_bar + 8 * j, 64, j * KB, h, b);
    }
    for (int j = 0; j < nsteps; ++j) {
      mbar_expect_tx(v_bar + 8 * j, KB * D * 2);
      tma_load_4d(sb + L.va + j * KB * 128, &va_map, v_bar + 8 * j, 0, j * KB, h, b);
      tma_load_4d(sb + L.vb + j * KB * 32, &vb_map, v_bar + 8 * j, 64, j * KB, h, b);
    }
  }
  __syncthreads();

  // this warp's q as A fragments (ldmatrix x4: rows 16 rg + (lane & 7) + 8 ((lane >> 3) & 1), chunk 2 ks + (lane >> 4))
  mbar_wait(q_bar, 0);
  uint32_t qf[KS][4];
  {
    const int r = rg * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) ldsm_x4(qf[ks], nf80_chunk(sb + L.qa, sb + L.qb, r, 2 * ks + (lane >> 4)));
  }
  // S of key step j for this warp's 16 rows, from the unscaled q, times qscale
  // in fp32, keys past Lk at -inf; s[t][0..1] are row 16 rg + gid, s[t][2..3]
  // row 16 rg + gid + 8, at keys KB j + 8 t + 2 tig + {0, 1}
  auto step_s = [&](float (&s)[4][4], int j) {
#pragma unroll
    for (int t = 0; t < 4; ++t) s[t][0] = s[t][1] = s[t][2] = s[t][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {  // ldmatrix x4: the B fragments of key tiles 2 jj and 2 jj + 1
        uint32_t bk[4];
        const int r = j * KB + (2 * jj + (lane >> 4)) * 8 + (lane & 7);
        ldsm_x4(bk, nf80_chunk(sb + L.ka, sb + L.kb, r, 2 * ks + ((lane >> 3) & 1)));
        mma_bf16_16816(s[2 * jj], qf[ks], bk[0], bk[1]);
        mma_bf16_16816(s[2 * jj + 1], qf[ks], bk[2], bk[3]);
      }
    }
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        s[t][u] *= qscale;
        if (j * KB + t * 8 + tig * 2 + (u & 1) >= Lk) s[t][u] = NEG_INF;
      }
  };

  // the first walk over this warp's key steps: the row max and the fp32 sum of
  // exp2(s - m), rescaled online
  float m_run[2] = {NEG_INF, NEG_INF};
  float l_part[2] = {0.f, 0.f};  // this lane's share of the row sums
  for (int j = kh; j < nsteps; j += KSPLIT) {
    mbar_wait(k_bar + 8 * j, 0);
    float s[4][4];
    step_s(s, j);
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int u = 0; u < 4; ++u) mx[u >> 1] = fmaxf(mx[u >> 1], s[t][u]);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m_run[i], mx[i]);  // finite: the step's first key is live
      l_part[i] *= exp2f(m_run[i] - m_new);
      m_run[i] = m_new;
    }
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int u = 0; u < 4; ++u) l_part[u >> 1] += exp2f(s[t][u] - m_run[u >> 1]);
  }
  // each split's m and l of the tile's rows, then the rows' m and l over the splits in their order
  float* ml = reinterpret_cast<float*>(base + L.ml);  // [KSPLIT][BQ][2]
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_part[i] += __shfl_xor_sync(0xffffffffu, l_part[i], 1);
    l_part[i] += __shfl_xor_sync(0xffffffffu, l_part[i], 2);
    if (tig == 0) {
      ml[(kh * BQ + rg * 16 + gid + 8 * i) * 2] = m_run[i];
      ml[(kh * BQ + rg * 16 + gid + 8 * i) * 2 + 1] = l_part[i];
    }
  }
  __syncthreads();
  float m[2], inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = rg * 16 + gid + 8 * i;
    m[i] = NEG_INF;
#pragma unroll
    for (int k = 0; k < KSPLIT; ++k) m[i] = fmaxf(m[i], ml[(k * BQ + row) * 2]);
    float l = 0.f;  // a split with no key step holds m = -inf, l = 0: it adds 0
#pragma unroll
    for (int k = 0; k < KSPLIT; ++k) l += ml[(k * BQ + row) * 2 + 1] * exp2f(ml[(k * BQ + row) * 2] - m[i]);
    inv[i] = 1.f / l;
  }

  // the second walk: p = exp2(s - m) times 1 / l, rounded; acc += P V, 16 keys a k-step
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  for (int j = kh; j < nsteps; j += KSPLIT) {
    mbar_wait(v_bar + 8 * j, 0);
    float s[4][4];
    step_s(s, j);
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int u = 0; u < 4; ++u) s[t][u] = exp2f(s[t][u] - m[u >> 1]) * inv[u >> 1];
#pragma unroll
    for (int kk = 0; kk < KB / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16x2(s[2 * kk][0], s[2 * kk][1]), pack_bf16x2(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      // ldmatrix x4 trans: lanes 8i..8i+7 address matrix i = key rows KB j + 16 kk + (i & 1) 8 + (lane & 7)
      // at chunk n + (i >> 1), i.e. the B fragments of n-tiles n and n + 1
      const int r = j * KB + kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7);
#pragma unroll
      for (int n = 0; n < NO; n += 2) {
        uint32_t bv[4];
        ldsm_x4_t(bv, nf80_chunk(sb + L.va, sb + L.vb, r, n + (lane >> 4)));
        mma_bf16_16816(acc[n], pa, bv[0], bv[1]);
        mma_bf16_16816(acc[n + 1], pa, bv[2], bv[3]);
      }
    }
  }

  // O: the splits' partial sums added in their order in fp32 by split 0's warps,
  // rounded once, staged in their own rows of split 1's partials, stored 16 bytes a lane
  float* part = reinterpret_cast<float*>(base + L.part);  // [KSPLIT - 1][BQ][PART]
  if (kh > 0) {
    float* pr = part + ((kh - 1) * BQ + rg * 16) * PART;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int n = 0; n < NO; ++n)
        *reinterpret_cast<float2*>(pr + (gid + 8 * i) * PART + n * 8 + tig * 2) =
            make_float2(acc[n][2 * i], acc[n][2 * i + 1]);
  }
  __syncthreads();
  if (kh > 0) return;
#pragma unroll
  for (int k = 1; k < KSPLIT; ++k) {
    const float* pr = part + ((k - 1) * BQ + rg * 16) * PART;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        const float2 x = *reinterpret_cast<const float2*>(pr + (gid + 8 * i) * PART + n * 8 + tig * 2);
        acc[n][2 * i] += x.x;
        acc[n][2 * i + 1] += x.y;
      }
  }
  __syncwarp();
  __nv_bfloat16* stage = reinterpret_cast<__nv_bfloat16*>(part + rg * 16 * PART);  // rows of PART bf16
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<uint32_t*>(stage + (gid + 8 * i) * PART + n * 8 + tig * 2) =
          pack_bf16x2(acc[n][2 * i], acc[n][2 * i + 1]);
  __syncwarp();
  __nv_bfloat16* ob = o + b * osb + h * osh;
  for (int e = lane; e < 16 * NO; e += 32) {
    const int r = e / NO, c = e % NO, row = q0 + rg * 16 + r;
    if (row < Lq)
      *reinterpret_cast<uint4*>(ob + (long long)row * osl + c * 8) =
          *reinterpret_cast<const uint4*>(stage + r * PART + c * 8);
  }
}

// q, k or v [B, L, H, 80] through its (batch, row, head) strides as two tiled
// maps, boxes of 32 rows: d 0..63 (128-byte swizzle) and d 64..79 (32-byte swizzle)
inline int nf80_maps(const void* x, int B, int H, int L, const long long* s, CUtensorMap* a, CUtensorMap* b) {
  const cuuint64_t dims[4] = {(cuuint64_t)nf80::D, (cuuint64_t)L, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)s[1] * 2, (cuuint64_t)s[2] * 2, (cuuint64_t)s[0] * 2};
  const cuuint32_t box_a[4] = {64, nf80::KB, 1, 1}, box_b[4] = {16, nf80::KB, 1, 1};
  if (const int rc = wgmma_tiled_map(x, 4, dims, strides, box_a, a)) return rc;
  return tma_tiled_map(CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, CU_TENSOR_MAP_SWIZZLE_32B, x, 4, dims, strides, box_b, b);
}

int launch_nf80_resident(const void* q, const void* k, const void* v, void* o, int B, int H, int Lq, int Lk,
                         const long long* st, float qscale, cudaStream_t stream) {
  if (!flash_vec_rows_ok(q, k, v, o, st)) return kErrBadArgument;
  static const cudaError_t attr =
      cudaFuncSetAttribute(flash_fwd_nf80_resident_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           nf80::Smem(nf80::steps(NF80_RESIDENT_KEYS)).bytes);
  if (attr != cudaSuccess) return (int)attr;
  CUtensorMap maps[6];
  const void* xs[3] = {q, k, v};
  const int lens[3] = {Lq, Lk, Lk};
  for (int i = 0; i < 3; ++i)
    if (const int rc = nf80_maps(xs[i], B, H, lens[i], st + 3 * i, &maps[2 * i], &maps[2 * i + 1])) return rc;
  dim3 grid((Lq + nf80::BQ - 1) / nf80::BQ, B * H);
  flash_fwd_nf80_resident_kernel<<<grid, nf80::THREADS, nf80::Smem(nf80::steps(Lk)).bytes, stream>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], maps[5], static_cast<__nv_bfloat16*>(o), H, Lq, Lk, st[9],
      st[10], st[11], qscale);
  return (int)cudaGetLastError();
}

// Two shapes of one kernel, chosen from Lk (times on the card in PERF.md):
// - long key walks (Lk > 2048, the ds1 self-attention: 5824 keys): two
//   warpgroups per block taking turns on the tensor cores, 128-key tiles;
// - shorter ones (ds2, ds4, mid, the 77-key cross-attention): one warpgroup per
//   block and three blocks per SM, 64-key tiles through a four-stage ring: the
//   blocks' softmaxes and products interleave on their own, and a block's
//   prologue and epilogue overlap the other blocks' work.
using F64Long = F64<2, 128, 3, 1>;
using F64Short = F64<1, 64, 4, 3>;

template <bool SUM_ROUNDED>
int launch_flash_wgmma64(const void* q, const void* k, const void* v, void* o, float* lse, int B, int H,
                         int Lq, int Lk, const long long* st, float qscale, cudaStream_t stream) {
  if (Lk > 2048)
    return launch_flash_wgmma64_cfg<F64Long, SUM_ROUNDED>(q, k, v, o, lse, B, H, Lq, Lk, st, qscale, stream);
  return launch_flash_wgmma64_cfg<F64Short, SUM_ROUNDED>(q, k, v, o, lse, B, H, Lq, Lk, st, qscale, stream);
}

// bf16 D = 64 by sum mode: the flash kernel with the fp32 (0) or the rounded
// (1) sum, or normalise first on the kernel that streams the keys (2, 3)
inline int launch_flash_wgmma64_mode(int mode, const void* q, const void* k, const void* v, void* o, float* lse,
                                     int B, int H, int Lq, int Lk, const long long* st, float qscale,
                                     cudaStream_t stream) {
  if (mode >= 2) return launch_flash_wgmma64_nf(q, k, v, o, B, H, Lq, Lk, st, qscale, stream);
  return mode ? launch_flash_wgmma64<true>(q, k, v, o, lse, B, H, Lq, Lk, st, qscale, stream)
              : launch_flash_wgmma64<false>(q, k, v, o, lse, B, H, Lq, Lk, st, qscale, stream);
}

inline bool flash_sizes_ok(int B, int H, int Lq, int Lk) {
  return B > 0 && H > 0 && Lq > 0 && Lk > 0 && B * H <= 65535;  // the grid's y limit
}

// bf16 by head dim and sum mode: the head dims the tuned kernels were built for
// (D = 64 on wgmma, 80 on mma.sync, 512 on wgmma), and any other D a config
// produces as an instance of the mma.sync template (D = 16: the tiny configs);
// one more D is one more case. The D = 512 kernel has no normalise-first mode
// (no path runs a bf16 D = 512 site shorter than 512). Normalise first at D = 64
// and 80: the resident kernels where the keys fit (mode 2), else and in mode 3
// the streaming ones; at D = 16 the template's mode 2. route: 2 wgmma, 1
// mma.sync, 5 the resident D = 64 kernel (wgmma), 6 the resident D = 80 one
// (mma.sync).
inline int flash_bf16_by_dim(int D, int mode, const void* q, const void* k, const void* v, void* o, float* lse,
                             int B, int H, int Lq, int Lk, const long long* st, float qscale, cudaStream_t s,
                             int* route) {
  const bool resident = mode == 2 && ((D == 64 && Lk <= NF64_RESIDENT_KEYS) || (D == 80 && Lk <= NF80_RESIDENT_KEYS));
  if (resident && D == 64) {
    *route = kRouteWgmmaResident;
    return Lk <= 80 ? launch_nf64_resident<80>(q, k, v, o, B, H, Lq, Lk, st, qscale, s)
                    : launch_nf64_resident<128>(q, k, v, o, B, H, Lq, Lk, st, qscale, s);
  }
  if (resident) {
    *route = kRouteMmaResident;
    return launch_nf80_resident(q, k, v, o, B, H, Lq, Lk, st, qscale, s);
  }
  switch (D) {
    case 16:
      *route = 1;
      return mode >= 2 ? launch_flash_mma<16, 2>(q, k, v, o, lse, B, H, Lq, Lk, st, qscale, s)
             : mode    ? launch_flash_mma<16, 1>(q, k, v, o, lse, B, H, Lq, Lk, st, qscale, s)
                       : launch_flash_mma<16, 0>(q, k, v, o, lse, B, H, Lq, Lk, st, qscale, s);
    case 64:
      *route = 2;
      return launch_flash_wgmma64_mode(mode, q, k, v, o, lse, B, H, Lq, Lk, st, qscale, s);
    case 80:
      *route = 1;
      return mode >= 2 ? launch_flash_mma<80, 2>(q, k, v, o, lse, B, H, Lq, Lk, st, qscale, s)
             : mode    ? launch_flash_mma<80, 1>(q, k, v, o, lse, B, H, Lq, Lk, st, qscale, s)
                       : launch_flash_mma<80, 0>(q, k, v, o, lse, B, H, Lq, Lk, st, qscale, s);
    case 512:
      *route = 2;
      return mode >= 2 ? kErrUnsupported
             : mode    ? launch_flash_wgmma512<true>(q, k, v, o, lse, B, H, Lq, Lk, st, qscale, s)
                       : launch_flash_wgmma512<false>(q, k, v, o, lse, B, H, Lq, Lk, st, qscale, s);
    default:
      return kErrUnsupported;
  }
}

// the entries' common body: sizes and mode checked, bf16 by head dim, fp32 on the FMA kernel
inline int flash_entry(int dtype, int D, const void* q, const void* k, const void* v, void* o, void* lse, int B,
                       int H, int Lq, int Lk, const long long* strides, float qscale, int sum_mode, int* route,
                       void* stream) {
  if (!flash_sizes_ok(B, H, Lq, Lk) || sum_mode < 0 || sum_mode > 3 || (sum_mode >= 2 && lse != nullptr))
    return kErrBadArgument;
  float* l = static_cast<float*>(lse);
  int r = -1, rc = kErrUnsupported;
  if (dtype == kBFloat16) {
    rc = flash_bf16_by_dim(D, sum_mode, q, k, v, o, l, B, H, Lq, Lk, strides, qscale,
                           static_cast<cudaStream_t>(stream), &r);
  } else if (dtype == kFloat32) {
    rc = flash_entry_fp32(D, q, k, v, o, l, B, H, Lq, Lk, strides, qscale, stream, &r);
  }
  if (route != nullptr) *route = r;
  return rc;
}

}  // namespace vs

// strides: 12 element strides (batch, row, head) for q, k, v, o in that order;
// the head-dim stride must be 1. D in {16, 64}, and 512 at one head (H = 1: the
// packed [B, L, 512] rows are K3's [B, 1, L, 512], so K3's D = 512 kernel runs
// them; the VideoDecoder's VideoAttnBlock). bf16 needs 16-byte aligned rows (or
// kErrBadArgument); fp32 runs the split-TF32 kernels at D = 512 (16-byte aligned
// rows too) and at D = 64 where TMA can address q, k and v, the FMA kernel at 16
// and at D = 64 otherwise.
// lse: NULL, or fp32 [B, Lq, H] contiguous for the base-2 logsumexp.
// sum_mode: 1, the denominator sums the p rounded to bf16; 0, the fp32 p; 2,
// normalise first (qscale then multiplies the fp32 logits; no lse; not at D =
// 512); 3, normalise first on the kernel that streams the keys from device
// memory (what mode 2 runs past the resident kernels' keys; at D = 16, mode 2).
// No effect in fp32.
// route (or NULL) receives the kernel that ran: 2 wgmma, 1 mma.sync, 0 fp32 FMAs,
// 5 and 6 the resident normalise-first kernels at D = 64 (wgmma) and 80 (mma.sync),
// 7 fp32 D = 512 (wgmma) and D = 64 (mma.sync) on split TF32 products.
extern "C" int vs_flash_attention_packed(int dtype, int D, const void* q, const void* k,
                                         const void* v, void* o, void* lse, int B, int H,
                                         int Lq, int Lk, const long long* strides,
                                         float qscale, int sum_mode, int* route, void* stream) {
  if (D != 16 && D != 64 && !(D == 512 && H == 1)) return vs::kErrUnsupported;
  return vs::flash_entry(dtype, D, q, k, v, o, lse, B, H, Lq, Lk, strides, qscale, sum_mode, route, stream);
}

// D in {16, 64, 80, 512}: bf16 runs wgmma at 64 and 512, mma.sync at 16 and 80;
// the normalise-first mode at 16, 64 and 80. lse: NULL (inference), or fp32 [B,
// Lq, H] contiguous under a gradient. sum_mode and route as above.
extern "C" int vs_flash_attention_bhld(int dtype, int D, const void* q, const void* k,
                                       const void* v, void* o, void* lse, int B, int H, int Lq,
                                       int Lk, const long long* strides, float qscale, int sum_mode,
                                       int* route, void* stream) {
  return vs::flash_entry(dtype, D, q, k, v, o, lse, B, H, Lq, Lk, strides, qscale, sum_mode, route, stream);
}

extern "C" const char* vs_error_string(int code) {
  if (code == vs::kErrUnsupported) return "dtype or size not built into the kernel";
  if (code == vs::kErrBadArgument) return "size or alignment out of the kernel's range";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
