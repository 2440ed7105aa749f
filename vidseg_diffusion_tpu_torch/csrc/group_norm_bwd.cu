// K9 group_norm_backward_stats and K10 group_norm_backward_apply: the
// GroupNorm (+ SiLU) backward in coefficient form on a channels-last
// activation [B, R, C] in its storage dtype, fp32 sums.
//
// Replaces (TPU): vidseg_diffusion_tpu/ops/norm.py:_gn_bwd_stats_kernel (K9)
// and _gn_bwd_apply_kernel (K10), both reached through _gn_bwd_pallas, with
// the [B, C] / [B, G] coefficient math of _gn_bwd_pallas folded into K9's
// finishing step.
//
// With xhat = (x - mean) * inv and u the gradient that reaches the affine
// output z = gamma * xhat + beta, the GroupNorm backward is affine in (u, x)
// per (batch, channel):  dx = a2 * u + b2 * x + c2, with
//   a2 = inv * gamma,  b2 = -inv^2 * m2,  c2 = inv * (mean * inv * m2 - m1),
//   m1 = mean_g(u * gamma),  m2 = mean_g(u * gamma * xhat),
// and dgamma = sum u * xhat, dbeta = sum u come from the same two sums
// r1 = sum u, rx = sum u * x per (batch, channel). Without SiLU u is dy (what
// the TPU kernels compute). With SiLU the forward's output is z * sigmoid(z),
// and the kernels recompute z = a * x + s from the forward's per-channel a, s
// and use u = dy * sigmoid(z) * (1 + z * (1 - sigmoid(z))): no fp32 activation
// is ever stored.
//
// What bounds them on the H100: memory traffic. K9 reads x and dy once, K10
// reads both again and writes dx (2 and 3 activation passes). Same block
// layout, fixed-order partial sums and 16-byte accesses as the forward
// (group_norm.cuh).
#include "group_norm.cuh"

namespace vs {

template <bool SILU>
__device__ __forceinline__ float upstream(float dy, float x, float a, float s) {
  if (!SILU) return dy;
  const float z = fmaf(x, a, s);
  const float sg = sigmoidf(z);
  return dy * sg * (1.f + z * (1.f - sg));
}

template <typename T, int VEC, bool SILU>
__global__ void __launch_bounds__(kGnThreads) gn_bwd_stats_kernel(
    const T* __restrict__ x, const T* __restrict__ dy, const float* __restrict__ a,
    const float* __restrict__ s, float* __restrict__ partial, int R, int C,
    int rows_per_chunk) {
  const GnTile t = gn_tile<VEC>(R, C, rows_per_chunk);
  float r1[VEC], rx[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) r1[i] = rx[i] = 0.f;
  if (t.active) {
    float av[VEC], sv[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) av[i] = sv[i] = 0.f;
    if (SILU) {
      load_vec<float, VEC>(a + (size_t)blockIdx.z * C + t.col, av);
      load_vec<float, VEC>(s + (size_t)blockIdx.z * C + t.col, sv);
    }
    const size_t base = (size_t)blockIdx.z * R * C + t.col;
#pragma unroll 2
    for (int r = t.row0; r < t.row_end; r += t.row_step) {
      float xv[VEC], gv[VEC];
      load_vec<T, VEC>(x + base + (size_t)r * C, xv);
      load_vec<T, VEC>(dy + base + (size_t)r * C, gv);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const float u = upstream<SILU>(gv[i], xv[i], av[i], sv[i]);
        r1[i] += u;
        rx[i] = fmaf(u, xv[i], rx[i]);
      }
    }
  }
  gn_write_partial<VEC>(t, r1, rx, partial, C);
}

// One block per batch item, from the per-channel sums [B][2][C] (r1, rx): the
// group means m1, m2, then coef[b] = (a2, b2, c2) per channel and this batch
// item's share of the parameter gradients dparam[b] = (dgamma, dbeta) per
// channel.
__global__ void __launch_bounds__(kFinishThreads) gn_bwd_finish_kernel(
    const float* __restrict__ all_sums, const void* __restrict__ gamma, int wdtype,
    const float* __restrict__ mean, const float* __restrict__ inv, float* __restrict__ coef,
    float* __restrict__ dparam, int C, int G, float count) {
  extern __shared__ float sm[];
  float* gm1 = sm;       // [G]
  float* gm2 = sm + G;   // [G]
  const int cg = C / G, b = blockIdx.x;
  const float* sums = all_sums + (size_t)b * 2 * C;  // r1, then rx
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nwarps = blockDim.x >> 5;
  for (int g = warp; g < G; g += nwarps) {  // one warp per group, a fixed shuffle tree
    float su = 0.f, sux = 0.f;
    for (int j = lane; j < cg; j += 32) {
      const float w = load_param(gamma, g * cg + j, wdtype);
      su += sums[g * cg + j] * w;
      sux += sums[C + g * cg + j] * w;
    }
    su = warp_sum(su);
    sux = warp_sum(sux);
    if (lane == 0) {
      const float mu = mean[(size_t)b * G + g], iv = inv[(size_t)b * G + g];
      gm1[g] = su / count;
      gm2[g] = iv * (sux - mu * su) / count;
    }
  }
  __syncthreads();
  float* cf = coef + (size_t)b * 3 * C;
  float* dp = dparam + (size_t)b * 2 * C;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    const int g = c / cg;
    const float mu = mean[(size_t)b * G + g], iv = inv[(size_t)b * G + g];
    const float m1 = gm1[g], m2 = gm2[g];
    cf[c] = iv * load_param(gamma, c, wdtype);
    cf[C + c] = -iv * iv * m2;
    cf[2 * C + c] = iv * (mu * iv * m2 - m1);
    dp[c] = iv * (sums[C + c] - mu * sums[c]);
    dp[C + c] = sums[c];
  }
}

template <typename T, int VEC, bool SILU>
__global__ void __launch_bounds__(kGnThreads) gn_bwd_apply_kernel(
    const T* __restrict__ x, const T* __restrict__ dy, const float* __restrict__ a,
    const float* __restrict__ s, const float* __restrict__ coef, T* __restrict__ dx, int R,
    int C, int rows_per_chunk) {
  const GnTile t = gn_tile<VEC>(R, C, rows_per_chunk);
  if (!t.active) return;
  float av[VEC], sv[VEC], a2[VEC], b2[VEC], c2[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) av[i] = sv[i] = 0.f;
  if (SILU) {
    load_vec<float, VEC>(a + (size_t)blockIdx.z * C + t.col, av);
    load_vec<float, VEC>(s + (size_t)blockIdx.z * C + t.col, sv);
  }
  const float* cf = coef + (size_t)blockIdx.z * 3 * C + t.col;
  load_vec<float, VEC>(cf, a2);
  load_vec<float, VEC>(cf + C, b2);
  load_vec<float, VEC>(cf + 2 * C, c2);
  const size_t base = (size_t)blockIdx.z * R * C + t.col;
#pragma unroll 2
  for (int r = t.row0; r < t.row_end; r += t.row_step) {
    float xv[VEC], gv[VEC];
    load_vec<T, VEC>(x + base + (size_t)r * C, xv);
    load_vec<T, VEC>(dy + base + (size_t)r * C, gv);
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const float u = upstream<SILU>(gv[i], xv[i], av[i], sv[i]);
      gv[i] = fmaf(a2[i], u, fmaf(b2[i], xv[i], c2[i]));
    }
    store_vec<T, VEC>(dx + base + (size_t)r * C, gv);
  }
}

template <typename T, int VEC>
int launch_bwd_stats(const void* x, const void* dy, const float* a, const float* s,
                     float* partial, int B, int R, int C, int rows_per_chunk, int nchunks,
                     int silu, cudaStream_t stream) {
  const dim3 grid = gn_grid(B, C, VEC, nchunks);
  const T* xp = static_cast<const T*>(x);
  const T* gp = static_cast<const T*>(dy);
  if (silu)
    gn_bwd_stats_kernel<T, VEC, true><<<grid, kGnThreads, 0, stream>>>(xp, gp, a, s, partial, R,
                                                                        C, rows_per_chunk);
  else
    gn_bwd_stats_kernel<T, VEC, false><<<grid, kGnThreads, 0, stream>>>(xp, gp, a, s, partial, R,
                                                                         C, rows_per_chunk);
  return (int)cudaGetLastError();
}

template <typename T, int VEC>
int launch_bwd_apply(const void* x, const void* dy, const float* a, const float* s,
                     const float* coef, void* dx, int B, int R, int C, int rows_per_chunk,
                     int nchunks, int silu, cudaStream_t stream) {
  const dim3 grid = gn_grid(B, C, VEC, nchunks);
  const T* xp = static_cast<const T*>(x);
  const T* gp = static_cast<const T*>(dy);
  T* dp = static_cast<T*>(dx);
  if (silu)
    gn_bwd_apply_kernel<T, VEC, true><<<grid, kGnThreads, 0, stream>>>(xp, gp, a, s, coef, dp, R,
                                                                        C, rows_per_chunk);
  else
    gn_bwd_apply_kernel<T, VEC, false><<<grid, kGnThreads, 0, stream>>>(xp, gp, a, s, coef, dp,
                                                                         R, C, rows_per_chunk);
  return (int)cudaGetLastError();
}

}  // namespace vs

// x, dy: contiguous [B, R, C]; a, s: the forward's fp32 [B, C] scale and shift
// (read only with silu); partial: fp32 scratch of B * (nchunks + 1) * 2 * C values
// ([B, nchunks, 2, C] partial sums, then [B, 2, C] sums); gamma: [C] in
// wdtype; mean, inv: fp32 [B, G]; coef: fp32 [B, 3, C] (a2, b2, c2); dparam: fp32
// [B, 2, C] (dgamma, dbeta shares, to be summed over B).
extern "C" int vs_group_norm_bwd_stats(int dtype, const void* x, const void* dy, const void* a,
                                       const void* s, void* partial, const void* gamma,
                                       int wdtype, const void* mean, const void* inv,
                                       void* coef, void* dparam, int B, int R, int C, int G,
                                       int vec, int rows_per_chunk, int nchunks, int silu,
                                       void* stream) {
  using namespace vs;
  if (!gn_args_ok(B, R, C, vec, rows_per_chunk, nchunks) || G <= 0 || C % G || G > kMaxGroups)
    return kErrBadArgument;
  if (wdtype != kFloat32 && wdtype != kBFloat16) return kErrUnsupported;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* af = static_cast<const float*>(a);
  const float* sf = static_cast<const float*>(s);
  float* part = static_cast<float*>(partial);
  int rc;
  if (dtype == kBFloat16 && vec == 8)
    rc = launch_bwd_stats<__nv_bfloat16, 8>(x, dy, af, sf, part, B, R, C, rows_per_chunk, nchunks, silu, st);
  else if (dtype == kBFloat16 && vec == 1)
    rc = launch_bwd_stats<__nv_bfloat16, 1>(x, dy, af, sf, part, B, R, C, rows_per_chunk, nchunks, silu, st);
  else if (dtype == kFloat32 && vec == 4)
    rc = launch_bwd_stats<float, 4>(x, dy, af, sf, part, B, R, C, rows_per_chunk, nchunks, silu, st);
  else if (dtype == kFloat32 && vec == 1)
    rc = launch_bwd_stats<float, 1>(x, dy, af, sf, part, B, R, C, rows_per_chunk, nchunks, silu, st);
  else
    return kErrUnsupported;
  if (rc != 0) return rc;
  float* sums = part + (size_t)B * nchunks * 2 * C;
  rc = gn_launch_reduce(part, sums, B, nchunks, C, st);
  if (rc != 0) return rc;
  const float count = (float)((double)R * (double)(C / G));
  gn_bwd_finish_kernel<<<B, kFinishThreads, sizeof(float) * 2 * G, st>>>(
      sums, gamma, wdtype, static_cast<const float*>(mean), static_cast<const float*>(inv),
      static_cast<float*>(coef), static_cast<float*>(dparam), C, G, count);
  return (int)cudaGetLastError();
}

// dx = a2 * u + b2 * x + c2 with u as in K9; dx contiguous [B, R, C].
extern "C" int vs_group_norm_bwd_apply(int dtype, const void* x, const void* dy, const void* a,
                                       const void* s, const void* coef, void* dx, int B, int R,
                                       int C, int vec, int rows_per_chunk, int nchunks,
                                       int silu, void* stream) {
  using namespace vs;
  if (!gn_args_ok(B, R, C, vec, rows_per_chunk, nchunks)) return kErrBadArgument;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* af = static_cast<const float*>(a);
  const float* sf = static_cast<const float*>(s);
  const float* cf = static_cast<const float*>(coef);
  if (dtype == kBFloat16 && vec == 8)
    return launch_bwd_apply<__nv_bfloat16, 8>(x, dy, af, sf, cf, dx, B, R, C, rows_per_chunk, nchunks, silu, st);
  if (dtype == kBFloat16 && vec == 1)
    return launch_bwd_apply<__nv_bfloat16, 1>(x, dy, af, sf, cf, dx, B, R, C, rows_per_chunk, nchunks, silu, st);
  if (dtype == kFloat32 && vec == 4)
    return launch_bwd_apply<float, 4>(x, dy, af, sf, cf, dx, B, R, C, rows_per_chunk, nchunks, silu, st);
  if (dtype == kFloat32 && vec == 1)
    return launch_bwd_apply<float, 1>(x, dy, af, sf, cf, dx, B, R, C, rows_per_chunk, nchunks, silu, st);
  return kErrUnsupported;
}
