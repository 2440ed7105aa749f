// K7 group_norm_stats and K8 group_norm_apply: GroupNorm (+ SiLU) forward on a
// channels-last activation [B, R, C] in its storage dtype, fp32 statistics.
//
// Replaces (TPU): vidseg_diffusion_tpu/ops/norm.py:_stats_kernel (via
// _stats_pallas; K7) and _apply_kernel (via group_norm_silu; K8), with the
// [B, C] -> [B, G] math of _affine_from_stats folded into K7's finishing step.
//
// What bounds them on the H100: memory traffic alone. K7 reads x once (a few
// flops per element), K8 reads x once and writes y once; at [28, 56, 104, 320]
// bf16 that is 104 MB and 208 MB. Design (group_norm.cuh): blocks over (row
// chunk, channel tile, batch item), 16-byte loads along C, per-channel sums in
// registers, one partial per block, a second kernel that adds the partials in
// a fixed order (deterministic, no atomics; the TPU kernel carries its sum
// across sequential grid steps, which parallel blocks cannot) and a third that
// folds groups into mean / inv-std and the per-channel scale a and shift s of
// y = x * a + s (three launches per K7 call). The TPU's row-tile padding has no counterpart: the ragged
// last chunk is a shorter loop. K8 keeps a and s of its channels in registers,
// computes in fp32 and rounds once at the store, as _apply_kernel does.
#include "group_norm.cuh"

namespace vs {

template <typename T, int VEC>
__global__ void __launch_bounds__(kGnThreads) gn_stats_kernel(
    const T* __restrict__ x, float* __restrict__ partial, int R, int C, int rows_per_chunk) {
  const GnTile t = gn_tile<VEC>(R, C, rows_per_chunk);
  float s[VEC], ss[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) s[i] = ss[i] = 0.f;
  if (t.active) {
    const T* base = x + (size_t)blockIdx.z * R * C + t.col;
#pragma unroll 4
    for (int r = t.row0; r < t.row_end; r += t.row_step) {
      float v[VEC];
      load_vec<T, VEC>(base + (size_t)r * C, v);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        s[i] += v[i];
        ss[i] = fmaf(v[i], v[i], ss[i]);
      }
    }
  }
  gn_write_partial<VEC>(t, s, ss, partial, C);
}

// The partial-sum reduction shared with the backward (declared in group_norm.cuh).
constexpr int kReduceCols = 64;
constexpr int kReduceSlices = 8;

__global__ void __launch_bounds__(kReduceCols * kReduceSlices) gn_reduce_partials_kernel(
    const float* __restrict__ partial, float* __restrict__ sums, int nchunks, int n2) {
  __shared__ float rows[kReduceSlices][kReduceCols];
  const int tx = threadIdx.x % kReduceCols, sl = threadIdx.x / kReduceCols;
  const int j = blockIdx.x * kReduceCols + tx;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  if (j < n2) {
    const float* mine = partial + (size_t)blockIdx.y * nchunks * n2 + j;
    int k = sl;
    for (; k + 3 * kReduceSlices < nchunks; k += 4 * kReduceSlices) {
#pragma unroll
      for (int u = 0; u < 4; ++u) acc[u] += mine[(size_t)(k + u * kReduceSlices) * n2];
    }
    for (; k < nchunks; k += kReduceSlices) acc[0] += mine[(size_t)k * n2];
  }
  rows[sl][tx] = (acc[0] + acc[1]) + (acc[2] + acc[3]);
  __syncthreads();
  if (sl == 0 && j < n2) {
    float a = 0.f;
#pragma unroll
    for (int s = 0; s < kReduceSlices; ++s) a += rows[s][tx];
    sums[(size_t)blockIdx.y * n2 + j] = a;
  }
}

int gn_launch_reduce(const float* partial, float* sums, int B, int nchunks, int C,
                            cudaStream_t stream) {
  const int n2 = 2 * C;
  const dim3 grid((unsigned)((n2 + kReduceCols - 1) / kReduceCols), (unsigned)B);
  gn_reduce_partials_kernel<<<grid, kReduceCols * kReduceSlices, 0, stream>>>(partial, sums,
                                                                             nchunks, n2);
  return (int)cudaGetLastError();
}

// One block per batch item, from the per-channel sums [B][2][C]: per group
// mean, clamped variance and inv-std, then a[b, c] = inv * gamma and
// s[b, c] = beta - mean * inv * gamma (norm.py:_affine_from_stats).
__global__ void __launch_bounds__(kFinishThreads) gn_stats_finish_kernel(
    const float* __restrict__ all_sums, const void* __restrict__ gamma,
    const void* __restrict__ beta, int wdtype, float* __restrict__ a_out,
    float* __restrict__ s_out, float* __restrict__ mean_out, float* __restrict__ inv_out,
    int C, int G, float count, float eps) {
  extern __shared__ float sm[];
  float* gmean = sm;      // [G]
  float* ginv = sm + G;   // [G]
  const int cg = C / G, b = blockIdx.x;
  const float* sums = all_sums + (size_t)b * 2 * C;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nwarps = blockDim.x >> 5;
  for (int g = warp; g < G; g += nwarps) {  // one warp per group, a fixed shuffle tree
    float gs = 0.f, gss = 0.f;
    for (int j = lane; j < cg; j += 32) {
      gs += sums[g * cg + j];
      gss += sums[C + g * cg + j];
    }
    gs = warp_sum(gs);
    gss = warp_sum(gss);
    if (lane == 0) {
      const float mean = gs / count;
      const float var = fmaxf(0.f, gss / count - mean * mean);
      const float inv = rsqrtf(var + eps);
      gmean[g] = mean;
      ginv[g] = inv;
      mean_out[(size_t)b * G + g] = mean;
      inv_out[(size_t)b * G + g] = inv;
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    const int g = c / cg;
    const float w = load_param(gamma, c, wdtype);
    a_out[(size_t)b * C + c] = ginv[g] * w;
    s_out[(size_t)b * C + c] = load_param(beta, c, wdtype) - gmean[g] * ginv[g] * w;
  }
}

template <typename T, int VEC, bool SILU>
__global__ void __launch_bounds__(kGnThreads) gn_apply_kernel(
    const T* __restrict__ x, const float* __restrict__ a, const float* __restrict__ s,
    T* __restrict__ y, int R, int C, int rows_per_chunk) {
  const GnTile t = gn_tile<VEC>(R, C, rows_per_chunk);
  if (!t.active) return;
  float av[VEC], sv[VEC];
  load_vec<float, VEC>(a + (size_t)blockIdx.z * C + t.col, av);
  load_vec<float, VEC>(s + (size_t)blockIdx.z * C + t.col, sv);
  const size_t base = (size_t)blockIdx.z * R * C + t.col;
#pragma unroll 4
  for (int r = t.row0; r < t.row_end; r += t.row_step) {
    float v[VEC];
    load_vec<T, VEC>(x + base + (size_t)r * C, v);
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      float z = fmaf(v[i], av[i], sv[i]);
      if (SILU) z = z * sigmoidf(z);
      v[i] = z;
    }
    store_vec<T, VEC>(y + base + (size_t)r * C, v);
  }
}

template <typename T, int VEC>
int launch_stats(const void* x, float* partial, int B, int R, int C, int rows_per_chunk,
                 int nchunks, cudaStream_t stream) {
  gn_stats_kernel<T, VEC><<<gn_grid(B, C, VEC, nchunks), kGnThreads, 0, stream>>>(
      static_cast<const T*>(x), partial, R, C, rows_per_chunk);
  return (int)cudaGetLastError();
}

template <typename T, int VEC>
int launch_apply(const void* x, const float* a, const float* s, void* y, int B, int R, int C,
                 int rows_per_chunk, int nchunks, int silu, cudaStream_t stream) {
  const dim3 grid = gn_grid(B, C, VEC, nchunks);
  if (silu)
    gn_apply_kernel<T, VEC, true><<<grid, kGnThreads, 0, stream>>>(
        static_cast<const T*>(x), a, s, static_cast<T*>(y), R, C, rows_per_chunk);
  else
    gn_apply_kernel<T, VEC, false><<<grid, kGnThreads, 0, stream>>>(
        static_cast<const T*>(x), a, s, static_cast<T*>(y), R, C, rows_per_chunk);
  return (int)cudaGetLastError();
}

}  // namespace vs

// x: contiguous [B, R, C]; partial: fp32 scratch of B * (nchunks + 1) * 2 * C
// values ([B, nchunks, 2, C] partial sums, then [B, 2, C] sums); gamma, beta:
// [C] in wdtype; a, s: fp32 [B, C]; mean, inv: fp32 [B, G]. vec is the channel
// vector width in elements: 16 bytes' worth (C % vec == 0, 16-byte aligned x),
// or 1.
extern "C" int vs_group_norm_stats(int dtype, const void* x, void* partial, const void* gamma,
                                   const void* beta, int wdtype, void* a, void* s, void* mean,
                                   void* inv, int B, int R, int C, int G, int vec,
                                   int rows_per_chunk, int nchunks, float eps, void* stream) {
  using namespace vs;
  if (!gn_args_ok(B, R, C, vec, rows_per_chunk, nchunks) || G <= 0 || C % G || G > kMaxGroups)
    return kErrBadArgument;
  if (wdtype != kFloat32 && wdtype != kBFloat16) return kErrUnsupported;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(partial);
  int rc;
  if (dtype == kBFloat16 && vec == 8)
    rc = launch_stats<__nv_bfloat16, 8>(x, part, B, R, C, rows_per_chunk, nchunks, st);
  else if (dtype == kBFloat16 && vec == 1)
    rc = launch_stats<__nv_bfloat16, 1>(x, part, B, R, C, rows_per_chunk, nchunks, st);
  else if (dtype == kFloat32 && vec == 4)
    rc = launch_stats<float, 4>(x, part, B, R, C, rows_per_chunk, nchunks, st);
  else if (dtype == kFloat32 && vec == 1)
    rc = launch_stats<float, 1>(x, part, B, R, C, rows_per_chunk, nchunks, st);
  else
    return kErrUnsupported;
  if (rc != 0) return rc;
  float* sums = part + (size_t)B * nchunks * 2 * C;
  rc = gn_launch_reduce(part, sums, B, nchunks, C, st);
  if (rc != 0) return rc;
  const float count = (float)((double)R * (double)(C / G));
  gn_stats_finish_kernel<<<B, kFinishThreads, sizeof(float) * 2 * G, st>>>(
      sums, gamma, beta, wdtype, static_cast<float*>(a), static_cast<float*>(s),
      static_cast<float*>(mean), static_cast<float*>(inv), C, G, count, eps);
  return (int)cudaGetLastError();
}

// y = x * a[b, c] + s[b, c], optionally * sigmoid of itself; x, y contiguous
// [B, R, C] (y may alias nothing), a, s fp32 [B, C].
extern "C" int vs_group_norm_apply(int dtype, const void* x, const void* a, const void* s,
                                   void* y, int B, int R, int C, int vec, int rows_per_chunk,
                                   int nchunks, int silu, void* stream) {
  using namespace vs;
  if (!gn_args_ok(B, R, C, vec, rows_per_chunk, nchunks)) return kErrBadArgument;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* af = static_cast<const float*>(a);
  const float* sf = static_cast<const float*>(s);
  if (dtype == kBFloat16 && vec == 8)
    return launch_apply<__nv_bfloat16, 8>(x, af, sf, y, B, R, C, rows_per_chunk, nchunks, silu, st);
  if (dtype == kBFloat16 && vec == 1)
    return launch_apply<__nv_bfloat16, 1>(x, af, sf, y, B, R, C, rows_per_chunk, nchunks, silu, st);
  if (dtype == kFloat32 && vec == 4)
    return launch_apply<float, 4>(x, af, sf, y, B, R, C, rows_per_chunk, nchunks, silu, st);
  if (dtype == kFloat32 && vec == 1)
    return launch_apply<float, 1>(x, af, sf, y, B, R, C, rows_per_chunk, nchunks, silu, st);
  return kErrUnsupported;
}
