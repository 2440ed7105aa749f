// GroupNorm (+ SiLU) forward on a channels-last activation [B, R, C] in its
// storage dtype, fp32 statistics: K7 group_norm_stats + K8 group_norm_apply,
// and the one-launch K7 + K8 group_norm_fused.
//
// Replaces (TPU): vidseg_diffusion_tpu/ops/norm.py:_stats_kernel (via
// _stats_pallas; K7) and _apply_kernel (via group_norm_silu; K8), with the
// [B, C] -> [B, G] math of _affine_from_stats folded into K7, and both of them
// into group_norm_fused.
//
// What bounds them on the H100: memory traffic alone (a few flops per
// element): x read once and y written once, 2 * 2 bytes an element in bf16 (104
// MB at [28, 56, 104, 320]; 2.7 GB at the VAE's [7, 448, 832, 128]).
//
// Two routes, chosen by the wrapper from the shape (ops/norm.py:
// group_norm_route), each with its own launch counter:
// - group_norm_fused, where one sample's slab of whole groups (rows of a
//   multiple of 16 bytes) fits in a block's shared memory (UNet ds2, ds4, ds8,
//   mid and the ds8 time_stack: 7 to 175 KB): one block per (batch item,
//   slab) copies the slab in by 16-byte cp.async copies, sums each channel in
//   a fixed order, forms mean, inv-std, a and s, and writes y from shared
//   memory: one read of x, one write of y, one launch. Several blocks share an
//   SM when the slab is small, so one block's copies overlap another's
//   arithmetic;
// - everywhere else (ds1 and its concatenations, the larger time_stacks, the
//   VAE) K7 and then K8. K7 walks one wave of blocks (four an SM) over (row
//   chunk, channel tile, batch item) with 16-byte loads along C
//   (group_norm.cuh), and each block writes its per-group partial sums; the last block of a batch item to arrive (an
//   arrival counter after a __threadfence(); the counter is reset by that
//   block, so it is zero again for the next call) adds the item's partials in
//   a fixed order and writes a, s, mean and inv: one launch, the same sums from
//   run to run, no atomics in any sum (the TPU kernel carries its sum across
//   sequential grid steps, which parallel blocks cannot). K8 keeps a and s of
//   its channels in registers, computes in fp32 and rounds once at the store,
//   as _apply_kernel does.
// Both compute per-channel Σx and Σx² in fp32, then per group mean = Σ/n,
// var = max(0, Σx²/n - mean²), inv = rsqrt(var + eps), a = inv·γ, s = β -
// mean·a, and y = x·a + s (· sigmoid) in fp32 with one rounding
// (norm.py:43-62, 109-130).
#include "group_norm.cuh"

namespace vs {

// the slab's share of a block's shared memory (the rest: the sums and coefficients)
constexpr int kSlabMaxBytes = 196608;
// K7's blocks an SM: its grid (ops/norm.py: _STATS_TARGET_BLOCKS) is one wave of them
constexpr int kStatsBlocksPerSM = 4;

__device__ __forceinline__ void cp_async_16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// Per-group mean, clamped variance and inv-std from the group sums.
__device__ __forceinline__ void gn_group_stats(float gs, float gss, float count, float eps, float* mean, float* inv) {
  *mean = gs / count;
  const float var = fmaxf(0.f, gss / count - *mean * *mean);
  *inv = rsqrtf(var + eps);
}

// One block per (slab of gc whole groups, batch item) of THREADS threads
// (1024 for a slab of more than 48 KB, which leaves one block an SM, so that
// its copy, sums and stores keep enough warps busy; 256 for the smaller ones,
// several blocks an SM); dynamic shared memory: the slab [R][W] in T, then
// fp32 red [THREADS][2], csum [2][W], coef [2][W].
template <typename T, bool SILU, int THREADS>
__global__ void __launch_bounds__(THREADS) gn_fused_kernel(
    const T* __restrict__ x, const void* __restrict__ gamma, const void* __restrict__ beta, int wdtype,
    T* __restrict__ y, float* __restrict__ a_out, float* __restrict__ s_out, float* __restrict__ mean_out,
    float* __restrict__ inv_out, int R, int C, int G, int gc, float count, float eps) {
  constexpr int VEC = 16 / sizeof(T);
  extern __shared__ __align__(16) unsigned char gn_smem[];
  const int cg = C / G, W = gc * cg, wv = W / VEC;
  const int b = blockIdx.y, g0 = blockIdx.x * gc, c0 = g0 * cg;
  T* slab = reinterpret_cast<T*>(gn_smem);
  float* red = reinterpret_cast<float*>(gn_smem + (((size_t)R * W * sizeof(T) + 15) & ~(size_t)15));
  float* csum = red + THREADS * 2;
  float* coef = csum + 2 * W;
  const T* xb = x + (size_t)b * R * C + c0;
  const int tid = threadIdx.x;

  for (int idx = tid; idx < R * wv; idx += THREADS) {
    const int r = idx / wv, v = idx - r * wv;
    cp_async_16(slab + (size_t)idx * VEC, xb + (size_t)r * C + v * VEC);
  }
  cp_async_wait_all();
  __syncthreads();

  // thread (sl, c) sums channel c over rows sl, sl + nsl, ...; then the slices in order
  const int c = tid % W, sl = tid / W, nsl = THREADS / W;
  if (sl < nsl) {
    float s = 0.f, ss = 0.f;
    for (int r = sl; r < R; r += nsl) {
      const float v = to_f<T>(slab[(size_t)r * W + c]);
      s += v;
      ss = fmaf(v, v, ss);
    }
    red[2 * tid] = s;
    red[2 * tid + 1] = ss;
  }
  __syncthreads();
  if (tid < W) {
    float s = 0.f, ss = 0.f;
    for (int k = 0; k < nsl; ++k) {
      s += red[2 * (k * W + tid)];
      ss += red[2 * (k * W + tid) + 1];
    }
    csum[tid] = s;
    csum[W + tid] = ss;
  }
  __syncthreads();
  // a warp per group: its channel sums in a fixed shuffle tree
  const int warp = tid >> 5, lane = tid & 31;
  for (int gi = warp; gi < gc; gi += THREADS / 32) {
    float gs = 0.f, gss = 0.f;
    for (int j = lane; j < cg; j += 32) {
      gs += csum[gi * cg + j];
      gss += csum[W + gi * cg + j];
    }
    gs = warp_sum(gs);
    gss = warp_sum(gss);
    float mean, inv;
    gn_group_stats(gs, gss, count, eps, &mean, &inv);
    for (int j = lane; j < cg; j += 32) {
      const int cc = gi * cg + j;
      const float w = load_param(gamma, c0 + cc, wdtype);
      coef[cc] = inv * w;
      coef[W + cc] = load_param(beta, c0 + cc, wdtype) - mean * inv * w;
      a_out[(size_t)b * C + c0 + cc] = coef[cc];
      s_out[(size_t)b * C + c0 + cc] = coef[W + cc];
    }
    if (lane == 0) {
      mean_out[(size_t)b * G + g0 + gi] = mean;
      inv_out[(size_t)b * G + g0 + gi] = inv;
    }
  }
  __syncthreads();
  // thread (ty, tx) writes channel vector tx of rows ty, ty + rpp, ...
  const int rpp = THREADS / wv, tx = tid % wv, ty = tid / wv;
  if (ty >= rpp) return;
  float av[VEC], sv[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    av[i] = coef[tx * VEC + i];
    sv[i] = coef[W + tx * VEC + i];
  }
  T* yb = y + (size_t)b * R * C + c0 + tx * VEC;
  for (int r = ty; r < R; r += rpp) {
    float v[VEC];
    load_vec<T, VEC>(slab + (size_t)r * W + tx * VEC, v);
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      float z = fmaf(v[i], av[i], sv[i]);
      if (SILU) z = z * sigmoidf(z);
      v[i] = z;
    }
    store_vec<T, VEC>(yb + (size_t)r * C, v);
  }
}

// The finishing block of K7: gsum[v] = sum over the P partials of item[p][v]
// for the nv values of one batch item, V values a load (V = 4: 16-byte loads,
// nv % 4 == 0). Thread (sl, v) adds p = sl, sl + nsl, ... with four
// accumulators (four loads in flight: eight float4 accumulators raised the
// kernel to 72 registers and cost its streaming loop blocks an SM), then the
// nsl slices are added in order: a fixed tree. red: 4 * kGnThreads floats.
template <int V>
__device__ __forceinline__ void gn_sum_partials(const float* __restrict__ item, int P, int nv, float* red,
                                                float* gsum) {
  using Vec = Pack<float, V>;
  const int tid = threadIdx.x, nvv = nv / V, nsl = max(1, kGnThreads / nvv), width = kGnThreads / nsl;
  const Vec* src = reinterpret_cast<const Vec*>(item);
  Vec* slices = reinterpret_cast<Vec*>(red);
  for (int v0 = 0; v0 < nvv; v0 += width) {
    const int v = v0 + tid % width, sl = tid / width;
    const bool mine = v < nvv && sl < nsl;
    float acc[4][V];
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int i = 0; i < V; ++i) acc[u][i] = 0.f;
    if (mine) {
      int p = sl;
      for (; p + 3 * nsl < P; p += 4 * nsl) {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          Vec in;
          if (V == 4) {
            const float4 q = __ldcg(reinterpret_cast<const float4*>(src + (size_t)(p + u * nsl) * nvv + v));
            in.v[0] = q.x, in.v[1] = q.y, in.v[2] = q.z, in.v[3] = q.w;
          } else {
            in.v[0] = __ldcg(reinterpret_cast<const float*>(src + (size_t)(p + u * nsl) * nvv + v));
          }
#pragma unroll
          for (int i = 0; i < V; ++i) acc[u][i] += in.v[i];
        }
      }
      for (; p < P; p += nsl) {
        const float* q = reinterpret_cast<const float*>(src + (size_t)p * nvv + v);
#pragma unroll
        for (int i = 0; i < V; ++i) acc[0][i] += __ldcg(q + i);
      }
    }
    __syncthreads();
    if (mine) {
      Vec out;
#pragma unroll
      for (int i = 0; i < V; ++i)
        out.v[i] = (acc[0][i] + acc[1][i]) + (acc[2][i] + acc[3][i]);
      slices[tid] = out;
    }
    __syncthreads();
    if (mine && sl == 0) {
      float total[V];
#pragma unroll
      for (int i = 0; i < V; ++i) total[i] = 0.f;
      for (int k = 0; k < nsl; ++k)
#pragma unroll
        for (int i = 0; i < V; ++i) total[i] += slices[k * width + tid].v[i];
#pragma unroll
      for (int i = 0; i < V; ++i) gsum[v * V + i] = total[i];
    }
  }
}

// K7: per-channel sums of this block's rows in registers, folded into per-group
// partial sums partial[b][chunk * tiles + tile][2][G] (zeros for the groups
// outside this channel tile); the last block of the batch item finishes.
template <typename T, int VEC>
__global__ void __launch_bounds__(kGnThreads, kStatsBlocksPerSM) gn_stats_kernel(
    const T* __restrict__ x, float* __restrict__ partial, int* __restrict__ counters, const void* __restrict__ gamma,
    const void* __restrict__ beta, int wdtype, float* __restrict__ a_out, float* __restrict__ s_out,
    float* __restrict__ mean_out, float* __restrict__ inv_out, int R, int C, int G, int rows_per_chunk,
    float count, float eps) {
  // one buffer, three uses in turn: the threads' sums, the tile's channel sums,
  // the finishing block's slice sums and group statistics (16 KB in bf16)
  constexpr int kRed = kGnThreads * 2 * VEC, kFin = 4 * kGnThreads + 2 * kMaxGroups;
  __shared__ __align__(16) float red[kRed > kFin ? kRed : kFin];
  float* csum = red;
  float* gsum = red + 4 * kGnThreads;
  __shared__ int last;
  const GnTile t = gn_tile<VEC>(R, C, rows_per_chunk);
  const int tid = threadIdx.x, b = blockIdx.z;
  float s[VEC], ss[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) s[i] = ss[i] = 0.f;
  if (t.active) {
    const T* base = x + (size_t)b * R * C + t.col;
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
    float* mine = red + (size_t)(t.ty * t.width + t.tx) * 2 * VEC;
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      mine[i] = s[i];
      mine[VEC + i] = ss[i];
    }
  }
  __syncthreads();
  const bool first = t.active && t.ty == 0;
  if (first) {  // the row slices in order: the tile's per-channel sums
#pragma unroll
    for (int i = 0; i < VEC; ++i) s[i] = ss[i] = 0.f;
    for (int yy = 0; yy < t.row_step; ++yy) {
      const float* src = red + (size_t)(yy * t.width + t.tx) * 2 * VEC;
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        s[i] += src[i];
        ss[i] += src[VEC + i];
      }
    }
  }
  __syncthreads();  // every slice read: the buffer takes the channel sums [2][width * VEC]
  const int tw = t.width * VEC;
  if (first) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      csum[t.tx * VEC + i] = s[i];
      csum[tw + t.tx * VEC + i] = ss[i];
    }
  }
  __syncthreads();
  // per group: its channels inside this tile, in order
  const int cg = C / G, tc0 = blockIdx.y * kTileVecs * VEC, tc1 = tc0 + tw;
  const int P = gridDim.x * gridDim.y;
  float* mine = partial + ((size_t)b * P + (size_t)blockIdx.x * gridDim.y + blockIdx.y) * 2 * G;
  for (int g = tid; g < G; g += kGnThreads) {
    float gs = 0.f, gss = 0.f;
    for (int c = max(g * cg, tc0); c < min((g + 1) * cg, tc1); ++c) {
      gs += csum[c - tc0];
      gss += csum[tw + c - tc0];
    }
    mine[g] = gs;
    mine[G + g] = gss;
  }
  if (tid < G) __threadfence();  // this thread's partials are visible to the block that finishes
  __syncthreads();
  if (tid == 0) last = atomicAdd(counters + b, 1) == P - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const float* item = partial + (size_t)b * P * 2 * G;
  if (G % 2 == 0)
    gn_sum_partials<4>(item, P, 2 * G, red, gsum);
  else
    gn_sum_partials<1>(item, P, 2 * G, red, gsum);
  __syncthreads();
  for (int g = tid; g < G; g += kGnThreads) {
    float mean, inv;
    gn_group_stats(gsum[g], gsum[G + g], count, eps, &mean, &inv);
    gsum[g] = mean;
    gsum[G + g] = inv;
    mean_out[(size_t)b * G + g] = mean;
    inv_out[(size_t)b * G + g] = inv;
  }
  __syncthreads();
  for (int c = tid; c < C; c += kGnThreads) {
    const int g = c / cg;
    const float w = load_param(gamma, c, wdtype);
    a_out[(size_t)b * C + c] = gsum[G + g] * w;
    s_out[(size_t)b * C + c] = load_param(beta, c, wdtype) - gsum[g] * gsum[G + g] * w;
  }
  if (tid == 0) counters[b] = 0;  // ready for the next call
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
int launch_stats(const void* x, float* partial, int* counters, const void* gamma, const void* beta, int wdtype,
                 float* a, float* s, float* mean, float* inv, int B, int R, int C, int G, int rows_per_chunk,
                 int nchunks, float count, float eps, cudaStream_t stream) {
  gn_stats_kernel<T, VEC><<<gn_grid(B, C, VEC, nchunks), kGnThreads, 0, stream>>>(
      static_cast<const T*>(x), partial, counters, gamma, beta, wdtype, a, s, mean, inv, R, C, G, rows_per_chunk,
      count, eps);
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

template <typename T, bool SILU, int THREADS>
int launch_fused_threads(const void* x, const void* gamma, const void* beta, int wdtype, void* y, float* a,
                         float* s, float* mean, float* inv, int B, int R, int C, int G, int gc, float count,
                         float eps, size_t slab, cudaStream_t stream) {
  const int W = gc * (C / G);
  const size_t bytes = ((slab + 15) & ~(size_t)15) + sizeof(float) * (THREADS * 2 + 4 * W);
  // more than 48 KB of shared memory is opted into once per process
  static const cudaError_t attr = cudaFuncSetAttribute(gn_fused_kernel<T, SILU, THREADS>,
                                                       cudaFuncAttributeMaxDynamicSharedMemorySize, 232448);
  if (attr != cudaSuccess) return (int)attr;
  gn_fused_kernel<T, SILU, THREADS><<<dim3((unsigned)(G / gc), (unsigned)B), THREADS, bytes, stream>>>(
      static_cast<const T*>(x), gamma, beta, wdtype, static_cast<T*>(y), a, s, mean, inv, R, C, G, gc, count, eps);
  return (int)cudaGetLastError();
}

template <typename T, bool SILU>
int launch_fused(const void* x, const void* gamma, const void* beta, int wdtype, void* y, float* a, float* s,
                 float* mean, float* inv, int B, int R, int C, int G, int gc, float count, float eps,
                 cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  const int W = gc * (C / G);
  const size_t slab = (size_t)R * W * sizeof(T);
  if (slab > (size_t)kSlabMaxBytes || W % VEC || W > kGnThreads) return kErrBadArgument;
  if (slab > 49152)
    return launch_fused_threads<T, SILU, 1024>(x, gamma, beta, wdtype, y, a, s, mean, inv, B, R, C, G, gc, count,
                                               eps, slab, stream);
  return launch_fused_threads<T, SILU, kGnThreads>(x, gamma, beta, wdtype, y, a, s, mean, inv, B, R, C, G, gc,
                                                   count, eps, slab, stream);
}

}  // namespace vs

// x: contiguous [B, R, C]; partial: fp32 scratch of B * nchunks * tiles * 2 * G
// values (tiles: the column tiles of kTileVecs vectors); counters: B ints,
// zero, left zero; gamma, beta: [C] in wdtype; a, s: fp32 [B, C]; mean, inv:
// fp32 [B, G]. vec is the channel vector width in elements: 16 bytes' worth
// (C % vec == 0, 16-byte aligned x), or 1.
extern "C" int vs_group_norm_stats(int dtype, const void* x, void* partial, void* counters, const void* gamma,
                                   const void* beta, int wdtype, void* a, void* s, void* mean,
                                   void* inv, int B, int R, int C, int G, int vec,
                                   int rows_per_chunk, int nchunks, float eps, void* stream) {
  using namespace vs;
  if (!gn_args_ok(B, R, C, vec, rows_per_chunk, nchunks) || G <= 0 || C % G || G > kMaxGroups)
    return kErrBadArgument;
  if (wdtype != kFloat32 && wdtype != kBFloat16) return kErrUnsupported;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(partial);
  int* cnt = static_cast<int*>(counters);
  float *af = static_cast<float*>(a), *sf = static_cast<float*>(s);
  float *mf = static_cast<float*>(mean), *vf = static_cast<float*>(inv);
  const float count = (float)((double)R * (double)(C / G));
  if (dtype == kBFloat16 && vec == 8)
    return launch_stats<__nv_bfloat16, 8>(x, part, cnt, gamma, beta, wdtype, af, sf, mf, vf, B, R, C, G,
                                          rows_per_chunk, nchunks, count, eps, st);
  if (dtype == kBFloat16 && vec == 1)
    return launch_stats<__nv_bfloat16, 1>(x, part, cnt, gamma, beta, wdtype, af, sf, mf, vf, B, R, C, G,
                                          rows_per_chunk, nchunks, count, eps, st);
  if (dtype == kFloat32 && vec == 4)
    return launch_stats<float, 4>(x, part, cnt, gamma, beta, wdtype, af, sf, mf, vf, B, R, C, G, rows_per_chunk,
                                  nchunks, count, eps, st);
  if (dtype == kFloat32 && vec == 1)
    return launch_stats<float, 1>(x, part, cnt, gamma, beta, wdtype, af, sf, mf, vf, B, R, C, G, rows_per_chunk,
                                  nchunks, count, eps, st);
  return kErrUnsupported;
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

// The one-launch forward: x, y contiguous [B, R, C], 16-byte aligned; gc whole
// groups a block, gc * C / G * itemsize a multiple of 16 bytes and R times that
// at most kSlabMaxBytes; gamma, beta [C] in wdtype; a, s fp32 [B, C]; mean,
// inv fp32 [B, G].
extern "C" int vs_group_norm_fused(int dtype, const void* x, const void* gamma, const void* beta, int wdtype,
                                   void* y, void* a, void* s, void* mean, void* inv, int B, int R, int C, int G,
                                   int gc, float eps, int silu, void* stream) {
  using namespace vs;
  if (B <= 0 || B > 65535 || R <= 0 || C <= 0 || G <= 0 || C % G || gc <= 0 || G % gc) return kErrBadArgument;
  if (wdtype != kFloat32 && wdtype != kBFloat16) return kErrUnsupported;
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y)) % 16) return kErrBadArgument;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float *af = static_cast<float*>(a), *sf = static_cast<float*>(s);
  float *mf = static_cast<float*>(mean), *vf = static_cast<float*>(inv);
  const float count = (float)((double)R * (double)(C / G));
  if (dtype == kBFloat16)
    return silu ? launch_fused<__nv_bfloat16, true>(x, gamma, beta, wdtype, y, af, sf, mf, vf, B, R, C, G, gc,
                                                    count, eps, st)
                : launch_fused<__nv_bfloat16, false>(x, gamma, beta, wdtype, y, af, sf, mf, vf, B, R, C, G, gc,
                                                     count, eps, st);
  if (dtype == kFloat32)
    return silu ? launch_fused<float, true>(x, gamma, beta, wdtype, y, af, sf, mf, vf, B, R, C, G, gc, count, eps,
                                            st)
                : launch_fused<float, false>(x, gamma, beta, wdtype, y, af, sf, mf, vf, B, R, C, G, gc, count, eps,
                                             st);
  return kErrUnsupported;
}
