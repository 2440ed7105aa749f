// The GroupNorm (+ SiLU) backward in coefficient form on a channels-last
// activation [B, R, C] in its storage dtype, fp32 sums: the one-launch slab
// kernel (K9 + K10 together) and, where no slab fits, K9
// group_norm_backward_stats and K10 group_norm_backward_apply.
//
// Replaces (TPU): vidseg_diffusion_tpu/ops/norm.py:_gn_bwd_stats_kernel (K9)
// and _gn_bwd_apply_kernel (K10), both reached through _gn_bwd_pallas, with
// the [B, C] / [B, G] coefficient math of _gn_bwd_pallas and the sum of the
// parameter gradients over the batch folded into the kernels.
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
// What bounds them on the H100: memory traffic, x and dy read once and dx
// written once (3 activation passes), and at the small sites the launches.
// Two routes, chosen by the wrapper from the shape (ops/norm.py:
// group_norm_backward_route), each with its own launch counter:
// - the slab kernel, where one sample's slab of x and dy over gc whole groups
//   (rows of a multiple of 16 bytes) fits in the shared memory of one block
//   ("fused") or of a cluster of n <= 16 blocks ("cluster", n a power of two):
//   each block holds `rows` rows of x and dy of one work item (batch item,
//   slab). Its first thread asks TMA for them in boxes of about 8 KB (at most
//   256 rows), one mbarrier a box, and the threads sum each box as it lands:
//   r1 and rx per channel in a fixed order. The blocks of a cluster exchange
//   their per-channel sums through distributed shared memory (each adds all n
//   in rank order, so all hold the same totals), form m1, m2 and (a2, b2, c2),
//   write dx over the resident dy and store each box by TMA once written. A
//   cluster's slab nearly fills each block's shared memory (half of it would
//   take half the cluster), so a block has its SM alone: there the grid is
//   persistent (as many clusters as the device holds, walking the items) and
//   each stored box is refilled at once with the next item's, so that the
//   loads of one item run under the stores and sums of another. Rank 0 writes
//   each item's share of dgamma, dbeta; the last block of a slab to arrive
//   ("fused") or the last cluster to finish (an arrival counter after a
//   __threadfence(), reset by that block) adds the B shares in batch order and
//   writes the parameter gradients in their dtype. One launch, x and dy read
//   once, dx written once;
// - elsewhere two launches. K9 walks one wave of blocks over (row chunk,
//   channel tile, batch item) with 16-byte loads (group_norm.cuh) and writes
//   per-channel partial sums; the last block of a batch item to arrive adds
//   its partials in a fixed order (eight loads in flight a thread) and writes
//   the coefficients and the item's parameter-gradient share; the last item
//   to arrive adds the shares in batch order. K10 keeps a2, b2, c2 of its
//   channels in registers and writes dx with one rounding. 5 activation
//   passes: the route's floor is 5/3 of the bound.
// No float atomics in any sum: the result is the same from run to run.
#include <cooperative_groups.h>

#include "group_norm.cuh"
#include "wgmma_tile.cuh"

namespace vs {

namespace coop = cooperative_groups;

constexpr int kSlabThreads = 512;        // threads of a slab block
constexpr int kSlabSmemMax = 232448;     // dynamic shared memory a block may take on the H100
constexpr int kSlabMaxBoxes = 64;        // TMA boxes (of each of x and dy) a block
constexpr int kSlabMaxCluster = 16;      // the largest cluster the H100 schedules (non-portable above 8)
constexpr int kSumDepth = 8;             // loads in flight a thread in the last block's sum over chunks

// u from dy; the sigmoid by the fast exponential and reciprocal (a few ulp of
// fp32 off the IEEE ones): recomputed twice an element on both routes, the
// IEEE forms made the SiLU sites issue-bound.
template <bool SILU>
__device__ __forceinline__ float upstream(float dy, float x, float a, float s) {
  if (!SILU) return dy;
  const float z = fmaf(x, a, s);
  const float sg = __fdividef(1.f, 1.f + __expf(-z));
  return dy * sg * (1.f + z * (1.f - sg));
}

__device__ __forceinline__ void store_param(void* p, int i, int dtype, float v) {
  if (dtype == kBFloat16)
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16(v);
  else
    static_cast<float*>(p)[i] = v;
}

// The B shares dparam[i][which][c] of channel c added in batch order, four
// loads in flight (a chain of dependent loads would take microseconds).
__device__ __forceinline__ float gn_bwd_share_sum(const float* __restrict__ dparam, int B, int C, int which, int c) {
  const float* q = dparam + (size_t)which * C + c;
  const size_t step = 2 * (size_t)C;
  float t = 0.f;
  int i = 0;
  for (; i + 3 < B; i += 4) {
    const float v0 = __ldcg(q + i * step), v1 = __ldcg(q + (i + 1) * step);
    const float v2 = __ldcg(q + (i + 2) * step), v3 = __ldcg(q + (i + 3) * step);
    t += v0, t += v1, t += v2, t += v3;
  }
  for (; i < B; ++i) t += __ldcg(q + i * step);
  return t;
}

// The group means of the backward from the per-channel totals r1 (tot[0..W))
// and rx (tot[W..2W)) of gc whole groups, their gamma gw[W] and statistics
// mu[gc], iv[gc]: gm[2 gi] = m1, gm[2 gi + 1] = m2; one warp a group (warp of
// nwarps), a fixed shuffle tree.
__device__ __forceinline__ void gn_bwd_group_means(const float* tot, int W, int gc, int cgs, const float* gw,
                                                   const float* mu, const float* iv, float count, float* gm,
                                                   int nwarps) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int gi = warp; gi < gc; gi += nwarps) {
    float su = 0.f, sux = 0.f;
    for (int j = lane; j < cgs; j += 32) {
      su += tot[gi * cgs + j] * gw[gi * cgs + j];
      sux += tot[W + gi * cgs + j] * gw[gi * cgs + j];
    }
    su = warp_sum(su);
    sux = warp_sum(sux);
    if (lane == 0) {
      gm[2 * gi] = su / count;
      gm[2 * gi + 1] = iv[gi] * (sux - mu[gi] * su) / count;
    }
  }
}

// (a2, b2, c2) of channel cc whose group means are gm (gn_bwd_group_means).
__device__ __forceinline__ void gn_bwd_coef(int cc, int cgs, const float* gm, const float* gw, const float* mu,
                                            const float* iv, float* a2, float* b2, float* c2) {
  const int gi = cc / cgs;
  const float m1 = gm[2 * gi], m2 = gm[2 * gi + 1];
  *a2 = iv[gi] * gw[cc];
  *b2 = -iv[gi] * iv[gi] * m2;
  *c2 = iv[gi] * (mu[gi] * iv[gi] * m2 - m1);
}

// ---- the slab kernel --------------------------------------------------------

// Where a slab block keeps what (bytes from its 128-byte aligned base); the
// wrapper mirrors it (ops/norm.py: _slab_smem) to pick the route.
struct SlabLayout {
  int box_bytes;  // one box of one tensor, rounded up to 128 bytes (TMA's alignment)
  int dy, red, part, tot, gm, par, bar, total;
};

__host__ __device__ inline SlabLayout slab_layout(int rows, int box_rows, int W, int item, int gc) {
  SlabLayout L;
  const int nbox = rows / box_rows;
  L.box_bytes = (box_rows * W * item + 127) & ~127;
  L.dy = nbox * L.box_bytes;               // x's boxes first, then dy's (dx is written over dy)
  L.red = 2 * nbox * L.box_bytes;          // [threads][4] fp32: each thread's r1, rx of its channel pair
  L.part = L.red + kSlabThreads * 16;      // [2][W] fp32: the block's per-channel r1, rx
  L.tot = L.part + 8 * W;                  // [2][W] fp32: the cluster's totals
  L.gm = L.tot + 8 * W;                    // [gc][2] fp32: m1, m2
  L.par = L.gm + 8 * gc;                   // [2][W + 2 gc] fp32: the item's gamma, mean and inv, by item parity
  L.bar = (L.par + 8 * (W + 2 * gc) + 7) & ~7;   // one mbarrier a box
  L.total = L.bar + 8 * nbox + 128;        // + the base's alignment
  return L;
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// One box of shared memory -> a rank-3 map (rows past the tensor are dropped).
__device__ __forceinline__ void gn_tma_store_3d(const CUtensorMap* map, uint32_t src, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// The TMA loads of x's and dy's box k of work item w (batch item w / nslab,
// slab w % nslab) for the block whose rows start at r0, onto mbarrier bar.
__device__ __forceinline__ void slab_load_box(const CUtensorMap* xmap, const CUtensorMap* dymap, unsigned char* base,
                                              const SlabLayout& L, uint32_t bar, int w, int nslab, int W, int r0,
                                              int box_rows, int k, int box_tx) {
  const int b = w / nslab, c0 = (w - b * nslab) * W;
  mbar_expect_tx(bar, box_tx);   // rows past R arrive as zeros and count
  tma_load_3d(smem_u32(base + k * L.box_bytes), xmap, bar, c0, r0 + k * box_rows, b);
  tma_load_3d(smem_u32(base + L.dy + k * L.box_bytes), dymap, bar, c0, r0 + k * box_rows, b);
}

// Clusters of n blocks, cluster c taking the work items (batch item, slab) w
// = c, c + clusters, ... (a persistent grid of as many clusters as the device
// holds at once; on one block a cluster, one item a block: several blocks
// share an SM there); its block of rank k holds rows [k * rows, (k + 1) *
// rows) of channels [slab * W, (slab + 1) * W) of x and dy (W = gc * C / G),
// read and written through rank-3 tensor maps over [B, R, C] with boxes of
// (W, box_rows, 1). Each box of dx is stored by TMA once written, and the box
// before it refilled with the next item's, so one item's loads run under the
// previous item's stores and sums.
template <typename T, bool SILU>
__global__ void __launch_bounds__(kSlabThreads) gn_bwd_slab_kernel(
    const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap dymap,
    const __grid_constant__ CUtensorMap dxmap, const float* __restrict__ a, const float* __restrict__ s,
    const void* __restrict__ gamma, int wdtype, const float* __restrict__ mean, const float* __restrict__ inv,
    float* __restrict__ dparam, int* __restrict__ counters, void* __restrict__ dgamma, void* __restrict__ dbeta,
    int B, int R, int C, int G, int gc, int rows, int box_rows, float count) {
  extern __shared__ __align__(16) unsigned char gn_bwd_smem[];
  unsigned char* base = gn_bwd_smem + ((128u - (smem_u32(gn_bwd_smem) & 127u)) & 127u);
  coop::cluster_group cluster = coop::this_cluster();
  const int n = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int cgs = C / G, W = gc * cgs, np = W / 2, nslab = G / gc, items = B * nslab;
  const int first = blockIdx.x / n, stride = gridDim.x / n;
  const int r0 = rank * rows, valid = max(0, min(rows, R - r0));
  const int nload = (valid + box_rows - 1) / box_rows;   // the boxes that hold any row of the sample
  const int box_tx = 2 * box_rows * W * (int)sizeof(T);
  const SlabLayout L = slab_layout(rows, box_rows, W, (int)sizeof(T), gc);
  float* red = reinterpret_cast<float*>(base + L.red);
  float* part = reinterpret_cast<float*>(base + L.part);
  float* mine = reinterpret_cast<float*>(base + L.tot);
  float* gm = reinterpret_cast<float*>(base + L.gm);
  const uint32_t bars = smem_u32(base + L.bar);
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int k = 0; k < nload; ++k) mbar_init(bars + 8 * k, 1);
    mbar_init_fence();
    for (int k = 0; k < nload; ++k)
      slab_load_box(&xmap, &dymap, base, L, bars + 8 * k, first, nslab, W, r0, box_rows, k, box_tx);
  }
  __syncthreads();

  // thread (sl, p) keeps channels 2p, 2p + 1 and visits rows sl, sl + nsl, ... of each box
  const int p = tid % np, sl = tid / np, nsl = kSlabThreads / np;
  const bool active = sl < nsl;
  int it = 0;
  for (int w = first; w < items; w += stride, ++it) {
    const int b = w / nslab, slab = w - b * nslab, c0 = slab * W, g0 = b * G + slab * gc;
    // this item's gamma, mean and inv, read after the sums (two sets: the last item's may still be read)
    float* gw = reinterpret_cast<float*>(base + L.par) + (it & 1) * (W + 2 * gc);
    float *mu = gw + W, *iv = mu + gc;
    if (tid < W) gw[tid] = load_param(gamma, c0 + tid, wdtype);
    if (tid < gc) mu[tid] = mean[g0 + tid], iv[tid] = inv[g0 + tid];
    float av[2] = {0.f, 0.f}, sv[2] = {0.f, 0.f}, r1[2] = {0.f, 0.f}, rx[2] = {0.f, 0.f};
    if (active) {
      if (SILU) {
        load_vec<float, 2>(a + (size_t)b * C + c0 + 2 * p, av);
        load_vec<float, 2>(s + (size_t)b * C + c0 + 2 * p, sv);
      }
      for (int k = 0; k < nload; ++k) {
        mbar_wait(bars + 8 * k, it & 1);
        const T* xs = reinterpret_cast<const T*>(base + k * L.box_bytes) + 2 * p;
        const T* gs = reinterpret_cast<const T*>(base + L.dy + k * L.box_bytes) + 2 * p;
        const int kr = min(box_rows, valid - k * box_rows);
#pragma unroll 4
        for (int j = sl; j < kr; j += nsl) {
          float xv[2], gv[2];
          load_vec<T, 2>(xs + (size_t)j * W, xv);
          load_vec<T, 2>(gs + (size_t)j * W, gv);
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const float u = upstream<SILU>(gv[i], xv[i], av[i], sv[i]);
            r1[i] += u;
            rx[i] = fmaf(u, xv[i], rx[i]);
          }
        }
      }
      reinterpret_cast<float4*>(red)[tid] = make_float4(r1[0], r1[1], rx[0], rx[1]);
    }
    __syncthreads();
    // the block's per-channel sums (the slices in a fixed order, four chains),
    // then the cluster's totals: every block adds the n blocks' sums in rank order
    if (n > 1 && it > 0) cluster_wait();   // every block is done reading this block's previous sums
    if (tid < np) {
      float4 acc[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) acc[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      int k = 0;
      for (; k + 3 < nsl; k += 4)
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float4 v = reinterpret_cast<const float4*>(red)[(k + u) * np + tid];
          acc[u].x += v.x, acc[u].y += v.y, acc[u].z += v.z, acc[u].w += v.w;
        }
      for (; k < nsl; ++k) {
        const float4 v = reinterpret_cast<const float4*>(red)[k * np + tid];
        acc[0].x += v.x, acc[0].y += v.y, acc[0].z += v.z, acc[0].w += v.w;
      }
      part[2 * tid] = (acc[0].x + acc[1].x) + (acc[2].x + acc[3].x);
      part[2 * tid + 1] = (acc[0].y + acc[1].y) + (acc[2].y + acc[3].y);
      part[W + 2 * tid] = (acc[0].z + acc[1].z) + (acc[2].z + acc[3].z);
      part[W + 2 * tid + 1] = (acc[0].w + acc[1].w) + (acc[2].w + acc[3].w);
    }
    const float* tot = part;
    if (n > 1) {
      cluster_arrive();
      cluster_wait();   // every block's sums are written (and the block's threads have met)
      if (tid < 2 * W) {  // in rank order (unrolled, so the loads need not wait for the adds)
        float t = 0.f;
#pragma unroll
        for (int k = 0; k < kSlabMaxCluster; ++k)
          if (k < n) t += cluster.map_shared_rank(part, k)[tid];
        mine[tid] = t;
      }
      cluster_arrive();  // done reading the others' sums: waited on before they are written again, and at exit
      tot = mine;
    }
    __syncthreads();
    gn_bwd_group_means(tot, W, gc, cgs, gw, mu, iv, count, gm, kSlabThreads / 32);
    __syncthreads();
    if (rank == 0 && tid < W) {  // this batch item's share of the parameter gradients
      const int gi = tid / cgs;
      float* dp = dparam + (size_t)b * 2 * C + c0;
      dp[tid] = iv[gi] * (tot[W + tid] - mu[gi] * tot[tid]);
      dp[C + tid] = tot[tid];
      if (n == 1) __threadfence();
    }
    // one block an item: the slab's last item to arrive adds its B shares (a
    // cluster adds them all at the end instead: its rank 0 would stall each item)
    if (n == 1 && __syncthreads_or(tid == 0 && atomicAdd(counters + slab, 1) == B - 1)) {
      __threadfence();
      if (tid < W) {
        store_param(dgamma, c0 + tid, wdtype, gn_bwd_share_sum(dparam, B, C, 0, c0 + tid));
        store_param(dbeta, c0 + tid, wdtype, gn_bwd_share_sum(dparam, B, C, 1, c0 + tid));
      }
      if (tid == 0) counters[slab] = 0;  // ready for the next call
    }

    // dx = a2 * u + b2 * x + c2 over the resident dy; each box is stored by
    // TMA once written, and the box before it refilled with the next item's
    float a2[2], b2[2], c2[2];
    if (active) {
#pragma unroll
      for (int i = 0; i < 2; ++i) gn_bwd_coef(2 * p + i, cgs, gm, gw, mu, iv, &a2[i], &b2[i], &c2[i]);
    }
    const int next = w + stride;
    for (int k = 0; k < nload; ++k) {
      if (active) {
        const T* xs = reinterpret_cast<const T*>(base + k * L.box_bytes) + 2 * p;
        T* gs = reinterpret_cast<T*>(base + L.dy + k * L.box_bytes) + 2 * p;
        const int kr = min(box_rows, valid - k * box_rows);
#pragma unroll 4
        for (int j = sl; j < kr; j += nsl) {
          float xv[2], gv[2];
          load_vec<T, 2>(xs + (size_t)j * W, xv);
          load_vec<T, 2>(gs + (size_t)j * W, gv);
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const float u = upstream<SILU>(gv[i], xv[i], av[i], sv[i]);
            gv[i] = fmaf(a2[i], u, fmaf(b2[i], xv[i], c2[i]));
          }
          store_vec<T, 2>(gs + (size_t)j * W, gv);
        }
      }
      fence_proxy_async();  // the generic-proxy writes of dx, before TMA reads them
      __syncthreads();
      if (tid == 0) {
        gn_tma_store_3d(&dxmap, smem_u32(base + L.dy + k * L.box_bytes), c0, r0 + k * box_rows, b);
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
        if (next < items && k > 0) {  // box k - 1 has left shared memory once at most this store is pending
          asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
          slab_load_box(&xmap, &dymap, base, L, bars + 8 * (k - 1), next, nslab, W, r0, box_rows, k - 1, box_tx);
        }
      }
    }
    if (tid == 0 && next < items && nload > 0) {
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      slab_load_box(&xmap, &dymap, base, L, bars + 8 * (nload - 1), next, nslab, W, r0, box_rows, nload - 1,
                    box_tx);
    }
  }
  if (tid == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");  // dx has left shared memory
  if (n > 1) cluster_wait();   // the last exchange's readers are done

  // the last cluster to finish adds the B shares of every channel in batch order (one
  // arrival a cluster, not one an item: a fence and an atomic are microseconds)
  if (n > 1 && rank == 0) {  // (no static shared memory: the block may take all 227 KB dynamically)
    __threadfence();
    __syncthreads();
    if (__syncthreads_or(tid == 0 && atomicAdd(counters, 1) == stride - 1)) {
      __threadfence();
      for (int c = tid; c < C; c += kSlabThreads) {
        store_param(dgamma, c, wdtype, gn_bwd_share_sum(dparam, B, C, 0, c));
        store_param(dbeta, c, wdtype, gn_bwd_share_sum(dparam, B, C, 1, c));
      }
      if (tid == 0) counters[0] = 0;  // ready for the next call
    }
  }
}

// ---- the stream route: K9 and K10 --------------------------------------------

// sums[v] = sum over the P partial rows of item[p][v], for the nv values of one
// batch item, V values a load (V = 4: 16-byte loads, nv % 4 == 0). Thread (sl,
// v) adds rows p = sl, sl + nsl, ... with kSumDepth accumulators (kSumDepth
// loads in flight: the partials of a wave of blocks are hundreds of KB, and one
// block with few loads in flight would chase them for tens of microseconds),
// then the nsl slices are added in order: a fixed tree. red: kGnThreads * V floats.
template <int V>
__device__ __forceinline__ void gn_bwd_sum_rows(const float* __restrict__ item, int P, int nv, float* red,
                                                float* sums) {
  using Vec = Pack<float, V>;
  const int tid = threadIdx.x, nvv = nv / V, nsl = max(1, kGnThreads / nvv), width = kGnThreads / nsl;
  const Vec* src = reinterpret_cast<const Vec*>(item);
  Vec* slices = reinterpret_cast<Vec*>(red);
  for (int v0 = 0; v0 < nvv; v0 += width) {
    const int v = v0 + tid % width, sl = tid / width;
    const bool mine = v < nvv && sl < nsl;
    float acc[kSumDepth][V];
#pragma unroll
    for (int u = 0; u < kSumDepth; ++u)
#pragma unroll
      for (int i = 0; i < V; ++i) acc[u][i] = 0.f;
    if (mine) {
      int p = sl;
      for (; p + (kSumDepth - 1) * nsl < P; p += kSumDepth * nsl) {
#pragma unroll
        for (int u = 0; u < kSumDepth; ++u) {
          const float* q = reinterpret_cast<const float*>(src + (size_t)(p + u * nsl) * nvv + v);
          if constexpr (V == 4) {
            const float4 f = __ldcg(reinterpret_cast<const float4*>(q));
            acc[u][0] += f.x, acc[u][1] += f.y, acc[u][2] += f.z, acc[u][3] += f.w;
          } else {
            acc[u][0] += __ldcg(q);
          }
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
        out.v[i] = ((acc[0][i] + acc[1][i]) + (acc[2][i] + acc[3][i])) +
                   ((acc[4][i] + acc[5][i]) + (acc[6][i] + acc[7][i]));
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
      for (int i = 0; i < V; ++i) sums[v * V + i] = total[i];
    }
  }
}

// K9: per-channel r1, rx of this block's rows, written as the partial sums
// partial[b][chunk][2][C] (each channel tile its columns); the last block of
// the batch item adds them (gn_bwd_sum_rows) and writes coef[b] = (a2, b2, c2)
// and dparam[b] = (dgamma, dbeta) shares; the last batch item adds the shares
// into dgamma, dbeta. Dynamic shared memory: kGnThreads * 4 floats for the
// sum over chunks, the sums [2C], the group means [2G] and gamma [C].
template <typename T, int VEC, bool SILU>
__global__ void __launch_bounds__(kGnThreads) gn_bwd_stats_kernel(
    const T* __restrict__ x, const T* __restrict__ dy, const float* __restrict__ a, const float* __restrict__ s,
    float* __restrict__ partial, int* __restrict__ counters, const void* __restrict__ gamma, int wdtype,
    const float* __restrict__ mean, const float* __restrict__ inv, float* __restrict__ coef,
    float* __restrict__ dparam, void* __restrict__ dgamma, void* __restrict__ dbeta, int R, int C, int G,
    int rows_per_chunk, float count) {
  extern __shared__ __align__(16) float gn_fin[];
  const GnTile t = gn_tile<VEC>(R, C, rows_per_chunk);
  const int tid = threadIdx.x, b = blockIdx.z, B = gridDim.z;
  float r1[VEC], rx[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) r1[i] = rx[i] = 0.f;
  if (t.active) {
    float av[VEC], sv[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) av[i] = sv[i] = 0.f;
    if (SILU) {
      load_vec<float, VEC>(a + (size_t)b * C + t.col, av);
      load_vec<float, VEC>(s + (size_t)b * C + t.col, sv);
    }
    const size_t base = (size_t)b * R * C + t.col;
#pragma unroll 4
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
  __threadfence();  // this block's partials are visible to the block that finishes
  __syncthreads();
  const int P = (int)(gridDim.x * gridDim.y);
  if (!__syncthreads_or(tid == 0 && atomicAdd(counters + b, 1) == P - 1)) return;
  __threadfence();

  float* red = gn_fin;                   // kGnThreads * 4: the sum's slices
  float* sums = red + 4 * kGnThreads;    // [2][C]: r1, then rx
  float* gm = sums + 2 * C;              // [G][2]: m1, m2
  float* gw = gm + 2 * G;                // [C]: gamma in fp32
  for (int c = tid; c < C; c += kGnThreads) gw[c] = load_param(gamma, c, wdtype);
  const float* item = partial + (size_t)b * gridDim.x * 2 * C;
  if (C % 2 == 0)
    gn_bwd_sum_rows<4>(item, gridDim.x, 2 * C, red, sums);
  else
    gn_bwd_sum_rows<1>(item, gridDim.x, 2 * C, red, sums);
  __syncthreads();
  const float *mu = mean + (size_t)b * G, *iv = inv + (size_t)b * G;
  gn_bwd_group_means(sums, C, G, C / G, gw, mu, iv, count, gm, kGnThreads / 32);
  __syncthreads();
  float* cf = coef + (size_t)b * 3 * C;
  float* dp = dparam + (size_t)b * 2 * C;
  const int cgs = C / G;
  for (int c = tid; c < C; c += kGnThreads) {
    const int g = c / cgs;
    gn_bwd_coef(c, cgs, gm, gw, mu, iv, &cf[c], &cf[C + c], &cf[2 * C + c]);
    dp[c] = iv[g] * (sums[C + c] - mu[g] * sums[c]);
    dp[C + c] = sums[c];
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) counters[b] = 0;  // ready for the next call
  if (!__syncthreads_or(tid == 0 && atomicAdd(counters + B, 1) == B - 1)) return;
  __threadfence();
  for (int c = tid; c < C; c += kGnThreads) {
    store_param(dgamma, c, wdtype, gn_bwd_share_sum(dparam, B, C, 0, c));
    store_param(dbeta, c, wdtype, gn_bwd_share_sum(dparam, B, C, 1, c));
  }
  if (tid == 0) counters[B] = 0;
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

// ---- launches -----------------------------------------------------------------

// How many clusters of n slab blocks of smem bytes the device holds at once (0: none).
template <typename Kernel>
int slab_clusters(Kernel kernel, int n, int smem, int* clusters) {
  *clusters = 0;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)n, attr[0].val.clusterDim.y = 1, attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3((unsigned)n, 1, 1);
  cfg.blockDim = dim3(kSlabThreads, 1, 1);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t rc = cudaOccupancyMaxActiveClusters(clusters, (void*)kernel, &cfg);
  if (rc != cudaSuccess) cudaGetLastError();  // reported by the return code, not left pending
  return (int)rc;
}

template <typename T, bool SILU>
int launch_slab(const void* x, const void* dy, const float* a, const float* s, const void* gamma, int wdtype,
                const float* mean, const float* inv, void* dx, float* dparam, int* counters, void* dgamma,
                void* dbeta, int B, int R, int C, int G, int gc, int n, int rows, int box_rows,
                cudaStream_t stream) {
  auto kernel = gn_bwd_slab_kernel<T, SILU>;
  const int W = gc * (C / G), item = (int)sizeof(T);
  const SlabLayout L = slab_layout(rows, box_rows, W, item, gc);
  if (L.total > kSlabSmemMax) return kErrBadArgument;
  if (n > kSlabMaxCluster) return (int)cudaErrorInvalidClusterSize;   // no H100 places a larger cluster
  // more than 48 KB of shared memory and clusters of 16 are opted into once per process
  static const cudaError_t smem_attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSlabSmemMax);
  if (smem_attr != cudaSuccess) return (int)smem_attr;
  static const cudaError_t cluster_attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (cluster_attr != cudaSuccess) return (int)cluster_attr;
  const long long items = (long long)B * (G / gc);
  long long grid_clusters = items;   // one block an item on one-block clusters
  if (n > 1) {
    // the clusters the device holds at once, asked once per (cluster size, shared memory): the persistent grid
    struct Known {
      int n, smem, clusters;
    };
    static Known known[64];
    static int nknown = 0;
    int clusters = -1;
    for (int i = 0; i < nknown && clusters < 0; ++i)
      if (known[i].n == n && known[i].smem == L.total) clusters = known[i].clusters;
    if (clusters < 0) {
      if (const int rc = slab_clusters(kernel, n, L.total, &clusters)) return rc;
      if (nknown < 64) known[nknown++] = {n, L.total, clusters};
    }
    if (clusters == 0) return (int)cudaErrorInvalidClusterSize;  // the device cannot place one
    grid_clusters = items < clusters ? items : clusters;
  }
  if (n * grid_clusters > 0x7fffffffLL) return kErrBadArgument;
  const cuuint64_t dims[3] = {(cuuint64_t)C, (cuuint64_t)R, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)C * item, (cuuint64_t)R * C * item};
  const cuuint32_t box[3] = {(cuuint32_t)W, (cuuint32_t)box_rows, 1};
  const CUtensorMapDataType dt = item == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  CUtensorMap maps[3];
  const void* bases[3] = {x, dy, dx};
  for (int i = 0; i < 3; ++i)
    if (const int rc = tma_tiled_map(dt, CU_TENSOR_MAP_SWIZZLE_NONE, bases[i], 3, dims, strides, box, &maps[i]))
      return rc;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)n, attr[0].val.clusterDim.y = 1, attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3((unsigned)(n * grid_clusters), 1, 1);
  cfg.blockDim = dim3(kSlabThreads, 1, 1);
  cfg.dynamicSmemBytes = (size_t)L.total;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const float count = (float)((double)R * (double)(C / G));
  const cudaError_t rc = cudaLaunchKernelEx(&cfg, kernel, maps[0], maps[1], maps[2], a, s, gamma, wdtype, mean, inv,
                                            dparam, counters, dgamma, dbeta, B, R, C, G, gc, rows, box_rows, count);
  return rc != cudaSuccess ? (int)rc : (int)cudaGetLastError();
}

template <typename T, int VEC>
int launch_bwd_stats(const void* x, const void* dy, const float* a, const float* s, float* partial,
                     int* counters, const void* gamma, int wdtype, const float* mean, const float* inv,
                     float* coef, float* dparam, void* dgamma, void* dbeta, int B, int R, int C, int G,
                     int rows_per_chunk, int nchunks, int silu, cudaStream_t stream) {
  const dim3 grid = gn_grid(B, C, VEC, nchunks);
  // dynamic shared memory beside the static partial-sum buffer (opted into
  // above 48 KB in all: once per instance, up to what a block may take)
  constexpr int kStatic = (int)sizeof(float) * kGnThreads * 2 * VEC;
  const size_t smem = sizeof(float) * (3 * (size_t)C + 2 * (size_t)G + 4 * kGnThreads);
  if (smem > (size_t)(kSlabSmemMax - kStatic)) return kErrBadArgument;
  static const cudaError_t attr[2] = {
      cudaFuncSetAttribute(gn_bwd_stats_kernel<T, VEC, false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kSlabSmemMax - kStatic),
      cudaFuncSetAttribute(gn_bwd_stats_kernel<T, VEC, true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kSlabSmemMax - kStatic)};
  if (attr[silu ? 1 : 0] != cudaSuccess) return (int)attr[silu ? 1 : 0];
  auto kernel = silu ? gn_bwd_stats_kernel<T, VEC, true> : gn_bwd_stats_kernel<T, VEC, false>;
  const float count = (float)((double)R * (double)(C / G));
  kernel<<<grid, kGnThreads, smem, stream>>>(static_cast<const T*>(x), static_cast<const T*>(dy), a, s, partial,
                                              counters, gamma, wdtype, mean, inv, coef, dparam, dgamma, dbeta, R,
                                              C, G, rows_per_chunk, count);
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

// The one-launch backward: x, dy, dx contiguous [B, R, C], 16-byte aligned;
// gc whole groups a slab (gc * C / G * itemsize a multiple of 16 bytes, gc * C
// / G <= 256); n blocks a cluster (1: no cluster), each holding `rows` rows in
// boxes of box_rows (<= 256, dividing rows, at most kSlabMaxBoxes), n * rows
// >= R; a, s: the forward's fp32 [B, C] (read only with silu); gamma [C] in
// wdtype; mean, inv fp32 [B, G]; dparam: fp32 scratch [B, 2, C]; counters:
// G / gc ints, zero, left zero; dgamma, dbeta [C] in wdtype.
extern "C" int vs_group_norm_bwd_slab(int dtype, const void* x, const void* dy, const void* a, const void* s,
                                      const void* gamma, int wdtype, const void* mean, const void* inv, void* dx,
                                      void* dparam, void* counters, void* dgamma, void* dbeta, int B, int R, int C,
                                      int G, int gc, int n, int rows, int box_rows, int silu, void* stream) {
  using namespace vs;
  if (B <= 0 || B > 65535 || R <= 0 || C <= 0 || G <= 0 || C % G || gc <= 0 || G % gc) return kErrBadArgument;
  if (wdtype != kFloat32 && wdtype != kBFloat16) return kErrUnsupported;
  const int item = dtype == kBFloat16 ? 2 : 4, W = gc * (C / G);
  if (W % 2 || W * item % 16 || W > 256 || n <= 0 || box_rows <= 0 || box_rows > 256 || rows % box_rows ||
      rows / box_rows > kSlabMaxBoxes || (long long)n * rows < R)
    return kErrBadArgument;
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(dy) | reinterpret_cast<uintptr_t>(dx)) % 16)
    return kErrBadArgument;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float *af = static_cast<const float*>(a), *sf = static_cast<const float*>(s);
  const float *mf = static_cast<const float*>(mean), *vf = static_cast<const float*>(inv);
  float* dp = static_cast<float*>(dparam);
  int* cnt = static_cast<int*>(counters);
  if (dtype == kBFloat16)
    return silu ? launch_slab<__nv_bfloat16, true>(x, dy, af, sf, gamma, wdtype, mf, vf, dx, dp, cnt, dgamma, dbeta,
                                                   B, R, C, G, gc, n, rows, box_rows, st)
                : launch_slab<__nv_bfloat16, false>(x, dy, af, sf, gamma, wdtype, mf, vf, dx, dp, cnt, dgamma,
                                                    dbeta, B, R, C, G, gc, n, rows, box_rows, st);
  if (dtype == kFloat32)
    return silu ? launch_slab<float, true>(x, dy, af, sf, gamma, wdtype, mf, vf, dx, dp, cnt, dgamma, dbeta, B, R,
                                           C, G, gc, n, rows, box_rows, st)
                : launch_slab<float, false>(x, dy, af, sf, gamma, wdtype, mf, vf, dx, dp, cnt, dgamma, dbeta, B, R,
                                            C, G, gc, n, rows, box_rows, st);
  return kErrUnsupported;
}

// K9. x, dy: contiguous [B, R, C]; a, s: the forward's fp32 [B, C] scale and
// shift (read only with silu); partial: fp32 scratch [B, nchunks, 2, C];
// counters: B + 1 ints, zero, left zero; gamma: [C] in wdtype; mean, inv: fp32
// [B, G]; coef: fp32 [B, 3, C] (a2, b2, c2) for K10; dparam: fp32 scratch [B,
// 2, C]; dgamma, dbeta: [C] in wdtype.
extern "C" int vs_group_norm_bwd_stats(int dtype, const void* x, const void* dy, const void* a,
                                       const void* s, void* partial, void* counters, const void* gamma,
                                       int wdtype, const void* mean, const void* inv, void* coef,
                                       void* dparam, void* dgamma, void* dbeta, int B, int R, int C, int G,
                                       int vec, int rows_per_chunk, int nchunks, int silu, void* stream) {
  using namespace vs;
  if (!gn_args_ok(B, R, C, vec, rows_per_chunk, nchunks) || G <= 0 || C % G || G > kMaxGroups)
    return kErrBadArgument;
  if (wdtype != kFloat32 && wdtype != kBFloat16) return kErrUnsupported;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* af = static_cast<const float*>(a);
  const float* sf = static_cast<const float*>(s);
  const float *mf = static_cast<const float*>(mean), *vf = static_cast<const float*>(inv);
  float *part = static_cast<float*>(partial), *cf = static_cast<float*>(coef), *dp = static_cast<float*>(dparam);
  int* cnt = static_cast<int*>(counters);
  if (dtype == kBFloat16 && vec == 8)
    return launch_bwd_stats<__nv_bfloat16, 8>(x, dy, af, sf, part, cnt, gamma, wdtype, mf, vf, cf, dp, dgamma,
                                              dbeta, B, R, C, G, rows_per_chunk, nchunks, silu, st);
  if (dtype == kBFloat16 && vec == 1)
    return launch_bwd_stats<__nv_bfloat16, 1>(x, dy, af, sf, part, cnt, gamma, wdtype, mf, vf, cf, dp, dgamma,
                                              dbeta, B, R, C, G, rows_per_chunk, nchunks, silu, st);
  if (dtype == kFloat32 && vec == 4)
    return launch_bwd_stats<float, 4>(x, dy, af, sf, part, cnt, gamma, wdtype, mf, vf, cf, dp, dgamma, dbeta, B,
                                      R, C, G, rows_per_chunk, nchunks, silu, st);
  if (dtype == kFloat32 && vec == 1)
    return launch_bwd_stats<float, 1>(x, dy, af, sf, part, cnt, gamma, wdtype, mf, vf, cf, dp, dgamma, dbeta, B,
                                      R, C, G, rows_per_chunk, nchunks, silu, st);
  return kErrUnsupported;
}

// K10. dx = a2 * u + b2 * x + c2 with u as in K9; dx contiguous [B, R, C].
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
