// K11 matmul_bias: y = x @ W^T + bias on x [M, K], W [N, K] (nn.Linear's weight,
// read in place), bias [N] or none -> y [M, N], fp32 accumulation, one cast at
// the store.
//
// Replaces (TPU): vidseg_diffusion_tpu/ops/matmul.py:_kernel (via
// _matmul_bias_impl). It runs at every CrossAttention projection (to_q, to_k,
// to_v without a bias, to_out with one): M is the token count of the CFG batch
// (28 to 163 072 rows), K and N the widths 320 / 640 / 1280, and K = 1024 for
// the to_k / to_v of a cross-attention context.
//
// What bounds it on the H100: 2*M*K*N flops against (M*K + N*K + M*N) elements.
// At K = N = 320 that is 160 flops per byte, below the card's ~295: the large
// sites are bound by memory, the 1280-wide ones by the tensor cores.
//
// bf16 with K % 8 == 0 and 16-byte aligned x and W (every projection of the
// UNets): a persistent wgmma kernel fed by TMA. K is short here (5 to 20
// slices of 64), so a block that did one output tile would spend as long
// filling its ring and storing its tile as multiplying. Instead one block per
// SM walks the output tiles (tile += gridDim.x; the column tiles of one row
// block are neighbours, so blocks that run together share x's rows in L2):
// - one producer thread (its own warp) asks TMA for the slices of its tiles,
//   tile after tile, through a ring of STAGES stages: the x rows by a rank-2
//   tiled map over [M, K] (BM rows x 64 channels a box, 128-byte swizzle), the
//   W rows by the one-tap weight map (160 x 64). It runs ahead into the next
//   tile while the consumers finish the current one. What lies outside M, N or
//   K arrives as zeros;
// - consumer warpgroups own 64 rows each (one m64n160k16 accumulator, 80 fp32
//   registers a thread); per slice four wgmmas from shared memory, the stage
//   handed back once the slice after it is issued;
// - the epilogue of each warpgroup is its own: bias add in fp32 and one
//   rounding into a staging tile of its 64 rows (not the ring, which the
//   producer is filling), then 16-byte stores along N (element stores when
//   N % 8 != 0), predicated on M and N; then it goes on to its next tile.
// Two tile heights, 192 rows (three warpgroups, three stages) and 128 (two,
// four stages), whichever leaves an SM the fewer rows to walk. Measured and
// dropped (PERF.md): the same tiles without persistence (one block per tile,
// 1.1-1.2x slower at the large sites), 128 x 320 tiles that read x once (160
// accumulator registers: ptxas spills and serializes the wgmmas), and stores
// straight from the accumulators with the staging tile's room given to one
// more stage (4-byte stores half a sector wide: 1.4-1.8x slower).
// Other bf16 inputs (K % 8 != 0, unaligned bases) take the mma.sync tile of
// gemm_tile.cuh, fp32 the FMA tile (the card-vs-CPU checks); no main path
// sends either. The entry reports which kernel ran (`route`). The residual /
// AlphaBlender epilogue is not here yet.
#include "gemm_tile.cuh"
#include "wgmma_tile.cuh"

namespace vs {

template <int NWG_, int STAGES_>
struct MB {
  static constexpr int NWG = NWG_, STAGES = STAGES_;
  static constexpr int BM = 64 * NWG, BN = 160;
  static constexpr int CONSUMERS = 128 * NWG;
  static constexpr int THREADS = CONSUMERS + 32;       // consumer warpgroups, then the producer warp
  static constexpr int A_BYTES = BM * 128, B_BYTES = BN * 128, STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int RING_BYTES = STAGES * STAGE_BYTES;
  static constexpr int OUT_PITCH = BN + 8;             // staging row in elements: conflict-free, 16-byte rows
  static constexpr int OUT_BYTES = BM * OUT_PITCH * 2;
  static constexpr int BAR_OFFSET = RING_BYTES + OUT_BYTES;  // STAGES full, then STAGES empty mbarriers
  static constexpr int SMEM_BYTES = BAR_OFFSET + 16 * STAGES + 1024;
  static_assert(SMEM_BYTES <= 232448, "shared memory of one block");
};

template <class C>
__global__ void __launch_bounds__(C::THREADS, 1) matmul_bias_wgmma_kernel(
    const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap wmap,
    const __nv_bfloat16* __restrict__ bias, __nv_bfloat16* __restrict__ y, long long M, int K, int N,
    int ncol, int ntiles) {
  constexpr int NWG = C::NWG, STAGES = C::STAGES, BM = C::BM, BN = C::BN;
  constexpr int CONSUMERS = C::CONSUMERS, A_BYTES = C::A_BYTES, STAGE_BYTES = C::STAGE_BYTES;
  constexpr int RING_BYTES = C::RING_BYTES, OUT_PITCH = C::OUT_PITCH, BAR_OFFSET = C::BAR_OFFSET;
  extern __shared__ unsigned char mb_smem[];
  unsigned char* smem = smem_align_1024(mb_smem);
  const uint32_t sbase = smem_u32(smem);
  const uint32_t full_bar = sbase + BAR_OFFSET, empty_bar = full_bar + 8 * STAGES;
  const int tid = threadIdx.x, wg = tid >> 7;
  const int nsl = (K + WT_BK - 1) / WT_BK;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full_bar + 8 * s, 1);
      mbar_init(empty_bar + 8 * s, NWG);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == NWG) {
    // the producer warp: one thread keeps the ring full across the block's tiles
    if (tid == CONSUMERS) {
      int stage = 0, it = 0;
      uint32_t parity = 1;  // of the empty barriers: the ring's round before this one
      for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
        const int row0 = (tile / ncol) * BM, col0 = (tile % ncol) * BN;
        for (int k0 = 0; k0 < K; k0 += WT_BK, ++it) {
          if (it >= STAGES) mbar_wait(empty_bar + 8 * stage, parity);
          const uint32_t sa = sbase + stage * STAGE_BYTES, bar = full_bar + 8 * stage;
          mbar_expect_tx(bar, STAGE_BYTES);
          tma_load_2d(sa, &xmap, bar, k0, row0);
          tma_load_3d(sa + A_BYTES, &wmap, bar, k0, col0, 0);
          if (++stage == STAGES) {
            stage = 0;
            parity ^= 1;
          }
        }
      }
    }
    return;
  }

  const int warp = (tid >> 5) & 3, lane = tid & 31, gid = lane >> 2, tig = lane & 3;
  const int wsync = 1 + wg;  // this warpgroup's named barrier
  __nv_bfloat16* outs = reinterpret_cast<__nv_bfloat16*>(smem + RING_BYTES) + wg * 64 * OUT_PITCH;
  const bool vec_out = N % 8 == 0 && reinterpret_cast<uintptr_t>(y) % 16 == 0;
  int stage = 0;
  uint32_t parity = 0;  // of the full barriers: the ring's current round
  float acc[BN / 2];
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const long long row0 = (long long)(tile / ncol) * BM;
    const int col0 = (tile % ncol) * BN;
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    int prev = 0;
    for (int s = 0; s < nsl; ++s) {
      mbar_wait(full_bar + 8 * stage, parity);
      const uint32_t sa = sbase + stage * STAGE_BYTES + wg * 64 * 128;
      const uint32_t sb = sbase + stage * STAGE_BYTES + A_BYTES;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < WT_BK / 16; ++kk)
        wgmma_m64n160k16_ss(acc, wgmma_desc(sa + kk * 32, 16, 1024), wgmma_desc(sb + kk * 32, 16, 1024), 1);
      wgmma_commit();
      wgmma_wait<1>();  // the slice before is done with its stage: hand it back
      if (s > 0 && (tid & 127) == 0) mbar_arrive(empty_bar + 8 * prev);
      prev = stage;
      if (++stage == STAGES) {
        stage = 0;
        parity ^= 1;
      }
    }
    wgmma_wait<0>();
    wgmma_fence_regs(acc);
    if ((tid & 127) == 0) mbar_arrive(empty_bar + 8 * prev);

    // epilogue: this warpgroup's 64 rows through its staging rows
    bar_sync(wsync, 128);  // its previous tile's stores have read the staging rows
    const int r_lo = warp * 16 + gid;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int c = j * 8 + tig * 2;
      float b0 = 0.f, b1 = 0.f;
      if (bias != nullptr) {
        if (col0 + c < N) b0 = __bfloat162float(bias[col0 + c]);
        if (col0 + c + 1 < N) b1 = __bfloat162float(bias[col0 + c + 1]);
      }
      *reinterpret_cast<__nv_bfloat162*>(&outs[r_lo * OUT_PITCH + c]) =
          __floats2bfloat162_rn(acc[4 * j] + b0, acc[4 * j + 1] + b1);
      *reinterpret_cast<__nv_bfloat162*>(&outs[(r_lo + 8) * OUT_PITCH + c]) =
          __floats2bfloat162_rn(acc[4 * j + 2] + b0, acc[4 * j + 3] + b1);
    }
    bar_sync(wsync, 128);
    const long long grow0 = row0 + wg * 64;
    const int t = tid & 127;
    if (vec_out) {
      constexpr int CH = BN / 8;
      for (int idx = t; idx < 64 * CH; idx += 128) {
        const int r = idx / CH, c = (idx - r * CH) * 8;
        if (grow0 + r < M && col0 + c < N)
          *reinterpret_cast<uint4*>(y + (grow0 + r) * N + col0 + c) =
              *reinterpret_cast<const uint4*>(&outs[r * OUT_PITCH + c]);
      }
    } else {
      for (int idx = t; idx < 64 * BN; idx += 128) {
        const int r = idx / BN, c = idx - r * BN;
        if (grow0 + r < M && col0 + c < N) y[(grow0 + r) * N + col0 + c] = outs[r * OUT_PITCH + c];
      }
    }
  }
}

template <int NT, bool VEC>
__global__ void __launch_bounds__(256, 2) matmul_bias_mma_kernel(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
    const __nv_bfloat16* __restrict__ bias, __nv_bfloat16* __restrict__ y, long long M, int K, int N,
    int ncol) {
  const long long row0 = (long long)(blockIdx.x / ncol) * GT_BM;
  const int col0 = (blockIdx.x % ncol) * 32 * NT;
  gemm_nk_mma_tile<NT, VEC>(DenseRows<__nv_bfloat16>{x, K}, w, bias, y, 1, K, N, M, row0, col0);
}

__global__ void __launch_bounds__(256) matmul_bias_fma_kernel(
    const float* __restrict__ x, const float* __restrict__ w, const float* __restrict__ bias,
    float* __restrict__ y, long long M, int K, int N, int ncol) {
  const long long row0 = (long long)(blockIdx.x / ncol) * GT_BM;
  const int col0 = (blockIdx.x % ncol) * GT_FBN;
  gemm_nk_fma_tile(DenseRows<float>{x, K}, w, bias, y, 1, K, N, M, row0, col0);
}

template <class C>
int launch_matmul_bias_wgmma_cfg(const void* x, const void* w, const void* bias, void* y, long long M, int K,
                                 int N, int sms, cudaStream_t stream) {
  // more than 48 KB of shared memory is opted into once per process
  static const cudaError_t attr = cudaFuncSetAttribute(
      matmul_bias_wgmma_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM_BYTES);
  if (attr != cudaSuccess) return (int)attr;
  unsigned tiles;
  int ncol;
  if (!wgmma_grid(M, N, C::BM, C::BN, &tiles, &ncol) || M > 0x7fffffffLL) return kErrBadArgument;
  CUtensorMap xmap, wmap;
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)M};
  const cuuint64_t strides[1] = {(cuuint64_t)K * 2};
  const cuuint32_t box[2] = {WT_BK, C::BM};
  if (const int rc = wgmma_tiled_map(x, 2, dims, strides, box, &xmap)) return rc;
  if (const int rc = wgmma_weight_map(w, 1, N, K, C::BN, &wmap)) return rc;
  const unsigned blocks = tiles < (unsigned)sms ? tiles : (unsigned)sms;  // persistent: one block per SM
  matmul_bias_wgmma_kernel<C><<<blocks, C::THREADS, C::SMEM_BYTES, stream>>>(
      xmap, wmap, static_cast<const __nv_bfloat16*>(bias), static_cast<__nv_bfloat16*>(y), M, K, N, ncol,
      (int)tiles);
  return (int)cudaGetLastError();
}

// rows one SM walks under a tiling of bm rows: its rounds of tiles times bm
inline long long mb_rows_per_sm(long long M, int N, int bm, int sms) {
  const long long tiles = ((M + bm - 1) / bm) * ((N + 159) / 160);
  return (tiles + sms - 1) / sms * bm;
}

// 192 or 128 rows a tile, whichever leaves an SM the fewer rows to walk (the
// last round of tiles is the one that leaves SMs idle): 192 at ds1, mid and
// SD's 77-token context products into 1280 channels ([2156, 1024 -> 1280]),
// 128 at ds2, ds4, the context products into 320 and 640 channels and the
// one-token ones.
int launch_matmul_bias_wgmma(const void* x, const void* w, const void* bias, void* y, long long M, int K,
                             int N, cudaStream_t stream) {
  int dev = 0, sms = 0;
  if (const cudaError_t rc = cudaGetDevice(&dev)) return (int)rc;
  if (const cudaError_t rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) return (int)rc;
  if (mb_rows_per_sm(M, N, 192, sms) <= mb_rows_per_sm(M, N, 128, sms))
    return launch_matmul_bias_wgmma_cfg<MB<3, 3>>(x, w, bias, y, M, K, N, sms, stream);
  return launch_matmul_bias_wgmma_cfg<MB<2, 4>>(x, w, bias, y, M, K, N, sms, stream);
}

template <int NT>
int launch_matmul_bias_mma(const void* x, const void* w, const void* bias, void* y, long long M, int K,
                           int N, cudaStream_t stream) {
  unsigned blocks;
  int ncol;
  if (!gemm_grid(M, N, 32 * NT, &blocks, &ncol)) return kErrBadArgument;
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* wb = static_cast<const __nv_bfloat16*>(w);
  const auto* bb = static_cast<const __nv_bfloat16*>(bias);
  auto* yb = static_cast<__nv_bfloat16*>(y);
  if (gemm_vec_ok(x, w, K))
    matmul_bias_mma_kernel<NT, true><<<blocks, 256, 0, stream>>>(xb, wb, bb, yb, M, K, N, ncol);
  else
    matmul_bias_mma_kernel<NT, false><<<blocks, 256, 0, stream>>>(xb, wb, bb, yb, M, K, N, ncol);
  return (int)cudaGetLastError();
}

}  // namespace vs

// x [M, K], w [N, K], bias [N] or NULL, y [M, N]; all contiguous, one dtype.
// route (or NULL) receives the kernel that ran: 2 the wgmma kernel, 1 the
// mma.sync tile, 0 the fp32 FMA tile.
extern "C" int vs_matmul_bias(int dtype, const void* x, const void* w, const void* bias, void* y,
                              long long M, int K, int N, int* route, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0) return vs::kErrBadArgument;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int r = -1, rc = vs::kErrUnsupported;
  if (dtype == vs::kBFloat16) {
    if (vs::gemm_vec_ok(x, w, K)) {
      r = 2;
      rc = vs::launch_matmul_bias_wgmma(x, w, bias, y, M, K, N, s);
    } else {
      r = 1;
      rc = vs::gemm_wide_tile(N) ? vs::launch_matmul_bias_mma<4>(x, w, bias, y, M, K, N, s)
                                 : vs::launch_matmul_bias_mma<2>(x, w, bias, y, M, K, N, s);
    }
  } else if (dtype == vs::kFloat32) {
    unsigned blocks;
    int ncol;
    if (!vs::gemm_grid(M, N, vs::GT_FBN, &blocks, &ncol)) return vs::kErrBadArgument;
    r = 0;
    vs::matmul_bias_fma_kernel<<<blocks, 256, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w), static_cast<const float*>(bias),
        static_cast<float*>(y), M, K, N, ncol);
    rc = (int)cudaGetLastError();
  }
  if (route != nullptr) *route = r;
  return rc;
}
