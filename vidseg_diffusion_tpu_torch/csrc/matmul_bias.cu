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
// UNets): the persistent wgmma loop of wgmma_tile.cuh (shared with K4) fed by
// TMA. K is short here (5 to 20 slices of 64), so a block that did one output
// tile would spend as long filling its ring and storing its tile as
// multiplying. Instead one block per SM walks the output tiles (the column
// tiles of one row block are neighbours, so blocks that run together share
// x's rows in L2): the x rows come by a rank-2 tiled map over [M, K] (BM rows x
// 64 channels a box, 128-byte swizzle), the W rows by the one-tap weight map
// (160 x 64); a producer warp runs ahead into the next tile, and each consumer
// warpgroup stores its own 64 rows through a staging tile. Two tile heights, 192 rows (three warpgroups, three stages) and 128 (two,
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

// K11's walk of the persistent loop (wgmma_tile.cuh): x [M, K] by a rank-2
// tiled map (BM rows x 64 channels a box), W [N, K] by the one-tap weight map;
// the column tiles of one row block are neighbours.
struct RowsWalk {
  const CUtensorMap* xmap;
  const CUtensorMap* wmap;
  long long M;
  int ncol, nk, bm, bn;
  struct Tile {
    long long out_row0;
    int rows, col0;
  };
  __device__ __forceinline__ Tile tile(int i) const {
    const long long row0 = (long long)(i / ncol) * bm;
    return Tile{row0, (int)min((long long)bm, M - row0), (i % ncol) * bn};
  }
  __device__ __forceinline__ int slices(const Tile&) const { return nk; }
  __device__ __forceinline__ void load(uint32_t a, uint32_t b, uint32_t bar, const Tile& t, int s) const {
    tma_load_2d(a, xmap, bar, s * WT_BK, (int)t.out_row0);
    tma_load_3d(b, wmap, bar, s * WT_BK, t.col0, 0);
  }
};

template <class C>
__global__ void __launch_bounds__(C::THREADS, 1) matmul_bias_wgmma_kernel(
    const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap wmap,
    const __nv_bfloat16* __restrict__ bias, __nv_bfloat16* __restrict__ y, long long M, int K, int N,
    int ncol, int ntiles) {
  extern __shared__ unsigned char mb_smem[];
  const RowsWalk walk{&xmap, &wmap, M, ncol, (K + WT_BK - 1) / WT_BK, C::BM, C::BN};
  wgmma_persistent<C>(walk, ntiles, bias, y, N, mb_smem);
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

// rows one SM walks under a tiling of bm x 160
inline long long mb_rows_per_sm(long long M, int N, int bm, int sms) {
  return persistent_rows_per_sm(((M + bm - 1) / bm) * ((N + 159) / 160), bm, sms);
}

// 192 or 128 rows a tile, whichever leaves an SM the fewer rows to walk (the
// last round of tiles is the one that leaves SMs idle): 192 at ds1, mid and
// SD's 77-token context products into 1280 channels ([2156, 1024 -> 1280]),
// 128 at ds2, ds4, the context products into 320 and 640 channels and the
// one-token ones.
int launch_matmul_bias_wgmma(const void* x, const void* w, const void* bias, void* y, long long M, int K,
                             int N, cudaStream_t stream) {
  int sms = 0;
  if (const int rc = device_sms(&sms)) return rc;
  if (mb_rows_per_sm(M, N, 192, sms) <= mb_rows_per_sm(M, N, 128, sms))
    return launch_matmul_bias_wgmma_cfg<PersistentTile<3, 160, 3>>(x, w, bias, y, M, K, N, sms, stream);
  return launch_matmul_bias_wgmma_cfg<PersistentTile<2, 160, 4>>(x, w, bias, y, M, K, N, sms, stream);
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
