// K12 conv3x3_same: the 3x3, stride-1, zero-padded ("SAME") convolution on
// channels-last x [B, H, W, Cin] with per-tap weights W [9, Cout, Cin] (tap =
// 3*dy + dx) and bias [Cout] or none -> y [B, H, W, Cout]:
//
//     y[b, h, w] = sum over dy, dx of x[b, h+dy-1, w+dx-1] @ W[3*dy+dx]^T + bias
//
// with zeros outside the image, fp32 accumulation, one cast at the store.
//
// Replaces (TPU): vidseg_diffusion_tpu/ops/conv3x3.py:_kernel (via
// _conv3x3_impl). It runs at the two 3x3 convolutions of every UNet ResBlock:
// [28, 56, 104, 320 -> 320] down to [28, 7, 13, 1280], and the output blocks'
// skip concatenations (960 -> 320, 1920 -> 640, 2560 -> 1280).
//
// What bounds it on the H100: an implicit GEMM with M = B*H*W output pixels,
// N = Cout and K = 9*Cin: 2*M*9*Cin*Cout flops against (M*Cin + 9*Cin*Cout +
// M*Cout) elements, thousands of flops per byte, so the tensor cores. Design:
// the nine taps are part of the K loop of one tile. A row of the tile is one
// output pixel; for tap (dy, dx) it reads the Cin channels of pixel (h+dy-1,
// w+dx-1) of its own image, or zeros when that pixel lies outside it. Nothing
// is padded or copied in device memory, and a tile that spans several images
// mixes nothing. Bias add and cast are fused into the store.
// - bf16 with Cin % 8 == 0 and 16-byte aligned x and w (every ResBlock of the
//   UNets): the wgmma tile of wgmma_tile.cuh, 192 pixels x 160 channels per
//   block, 64-channel slices through a five-stage ring that a producer thread
//   fills by TMA. The activations come through an im2col tensor map of x: the
//   hardware walks the tile's 192 pixels across image rows and images and
//   writes zeros for the halo; the weights come through a tiled map. Stores
//   are 16 bytes a thread;
// - other bf16 shapes: the mma.sync tile of gemm_tile.cuh with element loads,
//   whose rows decode their own (b, h, w) and take the halo as a predicate;
// - fp32 (the card-vs-CPU checks): the FMA tile of gemm_tile.cuh, likewise.
// The choice is made here, from the shapes and the pointers; nothing falls
// back when a launch is refused.
#include "gemm_tile.cuh"
#include "wgmma_tile.cuh"

namespace vs {

// The row source of the gemm_tile.cuh tiles.
template <typename T>
struct ConvRows {
  const T* x;
  int H, W, C;
  struct Slot {
    long long g;   // flat pixel index (b*H + h)*W + w, or -1 off the range
    int h, w;
  };
  __device__ __forceinline__ Slot slot(long long g, long long R) const {
    if (g >= R) return Slot{-1, 0, 0};
    const long long bh = g / W;
    return Slot{g, (int)(bh % H), (int)(g - bh * W)};
  }
  __device__ __forceinline__ const T* ptr(const Slot& s, int tap) const {
    const int dy = tap / 3 - 1, dx = tap % 3 - 1;
    const int hh = s.h + dy, ww = s.w + dx;
    if (s.g < 0 || hh < 0 || hh >= H || ww < 0 || ww >= W) return nullptr;
    return x + (s.g + (long long)dy * W + dx) * C;
  }
};

constexpr int C3_BM = 192;     // three consumer warpgroups, one block per SM
constexpr int C3_BN = 160;     // divides 320, 640 and 1280
constexpr int C3_STAGES = 5;   // 5 x 44 KB
using C3Tile = WgmmaTile<C3_BM, C3_BN, C3_STAGES>;

// The A box of the wgmma tile: C3_BM output pixels from flat pixel row0 on, read
// at tap (dy, dx) = (tap / 3 - 1, tap % 3 - 1) through the im2col map of x.
struct ConvIm2col {
  const CUtensorMap* map;
  int w, h, n;  // the tile's first pixel
  __device__ __forceinline__ void operator()(uint32_t dst, uint32_t bar, int k0, int tap) const {
    tma_load_im2col_4d(dst, map, bar, k0, w - 1, h - 1, n, tap % 3, tap / 3);
  }
};

__global__ void __launch_bounds__(C3Tile::THREADS, 1) conv3x3_wgmma_kernel(
    const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap wmap,
    const __nv_bfloat16* __restrict__ bias, __nv_bfloat16* __restrict__ y, long long R, int H, int W,
    int Cin, int Cout, int ncol) {
  extern __shared__ unsigned char conv_smem[];
  const long long row0 = (long long)(blockIdx.x / ncol) * C3_BM;
  const int col0 = (blockIdx.x % ncol) * C3_BN;
  const long long bh = row0 / W;
  const ConvIm2col load_a{&xmap, (int)(row0 - bh * W), (int)(bh % H), (int)(bh / H)};
  wgmma_nk_tile<C3_BM, C3_BN, C3_STAGES>(load_a, &wmap, bias, y, 9, Cin, Cout, R, row0, col0,
                                         smem_align_1024(conv_smem));
}

// bf16 shapes the wgmma tile does not take (Cin % 8 != 0 or unaligned bases)
template <int NT>
__global__ void __launch_bounds__(256, 2) conv3x3_mma_kernel(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
    const __nv_bfloat16* __restrict__ bias, __nv_bfloat16* __restrict__ y, long long R, int H, int W,
    int Cin, int Cout, int ncol) {
  const long long row0 = (long long)(blockIdx.x / ncol) * GT_BM;
  const int col0 = (blockIdx.x % ncol) * 32 * NT;
  gemm_nk_mma_tile<NT, false>(ConvRows<__nv_bfloat16>{x, H, W, Cin}, w, bias, y, 9, Cin, Cout, R, row0,
                              col0);
}

__global__ void __launch_bounds__(256) conv3x3_fma_kernel(
    const float* __restrict__ x, const float* __restrict__ w, const float* __restrict__ bias,
    float* __restrict__ y, long long R, int H, int W, int Cin, int Cout, int ncol) {
  const long long row0 = (long long)(blockIdx.x / ncol) * GT_BM;
  const int col0 = (blockIdx.x % ncol) * GT_FBN;
  gemm_nk_fma_tile(ConvRows<float>{x, H, W, Cin}, w, bias, y, 9, Cin, Cout, R, row0, col0);
}

int launch_conv3x3_wgmma(const __nv_bfloat16* x, const __nv_bfloat16* w, const __nv_bfloat16* bias,
                         __nv_bfloat16* y, int B, int H, int W, int Cin, int Cout, cudaStream_t stream) {
  // more than 48 KB of shared memory is opted into once per process
  static const cudaError_t attr = cudaFuncSetAttribute(
      conv3x3_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C3Tile::BYTES);
  if (attr != cudaSuccess) return (int)attr;
  const long long R = (long long)B * H * W;
  unsigned blocks;
  int ncol;
  if (!wgmma_grid(R, Cout, C3_BM, C3_BN, &blocks, &ncol)) return kErrBadArgument;
  CUtensorMap xmap, wmap;
  if (const int rc = wgmma_im2col3x3_map(x, B, H, W, Cin, C3_BM, &xmap)) return rc;
  if (const int rc = wgmma_weight_map(w, 9, Cout, Cin, C3_BN, &wmap)) return rc;
  conv3x3_wgmma_kernel<<<blocks, C3Tile::THREADS, C3Tile::BYTES, stream>>>(xmap, wmap, bias, y, R, H, W, Cin,
                                                                         Cout, ncol);
  return (int)cudaGetLastError();
}

template <int NT>
int launch_conv3x3_mma(const __nv_bfloat16* x, const __nv_bfloat16* w, const __nv_bfloat16* bias,
                       __nv_bfloat16* y, long long R, int H, int W, int Cin, int Cout,
                       cudaStream_t stream) {
  unsigned blocks;
  int ncol;
  if (!gemm_grid(R, Cout, 32 * NT, &blocks, &ncol)) return kErrBadArgument;
  conv3x3_mma_kernel<NT><<<blocks, 256, 0, stream>>>(x, w, bias, y, R, H, W, Cin, Cout, ncol);
  return (int)cudaGetLastError();
}

}  // namespace vs

// x [B, H, W, Cin], w [9, Cout, Cin], bias [Cout] or NULL, y [B, H, W, Cout];
// all contiguous, one dtype.
extern "C" int vs_conv3x3_same(int dtype, const void* x, const void* w, const void* bias, void* y,
                               int B, int H, int W, int Cin, int Cout, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || Cin <= 0 || Cout <= 0) return vs::kErrBadArgument;
  const long long R = (long long)B * H * W;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == vs::kBFloat16) {
    const auto* xb = static_cast<const __nv_bfloat16*>(x);
    const auto* wb = static_cast<const __nv_bfloat16*>(w);
    const auto* bb = static_cast<const __nv_bfloat16*>(bias);
    auto* yb = static_cast<__nv_bfloat16*>(y);
    if (vs::gemm_vec_ok(x, w, Cin)) return vs::launch_conv3x3_wgmma(xb, wb, bb, yb, B, H, W, Cin, Cout, s);
    if (vs::gemm_wide_tile(Cout)) return vs::launch_conv3x3_mma<4>(xb, wb, bb, yb, R, H, W, Cin, Cout, s);
    return vs::launch_conv3x3_mma<2>(xb, wb, bb, yb, R, H, W, Cin, Cout, s);
  }
  if (dtype == vs::kFloat32) {
    unsigned blocks;
    int ncol;
    if (!vs::gemm_grid(R, Cout, vs::GT_FBN, &blocks, &ncol)) return vs::kErrBadArgument;
    vs::conv3x3_fma_kernel<<<blocks, 256, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w), static_cast<const float*>(bias),
        static_cast<float*>(y), R, H, W, Cin, Cout, ncol);
    return (int)cudaGetLastError();
  }
  return vs::kErrUnsupported;
}

