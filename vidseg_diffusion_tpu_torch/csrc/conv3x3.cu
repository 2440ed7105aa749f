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
// the shared tile (gemm_tile.cuh) with the nine taps as the outer K loop. A row
// of the tile is one output pixel; for tap (dy, dx) it reads the Cin channels
// of pixel (h+dy-1, w+dx-1) of its own image, or zeros when that pixel lies
// outside it: the halo is a predicate on the load, nothing is padded or copied,
// and a tile that spans two images mixes nothing, since every row decodes its
// own (b, h, w). Bias add and cast are fused into the store; fp32 inputs take
// the FMA tile. wgmma with TMA (im2col mode) is next.
#include "gemm_tile.cuh"

namespace vs {

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

template <int NT, bool VEC>
__global__ void __launch_bounds__(256, 2) conv3x3_mma_kernel(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
    const __nv_bfloat16* __restrict__ bias, __nv_bfloat16* __restrict__ y, long long R, int H, int W,
    int Cin, int Cout, int ncol) {
  const long long row0 = (long long)(blockIdx.x / ncol) * GT_BM;
  const int col0 = (blockIdx.x % ncol) * 32 * NT;
  gemm_nk_mma_tile<NT, VEC>(ConvRows<__nv_bfloat16>{x, H, W, Cin}, w, bias, y, 9, Cin, Cout, R, row0,
                            col0);
}

__global__ void __launch_bounds__(256) conv3x3_fma_kernel(
    const float* __restrict__ x, const float* __restrict__ w, const float* __restrict__ bias,
    float* __restrict__ y, long long R, int H, int W, int Cin, int Cout, int ncol) {
  const long long row0 = (long long)(blockIdx.x / ncol) * GT_BM;
  const int col0 = (blockIdx.x % ncol) * GT_FBN;
  gemm_nk_fma_tile(ConvRows<float>{x, H, W, Cin}, w, bias, y, 9, Cin, Cout, R, row0, col0);
}

template <int NT>
int launch_conv3x3_mma(const void* x, const void* w, const void* bias, void* y, long long R, int H,
                       int W, int Cin, int Cout, cudaStream_t stream) {
  unsigned blocks;
  int ncol;
  if (!gemm_grid(R, Cout, 32 * NT, &blocks, &ncol)) return kErrBadArgument;
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* wb = static_cast<const __nv_bfloat16*>(w);
  const auto* bb = static_cast<const __nv_bfloat16*>(bias);
  auto* yb = static_cast<__nv_bfloat16*>(y);
  if (gemm_vec_ok(x, w, Cin))
    conv3x3_mma_kernel<NT, true><<<blocks, 256, 0, stream>>>(xb, wb, bb, yb, R, H, W, Cin, Cout, ncol);
  else
    conv3x3_mma_kernel<NT, false><<<blocks, 256, 0, stream>>>(xb, wb, bb, yb, R, H, W, Cin, Cout, ncol);
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
    if (vs::gemm_wide_tile(Cout))
      return vs::launch_conv3x3_mma<4>(x, w, bias, y, R, H, W, Cin, Cout, s);
    return vs::launch_conv3x3_mma<2>(x, w, bias, y, R, H, W, Cin, Cout, s);
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
