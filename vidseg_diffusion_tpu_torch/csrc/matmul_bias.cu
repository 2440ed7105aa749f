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
// sites are bound by memory, the 1280-wide ones by the tensor cores. Design: the
// one-tap case of the shared tile (gemm_tile.cuh): a 128 x 128 (or 128 x 64)
// output tile per 256-thread block, K staged through shared memory in 32-deep
// slices with the next slice's global loads in flight during the mma.sync work,
// bias add and cast fused into the store; ragged M, N and K are predicates on
// the loads and stores, never padding copies. fp32 inputs take the FMA tile.
// wgmma, TMA and the residual / AlphaBlender epilogue are next.
#include "gemm_tile.cuh"

namespace vs {

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
extern "C" int vs_matmul_bias(int dtype, const void* x, const void* w, const void* bias, void* y,
                              long long M, int K, int N, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0) return vs::kErrBadArgument;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == vs::kBFloat16) {
    if (vs::gemm_wide_tile(N)) return vs::launch_matmul_bias_mma<4>(x, w, bias, y, M, K, N, s);
    return vs::launch_matmul_bias_mma<2>(x, w, bias, y, M, K, N, s);
  }
  if (dtype == vs::kFloat32) {
    unsigned blocks;
    int ncol;
    if (!vs::gemm_grid(M, N, vs::GT_FBN, &blocks, &ncol)) return vs::kErrBadArgument;
    vs::matmul_bias_fma_kernel<<<blocks, 256, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w), static_cast<const float*>(bias),
        static_cast<float*>(y), M, K, N, ncol);
    return (int)cudaGetLastError();
  }
  return vs::kErrUnsupported;
}
