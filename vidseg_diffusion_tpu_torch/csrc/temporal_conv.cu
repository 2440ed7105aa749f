// K4 temporal_conv_1x1: the (kt, 1, 1) video convolution
//     y[b, t] = sum_j x[b, t + j - kt/2] @ W[j]^T + bias   (zero frames off range)
// on x [B, T, M, Cin], W K-major [kt, Cout, Cin], bias [Cout] or none -> y
// [B, T, M, Cout], fp32 accumulation over every tap and channel, the bias added
// in fp32, one rounding.
//
// Replaces (TPU): vidseg_diffusion_tpu/ops/temporal_conv.py:_kernel (via
// _temporal_conv_impl). On the GPU it runs at every (kt,1,1) site: all UNet
// time_stack widths (320, 640, 1280), the VAE decoder time_stack (128 to 512)
// and the VAE's conv_out_time_mix (C = 3), and for dx in the backward (the
// same convolution of the output gradient, taps flipped) — the TPU's C <= 640
// dispatch rule does not carry over.
//
// What bounds it on the H100: it is one GEMM with M = B*T*tokens rows (tens of
// thousands to millions), K = kt*Cin and N = Cout: 2*kt*Cin*Cout flops per row
// against 2*(Cin + Cout) bytes, so the tensor cores bound the UNet widths and
// memory the VAE's 128 channels at 448x832 (a 668 MB input).
//
// bf16 with Cin and Cout multiples of 8 and 16-byte aligned x and W (every UNet
// and VAE time_stack): the persistent wgmma loop of wgmma_tile.cuh (shared with
// K11). The walk (TconvWalk):
// - A by a rank-3 tiled map over x viewed [B, T*M, Cin] (a BM-row box of 64
//   channels at row r of video b). Tap j of the tile that starts at row r0 reads
//   the box at r0 + (j - kt/2) * M: the same tokens one frame earlier or later.
//   Rows of frames -1 and T lie outside the video, so TMA writes zeros there:
//   the halo needs no predicate and videos never mix. A tap whose rows all lie
//   outside is skipped (frame 0 and T - 1 lose one of three taps);
// - tiles either per frame (rows r0 = t*M + m0, t the inner index of the walk,
//   so the three frames a tile reads were just read by its neighbours and x
//   comes from device memory about once: this matters at the VAE's 95 MB
//   frames, larger than L2) or, where per-frame tiles would waste 2 % of their
//   rows or more on each frame's ragged end (UNet ds2 to ds8: 5 to 29 % at 128
//   rows), over the whole video (rows r0 = blk * BM across frames; the frames
//   there fit in L2 together);
// - BN = 160 where it divides Cout better than 128 (the UNet's 320 / 640 /
//   1280), else 128 (the VAE's 128 / 256 / 512); BM = 192 or 128, whichever
//   leaves an SM the fewer rows to walk; the K loop is kt * Cin / 64 slices (6
//   to 60).
// Other bf16 inputs (Cin or Cout % 8 != 0: the VAE's 3-channel
// conv_out_time_mix; unaligned bases) take a CUDA-core kernel sized to the
// row: one thread per output row, kt*Cin*Cout fp32 FMAs, element loads (the
// 3-channel site moves 31 MB, bound 0.009 ms; a 128-column tensor-core tile
// would compute 40x the columns it keeps). fp32 (the card-vs-CPU checks) takes the
// FMA tile of gemm_tile.cuh. The entry reports which kernel ran (`route`).
#include "gemm_tile.cuh"
#include "wgmma_tile.cuh"

namespace vs {

struct TconvWalk {
  const CUtensorMap* xmap;
  const CUtensorMap* wmap;
  int M, TM, kt;     // tokens per frame, rows per video, taps
  int S, nseg;       // rows per segment (M: tiles per frame; T*M: over the video), segments per video
  int nblk, ncol;    // row tiles per segment, column tiles
  int nk, bm, bn;    // 64-channel slices per tap, tile shape
  struct Tile {
    long long out_row0;
    int rows, col0;
    int b, r0, j0, nj;  // video, first row in it, the taps whose rows meet the video
  };
  __device__ __forceinline__ Tile tile(int i) const {
    Tile t;
    t.col0 = (i % ncol) * bn;
    i /= ncol;
    const int seg = i % nseg;
    i /= nseg;
    const int blk = i % nblk;
    t.b = i / nblk;
    t.r0 = seg * S + blk * bm;
    t.rows = min(bm, S - blk * bm);
    t.out_row0 = (long long)t.b * TM + t.r0;
    int j0 = kt, j1 = 0;
    for (int j = 0; j < kt; ++j) {
      const int d = (j - kt / 2) * M;
      if (t.r0 + d < TM && t.r0 + t.rows + d > 0) {
        j0 = min(j0, j);
        j1 = j + 1;
      }
    }
    t.j0 = j0;
    t.nj = j1 - j0;
    return t;
  }
  __device__ __forceinline__ int slices(const Tile& t) const { return t.nj * nk; }
  __device__ __forceinline__ void load(uint32_t a, uint32_t b, uint32_t bar, const Tile& t, int s) const {
    const int j = t.j0 + s / nk, k0 = (s % nk) * WT_BK;
    tma_load_3d(a, xmap, bar, k0, t.r0 + (j - kt / 2) * M, t.b);
    tma_load_3d(b, wmap, bar, k0, t.col0, j);
  }
};

template <class C>
__global__ void __launch_bounds__(C::THREADS, 1) temporal_conv_wgmma_kernel(
    const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap wmap,
    const __nv_bfloat16* __restrict__ bias, __nv_bfloat16* __restrict__ y, TconvWalk walk, int Cout, int ntiles) {
  extern __shared__ unsigned char tc_smem[];
  walk.xmap = &xmap;
  walk.wmap = &wmap;
  wgmma_persistent<C>(walk, ntiles, bias, y, Cout, tc_smem);
}

// One thread per output row. Rows whose taps and channels fit in registers
// (kt <= 3, Cin <= 4, Cout <= 256: the 3-channel conv_out_time_mix) take the
// first kernel: a thread loads all kt * Cin inputs before its first product,
// so its loads are in flight together, and W, staged in shared memory as fp32
// with each (tap, output) row padded to 4 channels, is read by every thread of
// a warp at the same address, 16 bytes at a time. Other rows take the second:
// output columns in chunks of 8 fp32 accumulators, W through the read-only
// cache.
constexpr int NARROW_CK = 4, NARROW_KT = 3, NARROW_MAX_COUT = 256;
constexpr int NARROW_CO = 8;

__global__ void __launch_bounds__(256) temporal_conv_narrow_small_kernel(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w, const __nv_bfloat16* __restrict__ bias,
    __nv_bfloat16* __restrict__ y, int Tn, int M, int Cin, int Cout, int kt, int R) {
  __shared__ float4 ws[NARROW_KT * NARROW_MAX_COUT];  // [tap][output]: 4 channels
  __shared__ float bs[NARROW_MAX_COUT];
  for (int i = threadIdx.x; i < kt * Cout; i += blockDim.x) {
    float v[NARROW_CK];
#pragma unroll
    for (int k = 0; k < NARROW_CK; ++k) v[k] = k < Cin ? __bfloat162float(w[(size_t)i * Cin + k]) : 0.f;
    ws[i] = make_float4(v[0], v[1], v[2], v[3]);
  }
  for (int n = threadIdx.x; n < Cout; n += blockDim.x) bs[n] = bias != nullptr ? __bfloat162float(bias[n]) : 0.f;
  __syncthreads();
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  const int t = (r / M) % Tn;
  float v[NARROW_KT][NARROW_CK];
#pragma unroll
  for (int j = 0; j < NARROW_KT; ++j) {
    const int ts = t + j - kt / 2;
    const bool ok = j < kt && ts >= 0 && ts < Tn;
    const __nv_bfloat16* xr = x + (size_t)(r + (j - kt / 2) * M) * Cin;
#pragma unroll
    for (int k = 0; k < NARROW_CK; ++k) v[j][k] = ok && k < Cin ? __bfloat162float(xr[k]) : 0.f;
  }
  __nv_bfloat16* yr = y + (size_t)r * Cout;
  for (int n = 0; n < Cout; ++n) {
    float acc = 0.f;
#pragma unroll
    for (int j = 0; j < NARROW_KT; ++j) {
      if (j < kt) {
        const float4 wv = ws[j * Cout + n];
        acc = fmaf(v[j][0], wv.x, acc);
        acc = fmaf(v[j][1], wv.y, acc);
        acc = fmaf(v[j][2], wv.z, acc);
        acc = fmaf(v[j][3], wv.w, acc);
      }
    }
    yr[n] = __float2bfloat16(acc + bs[n]);
  }
}

__global__ void __launch_bounds__(256) temporal_conv_narrow_kernel(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w, const __nv_bfloat16* __restrict__ bias,
    __nv_bfloat16* __restrict__ y, int Tn, int M, int Cin, int Cout, int kt, long long R) {
  const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  const long long bt = r / M;
  const int t = (int)(bt % Tn);
  for (int n0 = 0; n0 < Cout; n0 += NARROW_CO) {
    float acc[NARROW_CO];
#pragma unroll
    for (int c = 0; c < NARROW_CO; ++c) acc[c] = 0.f;
    const int nn = min(NARROW_CO, Cout - n0);
    for (int j = 0; j < kt; ++j) {
      const int ts = t + j - kt / 2;
      if (ts < 0 || ts >= Tn) continue;
      const __nv_bfloat16* xr = x + (r + (long long)(j - kt / 2) * M) * Cin;
      const __nv_bfloat16* wj = w + ((long long)j * Cout + n0) * Cin;
      for (int k = 0; k < Cin; ++k) {
        const float xv = __bfloat162float(xr[k]);
#pragma unroll
        for (int c = 0; c < NARROW_CO; ++c)
          if (c < nn) acc[c] = fmaf(xv, __bfloat162float(__ldg(wj + (long long)c * Cin + k)), acc[c]);
      }
    }
    __nv_bfloat16* yr = y + r * Cout + n0;
#pragma unroll
    for (int c = 0; c < NARROW_CO; ++c)
      if (c < nn) yr[c] = __float2bfloat16(acc[c] + (bias != nullptr ? __bfloat162float(bias[n0 + c]) : 0.f));
  }
}

// The row source of the fp32 FMA tile: row g of [B*T*M] at tap j reads the same
// token of frame t + j - kt/2, or nothing off the range.
struct FrameRows {
  const float* x;
  int Tn, M, Cin, kt;
  struct Slot {
    long long g;  // flat row, or -1 off the range
    int t;
  };
  __device__ __forceinline__ Slot slot(long long g, long long R) const {
    if (g >= R) return Slot{-1, 0};
    return Slot{g, (int)((g / M) % Tn)};
  }
  __device__ __forceinline__ const float* ptr(const Slot& s, int tap) const {
    const int ts = s.t + tap - kt / 2;
    if (s.g < 0 || ts < 0 || ts >= Tn) return nullptr;
    return x + (s.g + (long long)(tap - kt / 2) * M) * Cin;
  }
};

__global__ void __launch_bounds__(256) temporal_conv_fma_kernel(
    const float* __restrict__ x, const float* __restrict__ w, const float* __restrict__ bias,
    float* __restrict__ y, int Tn, int M, int Cin, int Cout, int kt, long long R, int ncol) {
  const long long row0 = (long long)(blockIdx.x / ncol) * GT_BM;
  const int col0 = (blockIdx.x % ncol) * GT_FBN;
  gemm_nk_fma_tile(FrameRows{x, Tn, M, Cin, kt}, w, bias, y, kt, Cin, Cout, R, row0, col0);
}

// columns computed for nothing when n columns are cut into tiles of bn
inline int tile_waste(long long n, int bn) { return (int)((n + bn - 1) / bn * bn - n); }

// The walk of a bm x bn tiling: per frame when that wastes under 2 % of the rows.
inline TconvWalk tconv_walk(int B, int Tn, int M, int Cin, int Cout, int kt, int bm, int bn, long long* tiles) {
  TconvWalk wk{};
  wk.M = M;
  wk.TM = Tn * M;
  wk.kt = kt;
  const bool per_frame = 50LL * tile_waste(M, bm) < M;
  wk.S = per_frame ? M : wk.TM;
  wk.nseg = per_frame ? Tn : 1;
  wk.nblk = (wk.S + bm - 1) / bm;
  wk.ncol = (Cout + bn - 1) / bn;
  wk.nk = (Cin + WT_BK - 1) / WT_BK;
  wk.bm = bm;
  wk.bn = bn;
  *tiles = (long long)B * wk.nseg * wk.nblk * wk.ncol;
  return wk;
}

template <class C>
int launch_temporal_conv_wgmma_cfg(const void* x, const void* w, const void* bias, void* y, int B, int Tn, int M,
                                   int Cin, int Cout, int kt, int sms, cudaStream_t stream) {
  // more than 48 KB of shared memory is opted into once per process
  static const cudaError_t attr = cudaFuncSetAttribute(
      temporal_conv_wgmma_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM_BYTES);
  if (attr != cudaSuccess) return (int)attr;
  long long tiles;
  const TconvWalk walk = tconv_walk(B, Tn, M, Cin, Cout, kt, C::BM, C::BN, &tiles);
  if (tiles > 0x7fffffffLL) return kErrBadArgument;
  CUtensorMap xmap, wmap;
  const cuuint64_t dims[3] = {(cuuint64_t)Cin, (cuuint64_t)walk.TM, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)Cin * 2, (cuuint64_t)walk.TM * Cin * 2};
  const cuuint32_t box[3] = {WT_BK, C::BM, 1};
  if (const int rc = wgmma_tiled_map(x, 3, dims, strides, box, &xmap)) return rc;
  if (const int rc = wgmma_weight_map(w, kt, Cout, Cin, C::BN, &wmap)) return rc;
  const unsigned blocks = tiles < sms ? (unsigned)tiles : (unsigned)sms;  // persistent: one block per SM
  temporal_conv_wgmma_kernel<C><<<blocks, C::THREADS, C::SMEM_BYTES, stream>>>(
      xmap, wmap, static_cast<const __nv_bfloat16*>(bias), static_cast<__nv_bfloat16*>(y), walk, Cout, (int)tiles);
  return (int)cudaGetLastError();
}

template <int BN, int STAGES192, int STAGES128>
int launch_temporal_conv_wgmma_bn(const void* x, const void* w, const void* bias, void* y, int B, int Tn, int M,
                                  int Cin, int Cout, int kt, int sms, cudaStream_t stream) {
  long long t192, t128;
  tconv_walk(B, Tn, M, Cin, Cout, kt, 192, BN, &t192);
  tconv_walk(B, Tn, M, Cin, Cout, kt, 128, BN, &t128);
  if (persistent_rows_per_sm(t192, 192, sms) <= persistent_rows_per_sm(t128, 128, sms))
    return launch_temporal_conv_wgmma_cfg<PersistentTile<3, BN, STAGES192>>(x, w, bias, y, B, Tn, M, Cin, Cout, kt,
                                                                             sms, stream);
  return launch_temporal_conv_wgmma_cfg<PersistentTile<2, BN, STAGES128>>(x, w, bias, y, B, Tn, M, Cin, Cout, kt,
                                                                          sms, stream);
}

int launch_temporal_conv_wgmma(const void* x, const void* w, const void* bias, void* y, int B, int Tn, int M,
                               int Cin, int Cout, int kt, cudaStream_t stream) {
  int sms = 0;
  if (const int rc = device_sms(&sms)) return rc;
  if ((long long)Tn * M > 0x7fffffffLL) return kErrBadArgument;
  if (tile_waste(Cout, 160) <= tile_waste(Cout, 128))
    return launch_temporal_conv_wgmma_bn<160, 3, 4>(x, w, bias, y, B, Tn, M, Cin, Cout, kt, sms, stream);
  return launch_temporal_conv_wgmma_bn<128, 4, 5>(x, w, bias, y, B, Tn, M, Cin, Cout, kt, sms, stream);
}

}  // namespace vs

// x [B, T, M, Cin], w [kt, Cout, Cin], bias [Cout] or NULL, y [B, T, M, Cout];
// all contiguous, one dtype. route (or NULL) receives the kernel that ran: 2
// the wgmma kernel, 3 the narrow CUDA-core kernel, 0 the fp32 FMA tile.
extern "C" int vs_temporal_conv_1x1(int dtype, const void* x, const void* w, const void* bias, void* y, int B,
                                    int Tn, int M, int Cin, int Cout, int kt, int* route, void* stream) {
  if (B <= 0 || Tn <= 0 || M <= 0 || Cin <= 0 || Cout <= 0 || kt <= 0 || kt % 2 == 0)
    return vs::kErrBadArgument;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long R = (long long)B * Tn * M;
  int r = -1, rc = vs::kErrUnsupported;
  if (dtype == vs::kBFloat16) {
    if (Cout % 8 == 0 && vs::gemm_vec_ok(x, w, Cin)) {
      r = 2;
      rc = vs::launch_temporal_conv_wgmma(x, w, bias, y, B, Tn, M, Cin, Cout, kt, s);
    } else {
      r = 3;
      const long long blocks = (R + 255) / 256;
      if (blocks > 0x7fffffffLL) return vs::kErrBadArgument;
      const auto* xb = static_cast<const __nv_bfloat16*>(x);
      const auto* wb = static_cast<const __nv_bfloat16*>(w);
      const auto* bb = static_cast<const __nv_bfloat16*>(bias);
      auto* yb = static_cast<__nv_bfloat16*>(y);
      if (kt <= vs::NARROW_KT && Cin <= vs::NARROW_CK && Cout <= vs::NARROW_MAX_COUT && R <= 0x7fffffffLL)
        vs::temporal_conv_narrow_small_kernel<<<(unsigned)blocks, 256, 0, s>>>(xb, wb, bb, yb, Tn, M, Cin, Cout, kt,
                                                                               (int)R);
      else
        vs::temporal_conv_narrow_kernel<<<(unsigned)blocks, 256, 0, s>>>(xb, wb, bb, yb, Tn, M, Cin, Cout, kt, R);
      rc = (int)cudaGetLastError();
    }
  } else if (dtype == vs::kFloat32) {
    unsigned blocks;
    int ncol;
    if (!vs::gemm_grid(R, Cout, vs::GT_FBN, &blocks, &ncol)) return vs::kErrBadArgument;
    r = 0;
    vs::temporal_conv_fma_kernel<<<blocks, 256, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w), static_cast<const float*>(bias),
        static_cast<float*>(y), Tn, M, Cin, Cout, kt, R, ncol);
    rc = (int)cudaGetLastError();
  }
  if (route != nullptr) *route = r;
  return rc;
}
