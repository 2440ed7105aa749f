// K4 temporal_conv_1x1: the (kt, 1, 1) video convolution
//     y[b, t] = sum_j x[b, t + j - kt/2] @ W[j] + bias   (zero frames off range)
// on x [B, T, M, Cin], W [kt, Cin, Cout], bias [Cout] -> y [B, T, M, Cout].
//
// Replaces (TPU): vidseg_diffusion_tpu/ops/temporal_conv.py:_kernel (via
// _temporal_conv_impl). On the GPU it runs at every (kt,1,1) site: all UNet
// time_stack widths (320, 640, 1280), the VAE decoder time_stack and the
// VAE's conv_out_time_mix (C = 3) — the TPU's C <= 640 dispatch rule does
// not carry over.
//
// What bounds it on the H100: it is one GEMM with M = B*T*tokens rows
// (tens of thousands to millions), K = kt*Cin and N = Cout, i.e. ~2*M*K*N
// flops against ~(M*Cin + M*Cout) elements: bound by arithmetic at the UNet
// widths, close to memory at the VAE's 128 channels. Design: a 128x128
// output tile per 256-thread block, K staged through shared memory in
// slices. The kt taps are the outer K loop: for tap j each row reads the
// frame t + j - kt/2 of its own video, or zeros when that frame is off the
// range, so T = 1 keeps only the centre tap and frames never mix across
// videos. Accumulation is fp32; bias add and the cast to the output dtype
// are fused into the store. bf16 runs on the tensor cores (mma.sync,
// temporal_conv_mma_kernel below); fp32 on fp32 FMAs (temporal_conv_kernel:
// an 8x8 register micro-tile per thread, rows and columns strided by 16 so
// shared-memory reads are conflict-free). wgmma with TMA is next.
#include "common.cuh"

namespace vs {

constexpr int TC_BM = 128;
constexpr int TC_BN = 128;
constexpr int TC_BK = 16;

template <typename T>
__global__ void __launch_bounds__(256) temporal_conv_kernel(
    const T* __restrict__ x, const T* __restrict__ w, const T* __restrict__ bias,
    T* __restrict__ y, int Tn, int M, int Cin, int Cout, int kt, long long R) {
  __shared__ float As[TC_BK][TC_BM + 4];  // [k][row]
  __shared__ float Bs[TC_BK][TC_BN + 4];  // [k][col]

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const long long row0 = (long long)blockIdx.x * TC_BM;
  const int col0 = blockIdx.y * TC_BN;
  const int pad = kt / 2;

  // this thread's A-tile load slot: one row, 8 consecutive k
  const int ar = tid >> 1;
  const int ak = (tid & 1) * 8;
  const long long grow = row0 + ar;
  const bool rvalid = grow < R;
  long long vid = 0;
  int tt = 0, mm = 0;
  if (rvalid) {
    mm = (int)(grow % M);
    const long long bt = grow / M;
    tt = (int)(bt % Tn);
    vid = bt / Tn;
  }
  // B-tile load slot: one k row, 8 consecutive columns
  const int bk = tid >> 4;
  const int bc = (tid & 15) * 8;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int j = 0; j < kt; ++j) {
    const int ts = tt + j - pad;
    const bool av = rvalid && ts >= 0 && ts < Tn;
    const T* arow = x + ((vid * Tn + (av ? ts : 0)) * M + mm) * (long long)Cin;
    const T* wj = w + (long long)j * Cin * Cout;
    for (int k0 = 0; k0 < Cin; k0 += TC_BK) {
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int kk = k0 + ak + u;
        As[ak + u][ar] = (av && kk < Cin) ? to_f<T>(arow[kk]) : 0.f;
      }
      const int kr = k0 + bk;
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int c = col0 + bc + u;
        Bs[bk][bc + u] = (kr < Cin && c < Cout) ? to_f<T>(wj[(long long)kr * Cout + c]) : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < TC_BK; ++kk) {
        float a[8], bv[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
        for (int c = 0; c < 8; ++c) bv[c] = Bs[kk][tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int c = 0; c < 8; ++c) acc[i][c] = fmaf(a[i], bv[c], acc[i][c]);
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long long r = row0 + ty + 16 * i;
    if (r >= R) continue;
    T* yrow = y + r * Cout;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int col = col0 + tx + 16 * c;
      if (col < Cout) yrow[col] = from_f<T>(acc[i][c] + to_f<T>(bias[col]));
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores: the same GEMM with mma.sync.m16n8k16 (bf16 in,
// fp32 accumulate). A 128x128 output tile per block of 8 warps, each warp a
// 64x32 sub-tile (4x4 m16n8 accumulators). K is walked in 32-deep slices per
// tap: the A slice (128 rows x 32 channels of each row's shifted frame, zeros
// off the range) and the W slice (32 x 128) are staged in shared memory with
// 16-byte rows of padding, A fragments are read straight from it and W's B
// fragments with ldmatrix.trans (both hit 32 distinct banks). VEC: Cin and
// Cout are multiples of 8, so global loads are 16-byte vectors; otherwise
// (the VAE's 3-channel conv_out_time_mix) element loads with bounds checks.

__device__ __forceinline__ void tc_mma_bf16_16816(float c[4], const uint32_t a[4], uint32_t b0,
                                                  uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void tc_ldmatrix_x4_trans(uint32_t r[4], const void* smem_ptr) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(smem_ptr));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

constexpr int MM_BK = 32;
constexpr int MM_AP = MM_BK + 8;   // padded A row (elements)
constexpr int MM_BP = TC_BN + 8;   // padded W row (elements)

template <bool VEC>
__global__ void __launch_bounds__(256) temporal_conv_mma_kernel(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
    const __nv_bfloat16* __restrict__ bias, __nv_bfloat16* __restrict__ y, int Tn, int M,
    int Cin, int Cout, int kt, long long R) {
  __shared__ __align__(16) __nv_bfloat16 As[TC_BM * MM_AP];
  __shared__ __align__(16) __nv_bfloat16 Bs[MM_BK * MM_BP];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;  // 2 x 4 warps: 64-row x 32-col sub-tiles
  const long long row0 = (long long)blockIdx.x * TC_BM;
  const int col0 = blockIdx.y * TC_BN;
  const int pad = kt / 2;

  // A staging: VEC -> two (row, 8-channel vector) slots per thread; scalar
  // -> the 16 channels [ (tid & 1) * 16, +16 ) of row tid >> 1
  constexpr int AROWS = VEC ? 2 : 1;
  long long arow_base[AROWS];  // flat row (vid * Tn) * M + mm of each staged row, or -1
  int arow_t[AROWS], arow_r[AROWS];
#pragma unroll
  for (int i = 0; i < AROWS; ++i) {
    const int r = VEC ? (tid >> 2) + 64 * i : (tid >> 1);
    const long long g = row0 + r;
    arow_r[i] = r;
    arow_t[i] = 0;
    arow_base[i] = -1;
    if (g < R) {
      const int mm = (int)(g % M);
      const long long bt = g / M;
      arow_t[i] = (int)(bt % Tn);
      arow_base[i] = (bt / Tn) * Tn * (long long)M + mm;
    }
  }

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  for (int j = 0; j < kt; ++j) {
    const __nv_bfloat16* wj = w + (long long)j * Cin * Cout;
    const __nv_bfloat16* asrc[AROWS];
#pragma unroll
    for (int i = 0; i < AROWS; ++i) {
      const int ts = arow_t[i] + j - pad;
      asrc[i] = (arow_base[i] >= 0 && ts >= 0 && ts < Tn)
                    ? x + (arow_base[i] + (long long)(ts) * M) * Cin
                    : nullptr;
    }
    for (int k0 = 0; k0 < Cin; k0 += MM_BK) {
      if (VEC) {
#pragma unroll
        for (int i = 0; i < AROWS; ++i) {
          const int c = (tid & 3) * 8;
          uint4 val = make_uint4(0, 0, 0, 0);
          if (asrc[i] != nullptr && k0 + c < Cin)
            val = *reinterpret_cast<const uint4*>(asrc[i] + k0 + c);
          *reinterpret_cast<uint4*>(&As[arow_r[i] * MM_AP + c]) = val;
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int e = tid + 256 * i;
          const int kr = e >> 4, c = (e & 15) * 8;
          uint4 val = make_uint4(0, 0, 0, 0);
          if (k0 + kr < Cin && col0 + c < Cout)
            val = *reinterpret_cast<const uint4*>(wj + (long long)(k0 + kr) * Cout + col0 + c);
          *reinterpret_cast<uint4*>(&Bs[kr * MM_BP + c]) = val;
        }
      } else {
        const int c0 = (tid & 1) * 16;
#pragma unroll
        for (int u = 0; u < 16; ++u) {
          const int kk = k0 + c0 + u;
          As[arow_r[0] * MM_AP + c0 + u] =
              (asrc[0] != nullptr && kk < Cin) ? asrc[0][kk] : __float2bfloat16(0.f);
        }
        const int kr = tid >> 3, cb = (tid & 7) * 16;
#pragma unroll
        for (int u = 0; u < 16; ++u) {
          const int c = col0 + cb + u;
          Bs[kr * MM_BP + cb + u] = (k0 + kr < Cin && c < Cout)
                                        ? wj[(long long)(k0 + kr) * Cout + c]
                                        : __float2bfloat16(0.f);
        }
      }
      __syncthreads();
#pragma unroll
      for (int ks = 0; ks < MM_BK / 16; ++ks) {
        uint32_t af[4][4];
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
          const __nv_bfloat16* a = &As[(wm * 64 + mt * 16 + gid) * MM_AP + ks * 16 + tig * 2];
          af[mt][0] = *reinterpret_cast<const uint32_t*>(a);
          af[mt][1] = *reinterpret_cast<const uint32_t*>(a + 8 * MM_AP);
          af[mt][2] = *reinterpret_cast<const uint32_t*>(a + 8);
          af[mt][3] = *reinterpret_cast<const uint32_t*>(a + 8 * MM_AP + 8);
        }
        // ldmatrix x4: lanes 8i..8i+7 address k rows ks*16 + (i&1)*8 + (lane&7)
        // at columns of n-tile 2p + (i>>1)
        const int krow = ks * 16 + ((lane >> 3) & 1) * 8 + (lane & 7);
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          uint32_t bf[4];
          tc_ldmatrix_x4_trans(bf, &Bs[krow * MM_BP + wn * 32 + (2 * p + (lane >> 4)) * 8]);
#pragma unroll
          for (int mt = 0; mt < 4; ++mt) {
            tc_mma_bf16_16816(acc[mt][2 * p], af[mt], bf[0], bf[1]);
            tc_mma_bf16_16816(acc[mt][2 * p + 1], af[mt], bf[2], bf[3]);
          }
        }
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const long long r = row0 + wm * 64 + mt * 16 + gid + 8 * half;
      if (r >= R) continue;
      __nv_bfloat16* yrow = y + r * Cout;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int col = col0 + wn * 32 + nt * 8 + tig * 2;
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          if (col + u < Cout)
            yrow[col + u] =
                __float2bfloat16(acc[mt][nt][2 * half + u] + __bfloat162float(bias[col + u]));
        }
      }
    }
  }
}

template <typename T>
int launch_temporal_conv(const void* x, const void* w, const void* bias, void* y, int B,
                         int Tn, int M, int Cin, int Cout, int kt, cudaStream_t stream) {
  const long long R = (long long)B * Tn * M;
  const long long gx = (R + TC_BM - 1) / TC_BM;
  const int gy = (Cout + TC_BN - 1) / TC_BN;
  if (gx > 0x7fffffffLL || gy > 65535) return kErrBadArgument;
  dim3 grid((unsigned)gx, gy);
  temporal_conv_kernel<T><<<grid, 256, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const T*>(bias),
      static_cast<T*>(y), Tn, M, Cin, Cout, kt, R);
  return (int)cudaGetLastError();
}

int launch_temporal_conv_mma(const void* x, const void* w, const void* bias, void* y, int B,
                             int Tn, int M, int Cin, int Cout, int kt, cudaStream_t stream) {
  const long long R = (long long)B * Tn * M;
  const long long gx = (R + TC_BM - 1) / TC_BM;
  const int gy = (Cout + TC_BN - 1) / TC_BN;
  if (gx > 0x7fffffffLL || gy > 65535) return kErrBadArgument;
  dim3 grid((unsigned)gx, gy);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* wb = static_cast<const __nv_bfloat16*>(w);
  const auto* bb = static_cast<const __nv_bfloat16*>(bias);
  auto* yb = static_cast<__nv_bfloat16*>(y);
  const bool vec = Cin % 8 == 0 && Cout % 8 == 0 &&
                   (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w)) % 16 == 0;
  if (vec)
    temporal_conv_mma_kernel<true><<<grid, 256, 0, stream>>>(xb, wb, bb, yb, Tn, M, Cin, Cout, kt, R);
  else
    temporal_conv_mma_kernel<false><<<grid, 256, 0, stream>>>(xb, wb, bb, yb, Tn, M, Cin, Cout, kt, R);
  return (int)cudaGetLastError();
}

}  // namespace vs

// x [B, T, M, Cin], w [kt, Cin, Cout], bias [Cout], y [B, T, M, Cout]; all
// contiguous, one dtype.
extern "C" int vs_temporal_conv_1x1(int dtype, const void* x, const void* w, const void* bias,
                                    void* y, int B, int Tn, int M, int Cin, int Cout, int kt,
                                    void* stream) {
  if (B <= 0 || Tn <= 0 || M <= 0 || Cin <= 0 || Cout <= 0 || kt <= 0 || kt % 2 == 0)
    return vs::kErrBadArgument;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == vs::kBFloat16)
    return vs::launch_temporal_conv_mma(x, w, bias, y, B, Tn, M, Cin, Cout, kt, s);
  if (dtype == vs::kFloat32)
    return vs::launch_temporal_conv<float>(x, w, bias, y, B, Tn, M, Cin, Cout, kt, s);
  return vs::kErrUnsupported;
}
