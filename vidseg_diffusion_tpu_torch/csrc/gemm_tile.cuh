// Tile code shared by the GEMM-shaped kernels: K4 (temporal_conv.cu) takes the
// tensor-core helpers; K11 (matmul_bias.cu) takes the whole tile, and so does
// K12 (conv3x3.cu) for fp32 and for the bf16 shapes its wgmma tile
// (wgmma_tile.cuh) does not take, since both are the same product
//
//     y[r, n] = sum over taps j, channels k of A_j[r, k] * W[j, n, k]  (+ bias[n])
//
// with W stored [taps, N, K] (nn.Linear's [N, K] is the one-tap case; it is the
// column-major [K, N] operand mma.sync.row.col wants, read in place) and A_j[r]
// the K contiguous channels a row source hands out for (row, tap), or zeros
// when it hands out nullptr. A row source is a small struct:
//
//     Slot slot(long long g, long long R) const;        // decode row g once
//     const T* ptr(const Slot&, int tap) const;          // its channels, or nullptr
//
// Only __device__ functions live here: each source file has its own __global__
// kernels (a __global__ defined in a header is linked once per source).
//
// gemm_nk_mma_tile (bf16): a 128 x (32*NT) output tile per block of 8 warps,
// 2 x 4 warps each owning 64 rows x 8*NT columns as 4 x NT m16n8 accumulators
// in fp32. NT = 4 gives the 128-wide tile, NT = 2 a 64-wide one for widths like
// 320 that 128 does not divide (three 128-wide tiles would compute 1.2x the
// products). K is walked in 32-deep slices per tap. VEC (K % 8 == 0, 16-byte
// aligned bases): 16-byte global loads, the next slice fetched into registers
// while the tensor cores work on the current one; otherwise element loads with
// bounds checks. Both operands sit in shared memory as [row][k] with 16 bytes of
// padding per row, so every fragment is a conflict-free 32-bit load.
//
// gemm_nk_fma_tile (fp32): 128 x 128 tile, 16-deep slices, an 8 x 8 register
// micro-tile per thread on fp32 FMAs, for the fp32 card-vs-CPU checks.
#pragma once

#include "common.cuh"

namespace vs {

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

constexpr int GT_BM = 128;          // rows per block
constexpr int GT_BK = 32;           // k-slice of the bf16 tile
constexpr int GT_P = GT_BK + 8;     // padded shared-memory row (elements)
constexpr int GT_FBN = 128;         // fp32 tile width
constexpr int GT_FBK = 16;          // fp32 k-slice

// The one-tap row source of a plain matrix x [R, K].
template <typename T>
struct DenseRows {
  const T* x;
  int K;
  struct Slot {
    long long g;
  };
  __device__ __forceinline__ Slot slot(long long g, long long R) const {
    return Slot{g < R ? g : -1};
  }
  __device__ __forceinline__ const T* ptr(const Slot& s, int) const {
    return s.g < 0 ? nullptr : x + s.g * K;
  }
};

template <int NT, bool VEC, class RowSrc>
__device__ __forceinline__ void gemm_nk_mma_tile(const RowSrc& src, const __nv_bfloat16* __restrict__ w,
                                                 const __nv_bfloat16* __restrict__ bias,
                                                 __nv_bfloat16* __restrict__ y, int taps, int K, int N,
                                                 long long R, long long row0, int col0) {
  constexpr int BN = 32 * NT;
  __shared__ __align__(16) __nv_bfloat16 As[GT_BM * GT_P];
  __shared__ __align__(16) __nv_bfloat16 Bs[BN * GT_P];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;
  const int ksl = (K + GT_BK - 1) / GT_BK;
  const int nsl = taps * ksl;

  float acc[4][NT][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  auto compute = [&]() {
#pragma unroll
    for (int ks = 0; ks < GT_BK / 16; ++ks) {
      uint32_t af[4][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const __nv_bfloat16* a = &As[(wm * 64 + mt * 16 + gid) * GT_P + ks * 16 + tig * 2];
        af[mt][0] = *reinterpret_cast<const uint32_t*>(a);
        af[mt][1] = *reinterpret_cast<const uint32_t*>(a + 8 * GT_P);
        af[mt][2] = *reinterpret_cast<const uint32_t*>(a + 8);
        af[mt][3] = *reinterpret_cast<const uint32_t*>(a + 8 * GT_P + 8);
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const __nv_bfloat16* b = &Bs[(wn * 8 * NT + nt * 8 + gid) * GT_P + ks * 16 + tig * 2];
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(b);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(b + 8);
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) tc_mma_bf16_16816(acc[mt][nt], af[mt], b0, b1);
      }
    }
  };

  if constexpr (VEC) {
    // A: two (row, 8-channel vector) slots per thread; W: NT / 2 slots
    constexpr int NB = NT / 2;
    const int c = (tid & 3) * 8;
    typename RowSrc::Slot aslot[2];
    const __nv_bfloat16* aptr[2] = {nullptr, nullptr};
#pragma unroll
    for (int i = 0; i < 2; ++i) aslot[i] = src.slot(row0 + (tid >> 2) + 64 * i, R);
    uint4 areg[2], breg[NB];

    auto fetch = [&](int s) {
      const int tap = s / ksl, k0 = (s - tap * ksl) * GT_BK;
      if (k0 == 0) {
#pragma unroll
        for (int i = 0; i < 2; ++i) aptr[i] = src.ptr(aslot[i], tap);
      }
      const bool kin = k0 + c < K;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        areg[i] = make_uint4(0, 0, 0, 0);
        if (aptr[i] != nullptr && kin) areg[i] = *reinterpret_cast<const uint4*>(aptr[i] + k0 + c);
      }
#pragma unroll
      for (int i = 0; i < NB; ++i) {
        const int n = col0 + ((tid + 256 * i) >> 2);
        breg[i] = make_uint4(0, 0, 0, 0);
        if (n < N && kin)
          breg[i] = *reinterpret_cast<const uint4*>(w + ((long long)tap * N + n) * K + k0 + c);
      }
    };
    auto stage = [&]() {
#pragma unroll
      for (int i = 0; i < 2; ++i)
        *reinterpret_cast<uint4*>(&As[((tid >> 2) + 64 * i) * GT_P + c]) = areg[i];
#pragma unroll
      for (int i = 0; i < NB; ++i)
        *reinterpret_cast<uint4*>(&Bs[((tid + 256 * i) >> 2) * GT_P + c]) = breg[i];
    };

    fetch(0);
    stage();
    __syncthreads();
    for (int s = 0; s < nsl; ++s) {
      if (s + 1 < nsl) fetch(s + 1);
      compute();
      __syncthreads();
      if (s + 1 < nsl) {
        stage();
        __syncthreads();
      }
    }
  } else {
    const typename RowSrc::Slot aslot = src.slot(row0 + (tid >> 1), R);
    const int c0 = (tid & 1) * 16;
    const __nv_bfloat16 zero = __float2bfloat16(0.f);
    for (int tap = 0; tap < taps; ++tap) {
      const __nv_bfloat16* ap = src.ptr(aslot, tap);
      const __nv_bfloat16* wt = w + (long long)tap * N * K;
      for (int k0 = 0; k0 < K; k0 += GT_BK) {
#pragma unroll
        for (int u = 0; u < 16; ++u) {
          const int kk = k0 + c0 + u;
          As[(tid >> 1) * GT_P + c0 + u] = (ap != nullptr && kk < K) ? ap[kk] : zero;
        }
        for (int e = tid; e < BN * GT_BK; e += 256) {
          const int nl = e / GT_BK, kl = e - nl * GT_BK;
          const int n = col0 + nl, kk = k0 + kl;
          Bs[nl * GT_P + kl] = (n < N && kk < K) ? wt[(long long)n * K + kk] : zero;
        }
        __syncthreads();
        compute();
        __syncthreads();
      }
    }
  }

  // bias add and the one cast at the store; column pairs as one 4-byte store
  // when the row pitch keeps them aligned
  const bool pair_ok = (N & 1) == 0;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const long long r = row0 + wm * 64 + mt * 16 + gid + 8 * half;
      if (r >= R) continue;
      __nv_bfloat16* yrow = y + r * N;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int col = col0 + wn * 8 * NT + nt * 8 + tig * 2;
        if (col >= N) continue;
        float v0 = acc[mt][nt][2 * half], v1 = acc[mt][nt][2 * half + 1];
        if (bias != nullptr) {
          v0 += __bfloat162float(bias[col]);
          if (col + 1 < N) v1 += __bfloat162float(bias[col + 1]);
        }
        if (pair_ok && col + 1 < N) {
          *reinterpret_cast<__nv_bfloat162*>(yrow + col) = __floats2bfloat162_rn(v0, v1);
        } else {
          yrow[col] = __float2bfloat16(v0);
          if (col + 1 < N) yrow[col + 1] = __float2bfloat16(v1);
        }
      }
    }
  }
}

template <class RowSrc>
__device__ __forceinline__ void gemm_nk_fma_tile(const RowSrc& src, const float* __restrict__ w,
                                                 const float* __restrict__ bias, float* __restrict__ y,
                                                 int taps, int K, int N, long long R, long long row0,
                                                 int col0) {
  __shared__ float As[GT_FBK][GT_BM + 4];    // [k][row]
  __shared__ float Bs[GT_FBK][GT_FBN + 4];   // [k][col]

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  // load slots: one row (A) and one column (W), 8 consecutive k each
  const int lr = tid >> 1, lk = (tid & 1) * 8;
  const typename RowSrc::Slot aslot = src.slot(row0 + lr, R);
  const int wcol = col0 + lr;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int tap = 0; tap < taps; ++tap) {
    const float* ap = src.ptr(aslot, tap);
    const float* wp = wcol < N ? w + ((long long)tap * N + wcol) * K : nullptr;
    for (int k0 = 0; k0 < K; k0 += GT_FBK) {
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int kk = k0 + lk + u;
        As[lk + u][lr] = (ap != nullptr && kk < K) ? ap[kk] : 0.f;
        Bs[lk + u][lr] = (wp != nullptr && kk < K) ? wp[kk] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < GT_FBK; ++kk) {
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
    float* yrow = y + r * N;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int col = col0 + tx + 16 * c;
      if (col < N) yrow[col] = acc[i][c] + (bias != nullptr ? bias[col] : 0.f);
    }
  }
}

// Grid of a tiled launch: column tiles vary fastest, so the blocks that share a
// row tile (and re-read its A rows) run together and find them in L2.
inline bool gemm_grid(long long R, int N, int bn, unsigned* blocks, int* ncol) {
  const long long nrow = (R + GT_BM - 1) / GT_BM;
  *ncol = (N + bn - 1) / bn;
  const long long total = nrow * *ncol;
  if (total <= 0 || total > 0x7fffffffLL) return false;
  *blocks = (unsigned)total;
  return true;
}

// 128-wide tiles when they divide N, else 64-wide ones (N = 320 is 5 of them).
inline bool gemm_wide_tile(int N) { return N % 128 == 0; }

inline bool gemm_vec_ok(const void* x, const void* w, int K) {
  return K % 8 == 0 && (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w)) % 16 == 0;
}

}  // namespace vs
