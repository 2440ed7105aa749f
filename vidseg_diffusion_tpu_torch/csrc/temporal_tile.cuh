// The tile loader and the 16 x 16 tensor-core tile that K2
// (temporal_attention.cu) and its backward K6 (temporal_attention_bwd.cu)
// share in bf16.
//
// Both work on the UNet's direct temporal layout: q, k, v (and o, g, dq, dk,
// dv) are contiguous [(nvid t), S, H * 64], and each (video, token, head) is
// one attention problem over the video's t frames. A problem's t rows lie
// S * H * 128 bytes apart in device memory (3.7 MB at the main path's ds1), so
// a warp that reads them as scalars touches t lines per instruction. Here TMA
// reads them instead: a tensor map views the tensor as (channel, frame, token,
// video) with the tensor's own strides, and one box of 64 channels x FR frames
// x NTOK tokens x 1 video lands as NTOK problems of FR rows of 128 bytes each
// (FR = 16 for t <= 16, 32 for t <= 32). A problem's frame rows are then
// 128 bytes apart in shared memory, so the 128-byte swizzle of the map keeps
// ldmatrix free of bank conflicts (a [token][frame] order would stack them
// NTOK * 128 bytes apart: an 8-way conflict). Frames t..FR-1 and tokens past S
// lie outside the map: TMA writes zeros for them on a load and drops them on a
// store, so neither t < FR nor a ragged S needs a predicate.
//
// A work unit is (video, tile of NTOK consecutive tokens, head); a block walks
// units with a stride of the grid (persistent), one warp per token of the
// unit, and one more warp whose first thread keeps a ring of STAGES stages
// full: it asks TMA for the NIN input boxes of a unit (`full` mbarrier), and
// once the compute warps have handed a stage back (`done` mbarrier) it stores
// the NOUT output boxes that they left in some of its input slots, waits until
// TMA has read them, and loads the next unit there. The next unit's boxes
// thus arrive while this one computes, and the stores leave behind it.
//
// Only __device__ functions and host helpers live here.
#pragma once

#include "wgmma_tile.cuh"

namespace vs {

// ---- mma.sync m16n8k16 (bf16 in, fp32 accumulate) and its operands ---------
//
// Fragments (lane = 4 gid + tig): A (16 x 16, row-major) a[0] = rows gid, cols
// 2 tig..+1; a[1] rows gid + 8; a[2] cols + 8; a[3] both. B (16 x 8) b[0] = rows
// 2 tig..+1 at col gid, b[1] rows + 8. C (16 x 8) c[0..1] = row gid, cols
// 2 tig..+1; c[2..3] row gid + 8. A C tile of 16 columns packed to bf16 pairs is
// the A fragment of the next product (two n-tiles make one k-step).
__device__ __forceinline__ void tt_mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8 x 8 bf16 matrices; lane L gives the address of row L % 8 of matrix L / 8.
__device__ __forceinline__ void tt_ldsm(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}
__device__ __forceinline__ void tt_ldsm_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ uint32_t tt_pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ float tt_lo(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float tt_hi(uint32_t v) { return __uint_as_float(v & 0xffff0000u); }

__device__ __forceinline__ void tt_st32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}
__device__ __forceinline__ uint4 tt_ld128(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}
__device__ __forceinline__ void tt_st128(uint32_t addr, uint4 v) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "r"(v.x), "r"(v.y), "r"(v.z),
               "r"(v.w)
               : "memory");
}

// Operand addresses in a problem's rows (`base`: FR rows of 64 bf16, 128 bytes
// each, 128-byte swizzled, 1024-byte aligned):
// - the A fragment of rows r0..r0+15, channels 16 ks..16 ks + 15 (row-major A);
// - the B fragments of two n-tiles from rows r0..r0+15 read as columns (B = rows^T,
//   channels 16 ks..: the keys of S = Q K^T): b[0..1] n-tile 0, b[2..3] n-tile 1;
// - the B fragments of channel n-tiles 2 np, 2 np + 1 from rows r0..r0+15 read as
//   the contraction (B = rows, through ldmatrix.trans: V of P V).
__device__ __forceinline__ uint32_t tt_a_addr(uint32_t base, int r0, int ks, int lane) {
  return base + sw128(r0 + (lane & 7) + 8 * ((lane >> 3) & 1), 2 * ks + (lane >> 4));
}
__device__ __forceinline__ uint32_t tt_bt_addr(uint32_t base, int r0, int ks, int lane) {
  return base + sw128(r0 + (lane & 7) + 8 * (lane >> 4), 2 * ks + ((lane >> 3) & 1));
}
__device__ __forceinline__ uint32_t tt_b_addr(uint32_t base, int r0, int np, int lane) {
  return base + sw128(r0 + (lane & 7) + 8 * ((lane >> 3) & 1), 2 * np + (lane >> 4));
}

// ---- the walk ------------------------------------------------------------------

template <int NMAPS>
struct DirectMaps {
  CUtensorMap m[NMAPS];  // the NIN inputs, then the NOUT outputs
};

// NIN input and NOUT output tensors, FR frames (16 or 32), NTOK tokens (one
// compute warp each) per unit, STAGES stages, SCRATCH bytes of shared memory per
// compute warp after the ring.
template <int NIN_, int NOUT_, int FR_, int NTOK_, int STAGES_, int SCRATCH_>
struct DirectTile {
  static constexpr int NIN = NIN_, NOUT = NOUT_, FR = FR_, NTOK = NTOK_, STAGES = STAGES_, SCRATCH = SCRATCH_;
  static constexpr int PROBLEM_BYTES = FR * 128;          // one tensor's rows of one problem
  static constexpr int BOX_BYTES = NTOK * PROBLEM_BYTES;  // one tensor's box of one unit
  static constexpr int STAGE_BYTES = NIN * BOX_BYTES;
  static constexpr int BAR_OFFSET = STAGES * STAGE_BYTES;  // STAGES full, then STAGES done barriers
  static constexpr int SCRATCH_OFFSET = BAR_OFFSET + 16 * STAGES;
  static constexpr int THREADS = 32 * (NTOK + 1);          // compute warps, then the producer warp
  static constexpr int SMEM_BYTES = SCRATCH_OFFSET + NTOK * SCRATCH + 1024;
  static_assert(FR == 16 || FR == 32, "frames per problem");
};

// Runs body(slots, scratch, lane) once per problem of every unit of this block:
// slots[i] is the shared address of the problem's rows in input box i; the body
// leaves output j in slot C::out_slot(j) (rows of inputs it no longer reads),
// ordered for TMA by a proxy fence here.
template <class C, class Body>
__device__ __forceinline__ void direct_walk(const DirectMaps<C::NIN + C::NOUT>& maps, int units, int H,
                                            int ntiles, unsigned char* smem_raw, Body body) {
  unsigned char* smem = smem_align_1024(smem_raw);
  const uint32_t sbase = smem_u32(smem);
  const uint32_t full_bar = sbase + C::BAR_OFFSET, done_bar = full_bar + 8 * C::STAGES;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(full_bar + 8 * s, 1);
      mbar_init(done_bar + 8 * s, C::NTOK * 32);
    }
    mbar_init_fence();
  }
  __syncthreads();
  const int stride = gridDim.x;
  auto coords = [&](int u, int& c0, int& tok0, int& b) {
    const int h = u % H, r = u / H;
    c0 = h * 64;
    tok0 = (r % ntiles) * C::NTOK;
    b = r / ntiles;
  };

  if (warp == C::NTOK) {  // the producer
    if (lane != 0) return;
    auto store = [&](int u, int stage) {
      int c0, tok0, b;
      coords(u, c0, tok0, b);
      const uint32_t st = sbase + stage * C::STAGE_BYTES;
#pragma unroll
      for (int j = 0; j < C::NOUT; ++j)
        tma_store_4d(&maps.m[C::NIN + j], st + Body::out_slot(j) * C::BOX_BYTES, c0, 0, tok0, b);
      tma_store_commit();
    };
    int it = 0;
    for (int u = blockIdx.x; u < units; u += stride, ++it) {
      const int stage = it % C::STAGES;
      if (it >= C::STAGES) {  // the unit before in this stage: computed, stored, read
        mbar_wait(done_bar + 8 * stage, ((it / C::STAGES) - 1) & 1);
        store(u - C::STAGES * stride, stage);
        tma_store_wait_read();
      }
      int c0, tok0, b;
      coords(u, c0, tok0, b);
      const uint32_t st = sbase + stage * C::STAGE_BYTES, bar = full_bar + 8 * stage;
      mbar_expect_tx(bar, C::STAGE_BYTES);
#pragma unroll
      for (int i = 0; i < C::NIN; ++i) tma_load_4d(st + i * C::BOX_BYTES, &maps.m[i], bar, c0, 0, tok0, b);
    }
    for (int j = it >= C::STAGES ? it - C::STAGES : 0; j < it; ++j) {  // the last units' stores
      const int stage = j % C::STAGES;
      mbar_wait(done_bar + 8 * stage, (j / C::STAGES) & 1);
      store(blockIdx.x + j * stride, stage);
    }
    tma_store_wait();
    return;
  }

  const uint32_t scratch = sbase + C::SCRATCH_OFFSET + warp * C::SCRATCH;
  int it = 0;
  for (int u = blockIdx.x; u < units; u += stride, ++it) {
    const int stage = it % C::STAGES;
    mbar_wait(full_bar + 8 * stage, (it / C::STAGES) & 1);
    uint32_t slots[C::NIN];
#pragma unroll
    for (int i = 0; i < C::NIN; ++i)
      slots[i] = sbase + stage * C::STAGE_BYTES + i * C::BOX_BYTES + warp * C::PROBLEM_BYTES;
    body(slots, scratch, lane);
    fence_proxy_async();  // the outputs, and every write into the stage, before TMA's next use of it
    mbar_arrive(done_bar + 8 * stage);
  }
}

// Host side. A map over a contiguous direct-layout tensor [(nvid t), S, H * 64]
// bf16 as (channel H * 64, frame t, token S, video nvid), boxes of 64 channels x
// fr frames x ntok tokens x 1 video.
inline int direct_layout_map(const void* x, int nvid, int t, int S, int H, int fr, int ntok, CUtensorMap* map) {
  const unsigned long long row = 128ull * H;  // bytes of one token's channels
  const cuuint64_t dims[4] = {(cuuint64_t)H * 64, (cuuint64_t)t, (cuuint64_t)S, (cuuint64_t)nvid};
  const cuuint64_t strides[3] = {row * S, row, row * S * t};
  const cuuint32_t box[4] = {64, (cuuint32_t)fr, (cuuint32_t)ntok, 1};
  return wgmma_tiled_map(x, 4, dims, strides, box, map);
}

// Launches a direct_walk kernel: maps of the NIN + NOUT tensors (all [(nvid t),
// S, H * 64] bf16, 16-byte aligned), a grid of as many blocks as fit on the card
// at once (at most one per unit); args... follow the maps and the walk's sizes.
template <class C, class... Args>
int launch_direct(void (*kern)(DirectMaps<C::NIN + C::NOUT>, int, int, int, Args...),
                  const void* const* tensors, int nvid, int t, int S, int H, cudaStream_t stream,
                  Args... args) {
  for (int i = 0; i < C::NIN + C::NOUT; ++i)
    if (reinterpret_cast<uintptr_t>(tensors[i]) % 16) return kErrBadArgument;
  static const cudaError_t attr =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM_BYTES);
  if (attr != cudaSuccess) return (int)attr;
  static int per_sm = 0;
  if (per_sm == 0) {
    if (const cudaError_t rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, C::THREADS,
                                                                              C::SMEM_BYTES))
      return (int)rc;
    if (per_sm == 0) return kErrUnsupported;
  }
  int sms = 0;
  if (const int rc = device_sms(&sms)) return rc;
  DirectMaps<C::NIN + C::NOUT> maps;
  for (int i = 0; i < C::NIN + C::NOUT; ++i)
    if (const int rc = direct_layout_map(tensors[i], nvid, t, S, H, C::FR, C::NTOK, &maps.m[i])) return rc;
  const int ntiles = (S + C::NTOK - 1) / C::NTOK;
  const long long units = (long long)nvid * ntiles * H;
  if (units > 0x7fffffffLL) return kErrBadArgument;
  const int grid = (int)(units < (long long)per_sm * sms ? units : (long long)per_sm * sms);
  kern<<<grid, C::THREADS, C::SMEM_BYTES, stream>>>(maps, (int)units, H, ntiles, args...);
  return (int)cudaGetLastError();
}

}  // namespace vs
