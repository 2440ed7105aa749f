// Shared pieces of the GroupNorm kernels (group_norm.cu forward, K7 + K8;
// group_norm_bwd.cu backward: the slab kernel, K9 + K10).
//
// The activation is channels-last and contiguous, [B, R, C] with R every
// non-batch, non-channel position. The four streaming kernels walk it the same way: a
// block owns one batch item, one tile of up to kTileVecs channel vectors and
// one chunk of rows; thread (ty, tx) keeps channel vector tx of the tile and
// visits rows ty, ty + rows_per_pass, ... of the chunk. A vector is VEC
// consecutive channels (16 bytes when C allows it, else one element), so the
// threads of a warp read consecutive addresses and a thread's per-channel
// coefficients or sums stay in registers for the whole chunk.
//
// K9 writes one partial sum per (batch, chunk, channel) and K7 per-group
// partials; the last block of each batch item to arrive adds them
// (group_norm_bwd.cu, group_norm.cu). No float atomics, so the result is the
// same from run to run, and the chunking makes the fp32 summation a tree
// (thread, block, chunk slices) instead of one long chain.
#pragma once

#include "common.cuh"

namespace vs {

constexpr int kGnThreads = 256;   // threads per block of the streaming kernels
constexpr int kTileVecs = 256;    // channel vectors per column tile
constexpr int kMaxGroups = 1024;     // it keeps two floats per group in shared memory

// VEC elements of T as one aligned load / store (16 bytes for the wide forms).
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* p, float (&out)[VEC]) {
  const Pack<T, VEC> raw = *reinterpret_cast<const Pack<T, VEC>*>(p);
#pragma unroll
  for (int i = 0; i < VEC; ++i) out[i] = to_f<T>(raw.v[i]);
}

template <typename T, int VEC>
__device__ __forceinline__ void store_vec(T* p, const float (&in)[VEC]) {
  Pack<T, VEC> raw;
#pragma unroll
  for (int i = 0; i < VEC; ++i) raw.v[i] = from_f<T>(in[i]);
  *reinterpret_cast<Pack<T, VEC>*>(p) = raw;
}

// Where this thread works. `active` is false for the threads left over when
// the tile width does not divide the block.
struct GnTile {
  int col;            // first channel of this thread's vector
  int row0, row_end;  // this thread's first row and the chunk's end
  int row_step;       // rows per pass of the block
  int ty, tx, width;  // position in the (rows_per_pass x width) thread grid
  bool active;
};

// grid = (chunks, column tiles, B)
template <int VEC>
__device__ __forceinline__ GnTile gn_tile(int R, int C, int rows_per_chunk) {
  GnTile t;
  const int cv = C / VEC;
  const int v0 = blockIdx.y * kTileVecs;
  t.width = min(kTileVecs, cv - v0);
  t.row_step = kGnThreads / t.width;
  t.ty = threadIdx.x / t.width;
  t.tx = threadIdx.x % t.width;
  t.active = t.ty < t.row_step;
  t.col = (v0 + t.tx) * VEC;
  const int chunk0 = blockIdx.x * rows_per_chunk;
  t.row0 = chunk0 + t.ty;
  t.row_end = min(R, chunk0 + rows_per_chunk);
  return t;
}

// Block-level sum of each thread's 2 * VEC accumulators over the ty axis, in
// the fixed order ty = 0, 1, ...; thread (0, tx) writes the tile's partial
// sums to partial[b][chunk][which][C] (which = 0 first sums, 1 second sums).
template <int VEC>
__device__ __forceinline__ void gn_write_partial(const GnTile& t, const float (&s0)[VEC],
                                                 const float (&s1)[VEC], float* partial,
                                                 int C) {
  __shared__ float red[kGnThreads * 2 * VEC];
  if (t.active) {
    float* mine = red + (size_t)(t.ty * t.width + t.tx) * 2 * VEC;
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      mine[i] = s0[i];
      mine[VEC + i] = s1[i];
    }
  }
  __syncthreads();
  if (t.active && t.ty == 0) {
    float a0[VEC], a1[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) a0[i] = a1[i] = 0.f;
    for (int y = 0; y < t.row_step; ++y) {
      const float* src = red + (size_t)(y * t.width + t.tx) * 2 * VEC;
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        a0[i] += src[i];
        a1[i] += src[VEC + i];
      }
    }
    float* out = partial + ((size_t)blockIdx.z * gridDim.x + blockIdx.x) * 2 * C + t.col;
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      out[i] = a0[i];
      out[C + i] = a1[i];
    }
  }
}

// Affine parameters may be stored in fp32 or in bf16, whatever the activation.
__device__ __forceinline__ float load_param(const void* p, int i, int dtype) {
  return dtype == kBFloat16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
                            : static_cast<const float*>(p)[i];
}

__device__ __forceinline__ float sigmoidf(float z) { return 1.f / (1.f + expf(-z)); }

inline bool gn_args_ok(int B, int R, int C, int vec, int rows_per_chunk, int nchunks) {
  if (B <= 0 || R <= 0 || C <= 0 || rows_per_chunk <= 0 || nchunks <= 0) return false;
  if (vec <= 0 || C % vec) return false;
  if ((long long)rows_per_chunk * nchunks < R) return false;
  if (B > 65535) return false;
  return true;
}

inline dim3 gn_grid(int B, int C, int vec, int nchunks) {
  const int cv = C / vec;
  return dim3((unsigned)nchunks, (unsigned)((cv + kTileVecs - 1) / kTileVecs), (unsigned)B);
}

}  // namespace vs
