// wgmma building blocks and the GEMM loops built on them: K12 (conv3x3.cu)
// takes the one-tile loop (wgmma_nk_tile); K11 (matmul_bias.cu) and K4
// (temporal_conv.cu) the persistent one (wgmma_persistent, at the end); K1 / K3
// (flash_attention.cu) take the primitives. Both loops compute the same
// product as gemm_tile.cuh,
//
//     y[r, n] = sum over taps j, channels k of A_j[r, k] * W[j, n, k]  (+ bias[n])
//
// for bf16 operands that TMA can address (K a multiple of 8, 16-byte aligned
// bases); gemm_tile.cuh keeps the element-load and fp32 tiles. It replaces
// (TPU) the MXU matmul of vidseg_diffusion_tpu/ops/conv3x3.py:_kernel.
//
// What bounds the product on the H100: by its arithmetic the tensor cores
// (thousands of flops per byte of device memory), and only wgmma reaches their
// full rate: the mma.sync tile read 148 TFLOP/s at the UNet's ds1 convolution,
// the card's peak is 989. Once the product runs on wgmma, what holds it is
// filling shared memory: 16-byte cp.async copies landed at about 32 bytes per
// clock and SM whatever the tile, slower still beside the wgmmas' own reads,
// and a block-wide barrier per slice left the tensor cores idle a sixth of the
// time. Design:
// - a BM x BN output tile per block, one consumer warpgroup per 64 rows holding
//   one m64nBNk16 accumulator (BN / 2 fp32 registers a thread). BN = 160
//   divides every ResBlock width of the UNets (320, 640, 1280), so no column
//   is computed for nothing; BM = 192 (three consumer warpgroups and the
//   producers make 512 threads, one block per SM, 128 registers a thread);
// - K walked in 64-channel slices (128-byte shared-memory rows under the
//   128-byte swizzle wgmma's descriptors read), channels outer and taps inner,
//   through a ring of STAGES stages. One more warpgroup holds the producer: per
//   slice its first thread waits for the stage to be empty and asks TMA for two boxes,
//   the A rows (through the caller's loader: for K12 an im2col tensor map, so
//   the hardware walks the pixels, crosses image rows and images, and writes
//   zeros for the halo) and the W rows (a rank-3 map over [taps, N, K]); the
//   boxes land a 128-byte line at a time and report to the stage's `full`
//   mbarrier. Whatever lies outside a tensor arrives as zeros, so the halo and
//   the ragged edges of M, N and K need no predicate;
// - the consumer warpgroups never meet in the main loop: each waits for `full`,
//   issues its four wgmmas, leaves them in flight, and when the slice before
//   has finished arrives on that stage's `empty` mbarrier;
// - bias add in fp32 and one rounding, staged through shared memory so that
//   the stores are 16 bytes a thread along N (element stores when N % 8 != 0).
// Tried and dropped (times in PERF.md): A by 16-byte cp.async copies from all
// threads with one __syncthreads() per slice (1.3 to 1.9 times slower); sharing
// the W tile between the blocks of a cluster by TMA multicast with consumer
// threads doing the cross-block hand-shake (slower still).
//
// Only __device__ functions live here (one __global__ per source file).
#pragma once

#include <cuda.h>

#include "common.cuh"

namespace vs {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Dynamic shared memory is only promised 16-byte alignment; the swizzled
// tiles need 1024. The launch asks for 1024 bytes more than the tiles take.
__device__ __forceinline__ unsigned char* smem_align_1024(unsigned char* p) {
  return p + ((1024u - (smem_u32(p) & 1023u)) & 1023u);
}

// wgmma reads shared memory through the async proxy: writes made by ordinary
// stores are ordered before it by this fence (then a barrier).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving reads of accumulators above the wait that
// makes them valid.
template <int N>
__device__ __forceinline__ void wgmma_fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// mbarrier (one 8-byte word of shared memory) and the TMA load it tracks.
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// Spins until the barrier's phase `parity` has completed; a copy that never
// lands (a wrong byte count) traps instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (int spins = 0; !done; ++spins) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (!done && spins > (1 << 22)) __trap();
  }
}
// One box of a rank-3 tensor map -> shared memory (the map's swizzle applies;
// elements outside the tensor arrive as zeros and count as bytes).
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0,
                                            int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// The same for a rank-2 map.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0,
                                            int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// The same for a rank-4 map.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0,
                                            int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
// One box of shared memory -> a rank-4 map (elements outside the tensor are dropped).
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, uint32_t src, int c0, int c1, int c2,
                                             int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
__device__ __forceinline__ void tma_store_commit() { asm volatile("cp.async.bulk.commit_group;\n" ::: "memory"); }
// The stores this thread committed, all but the last N, have read their shared
// memory (it may be written again).
template <int N = 0>
__device__ __forceinline__ void tma_store_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}
// The stores committed so far are complete.
__device__ __forceinline__ void tma_store_wait() { asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory"); }

// One im2col box of a rank-4 NHWC tensor map: the map's pixelsPerColumn
// pixels, walked along w, then h, then n from the base pixel (w, h, n) inside
// the map's bounding box, each read at (w + off_w, h + off_h), channels c on.
__device__ __forceinline__ void tma_load_im2col_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c,
                                                   int w, int h, int n, int off_w, int off_h) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.im2col.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2], {%7, %8};\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c), "r"(w), "r"(h), "r"(n),
      "h"(static_cast<uint16_t>(off_w)), "h"(static_cast<uint16_t>(off_h))
      : "memory");
}

// A barrier over the first N threads of the block (the consumers), which the
// producers, gone by then, take no part in.
template <int N>
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(N) : "memory");
}

// Named barriers over subsets of the block (id 0 is __syncthreads): bar_sync
// waits until `count` threads have arrived, bar_arrive arrives and goes on.
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// Byte offset of the 16-byte chunk `chunk` (0-7) of row `row` in a tile of
// 128-byte rows under the 128-byte swizzle (tile base 1024-byte aligned).
__device__ __forceinline__ uint32_t sw128(int row, int chunk) {
  return static_cast<uint32_t>(row * 128 + ((chunk ^ (row & 7)) << 4));
}

// Shared-memory matrix descriptor, 128-byte swizzle. K-major operands ([rows][64
// k] tiles): sbo = 1024 (8 rows), lbo unused; 16 k further is + 32 bytes on
// the address. MN-major B (the [k][64 n] panels of a transposed operand): lbo =
// bytes between 64-column panels, sbo = 1024 (8 k rows); 16 k further is + 2048.
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

// D (64 x N fp32, N / 2 registers a thread) (+)= A (64 x 16 bf16) * B (16 x N
// bf16); scale_d = 0 overwrites D. _ss: A and B K-major from shared memory;
// _rs_tb: A from registers (the m16n8k16 A fragment of each warp's 16 rows), B
// MN-major from shared memory.
__device__ __forceinline__ void wgmma_m64n32k16_ss(float (&d)[16], uint64_t desc_a, uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d)
      : "memory");
}

__device__ __forceinline__ void wgmma_m64n160k16_ss(float (&d)[80], uint64_t desc_a, uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %82, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, "
      " %40, %41, %42, %43, %44, %45, %46, %47, "
      " %48, %49, %50, %51, %52, %53, %54, %55, "
      " %56, %57, %58, %59, %60, %61, %62, %63, "
      " %64, %65, %66, %67, %68, %69, %70, %71, "
      " %72, %73, %74, %75, %76, %77, %78, %79}, "
      "%80, %81, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d)
      : "memory");
}

__device__ __forceinline__ void wgmma_m64n256k16_rs_tb(float (&d)[128], const uint32_t (&a)[4], uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, "
      " %40, %41, %42, %43, %44, %45, %46, %47, "
      " %48, %49, %50, %51, %52, %53, %54, %55, "
      " %56, %57, %58, %59, %60, %61, %62, %63, "
      " %64, %65, %66, %67, %68, %69, %70, %71, "
      " %72, %73, %74, %75, %76, %77, %78, %79, "
      " %80, %81, %82, %83, %84, %85, %86, %87, "
      " %88, %89, %90, %91, %92, %93, %94, %95, "
      " %96, %97, %98, %99, %100, %101, %102, %103, "
      " %104, %105, %106, %107, %108, %109, %110, %111, "
      " %112, %113, %114, %115, %116, %117, %118, %119, "
      " %120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d)
      : "memory");
}

__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t desc_a, uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d)
      : "memory");
}

__device__ __forceinline__ void wgmma_m64n80k16_ss(float (&d)[40], uint64_t desc_a, uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %42, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39}, "
      "%40, %41, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d)
      : "memory");
}

__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[64], uint64_t desc_a, uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, "
      " %40, %41, %42, %43, %44, %45, %46, %47, "
      " %48, %49, %50, %51, %52, %53, %54, %55, "
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d)
      : "memory");
}

__device__ __forceinline__ void wgmma_m64n64k16_rs_tb(float (&d)[32], const uint32_t (&a)[4], uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d)
      : "memory");
}

constexpr int WT_BK = 64;  // channels per slice: one 128-byte row

// One m64nBNk16 wgmma, both operands K-major from shared memory, accumulating:
// the tile widths the GEMM loops are built for.
template <int BN>
__device__ __forceinline__ void wgmma_ss(float (&d)[BN / 2], uint64_t desc_a, uint64_t desc_b);
template <>
__device__ __forceinline__ void wgmma_ss<160>(float (&d)[80], uint64_t desc_a, uint64_t desc_b) {
  wgmma_m64n160k16_ss(d, desc_a, desc_b, 1);
}
template <>
__device__ __forceinline__ void wgmma_ss<128>(float (&d)[64], uint64_t desc_a, uint64_t desc_b) {
  wgmma_m64n128k16_ss(d, desc_a, desc_b, 1);
}

// BM rows (64 per consumer warpgroup) x BN columns, a ring of STAGES stages;
// 2 * BM consumer threads and one producer warpgroup. ptxas wants BN / 2 + 26
// registers a thread at the launch bound to place one wgmma, whatever
// setmaxnreg would grant later: 512 threads (BM = 192) get 128, 640 only 96.
template <int BM, int BN, int STAGES>
struct WgmmaTile {
  static constexpr int CONSUMERS = 2 * BM;
  static constexpr int THREADS = CONSUMERS + 128;
  static constexpr int A_BYTES = BM * 128;
  static constexpr int B_BYTES = BN * 128;
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int OUT_PITCH = BN + 8;  // staging row in elements: conflict-free, 16-byte rows
  static constexpr int OUT_BYTES = BM * OUT_PITCH * 2;
  static constexpr int RING_BYTES = STAGES * STAGE_BYTES;
  static constexpr int BAR_OFFSET = RING_BYTES;  // STAGES full and STAGES empty mbarriers after the ring
  static constexpr int BYTES = RING_BYTES + 16 * STAGES + 1024;
  static_assert(BN == 160, "one wgmma shape is built");
  static_assert(BM % 64 == 0 && B_BYTES % 1024 == 0 && STAGES >= 2 && THREADS <= 512, "tile shape");
  static_assert(OUT_BYTES <= RING_BYTES, "the staging tile reuses the ring");
};

// One BM x BN tile of a block of WgmmaTile::THREADS threads. smem: 1024-byte
// aligned, WgmmaTile::BYTES - 1024 bytes. load_a(dst, bar, k0, tap) asks TMA for
// the BM x 64 A box of channels k0.. at tap `tap` (A_BYTES in all, zeros
// included, reported to `bar`); wmap: wgmma_weight_map of W with BN-row boxes.
template <int BM, int BN, int STAGES, class LoadA>
__device__ __forceinline__ void wgmma_nk_tile(const LoadA& load_a, const CUtensorMap* wmap,
                                              const __nv_bfloat16* __restrict__ bias,
                                              __nv_bfloat16* __restrict__ y, int taps, int K, int N,
                                              long long R, long long row0, int col0, unsigned char* smem) {
  using T = WgmmaTile<BM, BN, STAGES>;
  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const uint32_t sbase = smem_u32(smem);
  const uint32_t full_bar = sbase + T::BAR_OFFSET, empty_bar = full_bar + 8 * STAGES;
  const int nsl = taps * ((K + WT_BK - 1) / WT_BK);

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full_bar + 8 * s, 1);
      mbar_init(empty_bar + 8 * s, BM / 64);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (tid >= T::CONSUMERS) {
    // the producer warpgroup: one thread keeps the ring full, then all leave
    if (tid == T::CONSUMERS) {
      int stage = 0, tap = 0, k0 = 0;
      uint32_t parity = 1;  // of the empty barriers: the ring's round before this one
      for (int it = 0; it < nsl; ++it) {
        if (it >= STAGES) mbar_wait(empty_bar + 8 * stage, parity);
        const uint32_t sa = sbase + stage * T::STAGE_BYTES, bar = full_bar + 8 * stage;
        mbar_expect_tx(bar, T::STAGE_BYTES);
        load_a(sa, bar, k0, tap);
        tma_load_3d(sa + T::A_BYTES, wmap, bar, k0, col0, tap);
        if (++tap == taps) {
          tap = 0;
          k0 += WT_BK;
        }
        if (++stage == STAGES) {
          stage = 0;
          parity ^= 1;
        }
      }
    }
    return;
  }

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  int stage = 0;
  uint32_t parity = 0;  // of the full barriers: the ring's current round
  for (int it = 0; it < nsl; ++it) {
    mbar_wait(full_bar + 8 * stage, parity);
    const uint32_t sa = sbase + stage * T::STAGE_BYTES + wg * 64 * 128;
    const uint32_t sb = sbase + stage * T::STAGE_BYTES + T::A_BYTES;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < WT_BK / 16; ++kk)
      wgmma_m64n160k16_ss(acc, wgmma_desc(sa + kk * 32, 16, 1024), wgmma_desc(sb + kk * 32, 16, 1024), 1);
    wgmma_commit();
    wgmma_wait<1>();  // the slice before is done with its stage: hand it back
    if (it > 0 && (tid & 127) == 0) mbar_arrive(empty_bar + 8 * (stage == 0 ? STAGES - 1 : stage - 1));
    if (++stage == STAGES) {
      stage = 0;
      parity ^= 1;
    }
  }
  wgmma_wait<0>();
  wgmma_fence_regs(acc);
  consumer_sync<T::CONSUMERS>();  // every box has landed and been read: the ring becomes the staging tile

  __nv_bfloat16* outs = reinterpret_cast<__nv_bfloat16*>(smem);
  const int gid = lane >> 2, tig = lane & 3;
  const int r_lo = wg * 64 + warp * 16 + gid;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int c = j * 8 + tig * 2;
    float b0 = 0.f, b1 = 0.f;
    if (bias != nullptr) {
      if (col0 + c < N) b0 = __bfloat162float(bias[col0 + c]);
      if (col0 + c + 1 < N) b1 = __bfloat162float(bias[col0 + c + 1]);
    }
    *reinterpret_cast<__nv_bfloat162*>(&outs[r_lo * T::OUT_PITCH + c]) =
        __floats2bfloat162_rn(acc[4 * j] + b0, acc[4 * j + 1] + b1);
    *reinterpret_cast<__nv_bfloat162*>(&outs[(r_lo + 8) * T::OUT_PITCH + c]) =
        __floats2bfloat162_rn(acc[4 * j + 2] + b0, acc[4 * j + 3] + b1);
  }
  consumer_sync<T::CONSUMERS>();
  if (N % 8 == 0 && reinterpret_cast<uintptr_t>(y) % 16 == 0) {
    constexpr int CH = BN / 8;
    for (int idx = tid; idx < BM * CH; idx += T::CONSUMERS) {
      const int r = idx / CH, c = (idx - r * CH) * 8;
      if (row0 + r < R && col0 + c < N)
        *reinterpret_cast<uint4*>(y + (row0 + r) * N + col0 + c) =
            *reinterpret_cast<const uint4*>(&outs[r * T::OUT_PITCH + c]);
    }
  } else {
    for (int idx = tid; idx < BM * BN; idx += T::CONSUMERS) {
      const int r = idx / BN, c = idx - r * BN;
      if (row0 + r < R && col0 + c < N) y[(row0 + r) * N + col0 + c] = outs[r * T::OUT_PITCH + c];
    }
  }
}

// ---------------------------------------------------------------------------
// The persistent GEMM loop (K11, K4). One block per SM walks the output tiles
// (tile += gridDim.x), so one tile's epilogue and the next one's first loads
// overlap and no block pays a ring prologue per tile:
// - one producer thread (its own warp) asks TMA for the slices of its tiles,
//   tile after tile, through a ring of STAGES stages (A box BM x 64, W box
//   BN x 64, 128-byte swizzle), running ahead into the next tile while the
//   consumers finish the current one. What lies outside a tensor arrives as
//   zeros;
// - consumer warpgroups own 64 rows each (one m64nBNk16 accumulator, BN / 2
//   fp32 registers a thread); per slice four wgmmas from shared memory, the
//   stage handed back once the slice after it is issued;
// - each warpgroup's epilogue is its own: bias add in fp32 and one rounding
//   into a staging tile of its 64 rows (not the ring, which the producer is
//   filling), then 16-byte stores along N (element stores when N % 8 != 0),
//   predicated on the tile's rows and on N; then it goes on to its next tile.
// What a caller supplies is the walk: which rows and columns tile i covers,
// how many 64-channel slices its K loop has, and the two TMA loads of slice s:
//
//     struct Walk {
//       struct Tile { long long out_row0; int rows, col0; ... };  // y rows out_row0.., `rows` of them exist
//       Tile tile(int i) const;
//       int slices(const Tile&) const;
//       void load(uint32_t a, uint32_t b, uint32_t bar, const Tile&, int s) const;  // A_BYTES + B_BYTES to bar
//     };
template <int NWG_, int BN_, int STAGES_>
struct PersistentTile {
  static constexpr int NWG = NWG_, BN = BN_, STAGES = STAGES_;
  static constexpr int BM = 64 * NWG;
  static constexpr int CONSUMERS = 128 * NWG;
  static constexpr int THREADS = CONSUMERS + 32;       // consumer warpgroups, then the producer warp
  static constexpr int A_BYTES = BM * 128, B_BYTES = BN * 128, STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int RING_BYTES = STAGES * STAGE_BYTES;
  static constexpr int OUT_PITCH = BN + 8;             // staging row in elements: conflict-free, 16-byte rows
  static constexpr int OUT_BYTES = BM * OUT_PITCH * 2;
  static constexpr int BAR_OFFSET = RING_BYTES + OUT_BYTES;  // STAGES full, then STAGES empty mbarriers
  static constexpr int SMEM_BYTES = BAR_OFFSET + 16 * STAGES + 1024;
  static_assert(SMEM_BYTES <= 232448, "shared memory of one block");
  static_assert(B_BYTES % 1024 == 0 && STAGES >= 2, "tile shape");
};

// smem: the kernel's dynamic shared memory, C::SMEM_BYTES of it.
template <class C, class Walk>
__device__ __forceinline__ void wgmma_persistent(const Walk& walk, int ntiles, const __nv_bfloat16* __restrict__ bias,
                                                 __nv_bfloat16* __restrict__ y, int N, unsigned char* smem_raw) {
  constexpr int NWG = C::NWG, STAGES = C::STAGES, BN = C::BN;
  constexpr int CONSUMERS = C::CONSUMERS, A_BYTES = C::A_BYTES, STAGE_BYTES = C::STAGE_BYTES;
  constexpr int RING_BYTES = C::RING_BYTES, OUT_PITCH = C::OUT_PITCH, BAR_OFFSET = C::BAR_OFFSET;
  unsigned char* smem = smem_align_1024(smem_raw);
  const uint32_t sbase = smem_u32(smem);
  const uint32_t full_bar = sbase + BAR_OFFSET, empty_bar = full_bar + 8 * STAGES;
  const int tid = threadIdx.x, wg = tid >> 7;

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
      for (int i = blockIdx.x; i < ntiles; i += gridDim.x) {
        const typename Walk::Tile t = walk.tile(i);
        const int nsl = walk.slices(t);
        for (int s = 0; s < nsl; ++s, ++it) {
          if (it >= STAGES) mbar_wait(empty_bar + 8 * stage, parity);
          const uint32_t sa = sbase + stage * STAGE_BYTES, bar = full_bar + 8 * stage;
          mbar_expect_tx(bar, STAGE_BYTES);
          walk.load(sa, sa + A_BYTES, bar, t, s);
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
  for (int i = blockIdx.x; i < ntiles; i += gridDim.x) {
    const typename Walk::Tile t = walk.tile(i);
    const int nsl = walk.slices(t);
#pragma unroll
    for (int j = 0; j < BN / 2; ++j) acc[j] = 0.f;
    int prev = 0;
    for (int s = 0; s < nsl; ++s) {
      mbar_wait(full_bar + 8 * stage, parity);
      const uint32_t sa = sbase + stage * STAGE_BYTES + wg * 64 * 128;
      const uint32_t sb = sbase + stage * STAGE_BYTES + A_BYTES;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < WT_BK / 16; ++kk)
        wgmma_ss<BN>(acc, wgmma_desc(sa + kk * 32, 16, 1024), wgmma_desc(sb + kk * 32, 16, 1024));
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
        if (t.col0 + c < N) b0 = __bfloat162float(bias[t.col0 + c]);
        if (t.col0 + c + 1 < N) b1 = __bfloat162float(bias[t.col0 + c + 1]);
      }
      *reinterpret_cast<__nv_bfloat162*>(&outs[r_lo * OUT_PITCH + c]) =
          __floats2bfloat162_rn(acc[4 * j] + b0, acc[4 * j + 1] + b1);
      *reinterpret_cast<__nv_bfloat162*>(&outs[(r_lo + 8) * OUT_PITCH + c]) =
          __floats2bfloat162_rn(acc[4 * j + 2] + b0, acc[4 * j + 3] + b1);
    }
    bar_sync(wsync, 128);
    const int rows = t.rows - wg * 64;  // of this warpgroup's 64 that exist
    __nv_bfloat16* yw = y + (t.out_row0 + wg * 64) * N + t.col0;
    const int l = tid & 127;
    if (vec_out) {
      constexpr int CH = BN / 8;
      for (int idx = l; idx < 64 * CH; idx += 128) {
        const int r = idx / CH, c = (idx - r * CH) * 8;
        if (r < rows && t.col0 + c < N)
          *reinterpret_cast<uint4*>(yw + (long long)r * N + c) = *reinterpret_cast<const uint4*>(&outs[r * OUT_PITCH + c]);
      }
    } else {
      for (int idx = l; idx < 64 * BN; idx += 128) {
        const int r = idx / BN, c = idx - r * BN;
        if (r < rows && t.col0 + c < N) yw[(long long)r * N + c] = outs[r * OUT_PITCH + c];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// The persistent loop in fp32-class arithmetic (K11 and K4 in fp32): the walk,
// the producer warp and the ring of wgmma_persistent, every product split TF32.
// An fp32 operand x is hi + lo: hi
// is x as stored (the tensor cores read the top 19 bits of an fp32 value) and
// lo = x - hi rounded to TF32 (tf32_lo below), and a b ~
// hi_a lo_b + lo_a hi_b + hi_a hi_b. What differs from the bf16 loop:
// - a slice is 32 channels (a 128-byte fp32 row under the 128-byte swizzle), so
//   a stage holds the A box (BM x 32), the B box and the B lo box (BN x 32 each:
//   the caller forms B's lo parts in device memory before the products, one
//   pass over B, which every row tile reads. Split per slice in shared memory
//   instead (each block splitting every B box it reads, the consumers meeting
//   at one barrier a slice), the large products read 1.18-1.34x slower with A's
//   fragments split in registers and 1.32-1.45x with A split in shared memory,
//   PERF.md §6);
// - A's lo part is formed by the warpgroup that reads it: each consumer
//   warpgroup splits its own 64 rows of the stage into one of two lo slots of
//   its own (no other warpgroup reads them, so a warpgroup barrier suffices),
//   the next slice's while this slice's products run;
// - the tensor cores' fp32 sums round toward zero (PERF.md §6), so each
//   slice's twelve wgmmas (four 8-channel steps, three products each, small
//   terms first) sum from zero into `part`, which is added to the tile's
//   accumulator in fp32 registers: a chain is one load long;
// - the epilogue adds the bias in fp32 and stores each thread's pairs of
//   columns straight from the accumulator (8 bytes a thread, a quad fills a
//   32-byte sector), with no staging tile;
// - a slice's chain and the tile's accumulator take BN fp32 registers a thread
//   together. A producer warp beside two consumer warpgroups (288 threads, which
//   ptxas counts as 384) held the block to 168 registers, and 128 x 160 spilled;
//   so two warpgroups have no producer warp: the first thread of the last one,
//   once it has handed a stage back, waits until the other has too (the stage's
//   `empty` mbarrier) and asks TMA for the slice STAGES ahead, walking the tiles
//   with its own cursor (256 threads keep 255 registers). One warpgroup keeps
//   its producer warp (160 threads: no cap below 255; the folded producer read
//   1.3-2.4x slower there, PERF.md §6). The tile is 128 x 160 (two
//   warpgroups), 64 x 160 or 64 x 32 (one); the caller picks the one whose
//   rounds of tiles cost an SM least (a 2156-row context product walks 34 tiles
//   of 128 x 160 on 132 SMs).
// The walk's load is load(a, b, b_lo, bar, tile, s): A_BYTES + 2 B_BYTES to bar;
// tile(i) may be asked for an i past the last tile and must not fault.
template <int NWG_, int BN_, int STAGES_>
struct PersistentTileX3 {
  static constexpr int NWG = NWG_, BN = BN_, STAGES = STAGES_;
  static constexpr int BM = 64 * NWG, BK = 32;         // rows a tile, channels a slice
  static constexpr bool PRODUCER_WARP = NWG == 1;     // else the last warpgroup's first thread produces
  static constexpr int THREADS = 128 * NWG + (PRODUCER_WARP ? 32 : 0);
  static constexpr int A_BYTES = BM * 128, B_BYTES = BN * 128, STAGE_BYTES = A_BYTES + 2 * B_BYTES;
  static constexpr int RING_BYTES = STAGES * STAGE_BYTES;
  static constexpr int LO_SLOT = 64 * 128;             // a warpgroup's 64 rows of A's lo parts
  static constexpr int BAR_OFFSET = RING_BYTES + NWG * 2 * LO_SLOT;  // STAGES full, then STAGES empty mbarriers
  static constexpr int SMEM_BYTES = BAR_OFFSET + 16 * STAGES + 1024;
  static_assert(SMEM_BYTES <= 232448, "shared memory of one block");
  static_assert(B_BYTES % 1024 == 0 && STAGES >= 2, "tile shape");
};

// D (64 x 160 fp32) (+)= A (64 x 8 TF32) * B (8 x 160 TF32), both K-major from
// shared memory; scale_d = 0 overwrites D
__device__ __forceinline__ void wgmma_m64n160k8_tf32_ss(float (&d)[80], uint64_t desc_a, uint64_t desc_b,
                                                        int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %82, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, "
      " %40, %41, %42, %43, %44, %45, %46, %47, "
      " %48, %49, %50, %51, %52, %53, %54, %55, "
      " %56, %57, %58, %59, %60, %61, %62, %63, "
      " %64, %65, %66, %67, %68, %69, %70, %71, "
      " %72, %73, %74, %75, %76, %77, %78, %79}, "
      "%80, %81, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d)
      : "memory");
}

__device__ __forceinline__ void wgmma_m64n32k8_tf32_ss(float (&d)[16], uint64_t desc_a, uint64_t desc_b,
                                                       int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d)
      : "memory");
}

// One m64nBNk8 TF32 wgmma, both operands K-major from shared memory: the widths
// the fp32 loop is built for
template <int BN>
__device__ __forceinline__ void wgmma_tf32_ss(float (&d)[BN / 2], uint64_t desc_a, uint64_t desc_b, int scale_d);
template <>
__device__ __forceinline__ void wgmma_tf32_ss<160>(float (&d)[80], uint64_t desc_a, uint64_t desc_b, int scale_d) {
  wgmma_m64n160k8_tf32_ss(d, desc_a, desc_b, scale_d);
}
template <>
__device__ __forceinline__ void wgmma_tf32_ss<32>(float (&d)[16], uint64_t desc_a, uint64_t desc_b, int scale_d) {
  wgmma_m64n32k8_tf32_ss(d, desc_a, desc_b, scale_d);
}

// The lo part of an fp32 value for split-TF32 products (x = hi + lo, hi being x
// as stored, which the tensor cores cut to TF32): x less its TF32 cut, rounded to
// TF32 (nearest, ties away from zero, on the bits)
__device__ __forceinline__ uint32_t tf32_lo(float x) {
  const float rest = x - __uint_as_float(__float_as_uint(x) & 0xffffe000u);
  return (__float_as_uint(rest) + 0x1000u) & 0xffffe000u;
}

// smem: the kernel's dynamic shared memory, C::SMEM_BYTES of it.
template <class C, class Walk>
__device__ __forceinline__ void wgmma_persistent_x3(const Walk& walk, int ntiles, const float* __restrict__ bias,
                                                    float* __restrict__ y, int N, unsigned char* smem_raw) {
  constexpr int NWG = C::NWG, STAGES = C::STAGES, BN = C::BN;
  constexpr int A_BYTES = C::A_BYTES, B_BYTES = C::B_BYTES;
  constexpr int STAGE_BYTES = C::STAGE_BYTES, LO_SLOT = C::LO_SLOT;
  unsigned char* smem = smem_align_1024(smem_raw);
  const uint32_t sbase = smem_u32(smem);
  const uint32_t full_bar = sbase + C::BAR_OFFSET, empty_bar = full_bar + 8 * STAGES;
  const int tid = threadIdx.x, wg = tid >> 7;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full_bar + 8 * s, 1);
      mbar_init(empty_bar + 8 * s, NWG);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if constexpr (C::PRODUCER_WARP) {
    if (wg == NWG) {   // the producer warp: one thread keeps the ring full across the block's tiles
      if (tid == 128 * NWG) {
        int stage = 0, it = 0;
        uint32_t parity = 1;  // of the empty barriers: the ring's round before this one
        for (int i = blockIdx.x; i < ntiles; i += gridDim.x) {
          const typename Walk::Tile t = walk.tile(i);
          const int nsl = walk.slices(t);
          for (int s = 0; s < nsl; ++s, ++it) {
            if (it >= STAGES) mbar_wait(empty_bar + 8 * stage, parity);
            const uint32_t sa = sbase + stage * STAGE_BYTES, bar = full_bar + 8 * stage;
            mbar_expect_tx(bar, STAGE_BYTES);
            walk.load(sa, sa + A_BYTES, sa + A_BYTES + B_BYTES, bar, t, s);
            if (++stage == STAGES) {
              stage = 0;
              parity ^= 1;
            }
          }
        }
      }
      return;
    }
  }
  // else the producer is the first thread of the last warpgroup: its cursor over the block's (tile, slice) pairs
  const bool producer = !C::PRODUCER_WARP && tid == 128 * (NWG - 1);
  int p_tile = blockIdx.x, p_slice = 0, p_it = 0;
  typename Walk::Tile p_t = walk.tile(p_tile);
  int p_nsl = p_tile < ntiles ? walk.slices(p_t) : 0;
  auto produce = [&]() {   // the next slice of the block into its stage, once every warpgroup has freed it
    if (p_tile >= ntiles) return;
    const int stage = p_it % STAGES;
    if (p_it >= STAGES) mbar_wait(empty_bar + 8 * stage, ((p_it / STAGES) - 1) & 1);
    const uint32_t sa = sbase + stage * STAGE_BYTES, bar = full_bar + 8 * stage;
    mbar_expect_tx(bar, STAGE_BYTES);
    walk.load(sa, sa + A_BYTES, sa + A_BYTES + B_BYTES, bar, p_t, p_slice);
    ++p_it;
    if (++p_slice == p_nsl) {
      p_slice = 0;
      p_tile += gridDim.x;
      if (p_tile < ntiles) {
        p_t = walk.tile(p_tile);
        p_nsl = walk.slices(p_t);
      }
    }
  };
  if (producer)
    for (int k = 0; k < STAGES; ++k) produce();

  const int l = tid & 127, warp = l >> 5, lane = tid & 31, gid = lane >> 2, tig = lane & 3;
  const int wsync = 1 + wg;  // this warpgroup's named barrier
  const uint32_t lo_base = sbase + C::RING_BYTES + wg * 2 * LO_SLOT;
  // this warpgroup's 64 rows of the A box of `stage` -> their lo parts in `slot` (same swizzled offsets)
  auto split_rows = [&](int stage, int slot) {
    const uint32_t src = sbase + stage * STAGE_BYTES + wg * LO_SLOT, dst = lo_base + slot * LO_SLOT;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const uint32_t off = 16 * (l + 128 * k);
      float4 v;
      asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
                   : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
                   : "r"(src + off)
                   : "memory");
      asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(dst + off), "r"(tf32_lo(v.x)),
                   "r"(tf32_lo(v.y)), "r"(tf32_lo(v.z)), "r"(tf32_lo(v.w))
                   : "memory");
    }
    fence_proxy_async();  // the wgmmas read the lo slot through the async proxy
  };
  const bool vec_out = N % 2 == 0 && reinterpret_cast<uintptr_t>(y) % 8 == 0;
  int stage = 0;
  uint32_t parity = 0;  // of the full barriers: the ring's current round
  float acc[BN / 2], part[BN / 2];
  for (int i = blockIdx.x; i < ntiles; i += gridDim.x) {
    const typename Walk::Tile t = walk.tile(i);
    const int nsl = walk.slices(t);
#pragma unroll
    for (int j = 0; j < BN / 2; ++j) acc[j] = 0.f;
    mbar_wait(full_bar + 8 * stage, parity);
    split_rows(stage, 0);
    bar_sync(wsync, 128);
    for (int s = 0; s < nsl; ++s) {
      const uint32_t st = sbase + stage * STAGE_BYTES;
      const uint32_t sa = st + wg * LO_SLOT, sb = st + A_BYTES, sbl = sb + B_BYTES;
      const uint32_t sal = lo_base + (s & 1) * LO_SLOT;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {   // hi lo, lo hi, hi hi of each 8-channel step, from zero
        wgmma_tf32_ss<BN>(part, wgmma_desc(sa + kk * 32, 16, 1024), wgmma_desc(sbl + kk * 32, 16, 1024), kk);
        wgmma_tf32_ss<BN>(part, wgmma_desc(sal + kk * 32, 16, 1024), wgmma_desc(sb + kk * 32, 16, 1024), 1);
        wgmma_tf32_ss<BN>(part, wgmma_desc(sa + kk * 32, 16, 1024), wgmma_desc(sb + kk * 32, 16, 1024), 1);
      }
      wgmma_commit();
      const int next = stage + 1 == STAGES ? 0 : stage + 1;
      const uint32_t next_parity = next == 0 ? parity ^ 1 : parity;
      if (s + 1 < nsl) {   // the next slice's lo rows while these products run
        mbar_wait(full_bar + 8 * next, next_parity);
        split_rows(next, (s + 1) & 1);
      }
      wgmma_wait<0>();
      wgmma_fence_regs(part);
      if (l == 0) mbar_arrive(empty_bar + 8 * stage);
      if (producer) produce();
#pragma unroll
      for (int j = 0; j < BN / 2; ++j) acc[j] += part[j];
      stage = next;
      parity = next_parity;
      if (s + 1 < nsl) bar_sync(wsync, 128);   // the next slice's lo rows are in place
    }

    // epilogue: bias in fp32, each thread's column pairs of rows gid, gid + 8 of its warp's 16
    const int rows = t.rows - wg * 64;   // of this warpgroup's 64 that exist
    float* yw = y + (t.out_row0 + wg * 64) * N + t.col0;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int c = j * 8 + tig * 2, col = t.col0 + c;
      float b0 = 0.f, b1 = 0.f;
      if (bias != nullptr) {
        if (col < N) b0 = bias[col];
        if (col + 1 < N) b1 = bias[col + 1];
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = warp * 16 + gid + 8 * h;
        if (r >= rows || col >= N) continue;
        float* dst = yw + (long long)r * N + c;
        const float v0 = acc[4 * j + 2 * h] + b0, v1 = acc[4 * j + 2 * h + 1] + b1;
        if (vec_out && col + 1 < N) {
          *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
        } else {
          dst[0] = v0;
          if (col + 1 < N) dst[1] = v1;
        }
      }
    }
  }
}

// The TF32 lo parts of the fp32 weights w (n of them, a multiple of 4; w and lo
// 16-byte aligned) into lo, launched on `stream` (matmul_bias.cu): the third
// operand of wgmma_persistent_x3's walks, formed once a call.
void launch_tf32_lo(const void* w, void* lo, long long n, int sms, cudaStream_t stream);

// What an SM pays for a persistent x3 launch of `tiles` tiles of bm x bn: its
// rounds of tiles, each a slice's fixed cost (the split, the barrier, the wait for
// the products: about half a 128 x 160 slice's products) and its products.
inline double x3_cost(long long tiles, int bm, int bn, int sms) {
  return (double)((tiles + sms - 1) / sms) * (0.5 + (double)bm * bn / (128.0 * 160.0));
}

// Rows one SM walks when `tiles` tiles of `bm` rows are spread over `sms` SMs:
// its rounds of tiles times bm (the last round is the one that leaves SMs idle).
inline long long persistent_rows_per_sm(long long tiles, int bm, int sms) { return (tiles + sms - 1) / sms * bm; }

// SMs of the current device (0 and a CUDA error code on failure).
inline int device_sms(int* sms) {
  int dev = 0;
  if (const cudaError_t rc = cudaGetDevice(&dev)) return (int)rc;
  return (int)cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
}

// Host side: tensor maps. The encoders live in libcuda; they are looked up
// through the runtime, so the library links against no stub of it; encoding is host
// arithmetic only, so it is done per launch and nothing is cached.
inline void* wgmma_libcuda_entry(const char* name) {
  void* fn = nullptr;
  cudaDriverEntryPointQueryResult found;
  if (cudaGetDriverEntryPoint(name, &fn, cudaEnableDefault, &found) != cudaSuccess ||
      found != cudaDriverEntryPointSuccess)
    return nullptr;
  return fn;
}

// The encoders are driver calls, which need a context current on the calling
// thread. The runtime binds its primary context lazily, and a thread that has
// launched nothing yet may hold none (PyTorch's autograd device threads, whose
// first node can be a backward whose first CUDA call is this encoding: the
// driver then answers CUDA_ERROR_INVALID_CONTEXT). Setting the thread's current
// device binds it; when it is bound already this is a bookkeeping call.
inline void bind_current_context() {
  int dev = 0;
  if (cudaGetDevice(&dev) == cudaSuccess) cudaSetDevice(dev);
}

// A tiled map of a tensor of `rank` dims (innermost first, unit stride;
// strides: bytes of dims 1.., multiples of 16) with `box` elements per dim.
inline int tma_tiled_map(CUtensorMapDataType dtype, CUtensorMapSwizzle swizzle, const void* base, int rank,
                         const cuuint64_t* dims, const cuuint64_t* strides, const cuuint32_t* box,
                         CUtensorMap* map) {
  using Encode = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                              const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
                              CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
                              CUtensorMapFloatOOBfill);
  static const Encode encode = reinterpret_cast<Encode>(wgmma_libcuda_entry("cuTensorMapEncodeTiled"));
  if (encode == nullptr) return kErrUnsupported;
  bind_current_context();
  const cuuint32_t elem[5] = {1, 1, 1, 1, 1};
  const CUresult rc = encode(map, dtype, (cuuint32_t)rank, const_cast<void*>(base), dims, strides, box, elem,
                             CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS ? 0 : kErrBadArgument;
}

// A bf16 tiled map with 64 elements innermost in a box (one 128-byte row)
// under the 128-byte swizzle: the operand tiles of the wgmma kernels.
inline int wgmma_tiled_map(const void* base, int rank, const cuuint64_t* dims, const cuuint64_t* strides,
                           const cuuint32_t* box, CUtensorMap* map) {
  return tma_tiled_map(CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, CU_TENSOR_MAP_SWIZZLE_128B, base, rank, dims, strides,
                       box, map);
}

// W [taps, N, K] bf16 (K contiguous): boxes of 64 k x bn n x 1 tap.
inline int wgmma_weight_map(const void* w, int taps, int N, int K, int bn, CUtensorMap* map) {
  const cuuint64_t dims[3] = {(cuuint64_t)K, (cuuint64_t)N, (cuuint64_t)taps};
  const cuuint64_t strides[2] = {(cuuint64_t)K * 2, (cuuint64_t)N * K * 2};
  const cuuint32_t box[3] = {WT_BK, (cuuint32_t)bn, 1};
  return wgmma_tiled_map(w, 3, dims, strides, box, map);
}

// x [B, H, W, C] bf16 for a 3x3 SAME convolution: im2col boxes of 64 channels x
// bm pixels under the 128-byte swizzle. The bounding box starts one pixel
// outside the image (lower corner -1) and holds W x H base pixels (upper corner
// -1), so base pixel (w - 1, h - 1) read at offset (dx + 1, dy + 1) is the input
// of output pixel (w, h) at tap (dy, dx); what lies outside arrives as zeros.
inline int wgmma_im2col3x3_map(const void* x, int B, int H, int W, int C, int bm, CUtensorMap* map) {
  using Encode = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                              const cuuint64_t*, const int*, const int*, cuuint32_t, cuuint32_t,
                              const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                              CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
  static const Encode encode = reinterpret_cast<Encode>(wgmma_libcuda_entry("cuTensorMapEncodeIm2col"));
  if (encode == nullptr) return kErrUnsupported;
  bind_current_context();
  const cuuint64_t dims[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)C * 2, (cuuint64_t)W * C * 2, (cuuint64_t)H * W * C * 2};
  const int lower[2] = {-1, -1}, upper[2] = {-1, -1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult rc = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x), dims, strides,
                             lower, upper, WT_BK, (cuuint32_t)bm, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS ? 0 : kErrBadArgument;
}

// Grid of a tiled launch, column tiles fastest (the blocks that share a row
// tile's A rows run together and find them in L2).
inline bool wgmma_grid(long long R, int N, int bm, int bn, unsigned* blocks, int* ncol) {
  const long long nrow = (R + bm - 1) / bm;
  *ncol = (N + bn - 1) / bn;
  const long long total = nrow * *ncol;
  if (total <= 0 || total > 0x7fffffffLL) return false;
  *blocks = (unsigned)total;
  return true;
}

}  // namespace vs
