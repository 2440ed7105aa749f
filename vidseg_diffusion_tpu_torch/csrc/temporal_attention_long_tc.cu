// K2 and K6 past 32 frames on the tensor cores, at the head dims 64 (the
// UNet's temporal sites) and 512 (the VideoDecoder's VideoAttnBlock time mix),
// in bf16 (mma.sync.m16n8k16) and fp32 (mma.sync.m16n8k8 in TF32 as three
// products of split operands). The C entries of temporal_attention.cu and
// temporal_attention_bwd.cu send every t > 32 here at D = 64 and 512; D = 16
// keeps the frame-walking kernels of temporal_attention_long.cu. Up to 32
// frames they send here (route 9, "tc_short") K2 at D = 512 from their
// crossover with the wide kernel (the team kernel below, which holds every
// key tile's logits in registers there) and K6 in fp32 at D = 64 from 2
// frames on 16-byte aligned bases (the resident kernel on 16 or 32 rows, one
// or two warps, the key side reading the query side's p and ds from shared
// memory).
//
// Replaces (TPU): vidseg_diffusion_tpu/ops/attention.py:1375
// _temporal_direct_kernel (via _temporal_direct_impl's pallas_call at :1458,
// a 16-token tile past 32 frames) and, under a gradient, :1068
// _small_seq_bwd_kernel (pallas_call at :1167) via _tad_bwd (:1506-1533).
//
// The arithmetic is JAX's at every t, with no running softmax:
// - forward: qf = round(q * scale * log2(e)); the row max over all t logits
//   before any exp2; e = exp2(s - max); the denominator the fp32 sum of the
//   unrounded e; O = round(e) V in fp32, divided by the sum at the end;
// - backward: delta = rowsum(g o); p = e / sum(e) in fp32 over every key;
//   ds = round(p (g v^T - delta)); dq = scale ds k, dk = ds^T qf / log2(e),
//   dv = round(p)^T g.
// Nothing is summed across blocks or with atomics: the same inputs give the
// same bits.
//
// Layout. A problem (video, token, head) is a team of D / 64 warps (one at
// D = 64, eight at 512); warp w of a team owns the 64 channels [64 w, 64 w +
// 64) of every row (one 128-byte panel in bf16, two in fp32) and reads and
// writes only those, so its data is its own: it asks TMA for its boxes itself
// (lane 0, one mbarrier a ring stage) and waits on them with no block barrier.
// A TMA map views each tensor as (channel, frame, token, video) with its own
// strides and boxes of one panel x 16 frames, so a problem's rows, S H D
// itemsize bytes apart in device memory, land as 128-byte rows under the
// 128-byte swizzle (ldmatrix free of bank conflicts); frames at t or beyond
// arrive as zeros, so a ragged last tile masks only its logits.
// - S = qf K^T and dP = g V^T: each warp's partial over its channels on the
//   tensor cores (fp32: a chain of one panel's 32 channels, added in fp32
//   registers); at D = 512 the team's partials meet in shared memory and every
//   warp adds them in warp order, so all eight hold the same bits of the whole
//   tile as C fragments. The softmax works on those registers (row max and sum
//   over the quad), and p, round(p) and ds become A operands in place (bf16:
//   packed, ds^T and p^T by movmatrix; fp32: a C fragment is an A fragment
//   when k-step slot tig takes key 2 tig and slot tig + 4 key 2 tig + 1; the
//   transposes through a small tile of the warp): O = round(p) V, dq = ds K,
//   dk = ds^T qf, dv = round(p)^T g over the warp's own channels (fp32: one
//   chain over the tile's keys or queries, added in fp32).
// - D = 64 up to 64 frames: a problem's tensors fit a block, so one block of
//   three (up to 48 frames) or four warps holds them all, each row read once
//   by TMA, and warp w takes query tile w (K2; K6 then key tile w after a
//   block barrier); every tile's logits stay in registers (32 a lane).
// - otherwise the forward holds a 16-row tile of queries and walks 32-row tiles
//   of keys (16 at D = 512 and in fp32) through a ring of stages: the max, then
//   the sum and P V. Up to 64 frames the logits stay in registers, so the
//   second walk reads v alone; past 64 it recomputes them.
// - the backward first takes, per 16-row query tile (q, g held), delta from a
//   visit of o, then walks 16-row key tiles for the max, the sum (up to 64
//   frames from the held logits, with no walk) and dP, ds and dq, keeping each
//   query row's max, sum and delta in shared memory (where they do not fit, as
//   fp32 at D = 512 past 784 frames, in the wrapper's device scratch of three
//   floats a row); then per 16-row key tile (k, v held) walks the query tiles
//   once, recomputing S and dP from the same operands with the same products
//   in the same order, so p and ds are the bits the query side saw, and sums
//   dk and dv.
// Outputs are staged in a spent tile and leave 16 bytes a lane.
// At D = 512 the backward was also built as the 32-row tile of
// temporal_attention_bwd_512.cu walked over 32-row key tiles (warps owning
// S / dP regions over all 512 channels, q and g or k and v resident, the rest
// streamed in 32 KB chunks through a block-wide ring): it read slower at 48
// frames (PERF.md, the table's row 27) and is not kept.
#include "common.cuh"
#include "temporal_tile.cuh"
#include "tf32x3_attention.cuh"

namespace vs {
namespace ltc {

constexpr float kInvLog2E = 0.6931471805599453f;
constexpr int kSmemMax = 232448;

template <typename T, int D, bool BWD>
struct Cfg {
  using Elem = T;
  static constexpr bool F32 = sizeof(T) == 4;
  static constexpr int PPW = F32 ? 2 : 1;             // 128-byte panels a warp: 64 channels
  static constexpr int ELEM = 128 / (int)sizeof(T);   // channels a panel
  static constexpr int TEAM = D / 64;                 // warps a problem
  static constexpr int WT = (!F32 && D == 64 && !BWD) ? 32 : 16;  // rows a walked tile
  static constexpr int NT = WT / 8;                   // 8-key n-tiles of a walked tile
  static constexpr int HOLD = 64 / WT;                // walked tiles whose logits stay in registers (t <= 64)
  static constexpr int NST = BWD ? 2 : 3;             // ring stages
  static constexpr int NOWN = BWD ? 2 : 1;            // 16-row tiles a warp holds
  static constexpr int OWN_TILE = 16 * 128 * PPW;     // bytes of a held tile, all the warp's panels
  static constexpr int WALK_TILE = WT * 128 * PPW;
  static constexpr int STAGE = (BWD ? 2 : 1) * WALK_TILE;   // a visit's tiles: k or v; k and v, or q and g (or o)
  static constexpr int RP = WT + 8;                   // floats a row of a partial [16 rows][WT cols]
  // a warp's partials of S (and dP) for its team, or (fp32 backward) its p and ds for their transposes
  static constexpr int RED_BYTES = TEAM > 1 || (BWD && F32) ? (BWD ? 2 : 1) * 16 * RP * 4 : 0;
  static constexpr int RED = NOWN * OWN_TILE + NST * STAGE;
  static constexpr int WARP_BYTES = (RED + RED_BYTES + 1023) / 1024 * 1024;
  static constexpr int TEAMS = TEAM > 1 ? 1 : 2;      // problems a block
  static constexpr int WARPS = TEAM * TEAMS, THREADS = 32 * WARPS;
  static_assert(!BWD || WT == 16, "the backward's delta visit takes a 16-row o tile into a stage slot");
  // the backward's delta partials, then (stats: here, not in device memory) each query row's max, sum and delta
  static __host__ __device__ constexpr int team_bytes(int t, bool stats) {
    return BWD ? (TEAM * 16 * 4 + (stats ? 12 * ((t + 15) / 16 * 16) : 0) + 127) / 128 * 128 : 0;
  }
  static __host__ __device__ constexpr int smem(int t, bool stats) {
    return 1024 + WARPS * WARP_BYTES + TEAMS * team_bytes(t, stats) + WARPS * 8 * (NST + 1);
  }
};

// ---- fragments --------------------------------------------------------------

// x (fp32 bits) = hi + lo: hi cut to TF32, lo the rest rounded to TF32
__device__ __forceinline__ void split_cut(uint32_t x, uint32_t& hi, uint32_t& lo) {
  hi = x & 0xffffe000u;
  lo = tf32_lo(__uint_as_float(x));
}
template <int N>
__device__ __forceinline__ void split_cut(const uint32_t (&x)[N], uint32_t (&hi)[N], uint32_t (&lo)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) split_cut(x[i], hi[i], lo[i]);
}
// c += a b from the split parts, small terms first
__device__ __forceinline__ void mma_x3(float (&c)[4], const uint32_t (&ah)[4], const uint32_t (&al)[4], uint32_t bh0,
                                       uint32_t bh1, uint32_t bl0, uint32_t bl1) {
  tt_mma_tf32(c, ah, bl0, bl1);
  tt_mma_tf32(c, al, bh0, bh1);
  tt_mma_tf32(c, ah, bh0, bh1);
}

// acc[NT] = A B^T over this warp's channels: A the 16 rows of panel tile `a` (arows rows a panel), B the rows
// of `b` (brows a panel), only its first nv 16-row pairs (the rest stay zero). fp32: one chain a panel (32
// channels) on the tensor cores, the panels added in fp32. Both sides of the backward call this with the same
// operands, so each element has the same bits wherever it is computed.
template <typename T, int NT>
__device__ __forceinline__ void qk_partial(float (&acc)[NT][4], uint32_t a, int arows, uint32_t b, int brows, int nv,
                                           int lane) {
  constexpr bool F32 = sizeof(T) == 4;
  constexpr int PPW = F32 ? 2 : 1;
#pragma unroll
  for (int n = 0; n < NT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
#pragma unroll
  for (int p = 0; p < PPW; ++p) {
    const uint32_t pa = a + (uint32_t)(p * arows * 128), pb = b + (uint32_t)(p * brows * 128);
    float pt[NT][4];  // fp32: this panel's chain
#pragma unroll
    for (int n = 0; n < NT; ++n) pt[n][0] = pt[n][1] = pt[n][2] = pt[n][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {  // 16 bf16 / 8 fp32 channels
      uint32_t af[4], ah[4], al[4];
      tt_ldsm(af, tt_a_addr(pa, 0, ks, lane));
      if constexpr (F32) split_cut(af, ah, al);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np)
        if (np < nv) {
          uint32_t bf[4];
          tt_ldsm(bf, tt_bt_addr(pb, 16 * np, ks, lane));
          if constexpr (F32) {
            uint32_t bh[4], bl[4];
            split_cut(bf, bh, bl);
            mma_x3(pt[2 * np], ah, al, bh[0], bh[1], bl[0], bl[1]);
            mma_x3(pt[2 * np + 1], ah, al, bh[2], bh[3], bl[2], bl[3]);
          } else {
            tt_mma(acc[2 * np], af, bf[0], bf[1]);
            tt_mma(acc[2 * np + 1], af, bf[2], bf[3]);
          }
        }
    }
    if constexpr (F32) {
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int u = 0; u < 4; ++u) acc[n][u] += pt[n][u];
    }
  }
}

// a warp's partial [16 rows][8 NT cols] into shared memory (pitch floats a row)
template <int NT>
__device__ __forceinline__ void put_partial(uint32_t red, int pitch, const float (&acc)[NT][4], int lane) {
  const int gid = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" ::"r"(red + 4 * ((gid + 8 * r) * pitch + 8 * n + 2 * tig)),
                   "f"(acc[n][2 * r]), "f"(acc[n][2 * r + 1])
                   : "memory");
}

// x = the partials of the team's warps (warp w's at red0 + w * stride, in the layout of put_partial), added in
// warp order: every warp of the team gets the same bits
template <int NT>
__device__ __forceinline__ void sum_partials(float (&x)[NT][4], uint32_t red0, uint32_t stride, int nw, int pitch,
                                             int lane) {
  const int gid = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const uint32_t at = red0 + 4 * ((gid + 8 * r) * pitch + 8 * n + 2 * tig);
      float a, b;
      asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n" : "=f"(a), "=f"(b) : "r"(at) : "memory");
      for (int w = 1; w < nw; ++w) {
        float c, d;
        asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n" : "=f"(c), "=f"(d) : "r"(at + w * stride) : "memory");
        a += c, b += d;
      }
      x[n][2 * r] = a, x[n][2 * r + 1] = b;
    }
}

// the row max of C fragments (rows gid, gid + 8) over the quad
template <int NT>
__device__ __forceinline__ void row_max(const float (&s)[NT][4], float (&m)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float x = -INFINITY;
#pragma unroll
    for (int n = 0; n < NT; ++n) x = fmaxf(x, fmaxf(s[n][2 * r], s[n][2 * r + 1]));
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
    m[r] = fmaxf(m[r], x);
  }
}

// p = e / sum(e) and ds = p (dP - delta): the one place either side of the backward forms them
__device__ __forceinline__ void softmax_ds(float s, float m, float l, float dp, float delta, float& p, float& ds) {
  p = exp2f(s - m) / l;
  ds = p * (dp - delta);
}

// fp32: ch[8 n-tiles of this warp's 64 channels] += A B over one k-step, A split (slot tig <-> contraction row
// k0, slot tig + 4 <-> k0 + 1), B rows k0 and k0 + 1 of panel tile `src` (`rows` a panel), split here
__device__ __forceinline__ void f32_kstep(float (&ch)[8][4], const uint32_t (&ah)[4], const uint32_t (&al)[4],
                                          uint32_t src, int rows, int k0, int gid) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const uint32_t pn = src + (uint32_t)((j >> 2) * rows * 128);
    uint32_t bh0, bl0, bh1, bl1;
    split_cut(__float_as_uint(x3::lds(pn + x3::sw(k0, 8 * (j & 3) + gid))), bh0, bl0);
    split_cut(__float_as_uint(x3::lds(pn + x3::sw(k0 + 1, 8 * (j & 3) + gid))), bh1, bl1);
    mma_x3(ch[j], ah, al, bh0, bh1, bl0, bl1);
  }
}

// out[8 n-tiles of this warp's 64 channels] += X B: X [16 rows][8 NT keys] as C fragments (zero past kv; bf16:
// rounded here to the A operand), B the rows of panel tile `src` (`rows` a panel) as the contraction. fp32: k-step
// slot tig <-> key 2 tig, slot tig + 4 <-> 2 tig + 1, so a C fragment is an A fragment (and the B reads miss
// no bank); one chain over the tile's keys on the tensor cores, added to out in fp32.
template <typename T, int NT>
__device__ __forceinline__ void frag_product(float (&out)[8][4], const float (&x)[NT][4], uint32_t src, int rows,
                                             int kv, int lane) {
  const int gid = lane >> 2, tig = lane & 3;
  if constexpr (sizeof(T) == 2) {
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk)
      if (16 * kk < kv) {
        const uint32_t a[4] = {tt_pack(x[2 * kk][0], x[2 * kk][1]), tt_pack(x[2 * kk][2], x[2 * kk][3]),
                               tt_pack(x[2 * kk + 1][0], x[2 * kk + 1][1]), tt_pack(x[2 * kk + 1][2], x[2 * kk + 1][3])};
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          uint32_t bb[4];
          tt_ldsm_trans(bb, tt_b_addr(src, 16 * kk, np, lane));
          tt_mma(out[2 * np], a, bb[0], bb[1]);
          tt_mma(out[2 * np + 1], a, bb[2], bb[3]);
        }
      }
  } else {
    float ch[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) ch[j][0] = ch[j][1] = ch[j][2] = ch[j][3] = 0.f;
#pragma unroll
    for (int n = 0; n < NT; ++n)
      if (8 * n < kv) {
        const uint32_t xa[4] = {__float_as_uint(x[n][0]), __float_as_uint(x[n][2]), __float_as_uint(x[n][1]),
                                __float_as_uint(x[n][3])};
        uint32_t ah[4], al[4];
        split_cut(xa, ah, al);
        const int k0 = 8 * n + 2 * tig;
        f32_kstep(ch, ah, al, src, rows, k0, gid);
      }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int u = 0; u < 4; ++u) out[j][u] += ch[j][u];
  }
}

// fp32: out += A B with A [16 rows][kv] the transpose of `tile` ([kv rows][pitch floats], written by put_partial),
// B the rows of panel tile `src` as the contraction; slots as frag_product's, one chain, added in fp32
__device__ __forceinline__ void trans_product_f32(float (&out)[8][4], uint32_t tile, int pitch, uint32_t src, int rows,
                                                  int kv, int lane) {
  const int gid = lane >> 2, tig = lane & 3;
  auto ld = [&](int r, int c) { return __float_as_uint(x3::lds(tile + 4 * (r * pitch + c))); };
  float ch[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j) ch[j][0] = ch[j][1] = ch[j][2] = ch[j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < 2; ++kk)
    if (8 * kk < kv) {
      const int k0 = 8 * kk + 2 * tig;
      const uint32_t x[4] = {ld(k0, gid), ld(k0, gid + 8), ld(k0 + 1, gid), ld(k0 + 1, gid + 8)};
      uint32_t ah[4], al[4];
      split_cut(x, ah, al);
      f32_kstep(ch, ah, al, src, rows, k0, gid);
    }
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int u = 0; u < 4; ++u) out[j][u] += ch[j][u];
}

// out * mul (16 rows x this warp's 64 channels, rounded to T) over a tile's rows (prows rows a panel)
template <typename T>
__device__ __forceinline__ void stage_out(uint32_t tile, int prows, const float (&out)[8][4], float mul,
                                          const float (&div)[2], int lane) {
  const int gid = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float x0 = out[n][2 * r] * mul / div[r], x1 = out[n][2 * r + 1] * mul / div[r];
      if constexpr (sizeof(T) == 2) {
        tt_st32(tile + sw128(gid + 8 * r, n) + 4 * tig, tt_pack(x0, x1));
      } else {
        asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" ::"r"(tile + (n >> 2) * prows * 128 +
                                                                x3::sw(gid + 8 * r, 8 * (n & 3) + 2 * tig)),
                     "f"(x0), "f"(x1)
                     : "memory");
      }
    }
}

// qf = round(q * qscale) in place over `rows` rows of this warp's panels (prows rows a panel)
template <typename T>
__device__ __forceinline__ void to_qf(uint32_t tile, int rows, int prows, float qscale, int lane) {
  constexpr int PPW = sizeof(T) == 4 ? 2 : 1;
  for (int e = lane; e < rows * 8 * PPW; e += 32) {
    const uint32_t at = tile + (uint32_t)((e / (rows * 8)) * prows * 128 + (e % (rows * 8)) * 16);
    uint4 x = tt_ld128(at);
    uint32_t* w = reinterpret_cast<uint32_t*>(&x);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      w[j] = sizeof(T) == 4 ? __float_as_uint(__uint_as_float(w[j]) * qscale)
                            : tt_pack(tt_lo(w[j]) * qscale, tt_hi(w[j]) * qscale);
    tt_st128(at, x);
  }
}

// A problem's coordinates, the warp's channels, and its TMA boxes.
template <class C>
struct Warp {
  int s, b, c0, t, lane;
  long long row0, frame;  // element offset of frame 0 at this warp's first channel; elements a frame
  // rows [f0, f0 + rows) of this warp's panels of tensor `map` into `dst` (lane 0)
  __device__ __forceinline__ void load(const CUtensorMap* map, uint32_t dst, int f0, int rows, uint32_t bar) const {
#pragma unroll
    for (int p = 0; p < C::PPW; ++p)
      for (int hh = 0; hh < rows / 16; ++hh)
        tma_load_4d(dst + (uint32_t)(p * rows * 128 + hh * 2048), map, bar, c0 + p * C::ELEM, f0 + 16 * hh, s, b);
  }
  // a 16-row tile's rows f0.. (those before t; prows rows a panel) out to `dst`, 16 bytes a lane
  __device__ __forceinline__ void store(typename C::Elem* dst, uint32_t tile, int f0, int prows = 16) const {
    for (int e = lane; e < 16 * 8 * C::PPW; e += 32) {
      const int p = e >> 7, r = (e >> 3) & 15, piece = e & 7;
      if (f0 + r < t)
        *reinterpret_cast<uint4*>(dst + row0 + (f0 + r) * frame + p * C::ELEM + piece * (16 / sizeof(*dst))) =
            tt_ld128(tile + (uint32_t)(p * prows * 128) + sw128(r, piece));
    }
  }
};

template <typename T, int D>
using Fwd = Cfg<T, D, false>;
template <typename T, int D>
using Bwd = Cfg<T, D, true>;

// Common set-up of both kernels: the warp's regions and barriers; false for a team past the last problem.
template <class C>
struct Setup {
  uint32_t own, ring, red, red0, team, bars;
  int wt, team_id;
  long long prob;
  Warp<C> w;
  __device__ __forceinline__ bool init(unsigned char* raw, long long nprob, int t, int S, int H, bool stats) {
    const uint32_t base = smem_u32(smem_align_1024(raw));
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    team_id = warp / C::TEAM;
    wt = warp % C::TEAM;
    prob = (long long)blockIdx.x * C::TEAMS + team_id;
    if (prob >= nprob) return false;
    const int h = (int)(prob % H);
    const long long rest = prob / H;
    w.s = (int)(rest % S);
    w.b = (int)(rest / S);
    w.c0 = h * D_of() + wt * 64;
    w.t = t;
    w.lane = lane;
    w.frame = (long long)S * H * D_of();
    w.row0 = w.b * t * w.frame + (long long)w.s * H * D_of() + w.c0;
    own = base + warp * C::WARP_BYTES;
    ring = own + C::NOWN * C::OWN_TILE;
    red = own + C::RED;
    red0 = base + team_id * C::TEAM * C::WARP_BYTES + C::RED;
    team = base + C::WARPS * C::WARP_BYTES + team_id * C::team_bytes(t, stats);
    bars = base + C::WARPS * C::WARP_BYTES + C::TEAMS * C::team_bytes(t, stats) + warp * 8 * (C::NST + 1);
    if (lane == 0) {
#pragma unroll
      for (int i = 0; i < C::NST + 1; ++i) mbar_init(bars + 8 * i, 1);
      mbar_init_fence();
    }
    __syncwarp();
    return true;
  }
  static __device__ __forceinline__ int D_of() { return C::TEAM * 64; }
  __device__ __forceinline__ void team_sync() const {
    if constexpr (C::TEAM == 1)
      __syncwarp();
    else
      bar_sync(1 + team_id, 32 * C::TEAM);
  }
};

// A warp's ring: visit v (counted over the kernel) in stage v % NST.
template <class C>
struct Ring {
  uint32_t ring, bars;
  int n = 0;  // visits issued before this walk
  __device__ __forceinline__ uint32_t stage(int v) const { return ring + (uint32_t)((v % C::NST) * C::STAGE); }
  __device__ __forceinline__ uint32_t bar(int v) const { return bars + 8 * (1 + v % C::NST); }
  __device__ __forceinline__ void wait(int v) const { mbar_wait(bar(v), (uint32_t)((v / C::NST) & 1)); }
};

// ---- K2 ---------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(Fwd<T, D>::THREADS) temporal_long_tc_kernel(
    const __grid_constant__ DirectMaps<3> maps, T* __restrict__ o, long long nprob, int t, int S, int H, float qscale) {
  using C = Fwd<T, D>;
  constexpr int WT = C::WT, NT = C::NT, HOLD = C::HOLD;
  extern __shared__ unsigned char ltc_fwd_smem[];
  Setup<C> su;
  if (!su.init(ltc_fwd_smem, nprob, t, S, H, false)) return;
  const Warp<C>& w = su.w;
  const int lane = w.lane;
  const uint32_t own = su.own, own_bar = su.bars;
  Ring<C> ring{su.ring, su.bars};
  const int nkt = (t + WT - 1) / WT, nqt = (t + 15) / 16;
  const bool hold = nkt <= HOLD;   // every tile's logits in registers: the second walk reads v alone
  const int n = (hold ? 2 : 3) * nkt;
  uint32_t own_phase = 0;
  // visit i of a query tile, one tile each: the first walk k of key tile i; the second v of each tile, or
  // (logits not held) its k, then its v
  auto issue = [&](int i) {
    if (lane != 0) return;
    const int j = i - nkt, kt = i < nkt ? i : hold ? j : j / 2;
    const bool lv = i >= nkt && (hold || (j & 1));
    const uint32_t st = ring.stage(ring.n + i), bar = ring.bar(ring.n + i);
    fence_proxy_async();
    mbar_expect_tx(bar, C::WALK_TILE);
    w.load(&maps.m[lv ? 2 : 1], st, kt * WT, WT, bar);
  };
  // the logits of key tile kt (k in stage st) over all channels, keys past t at -inf
  auto logits = [&](uint32_t st, int kv, float (&s)[NT][4]) {
    qk_partial<T, NT>(s, own, 16, st, WT, (kv + 15) / 16, lane);
    if constexpr (C::TEAM > 1) {
      su.team_sync();   // every warp has read the partials before
      put_partial<NT>(su.red, C::RP, s, lane);
      su.team_sync();
      sum_partials<NT>(s, su.red0, C::WARP_BYTES, C::TEAM, C::RP, lane);
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (8 * j + 2 * (lane & 3) + (u & 1) >= kv) s[j][u] = -INFINITY;
  };

  for (int qt = 0; qt < nqt; ++qt) {
    __syncwarp();
    if (lane == 0) {
      fence_proxy_async();
      mbar_expect_tx(own_bar, C::OWN_TILE);
      w.load(&maps.m[0], own, 16 * qt, 16, own_bar);
    }
    for (int i = 0; i < C::NST - 1 && i < n; ++i) issue(i);
    mbar_wait(own_bar, own_phase);
    own_phase ^= 1;
    to_qf<T>(own, 16, 16, qscale, lane);
    __syncwarp();
    int i = 0;
    auto next = [&]() {   // the next visit's stage, once it has landed
      if (i + C::NST - 1 < n) issue(i + C::NST - 1);
      ring.wait(ring.n + i);
      return ring.stage(ring.n + i++);
    };
    float m[2] = {-INFINITY, -INFINITY}, ls[2] = {0.f, 0.f}, acc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    // the second walk on one tile: e = exp2(s - max), the fp32 sum of the unrounded e, round(e) V
    auto sum_pv = [&](const float (&s)[NT][4], uint32_t vt, int kv) {
      float e[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          e[j][u] = exp2f(s[j][u] - m[u >> 1]);
          ls[u >> 1] += e[j][u];
        }
      frag_product<T, NT>(acc, e, vt, WT, kv, lane);
    };
    if (hold) {
      float sh[HOLD][NT][4];
#pragma unroll
      for (int kt = 0; kt < HOLD; ++kt)
        if (kt < nkt) {
          logits(next(), min(WT, t - kt * WT), sh[kt]);
          row_max<NT>(sh[kt], m);
          __syncwarp();
        }
#pragma unroll
      for (int kt = 0; kt < HOLD; ++kt)
        if (kt < nkt) {
          sum_pv(sh[kt], next(), min(WT, t - kt * WT));
          __syncwarp();
        }
    } else {
      for (int kt = 0; kt < nkt; ++kt) {
        float s[NT][4];
        logits(next(), min(WT, t - kt * WT), s);
        row_max<NT>(s, m);
        __syncwarp();
      }
      for (int kt = 0; kt < nkt; ++kt) {
        float s[NT][4];
        logits(next(), min(WT, t - kt * WT), s);
        __syncwarp();   // k read: its stage takes the next visit
        sum_pv(s, next(), min(WT, t - kt * WT));
        __syncwarp();
      }
    }
    ring.n += n;
    float l[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] = ls[r] + __shfl_xor_sync(0xffffffffu, ls[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
    stage_out<T>(own, 16, acc, 1.f, l, lane);
    __syncwarp();
    w.store(o, own, 16 * qt);
  }
}

// ---- K6 ---------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(Bwd<T, D>::THREADS) temporal_long_tc_bwd_kernel(
    const __grid_constant__ DirectMaps<5> maps, T* __restrict__ dq, T* __restrict__ dk, T* __restrict__ dv,
    float* __restrict__ gstats, long long nprob, int t, int S, int H, float qscale, float scale) {
  using C = Bwd<T, D>;
  constexpr int WT = C::WT, NT = C::NT, HOLD = C::HOLD, TEAM = C::TEAM, RP = C::RP;
  extern __shared__ unsigned char ltc_bwd_smem[];
  Setup<C> su;
  if (!su.init(ltc_bwd_smem, nprob, t, S, H, gstats == nullptr)) return;
  const Warp<C>& w = su.w;
  const int lane = w.lane, gid = lane >> 2, tig = lane & 3;
  const uint32_t own0 = su.own, own1 = own0 + C::OWN_TILE, own_bar = su.bars;
  const int tp = (t + 15) / 16 * 16;
  const uint32_t dpart = su.team;
  // each query row's max, sum and delta: after the delta partials, or (past what shared memory holds) in gstats
  unsigned char* const gbase = smem_align_1024(ltc_bwd_smem);
  float* const st_m = gstats != nullptr ? gstats + su.prob * 3 * t
                                        : reinterpret_cast<float*>(gbase + (dpart + 4 * TEAM * 16 - smem_u32(gbase)));
  float* const st_l = st_m + (gstats != nullptr ? t : tp);
  float* const st_d = st_l + (gstats != nullptr ? t : tp);
  const uint32_t red_s = su.red, red_p = su.red + 4 * 16 * RP, red0_s = su.red0, red0_p = su.red0 + 4 * 16 * RP;
  Ring<C> ring{su.ring, su.bars};
  uint32_t own_phase = 0;
  const int nkt = (t + WT - 1) / WT;
  const bool hold = nkt <= HOLD;   // every key tile's logits in registers: no walk for the sum
  int i = 0, n = 0;
  auto next = [&](auto issue) {   // the next visit's stage, once it has landed
    if (i + C::NST - 1 < n) issue(i + C::NST - 1);
    ring.wait(ring.n + i);
    return ring.stage(ring.n + i++);
  };
  // the team's S (or dP) over all channels from this warp's partial x (own region `red`, the team's `red0`)
  auto full = [&](float (&x)[NT][4], uint32_t red, uint32_t red0) {
    if constexpr (TEAM > 1) {
      su.team_sync();
      put_partial<NT>(red, RP, x, lane);
      su.team_sync();
      sum_partials<NT>(x, red0, C::WARP_BYTES, TEAM, RP, lane);
    }
  };
  // S and dP together: one exchange of partials
  auto full2 = [&](float (&x)[NT][4], float (&y)[NT][4]) {
    if constexpr (TEAM > 1) {
      su.team_sync();
      put_partial<NT>(red_s, RP, x, lane);
      put_partial<NT>(red_p, RP, y, lane);
      su.team_sync();
      sum_partials<NT>(x, red0_s, C::WARP_BYTES, TEAM, RP, lane);
      sum_partials<NT>(y, red0_p, C::WARP_BYTES, TEAM, RP, lane);
    }
  };

  // query side: per 16-row tile of queries (q -> qf and g held), o for delta, then the key tiles walked for the
  // max, the sum (unless held) and dP, ds and dq
  for (int qt = 0; qt < (t + 15) / 16; ++qt) {
    n = 1 + (hold ? 2 : 3) * nkt;
    auto issue = [&](int v) {
      if (lane != 0) return;
      const uint32_t st = ring.stage(ring.n + v), bar = ring.bar(ring.n + v);
      fence_proxy_async();
      if (v == 0) {
        mbar_expect_tx(bar, C::WALK_TILE);
        w.load(&maps.m[3], st, 16 * qt, 16, bar);
        return;
      }
      const int j = v - 1, kt = j % nkt, pass = hold ? (j < nkt ? 0 : 2) : j / nkt;
      mbar_expect_tx(bar, (pass == 2 ? 2 : 1) * C::WALK_TILE);
      w.load(&maps.m[1], st, kt * WT, WT, bar);
      if (pass == 2) w.load(&maps.m[2], st + C::WALK_TILE, kt * WT, WT, bar);
    };
    __syncwarp();
    if (lane == 0) {
      fence_proxy_async();
      mbar_expect_tx(own_bar, 2 * C::OWN_TILE);
      w.load(&maps.m[0], own0, 16 * qt, 16, own_bar);
      w.load(&maps.m[4], own1, 16 * qt, 16, own_bar);
    }
    i = 0;
    for (int v = 0; v < C::NST - 1 && v < n; ++v) issue(v);
    mbar_wait(own_bar, own_phase);
    own_phase ^= 1;
    to_qf<T>(own0, 16, 16, qscale, lane);
    float delta[2];
    {  // delta = rowsum(g o): this warp's channels (row lane / 2, half the pieces a lane), then the team's in order
      const uint32_t so = next(issue);
      const int r = lane >> 1;
      float d = 0.f;
#pragma unroll
      for (int p = 0; p < C::PPW; ++p)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const uint32_t at = (uint32_t)(p * 16 * 128) + sw128(r, 4 * (lane & 1) + j);
          const uint4 gv = tt_ld128(own1 + at), ov = tt_ld128(so + at);
          const uint32_t* gw = reinterpret_cast<const uint32_t*>(&gv);
          const uint32_t* ow = reinterpret_cast<const uint32_t*>(&ov);
#pragma unroll
          for (int u = 0; u < 4; ++u)
            d += C::F32 ? __uint_as_float(gw[u]) * __uint_as_float(ow[u])
                        : tt_lo(gw[u]) * tt_lo(ow[u]) + tt_hi(gw[u]) * tt_hi(ow[u]);
        }
      d += __shfl_xor_sync(0xffffffffu, d, 1);
      if ((lane & 1) == 0) x3::stsf(dpart + 4 * (su.wt * 16 + r), d);
      su.team_sync();
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        delta[rr] = x3::lds(dpart + 4 * (gid + 8 * rr));
#pragma unroll
        for (int ww = 1; ww < TEAM; ++ww) delta[rr] += x3::lds(dpart + 4 * (ww * 16 + gid + 8 * rr));
      }
    }
    float m[2] = {-INFINITY, -INFINITY}, ls[2] = {0.f, 0.f}, l[2], acc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    auto logits = [&](uint32_t kst, int kv, float (&s)[NT][4]) {
      qk_partial<T, NT>(s, own0, 16, kst, WT, (kv + 15) / 16, lane);
      full(s, red_s, red0_s);
#pragma unroll
      for (int j = 0; j < NT; ++j)   // keys past t
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (8 * j + 2 * tig + (u & 1) >= kv) s[j][u] = -INFINITY;
    };
    auto add_sum = [&](const float (&s)[NT][4]) {
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int u = 0; u < 4; ++u) ls[u >> 1] += exp2f(s[j][u] - m[u >> 1]);
    };
    auto finish_sum = [&]() {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] = ls[r] + __shfl_xor_sync(0xffffffffu, ls[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      }
    };
    // dP = g V^T over all channels, ds = round(p (dP - delta)), dq += ds K
    auto ds_dq = [&](const float (&s)[NT][4], uint32_t st, int kv) {
      float dp[NT][4], ds[NT][4];
      qk_partial<T, NT>(dp, own1, 16, st + C::WALK_TILE, WT, (kv + 15) / 16, lane);
      full(dp, red_p, red0_p);
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          float p;
          ds[j][u] = 0.f;
          if (8 * j + 2 * tig + (u & 1) < kv)
            softmax_ds(s[j][u], m[u >> 1], l[u >> 1], dp[j][u], delta[u >> 1], p, ds[j][u]);
        }
      frag_product<T, NT>(acc, ds, st, WT, kv, lane);
    };
    if (hold) {
      float sh[HOLD][NT][4];
#pragma unroll
      for (int kt = 0; kt < HOLD; ++kt)
        if (kt < nkt) {
          logits(next(issue), min(WT, t - kt * WT), sh[kt]);
          row_max<NT>(sh[kt], m);
          __syncwarp();
        }
#pragma unroll
      for (int kt = 0; kt < HOLD; ++kt)
        if (kt < nkt) add_sum(sh[kt]);
      finish_sum();
#pragma unroll
      for (int kt = 0; kt < HOLD; ++kt)
        if (kt < nkt) {
          ds_dq(sh[kt], next(issue), min(WT, t - kt * WT));
          __syncwarp();
        }
    } else {
      for (int pass = 0; pass < 3; ++pass) {
        if (pass == 2) finish_sum();
        for (int kt = 0; kt < nkt; ++kt) {
          float s[NT][4];
          const uint32_t st = next(issue);
          logits(st, min(WT, t - kt * WT), s);
          if (pass == 0) row_max<NT>(s, m);
          if (pass == 1) add_sum(s);
          if (pass == 2) ds_dq(s, st, min(WT, t - kt * WT));
          __syncwarp();
        }
      }
    }
    ring.n += n;
    if (su.wt == 0 && tig == 0)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int q = 16 * qt + gid + 8 * r;
        if (q < t) st_m[q] = m[r], st_l[q] = l[r], st_d[q] = delta[r];
      }
    const float one[2] = {1.f, 1.f};
    stage_out<T>(own0, 16, acc, scale, one, lane);   // dq over the spent qf rows
    __syncwarp();
    w.store(dq, own0, 16 * qt);
  }
  su.team_sync();   // every query row's max, sum and delta

  // key side: per 16-row tile of keys (k, v held), one walk of the query tiles (q -> qf, g)
  n = nkt;
  auto issue_b = [&](int v) {
    if (lane != 0) return;
    const uint32_t st = ring.stage(ring.n + v), bar = ring.bar(ring.n + v);
    fence_proxy_async();
    mbar_expect_tx(bar, 2 * C::WALK_TILE);
    w.load(&maps.m[0], st, v * WT, WT, bar);
    w.load(&maps.m[4], st + C::WALK_TILE, v * WT, WT, bar);
  };
  for (int kb = 0; kb < (t + 15) / 16; ++kb) {
    __syncwarp();
    if (lane == 0) {
      fence_proxy_async();
      mbar_expect_tx(own_bar, 2 * C::OWN_TILE);
      w.load(&maps.m[1], own0, 16 * kb, 16, own_bar);
      w.load(&maps.m[2], own1, 16 * kb, 16, own_bar);
    }
    i = 0;
    for (int v = 0; v < C::NST - 1 && v < n; ++v) issue_b(v);
    mbar_wait(own_bar, own_phase);
    own_phase ^= 1;
    const int kv = min(16, t - 16 * kb);
    float ak[8][4], av[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int u = 0; u < 4; ++u) ak[j][u] = av[j][u] = 0.f;
    for (int qi = 0; qi < n; ++qi) {
      const uint32_t qst = next(issue_b), gst = qst + C::WALK_TILE;
      const int qv = min(WT, t - qi * WT);
      to_qf<T>(qst, WT, WT, qscale, lane);
      __syncwarp();
      float s[NT][4], dp[NT][4], p[NT][4], ds[NT][4];
      qk_partial<T, NT>(s, qst, WT, own0, 16, 1, lane);
      qk_partial<T, NT>(dp, gst, WT, own1, 16, 1, lane);
      full2(s, dp);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int q = qi * WT + gid + 8 * r;
        const bool row = gid + 8 * r < qv;
        const float mq = row ? st_m[q] : 0.f, lq = row ? st_l[q] : 1.f, dq_ = row ? st_d[q] : 0.f;
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int u = 2 * r; u < 2 * r + 2; ++u) {
            p[j][u] = ds[j][u] = 0.f;
            if (row && 8 * j + 2 * tig + (u & 1) < kv)
              softmax_ds(s[j][u], mq, lq, dp[j][u], dq_, p[j][u], ds[j][u]);
          }
      }
      if constexpr (!C::F32) {
        // p and ds as A operands (queries x keys), transposed by movmatrix: dv += round(p)^T g, dk += ds^T qf
        const uint32_t ap[4] = {tt_pack(p[0][0], p[0][1]), tt_pack(p[0][2], p[0][3]), tt_pack(p[1][0], p[1][1]),
                                tt_pack(p[1][2], p[1][3])};
        const uint32_t ad[4] = {tt_pack(ds[0][0], ds[0][1]), tt_pack(ds[0][2], ds[0][3]), tt_pack(ds[1][0], ds[1][1]),
                                tt_pack(ds[1][2], ds[1][3])};
        const uint32_t apt[4] = {tt_movt(ap[0]), tt_movt(ap[2]), tt_movt(ap[1]), tt_movt(ap[3])};
        const uint32_t adt[4] = {tt_movt(ad[0]), tt_movt(ad[2]), tt_movt(ad[1]), tt_movt(ad[3])};
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          uint32_t bg[4], bq[4];
          tt_ldsm_trans(bg, tt_b_addr(gst, 0, np, lane));
          tt_ldsm_trans(bq, tt_b_addr(qst, 0, np, lane));
          tt_mma(av[2 * np], apt, bg[0], bg[1]);
          tt_mma(av[2 * np + 1], apt, bg[2], bg[3]);
          tt_mma(ak[2 * np], adt, bq[0], bq[1]);
          tt_mma(ak[2 * np + 1], adt, bq[2], bq[3]);
        }
      } else {
        // p and ds through this warp's own tiles, read back transposed
        if constexpr (TEAM > 1) su.team_sync();   // every warp has read this warp's partials
        put_partial<NT>(red_s, RP, p, lane);
        put_partial<NT>(red_p, RP, ds, lane);
        __syncwarp();
        trans_product_f32(av, red_s, RP, gst, WT, qv, lane);
        trans_product_f32(ak, red_p, RP, qst, WT, qv, lane);
      }
      __syncwarp();
    }
    ring.n += n;
    const float one[2] = {1.f, 1.f};
    stage_out<T>(own0, 16, ak, kInvLog2E, one, lane);   // dk over the spent k rows
    stage_out<T>(own1, 16, av, 1.f, one, lane);         // dv over the spent v rows
    __syncwarp();
    w.store(dk, own0, 16 * kb);
    w.store(dv, own1, 16 * kb);
  }
}

// ---- D = 64 up to 64 frames: the problem resident ---------------------------------------
//
// Up to 64 frames a problem's tensors fit a block (K2's three, K6's five: 24 / 40 KB in bf16, twice that in
// fp32 at 64 channels), so one block of four warps takes one problem and TMA reads each row once: no tile is
// walked from device memory again. K2: warp w takes query tile w. K6: warp w takes query tile w (delta, the
// max, the sum from the held logits, dP, ds and dq), then, after a block barrier, key tile w (S and dP
// recomputed from the same resident operands, dk and dv). The products, the softmax and the bit-for-bit
// recompute are the walking kernels'; they only read their tiles in place. fp32 K6 up to 32 frames (16 or 32
// rows, a block of one or two warps, 24 / 51 KB: 9 / 4 blocks an SM) recomputes nothing: the query side
// leaves each tile of p and ds in shared memory and the key side reads them transposed (Res::XCH), so it
// sees the query side's bits by construction and runs 240 (t <= 16) rather than 336 split products a warp.

// TP rows held (48: up to 48 frames, three warps; 64: up to 64, four; fp32 K6 up to 32 frames: 16 or 32, one or
// two warps), a warp a 16-row tile
template <typename T, bool BWD, int TP_>
struct Res {
  using Elem = T;
  static constexpr bool F32 = sizeof(T) == 4;
  static constexpr int PPW = F32 ? 2 : 1, ELEM = 128 / (int)sizeof(T);
  static constexpr int TP = TP_, NT = 2, RP = 24;    // rows held; key n-tiles of a 16-row tile; partial pitch
  static constexpr int WARPS = TP / 16, THREADS = 32 * WARPS;
  static constexpr int NTENS = BWD ? 5 : 3;
  static constexpr int TENSOR = TP * 128 * PPW;            // bytes of one tensor's rows
  // fp32 K6 up to 32 frames: the query side leaves p and ds of the whole problem ([TP queries][XP floats] each)
  // for the key side, which reads them transposed instead of recomputing S and dP; XP = TP + 4 keeps those reads
  // free of bank conflicts
  static constexpr bool XCH = BWD && F32 && TP <= 32;
  static constexpr int XP = TP + 4;
  static constexpr int RED = NTENS * TENSOR;               // fp32 K6: each warp's p and ds tiles for their transposes
  static constexpr int RED_BYTES = BWD && F32 ? (XCH ? 2 * TP * XP * 4 / WARPS : 2 * 16 * RP * 4) : 0;
  static constexpr int STATS = RED + WARPS * RED_BYTES;    // each row's max, sum and delta
  static constexpr int BAR = STATS + 3 * TP * 4;
  static constexpr int SMEM = 1024 + BAR + 8;
};

// The problem of this block (its warp's lane, coordinates and rows) with every row of its C::NTENS tensors
// (q, k, v (, o, g)) landed in shared memory at base + i * C::TENSOR, panel p at + p * C::TP * 128 (frames past
// t zero); returns this warp's Warp.
template <class C>
__device__ __forceinline__ Warp<C> res_load(const CUtensorMap* maps, uint32_t base, uint32_t bar, int t, int S, int H) {
  Warp<C> w;
  const int h = (int)(blockIdx.x % H);
  const long long rest = blockIdx.x / H;
  w.s = (int)(rest % S);
  w.b = (int)(rest / S);
  w.c0 = h * 64;
  w.t = t;
  w.lane = threadIdx.x & 31;
  w.frame = (long long)S * H * 64;
  w.row0 = w.b * t * w.frame + (long long)w.s * H * 64 + w.c0;
  const int n16 = (t + 15) / 16;
  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    mbar_init_fence();
    mbar_expect_tx(bar, C::NTENS * n16 * 2048 * C::PPW);
    for (int x = 0; x < C::NTENS; ++x)
      for (int p = 0; p < C::PPW; ++p)
        for (int hh = 0; hh < n16; ++hh)
          tma_load_4d(base + (uint32_t)(x * C::TENSOR + p * C::TP * 128 + hh * 2048), &maps[x], bar,
                      w.c0 + p * C::ELEM, 16 * hh, w.s, w.b);
  }
  __syncthreads();
  mbar_wait(bar, 0);
  return w;
}

template <typename T, int TP>
__global__ void __launch_bounds__(Res<T, false, TP>::THREADS) temporal_long_res_kernel(
    const __grid_constant__ DirectMaps<3> maps, T* __restrict__ o, int t, int S, int H, float qscale) {
  using C = Res<T, false, TP>;
  constexpr int NT = C::NT, HOLD = TP / 16, tp = TP;
  extern __shared__ unsigned char ltc_res_fwd_smem[];
  const uint32_t base = smem_u32(smem_align_1024(ltc_res_fwd_smem));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, tig = lane & 3;
  const int n16 = (t + 15) / 16;
  const Warp<C> w = res_load<C>(maps.m, base, base + C::BAR, t, S, H);
  if (warp >= n16) return;
  const uint32_t qa = base + 16 * warp * 128, k_at = base + C::TENSOR, v_at = k_at + C::TENSOR;
  to_qf<T>(qa, 16, tp, qscale, lane);
  float m[2] = {-INFINITY, -INFINITY}, ls[2] = {0.f, 0.f}, l[2], acc[8][4], sh[HOLD][NT][4];
#pragma unroll
  for (int kt = 0; kt < HOLD; ++kt)
    if (kt < n16) {
      const int kv = min(16, t - 16 * kt);
      qk_partial<T, NT>(sh[kt], qa, tp, k_at + 16 * kt * 128, tp, 1, lane);
#pragma unroll
      for (int j = 0; j < NT; ++j)   // keys past t
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (8 * j + 2 * tig + (u & 1) >= kv) sh[kt][j][u] = -INFINITY;
      row_max<NT>(sh[kt], m);
    }
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll
  for (int kt = 0; kt < HOLD; ++kt)
    if (kt < n16) {   // e = exp2(s - max), the fp32 sum of the unrounded e, round(e) V
      float e[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          e[j][u] = exp2f(sh[kt][j][u] - m[u >> 1]);
          ls[u >> 1] += e[j][u];
        }
      frag_product<T, NT>(acc, e, v_at + 16 * kt * 128, tp, min(16, t - 16 * kt), lane);
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] = ls[r] + __shfl_xor_sync(0xffffffffu, ls[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  stage_out<T>(qa, tp, acc, 1.f, l, lane);   // O over this tile's qf rows
  __syncwarp();
  w.store(o, qa, 16 * warp, tp);
}

template <typename T, int TP>
__global__ void __launch_bounds__(Res<T, true, TP>::THREADS) temporal_long_res_bwd_kernel(
    const __grid_constant__ DirectMaps<5> maps, T* __restrict__ dq, T* __restrict__ dk, T* __restrict__ dv, int t,
    int S, int H, float qscale, float scale) {
  using C = Res<T, true, TP>;
  constexpr int NT = C::NT, RP = C::RP, HOLD = TP / 16, tp = TP;
  extern __shared__ unsigned char ltc_res_smem[];
  const uint32_t base = smem_u32(smem_align_1024(ltc_res_smem));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
  const int n16 = (t + 15) / 16;
  const Warp<C> w = res_load<C>(maps.m, base, base + C::BAR, t, S, H);
  const uint32_t q_at = base, k_at = q_at + C::TENSOR, v_at = k_at + C::TENSOR, o_at = v_at + C::TENSOR,
                 g_at = o_at + C::TENSOR;
  const uint32_t red_s = base + C::RED + warp * C::RED_BYTES, red_p = red_s + 16 * RP * 4;
  const uint32_t xp = base + C::RED, xds = xp + TP * C::XP * 4;   // C::XCH: the problem's p and ds
  const uint32_t st_m = base + C::STATS, st_l = st_m + 4 * tp, st_d = st_l + 4 * tp;
  const float one[2] = {1.f, 1.f};

  if (warp < n16) {  // query tile `warp`
    const int r0 = 16 * warp;
    const uint32_t qa = q_at + r0 * 128, ga = g_at + r0 * 128, oa = o_at + r0 * 128;
    to_qf<T>(qa, 16, tp, qscale, lane);
    float d = 0.f;  // delta = rowsum(g o): row lane / 2, half the pieces a lane
#pragma unroll
    for (int p = 0; p < C::PPW; ++p)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t at = (uint32_t)(p * tp * 128) + sw128(lane >> 1, 4 * (lane & 1) + j);
        const uint4 gv = tt_ld128(ga + at), ov = tt_ld128(oa + at);
        const uint32_t* gw = reinterpret_cast<const uint32_t*>(&gv);
        const uint32_t* ow = reinterpret_cast<const uint32_t*>(&ov);
#pragma unroll
        for (int u = 0; u < 4; ++u)
          d += C::F32 ? __uint_as_float(gw[u]) * __uint_as_float(ow[u])
                      : tt_lo(gw[u]) * tt_lo(ow[u]) + tt_hi(gw[u]) * tt_hi(ow[u]);
      }
    d += __shfl_xor_sync(0xffffffffu, d, 1);
    const float delta[2] = {__shfl_sync(0xffffffffu, d, 2 * gid), __shfl_sync(0xffffffffu, d, 2 * gid + 16)};
    __syncwarp();
    float m[2] = {-INFINITY, -INFINITY}, ls[2] = {0.f, 0.f}, l[2], acc[8][4], sh[HOLD][NT][4];
#pragma unroll
    for (int kt = 0; kt < HOLD; ++kt)
      if (kt < n16) {
        const int kv = min(16, t - 16 * kt);
        qk_partial<T, NT>(sh[kt], qa, tp, k_at + 16 * kt * 128, tp, 1, lane);
#pragma unroll
        for (int j = 0; j < NT; ++j)   // keys past t
#pragma unroll
          for (int u = 0; u < 4; ++u)
            if (8 * j + 2 * tig + (u & 1) >= kv) sh[kt][j][u] = -INFINITY;
        row_max<NT>(sh[kt], m);
      }
#pragma unroll
    for (int kt = 0; kt < HOLD; ++kt)
      if (kt < n16)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int u = 0; u < 4; ++u) ls[u >> 1] += exp2f(sh[kt][j][u] - m[u >> 1]);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] = ls[r] + __shfl_xor_sync(0xffffffffu, ls[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll
    for (int kt = 0; kt < HOLD; ++kt)
      if (kt < n16) {   // dP = g V^T, ds = round(p (dP - delta)), dq += ds K
        const int kv = min(16, t - 16 * kt);
        float dp[NT][4], ds[NT][4], p[NT][4];
        qk_partial<T, NT>(dp, ga, tp, v_at + 16 * kt * 128, tp, 1, lane);
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            p[j][u] = ds[j][u] = 0.f;
            if (8 * j + 2 * tig + (u & 1) < kv && r0 + gid + 4 * (u & 2) < t)
              softmax_ds(sh[kt][j][u], m[u >> 1], l[u >> 1], dp[j][u], delta[u >> 1], p[j][u], ds[j][u]);
          }
        if constexpr (C::XCH) {   // this tile of p and ds, for the key side
          put_partial<NT>(xp + 4 * (r0 * C::XP + 16 * kt), C::XP, p, lane);
          put_partial<NT>(xds + 4 * (r0 * C::XP + 16 * kt), C::XP, ds, lane);
        }
        frag_product<T, NT>(acc, ds, k_at + 16 * kt * 128, tp, kv, lane);
      }
    if (!C::XCH && tig == 0)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int q = r0 + gid + 8 * r;
        x3::stsf(st_m + 4 * q, m[r]);
        x3::stsf(st_l + 4 * q, l[r]);
        x3::stsf(st_d + 4 * q, delta[r]);
      }
    __syncwarp();   // o's rows read: dq goes over them
    stage_out<T>(oa, tp, acc, scale, one, lane);
    __syncwarp();
    w.store(dq, oa, r0, tp);
  }
  __syncthreads();   // every row's statistics and qf; every read of k and v by the query tiles

  if (warp < n16) {  // key tile `warp`
    const int kv = min(16, t - 16 * warp);
    const uint32_t ka = k_at + 16 * warp * 128, va = v_at + 16 * warp * 128;
    float ak[8][4], av[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int u = 0; u < 4; ++u) ak[j][u] = av[j][u] = 0.f;
    for (int qi = 0; qi < n16; ++qi) {
      const int qv = min(16, t - 16 * qi);
      const uint32_t qa = q_at + 16 * qi * 128, ga = g_at + 16 * qi * 128;
      if constexpr (C::XCH) {   // p and ds as the query side formed them, read transposed
        const uint32_t at = 4 * (16 * qi * C::XP + 16 * warp);
        trans_product_f32(av, xp + at, C::XP, ga, tp, qv, lane);
        trans_product_f32(ak, xds + at, C::XP, qa, tp, qv, lane);
        continue;
      }
      float s[NT][4], dp[NT][4], p[NT][4], ds[NT][4];
      qk_partial<T, NT>(s, qa, tp, ka, tp, 1, lane);
      qk_partial<T, NT>(dp, ga, tp, va, tp, 1, lane);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int q = 16 * qi + gid + 8 * r;
        const bool row = gid + 8 * r < qv;
        const float mq = row ? x3::lds(st_m + 4 * q) : 0.f, lq = row ? x3::lds(st_l + 4 * q) : 1.f,
                    dl = row ? x3::lds(st_d + 4 * q) : 0.f;
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int u = 2 * r; u < 2 * r + 2; ++u) {
            p[j][u] = ds[j][u] = 0.f;
            if (row && 8 * j + 2 * tig + (u & 1) < kv) softmax_ds(s[j][u], mq, lq, dp[j][u], dl, p[j][u], ds[j][u]);
          }
      }
      if constexpr (!C::F32) {
        const uint32_t ap[4] = {tt_pack(p[0][0], p[0][1]), tt_pack(p[0][2], p[0][3]), tt_pack(p[1][0], p[1][1]),
                                tt_pack(p[1][2], p[1][3])};
        const uint32_t ad[4] = {tt_pack(ds[0][0], ds[0][1]), tt_pack(ds[0][2], ds[0][3]), tt_pack(ds[1][0], ds[1][1]),
                                tt_pack(ds[1][2], ds[1][3])};
        const uint32_t apt[4] = {tt_movt(ap[0]), tt_movt(ap[2]), tt_movt(ap[1]), tt_movt(ap[3])};
        const uint32_t adt[4] = {tt_movt(ad[0]), tt_movt(ad[2]), tt_movt(ad[1]), tt_movt(ad[3])};
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          uint32_t bg[4], bq[4];
          tt_ldsm_trans(bg, tt_b_addr(ga, 0, np, lane));
          tt_ldsm_trans(bq, tt_b_addr(qa, 0, np, lane));
          tt_mma(av[2 * np], apt, bg[0], bg[1]);
          tt_mma(av[2 * np + 1], apt, bg[2], bg[3]);
          tt_mma(ak[2 * np], adt, bq[0], bq[1]);
          tt_mma(ak[2 * np + 1], adt, bq[2], bq[3]);
        }
      } else {
        put_partial<NT>(red_s, RP, p, lane);
        put_partial<NT>(red_p, RP, ds, lane);
        __syncwarp();
        trans_product_f32(av, red_s, RP, ga, tp, qv, lane);
        trans_product_f32(ak, red_p, RP, qa, tp, qv, lane);
        __syncwarp();
      }
    }
    stage_out<T>(ka, tp, ak, kInvLog2E, one, lane);   // dk over this tile's k rows, which no other warp reads now
    stage_out<T>(va, tp, av, 1.f, one, lane);
    __syncwarp();
    w.store(dk, ka, 16 * warp, tp);
    w.store(dv, va, 16 * warp, tp);
  }
}

// ---- host -------------------------------------------------------------------

// (channel H * D, frame t, token S, video nvid) over a contiguous [(nvid t), S, H * D] tensor, boxes of one
// 128-byte panel x 16 frames
inline int panel_map(const void* x, bool f32, int nvid, int t, int S, int H, int D, CUtensorMap* map) {
  const unsigned long long item = f32 ? 4 : 2, row = item * H * D;
  const cuuint64_t dims[4] = {(cuuint64_t)H * D, (cuuint64_t)t, (cuuint64_t)S, (cuuint64_t)nvid};
  const cuuint64_t strides[3] = {row * S, row, row * S * t};
  const cuuint32_t box[4] = {(cuuint32_t)(128 / item), 16, 1, 1};
  return tma_tiled_map(f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                       CU_TENSOR_MAP_SWIZZLE_128B, x, 4, dims, strides, box, map);
}

template <typename T, int D>
int fwd(const void* q, const void* k, const void* v, void* o, long long nprob, int nvid, int t, int S, int H,
        float qscale, cudaStream_t stream) {
  using C = Fwd<T, D>;
  const void* const in[3] = {q, k, v};
  const int smem = C::smem(t, false);
  auto kern = temporal_long_tc_kernel<T, D>;
  static const cudaError_t attr = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
  if (attr != cudaSuccess) return (int)attr;
  DirectMaps<3> maps;
  for (int i = 0; i < 3; ++i)
    if (const int rc = panel_map(in[i], C::F32, nvid, t, S, H, D, &maps.m[i])) return rc;
  const long long blocks = (nprob + C::TEAMS - 1) / C::TEAMS;
  kern<<<(unsigned)blocks, C::THREADS, smem, stream>>>(maps, static_cast<T*>(o), nprob, t, S, H, qscale);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int bwd(const void* q, const void* k, const void* v, const void* o, const void* g, void* dq, void* dk, void* dv,
        void* work, long long nprob, int nvid, int t, int S, int H, float qscale, float scale, cudaStream_t stream) {
  using C = Bwd<T, D>;
  const void* const in[5] = {q, k, v, o, g};
  // the query rows' statistics in shared memory while they fit (fp32 at D = 512: up to 784 frames), else in work
  const bool stats = C::smem(t, true) <= kSmemMax;
  if (!stats && work == nullptr) return kErrBadArgument;
  const int smem = C::smem(t, stats);
  auto kern = temporal_long_tc_bwd_kernel<T, D>;
  static const cudaError_t attr = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
  if (attr != cudaSuccess) return (int)attr;
  DirectMaps<5> maps;
  for (int i = 0; i < 5; ++i)
    if (const int rc = panel_map(in[i], C::F32, nvid, t, S, H, D, &maps.m[i])) return rc;
  const long long blocks = (nprob + C::TEAMS - 1) / C::TEAMS;
  kern<<<(unsigned)blocks, C::THREADS, smem, stream>>>(maps, static_cast<T*>(dq), static_cast<T*>(dk),
                                                       static_cast<T*>(dv), stats ? nullptr : static_cast<float*>(work),
                                                       nprob, t, S, H, qscale, scale);
  return (int)cudaGetLastError();
}

template <typename T, int TP>
int fwd_res(const void* q, const void* k, const void* v, void* o, long long nprob, int nvid, int t, int S, int H,
            float qscale, cudaStream_t stream) {
  using C = Res<T, false, TP>;
  const void* const in[3] = {q, k, v};
  auto kern = temporal_long_res_kernel<T, TP>;
  static const cudaError_t attr = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (attr != cudaSuccess) return (int)attr;
  DirectMaps<3> maps;
  for (int i = 0; i < 3; ++i)
    if (const int rc = panel_map(in[i], C::F32, nvid, t, S, H, 64, &maps.m[i])) return rc;
  kern<<<(unsigned)nprob, C::THREADS, C::SMEM, stream>>>(maps, static_cast<T*>(o), t, S, H, qscale);
  return (int)cudaGetLastError();
}

template <typename T, int TP>
int bwd_res(const void* q, const void* k, const void* v, const void* o, const void* g, void* dq, void* dk, void* dv,
            long long nprob, int nvid, int t, int S, int H, float qscale, float scale, cudaStream_t stream) {
  using C = Res<T, true, TP>;
  const void* const in[5] = {q, k, v, o, g};
  auto kern = temporal_long_res_bwd_kernel<T, TP>;
  static const cudaError_t attr = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (attr != cudaSuccess) return (int)attr;
  DirectMaps<5> maps;
  for (int i = 0; i < 5; ++i)
    if (const int rc = panel_map(in[i], C::F32, nvid, t, S, H, 64, &maps.m[i])) return rc;
  kern<<<(unsigned)nprob, C::THREADS, C::SMEM, stream>>>(maps, static_cast<T*>(dq), static_cast<T*>(dk),
                                                         static_cast<T*>(dv), t, S, H, qscale, scale);
  return (int)cudaGetLastError();
}

}  // namespace ltc

// K2 past 32 frames at D = 64 and 512, bf16 and fp32 (bases 16-byte aligned)
int launch_temporal_long_tc(int dtype, int D, const void* q, const void* k, const void* v, void* o, int nvid, int t,
                            int S, int H, float qscale, cudaStream_t stream) {
  const long long nprob = (long long)nvid * S * H;
  if (nprob > 0x7fffffffLL || t <= 32 || !aligned16({q, k, v, o})) return kErrBadArgument;
  using bf = __nv_bfloat16;
  const bool b16 = dtype == kBFloat16;
  if (!b16 && dtype != kFloat32) return kErrUnsupported;
  if (D == 64 && t <= 64) {  // the problem resident: 48 rows up to 48 frames, else 64
    if (t <= 48)
      return b16 ? ltc::fwd_res<bf, 48>(q, k, v, o, nprob, nvid, t, S, H, qscale, stream)
                 : ltc::fwd_res<float, 48>(q, k, v, o, nprob, nvid, t, S, H, qscale, stream);
    return b16 ? ltc::fwd_res<bf, 64>(q, k, v, o, nprob, nvid, t, S, H, qscale, stream)
               : ltc::fwd_res<float, 64>(q, k, v, o, nprob, nvid, t, S, H, qscale, stream);
  }
  if (D == 64)
    return b16 ? ltc::fwd<bf, 64>(q, k, v, o, nprob, nvid, t, S, H, qscale, stream)
               : ltc::fwd<float, 64>(q, k, v, o, nprob, nvid, t, S, H, qscale, stream);
  if (D == kWideD)
    return b16 ? ltc::fwd<bf, kWideD>(q, k, v, o, nprob, nvid, t, S, H, qscale, stream)
               : ltc::fwd<float, kWideD>(q, k, v, o, nprob, nvid, t, S, H, qscale, stream);
  return kErrUnsupported;
}

// K6 past 32 frames at D = 64 and 512, bf16 and fp32 (bases 16-byte aligned)
int launch_temporal_bwd_long_tc(int dtype, int D, const void* q, const void* k, const void* v, const void* o,
                                const void* g, void* dq, void* dk, void* dv, void* work, int nvid, int t, int S, int H,
                                float qscale, float scale, cudaStream_t stream) {
  const long long nprob = (long long)nvid * S * H;
  if (nprob > 0x7fffffffLL || t <= 32 || !aligned16({q, k, v, o, g, dq, dk, dv})) return kErrBadArgument;
  using bf = __nv_bfloat16;
  const bool b16 = dtype == kBFloat16;
  if (!b16 && dtype != kFloat32) return kErrUnsupported;
#define VS_LTC_BWD(T, DD) ltc::bwd<T, DD>(q, k, v, o, g, dq, dk, dv, work, nprob, nvid, t, S, H, qscale, scale, stream)
  if (D == 64 && t <= 64) {  // the problem resident: 48 rows up to 48 frames, else 64
    if (t <= 48)
      return b16 ? ltc::bwd_res<bf, 48>(q, k, v, o, g, dq, dk, dv, nprob, nvid, t, S, H, qscale, scale, stream)
                 : ltc::bwd_res<float, 48>(q, k, v, o, g, dq, dk, dv, nprob, nvid, t, S, H, qscale, scale, stream);
    return b16 ? ltc::bwd_res<bf, 64>(q, k, v, o, g, dq, dk, dv, nprob, nvid, t, S, H, qscale, scale, stream)
               : ltc::bwd_res<float, 64>(q, k, v, o, g, dq, dk, dv, nprob, nvid, t, S, H, qscale, scale, stream);
  }
  if (D == 64) return b16 ? VS_LTC_BWD(bf, 64) : VS_LTC_BWD(float, 64);
  if (D == kWideD) return b16 ? VS_LTC_BWD(bf, kWideD) : VS_LTC_BWD(float, kWideD);
#undef VS_LTC_BWD
  return kErrUnsupported;
}

// K2 at D = 512 up to 32 frames, bf16 and fp32 (bases 16-byte aligned): the team kernel, as past them (the C entry
// of temporal_attention.cu sends it the t from its crossover with the wide kernel)
int launch_temporal_short_tc(int dtype, const void* q, const void* k, const void* v, void* o, int nvid, int t, int S,
                             int H, float qscale, cudaStream_t stream) {
  const long long nprob = (long long)nvid * S * H;
  if (nprob > 0x7fffffffLL || t > 32 || !aligned16({q, k, v, o})) return kErrBadArgument;
  if (dtype == kBFloat16)
    return ltc::fwd<__nv_bfloat16, kWideD>(q, k, v, o, nprob, nvid, t, S, H, qscale, stream);
  if (dtype == kFloat32) return ltc::fwd<float, kWideD>(q, k, v, o, nprob, nvid, t, S, H, qscale, stream);
  return kErrUnsupported;
}

// K6 in fp32 at D = 64 from 2 to 32 frames (bases 16-byte aligned): the problem resident, 16 rows and one warp up to 16
// frames, 32 rows and two warps past them, p and ds handed to the key side through shared memory
int launch_temporal_bwd_short_tc(const void* q, const void* k, const void* v, const void* o, const void* g, void* dq,
                                 void* dk, void* dv, int nvid, int t, int S, int H, float qscale, float scale,
                                 cudaStream_t stream) {
  const long long nprob = (long long)nvid * S * H;
  if (nprob > 0x7fffffffLL || t > 32 || !aligned16({q, k, v, o, g, dq, dk, dv})) return kErrBadArgument;
  if (t <= 16) return ltc::bwd_res<float, 16>(q, k, v, o, g, dq, dk, dv, nprob, nvid, t, S, H, qscale, scale, stream);
  return ltc::bwd_res<float, 32>(q, k, v, o, g, dq, dk, dv, nprob, nvid, t, S, H, qscale, scale, stream);
}

}  // namespace vs
