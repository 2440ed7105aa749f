"""Device time of K1 (flash_attention_packed), K11 (matmul_bias), K4
(temporal_conv_1x1), the GroupNorm forward, K2 (temporal_attention_direct)
and its backward K6, the flash backwards K5 and K13, the normalise-first
route of K1 and K3, and the GroupNorm backward at the main paths'
shapes, beside the one PyTorch call for the same function, on one CUDA card.

    python3 -m vidseg_diffusion_tpu_torch.scripts.time_kernels [--only k11,k1,k4,gn,k2,k6,k5,k13,nf,gnb,k5w,k6w,x3,
                                                                       k5d16,fp32,long,short,x3d64,x3mm,x3k1,x3k4,
                                                                       mem]
                                                              [--root CHECKOUT]

Each call is captured 20 times into a CUDA graph and the replay is timed with
CUDA events, so the readings are device time without the host's launch cost
(chip_smoke.py's kernels phase times launches back to back from Python, and
below ~0.1 ms reads the host). Both kernels pick their shape from the
problem's (K11 a 192- or 128-row tile, K1 two warpgroups with 128-key tiles
for long key walks or one warpgroup with 64-key tiles); each case is timed
under that choice. K4 is timed at chip_smoke.py's K4 shapes (the UNet and VAE
time_stacks, the VAE's 3-channel conv_out_time_mix, and its dx + dW + db
backward) beside F.conv3d on the [B, Cin, T, M, 1] view (its backward
through autograd.grad, which a graph cannot capture: both backward rows are
CUDA events around back-to-back calls of over a millisecond); the GroupNorm forward as the paths call it
(group_norm under no_grad, whichever kernels its route launches) at
chip_smoke.py's GroupNorm sites beside F.group_norm (+ F.silu) on the
channels-last view. K2 is timed at chip_smoke.py's four temporal shapes (two
videos of 14 frames, [28, s, H, 64]) beside SDPA on the canonical view of the
same tensors ([b, s, H, t, 64], strided, no copy); K6 at the same shapes beside
SDPA's backward through autograd.grad, both with CUDA events around
back-to-back calls as K4's backward rows are (K6 also as a CUDA graph: its
device time). Each row carries its bound (bytes over 3.35 TB/s or
operations over 989 TFLOP/s, whichever is larger). Each output is also held
to the plain version (bf16 steps at max |plain|, relative RMS error; K1's
LSE too). K5 and K13 (`--only k5,k13`) are timed as CUDA graphs beside SDPA's
backward through autograd.grad, whose device time is the sum of its kernels in
torch.profiler (a graph cannot capture it); their bound counts the five
products (10 L^2 D flops), and the line also gives the flops the kernels
execute (S and dP recomputed: 14 L^2 D for K5, 18 L^2 D for K13). The
normalise-first sites (`nf`: NF_SHAPES, the SD 2.1, SDXL and SD 512x512
cross-attention, CLIP ViT-H and ViT-L/14) are graphs beside SDPA and beside the
kernel that streams the keys from device memory (what ran there before the
resident kernels), each held to mha_reference, with the route its launch
reported (`resident_launches`). The GroupNorm backward
(`gnb`) runs as GroupNormFn's backward calls it (the slab kernel or K9 + K10,
by route) at the GroupNorm sites and the backward's cluster sites, beside the
library backward (autograd.grad through F.group_norm (+ F.silu), profiled),
with a bound of x and dy read and dx written (the GroupNorm sites also of
svd.yaml's first stage trained on a 7-frame clip: its VideoDecoder's mid and
up levels); at a slab site K9 + K10 also,
at a K9 + K10 site each launch also alone, and the slab kernel where a
cluster would hold the slab but the route sends its many items to K9 + K10. The
backwards at one 512-dim head, on the 7-frame training clip of svd.yaml's
first stage: K5 there (`k5w`: K13's kernels on the packed strides, [7, 5824,
1 x 512], a CUDA graph beside SDPA's backward, profiled) and K6 (`k6w`: [t,
5824, 1, 512] at t = 7 and 14, at 17, 24 and 32 (the 32-row tile) and at 48
(the long route), bf16 and fp32, as CUDA events and a graph beside
SDPA's backward on the canonical view, profiled, whose backend is named; then
other t up to 28 as a graph; a call a checkout refuses prints as refused). K2
and K6 past 32 frames (`long`: one video of 33, 40, 48 and 64 frames at the
UNet's ds1 site [t, 5824, 5, 64] and of 48 and 64 at the time mix [t, 5824, 1,
512], both dtypes; graphs beside SDPA and its backward and the bound). Up to 32
frames on the same file's kernels (`short`): K6 in fp32 at the UNet's ds1 site
[2t, 5824, 5, 64] and K2 at the time mix [t, 5824, 1, 512] in both dtypes,
every t from 1 to 32 as a graph, and at t = 7, 14, 17, 24 and 32 beside SDPA
(K6: its backward, profiled) and the bound, held to the plain version; below
the C entry's crossover K2 runs the wide kernel, as the printed routes say. K5 and
K13 at D = 16 (`k5d16`: svd_tiny.yaml's ds1 on a B = 2 slice and ds2, K13 at
[2, 2, 1024, 16], both dtypes; graphs beside SDPA's backward, the exp2 floor
beside the bound). The
kernels these replaced (the wide kernel at every t, the FMA kernels at bf16
D = 16) are the parent commit's: time them with `--root`. The
fp32 routes at D = 64 (`fp32`: K1 at ds1, B = 2 and 28, K5 at ds1, K2 and K6 at
[28, 5824, 5, 64], K4 at the UNet's ds1 time_stack) beside the library call in
full fp32.
The fp32 attention at D = 512 on split TF32 products (`x3`): K1 at one 512-dim
head ([7, 5824, 1 x 512] and [14, ...], the VideoDecoder's attn2), its
backward K5 there on the 7-frame training clip, and K3 / K13 at [2, 1, 64,
512] (ae_grad's mid attention), each a CUDA graph beside SDPA (its backend
named; the backward profiled), held to the plain version and to the plain
version in float64 (relative RMS). fp32 library calls run with TF32 off (full
fp32, as the kernels compute), and an fp32 row's bound by operations is flops
over 165 TFLOP/s (three TF32 products at 495), bf16's over 989. K5 in fp32 at
D = 64 and K11 in fp32 on split-TF32 products (`x3d64`: K5 at ds1 on a B = 2
slice, at the training batch of 28, at ds2 and at the four spatial sites of
chip_smoke.py's train_grad phase; `x3mm`: K11 at every fp32 shape chip_smoke.py
times, the SVD projections and the kernel's edges): CUDA graphs beside the
library call in full fp32 (SDPA's backward profiled; F.linear) and the bound,
held to the plain version and to it in float64 (relative RMS) where the plain
version fits the card, with the route counters one call moved; with `--root`
the parent's kernels at the same shapes (FMA kernels there). K1 / K3 in fp32
at D = 64 and K4 in fp32 on split-TF32 products (`x3k1`: K1 at ds1 on a B = 2
slice, the CFG batch, ds2, ds4, mid, SD 2.1's 77-key cross-attention and the
train_grad phase's four sites, K3 at ViT-L/14's [2, 16, 257, 64], and the fp32
attention left on the FMA kernel, K3 at D = 80 (CLIP ViT-H) and K3 / K1 at D =
16; `x3k4`: K4 at the UNet's ds1, ds2 and ds4 time_stacks, the VAE decoder's
448 x 832 frames, dx at ds4 and the edges T = 1 and Cin = 1032) the same way,
beside SDPA / F.conv3d (dx: torch.nn.grad.conv3d_input) in full fp32. `mem` (not in
the default) reads the peak device memory of the fp32 full-width SVD UNet's
forward and loss backward at chip_smoke.py's unet and train_grad shapes, and
what ops/relayout.py's weight-copy caches hold. `--root` times
the kernels of another checkout (a parent commit unpacked beside this one) with
this script, so two versions compare in one call.
Prints the card's name and power limit
and ptxas's register / spill lines for the wgmma, the mma.sync flash and the
temporal-attention kernels.
"""

import argparse
import math
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

# (M, K, N, bias): the projections of the SVD and SD 2.1 paths (ds1 to_q and
# to_out, ds2, ds4 to_out, mid; one-token and 77-token context products) and
# the wgmma kernel's edges
MM_SHAPES = [(163072, 320, 320, False), (163072, 320, 320, True), (40768, 640, 640, False),
             (10192, 1280, 1280, True), (2548, 1280, 1280, False), (28, 1024, 320, False),
             (2156, 1024, 320, False), (2156, 1024, 1280, False), (193, 320, 168, True)]
# (B, Lq, Lk, H): spatial self-attention per level (ds1 on a B = 2 slice and at
# the CFG batch of 28), the SD 2.1 cross-attention's 77 keys
ATTN_SHAPES = [(2, 5824, 5824, 5), (28, 5824, 5824, 5), (28, 1456, 1456, 10), (28, 364, 364, 20),
               (28, 91, 91, 20), (28, 5824, 77, 5), (28, 91, 77, 20)]
# (B, T, M, Cin, Cout, backward): the UNet time_stack per level (two videos of 14
# frames), the VAE decoder's per level and its conv_out_time_mix (decoding_t 7),
# the training step's dx + dW + db at ds1 and ds4
TCONV_SHAPES = [(2, 14, 5824, 320, 320, False), (2, 14, 1456, 640, 640, False), (2, 14, 364, 1280, 1280, False),
                (2, 14, 91, 1280, 1280, False), (1, 7, 5824, 512, 512, False), (1, 7, 23296, 512, 512, False),
                (1, 7, 93184, 256, 256, False), (1, 7, 372736, 128, 128, False), (1, 7, 372736, 3, 3, False),
                (2, 14, 5824, 320, 320, True), (2, 14, 364, 1280, 1280, True)]
# (B, L, H): K5 at the training path's spatial sites (ds1 on a B = 2 slice and at
# the training batch of 2 x 14 frames)
K5_SHAPES = [(2, 5824, 5), (28, 5824, 5), (28, 1456, 10), (28, 364, 20), (28, 91, 20)]
# (B, H, Lq, Lk, D): K13 at the autoencoder step's VAE mid attention and off the tiles
K13_SHAPES = [(2, 1, 5824, 5824, 512), (1, 1, 130, 77, 512)]
# (B, L): K5 at one 512-dim head, the VideoAttnBlock's attn2 on the 7-frame training clip
K5_WIDE_SHAPES = [(7, 5824)]
# (t, S): K6 at D = 512, the VideoAttnBlock's time mix on that clip and on a 14-latent decode, the 32-row
# tile at 17, 24 and 32 frames and the frame-walking kernel at 48; the other t its tensor-core kernels take
# (up to 32 frames), timed beside the wide kernel to route them
K6_WIDE_SHAPES = [(7, 5824), (14, 5824), (17, 5824), (24, 5824), (32, 5824), (48, 5824)]
K6_ROUTE_TS = (1, 2, 3, 4, 5, 6, 8, 9, 10, 12, 16, 20, 28)
# (t, S, H, D): K2 and K6 past 32 frames (the tensor-core kernels of temporal_attention_long_tc.cu): the
# UNet's ds1 temporal site (long_video's t = 40) and the VideoAttnBlock's time mix, one video
LONG_SHAPES = [(33, 5824, 5, 64), (40, 5824, 5, 64), (48, 5824, 5, 64), (64, 5824, 5, 64), (48, 5824, 1, 512),
               (64, 5824, 1, 512)]
# up to 32 frames on the tensor-core kernels of temporal_attention_long_tc.cu (`short`): K6 in fp32 at the UNet's
# ds1 temporal site, two videos [2t, 5824, 5, 64], and K2 at the time mix's one 512-dim head, one video [t, 5824, 1,
# 512] in both dtypes; SHORT_TS beside the library call, the bound and the plain version, every other t up to 32
# as a graph alone (the crossover with the wide kernel, whose times are the parent's: `--root`)
SHORT_TS = (7, 14, 17, 24, 32)
# K5 at D = 16 (svd_tiny.yaml's heads): (B, L, H) at ds1 on a B = 2 slice and at ds2; K13 there (B, H, L)
K5_D16_SHAPES, K13_D16_SHAPE = [(2, 5824, 2), (28, 1456, 4)], (2, 2, 1024)
# the fp32 routes at D = 64 (step 0 of the fp32 table cells): K1 at ds1 (a B = 2 slice and the CFG batch),
# K5 at ds1 (B = 2), K2 and K6 at ds1 (t = 14, two videos), K4 at the UNet's ds1 time_stack
FP32_K1_SHAPES, FP32_K5_SHAPE, FP32_TEMPORAL_SHAPE, FP32_K4_SHAPE = (
    [(2, 5824, 5), (28, 5824, 5)], (2, 5824, 5), (5824, 5), (2, 14, 5824, 320, 320))
# K5 in fp32 at D = 64 on split TF32 (`x3d64`): (B, L, H) at ds1 on a B = 2 slice, at the training batch of 28,
# at ds2, and the train_grad phase's spatial sites (two 2-frame videos of 16 x 16 latents: 256, 64, 16, 4 tokens)
X3_K5_SHAPES = [(2, 5824, 5), (28, 5824, 5), (28, 1456, 10), (4, 256, 5), (4, 64, 10), (4, 16, 20), (4, 4, 20)]
# K11 in fp32 on split TF32 (`x3mm`): (M, K, N, bias): chip_smoke.py's fp32 rows (ds2 with a bias, SD to_k),
# the SVD projections and the kernel's edges (an N off the 160-wide tile, a K off the 32-channel slice)
# K1 / K3 in fp32 (`x3k1`): (layout, B, Lq, Lk, H, D): at D = 64 on split TF32, K1 at ds1 (a B = 2 slice and the
# CFG batch), ds2, ds4, mid, SD 2.1's 77-key cross-attention at ds1 and the train_grad phase's spatial sites (256, 64,
# 16, 4 tokens), K3 on its bhld strides at ViT-L/14's heads; on the FMA kernel, K3 at D = 80 (CLIP ViT-H) and K3 / K1
# at D = 16 (the tiny configs: CLIP [1, 4, 257, 16], K13's [2, 2, 1024, 16], ds1 on a B = 2 slice)
X3_K1_SHAPES = [("blhd", 2, 5824, 5824, 5, 64), ("blhd", 28, 5824, 5824, 5, 64), ("blhd", 28, 1456, 1456, 10, 64),
                ("blhd", 28, 364, 364, 20, 64), ("blhd", 28, 91, 91, 20, 64), ("blhd", 28, 5824, 77, 5, 64),
                ("blhd", 4, 256, 256, 5, 64), ("blhd", 4, 64, 64, 10, 64), ("blhd", 4, 16, 16, 20, 64),
                ("blhd", 4, 4, 4, 20, 64), ("bhld", 2, 257, 257, 16, 64), ("bhld", 1, 257, 257, 16, 80),
                ("bhld", 1, 257, 257, 4, 16), ("bhld", 2, 1024, 1024, 2, 16), ("blhd", 2, 5824, 5824, 2, 16)]
# K4 in fp32 on split TF32 (`x3k4`): (B, T, M, Cin, Cout, kt, dx): the UNet's time_stacks at ds1, ds2 and ds4, the
# VAE decoder's at 448 x 832 (one 7-frame clip, 128 channels), dx at ds4, and the edges: one frame, a last
# 32-channel slice of 8 (Cin = 1032)
X3_K4_SHAPES = [(2, 14, 5824, 320, 320, 3, False), (2, 14, 1456, 640, 640, 3, False),
                (2, 14, 364, 1280, 1280, 3, False), (1, 7, 372736, 128, 128, 3, False),
                (2, 14, 364, 1280, 1280, 3, True), (2, 1, 5824, 320, 320, 3, False),
                (2, 2, 1456, 1032, 640, 3, False)]
X3_MM_SHAPES = [(40768, 640, 640, True), (2156, 1024, 320, False), (163072, 320, 320, False),
                (163072, 320, 320, True), (10192, 1280, 1280, True), (2548, 1280, 1280, False), (28, 1024, 320, False),
                (2156, 1024, 1280, False), (193, 320, 168, True), (2156, 1032, 640, True)]
# normalise-first sites: (layout, B, Lq, Lk, H, D): SD 2.1's cross-attention at ds1 and ds2 (the CFG batch of
# 28 frames), the SDXL base's at 1024x1024, SD 2.1's at 512x512 (null-text inversion, T5, the demo), CLIP ViT-H
# (the SVD conditioner), CLIP ViT-L/14 (the safety filter, two images)
NF_SHAPES = [("blhd", 28, 5824, 77, 5, 64), ("blhd", 28, 1456, 77, 10, 64), ("blhd", 2, 4096, 77, 10, 64),
             ("blhd", 2, 1024, 77, 20, 64), ("blhd", 2, 4096, 77, 5, 64), ("blhd", 2, 1024, 77, 10, 64),
             ("bhld", 1, 257, 257, 16, 80), ("bhld", 2, 257, 257, 16, 64)]
# (S, H): the temporal self-attention sites per level (t = 14 frames, 2 videos)
TEMPORAL_SHAPES = [(5824, 5), (1456, 10), (364, 20), (91, 20)]
# (shape, dtype, silu, eps): chip_smoke.py's GroupNorm sites
GN_SITES = [((28, 56, 104, 320), "bf16", True, 1e-5), ((28, 56, 104, 320), "bf16", False, 1e-6),
            ((28, 56, 104, 960), "bf16", True, 1e-5), ((28, 28, 52, 640), "bf16", True, 1e-5),
            ((28, 14, 26, 1280), "bf16", True, 1e-5),
            ((28, 14, 26, 1280), "bf16", False, 1e-6), ((28, 7, 13, 1280), "bf16", False, 1e-6),
            ((28, 7, 13, 2560), "bf16", True, 1e-5), ((2, 14, 56, 104, 320), "bf16", True, 1e-5),
            ((2, 14, 7, 13, 1280), "bf16", True, 1e-5),
            ((7, 448, 832, 128), "bf16", True, 1e-6), ((1, 7, 448, 832, 128), "bf16", True, 1e-6),
            ((28, 56, 104, 320), "fp32", True, 1e-5), ((28, 7, 13, 1280), "fp32", False, 1e-6),
            ((2, 14, 56, 104, 320), "fp32", True, 1e-5)]
# the backward's also at its cluster sites off chip_smoke's list: UNet ds2 concat, the
# ds4 time_stack, the inversion's ds1 concat at 512 x 512, the autoencoder step at 112 x 208
GN_BWD_SITES = GN_SITES + [((28, 28, 52, 1920), "bf16", True, 1e-5), ((2, 14, 14, 26, 1280), "bf16", True, 1e-5),
                           ((2, 64, 64, 960), "bf16", True, 1e-5), ((2, 112, 208, 512), "bf16", True, 1e-6),
                           # svd.yaml's VideoDecoder on a 7-frame clip: the mid (and its time_stack), the
                           # 112x208 and 224x416 levels
                           ((7, 56, 104, 512), "bf16", True, 1e-6), ((1, 7, 56, 104, 512), "bf16", True, 1e-6),
                           ((7, 112, 208, 512), "bf16", True, 1e-6), ((7, 224, 416, 256), "bf16", True, 1e-6)]
HBM_BYTES_PER_S = 3.35e12
# dense tensor-core peaks: bf16, and fp32-class products as three TF32 products (495 / 3)
PEAK_FLOPS = {"bf16": 989e12, "fp32": 495e12 / 3}
# the fp32 D = 512 attention (`x3`): packed [B, L, 1 x 512] forwards (decoding_t 7 and 14), the packed
# backward on the 7-frame training clip, and bhld [B, 1, L, 512] forward and backward at ae_grad's 64 tokens
X3_FWD_SHAPES, X3_BWD_SHAPES, X3_BHLD = [(7, 5824), (14, 5824)], [(7, 5824)], (2, 1, 64, 512)


def graph_ms(torch, fn, n=20):
    """Device ms per call: n calls captured in one CUDA graph, one replay timed."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def events_ms(torch, fn, n=5):
    """Device ms per call from CUDA events around n launches after a warm-up:
    for calls that cannot be captured in a graph (autograd's backward) and
    that run long enough (over ~1 ms) for the host not to show."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def profiled_ms(torch, fn, n=5):
    """Device ms per call: the CUDA kernels' time that torch.profiler records
    over n calls (for calls a CUDA graph cannot capture: autograd's backward);
    None if the profiler saw no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    total = sum(getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0))
                for e in prof.key_averages())
    return total / n / 1e3 if total > 0 else None


def fmt_ms(ms):
    return "not measured" if ms is None else f"{ms:.4f}"


def errors(out, ref):
    """(error in bf16 steps at max |ref|, in fp32 relative to max |ref|; relative RMS error)"""
    diff = out.float() - ref.float()
    peak = ref.float().abs().max().item()
    step = 2.0 ** (math.floor(math.log2(peak)) - 7) if out.element_size() == 2 else peak
    return diff.abs().max().item() / step, diff.norm().item() / ref.float().norm().item()


def bound_ms(nbytes, flops, dtype="bf16"):
    return max(nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]) * 1e3


def routes(fn):
    """The wrapper's route counters (absent on builds that have none)."""
    return {k: v for k, v in vars(fn).items() if k.endswith("launches")}


def time_tconv(torch, F, rn):
    from vidseg_diffusion_tpu_torch.ops import temporal_conv as TC

    bf = torch.bfloat16
    for b, t, m, ci, co, backward in TCONV_SHAPES:
        x, w = rn(b, t, m, ci).to(bf), (rn(3, ci, co) / (3 * ci) ** 0.5).to(bf)
        pairs = sum(1 for f in range(t) for j in range(3) if 0 <= f + j - 1 < t)
        nbytes = 2 * (b * t * m * (ci + co) + 3 * ci * co + co)
        flops = 2 * b * pairs * m * ci * co
        x5 = x.permute(0, 3, 1, 2).unsqueeze(-1)               # [B, Cin, T, M, 1]
        w5 = w.permute(2, 1, 0).contiguous()[..., None, None]  # [Cout, Cin, kt, 1, 1]
        if backward:   # dx + dW + db: two products of the forward's size
            g = rn(b, t, m, co).to(bf)
            leaves = [x5.detach().requires_grad_(), w5.detach().requires_grad_(),
                      torch.zeros(co, dtype=bf, device="cuda", requires_grad=True)]
            y5 = F.conv3d(*leaves, padding=(1, 0, 0))
            g5 = g.permute(0, 3, 1, 2).unsqueeze(-1)
            lib_ms = events_ms(torch, lambda: torch.autograd.grad(y5, leaves, g5, retain_graph=True))
            got, ref = TC.temporal_conv_1x1_backward(x, w, g), TC.temporal_conv_1x1_backward_reference(x, w, g)
            check = ", ".join("%.2f bf16 steps, rel. RMS %.2e" % errors(o, r) for o, r in zip(got, ref))
            before = routes(TC.temporal_conv_1x1)
            ms = events_ms(torch, lambda: TC.temporal_conv_1x1_backward(x, w, g))
            label, nbytes, flops = "dx+dW+db (CUDA events) ", 2 * nbytes, 2 * flops
            del g, leaves, y5, g5, got, ref
        else:
            bias = rn(co).to(bf)
            lib_ms = graph_ms(torch, lambda: F.conv3d(x5, w5, bias, padding=(1, 0, 0)), 5)
            check = "%.2f bf16 steps, rel. RMS %.2e" % errors(
                TC.temporal_conv_1x1(x, w, bias), TC.temporal_conv_1x1_reference(x, w, bias))
            before = routes(TC.temporal_conv_1x1)
            ms = graph_ms(torch, lambda: TC.temporal_conv_1x1(x, w, bias), 5)
            label = ""
            del bias
        moved = {k: v - before[k] for k, v in routes(TC.temporal_conv_1x1).items()}
        print(f"K4 {label}[{b},{t},{m},{ci}->{co}]: {ms:.4f} ms (F.conv3d {lib_ms:.4f}, bound "
              f"{bound_ms(nbytes, flops):.4f}), {check}; routes over the timed launches {moved}", flush=True)
        del x, w, x5, w5
        torch.cuda.empty_cache()


def time_group_norm(torch, F, rn):
    from vidseg_diffusion_tpu_torch.ops import norm as N

    dtypes = {"bf16": torch.bfloat16, "fp32": torch.float32}
    counters = [f for f in N.KERNEL_COUNTERS if not f.__name__.startswith("group_norm_backward")]
    for shape, dt, silu, eps in GN_SITES:
        dtype, c = dtypes[dt], shape[-1]
        x = (rn(*shape) * 1.5 + 0.3).to(dtype)
        w, b = (rn(c) * 0.5 + 1.0).to(dtype), rn(c).to(dtype)
        view = x.permute(0, x.dim() - 1, *range(1, x.dim() - 1))   # the channels-last view

        def library():
            y = F.group_norm(view, 32, w, b, eps)
            return F.silu(y) if silu else y

        def port():
            return N.group_norm(x, w, b, 32, eps, silu=silu)

        with torch.no_grad():
            lib_ms = graph_ms(torch, library, 5)
            steps, rms = errors(port(), N.group_norm_plain(x, w, b, 32, eps, silu=silu))
            before = {f.__name__: f.launches for f in counters}
            port()
            launched = {k: f.launches - before[k] for f in counters for k in [f.__name__] if f.launches > before[k]}
            ms = graph_ms(torch, port, 5)
        nbytes = 2 * x.numel() * x.element_size()   # x read once, y written once
        print(f"GroupNorm {'+SiLU ' if silu else ''}{list(shape)} {dt}: {ms:.4f} ms (F.group_norm"
              f"{'+F.silu' if silu else ''} {lib_ms:.4f}, bound {bound_ms(nbytes, 0):.4f}), "
              f"{steps:.2e} {'bf16 steps' if dt == 'bf16' else 'relative'}, rel. RMS {rms:.2e}; "
              f"launches per call {launched}", flush=True)
        del x, view
        torch.cuda.empty_cache()


def time_temporal(torch, F, rn, only):
    """K2 (graph) and K6 (events and graph) at TEMPORAL_SHAPES beside SDPA
    and its backward on the canonical view."""
    from vidseg_diffusion_tpu_torch.ops import attention as A

    bf, t, b = torch.bfloat16, 14, 28
    frames = lambda x: x.view(b // t, t, *x.shape[1:]).permute(0, 2, 3, 1, 4)   # [videos, s, H, t, 64]
    for s, h in TEMPORAL_SHAPES:
        q, k, v, g = (rn(b, s, h, 64).to(bf) for _ in range(4))
        n = b * s * h * 64   # elements of one tensor
        flops = 4 * t * t * 64 * (b // t) * s * h   # S and P V per problem
        if "k2" in only:
            steps, rms = errors(A.temporal_attention_direct(q, k, v, t=t),
                                A.temporal_attention_direct_reference(q, k, v, t=t))
            lib_ms = graph_ms(torch, lambda: F.scaled_dot_product_attention(frames(q), frames(k), frames(v)), 5)
            before = routes(A.temporal_attention_direct)
            ms = graph_ms(torch, lambda: A.temporal_attention_direct(q, k, v, t=t), 5)
            moved = {key: val - before[key] for key, val in routes(A.temporal_attention_direct).items()}
            print(f"K2 [{b},{s},{h},64] t={t}: {ms:.4f} ms (SDPA {lib_ms:.4f}, bound "
                  f"{bound_ms(4 * 2 * n, flops):.4f}), {steps:.2f} bf16 steps, rel. RMS {rms:.2e}; "
                  f"routes over the timed launches {moved}", flush=True)
        if "k6" in only:
            o = A.temporal_attention_direct(q, k, v, t=t)
            got = A.temporal_attention_direct_backward(q, k, v, o, g, t=t)
            ref = A.temporal_attention_direct_backward_reference(q, k, v, o, g, t=t)
            check = ", ".join("%.2f bf16 steps, rel. RMS %.2e" % errors(x, r) for x, r in zip(got, ref))
            leaves = [frames(x).detach().requires_grad_() for x in (q, k, v)]
            y = F.scaled_dot_product_attention(*leaves)
            lib_ms = events_ms(torch, lambda: torch.autograd.grad(y, leaves, frames(g), retain_graph=True))
            before = routes(A.temporal_attention_direct_backward)
            ms = events_ms(torch, lambda: A.temporal_attention_direct_backward(q, k, v, o, g, t=t))
            dev_ms = graph_ms(torch, lambda: A.temporal_attention_direct_backward(q, k, v, o, g, t=t), 5)
            moved = {key: val - before[key] for key, val in routes(A.temporal_attention_direct_backward).items()}
            print(f"K6 [{b},{s},{h},64] t={t} (CUDA events): {ms:.4f} ms (SDPA backward {lib_ms:.4f}, bound "
                  f"{bound_ms(8 * 2 * n, 2.5 * flops):.4f}; device time {dev_ms:.4f}), {check}; routes over "
                  f"the timed launches {moved}", flush=True)
            del o, got, ref, leaves, y
        del q, k, v, g
        torch.cuda.empty_cache()


def time_flash_backward(torch, F, rn, only):
    """K5 (packed [B, L, H*64]) and K13 (bhld, D = 512) beside SDPA's backward
    on views of the same tensors, each held to its plain version where the
    plain version's [B, H, L, L] fp32 tensors fit (under ~2 GB)."""
    from vidseg_diffusion_tpu_torch.ops import attention as A

    bf = torch.bfloat16
    cases = ([("k5", b, h, l, l, 64) for b, l, h in K5_SHAPES] + [("k13",) + s for s in K13_SHAPES]
             + [("k5w", b, 1, l, l, 512) for b, l in K5_WIDE_SHAPES])
    for key, b, h, lq, lk, d in cases:
        if key not in only:
            continue
        if key in ("k5", "k5w"):
            q, go = (rn(b, lq, h * d).to(bf) for _ in range(2))
            k, v = (rn(b, lk, h * d).to(bf) for _ in range(2))
            out, lse = A._flash_attention_packed_forward(q, k, v, h, None, save_lse=True)
            fn, plain = A.flash_attention_packed_backward, A.flash_attention_packed_backward_reference
            args = (q, k, v, out, lse, go, h)
            view = lambda x: x.view(b, x.shape[1], h, d).transpose(1, 2)
            executed = 14 if d == 64 else 18   # at one 512-dim head K13's kernels
        else:
            q, go = (rn(b, h, lq, d).to(bf) for _ in range(2))
            k, v = (rn(b, h, lk, d).to(bf) for _ in range(2))
            out, lse = A._flash_attention_forward(q, k, v, None, save_lse=True)
            fn, plain = A.flash_attention_backward, A.flash_attention_backward_reference
            args = (q, k, v, out, lse, go)
            view = lambda x: x
            executed = 18
        check = ""
        if 4 * b * h * lq * lk * 4 <= 2e9:
            got, ref = fn(*args), plain(*args)
            check = ", " + ", ".join("%.2f bf16 steps, rel. RMS %.2e" % errors(x, r) for x, r in zip(got, ref))
            del got, ref
        leaves = [view(x).detach().requires_grad_() for x in (q, k, v)]
        y = F.scaled_dot_product_attention(*leaves)
        lib_ms = profiled_ms(torch, lambda: torch.autograd.grad(y, leaves, view(go), retain_graph=True))
        before = routes(fn)
        fn(*args)
        moved = {key2: val - before[key2] for key2, val in routes(fn).items()}
        ms = graph_ms(torch, lambda: fn(*args), 5)
        nbytes = 2 * (4 * b * h * lq * d + 4 * b * h * lk * d) + 4 * b * h * lq
        flops = 10 * b * h * lq * lk * d
        print(f"{key.upper()} [{b},{h},{lq}x{lk},{d}]: {ms:.4f} ms (SDPA backward {fmt_ms(lib_ms)}, bound "
              f"{bound_ms(nbytes, flops):.4f} for {flops:.3e} flops; executed {executed / 10 * flops:.3e} "
              f"flops){check}; routes of one call {moved}", flush=True)
        del q, k, v, go, out, lse, args, leaves, y
        torch.cuda.empty_cache()


def time_temporal_wide_backward(torch, F, rn):
    """K6 at D = 512 at K6_WIDE_SHAPES in bf16 and fp32 as its route takes it,
    CUDA events and a graph, beside SDPA's backward on the canonical view ([1,
    S, 1, t, 512], strided; torch.profiler's sum of its kernels), held to the
    plain version; the SDPA backends that take the view named. Then every other
    t up to 16 (K6_ROUTE_TS) as graphs. The route of each call is printed."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from vidseg_diffusion_tpu_torch.ops import attention as A

    fn = A.temporal_attention_direct_backward
    cases = [(t, s, True) for t, s in K6_WIDE_SHAPES] + [(t, 5824, False) for t in K6_ROUTE_TS]
    for t, s, headline in cases:
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v, g = (rn(t, s, 1, 512).to(dtype) for _ in range(4))
            frames = lambda x: x.view(1, t, s, 1, 512).permute(0, 2, 3, 1, 4)
            o = A.temporal_attention_direct_reference(q, k, v, t=t).contiguous()
            try:   # an older checkout (--root) refuses some t
                got = fn(q, k, v, o, g, t=t)
            except (ValueError, RuntimeError) as e:
                print(f"K6 D=512 [{t},{s},1,512] t={t} {str(dtype)[6:]}: refused ({str(e)[:80]})", flush=True)
                continue
            ref = A.temporal_attention_direct_backward_reference(q, k, v, o, g, t=t)
            unit = "bf16 steps" if dtype == torch.bfloat16 else "relative"
            check = ", ".join(f"%.2e {unit}, rel. RMS %.2e" % errors(x, r) for x, r in zip(got, ref))
            before = routes(fn)
            fn(q, k, v, o, g, t=t)
            moved = {key: val - before[key] for key, val in routes(fn).items()}
            dev_ms = graph_ms(torch, lambda: fn(q, k, v, o, g, t=t), 5)
            item = q.element_size()
            nbytes, flops = 8 * item * q.numel(), 10 * t * t * 512 * s
            bound = bound_ms(nbytes, flops, 'bf16' if item == 2 else 'fp32')
            head = f"K6 D=512 [{t},{s},1,512] t={t} {str(dtype)[6:]}"
            if headline:
                takes = []
                for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.CUDNN_ATTENTION,
                                SDPBackend.EFFICIENT_ATTENTION, SDPBackend.MATH):
                    try:
                        with sdpa_kernel([backend]):
                            F.scaled_dot_product_attention(*(frames(x) for x in (q, k, v)))
                        takes.append(backend.name)
                    except RuntimeError:
                        pass
                leaves = [frames(x).detach().requires_grad_() for x in (q, k, v)]
                y = F.scaled_dot_product_attention(*leaves)
                lib_ms = profiled_ms(torch, lambda: torch.autograd.grad(y, leaves, frames(g), retain_graph=True))
                ms = events_ms(torch, lambda: fn(q, k, v, o, g, t=t))
                print(f"{head} (CUDA events): {ms:.4f} ms (device time {dev_ms:.4f}; SDPA backward, device time, "
                      f"{fmt_ms(lib_ms)}, backends taking the view {takes}; bound {bound:.4f}), {check}; routes of "
                      f"one call {moved}", flush=True)
                del leaves, y
            else:
                print(f"{head}: device time {dev_ms:.4f} ms (bound {bound:.4f}), {check}; routes of one call "
                      f"{moved}", flush=True)
            del q, k, v, g, o, got, ref
            torch.cuda.empty_cache()


def time_temporal_tc(torch, F, rn, kind, b, t, s, h, d, dtype, tag, full=True):
    """K2 or K6 (`kind`) on b videos of [t, s, h, d] in `dtype` as a CUDA graph
    beside the bound, with the route of one launch; `full`: also beside SDPA
    on the canonical view ([b, s, h, t, d], strided; K6: its backward, the sum
    of its kernels in torch.profiler), held to the plain version. A call the
    checkout refuses (`--root` an older tree) prints as refused."""
    from vidseg_diffusion_tpu_torch.ops import attention as A

    q, k, v, g = (rn(b * t, s, h, d).to(dtype) for _ in range(4))
    frames = lambda x: x.view(b, t, s, h, d).permute(0, 2, 3, 1, 4)
    item, name = q.element_size(), f"[{b * t},{s},{h},{d}] t={t} {str(dtype)[6:]}"
    if kind == "K2":
        fn, args, plain = A.temporal_attention_direct, (q, k, v), A.temporal_attention_direct_reference
        nbytes, flops = 4 * item * q.numel(), 4 * t * t * d * b * s * h
    else:
        fn, plain = A.temporal_attention_direct_backward, A.temporal_attention_direct_backward_reference
        args = (q, k, v, A.temporal_attention_direct_reference(q, k, v, t=t).contiguous(), g)
        nbytes, flops = 8 * item * q.numel(), 10 * t * t * d * b * s * h
    try:
        got = fn(*args, t=t)
    except (ValueError, RuntimeError) as e:
        print(f"{kind} {tag} {name}: refused ({str(e)[:80]})", flush=True)
        return
    before = routes(fn)
    fn(*args, t=t)
    moved = {key: val - before[key] for key, val in routes(fn).items() if val != before[key]}
    ms = graph_ms(torch, lambda: fn(*args, t=t), 5)
    bound = bound_ms(nbytes, flops, "bf16" if item == 2 else "fp32")
    if not full:
        print(f"{kind} {tag} {name}: device time {ms:.4f} ms (bound {bound:.4f}); routes of one call {moved}",
              flush=True)
        return
    ref = plain(*args, t=t)
    got, ref = (got, ref) if isinstance(got, tuple) else ((got,), (ref,))
    unit = "bf16 steps" if item == 2 else "relative"
    check = ", ".join(f"%.2e {unit}, rel. RMS %.2e" % errors(x, r) for x, r in zip(got, ref))
    if kind == "K2":
        lib_ms = graph_ms(torch, lambda: F.scaled_dot_product_attention(*(frames(x) for x in (q, k, v))), 5)
    else:
        leaves = [frames(x).detach().requires_grad_() for x in (q, k, v)]
        y = F.scaled_dot_product_attention(*leaves)
        lib_ms = profiled_ms(torch, lambda: torch.autograd.grad(y, leaves, frames(g), retain_graph=True))
        del leaves, y
    print(f"{kind} {tag} {name}: device time {ms:.4f} ms (SDPA{' backward' if kind == 'K6' else ''}, device time, "
          f"{fmt_ms(lib_ms)}, {sdpa_backend(torch, F, *(frames(x) for x in (q, k, v)))}; bound {bound:.4f}), "
          f"{check}; routes of one call {moved}", flush=True)
    del q, k, v, g, args, got, ref
    torch.cuda.empty_cache()


def time_long_frames(torch, F, rn):
    """K2 and K6 past 32 frames (LONG_SHAPES, one video, both dtypes), each
    with time_temporal_tc in full."""
    for t, s, h, d in LONG_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            for kind in ("K2", "K6"):
                time_temporal_tc(torch, F, rn, kind, 1, t, s, h, d, dtype, "past 32 frames")


def time_short_frames(torch, F, rn):
    """K6 in fp32 at D = 64 (two videos, [2t, 5824, 5, 64]) and K2 at D = 512
    (one video, [t, 5824, 1, 512], bf16 and fp32) at every t from 1 to 32 with
    time_temporal_tc, in full at SHORT_TS."""
    for t in range(1, 33):
        time_temporal_tc(torch, F, rn, "K6", 2, t, 5824, 5, 64, torch.float32, "short", full=t in SHORT_TS)
    for t in range(1, 33):
        for dtype in (torch.bfloat16, torch.float32):
            time_temporal_tc(torch, F, rn, "K2", 1, t, 5824, 1, 512, dtype, "short", full=t in SHORT_TS)


def time_k5_d16(torch, F, rn):
    """K5 at D = 16 (K5_D16_SHAPES) and K13 there (K13_D16_SHAPE, K5's kernels
    on K3's strides), bf16 and fp32, as CUDA graphs beside SDPA's backward
    (torch.profiler's sum of its kernels), held to the plain version; the bound
    (five products, 10 L^2 D flops, or bytes) and the exp2 floor (two exp2 a
    (query, key) pair, one a kernel, at 16 a clock an SM at the card's largest
    SM clock)."""
    from vidseg_diffusion_tpu_torch.ops import attention as A

    props = torch.cuda.get_device_properties(0)
    clock = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                           capture_output=True, text=True, check=True).stdout.split()[0]
    exp2_rate = 16 * props.multi_processor_count * float(clock) * 1e6
    cases = [("K5", b, h, l) for b, l, h in K5_D16_SHAPES] + [("K13",) + K13_D16_SHAPE]
    for name, b, h, l in cases:
        for dtype in (torch.bfloat16, torch.float32):
            if name == "K5":
                q, k, v, go = (rn(b, l, h * 16).to(dtype) for _ in range(4))
                out, lse = A._flash_attention_packed_forward(q, k, v, h, None, save_lse=True)
                args = (q, k, v, out, lse, go, h)
                fn, plain, counter = A.flash_attention_packed_backward, A.flash_attention_packed_backward_reference, \
                    A.flash_attention_packed_backward
                view = lambda x: x.view(b, l, h, 16).transpose(1, 2)
            else:
                q, k, v, go = (rn(b, h, l, 16).to(dtype) for _ in range(4))
                out, lse = A._flash_attention_forward(q, k, v, None, save_lse=True)
                args = (q, k, v, out, lse, go)
                fn, plain, counter = A.flash_attention_backward, A.flash_attention_backward_reference, \
                    A.flash_attention_packed_backward
                view = lambda x: x
            got, ref = fn(*args), plain(*args)
            unit = "bf16 steps" if dtype == torch.bfloat16 else "relative"
            check = ", ".join(f"%.2e {unit}, rel. RMS %.2e" % errors(x, r) for x, r in zip(got, ref))
            before = routes(counter)
            fn(*args)
            moved = {key: val - before[key] for key, val in routes(counter).items()}
            ms = graph_ms(torch, lambda: fn(*args), 5)
            leaves = [view(x).detach().requires_grad_() for x in (q, k, v)]
            y = F.scaled_dot_product_attention(*leaves)
            lib_ms = profiled_ms(torch, lambda: torch.autograd.grad(y, leaves, view(go), retain_graph=True))
            item = q.element_size()
            nbytes = item * 8 * b * h * l * 16 + 4 * b * h * l
            bound = bound_ms(nbytes, 10 * b * h * l * l * 16, "bf16" if item == 2 else "fp32")
            floor = 2 * b * h * l * l / exp2_rate * 1e3
            print(f"{name} D=16 [{b},{l},{h}x16] {str(dtype)[6:]}: {ms:.4f} ms (SDPA backward {fmt_ms(lib_ms)}, "
                  f"{sdpa_backend(torch, F, *leaves)}; bound {bound:.4f}, exp2 floor {floor:.4f} at {clock} MHz), "
                  f"{check}; routes of one call {moved}", flush=True)
            del q, k, v, go, out, lse, args, got, ref, leaves, y
            torch.cuda.empty_cache()


def time_fp32_d64(torch, F, rn):
    """The fp32 routes at D = 64 (step 0's blank table cells) and K4's fp32 tile
    at the UNet's ds1: device time as CUDA graphs (backwards: graphs too, SDPA's
    profiled), beside the one PyTorch call in full fp32 (TF32 off), with the
    fp32 bound (bytes, or flops at 165 TFLOP/s), held to the plain version
    where it fits (B = 2)."""
    from vidseg_diffusion_tpu_torch.ops import attention as A
    from vidseg_diffusion_tpu_torch.ops import temporal_conv as TC

    f32 = torch.float32
    heads = lambda x, b, h: x.view(b, x.shape[1], h, 64).transpose(1, 2)
    for b, l, h in FP32_K1_SHAPES:
        q, k, v = (rn(b, l, h * 64) for _ in range(3))
        check = ""
        if b == 2:
            check = ", %.2e relative, rel. RMS %.2e" % errors(A.flash_attention_packed(q, k, v, h),
                                                           A.flash_attention_packed_reference(q, k, v, h))
        n = 5 if b == 2 else 2
        ms = graph_ms(torch, lambda: A.flash_attention_packed(q, k, v, h), n)
        lib_ms = graph_ms(torch, lambda: F.scaled_dot_product_attention(heads(q, b, h), heads(k, b, h),
                                                                        heads(v, b, h)), n)
        bound = bound_ms(4 * 4 * b * l * h * 64, 4 * b * h * l * l * 64, "fp32")
        print(f"FP32 K1 [{b},{l},{h}x64]: {ms:.4f} ms (SDPA {lib_ms:.4f}, "
              f"{sdpa_backend(torch, F, heads(q, b, h), heads(k, b, h), heads(v, b, h))}; bound {bound:.4f}){check}",
              flush=True)
        del q, k, v
        torch.cuda.empty_cache()
    b, l, h = FP32_K5_SHAPE
    q, k, v, go = (rn(b, l, h * 64) for _ in range(4))
    out, lse = A._flash_attention_packed_forward(q, k, v, h, None, save_lse=True)
    args = (q, k, v, out, lse, go, h)
    check = ", ".join("%.2e relative, rel. RMS %.2e" % errors(x, r) for x, r in
                      zip(A.flash_attention_packed_backward(*args), A.flash_attention_packed_backward_reference(*args)))
    ms = graph_ms(torch, lambda: A.flash_attention_packed_backward(*args), 3)
    leaves = [heads(x, b, h).detach().requires_grad_() for x in (q, k, v)]
    y = F.scaled_dot_product_attention(*leaves)
    lib_ms = profiled_ms(torch, lambda: torch.autograd.grad(y, leaves, heads(go, b, h), retain_graph=True))
    bound = bound_ms(4 * 8 * b * l * h * 64 + 4 * b * h * l, 10 * b * h * l * l * 64, "fp32")
    print(f"FP32 K5 [{b},{l},{h}x64]: {ms:.4f} ms (SDPA backward {fmt_ms(lib_ms)}, {sdpa_backend(torch, F, *leaves)}; "
          f"bound {bound:.4f}), {check}", flush=True)
    del q, k, v, go, out, lse, args, leaves, y
    torch.cuda.empty_cache()
    s, h = FP32_TEMPORAL_SHAPE
    t, bt = 14, 28
    q, k, v, g = (rn(bt, s, h, 64) for _ in range(4))
    frames = lambda x: x.view(bt // t, t, *x.shape[1:]).permute(0, 2, 3, 1, 4)
    o = A.temporal_attention_direct(q, k, v, t=t)
    n = bt * s * h * 64
    flops = 4 * t * t * 64 * (bt // t) * s * h
    check = "%.2e relative, rel. RMS %.2e" % errors(o, A.temporal_attention_direct_reference(q, k, v, t=t))
    ms = graph_ms(torch, lambda: A.temporal_attention_direct(q, k, v, t=t), 5)
    lib_ms = graph_ms(torch, lambda: F.scaled_dot_product_attention(frames(q), frames(k), frames(v)), 5)
    print(f"FP32 K2 [{bt},{s},{h},64] t={t}: {ms:.4f} ms (SDPA {lib_ms:.4f}, "
          f"{sdpa_backend(torch, F, frames(q), frames(k), frames(v))}; bound {bound_ms(4 * 4 * n, flops, 'fp32'):.4f}), "
          f"{check}", flush=True)
    check = ", ".join("%.2e relative, rel. RMS %.2e" % errors(x, r) for x, r in zip(
        A.temporal_attention_direct_backward(q, k, v, o, g, t=t),
        A.temporal_attention_direct_backward_reference(q, k, v, o, g, t=t)))
    ms = graph_ms(torch, lambda: A.temporal_attention_direct_backward(q, k, v, o, g, t=t), 3)
    leaves = [frames(x).detach().requires_grad_() for x in (q, k, v)]
    y = F.scaled_dot_product_attention(*leaves)
    lib_ms = profiled_ms(torch, lambda: torch.autograd.grad(y, leaves, frames(g), retain_graph=True))
    print(f"FP32 K6 [{bt},{s},{h},64] t={t}: {ms:.4f} ms (SDPA backward {fmt_ms(lib_ms)}, "
          f"{sdpa_backend(torch, F, *leaves)}; bound {bound_ms(8 * 4 * n, 2.5 * flops, 'fp32'):.4f}), {check}",
          flush=True)
    del q, k, v, g, o, leaves, y
    torch.cuda.empty_cache()
    b, t, m, ci, co = FP32_K4_SHAPE
    x, w, bias = rn(b, t, m, ci), rn(3, ci, co) / (3 * ci) ** 0.5, rn(co)
    x5 = x.permute(0, 3, 1, 2).unsqueeze(-1)
    w5 = w.permute(2, 1, 0).contiguous()[..., None, None]
    check = "%.2e relative, rel. RMS %.2e" % errors(TC.temporal_conv_1x1(x, w, bias),
                                                     TC.temporal_conv_1x1_reference(x, w, bias))
    ms = graph_ms(torch, lambda: TC.temporal_conv_1x1(x, w, bias), 5)
    lib_ms = graph_ms(torch, lambda: F.conv3d(x5, w5, bias, padding=(1, 0, 0)), 5)
    pairs = sum(1 for f in range(t) for j in range(3) if 0 <= f + j - 1 < t)
    bound = bound_ms(4 * (b * t * m * (ci + co) + 3 * ci * co + co), 2 * b * pairs * m * ci * co, "fp32")
    print(f"FP32 K4 [{b},{t},{m},{ci}->{co}]: {ms:.4f} ms (F.conv3d {lib_ms:.4f}; bound {bound:.4f}), {check}",
          flush=True)


def sdpa_backend(torch, F, *qkv):
    """The first SDPA backend that takes these inputs: the one the library call runs."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.CUDNN_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
                    SDPBackend.MATH):
        try:
            with sdpa_kernel([backend]):
                F.scaled_dot_product_attention(*qkv)
            return backend.name
        except RuntimeError:
            pass
    return "none"


def time_x3(torch, F, rn):
    """The fp32 attention at D = 512 (`x3`): forwards and backwards as CUDA
    graphs beside SDPA (backward: profiled), held to the plain version (max
    error relative to max |plain|, relative RMS) and to the plain version in
    float64 (relative RMS). Bound: bytes, or the five products (backward; the
    kernels execute eight: S three times, dP twice) at 165 TFLOP/s."""
    from vidseg_diffusion_tpu_torch.ops import attention as A

    def check(got, plain, args):
        ref, ref64 = plain(*args), plain(*(a.double() if torch.is_tensor(a) and a.is_floating_point() else a
                                           for a in args))
        got, ref, ref64 = ((x,) if torch.is_tensor(x) else x for x in (got, ref, ref64))
        return ", ".join("%.2e relative, rel. RMS %.2e" % errors(x, r) + ", vs float64 rel. RMS %.2e"
                         % ((x.double() - r64).norm() / r64.norm()).item() for x, r, r64 in zip(got, ref, ref64))

    def bwd_lib(view, qkv, g):
        leaves = [view(x).detach().requires_grad_() for x in qkv]
        y = F.scaled_dot_product_attention(*leaves)
        return profiled_ms(torch, lambda: torch.autograd.grad(y, leaves, view(g), retain_graph=True))

    for b, l in X3_FWD_SHAPES:
        q, k, v = (rn(b, l, 512) for _ in range(3))
        heads = lambda x: x.view(b, l, 1, 512).transpose(1, 2)
        before = routes(A.flash_attention_packed)
        got = A.flash_attention_packed(q, k, v, 1)
        moved = {key: val - before[key] for key, val in routes(A.flash_attention_packed).items()}
        errs = check(got, A.flash_attention_packed_reference, (q, k, v, 1))
        ms = graph_ms(torch, lambda: A.flash_attention_packed(q, k, v, 1), 5)
        lib_ms = graph_ms(torch, lambda: F.scaled_dot_product_attention(heads(q), heads(k), heads(v)), 5)
        print(f"X3 K1 fp32 [{b},{l},1x512]: {ms:.4f} ms (SDPA {lib_ms:.4f}, "
              f"{sdpa_backend(torch, F, heads(q), heads(k), heads(v))}; bound "
              f"{bound_ms(16 * b * l * 512, 4 * b * l * l * 512, 'fp32'):.4f}), {errs}; routes of one call {moved}",
              flush=True)
        del q, k, v, got
        torch.cuda.empty_cache()
    for b, l in X3_BWD_SHAPES:
        q, k, v, g = (rn(b, l, 512) for _ in range(4))
        heads = lambda x: x.view(b, l, 1, 512).transpose(1, 2)
        out, lse = A._flash_attention_packed_forward(q, k, v, 1, None, save_lse=True)
        args = (q, k, v, out, lse, g, 1)
        before = routes(A.flash_attention_packed_backward)
        got = A.flash_attention_packed_backward(*args)
        moved = {key: val - before[key] for key, val in routes(A.flash_attention_packed_backward).items()}
        errs = check(got, A.flash_attention_packed_backward_reference, args)
        ms = graph_ms(torch, lambda: A.flash_attention_packed_backward(*args), 3)
        lib_ms = bwd_lib(heads, (q, k, v), g)
        print(f"X3 K5 fp32 [{b},{l},1x512]: {ms:.4f} ms (SDPA backward {fmt_ms(lib_ms)}, "
              f"{sdpa_backend(torch, F, heads(q), heads(k), heads(v))}; bound "
              f"{bound_ms(32 * b * l * 512, 10 * b * l * l * 512, 'fp32'):.4f}), {errs}; routes of one call {moved}",
              flush=True)
        del q, k, v, g, out, lse, args, got
        torch.cuda.empty_cache()
    b, h, l, d = X3_BHLD
    q, k, v, g = (rn(b, h, l, d) for _ in range(4))
    out, lse = A._flash_attention_forward(q, k, v, None, save_lse=True)
    for name, fn, plain, args, lib_ms, flops in (
            ("K3", lambda *a: A._flash_attention_forward(*a, None, save_lse=False), A.flash_attention_reference,
             (q, k, v), graph_ms(torch, lambda: F.scaled_dot_product_attention(q, k, v)), 4 * b * l * l * d),
            ("K13", A.flash_attention_backward, A.flash_attention_backward_reference, (q, k, v, out, lse, g),
             bwd_lib(lambda x: x, (q, k, v), g), 10 * b * l * l * d)):
        counter = A.flash_attention if name == "K3" else A.flash_attention_backward
        before = routes(counter)
        got = fn(*args)
        moved = {key: val - before[key] for key, val in routes(counter).items()}
        errs = check(got, plain, args)
        ms = graph_ms(torch, lambda: fn(*args))
        nbytes = (16 if name == "K3" else 32) * b * h * l * d
        print(f"X3 {name} fp32 [{b},{h},{l},{d}]: {ms:.4f} ms (SDPA{' backward' if name == 'K13' else ''} "
              f"{fmt_ms(lib_ms)}, {sdpa_backend(torch, F, q, k, v)}; bound {bound_ms(nbytes, flops, 'fp32'):.4f}), "
              f"{errs}; routes of one call {moved}", flush=True)


def vs_float64(torch, got, plain, args):
    """'max error relative to max |plain|, rel. RMS, vs float64 rel. RMS' for each output."""
    ref = plain(*args)
    ref64 = plain(*(a.double() if torch.is_tensor(a) and a.is_floating_point() else a for a in args))
    got, ref, ref64 = ((x,) if torch.is_tensor(x) else x for x in (got, ref, ref64))
    return ", ".join("%.2e relative, rel. RMS %.2e" % errors(x, r) + ", vs float64 rel. RMS %.2e"
                     % ((x.double() - r64).norm() / r64.norm()).item() for x, r, r64 in zip(got, ref, ref64))


def moved_routes(torch, counter, fn):
    """The route counters one call of fn moved."""
    before = routes(counter)
    fn()
    torch.cuda.synchronize()
    return {k: v - before[k] for k, v in routes(counter).items() if v != before[k]}


def time_x3_d64(torch, F, rn):
    """K5 in fp32 at D = 64 (`x3d64`) as CUDA graphs beside SDPA's backward in
    full fp32 (profiled) and the bound (bytes, or the five products at 165
    TFLOP/s), held to the plain version and to it in float64 up to B = 4 at
    5824 tokens' worth of logits."""
    from vidseg_diffusion_tpu_torch.ops import attention as A

    for b, l, h in X3_K5_SHAPES:
        q, k, v, g = (rn(b, l, h * 64) for _ in range(4))
        heads = lambda x: x.view(b, l, h, 64).transpose(1, 2)
        out, lse = A._flash_attention_packed_forward(q, k, v, h, None, save_lse=True)
        args = (q, k, v, out, lse, g, h)
        moved = moved_routes(torch, A.flash_attention_packed_backward, lambda: A.flash_attention_packed_backward(*args))
        errs = (vs_float64(torch, A.flash_attention_packed_backward(*args), A.flash_attention_packed_backward_reference,
                           args) if b * h * l * l <= 2 * 5 * 5824 * 5824 else "plain version not run (memory)")
        ms = graph_ms(torch, lambda: A.flash_attention_packed_backward(*args), 3 if l > 1000 else 20)
        leaves = [heads(x).detach().requires_grad_() for x in (q, k, v)]
        y = F.scaled_dot_product_attention(*leaves)
        lib_ms = profiled_ms(torch, lambda: torch.autograd.grad(y, leaves, heads(g), retain_graph=True))
        bound = bound_ms(4 * 8 * b * l * h * 64 + 4 * b * h * l, 10 * b * h * l * l * 64, "fp32")
        print(f"X3D64 K5 fp32 [{b},{l},{h}x64]: {ms:.4f} ms (SDPA backward {fmt_ms(lib_ms)}, "
              f"{sdpa_backend(torch, F, *leaves)}; bound {bound:.4f}), {errs}; routes of one call {moved}", flush=True)
        del q, k, v, g, out, lse, args, leaves, y
        torch.cuda.empty_cache()


def time_x3_mm(torch, F, rn, MM):
    """K11 in fp32 (`x3mm`) as CUDA graphs beside F.linear in full fp32 and the
    bound (bytes, or 2 M K N flops at 165 TFLOP/s), held to the plain version
    and to it in float64."""
    for m, k, n, with_bias in X3_MM_SHAPES:
        x, w = rn(m, k), rn(n, k) / k ** 0.5
        b = rn(n) if with_bias else None
        moved = moved_routes(torch, MM.matmul_bias, lambda: MM.matmul_bias(x, w, b))
        errs = vs_float64(torch, MM.matmul_bias(x, w, b), MM.matmul_bias_plain, (x, w, b))
        ms = graph_ms(torch, lambda: MM.matmul_bias(x, w, b))
        lib_ms = graph_ms(torch, lambda: F.linear(x, w, b))
        bound = bound_ms(4 * (m * k + n * k + m * n + (n if with_bias else 0)), 2 * m * k * n, "fp32")
        print(f"X3MM K11 fp32 [{m},{k}->{n}]{' bias' if with_bias else ''}: {ms:.4f} ms (F.linear {lib_ms:.4f}; "
              f"bound {bound:.4f}), {errs}; routes of one call {moved}", flush=True)
        del x, w, b
        torch.cuda.empty_cache()


def time_x3_k1(torch, F, rn):
    """K1 / K3 in fp32 (`x3k1`) as CUDA graphs beside SDPA in full fp32 and the
    bound (bytes, or 4 Lq Lk D flops a head at 165 TFLOP/s), held to the plain
    version and to it in float64 up to the ds1 slice's logits."""
    from vidseg_diffusion_tpu_torch.ops import attention as A

    for layout, b, lq, lk, h, d in X3_K1_SHAPES:
        if layout == "blhd":
            q, k, v = rn(b, lq, h * d), rn(b, lk, h * d), rn(b, lk, h * d)
            fn, plain, args = A.flash_attention_packed, A.flash_attention_packed_reference, (q, k, v, h)
            lib_args = [x.view(b, x.shape[1], h, d).transpose(1, 2) for x in (q, k, v)]
        else:
            q, k, v = rn(b, h, lq, d), rn(b, h, lk, d), rn(b, h, lk, d)
            fn, plain, args, lib_args = A.flash_attention, A.flash_attention_reference, (q, k, v), [q, k, v]
        moved = moved_routes(torch, fn, lambda: fn(*args))
        errs = (vs_float64(torch, fn(*args), plain, args) if b * h * lq * lk <= 2 * 5 * 5824 * 5824
                else "plain version not run (memory)")
        n = 3 if b * h * lq * lk > 1e9 else 20
        ms = graph_ms(torch, lambda: fn(*args), n)
        lib_ms = graph_ms(torch, lambda: F.scaled_dot_product_attention(*lib_args), n)
        bound = bound_ms(4 * 2 * b * h * (lq + lk) * d, 4 * b * h * lq * lk * d, "fp32")
        print(f"X3K1 {'K1' if layout == 'blhd' else 'K3'} fp32 {layout} [{b},{lq}x{lk},{h}x{d}]: {ms:.4f} ms (SDPA "
              f"{lib_ms:.4f}, {sdpa_backend(torch, F, *lib_args)}; bound {bound:.4f}), {errs}; routes of one call "
              f"{moved}", flush=True)
        del q, k, v, args, lib_args
        torch.cuda.empty_cache()


def time_x3_k4(torch, F, rn):
    """K4 in fp32 (`x3k4`) as CUDA graphs beside F.conv3d (dx:
    torch.nn.grad.conv3d_input) in full fp32 and the bound, held to the plain
    version and to it in float64; the dx rows time K4's launch on the output
    gradient with the flipped taps alone."""
    from vidseg_diffusion_tpu_torch.ops import temporal_conv as TC

    for b, t, m, ci, co, kt, dx in X3_K4_SHAPES:
        x, w = rn(b, t, m, ci), rn(kt, ci, co) / (kt * ci) ** 0.5
        pairs = sum(1 for f in range(t) for j in range(kt) if 0 <= f + j - kt // 2 < t)
        w5 = w.permute(2, 1, 0).contiguous()[..., None, None]  # [Cout, Cin, kt, 1, 1]
        if dx:
            g = rn(b, t, m, co)
            wdx = TC._dx_taps(w).contiguous()
            fn, args = (lambda g, wdx: TC._launch(g, wdx, None)), (g, wdx)
            # dx as the plain backward computes it: the plain forward on g with the flipped taps
            plain, plain_args = TC.temporal_conv_1x1_reference, (g, wdx.transpose(1, 2), torch.zeros_like(x[0, 0, 0]))
            g5 = g.permute(0, 3, 1, 2).unsqueeze(-1)
            library = lambda: torch.nn.grad.conv3d_input((b, ci, t, m, 1), w5, g5, padding=(kt // 2, 0, 0))
        else:
            bias = rn(co)
            fn, args = TC.temporal_conv_1x1, (x, w, bias)
            plain, plain_args = TC.temporal_conv_1x1_reference, (x, w, bias)
            x5 = x.permute(0, 3, 1, 2).unsqueeze(-1)               # [B, Cin, T, M, 1]
            library = lambda: F.conv3d(x5, w5, bias, padding=(kt // 2, 0, 0))
        moved = moved_routes(torch, TC.temporal_conv_1x1, lambda: fn(*args))
        errs = vs_float64(torch, fn(*args), plain, plain_args)
        ms = graph_ms(torch, lambda: fn(*args), 5)
        lib_ms = graph_ms(torch, library, 5)
        bound = bound_ms(4 * (b * t * m * (ci + co) + kt * ci * co + (0 if dx else co)),
                         2 * b * pairs * m * ci * co, "fp32")
        print(f"X3K4 K4 fp32 {'dx ' if dx else ''}[{b},{t},{m},{ci}->{co}] kt={kt}: {ms:.4f} ms (F.conv3d"
              f"{' input gradient' if dx else ''} {lib_ms:.4f}; bound {bound:.4f}), {errs}; routes of one call "
              f"{moved}", flush=True)
        del x, w, w5, args, plain_args
        torch.cuda.empty_cache()


def time_memory(torch):
    """Peak device memory (`mem`) of the fp32 runs of chip_smoke.py's unet and
    train_grad phases on the card: the full-width SVD UNet's forward (a 16 x 16
    latent, [uc; c] of one 2-frame video) and its diffusion loss's backward
    (two 2-frame videos, remat on), with what the weight-copy caches of
    ops/relayout.py hold after each."""
    from vidseg_diffusion_tpu_torch.config import load_model_spec
    from vidseg_diffusion_tpu_torch.engine.build import randomize_
    from vidseg_diffusion_tpu_torch.models.unet import UNetModel
    from vidseg_diffusion_tpu_torch.ops import _cuda, relayout
    from vidseg_diffusion_tpu_torch.scripts import train_path

    def cached():   # GiB each RelayoutCache holds, by the module attribute that keeps it
        held = {}
        for name, mod in list(sys.modules.items()):
            for attr, val in (vars(mod).items() if name.startswith("vidseg_diffusion_tpu_torch") else ()):
                if isinstance(val, relayout.RelayoutCache):
                    held[f"{name.rsplit('.', 1)[-1]}.{attr}"] = round(sum(
                        e[2].numel() * e[2].element_size() for e in val._entries.values() if e[2] is not None)
                        / 2 ** 30, 3)
        return held

    def report(tag, unet):
        weights = sum(p.numel() * p.element_size() for p in unet.parameters())
        print(f"MEM {tag}: peak {torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB, weights "
              f"{weights / 2 ** 30:.3f} GiB, relayout caches (GiB) {cached()}", flush=True)

    root = os.path.dirname(os.path.dirname(_cuda.CSRC))
    t, b = 2, 4
    spec = load_model_spec(os.path.join(root, "configs/inference/svd.yaml"), num_frames=t)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    unet = UNetModel(spec.unet_config).cuda()
    randomize_(unet, torch.Generator(device="cuda").manual_seed(1))
    g = torch.Generator(device="cuda").manual_seed(2)
    rn = lambda *s: torch.randn(*s, generator=g, device="cuda")
    with torch.no_grad():
        unet(rn(b, 16, 16, spec.unet_config.in_channels), rn(b), rn(b, 1, 1024), rn(b, 768), num_video_frames=t,
             image_only_indicator=torch.zeros(2, t, device="cuda"))
    torch.cuda.synchronize()
    report("unet fp32 forward [4,16,16] t=2", unet)
    del unet
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = train_path.unet_config(dtype=torch.float32, num_frames=t)
    with torch.device("cuda"):
        unet = UNetModel(cfg)
    randomize_(unet, torch.Generator(device="cuda").manual_seed(3))
    cond = {"crossattn": rn(b, 1, 1024), "vector": rn(b, 768), "concat": rn(b, 16, 16, 4)}
    loss = train_path.loss_module()(train_path.network_factory(t)(unet), rn(b, 16, 16, 4), cond,
                                    sigma=torch.exp(-1.2 + 1.2 * rn(b)), noise=rn(b, 16, 16, 4))
    loss.backward()
    torch.cuda.synchronize()
    report("train_grad fp32 forward + backward [4,16,16] t=2 remat", unet)
    del unet, loss, cond
    torch.cuda.empty_cache()


def time_normalised(torch, F, rn):
    """The normalise-first route at NF_SHAPES beside SDPA and beside the
    kernel that streams the keys (what ran there before the resident kernels),
    held to mha_reference."""
    from vidseg_diffusion_tpu_torch.ops import attention as A

    bf = torch.bfloat16
    for layout, b, lq, lk, h, d in NF_SHAPES:
        if layout == "blhd":
            q = rn(b, lq, h * d).to(bf)
            k, v = (rn(b, lk, h * d).to(bf) for _ in range(2))
            fn = A.flash_attention_packed
            old = lambda: A._flash_attention_packed_forward(q, k, v, h, None, save_lse=False, normalise_first=True,
                                                            streamed=True)
            nf = lambda: A.flash_attention_packed(q, k, v, h, normalise_first=True)
            view = lambda x: x.view(b, x.shape[1], h, d).transpose(1, 2)
            ref = A.mha_reference(*(x.view(b, x.shape[1], h, d) for x in (q, k, v)), layout="blhd").reshape(q.shape)
        else:
            q, k, v = (rn(b, h, lq, d).to(bf) for _ in range(3))
            fn = A.flash_attention
            old = lambda: A._flash_attention_forward(q, k, v, None, save_lse=False, normalise_first=True, streamed=True)
            nf = lambda: A.flash_attention(q, k, v, normalise_first=True)
            view = lambda x: x
            ref = A.mha_reference(q, k, v)
        out = nf()
        apart = (old() != out).float().mean().item()
        diff = (out.float() - ref.float()).abs()
        step = 2.0 ** (math.floor(math.log2(ref.float().abs().max().item())) - 7)
        before = routes(fn)
        nf()
        moved = {key: val - before[key] for key, val in routes(fn).items()}
        # in turns: the mode's kernel, the streaming one twice, the mode's again; SDPA twice
        turns = [graph_ms(torch, fn_) for fn_ in (nf, old, old, nf)]
        sdpa = lambda: F.scaled_dot_product_attention(view(q), view(k), view(v))
        lib = [graph_ms(torch, sdpa) for _ in range(2)]
        span = lambda xs: f"{min(xs):.4f}-{max(xs):.4f}"
        nbytes, flops = 2 * 2 * b * h * (lq + lk) * d, 4 * b * h * lq * lk * d
        print(f"normalise-first {layout} [{b},{lq}x{lk},{h}x{d}]: {span(turns[::3])} ms (SDPA {span(lib)}, the "
              f"kernel streaming the keys {span(turns[1:3])}, its output {apart:.2e} of the elements apart, bound "
              f"{bound_ms(nbytes, flops):.4f}); vs mha_reference {diff.max().item() / step:.2f} bf16 steps, "
              f"{(diff > 0).float().mean().item():.2e} of the elements differ; routes of one call {moved}",
              flush=True)
        del q, k, v, out, ref, diff
        torch.cuda.empty_cache()


def time_group_norm_backward(torch, F, rn):
    """The GroupNorm backward as GroupNormFn's backward calls it (ops.norm:
    the slab kernel or K9 + K10, by group_norm_backward_route), at
    GN_BWD_SITES, beside autograd.grad through F.group_norm (+ F.silu) on the
    channels-last view (profiled device time), held to the plain backward;
    where the route is the slab kernel, also K9 + K10 at the same site (the
    other route); where it is K9 + K10, each of the two launches alone, K10
    with its rate (x and dy read, dx written)."""
    from vidseg_diffusion_tpu_torch.ops import norm as N

    dtypes = {"bf16": torch.bfloat16, "fp32": torch.float32}
    for shape, dt, silu, eps in GN_BWD_SITES:
        dtype, c = dtypes[dt], shape[-1]
        x = (rn(*shape) * 1.5 + 0.3).to(dtype)
        dy = rn(*shape).to(dtype)
        w, b = (rn(c) * 0.5 + 1.0).to(dtype), rn(c).to(dtype)
        nbytes = 3 * x.numel() * x.element_size()   # x and dy read once, dx written once
        with torch.no_grad():
            _, a, s, mean, inv = N._forward(x, w, b, 32, eps, silu)
            args = (x, dy, w, a, s, mean, inv)
            route, plan = N.group_norm_backward_route(shape[0], x.numel() // (shape[0] * c), c, 32,
                                                      x.element_size(), True)
            route += f" {plan.n}" if route == "cluster" else ""
            steps, rms = errors(N._backward(*args, 32, silu)[0], N.group_norm_backward_plain(*args, 32, silu)[0])
            ms = graph_ms(torch, lambda: N._backward(*args, 32, silu), 5)

            def stream():
                coef = N.group_norm_backward_stats(*args, 32, silu)[0]
                return N.group_norm_backward_apply(x, dy, a, s, coef, silu)

            if route == "stream":
                coef = N.group_norm_backward_stats(*args, 32, silu)[0]
                k9 = graph_ms(torch, lambda: N.group_norm_backward_stats(*args, 32, silu), 5)
                k10 = graph_ms(torch, lambda: N.group_norm_backward_apply(x, dy, a, s, coef, silu), 5)
                other = (f"; K9 alone {k9:.4f}, K10 alone {k10:.4f} ({nbytes / k10 / 1e9:.2f} TB/s, "
                         f"{100 * nbytes / k10 / 1e9 / (HBM_BYTES_PER_S / 1e12):.0f}% of 3.35 TB/s)")
                # where a cluster of 8 or 16 would hold the slab but the batch has too many
                # items for it (ops.norm._BWD_STREAM_ITEMS), the slab kernel on that cluster too
                items = N._BWD_STREAM_ITEMS
                N._BWD_STREAM_ITEMS = math.inf
                try:
                    held, plan = N.group_norm_backward_route(shape[0], x.numel() // (shape[0] * c), c, 32,
                                                             x.element_size(), True)
                    if held == "cluster":
                        slab = graph_ms(torch, lambda: N.group_norm_backward_slab(*args, 32, silu), 5)
                        other += f"; the slab kernel on a cluster of {plan.n} here {slab:.4f}"
                finally:
                    N._BWD_STREAM_ITEMS = items
            else:
                other = f"; K9 + K10 here {graph_ms(torch, stream, 5):.4f}"
        cl = lambda t: t.permute(0, t.dim() - 1, *range(1, t.dim() - 1))   # the channels-last view
        leaves = [cl(x).detach().requires_grad_(), w.detach().requires_grad_(), b.detach().requires_grad_()]
        y = F.group_norm(leaves[0], 32, leaves[1], leaves[2], eps)
        y = F.silu(y) if silu else y
        lib_ms = profiled_ms(torch, lambda: torch.autograd.grad(y, leaves, cl(dy), retain_graph=True))
        bound = bound_ms(nbytes, 0)
        print(f"GroupNorm backward ({route}) {'+SiLU ' if silu else ''}{list(shape)} {dt}: {ms:.4f} ms "
              f"({ms / bound:.2f}x bound {bound:.4f}; library backward {fmt_ms(lib_ms)}){other}, dx {steps:.2e} "
              f"{'bf16 steps' if dt == 'bf16' else 'relative'}, rel. RMS {rms:.2e}", flush=True)
        del x, dy, leaves, y, args
        torch.cuda.empty_cache()


def main():
    import torch
    import torch.nn.functional as F

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--only",
                        default="k11,k1,k4,gn,k2,k6,k5,k13,nf,gnb,k5w,k6w,x3,k5d16,fp32,long,short,x3d64,x3mm,"
                                "x3k1,x3k4",
                        help="comma-separated: k11, k1, k4, gn, k2, k6, k5, k13, nf, gnb, k5w, k6w, x3, k5d16, fp32, "
                             "long, short, x3d64, x3mm, x3k1, x3k4, mem (not in the default)")
    parser.add_argument("--root", default=None,
                        help="import vidseg_diffusion_tpu_torch (and build its kernels) from this checkout")
    args = parser.parse_args()
    only = set(args.only.split(","))
    if args.root:   # that checkout's package, even where `-m` has imported this one's
        sys.path.insert(0, os.path.abspath(args.root))
        for name in [m for m in sys.modules if m.split(".")[0] == "vidseg_diffusion_tpu_torch"]:
            del sys.modules[name]
    from vidseg_diffusion_tpu_torch.ops import _cuda
    from vidseg_diffusion_tpu_torch.ops import attention as A
    from vidseg_diffusion_tpu_torch.ops import matmul as MM

    if not torch.cuda.is_available():
        raise SystemExit("time_kernels needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}; kernels of "
          f"{os.path.dirname(os.path.dirname(_cuda.CSRC))}", flush=True)
    _cuda.load_library()
    with open(os.path.join(_cuda.BUILD_DIR, "build.log")) as f:
        log = f.read().splitlines()
    for i, line in enumerate(log):
        if "Function properties for" in line and any(n in line for n in ("wgmma", "temporal_attn", "mma_kernel",
                                                                         "tf32x3", "x3_kernel")):
            print("ptxas:", line.split("for ")[-1], "|", " | ".join(s.strip() for s in log[i + 1:i + 3]))
        if "C7512" in line:
            print("ptxas:", line.strip())

    # fp32 library calls in full fp32, as the kernels compute (restored at the end)
    saved_tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        run(torch, F, A, MM, only)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved_tf32


def run(torch, F, A, MM, only):
    g = torch.Generator(device="cuda").manual_seed(0)
    rn = lambda *s: torch.randn(*s, generator=g, device="cuda")
    bf = torch.bfloat16
    if "x3" in only:
        time_x3(torch, F, rn)
    if "x3d64" in only:
        time_x3_d64(torch, F, rn)
    if "x3mm" in only:
        time_x3_mm(torch, F, rn, MM)
    if "x3k1" in only:
        time_x3_k1(torch, F, rn)
    if "x3k4" in only:
        time_x3_k4(torch, F, rn)
    if "mem" in only:
        time_memory(torch)
    if "k4" in only:
        time_tconv(torch, F, rn)
    if "gn" in only:
        time_group_norm(torch, F, rn)
    if only & {"k2", "k6"}:
        time_temporal(torch, F, rn, only)
    if only & {"k5", "k13", "k5w"}:
        time_flash_backward(torch, F, rn, only)
    if "k6w" in only:
        time_temporal_wide_backward(torch, F, rn)
    if "long" in only:
        time_long_frames(torch, F, rn)
    if "short" in only:
        time_short_frames(torch, F, rn)
    if "k5d16" in only:
        time_k5_d16(torch, F, rn)
    if "fp32" in only:
        time_fp32_d64(torch, F, rn)
    if "nf" in only:
        time_normalised(torch, F, rn)
    if "gnb" in only:
        time_group_norm_backward(torch, F, rn)
    for m, k, n, with_bias in MM_SHAPES if "k11" in only else ():
        x, w = rn(m, k).to(bf), (rn(n, k) / k ** 0.5).to(bf)
        b = rn(n).to(bf) if with_bias else None
        ref = MM.matmul_bias_plain(x, w, b)
        lib_ms = graph_ms(torch, lambda: F.linear(x, w, b))
        steps, rms = errors(MM.matmul_bias(x, w, b), ref)
        ms = graph_ms(torch, lambda: MM.matmul_bias(x, w, b))
        print(f"K11 [{m},{k}->{n}]{' bias' if with_bias else ''}: {ms:.4f} ms (F.linear "
              f"{lib_ms:.4f}), {steps:.2f} bf16 steps, rel. RMS {rms:.2e}", flush=True)
        del x, w, b, ref
    for b, lq, lk, h in ATTN_SHAPES if "k1" in only else ():
        q = rn(b, lq, h * 64).to(bf)
        k, v = (rn(b, lk, h * 64).to(bf) for _ in range(2))
        heads = lambda t: t.view(b, t.shape[1], h, 64).transpose(1, 2)
        lib_ms = graph_ms(torch, lambda: F.scaled_dot_product_attention(heads(q), heads(k), heads(v)), 5)
        # the plain version holds [B, H, Lq, Lk] fp32 logits: compared up to 2 GB of them
        ref = (A.flash_attention_packed_reference(q, k, v, h, save_lse=True)
               if b * h * lq * lk * 4 <= 2e9 else None)
        out, lse = A._flash_attention_packed_forward(q, k, v, h, None, save_lse=True)
        check = ""
        if ref is not None:
            steps, rms = errors(out, ref[0])
            check = (f", {steps:.2f} bf16 steps, rel. RMS {rms:.2e}, LSE "
                     f"{(lse - ref[1]).abs().max().item():.2e}")
        ms = graph_ms(torch, lambda: A.flash_attention_packed(q, k, v, h), 5)
        print(f"K1 [{b},{lq}x{lk},{h}x64]: {ms:.4f} ms (SDPA {lib_ms:.4f}){check}", flush=True)
        del q, k, v, ref
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
