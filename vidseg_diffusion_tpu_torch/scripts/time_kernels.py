"""Device time of K1 (flash_attention_packed), K11 (matmul_bias), K4
(temporal_conv_1x1), the GroupNorm forward, K2 (temporal_attention_direct)
and its backward K6, the flash backwards K5 and K13, the normalise-first
route of K1 and K3, and the GroupNorm backward at the main paths'
shapes, beside the one PyTorch call for the same function, on one CUDA card.

    python3 -m vidseg_diffusion_tpu_torch.scripts.time_kernels [--only k11,k1,k4,gn,k2,k6,k5,k13,nf,gnb,k5w,k6w]

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
1 x 512], a CUDA graph beside SDPA's backward, profiled) and K6's wide kernel
(`k6w`: [t, 5824, 1, 512] at t = 7 and 14, bf16 and fp32, CUDA events and a
graph beside SDPA's backward on the canonical view, whose backend is named).
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
# (t, S): K6 at D = 512, the VideoAttnBlock's time mix on that clip and on a 14-latent decode
K6_WIDE_SHAPES = [(7, 5824), (14, 5824)]
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
HBM_BYTES_PER_S, BF16_FLOPS = 3.35e12, 989e12


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


def bound_ms(nbytes, flops):
    return max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS) * 1e3


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
    """K6 at D = 512 (the wide kernel) at K6_WIDE_SHAPES in bf16 and fp32, CUDA
    events and a graph, beside SDPA's backward on the canonical view
    ([1, S, 1, t, 512], strided) with CUDA events, held to the plain version;
    the SDPA backends that take the view named."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from vidseg_diffusion_tpu_torch.ops import attention as A

    for t, s in K6_WIDE_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v, g = (rn(t, s, 1, 512).to(dtype) for _ in range(4))
            frames = lambda x: x.view(1, t, s, 1, 512).permute(0, 2, 3, 1, 4)
            o = A.temporal_attention_direct(q, k, v, t=t)
            got = A.temporal_attention_direct_backward(q, k, v, o, g, t=t)
            ref = A.temporal_attention_direct_backward_reference(q, k, v, o, g, t=t)
            unit = "bf16 steps" if dtype == torch.bfloat16 else "relative"
            check = ", ".join(f"%.2e {unit}, rel. RMS %.2e" % errors(x, r) for x, r in zip(got, ref))
            takes = []
            for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.CUDNN_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
                            SDPBackend.MATH):
                try:
                    with sdpa_kernel([backend]):
                        F.scaled_dot_product_attention(*(frames(x) for x in (q, k, v)))
                    takes.append(backend.name)
                except RuntimeError:
                    pass
            leaves = [frames(x).detach().requires_grad_() for x in (q, k, v)]
            y = F.scaled_dot_product_attention(*leaves)
            lib_ms = events_ms(torch, lambda: torch.autograd.grad(y, leaves, frames(g), retain_graph=True))
            before = routes(A.temporal_attention_direct_backward)
            ms = events_ms(torch, lambda: A.temporal_attention_direct_backward(q, k, v, o, g, t=t))
            dev_ms = graph_ms(torch, lambda: A.temporal_attention_direct_backward(q, k, v, o, g, t=t), 5)
            moved = {key: val - before[key] for key, val in routes(A.temporal_attention_direct_backward).items()}
            item = q.element_size()
            nbytes, flops = 8 * item * q.numel(), 10 * t * t * 512 * s
            print(f"K6 D=512 [{t},{s},1,512] t={t} {str(dtype)[6:]} (CUDA events): {ms:.4f} ms (SDPA backward "
                  f"{lib_ms:.4f}, backends taking the view {takes}; bound {bound_ms(nbytes, flops):.4f}; device time "
                  f"{dev_ms:.4f}), {check}; routes over the timed launches {moved}", flush=True)
            del q, k, v, g, o, got, ref, leaves, y
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

    from vidseg_diffusion_tpu_torch.ops import _cuda
    from vidseg_diffusion_tpu_torch.ops import attention as A
    from vidseg_diffusion_tpu_torch.ops import matmul as MM

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--only", default="k11,k1,k4,gn,k2,k6,k5,k13,nf,gnb,k5w,k6w",
                        help="comma-separated: k11, k1, k4, gn, k2, k6, k5, k13, nf, gnb, k5w, k6w")
    only = set(parser.parse_args().only.split(","))
    if not torch.cuda.is_available():
        raise SystemExit("time_kernels needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    _cuda.load_library()
    with open(os.path.join(_cuda.BUILD_DIR, "build.log")) as f:
        log = f.read().splitlines()
    for i, line in enumerate(log):
        if "Function properties for" in line and any(n in line for n in ("wgmma", "temporal_attn", "mma_kernel")):
            print("ptxas:", line.split("for ")[-1], "|", " | ".join(s.strip() for s in log[i + 1:i + 3]))
        if "C7512" in line:
            print("ptxas:", line.strip())

    g = torch.Generator(device="cuda").manual_seed(0)
    rn = lambda *s: torch.randn(*s, generator=g, device="cuda")
    bf = torch.bfloat16
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
