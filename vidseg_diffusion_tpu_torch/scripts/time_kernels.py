"""Device time of K1 (flash_attention_packed), K11 (matmul_bias), K4
(temporal_conv_1x1) and the GroupNorm forward at the main paths' shapes,
beside the one PyTorch call for the same function, on one CUDA card.

    python3 -m vidseg_diffusion_tpu_torch.scripts.time_kernels [--only k11,k1,k4,gn]

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
channels-last view. Each row carries its bound (bytes over 3.35 TB/s or
operations over 989 TFLOP/s, whichever is larger). Each output is also held
to the plain version (bf16 steps at max |plain|, relative RMS error; K1's
LSE too). Prints the card's name and power limit and ptxas's register /
spill lines for the wgmma kernels.
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


def main():
    import torch
    import torch.nn.functional as F

    from vidseg_diffusion_tpu_torch.ops import _cuda
    from vidseg_diffusion_tpu_torch.ops import attention as A
    from vidseg_diffusion_tpu_torch.ops import matmul as MM

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--only", default="k11,k1,k4,gn", help="comma-separated: k11, k1, k4, gn")
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
        if "Function properties for" in line and "wgmma" in line:
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
