#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA H100 (needs CUDA; no JAX).

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:
1. card: print `nvidia-smi --query-gpu=name,power.limit`.
2. build: compile the kernels from vidseg_diffusion_tpu_torch/csrc with nvcc
   (one process per source, in parallel).
3. kernels: each kernel (K1-K6) against its plain PyTorch version on the same
   bf16 inputs at the shapes of its path (K1-K4 inference, K5/K6 and K4's dx
   launch training); errors within the stated bounds, kernel and plain
   times with CUDA events; K1's saved LSE against the plain LSE.
4. unet: one full-width SVD UNet forward in fp32 (random weights, a 16x16
   latent, 2 frames) on the card through the kernels vs the same weights on
   the CPU through the plain versions.
5. train_grad: the same UNet in fp32 with remat, loss.backward() of the
   diffusion loss (explicit sigma and noise) on the card through the
   kernels and their backward kernels vs the CPU through the plain
   versions; every parameter's gradient within a relative bound by norm.
6. main: the run of vidseg_diffusion_tpu_torch/scripts/main_path.py
   (configs/inference/svd.yaml at full width with random bf16 weights,
   run_single_video on 14 synthetic 448x832 frames, 25 steps, modulate step
   17, 2 masks, decoding_t 7) under torch.no_grad; the inference kernels
   must launch exactly as many times as the configuration implies (K1 832,
   K2 832, K3 43, K4 2520), the backward kernels and the plain versions
   never; latents and labels must be finite and shaped; the +lambda and
   -lambda runs must differ, and the outside-mask latents must equal the
   cached trajectory exactly.
7. train: the full-width training step of
   vidseg_diffusion_tpu_torch/scripts/train_path.py (svd.yaml UNet, bf16,
   remat, 2 x 14 frames of 56x104 latents, Adam, EMA): a warm-up step, then
   TRAIN_STEPS steps; the loss finite at every step, every gradient finite,
   the self-attention q/k/v projections' gradients non-zero (spatial and
   temporal), the last step taken by every parameter with a gradient and
   by the EMA (check_last_update), K1, K2, K4, K5 and K6 launched and no
   plain version called; step time and peak memory.

Before the last line come the kernels JSON (per kernel: launches in the run
of its path, worst error, kernel and plain ms at its headline shape) and the
card's name and power limit; the last line is {"ok": true, "device": ...}.
"""

import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

KERNELS = {
    "flash_attention_packed": dict(
        id="K1", source="vidseg_diffusion_tpu_torch/csrc/flash_attention.cu",
        replaces="vidseg_diffusion_tpu/ops/attention.py:527", rms_tol=4e-3,
    ),
    "temporal_attention_direct": dict(
        id="K2", source="vidseg_diffusion_tpu_torch/csrc/temporal_attention.cu",
        replaces="vidseg_diffusion_tpu/ops/attention.py:1458", rms_tol=1e-3,
    ),
    "flash_attention": dict(
        id="K3", source="vidseg_diffusion_tpu_torch/csrc/flash_attention.cu",
        replaces="vidseg_diffusion_tpu/ops/attention.py:297", rms_tol=4e-3,
    ),
    "temporal_conv_1x1": dict(
        id="K4", source="vidseg_diffusion_tpu_torch/csrc/temporal_conv.cu",
        replaces="vidseg_diffusion_tpu/ops/temporal_conv.py:103", rms_tol=5e-4,
    ),
    "flash_attention_packed_backward": dict(
        id="K5", source="vidseg_diffusion_tpu_torch/csrc/flash_attention_bwd.cu",
        replaces="vidseg_diffusion_tpu/ops/attention.py:993", rms_tol=1e-3,
    ),
    "temporal_attention_direct_backward": dict(
        id="K6", source="vidseg_diffusion_tpu_torch/csrc/temporal_attention_bwd.cu",
        replaces="vidseg_diffusion_tpu/ops/attention.py:1167", rms_tol=2e-4,
    ),
}
INFERENCE_KERNELS = ("flash_attention_packed", "temporal_attention_direct", "flash_attention",
                     "temporal_conv_1x1")
TRAIN_KERNELS = ("flash_attention_packed", "temporal_attention_direct", "temporal_conv_1x1",
                 "flash_attention_packed_backward", "temporal_attention_direct_backward")
# launches of the inference main path, implied by its configuration: 52 UNet
# calls x 16 spatial / 16 temporal self-attention sites and 44 temporal
# convs (+ 29 per decoder chunk x 8), 32 CLIP layers + 11 VAE attentions
MAIN_LAUNCHES = {"flash_attention_packed": 832, "temporal_attention_direct": 832,
                 "flash_attention": 43, "temporal_conv_1x1": 2520}
# Kernel output vs plain version, both from the same bf16 inputs: the plain
# version computes in fp32 and rounds once to bf16; the kernel accumulates in
# fp32 in another order, so elements may land one bf16 step apart. Bounds:
# - max |kernel - plain| <= MAX_STEPS bf16 steps at max |plain| (a step there
#   is 2**(floor(log2 max|plain|) - 7)); the sound readings are 0-1 step;
# - ||kernel - plain||_2 <= rms_tol * ||plain||_2, per kernel above, from its
#   sound readings at these shapes (PERF.md): K1 and K3 read 1.3e-3 to 2.4e-3
#   (online softmax rounds p to bf16 against a running max), K4 1e-5 to
#   1.4e-4 (its dx launch included), K2 0 (bit for bit), K5 4.8e-5 to 2.2e-4,
#   K6 2.2e-5 to 3.9e-5 (worst of dq/dk/dv). A fault that moves every output
#   by 1% reads 1e-2.
MAX_STEPS = 2
UNET_REL_TOL = 1e-4     # fp32 UNet, card (kernels) vs CPU (plain versions), x max |CPU|
LSE_TOL = 5e-3          # K1's base-2 LSE vs the plain LSE, absolute (log2 units; reads <= 1.5e-3)
# fp32 UNet gradients, card vs CPU, for every parameter:
# ||g_card - g_cpu|| <= GRAD_REL_TOL * max(||g_cpu||, GRAD_FLOOR * the largest
# parameter gradient norm) (the forward agrees to ~5e-6 of its scale and the
# worst gradient reads 2.6e-6; the floor covers gradients that are 0 up to
# rounding, as the CPU tests found for biases that feed a GroupNorm group)
GRAD_REL_TOL = 1e-4
GRAD_FLOOR = 1e-3
TRAIN_STEPS = 3


def fail(msg):
    raise RuntimeError(f"chip_smoke: {msg}")


def check(cond, msg):
    if not cond:
        fail(msg)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    check(out, "nvidia-smi printed nothing")
    return out[0]


def time_ms(fn, iters, warmup=1):
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def kernel_cases(torch):
    """(kernel, label, inputs builder, kernel call, plain call, timing iters)
    at the main-path shapes (swan: 14 frames at 448x832, CFG batch 28)."""
    from vidseg_diffusion_tpu_torch.ops import attention as A
    from vidseg_diffusion_tpu_torch.ops import temporal_conv as TC

    dev, bf = "cuda", torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(0)
    rn = lambda *s: torch.randn(*s, generator=g, device=dev, dtype=torch.float32)

    def packed(b, l, h):
        return lambda: tuple(rn(b, l, h * 64).to(bf) for _ in range(3)) + (h,)

    def direct(b, s, h):
        return lambda: tuple(rn(b, s, h, 64).to(bf) for _ in range(3))

    def bhld(b, h, l, d):
        return lambda: tuple(rn(b, h, l, d).to(bf) for _ in range(3))

    def tconv(b, t, m, cin, cout):
        return lambda: (rn(b, t, m, cin).to(bf), (rn(3, cin, cout) / (3 * cin) ** 0.5).to(bf),
                        rn(cout).to(bf))

    def packed_bwd(b, l, h):
        """(q, k, v, out, lse, g, heads) with out and lse from K1's save_lse
        forward; K1's LSE is checked against the plain LSE here."""
        def make():
            q, k, v, g = (rn(b, l, h * 64).to(bf) for _ in range(4))
            out, lse = A._flash_attention_packed_forward(q, k, v, h, None, save_lse=True)
            _, lse_ref = A.flash_attention_packed_reference(q, k, v, h, save_lse=True)
            err = (lse - lse_ref).abs().max().item()
            print(f"[kernels] K1 save_lse [{b},{l},{h}x64]: max |lse - plain| = {err:.3e} "
                  f"(tol {LSE_TOL:.0e})", flush=True)
            check(err <= LSE_TOL, f"K1 LSE disagrees with the plain LSE: {err}")
            return q, k, v, out, lse, g, h
        return make

    def temporal_bwd(b, s, h):
        def make():
            q, k, v, g = (rn(b, s, h, 64).to(bf) for _ in range(4))
            return q, k, v, A.temporal_attention_direct(q, k, v, t=14), g
        return make

    def tconv_bwd(b, t, m, c):
        return lambda: (rn(b, t, m, c).to(bf), (rn(3, c, c) / (3 * c) ** 0.5).to(bf),
                        rn(b, t, m, c).to(bf))

    cases = []
    # K1: spatial self-attention; ds1 compared on a B=2 slice of the CFG batch
    # (the plain version would hold ~19 GB of fp32 logits at B=28)
    for label, b, l, h in (("ds1 B=2 slice [2,5824,5x64]", 2, 5824, 5),
                           ("ds2 [28,1456,10x64]", 28, 1456, 10),
                           ("ds4 [28,364,20x64]", 28, 364, 20),
                           ("mid [28,91,20x64]", 28, 91, 20)):
        cases.append(("flash_attention_packed", label, packed(b, l, h),
                      A.flash_attention_packed, A.flash_attention_packed_reference, 3))
    # K2: temporal self-attention, t = 14 frames, two videos (uc, c)
    for label, s, h in (("ds1 [28,5824,5,64] t=14", 5824, 5), ("ds2 [28,1456,10,64] t=14", 1456, 10),
                        ("ds4 [28,364,20,64] t=14", 364, 20), ("mid [28,91,20,64] t=14", 91, 20)):
        cases.append(("temporal_attention_direct", label, direct(28, s, h),
                      lambda q, k, v: A.temporal_attention_direct(q, k, v, t=14),
                      lambda q, k, v: A.temporal_attention_direct_reference(q, k, v, t=14), 5))
    # K3: VAE mid attention (one 512-dim head, decoding_t = 7 frames) and CLIP
    cases.append(("flash_attention", "VAE mid [7,1,5824,512]", bhld(7, 1, 5824, 512),
                  A.flash_attention, A.flash_attention_reference, 2))
    cases.append(("flash_attention", "CLIP ViT-H [1,16,257,80]", bhld(1, 16, 257, 80),
                  A.flash_attention, A.flash_attention_reference, 5))
    # K4: UNet time_stack per level (two videos of 14 frames), VAE decoder
    # time_stack per level and conv_out_time_mix (decoding_t = 7)
    for label, b, t, m, ci, co in (
        ("UNet ds1 [2,14,5824,320]", 2, 14, 5824, 320, 320),
        ("UNet ds2 [2,14,1456,640]", 2, 14, 1456, 640, 640),
        ("UNet ds4 [2,14,364,1280]", 2, 14, 364, 1280, 1280),
        ("UNet ds8 [2,14,91,1280]", 2, 14, 91, 1280, 1280),
        ("VAE 56x104 [1,7,5824,512]", 1, 7, 5824, 512, 512),
        ("VAE 112x208 [1,7,23296,512]", 1, 7, 23296, 512, 512),
        ("VAE 224x416 [1,7,93184,256]", 1, 7, 93184, 256, 256),
        ("VAE 448x832 [1,7,372736,128]", 1, 7, 372736, 128, 128),
        ("VAE conv_out_time_mix [1,7,372736,3]", 1, 7, 372736, 3, 3),
    ):
        cases.append(("temporal_conv_1x1", label, tconv(b, t, m, ci, co),
                      TC.temporal_conv_1x1, TC.temporal_conv_1x1_reference, 3))
    # training path (the train phase's batch of 2 videos x 14 frames):
    # K4's dx launch inside the temporal-conv backward (dW/db are matmuls),
    # K5 at every spatial self-attention width (ds1 on a B=2 slice: the
    # plain backward holds several [B, H, L, L] fp32 tensors), K6 at every
    # temporal one
    for label, m, c in (("dx UNet ds1 [2,14,5824,320]", 5824, 320),
                        ("dx UNet ds4 [2,14,364,1280]", 364, 1280)):
        cases.append(("temporal_conv_1x1", label, tconv_bwd(2, 14, m, c),
                      TC.temporal_conv_1x1_backward, TC.temporal_conv_1x1_backward_reference, 3))
    for label, b, l, h in (("ds1 B=2 slice [2,5824,5x64]", 2, 5824, 5),
                           ("ds2 [28,1456,10x64]", 28, 1456, 10),
                           ("ds4 [28,364,20x64]", 28, 364, 20),
                           ("mid [28,91,20x64]", 28, 91, 20)):
        cases.append(("flash_attention_packed_backward", label, packed_bwd(b, l, h),
                      A.flash_attention_packed_backward, A.flash_attention_packed_backward_reference, 3))
    for label, s, h in (("ds1 [28,5824,5,64] t=14", 5824, 5), ("ds2 [28,1456,10,64] t=14", 1456, 10),
                        ("ds4 [28,364,20,64] t=14", 364, 20), ("mid [28,91,20,64] t=14", 91, 20)):
        cases.append(("temporal_attention_direct_backward", label, temporal_bwd(28, s, h),
                      lambda q, k, v, o, g: A.temporal_attention_direct_backward(q, k, v, o, g, t=14),
                      lambda q, k, v, o, g: A.temporal_attention_direct_backward_reference(
                          q, k, v, o, g, t=14), 3))
    return cases


def phase_kernels(torch):
    rows = []
    for kname, label, make, kern, plain, iters in kernel_cases(torch):
        args = make()
        out = kern(*args)
        torch.cuda.synchronize()
        ref = plain(*args)
        torch.cuda.synchronize()
        # a backward returns several gradients: each is held to the bounds
        outs, refs = (out, ref) if isinstance(out, tuple) else ((out,), (ref,))
        rms_tol = KERNELS[kname]["rms_tol"]
        ok, err, rms, steps, peak = True, 0.0, 0.0, 0.0, 0.0
        for o, r in zip(outs, refs):
            check(o.shape == r.shape and o.dtype == r.dtype, f"{kname} {label}: shape/dtype")
            diff = o.float() - r.float()
            e = diff.abs().max().item()
            pk = r.float().abs().max().item()
            rm = diff.norm().item() / max(r.float().norm().item(), 1e-30)
            step = 2.0 ** (math.floor(math.log2(pk)) - 7) if pk > 0 else 0.0
            ok = ok and e <= MAX_STEPS * step and rm <= rms_tol and bool(torch.isfinite(o).all())
            err, rms, peak = max(err, e), max(rms, rm), max(peak, pk)
            steps = max(steps, e / step if step else (0.0 if e == 0 else math.inf))
            del diff
        ms = time_ms(lambda: kern(*args), iters)
        plain_ms = time_ms(lambda: plain(*args), iters)
        row = dict(kernel=kname, shape=label, max_abs_err=err, bf16_steps=steps, max_abs_plain=peak,
                   rel_rms_err=rms, ok=ok, ms=ms, plain_ms=plain_ms)
        rows.append(row)
        print(f"[kernels] {KERNELS[kname]['id']} {kname} {label}: max_abs_err={err:.3e} "
              f"({steps:.2f} bf16 steps at max|plain| {peak:.3e}, tol {MAX_STEPS}) "
              f"rel_rms_err={rms:.3e} (tol {rms_tol:.0e}) "
              f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms", flush=True)
        del args, out, ref, outs, refs
        torch.cuda.empty_cache()
    bad = [r for r in rows if not r["ok"]]
    check(not bad, f"kernel disagrees with its plain version: {bad}")
    return rows


def phase_unet(torch):
    """Full-width UNet forward: kernels on the card vs plain versions on the
    CPU, same fp32 weights and inputs (TF32 off on the card)."""
    import copy

    from vidseg_diffusion_tpu_torch.config import load_model_spec
    from vidseg_diffusion_tpu_torch.engine.build import randomize_
    from vidseg_diffusion_tpu_torch.models.unet import UNetModel

    saved_tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    spec = load_model_spec(os.path.join(ROOT, "configs/inference/svd.yaml"), num_frames=2)
    unet = UNetModel(spec.unet_config).cuda()
    randomize_(unet, torch.Generator(device="cuda").manual_seed(1))
    cpu_unet = copy.deepcopy(unet).cpu()
    g = torch.Generator().manual_seed(2)
    t, b = 2, 4  # [uc; c] of one 2-frame video
    x = torch.randn(b, 16, 16, 8, generator=g)
    ts = torch.randn(b, generator=g)
    ctx = torch.randn(b, 1, 1024, generator=g)
    y = torch.randn(b, 768, generator=g)
    ioi = torch.zeros(2, t)
    with torch.no_grad():
        ref = cpu_unet(x, ts, ctx, y, num_video_frames=t, image_only_indicator=ioi)
        out = unet(x.cuda(), ts.cuda(), ctx.cuda(), y.cuda(), num_video_frames=t,
                   image_only_indicator=ioi.cuda()).cpu()
    err = (out - ref).abs().max().item()
    scale = ref.abs().max().item()
    print(f"[unet] full-width UNet fp32, card vs CPU: max_abs_err={err:.3e} "
          f"(tol {UNET_REL_TOL * scale:.3e})", flush=True)
    check(bool(torch.isfinite(out).all()), "UNet output not finite")
    check(err <= UNET_REL_TOL * scale, "UNet on the card disagrees with the CPU plain path")
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved_tf32
    del unet, cpu_unet
    torch.cuda.empty_cache()


def phase_train_grad(torch):
    """Full-width UNet gradients: loss.backward() on the card through the
    kernels (K1/K5, K2/K6, K4) vs the CPU through the plain versions, same
    fp32 weights, inputs, sigma and noise (TF32 off on the card)."""
    import copy
    import dataclasses

    from vidseg_diffusion_tpu_torch.engine.build import randomize_
    from vidseg_diffusion_tpu_torch.models.unet import UNetModel
    from vidseg_diffusion_tpu_torch.ops import attention as A
    from vidseg_diffusion_tpu_torch.scripts import train_path

    saved_tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t, b = 2, 4  # two 2-frame videos
    cfg = train_path.unet_config(dtype=torch.float32, num_frames=t)
    with torch.device("cuda"):
        unet = UNetModel(cfg)
    randomize_(unet, torch.Generator(device="cuda").manual_seed(3))
    cpu_unet = copy.deepcopy(unet).cpu()
    cpu_unet.config = dataclasses.replace(cfg, remat=False)  # same math, one forward less
    g = torch.Generator().manual_seed(4)
    latents = torch.randn(b, 16, 16, 4, generator=g)
    cond = {"crossattn": torch.randn(b, 1, 1024, generator=g), "vector": torch.randn(b, 768, generator=g),
            "concat": torch.randn(b, 16, 16, 4, generator=g)}
    sigma = torch.exp(-1.2 + 1.2 * torch.randn(b, generator=g))
    noise = torch.randn(b, 16, 16, 4, generator=g)
    loss_mod, factory = train_path.loss_module(), train_path.network_factory(t)

    def grads(model, dev):
        cd = {k: v.to(dev) for k, v in cond.items()}
        loss = loss_mod(factory(model), latents.to(dev), cd, sigma=sigma.to(dev), noise=noise.to(dev))
        loss.backward()
        return loss.item(), {n: p.grad for n, p in model.named_parameters()}

    launches = A.flash_attention_packed_backward.launches, A.temporal_attention_direct_backward.launches
    t0 = time.perf_counter()
    loss_card, g_card = grads(unet, "cuda")
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    check(A.flash_attention_packed_backward.launches > launches[0]
          and A.temporal_attention_direct_backward.launches > launches[1],
          "the card's backward did not launch K5 and K6")
    t0 = time.perf_counter()
    loss_cpu, g_cpu = grads(cpu_unet, "cpu")
    cpu_s = time.perf_counter() - t0
    worst, worst_name, n_none = 0.0, "", 0
    floor = GRAD_FLOOR * max(gc.norm().item() for gc in g_cpu.values() if gc is not None)
    for name, gc in g_cpu.items():
        gk = g_card[name]
        if gc is None or gk is None:
            check(gc is None and gk is None and feeds_one_key_query(name), f"gradient missing for {name}")
            n_none += 1
            continue
        check(bool(torch.isfinite(gk).all()), f"gradient of {name} not finite on the card")
        rel = (gk.cpu() - gc).norm().item() / max(gc.norm().item(), floor)
        if rel > worst:
            worst, worst_name = rel, name
    print(f"[train_grad] full-width UNet fp32 remat, loss card {loss_card:.6f} vs CPU {loss_cpu:.6f}; "
          f"{len(g_cpu) - n_none} parameter gradients, worst relative error by norm {worst:.3e} "
          f"({worst_name}; tol {GRAD_REL_TOL:.0e}); {n_none} one-key query/key parameters without one; "
          f"card {card_s:.1f} s, CPU {cpu_s:.1f} s", flush=True)
    check(abs(loss_card - loss_cpu) <= UNET_REL_TOL * abs(loss_cpu), "loss on the card disagrees with the CPU")
    check(worst <= GRAD_REL_TOL, f"gradient of {worst_name} on the card disagrees with the CPU: {worst}")
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved_tf32
    del unet, cpu_unet, g_card, g_cpu
    torch.cuda.empty_cache()


def feeds_one_key_query(name):
    """Parameters that only feed the query or key of a one-key cross-attention
    (attn2's q/k projections and the norm2 LayerNorm before them): the V
    shortcut leaves them without a gradient."""
    return any(s in name for s in ("attn2.to_q.", "attn2.to_k.", "norm2."))


def kernel_fns():
    from vidseg_diffusion_tpu_torch.ops import attention as A
    from vidseg_diffusion_tpu_torch.ops import temporal_conv as TC

    counters = list(A.KERNEL_COUNTERS) + [TC.temporal_conv_1x1]
    plains = list(A.PLAIN_COUNTERS) + [TC.temporal_conv_1x1_reference,
                                       TC.temporal_conv_1x1_backward_reference]
    return counters, plains


def reset_counts():
    counters, plains = kernel_fns()
    for f in counters:
        f.launches = 0
    for f in plains:
        f.calls = 0


def read_counts():
    counters, plains = kernel_fns()
    return {f.__name__: f.launches for f in counters}, {f.__name__: f.calls for f in plains}


def phase_main(torch):
    import numpy as np

    from vidseg_diffusion_tpu_torch.pipelines.single_video import run_single_video
    from vidseg_diffusion_tpu_torch.scripts import main_path

    t, hpx, wpx = main_path.NUM_FRAMES, main_path.HEIGHT, main_path.WIDTH
    t0 = time.perf_counter()
    pipe = main_path.build()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in pipe.unet.parameters())
    print(f"[main] built svd.yaml (UNet {n_params / 1e9:.3f} B params, bf16) in {build_s:.1f} s", flush=True)
    frames, names, args = main_path.frames(), main_path.frame_names(), main_path.vidseg_args()

    timings = {}
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    res = run_single_video(pipe, frames, names, args, write_outputs=False, timings=timings)
    total = time.perf_counter() - t0
    launches, plain_calls = read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"[main] run_single_video {total:.2f} s, stages_s "
          f"{json.dumps({k: round(v, 3) for k, v in timings.items()})}", flush=True)
    print(f"[main] kernel launches {json.dumps(launches)}; plain calls {json.dumps(plain_calls)}; "
          f"peak device memory {peak_gb:.1f} GB", flush=True)

    expected = {name: MAIN_LAUNCHES.get(name, 0) for name in launches}
    check(launches == expected, f"inference launches {launches}, expected {expected} (no backward)")
    check(all(n == 0 for n in plain_calls.values()), f"plain versions ran on the card: {plain_calls}")
    k = args.num_masks
    h, w = hpx // 8, wpx // 8
    fin = res.final_latents
    check(fin.shape == (2, k, t, h, w, 4), f"final latents shape {fin.shape}")
    check(np.isfinite(fin).all() and np.isfinite(res.feature_x0).all(), "latents not finite")
    check(res.seg_raw.shape == (t, hpx, wpx) and res.seg_filtered.shape == (t, hpx, wpx),
          f"label map shape {res.seg_raw.shape}")
    check(set(np.unique(res.seg_raw)) <= set(range(k)), "labels out of range")
    check(np.isfinite(res.diff_maps).all(), "difference maps not finite")
    dpm = float(np.abs(fin[0] - fin[1]).max())
    check(dpm > 0, "+lambda and -lambda runs are identical: modulation never reached the output")
    last = res.cached_xt[-1]
    outside = max(float(np.abs((fin[s, m] - last) * (1 - res.masks_latent[m][..., None])).max())
                  for s in range(2) for m in range(k))
    check(outside == 0.0, f"outside-mask latents deviate from the cached trajectory by {outside}")
    print(f"[main] max|+lambda - -lambda| = {dpm:.4f}; outside-mask deviation = {outside}; "
          f"labels used {sorted(int(v) for v in np.unique(res.seg_raw))}", flush=True)
    return launches


def phase_train(torch):
    """TRAIN_STEPS steps of the full-width training setup after a warm-up."""
    from vidseg_diffusion_tpu_torch.scripts import train_path

    t0 = time.perf_counter()
    trainer = train_path.build()
    latents, cond = train_path.batch()
    gens = train_path.generators()
    unet = trainer.model
    n_params = sum(p.numel() for p in unet.parameters())
    print(f"[train] built the svd.yaml UNet ({n_params / 1e9:.3f} B params, bf16, remat "
          f"{unet.config.remat}), Adam, EMA in {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    loss = trainer.step(latents, cond, generators=gens)
    torch.cuda.synchronize()
    print(f"[train] warm-up step {time.perf_counter() - t0:.2f} s, loss {loss.item():.5f}", flush=True)
    check(bool(torch.isfinite(loss)), "warm-up loss not finite")

    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    losses, times = [], []
    for i in range(TRAIN_STEPS):
        if i == TRAIN_STEPS - 1:  # the weights and EMA before the step that check_last_update reads
            params0 = [p.detach().clone() for p in unet.parameters()]
            ema0 = {n: e.clone() for n, e in trainer.ema.params.items()}
        t0 = time.perf_counter()
        loss = trainer.step(latents, cond, generators=gens)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(loss.item())
    launches, plain_calls = read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"[train] {TRAIN_STEPS} steps: step_s {[round(x, 4) for x in times]}, losses "
          f"{[round(x, 6) for x in losses]}, peak device memory {peak_gb:.2f} GB ({card_line()})",
          flush=True)
    print(f"[train] kernel launches {json.dumps(launches)}; plain calls {json.dumps(plain_calls)}",
          flush=True)

    check(all(math.isfinite(x) for x in losses), f"loss not finite: {losses}")
    missing = []
    for name, p in unet.named_parameters():
        if p.grad is None:
            missing.append(name)
            continue
        check(bool(torch.isfinite(p.grad).all()), f"gradient of {name} not finite")
    check(all(feeds_one_key_query(n) for n in missing), f"parameters without a gradient: {missing}")
    proj = [(n, p) for n, p in unet.named_parameters()
            if any(f"attn1.to_{x}." in n for x in "qkv") or "attn2.to_v." in n]
    n_temporal = sum(".time_stack." in n for n, _ in proj)
    check(n_temporal > 0 and len(proj) > n_temporal, "no spatial or temporal projections found")
    zero = [n for n, p in proj if p.grad is None or not bool(p.grad.abs().max() > 0)]
    check(not zero, f"attention projections with a zero gradient (a detached kernel?): {zero}")
    n_grad, n_due, n_moved = check_last_update(torch, trainer, params0, ema0)
    print(f"[train] {len(proj)} attention projections ({n_temporal} temporal) with non-zero gradients; "
          f"last step: {n_grad} parameters with a gradient took it, {n_due} were due to move by more "
          f"than a bf16 step and moved, {n_moved} moved in all; every EMA tensor updated", flush=True)
    check(all(launches[k] > 0 for k in TRAIN_KERNELS), f"a kernel of the training path never launched: {launches}")
    check(all(n == 0 for n in plain_calls.values()), f"plain versions ran on the card: {plain_calls}")
    del trainer, unet, params0, ema0
    torch.cuda.empty_cache()
    return launches


def check_last_update(torch, trainer, params0, ema0):
    """The trainer's last step against its Adam state and the weights and
    EMA from before it: every parameter with a gradient took every step,
    each of its elements whose update (recomputed in fp32 from the state)
    exceeds one bf16 step of the element's value changed, every other
    parameter stayed, and every EMA tensor is the LitEma update of its old
    value towards the new weights. (An element's update can be smaller than
    half a bf16 step: the q/k projections' gradients at N(0, 0.02) weights
    are ~1e-15, so Adam moves them by ~1e-11.) Returns the counts of
    parameters with a gradient, due to move, and moved."""
    group = trainer.optimizer.param_groups[0]
    lr, (b1, b2), eps = group["lr"], group["betas"], group["eps"]
    check(group["weight_decay"] == 0 and not group["amsgrad"], "check_last_update reads plain Adam")
    n_grad = n_due = n_moved = 0
    for (name, p), p0 in zip(trainer.model.named_parameters(), params0):
        moved = not torch.equal(p, p0)
        n_moved += moved
        if p.grad is None:
            check(not moved, f"{name} has no gradient but moved")
            continue
        n_grad += 1
        state = trainer.optimizer.state[p]
        check("step" in state, f"{name} has a gradient and no optimizer state")
        step = int(state["step"])
        check(step == trainer.step_count, f"{name} took {step} of {trainer.step_count} optimizer steps")
        update = (lr / (1 - b1 ** step) * state["exp_avg"].float()
                  / ((state["exp_avg_sq"].float() / (1 - b2 ** step)).sqrt() + eps))
        bf16_step = torch.exp2(torch.log2(p0.float().abs()).clamp(min=-126) - 7)
        due = update.abs() > bf16_step
        n_due += bool(due.any())
        check(bool((p[due] != p0[due]).all()), f"{name}: elements due to move by more than a bf16 step did not")
    n = trainer.ema.num_updates
    d = min(trainer.ema_decay, (1.0 + n) / (10.0 + n))
    for (name, p) in trainer.model.named_parameters():
        e0 = ema0[name]
        check(torch.equal(trainer.ema.params[name], e0 - (e0 - p.detach()) * (1.0 - d)),
              f"the EMA of {name} did not take the last step's update")
    return n_grad, n_due, n_moved


def main():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs an NVIDIA card")
    sys.path.insert(0, ROOT)
    from vidseg_diffusion_tpu_torch.ops import _cuda

    card = card_line()
    print(f"[card] {card}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    _cuda.load_library()
    print(f"[build] kernels built and loaded in {time.perf_counter() - t0:.1f} s", flush=True)
    log = os.path.join(_cuda.BUILD_DIR, "build.log")
    if os.path.isfile(log):  # ptxas's register / spill report of the last build
        with open(log) as f:
            ptxas = [line.strip() for line in f if "registers" in line or "spill" in line]
        regs = [int(s.split("Used ")[1].split()[0]) for s in ptxas if "Used " in s]
        spills = sum(int(s.split(" bytes spill stores")[0].split()[-1]) for s in ptxas if "spill stores" in s)
        print(f"[build] ptxas: {len(regs)} kernel instances, registers {min(regs)}-{max(regs)}, "
              f"spill stores {spills} bytes", flush=True)

    phases = {}
    t0 = time.perf_counter()
    rows = phase_kernels(torch)
    phases["kernels"] = time.perf_counter() - t0
    for name, fn in (("unet", phase_unet), ("train_grad", phase_train_grad)):
        t0 = time.perf_counter()
        fn(torch)
        phases[name] = time.perf_counter() - t0
    t0 = time.perf_counter()
    launches = phase_main(torch)
    phases["main"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    train_launches = phase_train(torch)
    phases["train"] = time.perf_counter() - t0
    print(f"[phases] seconds {json.dumps({k: round(v, 1) for k, v in phases.items()})}", flush=True)

    headline = {  # the shape of its path each kernel is timed at
        "flash_attention_packed": "ds1 B=2 slice [2,5824,5x64]",
        "temporal_attention_direct": "ds1 [28,5824,5,64] t=14",
        "flash_attention": "VAE mid [7,1,5824,512]",
        "temporal_conv_1x1": "UNet ds1 [2,14,5824,320]",
        "flash_attention_packed_backward": "ds1 B=2 slice [2,5824,5x64]",
        "temporal_attention_direct_backward": "ds1 [28,5824,5,64] t=14",
    }
    kernels = []
    for name, meta in KERNELS.items():
        mine = [r for r in rows if r["kernel"] == name]
        head = next(r for r in mine if r["shape"] == headline[name])
        kernels.append(dict(
            name=name, route="cuda", source=meta["source"], replaces=meta["replaces"],
            # the run of its path: inference for K1-K4, training for K5/K6
            launches=launches[name] if name in INFERENCE_KERNELS else train_launches[name],
            train_launches=train_launches[name], max_abs_err=max(r["max_abs_err"] for r in mine),
            ms=head["ms"], plain_ms=head["plain_ms"],
        ))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
