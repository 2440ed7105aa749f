#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA H100 (needs CUDA; no JAX).

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:
1. card: print `nvidia-smi --query-gpu=name,power.limit`.
2. build: compile the kernels from vidseg_diffusion_tpu_torch/csrc with nvcc.
3. kernels: each kernel (K1-K4) against its plain PyTorch version on the same
   bf16 inputs at the main-path shapes; errors within the stated bounds,
   kernel and plain times with CUDA events.
4. unet: one full-width SVD UNet forward in fp32 (random weights, a 16x16
   latent, 2 frames) on the card through the kernels vs the same weights on
   the CPU through the plain versions.
5. main: the run of vidseg_diffusion_tpu_torch/scripts/main_path.py
   (configs/inference/svd.yaml at full width with random bf16 weights,
   run_single_video on 14 synthetic 448x832 frames, 25 steps, modulate step
   17, 2 masks, decoding_t 7); the kernel launch counters must be > 0 and
   the plain attention / temporal-conv counters 0; latents and labels must
   be finite and shaped; the +lambda and -lambda runs must differ, and the
   outside-mask latents must equal the cached trajectory exactly.

Before the last line come the kernels JSON (per kernel: launches in the main
run, worst error, kernel and plain ms at its main-path headline shape) and
the card's name and power limit; the last line is {"ok": true, "device": ...}.
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
}
# Kernel output vs plain version, both from the same bf16 inputs: the plain
# version computes in fp32 and rounds once to bf16; the kernel accumulates in
# fp32 in another order, so elements may land one bf16 step apart. Bounds:
# - max |kernel - plain| <= MAX_STEPS bf16 steps at max |plain| (a step there
#   is 2**(floor(log2 max|plain|) - 7)); the sound readings are 0-1 step;
# - ||kernel - plain||_2 <= rms_tol * ||plain||_2, per kernel above, from its
#   sound readings at these shapes (PERF.md): K1 and K3 read 1.3e-3 to 2.4e-3
#   (online softmax rounds p to bf16 against a running max), K4 1e-5 to
#   1.1e-4, K2 0 (bit for bit). A fault that moves every output by 1% reads 1e-2.
MAX_STEPS = 2
UNET_REL_TOL = 1e-4     # fp32 UNet, card (kernels) vs CPU (plain versions), x max |CPU|


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
    return cases


def phase_kernels(torch):
    rows = []
    for kname, label, make, kern, plain, iters in kernel_cases(torch):
        args = make()
        out = kern(*args)
        torch.cuda.synchronize()
        ref = plain(*args)
        torch.cuda.synchronize()
        check(out.shape == ref.shape and out.dtype == ref.dtype, f"{kname} {label}: shape/dtype")
        diff = out.float() - ref.float()
        err = diff.abs().max().item()
        peak = ref.float().abs().max().item()
        rms = diff.norm().item() / max(ref.float().norm().item(), 1e-30)
        tol = MAX_STEPS * 2.0 ** (math.floor(math.log2(peak)) - 7) if peak > 0 else 0.0
        rms_tol = KERNELS[kname]["rms_tol"]
        ok = err <= tol and rms <= rms_tol and bool(torch.isfinite(out).all())
        ms = time_ms(lambda: kern(*args), iters)
        plain_ms = time_ms(lambda: plain(*args), iters)
        row = dict(kernel=kname, shape=label, max_abs_err=err, tol=tol, max_abs_plain=peak,
                   rel_rms_err=rms, ok=ok, ms=ms, plain_ms=plain_ms)
        rows.append(row)
        print(f"[kernels] {KERNELS[kname]['id']} {kname} {label}: max_abs_err={err:.3e} "
              f"(tol {tol:.3e}, max|plain| {peak:.3e}) rel_rms_err={rms:.3e} (tol {rms_tol:.0e}) "
              f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms", flush=True)
        del args, out, ref, diff
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


def phase_main(torch):
    import numpy as np

    from vidseg_diffusion_tpu_torch.ops import attention as A
    from vidseg_diffusion_tpu_torch.ops import temporal_conv as TC
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

    counters = list(A.KERNEL_COUNTERS) + [TC.temporal_conv_1x1]
    plains = list(A.PLAIN_COUNTERS) + [TC.temporal_conv_1x1_reference]
    for f in counters:
        f.launches = 0
    for f in plains:
        f.calls = 0
    timings = {}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = run_single_video(pipe, frames, names, args, write_outputs=False, timings=timings)
    total = time.perf_counter() - t0
    launches = {f.__name__: f.launches for f in counters}
    plain_calls = {f.__name__: f.calls for f in plains}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"[main] run_single_video {total:.2f} s, stages_s "
          f"{json.dumps({k: round(v, 3) for k, v in timings.items()})}", flush=True)
    print(f"[main] kernel launches {json.dumps(launches)}; plain calls {json.dumps(plain_calls)}; "
          f"peak device memory {peak_gb:.1f} GB", flush=True)

    check(all(n > 0 for n in launches.values()), f"a kernel of the path never launched: {launches}")
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

    rows = phase_kernels(torch)
    phase_unet(torch)
    launches = phase_main(torch)

    headline = {  # the main-path shape each kernel is timed at
        "flash_attention_packed": "ds1 B=2 slice [2,5824,5x64]",
        "temporal_attention_direct": "ds1 [28,5824,5,64] t=14",
        "flash_attention": "VAE mid [7,1,5824,512]",
        "temporal_conv_1x1": "UNet ds1 [2,14,5824,320]",
    }
    kernels = []
    for name, meta in KERNELS.items():
        mine = [r for r in rows if r["kernel"] == name]
        head = next(r for r in mine if r["shape"] == headline[name])
        kernels.append(dict(
            name=name, route="cuda", source=meta["source"], replaces=meta["replaces"],
            launches=launches[name], max_abs_err=max(r["max_abs_err"] for r in mine),
            ms=head["ms"], plain_ms=head["plain_ms"],
        ))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
