"""Where the time goes in the port's full-width training steps on one CUDA card.

    python3 -m vidseg_diffusion_tpu_torch.scripts.profile_train [--autoencoder [--svd=MODE]]

Builds the training setup of scripts/train_path.py (the one chip_smoke.py
checks: svd.yaml UNet at full width, bf16, remat, batch 2 x 14 frames of
56x104 latents, Adam, EMA), or with --autoencoder that of
scripts/autoencoder_train_path.py (sd_2_1.yaml's first stage at full width,
bf16, LPIPS and the PatchGAN discriminator, 2 frames of 448x832, Adam for
both phases; with --svd=MODE svd.yaml's own first stage, its VideoDecoder at
time_mode MODE (conv-only, all or attn-only), on one clip of 7 frames of
448x832), takes a warm-up step, times STEPS steps (host clock after
torch.cuda.synchronize), then profiles one more step under torch.profiler.
Prints the card's name and power limit, the step times, the peak device
memory, the device time by group and by kernel name (top 30), the device
idle share of the profiled step and of the mean timed step (the profiler
adds host time), and the split of PyTorch's own kernels by launch site
(profile_single_video.glue_split), the GroupNorm backward's device time and
launches (its kernels, and any other kernel its autograd node launched); for
the autoencoder also the vendor GEMM
/ convolution kernels by model (the "vs:ae:" ranges of AutoencoderTrainStep:
encoder, decoder, LPIPS, discriminator; backward kernels by autograd node).
The warm-up step includes the kernels' build in a fresh checkout.
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

STEPS = 3


def group_norm_backward_report(prof) -> str:
    """Device time and launches of the GroupNorm backward in a profiled step:
    its kernels by name (vs::gn_bwd_*) and PyTorch's own kernels launched
    inside GroupNormFn's backward node (the dy copies)."""
    events = prof.key_averages()
    attr = "device_time_total" if hasattr(events[0], "device_time_total") else "cuda_time_total"
    mine = [e for e in events if e.device_type.name == "CUDA" and "gn_bwd" in e.key]
    lines = [f"GroupNorm backward kernels: {sum(getattr(e, attr) for e in mine) / 1e3:.3f} ms device, "
             f"{sum(e.count for e in mine)} launches"]
    for e in sorted(mine, key=lambda e: -getattr(e, attr)):
        lines.append(f"  {getattr(e, attr) / 1e3:9.3f} ms {e.count:6d}x  {e.key[:100]}")
    us, n = 0.0, 0
    for ev in prof.events():
        up = ev
        while up is not None and not up.name.startswith("autograd::engine::evaluate_function: GroupNormFnBackward"):
            up = up.cpu_parent
        if up is not None:
            extra = [k for k in getattr(ev, "kernels", ()) if "gn_bwd" not in k.name]
            us += sum(k.duration for k in extra)
            n += len(extra)
    lines.append(f"  other kernels launched inside GroupNormFn's backward: {us / 1e3:.3f} ms device, {n} launches")
    return "\n".join(lines)


def main():
    import torch
    from torch.profiler import ProfilerActivity, profile

    from vidseg_diffusion_tpu_torch.scripts import train_path
    from vidseg_diffusion_tpu_torch.scripts.profile_single_video import (
        card_line,
        device_time_report,
        glue_split,
    )

    if not torch.cuda.is_available():
        raise SystemExit("profile_train needs a CUDA card")
    autoencoder = "--autoencoder" in sys.argv[1:]
    print(card_line(), flush=True)
    if autoencoder:
        from vidseg_diffusion_tpu_torch.scripts import autoencoder_train_path as ae_path

        svd = next((a.split("=", 1)[1] for a in sys.argv[1:] if a.startswith("--svd=")), None)
        trainer = ae_path.build(vae=ae_path.svd_vae_config(svd) if svd else None)[0]
        x = ae_path.batch(frames=ae_path.SVD_FRAMES) if svd else ae_path.batch()
        noise = ae_path.noise_generator()
        take_step = lambda: trainer.step(x, trainer.step_count, generator=noise)["g_loss"]
    else:
        trainer = train_path.build()
        latents, cond = train_path.batch()
        gens = train_path.generators()
        take_step = lambda: trainer.step(latents, cond, generators=gens)
    t0 = time.perf_counter()
    loss = take_step()
    torch.cuda.synchronize()
    print(f"warm-up step {time.perf_counter() - t0:.3f} s, loss {loss.item():.5f}", flush=True)

    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(STEPS):
        t0 = time.perf_counter()
        loss = take_step()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    print(f"steps_s {[round(t, 4) for t in times]}, loss {loss.item():.5f}, "
          f"peak device memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB", flush=True)

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        take_step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    print(device_time_report(prof, wall, unprofiled_wall=sum(times) / len(times)))
    print(glue_split(prof))
    print(group_norm_backward_report(prof))
    if autoencoder:
        print(glue_split(prof, group="GEMM / conv (cuBLAS, cuDNN)", prefix="vs:ae:"))
        print(glue_split(prof, group="port kernels (csrc)", prefix="vs:ae:"))


if __name__ == "__main__":
    main()
