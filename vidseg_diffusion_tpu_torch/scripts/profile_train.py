"""Where the time goes in the port's full-width training step on one CUDA card.

    python3 -m vidseg_diffusion_tpu_torch.scripts.profile_train

Builds the training setup of scripts/train_path.py (the one chip_smoke.py
checks: svd.yaml UNet at full width, bf16, remat, batch 2 x 14 frames of
56x104 latents, Adam, EMA), takes a warm-up step, times STEPS steps
(host clock after torch.cuda.synchronize), then profiles one more step
under torch.profiler. Prints the card's name and power limit, the step
times, the peak device memory, the device time by group and by kernel name
(top 30), the device idle share of the profiled step and of the mean
timed step (the profiler adds host time), and the split of PyTorch's own
kernels by launch site (profile_single_video.glue_split). The warm-up step includes the
kernels' build in a fresh checkout.
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

STEPS = 3


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
    print(card_line(), flush=True)
    trainer = train_path.build()
    latents, cond = train_path.batch()
    gens = train_path.generators()
    t0 = time.perf_counter()
    loss = trainer.step(latents, cond, generators=gens)
    torch.cuda.synchronize()
    print(f"warm-up step {time.perf_counter() - t0:.3f} s, loss {loss.item():.5f}", flush=True)

    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(STEPS):
        t0 = time.perf_counter()
        loss = trainer.step(latents, cond, generators=gens)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    print(f"steps_s {[round(t, 4) for t in times]}, loss {loss.item():.5f}, "
          f"peak device memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB", flush=True)

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.step(latents, cond, generators=gens)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    print(device_time_report(prof, wall, unprofiled_wall=sum(times) / len(times)))
    print(glue_split(prof))


if __name__ == "__main__":
    main()
