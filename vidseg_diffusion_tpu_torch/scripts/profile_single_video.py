"""Where the time goes in the port's main path on one CUDA card.

    python3 -m vidseg_diffusion_tpu_torch.scripts.profile_single_video

Runs the main path of scripts/main_path.py (the run chip_smoke.py checks:
svd.yaml at full width, random bf16 weights, 14 synthetic 448x832 frames)
once to warm up, then once more under torch.profiler. Prints the stage
seconds, the device time by group and by kernel name (top 30) and the
device busy share of the profiled run's wall time.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))


# device-time groups, by kernel name: the port's kernels (csrc/, namespace
# vs::), the vendor GEMM / convolution kernels, and everything else
# (PyTorch's elementwise, reduction, norm and copy kernels)
_GROUPS = (("port kernels (csrc)", ("vs::",)),
           ("GEMM / conv (cuBLAS, cuDNN)", ("nvjet", "xmma", "gemm", "cutlass", "cudnn", "conv")))


def _group(name: str) -> str:
    low = name.lower()
    return next((g for g, keys in _GROUPS if any(k.lower() in low for k in keys)), "other (PyTorch)")


def device_time_report(prof, wall: float, top: int = 30, unprofiled_wall: float = None) -> str:
    """Device busy and idle share of `wall` seconds (and of `unprofiled_wall`,
    the same work timed without the profiler's host overhead), the device
    time by group and by kernel name (top `top`) from a torch.profiler run.
    User annotations (record_function ranges) are not kernels and not
    counted."""
    events = prof.key_averages()
    attr = "device_time_total" if hasattr(events[0], "device_time_total") else "cuda_time_total"
    kernels = [e for e in events if getattr(e, attr) > 0 and e.device_type.name == "CUDA"
               and not getattr(e, "is_user_annotation", False)]
    busy_us = sum(getattr(e, attr) for e in kernels)
    lines = [f"wall {wall:.2f} s, device busy {busy_us / 1e6:.3f} s "
             f"({100 * busy_us / 1e6 / wall:.1f}%), idle share {100 * (1 - busy_us / 1e6 / wall):.1f}%"]
    if unprofiled_wall:
        lines.append(f"unprofiled wall {unprofiled_wall:.3f} s: idle share "
                     f"{100 * (1 - busy_us / 1e6 / unprofiled_wall):.1f}%")
    groups = {}
    for e in kernels:
        groups[_group(e.key)] = groups.get(_group(e.key), 0) + getattr(e, attr)
    for g, us in sorted(groups.items(), key=lambda kv: -kv[1]):
        lines.append(f"{us / 1e6:9.3f} s {100 * us / busy_us:5.1f}%  {g}")
    for e in sorted(kernels, key=lambda e: -getattr(e, attr))[:top]:
        us = getattr(e, attr)
        lines.append(f"{us / 1e6:9.3f} s {100 * us / busy_us:5.1f}%  {e.count:7d}x  {e.key[:110]}")
    return "\n".join(lines)


def main():
    import torch
    from torch.profiler import ProfilerActivity, profile

    from vidseg_diffusion_tpu_torch.pipelines.single_video import run_single_video
    from vidseg_diffusion_tpu_torch.scripts import main_path

    if not torch.cuda.is_available():
        raise SystemExit("profile_single_video needs a CUDA card")
    pipe = main_path.build()
    frames, names, vargs = main_path.frames(), main_path.frame_names(), main_path.vidseg_args()
    warm = {}
    run_single_video(pipe, frames, names, vargs, write_outputs=False, timings=warm)
    print("warm-up stages_s", json.dumps({k: round(v, 3) for k, v in warm.items()}), flush=True)

    stages = {}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_single_video(pipe, frames, names, vargs, write_outputs=False, timings=stages)
        wall = time.perf_counter() - t0
    print("profiled stages_s", json.dumps({k: round(v, 3) for k, v in stages.items()}), flush=True)

    print(device_time_report(prof, wall))


if __name__ == "__main__":
    main()
