"""Where the time goes in the port's main path on one CUDA card.

    python3 -m vidseg_diffusion_tpu_torch.scripts.profile_single_video [--injected | --sd | --sdxl]

Runs the main path of scripts/main_path.py (the run chip_smoke.py checks:
svd.yaml at full width, random bf16 weights, 14 synthetic 448x832 frames)
once to warm up, then once more under torch.profiler. Prints the card's
name and power limit, the stage seconds, the device time by group and by
kernel name (top 30), the device busy share of the profiled run's wall time,
and the split of PyTorch's own kernels (everything that is neither a kernel
of csrc/ nor a vendor GEMM / convolution) by what launched them: the port's
"vs:<site>" record_function ranges (GroupNorm, LayerNorm, GEGLU, linear,
Conv2dNHWC, Conv3x3, TemporalConv, AlphaBlender, modulation, optimizer, ema),
else the autograd node of the backward, else "outside any range". The
attention projections and the ResBlock 3x3 convolutions are kernels of csrc/
(K11 matmul_bias, K12 conv3x3): the linear and Conv2dNHWC ranges hold only the
sites that stayed library calls, and Conv3x3 the re-laying of K12's weights.
With --injected it profiles the is_injected_features configuration, with --sd
the SD 2.1 path of scripts/sd_path.py, with --sdxl the sampling API's
text_to_image on the SDXL base of scripts/api_path.py (1024x1024, 40 Euler
steps; its wall time also measured once without the profiler).
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
    time by group and by kernel name (top `top`, and every kernel of csrc/)
    from a torch.profiler run.
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
    ranked = sorted(kernels, key=lambda e: -getattr(e, attr))
    # the top kernels, then every kernel of csrc/ that is not among them
    for e in ranked[:top] + [e for e in ranked[top:] if _group(e.key) == _GROUPS[0][0]]:
        us = getattr(e, attr)
        lines.append(f"{us / 1e6:9.3f} s {100 * us / busy_us:5.1f}%  {e.count:7d}x  {e.key[:110]}")
    return "\n".join(lines)


def glue_split(prof, top: int = 25, group: str = "other (PyTorch)", prefix: str = "vs:") -> str:
    """Device time of the kernels of `group` ('other (PyTorch)': PyTorch's
    own) by the innermost enclosing record_function range whose name starts
    with `prefix` of the op that launched them; for kernels launched by the
    autograd engine outside any range, by the autograd node ("bwd <Node>").
    Reads the profiler's event tree: a CPU op event lists the kernels it
    launched, and its cpu_parent chain leads to the range."""
    by_site, total = {}, 0.0
    for ev in prof.events():
        kernels = [k for k in getattr(ev, "kernels", ()) if _group(k.name) == group]
        if not kernels:
            continue
        site, node, up = None, None, ev
        while up is not None and site is None:
            if up.name.startswith(prefix):
                site = up.name
            elif node is None and up.name.startswith("autograd::engine::evaluate_function: "):
                node = "bwd " + up.name.split(": ", 1)[1]
            up = up.cpu_parent
        us = sum(k.duration for k in kernels)
        key = site or node or "outside any range"
        cell = by_site.setdefault(key, [0.0, 0])
        cell[0] += us
        cell[1] += len(kernels)
        total += us
    if not total:
        return f"{group} split: the profiler linked no kernel to a CPU op"
    lines = [f"{group} kernels by launch site: {total / 1e6:.3f} s"]
    for key, (us, n) in sorted(by_site.items(), key=lambda kv: -kv[1][0])[:top]:
        lines.append(f"{us / 1e6:9.3f} s {100 * us / total:5.1f}%  {n:7d}x  {key}")
    return "\n".join(lines)


def card_line() -> str:
    import subprocess

    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()


def main():
    import torch
    from torch.profiler import ProfilerActivity, profile

    from vidseg_diffusion_tpu_torch.pipelines.single_video import run_single_video
    from vidseg_diffusion_tpu_torch.scripts import main_path, sd_path

    if not torch.cuda.is_available():
        raise SystemExit("profile_single_video needs a CUDA card")
    if "--sdxl" in sys.argv[1:]:
        return profile_sdxl(torch, profile, ProfilerActivity)
    injected, sd = "--injected" in sys.argv[1:], "--sd" in sys.argv[1:]
    print(card_line(), "| is_injected_features", injected, "| sd_2_1", sd, flush=True)
    if sd:
        pipe, vargs, extra = sd_path.build(), sd_path.vidseg_args(), dict(text_tokens=sd_path.text_tokens())
    else:
        pipe, vargs, extra = main_path.build(), main_path.vidseg_args(is_injected_features=injected), {}
    frames, names = main_path.frames(), main_path.frame_names()
    warm = {}
    run_single_video(pipe, frames, names, vargs, write_outputs=False, timings=warm, **extra)
    print("warm-up stages_s", json.dumps({k: round(v, 3) for k, v in warm.items()}), flush=True)

    stages = {}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_single_video(pipe, frames, names, vargs, write_outputs=False, timings=stages, **extra)
        wall = time.perf_counter() - t0
    print("profiled stages_s", json.dumps({k: round(v, 3) for k, v in stages.items()}), flush=True)

    print(device_time_report(prof, wall))
    print(glue_split(prof))


def profile_sdxl(torch, profile, ProfilerActivity):
    from vidseg_diffusion_tpu_torch.scripts import api_path

    print(card_line(), "| SDXL base text_to_image 1024x1024, 40 steps", flush=True)
    api, tokens, params = api_path.build("configs/inference/sd_xl_base.yaml"), api_path.tokens(), api_path.sdxl_params()

    def run():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        api.text_to_image(params, tokens, generator=torch.Generator(device="cuda").manual_seed(3))
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    run()   # warm-up
    unprofiled = run()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall = run()
    print(device_time_report(prof, wall, unprofiled_wall=unprofiled))
    print(glue_split(prof))


if __name__ == "__main__":
    main()
