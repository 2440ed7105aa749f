"""The main-path run that chip_smoke.py checks and profile_single_video.py
profiles, defined once so both see the same work.

configs/inference/svd.yaml at full width with random bf16 weights (seed 0),
run_single_video on 14 synthetic 448x832 frames (or `n`: chip_smoke.py's
long_video runs 40): 25 steps, modulate step 17,
feature step 24, 2 masks, decoding_t 7, seed 1; a second configuration is the
same run with is_injected_features (the feature pass caches the temporal q/k
of the nine attention-bearing output blocks on the device, the modulated runs
inject them), and a third that with inversion_type 'inversion' (the latents
inverted over all 25 steps, the feature pass and its cache from step 0).
"""

import os

import numpy as np
import torch

from vidseg_diffusion_tpu_torch.engine.build import build_pipeline
from vidseg_diffusion_tpu_torch.pipelines.single_video import VidSegArgs

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
NUM_FRAMES, HEIGHT, WIDTH = 14, 448, 832
NUM_STEPS = 25


def build(device="cuda", n=NUM_FRAMES):
    return build_pipeline(os.path.join(ROOT, "configs/inference/svd.yaml"), num_steps=NUM_STEPS,
                          num_frames=n, dtype=torch.bfloat16, device=device, seed=0)


def frames(n=NUM_FRAMES):
    """[n, H, W, 3] in [-1, 1]: a moving gradient plus low-amplitude noise."""
    rng = np.random.RandomState(0)
    yy, xx = np.meshgrid(np.linspace(-1, 1, HEIGHT), np.linspace(-1, 1, WIDTH), indexing="ij")
    out = np.stack([
        np.stack([np.sin(3 * xx + 0.2 * i), np.cos(2 * yy - 0.1 * i), xx * yy], -1)
        for i in range(n)
    ]).astype(np.float32) * 0.8 + 0.1 * rng.randn(n, HEIGHT, WIDTH, 3).astype(np.float32)
    return np.clip(out, -1, 1)


def frame_names(n=NUM_FRAMES):
    return [str(i) for i in range(n)]


def vidseg_args(is_injected_features: bool = False, inversion_type: str = "add_noise"):
    return VidSegArgs(exp_name="main_path", num_steps=NUM_STEPS, modulate_timestep=(17,),
                      feature_timestep=(24,), num_masks=2, decoding_t=7, seed=1,
                      is_injected_features=is_injected_features, inversion_type=inversion_type)
