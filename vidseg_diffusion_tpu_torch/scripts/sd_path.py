"""The SD 2.1 run that chip_smoke.py checks and profile_single_video.py --sd
profiles, defined once so both see the same work.

configs/inference/sd_2_1.yaml at full width (865 M-parameter image UNet,
ViT-H text tower, the image VAE) with random bf16 weights (seed 0),
run_single_video on main_path.py's 14 synthetic 448x832 frames with the SD
sweep's settings: the empty prompt, 25 steps, modulate block 7 at step 22,
feature step 24, lambda 50 constant on the spatial cross-attention, latent
blending over the SD window, k-means masks (4; matching ground-truth masks
needs the VSPW sweep), decoding_t 7, seed 1.
"""

import os

import torch

from vidseg_diffusion_tpu_torch.engine.build import build_pipeline
from vidseg_diffusion_tpu_torch.io.tokenizer import tokenize_empty
from vidseg_diffusion_tpu_torch.pipelines.single_video import VidSegArgs
from vidseg_diffusion_tpu_torch.scripts.main_path import NUM_FRAMES, NUM_STEPS, ROOT, frame_names, frames

__all__ = ["build", "frames", "frame_names", "vidseg_args", "text_tokens", "unet_calls"]

NUM_MASKS = 4
MODULATE_STEP = 22


def build(device="cuda"):
    return build_pipeline(os.path.join(ROOT, "configs/inference/sd_2_1.yaml"), num_steps=NUM_STEPS,
                          num_frames=NUM_FRAMES, dtype=torch.bfloat16, device=device, seed=0)


def vidseg_args():
    return VidSegArgs(exp_name="sd_path", num_steps=NUM_STEPS, modulate_block_idx=(7,),
                      modulate_timestep=(MODULATE_STEP,), feature_timestep=(24,), num_masks=NUM_MASKS,
                      decoding_t=7, seed=1, sd_blend_window=True)


def text_tokens():
    return tokenize_empty(1)


def unet_calls(num_masks: int = NUM_MASKS) -> int:
    """UNet calls of one run: the feature pass from the modulated step on, and
    2 * num_masks modulated runs that start three steps earlier."""
    return (NUM_STEPS - MODULATE_STEP) + 2 * num_masks * (NUM_STEPS - (MODULATE_STEP - 3))
