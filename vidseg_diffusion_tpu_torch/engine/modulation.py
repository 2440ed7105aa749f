"""VidSeg modulation schedule (PyTorch port of
vidseg_diffusion_tpu/engine/modulation.py).

Turns the reference's modulate_params plumbing into dense gates: lambda over
frames lam[T], the (step, frame) gate step_frames[num_steps, T] and the
latent-blend window. Block / layer-type / attention-type gating stays static
(which UNetHooks entries exist).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np
import torch


def modulate_lambda_schedule(lambda_start: float, lambda_end: float, schedule: str,
                             num_frames: int) -> torch.Tensor:
    """Per-frame lambda (diffusionmodules/util.py:383-392): constant, or
    linear in the frame index f: start + (end - start) * f / num_frames."""
    if schedule == "constant":
        return torch.full((num_frames,), float(lambda_start), dtype=torch.float32)
    if schedule == "linear":
        f = np.arange(num_frames, dtype=np.float32)
        return torch.from_numpy(
            (lambda_start + (lambda_end - lambda_start) * f / num_frames).astype(np.float32)
        )
    raise ValueError(f"unknown modulate schedule {schedule!r}")


def modulate_timestep_frames_table(num_steps: int, num_frames: int,
                                   modulate_timesteps: Sequence[int],
                                   schedule: str = "constant", start_timestep: int = 20,
                                   end_timestep: int = 15) -> np.ndarray:
    """[num_steps, T] bool: frame f is modulated at step i ('constant': every
    frame at every i in modulate_timesteps; 'linear': frame f at step
    int(start + (end - start) * f / (T - 1)), sgm/util.py:316-326)."""
    table = np.zeros((num_steps, num_frames), dtype=bool)
    if schedule == "constant":
        for i in modulate_timesteps:
            table[i, :] = True
    elif schedule == "linear":
        for f in range(num_frames):
            i = int(start_timestep + (end_timestep - start_timestep) * f / (num_frames - 1))
            table[i, f] = True
    else:
        raise ValueError(f"unknown timestep-frames schedule {schedule!r}")
    return table


@dataclasses.dataclass(frozen=True)
class ModulationConfig:
    """Static VidSeg modulation configuration (CLI-parity knobs)."""

    modulate_block_idx: Tuple[int, ...] = (8,)
    modulate_timestep: Tuple[int, ...] = (17,)
    feature_timestep: Tuple[int, ...] = (24,)
    modulate_schedule: str = "constant"
    modulate_lambda_start: float = 50.0
    modulate_lambda_end: float = 50.0
    modulate_layer_type: Tuple[str, ...] = ("spatial",)
    modulate_attn_type: Tuple[str, ...] = ("cross_attn",)
    modulate_timestep_frames_schedule: str = "constant"
    num_steps: int = 25
    num_frames: int = 14
    is_injected_features: bool = False
    is_latent_blending: bool = True

    def lam(self) -> torch.Tensor:
        return modulate_lambda_schedule(
            self.modulate_lambda_start, self.modulate_lambda_end,
            self.modulate_schedule, self.num_frames,
        )

    def step_frame_table(self) -> np.ndarray:
        return modulate_timestep_frames_table(
            self.num_steps, self.num_frames, self.modulate_timestep,
            self.modulate_timestep_frames_schedule,
        )

    def blend_window(self) -> Tuple[int, int]:
        """Steps whose outputs latent blending pins outside the mask:
        min(modulate_timestep) through the last step."""
        return min(self.modulate_timestep), self.num_steps

    def block_resolution_divisor(self, block_idx: int) -> int:
        """Latent-to-token downscale of an output block: 0-2 -> 8, 3-5 -> 4,
        6-8 -> 2, 9-11 -> 1 (svd_single_video_inference.py:84-95)."""
        for blocks, div in (((0, 1, 2), 8), ((3, 4, 5), 4), ((6, 7, 8), 2), ((9, 10, 11), 1)):
            if block_idx in blocks:
                return div
        raise ValueError(block_idx)
