"""Denoiser pre-conditioning (PyTorch): VScalingWithEDMcNoise, the SVD
scaling, and EpsScaling, of vidseg_diffusion_tpu/diffusion/scaling.py."""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class VScalingWithEDMcNoise:
    """sigma -> (c_skip, c_out, c_in, c_noise) for v-prediction with the EDM
    c_noise (denoiser_scaling.py:51-59)."""

    def __call__(self, sigma: torch.Tensor):
        c_skip = 1.0 / (sigma**2 + 1.0)
        c_out = -sigma / (sigma**2 + 1.0) ** 0.5
        c_in = 1.0 / (sigma**2 + 1.0) ** 0.5
        c_noise = 0.25 * torch.log(sigma)
        return c_skip, c_out, c_in, c_noise


@dataclasses.dataclass(frozen=True)
class EpsScaling:
    """epsilon-prediction scaling (denoiser_scaling.py:29-37)."""

    def __call__(self, sigma: torch.Tensor):
        return torch.ones_like(sigma), -sigma, 1.0 / (sigma**2 + 1.0) ** 0.5, sigma
