"""Denoiser pre-conditioning (PyTorch), of
vidseg_diffusion_tpu/diffusion/scaling.py: VScalingWithEDMcNoise (SVD),
EpsScaling (SD 2.1, SDXL), VScaling (SD 2.1-768) and EDMScaling; each maps
sigma to (c_skip, c_out, c_in, c_noise)."""

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
class EDMScaling:
    """Karras EDM scaling (denoiser_scaling.py:15-26)."""

    sigma_data: float = 0.5

    def __call__(self, sigma: torch.Tensor):
        sd2 = self.sigma_data ** 2
        c_skip = sd2 / (sigma**2 + sd2)
        c_out = sigma * self.sigma_data / (sigma**2 + sd2) ** 0.5
        c_in = 1 / (sigma**2 + sd2) ** 0.5
        return c_skip, c_out, c_in, 0.25 * torch.log(sigma)


@dataclasses.dataclass(frozen=True)
class VScaling:
    """v-prediction scaling (denoiser_scaling.py:40-48)."""

    def __call__(self, sigma: torch.Tensor):
        c_skip = 1.0 / (sigma**2 + 1.0)
        c_out = -sigma / (sigma**2 + 1.0) ** 0.5
        c_in = 1.0 / (sigma**2 + 1.0) ** 0.5
        return c_skip, c_out, c_in, sigma


@dataclasses.dataclass(frozen=True)
class EpsScaling:
    """epsilon-prediction scaling (denoiser_scaling.py:29-37)."""

    def __call__(self, sigma: torch.Tensor):
        return torch.ones_like(sigma), -sigma, 1.0 / (sigma**2 + 1.0) ** 0.5, sigma
