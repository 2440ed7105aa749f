"""Sigma discretizations (PyTorch).

Counterpart of vidseg_diffusion_tpu/diffusion/discretization.py:
EDMDiscretization (the Karras rho-ramp; SVD uses sigma_max = 700) and
LegacyDDPMDiscretization (the 1000-step DDPM beta schedule turned into sigmas;
SD 2.1). The schedules are computed in float64 numpy and returned as fp32,
as there.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Discretization:
    def get_sigmas(self, n: int) -> torch.Tensor:
        raise NotImplementedError

    def __call__(self, n: int, do_append_zero: bool = True, flip: bool = False) -> torch.Tensor:
        sigmas = self.get_sigmas(n)
        if do_append_zero:
            sigmas = torch.cat([sigmas, sigmas.new_zeros(1)])
        return sigmas.flip(0) if flip else sigmas


@dataclasses.dataclass(frozen=True)
class EDMDiscretization(Discretization):
    sigma_min: float = 0.002
    sigma_max: float = 80.0
    rho: float = 7.0

    def get_sigmas(self, n: int) -> torch.Tensor:
        ramp = np.linspace(0.0, 1.0, n)
        min_inv_rho = self.sigma_min ** (1.0 / self.rho)
        max_inv_rho = self.sigma_max ** (1.0 / self.rho)
        sigmas = (max_inv_rho + ramp * (min_inv_rho - max_inv_rho)) ** self.rho
        return torch.tensor(sigmas, dtype=torch.float32)


@dataclasses.dataclass(frozen=True)
class LegacyDDPMDiscretization(Discretization):
    """discretizer.py:43-70: betas are a linspace in sqrt space, squared, in
    float64; n < num_timesteps sub-samples roughly equally spaced timesteps;
    the sigmas come out descending."""

    linear_start: float = 0.00085
    linear_end: float = 0.0120
    num_timesteps: int = 1000

    @property
    def alphas_cumprod(self) -> np.ndarray:
        betas = np.linspace(self.linear_start ** 0.5, self.linear_end ** 0.5, self.num_timesteps,
                            dtype=np.float64) ** 2
        return np.cumprod(1.0 - betas, axis=0)

    def get_sigmas(self, n: int) -> torch.Tensor:
        alphas_cumprod = self.alphas_cumprod
        if n < self.num_timesteps:
            steps = np.linspace(self.num_timesteps - 1, 0, n, endpoint=False).astype(int)[::-1]
            alphas_cumprod = alphas_cumprod[steps]
        elif n > self.num_timesteps:
            raise ValueError(f"n={n} exceeds num_timesteps={self.num_timesteps}")
        sigmas = ((1 - alphas_cumprod) / alphas_cumprod) ** 0.5
        return torch.tensor(sigmas[::-1].copy(), dtype=torch.float32)
