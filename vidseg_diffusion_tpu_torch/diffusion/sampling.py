"""Euler EDM sampler (PyTorch), the sampler of both shipped pipelines, of
vidseg_diffusion_tpu/diffusion/sampling.py (sampling.py:92-262 of the
reference): the sigma schedule, the sqrt(1 + sigma_0^2) pre-scale and its
inverse in `add_noise` (they cancel by construction, and VidSeg relies on
it), and one Euler step. The step loops live in engine/vidseg.py; s_churn
is 0 on every shipped config and is not ported."""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from vidseg_diffusion_tpu_torch.diffusion.discretization import Discretization


@dataclasses.dataclass(frozen=True)
class EulerEDMSampler:
    discretization: Discretization
    num_steps: int

    def sigmas(self) -> torch.Tensor:
        """[num_steps + 1] fp32 on the CPU, last entry 0."""
        return self.discretization(self.num_steps, do_append_zero=True)

    def prescale(self, x: torch.Tensor, sigmas: torch.Tensor) -> torch.Tensor:
        return x * torch.sqrt(1.0 + sigmas[0] ** 2.0).item()

    def add_noise(self, x: torch.Tensor, noise_level: int, noise: Optional[torch.Tensor] = None,
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """(x + sigma[noise_level] * eps) / sqrt(1 + sigma_0^2) in fp32. eps is
        `noise` when given (e.g. the array JAX drew), else drawn from
        `generator` (CPU) in x's dtype, as the JAX package draws it."""
        sigmas = self.sigmas()
        if noise is None:
            noise = torch.randn(x.shape, generator=generator, dtype=x.dtype)
        eps = noise.to(x.device).float() * sigmas[noise_level].item()
        return (x.float() + eps) / torch.sqrt(1.0 + sigmas[0] ** 2.0).item()

    def step(self, denoise_fn, x, sigma: float, next_sigma: float, i: int):
        """One Euler step (sampling.py:103-131, s_churn = 0). denoise_fn(x,
        sigma, i) -> (denoised, aux); returns (x_next, aux)."""
        denoised, aux = denoise_fn(x, sigma, i)
        d = (x - denoised) / sigma
        dt = float(np.float32(next_sigma) - np.float32(sigma))  # fp32, as JAX subtracts
        return x + dt * d, aux
