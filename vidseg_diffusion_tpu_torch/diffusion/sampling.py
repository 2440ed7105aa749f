"""Euler EDM sampler (PyTorch), the sampler of both shipped pipelines, of
vidseg_diffusion_tpu/diffusion/sampling.py (sampling.py:92-262 of the
reference): the sigma schedule (flipped for inversion), the sqrt(1 +
sigma_0^2) pre-scale and its inverse in `add_noise` (they cancel by
construction, and VidSeg relies on it), one Euler step, and the DDIM-style
inversion over the flipped schedule. The other step loops live in
engine/vidseg.py; s_churn is 0 on every shipped config and is not ported."""

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

    def sigmas(self, flip: bool = False) -> torch.Tensor:
        """[num_steps + 1] fp32 on the CPU, last entry 0; `flip` reverses it
        and adds 1e-8 to the first entry, so the loop never starts at sigma 0
        (JAX sampling.py:68-74)."""
        sig = self.discretization(self.num_steps, do_append_zero=True)
        if flip:
            sig = sig.flip(0)
            sig[0] += 1e-8
        return sig

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

    def inversion(self, denoise_fn, x: torch.Tensor):
        """DDIM-style inversion over the flipped schedule (JAX
        sampling.py:185-218): x * sqrt(1 + sigma_0^2), then num_steps Euler
        steps from sigma ~ 0 up to sigma_max, then / sqrt(1 + sigma_last^2).
        Returns (x_T, latents [num_steps + 1, ...]): the trajectory from the
        pre-scaled start latent on; fp32, as JAX's product with its fp32 scale
        promotes a bf16 latent."""
        sig = self.sigmas(flip=True)
        sigmas = sig.tolist()
        x = x.float() * torch.sqrt(1.0 + sig[0] ** 2.0).item()
        latents = [x]
        for i in range(len(sigmas) - 1):
            x, _ = self.step(denoise_fn, x, sigmas[i], sigmas[i + 1], i)
            latents.append(x)
        return x / torch.sqrt(1.0 + sig[-1] ** 2.0).item(), torch.stack(latents)
