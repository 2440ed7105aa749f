"""Diffusion training loss (PyTorch).

Counterpart of vidseg_diffusion_tpu/diffusion/loss.py: the sigma samplers
(sigma_sampling.py:6-31 of the reference), the eps / v / unit weightings
(denoiser_weighting.py) and StandardDiffusionLoss with l2, l1 and lpips
(loss.py:12-105). Random draws take one explicit torch.Generator per site:
the sigma draw and the noise draw, the two keys JAX splits from `rng`
(loss.py:77). Both can also be handed in as tensors, so a test can give the
port the arrays JAX drew.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

from vidseg_diffusion_tpu_torch.diffusion.denoiser import Denoiser, append_dims


@dataclasses.dataclass(frozen=True)
class EDMSigmaSampling:
    """logN(p_mean, p_std) sigma sampler (sigma_sampling.py:6-12)."""

    p_mean: float = -1.2
    p_std: float = 1.2

    def __call__(self, n: int, generator: Optional[torch.Generator] = None,
                 device=None) -> torch.Tensor:
        return torch.exp(self.p_mean + self.p_std * torch.randn(n, generator=generator, device=device))


@dataclasses.dataclass(frozen=True)
class DiscreteSigmaSampling:
    """Uniform index into a discretized sigma table (sigma_sampling.py:15-31)."""

    sigmas: torch.Tensor  # [num_idx]

    def __call__(self, n: int, generator: Optional[torch.Generator] = None,
                 device=None) -> torch.Tensor:
        idx = torch.randint(0, self.sigmas.shape[0], (n,), generator=generator, device=device)
        return self.sigmas.to(idx.device)[idx]


def eps_weighting(sigma):
    return sigma**-2.0


def v_weighting(sigma):
    return (sigma**2 + 1.0) / sigma**2.0


def unit_weighting(sigma):
    return torch.ones_like(sigma)


@dataclasses.dataclass(frozen=True)
class StandardDiffusionLoss:
    """w(sigma) * ||D(x0 + sigma eps, sigma) - x0||^2 averaged over the batch
    (loss.py:12-105), l2 or l1; or lpips: `lpips_fn(pred, x0)` per sample
    (models.lpips.LPIPS bound to its weights), without the sigma weighting,
    as the reference applies it (loss.py:101-103). The denoiser's network
    returns (out, aux), and the loss uses out."""

    denoiser: Denoiser
    sigma_sampler: Callable
    weighting: Callable = unit_weighting
    loss_type: str = "l2"
    lpips_fn: Optional[Callable] = None

    def __post_init__(self):
        if self.loss_type not in ("l2", "l1", "lpips"):
            raise ValueError(self.loss_type)
        if self.loss_type == "lpips" and self.lpips_fn is None:
            raise ValueError("loss_type='lpips' requires lpips_fn")

    def draw(self, x0: torch.Tensor, generators: Optional[Tuple[torch.Generator, torch.Generator]] = None,
             sigma: Optional[torch.Tensor] = None,
             noise: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """(sigma [B], noise of x0's shape) for a batch x0: the ones given,
        else drawn from generators = (sigma draw, noise draw)."""
        g_sigma, g_noise = generators if generators is not None else (None, None)
        if sigma is None:
            sigma = self.sigma_sampler(x0.shape[0], generator=g_sigma, device=x0.device)
        if noise is None:
            noise = torch.randn(x0.shape, generator=g_noise, device=x0.device, dtype=x0.dtype)
        return sigma, noise

    def __call__(self, network, x0: torch.Tensor, cond: Dict[str, torch.Tensor],
                 generators: Optional[Tuple[torch.Generator, torch.Generator]] = None,
                 sigma: Optional[torch.Tensor] = None,
                 noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """generators = (sigma draw, noise draw); `sigma` [B] and `noise`
        (x0's shape) replace the draws they are given for."""
        sigma, noise = self.draw(x0, generators, sigma, noise)
        sigma = sigma.to(device=x0.device, dtype=x0.dtype)
        noised = x0 + noise.to(x0.dtype) * append_dims(sigma, x0.dim())
        pred = self.denoiser(network, noised, sigma, cond)[0]
        if self.loss_type == "lpips":
            return self.lpips_fn(pred, x0).reshape(-1).mean()
        w = append_dims(self.weighting(sigma), x0.dim())
        err = (pred - x0) ** 2 if self.loss_type == "l2" else (pred - x0).abs()
        return (w * err).reshape(x0.shape[0], -1).mean(dim=1).mean()
