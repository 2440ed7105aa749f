"""Denoisers (PyTorch): D(x, s) = net(x c_in, c_noise) c_out + x c_skip
(vidseg_diffusion_tpu/diffusion/denoiser.py, denoiser.py:11-83 of the
reference). Denoiser takes sigma as it comes (SVD); DiscreteDenoiser snaps it
to a table of num_idx sigmas and hands the network the table index (SD 2.1).
The network may return (out, aux); aux passes through."""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import torch

from vidseg_diffusion_tpu_torch.diffusion.discretization import Discretization


def append_dims(x: torch.Tensor, target_ndim: int) -> torch.Tensor:
    return x.reshape(x.shape + (1,) * (target_ndim - x.dim()))


@dataclasses.dataclass(frozen=True)
class Denoiser:
    scaling: Callable

    def possibly_quantize_sigma(self, sigma: torch.Tensor) -> torch.Tensor:
        return sigma

    def possibly_quantize_c_noise(self, c_noise: torch.Tensor) -> torch.Tensor:
        return c_noise

    def __call__(self, network, x: torch.Tensor, sigma: torch.Tensor, cond):
        """sigma [B]; returns (denoised, aux) for a network returning
        (out, aux)."""
        sigma = self.possibly_quantize_sigma(sigma)
        c_skip, c_out, c_in, c_noise = self.scaling(append_dims(sigma, x.dim()))
        c_noise = self.possibly_quantize_c_noise(c_noise.reshape(sigma.shape))
        out, aux = network(x * c_in, c_noise, cond)
        return out * c_out + x * c_skip, aux


@functools.lru_cache(maxsize=None)
def _sigma_table(discretization: Discretization, num_idx: int, device: torch.device) -> torch.Tensor:
    """The ascending table of num_idx sigmas, made once per device."""
    return discretization(num_idx, do_append_zero=False, flip=True).to(device)


@dataclasses.dataclass(frozen=True)
class DiscreteDenoiser(Denoiser):
    """sigma snapped to the nearest of num_idx table entries; c_noise becomes
    the table index (denoiser.py:49-83 with LegacyDDPMDiscretization)."""

    discretization: Discretization = None
    num_idx: int = 1000
    quantize_c_noise: bool = True

    def sigma_to_idx(self, sigma: torch.Tensor) -> torch.Tensor:
        table = _sigma_table(self.discretization, self.num_idx, sigma.device)
        dists = sigma.float() - table.reshape((-1,) + (1,) * sigma.dim())
        return dists.abs().argmin(dim=0).reshape(sigma.shape)

    def idx_to_sigma(self, idx: torch.Tensor) -> torch.Tensor:
        return _sigma_table(self.discretization, self.num_idx, idx.device)[idx]

    def possibly_quantize_sigma(self, sigma: torch.Tensor) -> torch.Tensor:
        return self.idx_to_sigma(self.sigma_to_idx(sigma)).to(sigma.dtype)

    def possibly_quantize_c_noise(self, c_noise: torch.Tensor) -> torch.Tensor:
        return self.sigma_to_idx(c_noise) if self.quantize_c_noise else c_noise
