"""Continuous-sigma denoiser (PyTorch): D(x, s) = net(x c_in, c_noise) c_out
+ x c_skip (vidseg_diffusion_tpu/diffusion/denoiser.py, denoiser.py:11-46 of
the reference). The network may return (out, aux); aux passes through."""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch


def append_dims(x: torch.Tensor, target_ndim: int) -> torch.Tensor:
    return x.reshape(x.shape + (1,) * (target_ndim - x.dim()))


@dataclasses.dataclass(frozen=True)
class Denoiser:
    scaling: Callable

    def __call__(self, network, x: torch.Tensor, sigma: torch.Tensor, cond):
        """sigma [B]; returns (denoised, aux) for a network returning
        (out, aux)."""
        c_skip, c_out, c_in, c_noise = self.scaling(append_dims(sigma, x.dim()))
        out, aux = network(x * c_in, c_noise.reshape(sigma.shape), cond)
        return out * c_out + x * c_skip, aux
