"""Classifier-free-guidance guiders (PyTorch) of
vidseg_diffusion_tpu/diffusion/guidance.py: LinearPredictionGuider, per-frame
CFG scale linspace(min, max, T) (SVD; guiders.py:60-100), VanillaCFG, one
scale (SD 2.1, SDXL; guiders.py:24-42), and IdentityGuider, no guidance
(guiders.py:45-57).

The batch contract is the reference's and the VidSeg modulation depends on
it: `prepare_inputs` doubles the batch as [uc; c] on axis 0 and `__call__`
splits it back."""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

_CONCAT_KEYS = ("vector", "crossattn", "concat")


def concat_conds(c: Dict[str, torch.Tensor], uc: Dict[str, torch.Tensor]):
    return {k: torch.cat([uc[k], c[k]], dim=0) if k in _CONCAT_KEYS else c[k] for k in c}


@dataclasses.dataclass(frozen=True)
class VanillaCFG:
    """x_u + scale * (x_c - x_u)."""

    scale: float

    def prepare_inputs(self, x, s, c, uc) -> Tuple[torch.Tensor, torch.Tensor, Dict]:
        return torch.cat([x, x], dim=0), torch.cat([s, s], dim=0), concat_conds(c, uc)

    def __call__(self, x: torch.Tensor, sigma) -> torch.Tensor:
        x_u, x_c = x.chunk(2, dim=0)
        return x_u + self.scale * (x_c - x_u)


@dataclasses.dataclass(frozen=True)
class IdentityGuider:
    """No guidance: the batch is not doubled."""

    def prepare_inputs(self, x, s, c, uc) -> Tuple[torch.Tensor, torch.Tensor, Dict]:
        return x, s, dict(c)

    def __call__(self, x: torch.Tensor, sigma) -> torch.Tensor:
        return x


@dataclasses.dataclass(frozen=True)
class LinearPredictionGuider:
    max_scale: float
    num_frames: int
    min_scale: float = 1.0

    def prepare_inputs(self, x, s, c, uc) -> Tuple[torch.Tensor, torch.Tensor, Dict]:
        return torch.cat([x, x], dim=0), torch.cat([s, s], dim=0), concat_conds(c, uc)

    def __call__(self, x: torch.Tensor, sigma) -> torch.Tensor:
        x_u, x_c = x.chunk(2, dim=0)
        t = self.num_frames
        b = x_u.shape[0] // t
        x_u = x_u.reshape((b, t) + x_u.shape[1:])
        x_c = x_c.reshape((b, t) + x_c.shape[1:])
        scale = torch.linspace(self.min_scale, self.max_scale, t, dtype=x_u.dtype, device=x.device)
        scale = scale.reshape((1, t) + (1,) * (x_u.dim() - 2))
        out = x_u + scale * (x_c - x_u)
        return out.reshape((b * t,) + out.shape[2:])
