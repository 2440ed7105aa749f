"""GroupNorm with fp32 statistics (the JAX package's group_norm_xla math).

Counterpart of vidseg_diffusion_tpu/ops/norm.py:420-481: per-(batch, group)
statistics over every non-batch, non-channel axis, computed from per-channel
sums in fp32 whatever the activation dtype, then one scale-shift and a cast
back. The Pallas GN kernels of the JAX package are switched off on its main
path and are not ported yet (ROADMAP Queue B).
"""

from __future__ import annotations

import torch


def group_norm(x, weight, bias, groups: int = 32, eps: float = 1e-5, silu: bool = False):
    """x [B, ..., C] (channels last)."""
    b, c = x.shape[0], x.shape[-1]
    if c % groups:
        raise ValueError(f"group_norm: {c} channels not divisible by {groups} groups")
    red = tuple(range(1, x.dim() - 1))
    xf = x.float()
    s = xf.sum(dim=red)                  # [B, C]
    ss = (xf * xf).sum(dim=red)          # [B, C]
    n = (x.numel() // (b * c)) * (c // groups)
    mean = s.view(b, groups, -1).sum(-1) / n
    var = (ss.view(b, groups, -1).sum(-1) / n - mean * mean).clamp_min(0.0)
    inv = torch.rsqrt(var + eps)
    rep = c // groups
    a = inv.repeat_interleave(rep, dim=1) * weight.float()
    shift = bias.float() - (mean * inv).repeat_interleave(rep, dim=1) * weight.float()
    bcast = (b,) + (1,) * (x.dim() - 2) + (c,)
    y = xf * a.view(bcast) + shift.view(bcast)
    if silu:
        y = y * torch.sigmoid(y)
    return y.to(x.dtype)
