"""Shared building blocks of the UNet and its transformers (PyTorch).

Counterpart of vidseg_diffusion_tpu/models/layers.py. Activations are
channels-last as in the JAX package: images [B, H, W, C], tokens [B, L, C],
attention q/k/v [B, L, H, D] (packed [B, L, H*D] in memory). Module and
parameter names follow the reference's sgm state-dict keys, so an sgm
checkpoint loads with `load_state_dict` and io/convert.py maps the JAX
parameter trees onto the same names.

The q/k harvest of the feature pass is a dict handed to CrossAttention
(`sow`): the flat [B, L, H*D] q and k are stored there, the counterpart of
the JAX package's flax `sow` into 'intermediates' (layers.py:375-380).

The glue around the kernels runs under torch.profiler.record_function ranges
named "vs:<site>" (GroupNorm, LayerNorm, GEGLU, linear, Conv2dNHWC, Conv3x3,
AlphaBlender, modulation; linear and Conv2dNHWC hold only the sites that
stayed library calls), which scripts/profile_*.py use to split the
device time of PyTorch's own kernels by what launched them.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.profiler import record_function

from vidseg_diffusion_tpu_torch.ops.attention import (
    dot_product_attention,
    temporal_attention_direct,
)
from vidseg_diffusion_tpu_torch.ops.conv3x3 import conv3x3_same
from vidseg_diffusion_tpu_torch.ops.matmul import matmul_bias
from vidseg_diffusion_tpu_torch.ops.norm import group_norm


def timestep_embedding(timesteps: torch.Tensor, dim: int, max_period: int = 10000) -> torch.Tensor:
    """Sinusoidal embedding in fp32, [cos | sin] order."""
    half = dim // 2
    freqs = torch.exp(
        -math.log(max_period) * torch.arange(half, dtype=torch.float32, device=timesteps.device) / half
    )
    args = timesteps.float()[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


class GroupNorm32(nn.Module):
    """GroupNorm with fp32 statistics on channels-last input; 32 groups, or
    gcd(32, C) when C is not a multiple of 32 (layers.py:92)."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.groups = 32 if channels % 32 == 0 else math.gcd(32, channels)
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor, silu: bool = False) -> torch.Tensor:
        return group_norm(x, self.weight, self.bias, self.groups, self.eps, silu=silu)


class Conv2dNHWC(nn.Conv2d):
    """nn.Conv2d on channels-last [B, H, W, C] activations. The permutes are
    views: cuDNN sees a channels_last NCHW tensor, so no copy is made on the
    way in or out."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with record_function("vs:Conv2dNHWC"):
            y = F.conv2d(
                x.permute(0, 3, 1, 2), self.weight.to(x.dtype),
                None if self.bias is None else self.bias.to(x.dtype),
                self.stride, self.padding,
            )
            return y.permute(0, 2, 3, 1)


class Conv3x3NHWC(nn.Conv2d):
    """The 3x3, stride-1, padding-1 convolution of a ResBlock on channels-last
    [B, H, W, C] activations, through conv3x3_same (K12 on CUDA): the JAX
    package's SpatialConv3x3 dispatch hook (models/unet.py:169-198).
    Parameters are nn.Conv2d's (weight [Cout, Cin, 3, 3], bias). The weight
    goes in as the parameter itself, whatever its dtype: the wrapper's cached
    tap-major copy holds the cast to the activation's."""

    def __init__(self, cin: int, cout: int):
        super().__init__(cin, cout, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv3x3_same(x, self.weight, self.bias.to(x.dtype))


def project(x: torch.Tensor, layer: nn.Linear) -> torch.Tensor:
    """An attention projection in the activation's dtype through matmul_bias
    (K11 on CUDA): the JAX package's dispatch hook in CrossAttention
    (models/layers.py:348-365, :392-403)."""
    return matmul_bias(x, layer.weight.to(x.dtype), None if layer.bias is None else layer.bias.to(x.dtype))


def linear(x: torch.Tensor, layer: nn.Linear) -> torch.Tensor:
    """nn.Linear in the activation's dtype (the JAX modules' `dtype=` cast)."""
    with record_function("vs:linear"):
        return F.linear(x, layer.weight.to(x.dtype), None if layer.bias is None else layer.bias.to(x.dtype))


class AlphaBlender(nn.Module):
    """Spatial/temporal mix alpha * x_spatial + (1 - alpha) * x_temporal
    (diffusionmodules/util.py:314-381; JAX AlphaBlender and AlphaBlenderB1T):
    - 'learned_with_images' (the SVD config's): alpha = 1 on image-only
      frames, sigmoid(mix_factor) elsewhere; `image_only_indicator` is [b, t]
      and the per-frame alpha broadcasts over [(b t), ...] ('bt') or [b, t,
      ...] ('b_t');
    - 'learned': sigmoid(mix_factor) over everything, no indicator read;
    - 'fixed': alpha = mix_factor itself, a buffer as in the reference (so
      its state dict loads), holding `alpha`; JAX has no leaf for it.
    alpha is rounded to x's dtype before the mix, as in JAX."""

    def __init__(self, alpha: float = 0.5, merge_strategy: str = "learned_with_images",
                 broadcast: str = "bt"):
        super().__init__()
        if merge_strategy not in ("fixed", "learned", "learned_with_images"):
            raise ValueError(f"unknown merge_strategy {merge_strategy!r}")
        self.merge_strategy = merge_strategy
        self.broadcast = broadcast
        if merge_strategy == "fixed":
            self.register_buffer("mix_factor", torch.full((1,), float(alpha)))
        else:
            self.mix_factor = nn.Parameter(torch.full((1,), float(alpha)))

    def forward(self, x_spatial, x_temporal, image_only_indicator=None):
        with record_function("vs:AlphaBlender"):
            if self.merge_strategy == "fixed":
                alpha = self.mix_factor
            else:
                alpha = torch.sigmoid(self.mix_factor.float())
            if self.merge_strategy == "learned_with_images":
                alpha = torch.where(image_only_indicator.bool(), torch.ones_like(alpha), alpha)  # [b, t]
                b, t = alpha.shape
                if self.broadcast == "bt":
                    alpha = alpha.reshape((b * t,) + (1,) * (x_spatial.dim() - 1))
                else:
                    alpha = alpha.reshape((b, t) + (1,) * (x_spatial.dim() - 2))
            alpha = alpha.to(x_spatial.dtype)
            return alpha * x_spatial + (1.0 - alpha) * x_temporal


class GEGLU(nn.Module):
    def __init__(self, dim_in: int, dim_out: int):
        super().__init__()
        self.proj = nn.Linear(dim_in, dim_out * 2)

    def forward(self, x):
        with record_function("vs:GEGLU"):
            x, gate = linear(x, self.proj).chunk(2, dim=-1)
            return x * F.gelu(gate, approximate="tanh")  # flax nn.gelu default


class FeedForward(nn.Module):
    """mult x expansion MLP with a GEGLU gate (attention.py:99-115);
    keys net.0.proj and net.2."""

    def __init__(self, dim: int, mult: int = 4, dim_out: Optional[int] = None):
        super().__init__()
        inner = int(dim * mult)
        self.net = nn.ModuleList([GEGLU(dim, inner), nn.Identity(), nn.Linear(inner, dim_out or dim)])

    def forward(self, x):
        return linear(self.net[0](x), self.net[2])


@dataclasses.dataclass
class Modulation:
    """lambda * mask modulation of one transformer site (attention.py:646-663).

    masks [T, L] at the site's token resolution, lam [T] signed lambda,
    frame_gate [T] bool and enabled (0-d bool) for this step. Adds
    lam[f] * mask[f] to the rows of frame f on both halves of the [uc; c]
    CFG batch (the reference modulates the uc half too)."""

    masks: torch.Tensor
    lam: torch.Tensor
    frame_gate: torch.Tensor
    enabled: torch.Tensor

    def spatial_add(self, out: torch.Tensor) -> torch.Tensor:
        """out: [(2b t), L, C] spatial token layout (uc frames then cond)."""
        t = self.masks.shape[0]
        if out.shape[0] != 2 * t:
            raise ValueError(f"modulation expects the [uc; c] batch of {2 * t} rows, got {out.shape[0]}")
        with record_function("vs:modulation"):
            scale = (
                self.enabled.to(out.dtype) * self.frame_gate.to(out.dtype) * self.lam.to(out.dtype)
            )
            add = scale[:, None] * self.masks.to(out.dtype)  # [T, L]
            return out + torch.cat([add, add], dim=0)[:, :, None]


@dataclasses.dataclass
class BlockModulation:
    """Per-site modulation of one transformer block; None = statically off."""

    self_attn: Optional[Modulation] = None
    cross_attn: Optional[Modulation] = None
    ff_out: Optional[Modulation] = None


@dataclasses.dataclass
class AttnInjection:
    """Injected q/k/v of one attention site, as flat [B, L, H*D] tensors,
    selected over the computed ones where `gate` (0-d bool) is set."""

    gate: torch.Tensor
    q: Optional[torch.Tensor] = None
    k: Optional[torch.Tensor] = None
    v: Optional[torch.Tensor] = None


def _inject(computed, injected, gate):
    if injected is None:
        return computed
    return torch.where(gate, injected.to(computed.dtype), computed)


class CrossAttention(nn.Module):
    """q/k/v projections + attention + output projection (attention.py:257-364);
    the four projections go through matmul_bias (K11 on CUDA).

    Self-attention when context is None. `temporal`: x is the direct
    temporal layout [(b t), s, C] and attention runs across the `frames`
    frames of each token (K2 on CUDA). Otherwise spatial attention over
    axis 1 (K1 on CUDA; one context token takes the V shortcut)."""

    def __init__(self, query_dim: int, heads: int, dim_head: int,
                 context_dim: Optional[int] = None, temporal: bool = False):
        super().__init__()
        inner = heads * dim_head
        context_dim = context_dim or query_dim
        self.heads, self.dim_head = heads, dim_head
        self.temporal = temporal
        self.to_q = nn.Linear(query_dim, inner, bias=False)
        self.to_k = nn.Linear(context_dim, inner, bias=False)
        self.to_v = nn.Linear(context_dim, inner, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(inner, query_dim), nn.Identity()])

    def forward(self, x, context=None, injection: Optional[AttnInjection] = None,
                sow: Optional[Dict[str, torch.Tensor]] = None, frames: Optional[int] = None):
        h, dh = self.heads, self.dim_head
        ctx = x if context is None else context.to(x.dtype)
        b, lq, _ = x.shape
        lk = ctx.shape[1]
        q = project(x, self.to_q)
        k = project(ctx, self.to_k)
        v = project(ctx, self.to_v)

        def to_heads(flat, l):
            # a harvest of another layout has the same element count; refuse
            # it instead of scrambling the heads (layers.py:367-373)
            if flat.shape != (b, l, h * dh):
                raise ValueError(f"injected tensor {tuple(flat.shape)} != {(b, l, h * dh)}")
            return flat

        if injection is not None:
            q = _inject(q, None if injection.q is None else to_heads(injection.q, lq), injection.gate)
            k = _inject(k, None if injection.k is None else to_heads(injection.k, lk), injection.gate)
            v = _inject(v, None if injection.v is None else to_heads(injection.v, lk), injection.gate)
        if sow is not None:
            sow["q"] = q
            sow["k"] = k
        q4, k4, v4 = (t.view(t.shape[0], t.shape[1], h, dh) for t in (q, k, v))
        if self.temporal:
            out = temporal_attention_direct(q4, k4, v4, t=frames)
        else:
            out = dot_product_attention(q4, k4, v4, layout="blhd")
        # one key: `out` is V expanded over the queries, a view K11 cannot read
        return project(out.reshape(b, lq, h * dh).contiguous(), self.to_out[0])


@dataclasses.dataclass
class BlockInjection:
    attn1: Optional[AttnInjection] = None
    attn2: Optional[AttnInjection] = None


def _sub(sow, name):
    return None if sow is None else sow.setdefault(name, {})


class BasicTransformerBlock(nn.Module):
    """Pre-LN self-attn + cross-attn + FF with the VidSeg modulation and
    injection hooks (attention.py:504-759)."""

    def __init__(self, dim: int, heads: int, dim_head: int, context_dim: int):
        super().__init__()
        self.attn1 = CrossAttention(dim, heads, dim_head)
        self.ff = FeedForward(dim)
        self.attn2 = CrossAttention(dim, heads, dim_head, context_dim=context_dim)
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.norm3 = nn.LayerNorm(dim, eps=1e-5)

    def forward(self, x, context=None, modulation: Optional[BlockModulation] = None,
                injection: Optional[BlockInjection] = None, sow=None):
        a1 = self.attn1(
            layer_norm(x, self.norm1), None,
            injection.attn1 if injection is not None else None, _sub(sow, "attn1"),
        )
        if modulation is not None and modulation.self_attn is not None:
            a1 = modulation.self_attn.spatial_add(a1)
        x = a1 + x
        a2 = self.attn2(
            layer_norm(x, self.norm2), context,
            injection.attn2 if injection is not None else None, _sub(sow, "attn2"),
        )
        if modulation is not None and modulation.cross_attn is not None:
            a2 = modulation.cross_attn.spatial_add(a2)
        x = a2 + x
        f = self.ff(layer_norm(x, self.norm3))
        if modulation is not None and modulation.ff_out is not None:
            f = modulation.ff_out.spatial_add(f)
        return x + f


def layer_norm(x: torch.Tensor, ln: nn.LayerNorm) -> torch.Tensor:
    with record_function("vs:LayerNorm"):
        return F.layer_norm(x, ln.normalized_shape, ln.weight.to(x.dtype), ln.bias.to(x.dtype), ln.eps)


class SpatialTransformer(nn.Module):
    """GroupNorm -> proj_in -> transformer blocks -> proj_out + residual
    (attention.py:806-927), linear projections (use_linear)."""

    def __init__(self, channels: int, heads: int, dim_head: int, context_dim: int, depth: int = 1):
        super().__init__()
        inner = heads * dim_head
        self.norm = GroupNorm32(channels, eps=1e-6)
        self.proj_in = nn.Linear(channels, inner)
        self.transformer_blocks = nn.ModuleList(
            [BasicTransformerBlock(inner, heads, dim_head, context_dim) for _ in range(depth)]
        )
        self.proj_out = nn.Linear(inner, channels)

    def forward(self, x, context=None, modulation=None, injection=None, sow=None):
        b, h, w, c = x.shape
        x_in = x
        x = linear(self.norm(x).reshape(b, h * w, c), self.proj_in)
        for d, block in enumerate(self.transformer_blocks):
            x = block(x, context, modulation, injection, _sub(sow, f"transformer_blocks_{d}"))
        x = linear(x, self.proj_out)
        return x.reshape(b, h, w, c) + x_in
