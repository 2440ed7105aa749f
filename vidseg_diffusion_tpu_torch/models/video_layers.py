"""Temporal transformer blocks of the SVD UNet, in the direct layout only.

Counterpart of vidseg_diffusion_tpu/models/video_layers.py with
VIDSEG_TEMPORAL_LAYOUT=direct (its default, :55): the temporal blocks stay
in the UNet's spatial token layout [(b t), s, C] and temporal attention runs
across the t frames of each token (K2 on CUDA), so no (b t) s c <-> (b s) t c
transpose exists. The folded layout is not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from vidseg_diffusion_tpu_torch.models.layers import (
    AlphaBlender,
    BasicTransformerBlock,
    BlockInjection,
    BlockModulation,
    CrossAttention,
    FeedForward,
    GroupNorm32,
    _sub,
    layer_norm,
    linear,
    timestep_embedding,
)


class VideoTransformerBlock(nn.Module):
    """Temporal transformer block (video_attention.py:18-288), SVD form:
    ff_in with residual, temporal self-attention, cross-attention to the
    first frame's context, FF. Only attn1 accepts injected q/k/v
    (video_attention.py:166-195). With context_dim None (the VideoDecoder's
    VideoAttnBlock) attn2 is a self-attention over the block's own tokens as
    JAX builds it: in the direct layout over the s tokens of each frame, not
    over the t frames the reference's folded layout attends across."""

    def __init__(self, dim: int, heads: int, dim_head: int, context_dim: Optional[int]):
        super().__init__()
        self.ff_in = FeedForward(dim, dim_out=dim)
        self.norm_in = nn.LayerNorm(dim, eps=1e-5)
        self.attn1 = CrossAttention(dim, heads, dim_head, temporal=True)
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn2 = CrossAttention(dim, heads, dim_head, context_dim=context_dim)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.ff = FeedForward(dim, dim_out=dim)
        self.norm3 = nn.LayerNorm(dim, eps=1e-5)

    def forward(self, x, context, timesteps: int, modulation: Optional[BlockModulation] = None,
                injection: Optional[BlockInjection] = None, sow=None):
        """x [(b t), s, C] with t = timesteps frames per video."""
        x = self.ff_in(layer_norm(x, self.norm_in)) + x
        a1 = self.attn1(
            layer_norm(x, self.norm1), None,
            injection.attn1 if injection is not None else None, _sub(sow, "attn1"),
            frames=timesteps,
        )
        if modulation is not None and modulation.self_attn is not None:
            a1 = modulation.self_attn.spatial_add(a1)
        x = a1 + x
        a2 = self.attn2(layer_norm(x, self.norm2), context, None, _sub(sow, "attn2"))
        if modulation is not None and modulation.cross_attn is not None:
            a2 = modulation.cross_attn.spatial_add(a2)
        x = a2 + x
        f = self.ff(layer_norm(x, self.norm3))
        if modulation is not None and modulation.ff_out is not None:
            f = modulation.ff_out.spatial_add(f)
        return x + f


@dataclasses.dataclass
class SiteModulation:
    spatial: Optional[BlockModulation] = None
    temporal: Optional[BlockModulation] = None


@dataclasses.dataclass
class SiteInjection:
    spatial: Optional[BlockInjection] = None
    temporal: Optional[BlockInjection] = None


class SpatialVideoTransformer(nn.Module):
    """Spatial block -> frame-position embedding -> temporal block -> alpha
    merge, per depth (video_attention.py:291-489)."""

    def __init__(self, channels: int, heads: int, dim_head: int, context_dim: int,
                 depth: int = 1, merge_factor: float = 0.5,
                 merge_strategy: str = "learned_with_images", max_time_embed_period: int = 10000):
        super().__init__()
        inner = heads * dim_head
        self.max_time_embed_period = max_time_embed_period
        self.norm = GroupNorm32(channels, eps=1e-6)
        self.proj_in = nn.Linear(channels, inner)
        self.transformer_blocks = nn.ModuleList(
            [BasicTransformerBlock(inner, heads, dim_head, context_dim) for _ in range(depth)]
        )
        self.time_stack = nn.ModuleList(
            [VideoTransformerBlock(inner, heads, dim_head, context_dim) for _ in range(depth)]
        )
        self.time_pos_embed = nn.ModuleList(
            [nn.Linear(channels, channels * 4), nn.SiLU(), nn.Linear(channels * 4, channels)]
        )
        self.time_mixer = AlphaBlender(merge_factor, merge_strategy, broadcast="bt")
        self.proj_out = nn.Linear(inner, channels)

    def forward(self, x, context, timesteps: int, image_only_indicator=None,
                modulation: Optional[SiteModulation] = None,
                injection: Optional[SiteInjection] = None, sow=None):
        """x [(b t), H, W, C] with t = timesteps; context [(b t), Lc, ctx]."""
        bt, h, w, c = x.shape
        t = timesteps
        x_in = x
        time_context = None
        if context is not None:
            # each video's first-frame context, repeated per frame row
            time_context = torch.repeat_interleave(context[::t], t, dim=0)
        x = linear(self.norm(x).reshape(bt, h * w, c), self.proj_in)

        frame_ids = torch.arange(t, device=x.device).repeat(bt // t)
        t_emb = timestep_embedding(frame_ids, c, max_period=self.max_time_embed_period)
        emb = linear(t_emb.to(x.dtype), self.time_pos_embed[0])
        emb = linear(F.silu(emb), self.time_pos_embed[2])[:, None, :]

        for d, (spatial, temporal) in enumerate(zip(self.transformer_blocks, self.time_stack)):
            x = spatial(
                x, context,
                modulation.spatial if modulation is not None else None,
                injection.spatial if injection is not None else None,
                _sub(sow, f"transformer_blocks_{d}"),
            )
            x_mix = temporal(
                x + emb, time_context, t,
                modulation.temporal if modulation is not None else None,
                injection.temporal if injection is not None else None,
                _sub(sow, f"time_stack_{d}"),
            )
            x = self.time_mixer(x, x_mix, image_only_indicator)
        x = linear(x, self.proj_out)
        return x.reshape(bt, h, w, c) + x_in
