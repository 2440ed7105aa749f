"""OpenCLIP ViT image tower (PyTorch), the SVD image embedder.

Counterpart of the vision half of vidseg_diffusion_tpu/models/clip.py
(CLIPVisionTransformer, clip_preprocess: :141-203). Parameter names are the
open_clip keys of the `visual` tower after the packed in_proj is split into
attn.q/k/v and out_proj is named attn.out (the names clip_vision_key_fn of
the JAX package maps to, minus the leading 'visual.'). Attention runs in the
head-major [B, H, L, D] layout: K3 on CUDA (80-dim heads at ViT-H).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn as nn
import torch.nn.functional as F

from vidseg_diffusion_tpu_torch.models.layers import layer_norm, linear
from vidseg_diffusion_tpu_torch.ops.attention import dot_product_attention
from vidseg_diffusion_tpu_torch.ops.image import resize_bicubic


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    image_size: int = 224
    patch_size: int = 14
    width: int = 1280
    heads: int = 16
    layers: int = 32
    output_dim: int = 1024
    dtype: torch.dtype = torch.float32


class _Attn(nn.Module):
    def __init__(self, width: int):
        super().__init__()
        self.q = nn.Linear(width, width)
        self.k = nn.Linear(width, width)
        self.v = nn.Linear(width, width)
        self.out = nn.Linear(width, width)


class _MLP(nn.Module):
    def __init__(self, width: int):
        super().__init__()
        self.c_fc = nn.Linear(width, width * 4)
        self.c_proj = nn.Linear(width * 4, width)


class ResidualAttentionBlock(nn.Module):
    """Pre-LN attention + exact-GELU MLP (open_clip ResidualAttentionBlock)."""

    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.ln_1 = nn.LayerNorm(width, eps=1e-5)
        self.attn = _Attn(width)
        self.ln_2 = nn.LayerNorm(width, eps=1e-5)
        self.mlp = _MLP(width)

    def forward(self, x):
        b, l, w = x.shape
        h = layer_norm(x, self.ln_1)
        q, k, v = (
            linear(h, m).view(b, l, self.heads, w // self.heads).transpose(1, 2)
            for m in (self.attn.q, self.attn.k, self.attn.v)
        )
        out = dot_product_attention(q, k, v).transpose(1, 2).reshape(b, l, w)
        x = x + linear(out, self.attn.out)
        h = F.gelu(linear(layer_norm(x, self.ln_2), self.mlp.c_fc))
        return x + linear(h, self.mlp.c_proj)


class CLIPVisionTransformer(nn.Module):
    """[b, 224, 224, 3] CLIP-normalized images -> pooled, projected
    embedding [b, output_dim]."""

    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.config = cfg
        w = cfg.width
        grid = (cfg.image_size // cfg.patch_size) ** 2
        self.conv1 = nn.Conv2d(3, w, cfg.patch_size, stride=cfg.patch_size, bias=False)
        self.class_embedding = nn.Parameter(torch.zeros(w))
        self.positional_embedding = nn.Parameter(torch.zeros(grid + 1, w))
        self.ln_pre = nn.LayerNorm(w, eps=1e-5)
        self.transformer = nn.Module()
        self.transformer.resblocks = nn.ModuleList(
            [ResidualAttentionBlock(w, cfg.heads) for _ in range(cfg.layers)]
        )
        self.ln_post = nn.LayerNorm(w, eps=1e-5)
        self.proj = nn.Parameter(torch.zeros(w, cfg.output_dim))

    def forward(self, x):
        cfg = self.config
        dt = cfg.dtype
        b = x.shape[0]
        x = F.conv2d(x.to(dt).permute(0, 3, 1, 2), self.conv1.weight.to(dt), stride=cfg.patch_size)
        x = x.flatten(2).transpose(1, 2)  # [b, grid, w]
        cls = self.class_embedding.to(dt).expand(b, 1, -1)
        x = torch.cat([cls, x], dim=1) + self.positional_embedding.to(dt)[None]
        x = layer_norm(x, self.ln_pre)
        for block in self.transformer.resblocks:
            x = block(x)
        pooled = layer_norm(x[:, 0], self.ln_post)
        return pooled @ self.proj.to(dt)


_CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
_CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def clip_preprocess(x: torch.Tensor) -> torch.Tensor:
    """[-1, 1] frames [b, h, w, 3] -> 224x224 CLIP-normalized (antialiased
    bicubic resize, then mean/std; modules.py:620-632)."""
    x = resize_bicubic(x.float().permute(0, 3, 1, 2), (224, 224)).permute(0, 2, 3, 1)
    x = (x + 1.0) / 2.0
    mean = torch.tensor(_CLIP_MEAN, device=x.device)
    std = torch.tensor(_CLIP_STD, device=x.device)
    return (x - mean) / std
