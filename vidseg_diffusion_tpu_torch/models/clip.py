"""OpenCLIP towers (PyTorch): the ViT image tower (the SVD image embedder)
and the text tower (the SD 2.1 text embedder).

Counterpart of vidseg_diffusion_tpu/models/clip.py (CLIPVisionTransformer,
clip_preprocess: :141-203; CLIPTextTransformer in its SD 2.1 form, :68-126:
penultimate layer, then ln_final). Parameter names are the open_clip keys
after the packed in_proj is split into attn.q/k/v and out_proj is named
attn.out (the names clip_vision_key_fn / clip_text_key_fn of the JAX package
map to, the vision tower's minus the leading 'visual.'). The image tower's
attention runs in the head-major [B, H, L, D] layout: K3 on CUDA (80-dim heads
at ViT-H). The text tower's causal attention over 77 tokens is an explicit
masked softmax, as in the JAX package (clip.py:41-51), outside any kernel.
"""

from __future__ import annotations

import dataclasses
import math

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
    """Pre-LN attention + exact-GELU MLP (open_clip ResidualAttentionBlock);
    `causal`: each token attends to itself and the tokens before it."""

    def __init__(self, width: int, heads: int, causal: bool = False):
        super().__init__()
        self.heads = heads
        self.causal = causal
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
        if self.causal:
            # logits and softmax in fp32, the weights cast to v's dtype
            logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) / math.sqrt(w // self.heads)
            mask = torch.ones((l, l), dtype=torch.bool, device=x.device).tril()
            weights = torch.softmax(logits.masked_fill(~mask, -math.inf), dim=-1).to(v.dtype)
            out = torch.einsum("bhqk,bhkd->bhqd", weights, v)
        else:
            out = dot_product_attention(q, k, v)
        out = out.transpose(1, 2).reshape(b, l, w)
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


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    width: int = 1024
    heads: int = 16
    layers: int = 24
    context_length: int = 77
    dtype: torch.dtype = torch.float32


class CLIPTextTransformer(nn.Module):
    """Token ids [b, 77] -> hidden states [b, 77, width] of the penultimate
    layer under ln_final (FrozenOpenCLIPEmbedder with layer 'penultimate',
    modules.py:552-563): the last of the `layers` blocks is never run, so it
    is not built (a checkpoint's keys for it are left unused)."""

    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.config = cfg
        w = cfg.width
        self.token_embedding = nn.Embedding(cfg.vocab_size, w)
        self.positional_embedding = nn.Parameter(torch.zeros(cfg.context_length, w))
        self.transformer = nn.Module()
        self.transformer.resblocks = nn.ModuleList(
            [ResidualAttentionBlock(w, cfg.heads, causal=True) for _ in range(cfg.layers - 1)]
        )
        self.ln_final = nn.LayerNorm(w, eps=1e-5)

    def forward(self, tokens):
        dt = self.config.dtype
        x = self.token_embedding.weight[tokens.long()].to(dt) + self.positional_embedding.to(dt)[None]
        for block in self.transformer.resblocks:
            x = block(x)
        return layer_norm(x, self.ln_final)


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
