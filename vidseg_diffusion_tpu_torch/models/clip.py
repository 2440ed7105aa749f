"""OpenCLIP towers (PyTorch): the ViT image tower (the SVD image embedder)
and the causal text towers of the text embedders.

Counterpart of vidseg_diffusion_tpu/models/clip.py (CLIPVisionTransformer,
clip_preprocess: :141-203; CLIPTextTransformer, :68-126). The text tower
covers the reference's three text embedders:
- SD 2.1 FrozenOpenCLIPEmbedder: layer 'penultimate' (the last block is not
  built) or 'last', then ln_final;
- SDXL FrozenOpenCLIPEmbedder2 (ViT-bigG, `return_pooled`): every block runs;
  the hidden states are the penultimate block's output without ln_final, the
  pooled output is ln_final(last) at the argmax-token (EOT) position times
  text_projection;
- SDXL FrozenCLIPEmbedder (HF CLIP-L, layer 'hidden', layer_idx 11):
  `HFCLIPTextTransformer`, quick-GELU, the output of its first layer_idx
  layers, no final LayerNorm, under HF's CLIPTextModel key names.
open_clip parameter names are the keys after the packed in_proj is split into
attn.q/k/v and out_proj is named attn.out (the names clip_vision_key_fn /
clip_text_key_fn of the JAX package map to, the vision tower's minus the
leading 'visual.'). The image tower's attention runs in the head-major
[B, H, L, D] layout: K3 on CUDA (80-dim heads at ViT-H). The text towers'
causal attention over 77 tokens is an explicit masked softmax, as in the JAX
package (clip.py:41-51), outside any kernel: JAX's reaches no Pallas kernel
there either.
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


def _block(x, heads: int, causal: bool, act: str, ln_1, q_proj, k_proj, v_proj, out_proj, ln_2, fc, fc_out):
    """Pre-LN attention + MLP (open_clip ResidualAttentionBlock, HF
    CLIPEncoderLayer); `causal`: each token attends to itself and the tokens
    before it; `act` 'gelu' (exact) or 'quick_gelu' (h * sigmoid(1.702 h))."""
    b, l, w = x.shape
    h = layer_norm(x, ln_1)
    q, k, v = (linear(h, m).view(b, l, heads, w // heads).transpose(1, 2) for m in (q_proj, k_proj, v_proj))
    if causal:
        # logits and softmax in fp32, the weights cast to v's dtype
        logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) / math.sqrt(w // heads)
        mask = torch.ones((l, l), dtype=torch.bool, device=x.device).tril()
        weights = torch.softmax(logits.masked_fill(~mask, -math.inf), dim=-1).to(v.dtype)
        out = torch.einsum("bhqk,bhkd->bhqd", weights, v)
    else:
        out = dot_product_attention(q, k, v)
    x = x + linear(out.transpose(1, 2).reshape(b, l, w), out_proj)
    h = linear(layer_norm(x, ln_2), fc)
    h = h * torch.sigmoid(1.702 * h) if act == "quick_gelu" else F.gelu(h)
    return x + linear(h, fc_out)


class ResidualAttentionBlock(nn.Module):
    """open_clip's ResidualAttentionBlock (keys ln_1, attn.q/k/v/out, ln_2,
    mlp.c_fc / c_proj)."""

    def __init__(self, width: int, heads: int, causal: bool = False, act: str = "gelu"):
        super().__init__()
        self.heads, self.causal, self.act = heads, causal, act
        self.ln_1 = nn.LayerNorm(width, eps=1e-5)
        self.attn = _Attn(width)
        self.ln_2 = nn.LayerNorm(width, eps=1e-5)
        self.mlp = _MLP(width)

    def forward(self, x):
        a, m = self.attn, self.mlp
        return _block(x, self.heads, self.causal, self.act, self.ln_1, a.q, a.k, a.v, a.out, self.ln_2,
                      m.c_fc, m.c_proj)


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
    act: str = "gelu"  # "quick_gelu" for the OpenAI CLIP-L tower
    dtype: torch.dtype = torch.float32


class CLIPTextTransformer(nn.Module):
    """Token ids [b, 77] -> hidden states [b, 77, width] (open_clip keys).

    - penultimate (the default, SD 2.1's layer 'penultimate'): the first
      layers - 1 blocks, then ln_final; the last block is not built (a
      checkpoint's keys for it are left unused);
    - penultimate False (layer 'last'): every block, then ln_final;
    - return_pooled (SDXL bigG): every block; returns (the penultimate
      block's output without ln_final, ln_final(last)[argmax token] @
      text_projection [b, width])."""

    def __init__(self, cfg: CLIPTextConfig, penultimate: bool = True, return_pooled: bool = False):
        super().__init__()
        self.config = cfg
        self.penultimate, self.return_pooled = penultimate, return_pooled
        w = cfg.width
        n = cfg.layers - (1 if penultimate and not return_pooled else 0)
        self.token_embedding = nn.Embedding(cfg.vocab_size, w)
        self.positional_embedding = nn.Parameter(torch.zeros(cfg.context_length, w))
        self.transformer = nn.Module()
        self.transformer.resblocks = nn.ModuleList(
            [ResidualAttentionBlock(w, cfg.heads, causal=True, act=cfg.act) for _ in range(n)]
        )
        self.ln_final = nn.LayerNorm(w, eps=1e-5)
        if return_pooled:
            self.text_projection = nn.Parameter(torch.zeros(w, w))

    def forward(self, tokens):
        dt = self.config.dtype
        tokens = tokens.long()
        x = self.token_embedding.weight[tokens].to(dt) + self.positional_embedding.to(dt)[None]
        x_pen = x
        for block in self.transformer.resblocks:
            x_pen = x
            x = block(x)
        if not self.return_pooled:
            return layer_norm(x, self.ln_final)
        pooled = layer_norm(x, self.ln_final)[torch.arange(x.shape[0], device=x.device), tokens.argmax(-1)]
        return (x_pen if self.penultimate else x), pooled @ self.text_projection.to(dt)


class _HFAttn(nn.Module):
    def __init__(self, width: int):
        super().__init__()
        self.q_proj, self.k_proj = nn.Linear(width, width), nn.Linear(width, width)
        self.v_proj, self.out_proj = nn.Linear(width, width), nn.Linear(width, width)


class _HFMLP(nn.Module):
    def __init__(self, width: int):
        super().__init__()
        self.fc1, self.fc2 = nn.Linear(width, width * 4), nn.Linear(width * 4, width)


class HFCLIPLayer(nn.Module):
    """HF CLIPEncoderLayer: keys self_attn.{q,k,v,out}_proj, layer_norm1,
    mlp.fc1 / fc2, layer_norm2."""

    def __init__(self, width: int, heads: int, act: str):
        super().__init__()
        self.heads, self.act = heads, act
        self.self_attn = _HFAttn(width)
        self.layer_norm1 = nn.LayerNorm(width, eps=1e-5)
        self.mlp = _HFMLP(width)
        self.layer_norm2 = nn.LayerNorm(width, eps=1e-5)

    def forward(self, x):
        a = self.self_attn
        return _block(x, self.heads, True, self.act, self.layer_norm1, a.q_proj, a.k_proj, a.v_proj,
                      a.out_proj, self.layer_norm2, self.mlp.fc1, self.mlp.fc2)


class HFCLIPTextTransformer(nn.Module):
    """The SDXL CLIP-L tower (FrozenCLIPEmbedder, layer 'hidden'): token ids
    [b, 77] -> the output of the first `layer_idx` layers (HF's
    hidden_states[layer_idx]), no final LayerNorm, under HF CLIPTextModel's
    keys (text_model.embeddings.token_embedding / position_embedding,
    text_model.encoder.layers.{i}), so the checkpoint's
    conditioner.embedders.0.transformer.* loads in place; the layers past
    layer_idx and the final LayerNorm are not built."""

    def __init__(self, cfg: CLIPTextConfig, layer_idx: int):
        super().__init__()
        self.config = cfg
        w = cfg.width
        self.text_model = nn.Module()
        self.text_model.embeddings = nn.Module()
        self.text_model.embeddings.token_embedding = nn.Embedding(cfg.vocab_size, w)
        self.text_model.embeddings.position_embedding = nn.Embedding(cfg.context_length, w)
        self.text_model.encoder = nn.Module()
        self.text_model.encoder.layers = nn.ModuleList(
            [HFCLIPLayer(w, cfg.heads, cfg.act) for _ in range(layer_idx)]
        )

    def forward(self, tokens):
        dt = self.config.dtype
        emb = self.text_model.embeddings
        x = emb.token_embedding.weight[tokens.long()].to(dt) + emb.position_embedding.weight.to(dt)[None]
        for layer in self.text_model.encoder.layers:
            x = layer(x)
        return x


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
