"""T5 / ByT5 text-encoder tower (PyTorch).

Counterpart of vidseg_diffusion_tpu/models/t5.py (the reference's
FrozenT5Embedder / FrozenByT5Embedder, sgm/modules/encoders/modules.py:249-328,
which wrap HF `T5EncoderModel`). Module names are HF's, so an HF
`T5EncoderModel` state dict (`shared.weight`,
`encoder.block.{i}.layer.0.SelfAttention.{q,k,v,o}.weight`, ...,
`encoder.final_layer_norm.weight`) loads in place; its tied
`encoder.embed_tokens.weight` is accepted and left unused.

T5's quirks, as in the JAX tower:
- RMS LayerNorm: the variance in fp32, no mean and no bias, cast to the
  dtype, then times the scale; it reads the residual sum before its
  rounding, as XLA's fusion of the add into the norm does (T5Block);
- unscaled attention logits in fp32 plus one learned relative-position
  bias table, owned by block 0 and shared by every layer; the softmax in
  fp32, cast to v's dtype. The core is a plain matmul + softmax: JAX
  computes it with einsum outside any Pallas kernel (:103-113), and the
  port's attention kernels take no additive bias;
- the v1.1 gated-GELU FFN (`wi_0` through gelu_new, times `wi_1`) or the
  legacy ReLU `wi`. gelu_new is jax.nn.gelu(approximate=True) written out,
  each operation rounded to the activation's dtype as JAX's are (F.gelu's
  tanh form rounds once: 42 % of bf16 elements a step apart).
The projections go through `models/layers.linear`, as CLIP's do.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Dict

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from vidseg_diffusion_tpu_torch.models.layers import linear


@dataclasses.dataclass(frozen=True)
class T5Config:
    vocab_size: int = 32128       # byt5: 384
    d_model: int = 512
    d_kv: int = 64
    num_heads: int = 8
    d_ff: int = 1024
    num_layers: int = 6
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    feed_forward_proj: str = "gated-gelu"  # | "relu" (legacy t5)
    layer_norm_epsilon: float = 1e-6
    dtype: torch.dtype = torch.float32


class T5RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        xf = x.float()
        var = xf.square().mean(dim=-1, keepdim=True)
        return self.weight.to(dtype) * (xf * torch.rsqrt(var + self.eps)).to(dtype)


def relative_position_bucket(relative_position: torch.Tensor, num_buckets: int = 32,
                             max_distance: int = 128) -> torch.Tensor:
    """Bidirectional log-bucketed relative positions (HF
    T5Attention._relative_position_bucket, with the JAX tower's + 1e-6 inside
    the log), int32."""
    num_buckets //= 2
    ret = (relative_position > 0).to(torch.int32) * num_buckets
    n = relative_position.abs().to(torch.int32)
    max_exact = num_buckets // 2
    is_small = n < max_exact
    val_if_large = max_exact + (
        torch.log(n.float() / max_exact + 1e-6) / math.log(max_distance / max_exact) * (num_buckets - max_exact)
    ).to(torch.int32)
    val_if_large = torch.clamp(val_if_large, max=num_buckets - 1)
    return ret + torch.where(is_small, n, val_if_large)


def gelu_new(x: torch.Tensor) -> torch.Tensor:
    """x * 0.5 * (1 + tanh(sqrt(2 / pi) * (x + 0.044715 x^3))), op by op in
    x's dtype (jax.nn.gelu(approximate=True)). The constants are filled on
    x's device: a torch.tensor copied from the host would wait for the stream
    twice a layer."""
    c = torch.full((), math.sqrt(2.0 / math.pi), dtype=x.dtype, device=x.device)
    inner = x + torch.full((), 0.044715, dtype=x.dtype, device=x.device) * (x * x * x)
    return x * (0.5 * (1.0 + torch.tanh(c * inner)))


class _SelfAttention(nn.Module):
    def __init__(self, cfg: T5Config, has_bias: bool):
        super().__init__()
        inner = cfg.num_heads * cfg.d_kv
        self.q = nn.Linear(cfg.d_model, inner, bias=False)
        self.k = nn.Linear(cfg.d_model, inner, bias=False)
        self.v = nn.Linear(cfg.d_model, inner, bias=False)
        self.o = nn.Linear(inner, cfg.d_model, bias=False)
        if has_bias:
            self.relative_attention_bias = nn.Embedding(cfg.relative_attention_num_buckets, cfg.num_heads)


class _AttnLayer(nn.Module):
    def __init__(self, cfg: T5Config, has_bias: bool):
        super().__init__()
        self.SelfAttention = _SelfAttention(cfg, has_bias)
        self.layer_norm = T5RMSNorm(cfg.d_model, cfg.layer_norm_epsilon)


class _DenseReluDense(nn.Module):
    def __init__(self, cfg: T5Config):
        super().__init__()
        if cfg.feed_forward_proj == "gated-gelu":
            self.wi_0 = nn.Linear(cfg.d_model, cfg.d_ff, bias=False)
            self.wi_1 = nn.Linear(cfg.d_model, cfg.d_ff, bias=False)
        else:
            self.wi = nn.Linear(cfg.d_model, cfg.d_ff, bias=False)
        self.wo = nn.Linear(cfg.d_ff, cfg.d_model, bias=False)


class _FFLayer(nn.Module):
    def __init__(self, cfg: T5Config):
        super().__init__()
        self.DenseReluDense = _DenseReluDense(cfg)
        self.layer_norm = T5RMSNorm(cfg.d_model, cfg.layer_norm_epsilon)


class T5Block(nn.Module):
    """One encoder block (HF T5Block: layer.0 self-attention, layer.1 FFN).

    Takes and returns the residual stream twice: `x` in the dtype and `xs`,
    the same sum before its rounding (fp32). Each RMSNorm reads `xs`: XLA
    fuses the residual add into the norm that follows it and skips the
    add's bf16 rounding there (22 % of a bf16 norm's elements a step apart
    otherwise), while the stream itself is rounded."""

    def __init__(self, cfg: T5Config, has_bias: bool = False):
        super().__init__()
        self.config = cfg
        self.layer = nn.ModuleList([_AttnLayer(cfg, has_bias), _FFLayer(cfg)])

    def forward(self, x: torch.Tensor, xs: torch.Tensor, position_bias: torch.Tensor):
        cfg = self.config
        dt = cfg.dtype
        b, l, _ = x.shape
        attn, ff = self.layer
        a = attn.SelfAttention
        h = attn.layer_norm(xs, dt)
        q, k, v = (linear(h, m).view(b, l, cfg.num_heads, cfg.d_kv).transpose(1, 2) for m in (a.q, a.k, a.v))
        logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) + position_bias
        w = torch.softmax(logits, dim=-1).to(v.dtype)
        out = torch.matmul(w, v).transpose(1, 2).reshape(b, l, cfg.num_heads * cfg.d_kv)
        xs = x.float() + linear(out, a.o).float()
        x = xs.to(dt)

        d = ff.DenseReluDense
        h = ff.layer_norm(xs, dt)
        if cfg.feed_forward_proj == "gated-gelu":
            h = gelu_new(linear(h, d.wi_0)) * linear(h, d.wi_1)
        else:
            h = F.relu(linear(h, d.wi))
        xs = x.float() + linear(h, d.wo).float()
        return xs.to(dt), xs


class T5Encoder(nn.Module):
    """Token ids [b, l] -> the final-normed hidden states [b, l, d_model]
    (HF `last_hidden_state`, what FrozenT5Embedder.forward returns)."""

    def __init__(self, cfg: T5Config):
        super().__init__()
        self.config = cfg
        self.shared = nn.Embedding(cfg.vocab_size, cfg.d_model)
        self.encoder = nn.Module()
        self.encoder.block = nn.ModuleList([T5Block(cfg, has_bias=i == 0) for i in range(cfg.num_layers)])
        self.encoder.final_layer_norm = T5RMSNorm(cfg.d_model, cfg.layer_norm_epsilon)

    def position_bias(self, l: int, device) -> torch.Tensor:
        """[1, heads, l, l] fp32: block 0's table at the buckets of
        memory - context positions."""
        cfg = self.config
        pos = torch.arange(l, device=device)
        buckets = relative_position_bucket(pos[None, :] - pos[:, None], cfg.relative_attention_num_buckets,
                                           cfg.relative_attention_max_distance)
        table = self.encoder.block[0].layer[0].SelfAttention.relative_attention_bias.weight
        return table[buckets.long()].permute(2, 0, 1)[None].float()

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        tokens = torch.as_tensor(tokens).to(self.shared.weight.device).long()
        x = self.shared.weight[tokens].to(cfg.dtype)
        xs = x.float()
        bias = self.position_bias(tokens.shape[-1], x.device)
        for block in self.encoder.block:
            x, xs = block(x, xs, bias)
        return self.encoder.final_layer_norm(xs, cfg.dtype)

    def load_state_dict(self, state_dict, strict: bool = True, assign: bool = False):
        """HF's state dict, its tied `encoder.embed_tokens.weight` dropped."""
        sd = {k: v for k, v in state_dict.items() if k != "encoder.embed_tokens.weight"}
        return super().load_state_dict(sd, strict=strict, assign=assign)


def t5_config_from_state_dict(sd: Dict, dtype: torch.dtype = torch.float32) -> T5Config:
    """A T5Config from an HF `T5EncoderModel` state dict (the reference YAMLs
    carry only the HF version string, modules.py:252-255). max_distance is
    not in the shapes; every released t5 / byt5 checkpoint uses 128."""
    shape = lambda k: tuple(np.shape(sd[k]))
    vocab, d_model = shape("shared.weight")
    n_layers = 1 + max(int(m.group(1)) for k in sd if (m := re.match(r"encoder\.block\.(\d+)\.", k)))
    inner = shape("encoder.block.0.layer.0.SelfAttention.q.weight")[0]
    num_buckets, num_heads = shape("encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight")
    gated = "encoder.block.0.layer.1.DenseReluDense.wi_0.weight" in sd
    d_ff = shape(f"encoder.block.0.layer.1.DenseReluDense.{'wi_0' if gated else 'wi'}.weight")[0]
    return T5Config(vocab_size=vocab, d_model=d_model, d_kv=inner // num_heads, num_heads=num_heads, d_ff=d_ff,
                    num_layers=n_layers, relative_attention_num_buckets=num_buckets,
                    feed_forward_proj="gated-gelu" if gated else "relu", dtype=dtype)


def byt5_tokenize(texts, max_length: int = 77, pad_id: int = 0, eos_id: int = 1) -> np.ndarray:
    """ByT5 byte-level tokenizer (HF ByT5Tokenizer: utf-8 bytes shifted by 3
    special ids, EOS appended, truncated and padded to max_length); int32
    [n, max_length]. No vocabulary file: this is the whole tokenizer."""
    if isinstance(texts, str):
        texts = [texts]
    out = np.full((len(texts), max_length), pad_id, dtype=np.int32)
    for i, t in enumerate(texts):
        ids = [b + 3 for b in t.encode("utf-8")][: max_length - 1] + [eos_id]
        out[i, : len(ids)] = ids
    return out


def t5_tokenize(texts, sp_model_path: str, max_length: int = 77) -> np.ndarray:
    """SentencePiece T5 tokenization: needs the `sentencepiece` package and a
    `spiece.model` file, neither in the repository; pre-tokenized ids can be
    fed to T5Encoder directly, and byt5_tokenize needs no vocabulary."""
    try:
        import sentencepiece as spm
    except ImportError as e:
        raise ImportError(
            "t5_tokenize needs the `sentencepiece` package (not bundled); pass pre-tokenized ids to T5Encoder "
            "instead, or use byt5_tokenize which is vocab-free") from e
    sp = spm.SentencePieceProcessor(model_file=sp_model_path)
    if isinstance(texts, str):
        texts = [texts]
    out = np.zeros((len(texts), max_length), dtype=np.int32)
    for i, t in enumerate(texts):
        ids = sp.encode(t)[: max_length - 1] + [sp.eos_id()]
        out[i, : len(ids)] = ids
    return out
