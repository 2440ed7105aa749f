"""Attention: plain PyTorch versions and the wrappers of kernels K1, K2, K3.

Counterpart of vidseg_diffusion_tpu/ops/attention.py. Layouts are the JAX
package's: packed [B, L, H*D] for K1, [B, L, H, D] ("blhd") at the module
sites, [(b t), s, H, D] for the direct temporal layout (K2) and [B, H, L, D]
("bhld") for K3.

Each kernel wrapper takes its plain version for tensors on the CPU and
launches its CUDA kernel (csrc/) for tensors on a CUDA device, or raises;
there is no fallback between the two. Each wrapper and each plain version
carries a plain integer counter (`.launches` / `.calls`) that a run can read
to show which path it took.

The plain versions of the kernels reproduce the kernels' arithmetic: q
pre-scaled by scale*log2(e) in the input dtype, a base-2 softmax, and the p
that feeds P.V rounded to the input dtype with the denominator summed from
the rounded p (ops/attention.py:377-396, :505 of the JAX package).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from vidseg_diffusion_tpu_torch.ops import _cuda

LOG2_E = 1.4426950408889634


def _rounded_qscale(scale: float, dtype: torch.dtype) -> torch.Tensor:
    """scale*log2(e) as a 0-d tensor of `dtype` (rounded as JAX rounds it)."""
    return torch.tensor(scale * LOG2_E, dtype=dtype)


def _attention_base2(q, k, v, scale):
    """The kernels' math on blhd [B, L, H, D] inputs; returns fp32 blhd."""
    qs = (q * _rounded_qscale(scale, q.dtype).to(q.device)).float()
    s = torch.einsum("bqhd,bkhd->bhqk", qs, k.float())
    p = torch.exp2(s - s.amax(dim=-1, keepdim=True)).to(v.dtype).float()
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return out / p.sum(dim=-1).permute(0, 2, 1)[..., None]


def mha_reference(q, k, v, scale: Optional[float] = None, layout: str = "bhld"):
    """Plain attention with an fp32 softmax (the JAX package's mha_reference).
    layout 'bhld' [B, H, L, D] or 'blhd' [B, L, H, D]."""
    mha_reference.calls += 1
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if layout == "blhd":
        logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
        w = torch.softmax(logits, dim=-1).to(v.dtype)
        return torch.einsum("bhqk,bkhd->bqhd", w.float(), v.float()).to(q.dtype)
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    w = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", w.float(), v.float()).to(q.dtype)


mha_reference.calls = 0


# -- K1: packed flash attention --------------------------------------------


def flash_attention_packed_reference(q, k, v, heads: int, scale: Optional[float] = None):
    """Plain version of K1 on packed [B, L, H*D]."""
    flash_attention_packed_reference.calls += 1
    b, lq, hd = q.shape
    lk = k.shape[1]
    d = hd // heads
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    out = _attention_base2(
        q.reshape(b, lq, heads, d), k.reshape(b, lk, heads, d),
        v.reshape(b, lk, heads, d), scale,
    )
    return out.reshape(b, lq, hd).to(q.dtype)


flash_attention_packed_reference.calls = 0


def flash_attention_packed(q, k, v, heads: int, scale: Optional[float] = None):
    """K1: online-softmax attention on packed [B, L, H*D] (any L, D = 64),
    read through the tensors' strides with no transpose."""
    if q.device.type == "cpu":
        return flash_attention_packed_reference(q, k, v, heads, scale)
    dtype = _cuda.check_cuda_tensors("flash_attention_packed", q, k, v)
    if q.dim() != 3 or k.dim() != 3 or k.shape != v.shape:
        raise ValueError(f"flash_attention_packed: bad shapes {q.shape} {k.shape} {v.shape}")
    b, lq, hd = q.shape
    lk = k.shape[1]
    if k.shape[0] != b or k.shape[2] != hd or hd % heads:
        raise ValueError(f"flash_attention_packed: bad shapes {q.shape} {k.shape}, heads={heads}")
    d = hd // heads
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    out = torch.empty((b, lq, heads, d), dtype=dtype, device=q.device)
    strides = _cuda.strides_arg(q.view(b, lq, heads, d), k.view(b, lk, heads, d),
                                v.view(b, lk, heads, d), out)
    if dtype == torch.bfloat16 and (any(s % 8 for s in strides[:9])
                                    or any(t.data_ptr() % 16 for t in (q, k, v))):
        raise ValueError("flash_attention_packed: bf16 q/k/v rows must be 16-byte aligned")
    _cuda.call(
        "vs_flash_attention_packed", _cuda.DTYPE_CODES[dtype], d,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, heads, lq, lk, strides, float(_rounded_qscale(scale, dtype)),
    )
    flash_attention_packed.launches += 1
    return out.view(b, lq, hd)


flash_attention_packed.launches = 0


def small_batched_attention(q, k, v, scale: Optional[float] = None):
    """Attention on [B, L, H, D]. The TPU folds many short problems
    (L < 512) into one MXU tile (_small_seq_kernel); on the GPU short and
    long problems alike are rows of K1's grid on the packed view, so this
    also serves dot_product_attention's long spatial sites."""
    b, lq, h, d = q.shape
    lk = k.shape[1]
    out = flash_attention_packed(
        q.reshape(b, lq, h * d), k.reshape(b, lk, h * d), v.reshape(b, lk, h * d),
        heads=h, scale=scale,
    )
    return out.reshape(b, lq, h, d)


# -- K2: direct-layout temporal attention ------------------------------------


def _to_canonical(x, t):
    """[(b t), s, h, d] -> [(b s), t, h, d]."""
    bt, s, h, d = x.shape
    return x.reshape(bt // t, t, s, h, d).transpose(1, 2).reshape(-1, t, h, d)


def _from_canonical(x, t, b):
    bs, _, h, d = x.shape
    s = bs // b
    return x.reshape(b, s, t, h, d).transpose(1, 2).reshape(b * t, s, h, d)


def temporal_attention_direct_reference(q, k, v, t: int, scale: Optional[float] = None):
    """Plain version of K2 on [(b t), s, H, D]."""
    temporal_attention_direct_reference.calls += 1
    bt, s, h, d = q.shape
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    out = _attention_base2(
        _to_canonical(q, t), _to_canonical(k, t), _to_canonical(v, t), scale
    )
    return _from_canonical(out, t, bt // t).to(q.dtype)


temporal_attention_direct_reference.calls = 0


def temporal_attention_direct(q, k, v, t: int, scale: Optional[float] = None):
    """K2: softmax over the t frames of each (video, token, head), read from
    the spatial token layout [(b t), s, H, D] (contiguous, D = 64, t <= 32,
    any s)."""
    if q.device.type == "cpu":
        return temporal_attention_direct_reference(q, k, v, t, scale)
    dtype = _cuda.check_cuda_tensors("temporal_attention_direct", q, k, v)
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"temporal_attention_direct: bad shapes {q.shape} {k.shape} {v.shape}")
    bt, s, h, d = q.shape
    if bt % t or not 0 < t <= 32:
        raise ValueError(f"temporal_attention_direct: rows {bt} vs t={t}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("temporal_attention_direct: inputs must be contiguous")
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    out = torch.empty_like(q)
    _cuda.call(
        "vs_temporal_attention_direct", _cuda.DTYPE_CODES[dtype], d,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        bt // t, t, s, h, float(_rounded_qscale(scale, dtype)),
    )
    temporal_attention_direct.launches += 1
    return out


temporal_attention_direct.launches = 0


# -- K3: bhld flash attention -------------------------------------------------


def flash_attention_reference(q, k, v, scale: Optional[float] = None):
    """Plain version of K3 on bhld [B, H, L, D]."""
    flash_attention_reference.calls += 1
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else scale
    out = _attention_base2(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), scale
    )
    return out.transpose(1, 2).to(q.dtype)


flash_attention_reference.calls = 0


def flash_attention(q, k, v, scale: Optional[float] = None):
    """K3: flash attention on bhld [B, H, L, D] through strides (D in
    {64, 80, 512}: the VAE's single 512-dim head and CLIP's 80-dim heads)."""
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, scale)
    dtype = _cuda.check_cuda_tensors("flash_attention", q, k, v)
    if q.dim() != 4 or k.shape != v.shape or q.shape[:2] != k.shape[:2] or q.shape[3] != k.shape[3]:
        raise ValueError(f"flash_attention: bad shapes {q.shape} {k.shape} {v.shape}")
    b, h, lq, d = q.shape
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    out = torch.empty((b, h, lq, d), dtype=dtype, device=q.device)
    _cuda.call(
        "vs_flash_attention_bhld", _cuda.DTYPE_CODES[dtype], d,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, h, lq, k.shape[2], _cuda.strides_arg(q, k, v, out, dims=(0, 2, 1)),
        float(_rounded_qscale(scale, dtype)),
    )
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


# -- dispatcher -------------------------------------------------------------


def dot_product_attention(q, k, v, scale: Optional[float] = None, layout: str = "bhld"):
    """Attention dispatcher (the JAX package's dot_product_attention).

    - One key (every SVD cross-attention site, spatial and temporal: the
      context is one pooled CLIP token): softmax over one key is 1, so the
      result is V broadcast over the queries; no kernel runs.
    - CPU tensors: plain attention with an fp32 softmax (what the JAX
      package runs on its CPU backend).
    - CUDA tensors: K1 for blhd (every spatial self-attention site, long or
      short), K3 for bhld."""
    l_axis = 1 if layout == "blhd" else 2
    lq, lk = q.shape[l_axis], k.shape[l_axis]
    if lk == 1:
        shape = list(v.shape)
        shape[l_axis] = lq
        return v.expand(shape).to(q.dtype)
    if q.device.type == "cpu":
        return mha_reference(q, k, v, scale=scale, layout=layout)
    if layout == "blhd":
        return small_batched_attention(q, k, v, scale=scale)
    return flash_attention(q, k, v, scale=scale)


PLAIN_COUNTERS = (
    mha_reference,
    flash_attention_packed_reference,
    temporal_attention_direct_reference,
    flash_attention_reference,
)
KERNEL_COUNTERS = (flash_attention_packed, temporal_attention_direct, flash_attention)
