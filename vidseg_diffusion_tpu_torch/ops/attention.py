"""Attention: plain PyTorch versions and the wrappers of kernels K1, K2, K3,
K5, K6 and K13.

Counterpart of vidseg_diffusion_tpu/ops/attention.py. Layouts are the JAX
package's: packed [B, L, H*D] for K1 and its backward K5, [B, L, H, D]
("blhd") at the module sites, [(b t), s, H, D] for the direct temporal
layout (K2 and its backward K6) and [B, H, L, D] ("bhld") for K3.

Each kernel wrapper takes its plain version for tensors on the CPU and
launches its CUDA kernel (csrc/) for tensors on a CUDA device, or raises;
there is no fallback between the two. Each wrapper and each plain version
carries a plain integer counter (`.launches` / `.calls`) that a run can read
to show which path it took; the wrappers also count their launches by head
dim (`.dim_launches`, a Counter; K1 and K3 their normalise-first launches
too, `.normalised_dim_launches`) and by the kernel that ran (`.*_launches`).

Gradients: when grad mode is on and an input requires grad, K1, K2 and K3
run inside a torch.autograd.Function (the JAX package's custom_vjps,
attention.py:1207-1535) whose backward is K5 (packed flash backward), K6
(direct-layout temporal backward) or K13 (bhld flash backward; K5 at D = 64)
on CUDA and their plain versions on the CPU, so both devices have the same
autograd structure. K1 and K3 then also write the per-row base-2 logsumexp
that K5 and K13 read. Otherwise (inference, torch.no_grad) the wrappers
launch the forward kernel alone: no LSE, no saved tensors.

The plain versions of the kernels reproduce the kernels' arithmetic: q
pre-scaled by scale*log2(e) in the input dtype, a base-2 softmax, and the p
that feeds P.V rounded to the input dtype. The denominator follows the JAX
kernel each site replaces: the sum of the rounded p where that kernel is the
packed one with fused_psum (attention.py:376-396 of the JAX package: K1 at
the long sites, and K3 under a gradient, which _fa_fwd runs through it), the
fp32 sum of the unrounded p elsewhere (_temporal_direct_kernel :1398-1403 for
K2, _small_seq_kernel :590-595 for K1 at the short sites, _flash_kernel
:147-156 for K3 without a gradient). The backward versions round ds, and p
where it feeds dV, to the input dtype before the products
(attention.py:813-906, :1068-1120).

Routing: site_route mirrors the JAX package's TPU dispatch (dot_product_attention)
case by case, and dot_product_attention and small_batched_attention take their
kernel from it. Where JAX sends a site to no Pallas kernel but to mha_reference
(mixed lengths on either side of 512, bhld shorter than 512, too few folded
rows), the card runs K1 or K3 in their normalise-first mode: S from the
unscaled q in fp32 times scale*log2(e), p = exp2(s - m) / l normalised in fp32
before it is rounded to the input dtype, and no division after P.V
(_attention_normalised is its plain version; where a head's keys fit, the
kernels hold its K and V in shared memory, `.resident_launches`). At
such a site under a gradient, and where no normalise-first kernel takes the
dtype and head dim (bf16 K1 at D = 16 and 64, K3 at D = 16, 64 and 80), the
port runs mha_reference itself under autograd on either device, as JAX runs
and differentiates it there (mha_reference_site, counted apart from the plain
versions).

Head dims: the kernels take every head dim the shipped configs produce at a
kernel site (HEAD_DIMS: 16 from the tiny configs, 64, CLIP's 80 at bhld, and
512 at the VAE's bhld sites and the VideoDecoder VideoAttnBlock's blhd (one
head) and temporal sites), forward and, where a training path can reach them,
backward (BACKWARD_HEAD_DIMS). A site whose head dim no kernel takes raises a
ValueError on the card before any launch; nothing falls back to a plain
version.
"""

from __future__ import annotations

import collections
import math
from typing import Optional

import torch

from vidseg_diffusion_tpu_torch.ops import _cuda

LOG2_E = 1.4426950408889634


def _rounded_qscale(scale: float, dtype: torch.dtype) -> torch.Tensor:
    """scale*log2(e) as a 0-d tensor of `dtype` (rounded as JAX rounds it)."""
    return torch.tensor(scale * LOG2_E, dtype=dtype)


def _needs_grad(*tensors: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _attention_base2(q, k, v, scale, with_lse: bool = False, psum_rounded: bool = True):
    """The kernels' math on blhd [B, L, H, D] inputs; returns fp32 blhd, and
    with_lse the base-2 logsumexp m + log2(l) as fp32 [B, L, H]. The
    denominator l sums the p rounded to the input dtype (psum_rounded: the
    packed kernel's fused_psum) or the fp32 p before that rounding."""
    qs = (q * _rounded_qscale(scale, q.dtype).to(q.device)).float()
    s = torch.einsum("bqhd,bkhd->bhqk", qs, k.float())
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp2(s - m)
    p = e.to(v.dtype).float()
    l = (p if psum_rounded else e).sum(dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float()) / l.permute(0, 2, 1)[..., None]
    if not with_lse:
        return out
    return out, (m[..., 0] + torch.log2(l)).permute(0, 2, 1)


def _attention_normalised(q, k, v, scale):
    """mha_reference's math in the kernels' base 2 on blhd [B, L, H, D]: the
    logits from the unscaled inputs in fp32 times scale*log2(e), the softmax
    normalised in fp32, p rounded to the input dtype, P.V in fp32 with no
    division after it. Returns fp32 blhd."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * (scale * LOG2_E)
    e = torch.exp2(s - s.amax(dim=-1, keepdim=True))
    p = (e / e.sum(dim=-1, keepdim=True)).to(v.dtype).float()
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float())


def _sum_mode(psum_rounded: bool, normalise_first: bool, streamed: bool = False) -> int:
    """The C entries' softmax mode: 0 the fp32 sum of p, 1 the sum of the
    rounded p, 2 normalise first (mha_reference), 3 normalise first on the
    kernel that streams the keys from device memory where mode 2 would hold
    them in shared memory (the yardstick chip_smoke.py times beside it)."""
    if streamed and not normalise_first:
        raise ValueError("streamed is a kernel of the normalise-first mode")
    return (3 if streamed else 2) if normalise_first else int(psum_rounded)


def _kernel_qscale(scale: float, dtype: torch.dtype, normalise_first: bool) -> float:
    """What the kernels multiply by: scale*log2(e) rounded to the input dtype
    (the q prescale of the Pallas kernels), or as the C float it is passed as,
    on the fp32 logits (normalise first)."""
    return scale * LOG2_E if normalise_first else float(_rounded_qscale(scale, dtype))


def _refuse_normalised_grad(name, normalise_first, *tensors):
    if normalise_first and _needs_grad(*tensors):
        raise ValueError(f"{name}: the normalise-first route has no backward; a site that trains keeps "
                         "the flash route (site_route)")


def _mha(q, k, v, scale: Optional[float], layout: str):
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if layout == "blhd":
        logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
        w = torch.softmax(logits, dim=-1).to(v.dtype)
        return torch.einsum("bhqk,bkhd->bqhd", w.float(), v.float()).to(q.dtype)
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    w = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", w.float(), v.float()).to(q.dtype)


def mha_reference(q, k, v, scale: Optional[float] = None, layout: str = "bhld"):
    """Plain attention with an fp32 softmax (the JAX package's mha_reference).
    layout 'bhld' [B, H, L, D] or 'blhd' [B, L, H, D]."""
    mha_reference.calls += 1
    return _mha(q, k, v, scale, layout)


mha_reference.calls = 0


def mha_reference_site(q, k, v, scale: Optional[float] = None, layout: str = "bhld"):
    """mha_reference run as the route of an attention site, on the card as on
    the CPU: where JAX's TPU dispatch runs mha_reference and the site takes a
    gradient (JAX differentiates mha_reference there) or no normalise-first
    kernel takes its dtype and head dim. Its own counter (`.calls`) tells it
    from the plain versions that hold the kernels."""
    mha_reference_site.calls += 1
    return _mha(q, k, v, scale, layout)


mha_reference_site.calls = 0


# -- K1: packed flash attention (forward, optional LSE) ------------------------


def flash_attention_packed_reference(q, k, v, heads: int, scale: Optional[float] = None,
                                     save_lse: bool = False, psum_rounded: bool = True,
                                     normalise_first: bool = False):
    """Plain version of K1 on packed [B, L, H*D]; save_lse also returns the
    base-2 LSE [B, L, H] fp32 (the JAX package's save_lse output);
    psum_rounded and normalise_first as K1's (flash_attention_packed)."""
    flash_attention_packed_reference.calls += 1
    b, lq, hd = q.shape
    lk = k.shape[1]
    d = hd // heads
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    if normalise_first:
        if save_lse:
            raise ValueError("flash_attention_packed: the normalise-first route writes no LSE")
        out = _attention_normalised(q.reshape(b, lq, heads, d), k.reshape(b, lk, heads, d),
                                    v.reshape(b, lk, heads, d), scale)
        return out.reshape(b, lq, hd).to(q.dtype)
    res = _attention_base2(
        q.reshape(b, lq, heads, d), k.reshape(b, lk, heads, d),
        v.reshape(b, lk, heads, d), scale, with_lse=save_lse, psum_rounded=psum_rounded,
    )
    if save_lse:
        return res[0].reshape(b, lq, hd).to(q.dtype), res[1]
    return res.reshape(b, lq, hd).to(q.dtype)


flash_attention_packed_reference.calls = 0


def _check_packed(name, q, k, v, heads):
    dtype = _cuda.check_cuda_tensors(name, q, k, v)
    if q.dim() != 3 or k.dim() != 3 or k.shape != v.shape:
        raise ValueError(f"{name}: bad shapes {q.shape} {k.shape} {v.shape}")
    b, _, hd = q.shape
    if k.shape[0] != b or k.shape[2] != hd or hd % heads:
        raise ValueError(f"{name}: bad shapes {q.shape} {k.shape}, heads={heads}")
    return dtype


def _check_aligned_rows(name, dtype, d, strides, n_vec, *tensors):
    """The tensor-core kernels load rows as 16-byte vectors (bf16, and fp32 at
    D = 512, whose split-TF32 kernels read by TMA): the first `n_vec` strides
    must be whole vectors and the base pointers aligned."""
    vec = 8 if dtype == torch.bfloat16 else 4 if d == 512 else 0
    if vec and (any(s % vec for s in strides[:n_vec]) or any(t.data_ptr() % 16 for t in tensors)):
        raise ValueError(f"{name}: {'bf16' if vec == 8 else 'fp32 D = 512'} q/k/v rows must be 16-byte aligned")


def _flash_attention_packed_forward(q, k, v, heads: int, scale: Optional[float], save_lse: bool,
                                    psum_rounded: bool = True, normalise_first: bool = False,
                                    streamed: bool = False):
    """K1 on CUDA tensors (the plain version on CPU): out, or (out, lse).
    streamed runs the normalise-first mode on the kernel that streams the keys
    (sum mode 3)."""
    if q.device.type == "cpu":
        return flash_attention_packed_reference(q, k, v, heads, scale, save_lse=save_lse,
                                                psum_rounded=psum_rounded, normalise_first=normalise_first)
    dtype = _check_packed("flash_attention_packed", q, k, v, heads)
    b, lq, hd = q.shape
    lk = k.shape[1]
    d = hd // heads
    _check_head_dim("flash_attention_packed", "blhd", (b, lq, heads, d), d, heads)
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    out = torch.empty((b, lq, heads, d), dtype=dtype, device=q.device)
    lse = torch.empty((b, lq, heads), dtype=torch.float32, device=q.device) if save_lse else None
    strides = _cuda.strides_arg(q.view(b, lq, heads, d), k.view(b, lk, heads, d),
                                v.view(b, lk, heads, d), out)
    _check_aligned_rows("flash_attention_packed", dtype, d, strides, 9, q, k, v)
    route = _cuda.call_routed(
        "vs_flash_attention_packed", _cuda.DTYPE_CODES[dtype], d,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr() if save_lse else None,
        b, heads, lq, lk, strides, _kernel_qscale(scale, dtype, normalise_first),
        _sum_mode(psum_rounded, normalise_first, streamed),
    )
    resident = route.endswith("_resident")
    route = route.removesuffix("_resident")
    flash_attention_packed.launches += 1
    flash_attention_packed.dim_launches[d] += 1
    flash_attention_packed.resident_launches += resident
    flash_attention_packed.wgmma_launches += route == "wgmma"
    flash_attention_packed.mma_launches += route == "mma_sync"
    flash_attention_packed.tf32x3_launches += route == "tf32x3"
    flash_attention_packed.fma_launches += route == "fma"
    if normalise_first and dtype == torch.bfloat16:
        flash_attention_packed.normalised_launches += 1
        flash_attention_packed.normalised_dim_launches[d] += 1
    out = out.view(b, lq, hd)
    return (out, lse) if save_lse else out


class _FlashAttentionPacked(torch.autograd.Function):
    """K1 forward with LSE; K5 backward (the JAX package's _fap custom_vjp)."""

    @staticmethod
    def forward(ctx, q, k, v, heads, scale, psum_rounded):
        out, lse = _flash_attention_packed_forward(q, k, v, heads, scale, save_lse=True,
                                                   psum_rounded=psum_rounded)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.heads, ctx.scale = heads, scale
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_packed_backward(
            q, k, v, out, lse, g.contiguous(), ctx.heads, ctx.scale)
        return dq, dk, dv, None, None, None


def flash_attention_packed(q, k, v, heads: int, scale: Optional[float] = None,
                           psum_rounded: bool = True, normalise_first: bool = False):
    """K1: online-softmax attention on packed [B, L, H*D] (any L; D = 16 or
    64, or 512 at one head), read through the tensors' strides with no
    transpose; bf16 runs the wgmma kernel fed by TMA at D = 64 (at one 512-dim
    head K3's D = 512 kernel, which reads the same rows), the mma.sync
    template at D = 16, and needs 16-byte aligned rows (a view that is not is
    refused); fp32 at D = 64 and at one 512-dim head (K3's kernel) runs
    split-TF32 tensor-core kernels (`.tf32x3_launches`) where TMA can address
    q, k and v (16-byte aligned bases and rows), else (D = 16, unaligned D =
    64) the FMA kernel (`.fma_launches`). The denominator
    sums the rounded p (psum_rounded, JAX's fused_psum default) or the fp32 p (the short sites,
    small_batched_attention); the LSE written under a gradient is m + log2 of
    that same sum. normalise_first computes mha_reference's softmax instead
    (p normalised in fp32, then rounded; no gradient). Differentiable
    otherwise: with grad on, the backward is K5."""
    _refuse_normalised_grad("flash_attention_packed", normalise_first, q, k, v)
    if _needs_grad(q, k, v):
        return _FlashAttentionPacked.apply(q, k, v, heads, scale, psum_rounded)
    return _flash_attention_packed_forward(q, k, v, heads, scale, save_lse=False,
                                           psum_rounded=psum_rounded, normalise_first=normalise_first)


flash_attention_packed.launches = 0
flash_attention_packed.dim_launches = collections.Counter()   # launches by head dim
flash_attention_packed.wgmma_launches = 0   # of .launches, those that ran a wgmma kernel (D = 64, 512)
flash_attention_packed.mma_launches = 0   # of .launches, those on the mma.sync template (bf16 D = 16)
# of .launches, fp32 on split TF32 products: D = 512 (wgmma) and D = 64 where TMA can address q, k, v (mma.sync)
flash_attention_packed.tf32x3_launches = 0
flash_attention_packed.fma_launches = 0   # of .launches, the other fp32 ones (D = 16, unaligned D = 64), on FMAs
flash_attention_packed.normalised_launches = 0   # bf16 launches in the normalise-first mode
flash_attention_packed.normalised_dim_launches = collections.Counter()   # those by head dim
# of .normalised_launches, those on the kernel that holds a head's K and V in shared memory (D = 64,
# up to 128 keys); the others stream the keys from device memory
flash_attention_packed.resident_launches = 0


# -- K5: packed flash-attention backward ---------------------------------------


def flash_attention_packed_backward_reference(q, k, v, out, lse, g, heads: int,
                                              scale: Optional[float] = None):
    """Plain version of K5 (_flash_attention_packed_bwd_impl): p recomputed
    as exp2(qf k^T - lse) with qf = q*scale*log2(e) in the input dtype,
    delta = rowsum(g * out) per head in fp32, ds = p * (g v^T - delta); ds,
    and p where it feeds dv, rounded to the input dtype; dq scaled by
    `scale`, dk divided by log2(e). Returns (dq, dk, dv) packed."""
    flash_attention_packed_backward_reference.calls += 1
    return _packed_backward_math(q, k, v, out, lse, g, heads, scale)


flash_attention_packed_backward_reference.calls = 0


def _packed_backward_math(q, k, v, out, lse, g, heads, scale):
    b, lq, hd = q.shape
    lk = k.shape[1]
    d = hd // heads
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    dt = q.dtype
    acc = torch.float64 if dt == torch.float64 else torch.float32   # float64 inputs: the float64 reference
    qf = (q * _rounded_qscale(scale, dt).to(q.device)).reshape(b, lq, heads, d).to(acc)
    kf = k.reshape(b, lk, heads, d).to(acc)
    vf = v.reshape(b, lk, heads, d).to(acc)
    gf = g.to(dt).reshape(b, lq, heads, d).to(acc)
    delta = (g.to(acc) * out.to(acc)).reshape(b, lq, heads, d).sum(-1)        # [B, Lq, H]
    p = torch.exp2(torch.einsum("bqhd,bkhd->bhqk", qf, kf) - lse.to(acc).permute(0, 2, 1)[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", gf, vf)
    ds = (p * (dp - delta.permute(0, 2, 1)[..., None])).to(dt).to(acc)
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(dt).to(acc), gf)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf) * (1.0 / LOG2_E)
    return (dq.reshape(b, lq, hd).to(dt), dk.reshape(b, lk, hd).to(k.dtype),
            dv.reshape(b, lk, hd).to(v.dtype))


def flash_attention_packed_backward(q, k, v, out, lse, g, heads: int,
                                    scale: Optional[float] = None):
    """K5: (dq, dk, dv) of K1 from its saved LSE, on packed [B, L, H*D]
    through strides; two kernels, dq over key tiles and dk/dv over query
    tiles, each the only writer of its outputs: bf16 at D = 64 on wgmma
    (`.wgmma_launches`), at D = 16 on mma.sync (`.mma_launches`), fp32 at
    D = 64 on split-TF32 mma.sync products where TMA can address q, k, v, out
    and g (`.tf32x3_launches`), else on FMAs (`.fma_launches`).
    At one 512-dim head (the VideoAttnBlock's attn2) K13's D = 512 kernels run
    on the packed strides: [B, L, 1 x 512] is [B, L, 1, 512] read as (batch,
    row, head), the LSE [B, L, 1] is K13's [B, Lq, H], as JAX's _fa_bwd and
    _fap_bwd reach the same packed backward at heads = 1. The plain version on
    CPU."""
    if q.device.type == "cpu":
        return flash_attention_packed_backward_reference(q, k, v, out, lse, g, heads, scale)
    dtype = _check_packed("flash_attention_packed_backward", q, k, v, heads)
    _cuda.check_cuda_tensors("flash_attention_packed_backward", q, out, g)
    b, lq, hd = q.shape
    lk = k.shape[1]
    d = hd // heads
    _check_head_dim("flash_attention_packed_backward", "blhd", (b, lq, heads, d), d, heads, backward=True)
    if out.shape != q.shape or g.shape != q.shape or lse.shape != (b, lq, heads):
        raise ValueError(f"flash_attention_packed_backward: bad shapes out {out.shape}, "
                         f"g {g.shape}, lse {lse.shape} for q {q.shape}")
    if lse.dtype != torch.float32 or not lse.is_contiguous() or lse.device != q.device:
        raise ValueError("flash_attention_packed_backward: lse must be contiguous fp32 on q's device")
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    dq = torch.empty((b, lq, heads, d), dtype=dtype, device=q.device)
    dk = torch.empty((b, lk, heads, d), dtype=dtype, device=q.device)
    dv = torch.empty_like(dk)
    r4 = lambda t, l: t.view(b, l, heads, d)
    strides = _cuda.strides_arg(r4(q, lq), r4(k, lk), r4(v, lk), r4(out, lq), r4(g, lq), dq, dk, dv)
    _check_aligned_rows("flash_attention_packed_backward", dtype, d, strides, 15, q, k, v, out, g)
    route = _cuda.call_routed(
        "vs_flash_attention_bhld_bwd" if d == 512 else "vs_flash_attention_packed_bwd", _cuda.DTYPE_CODES[dtype], d,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), g.data_ptr(),
        lse.data_ptr(), _bwd_scratch(b, heads, lq, q.device).data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        b, heads, lq, lk, strides, float(_rounded_qscale(scale, dtype)), float(scale),
    )
    _count_routes(flash_attention_packed_backward, d, route)
    return dq.view(b, lq, hd), dk.view(b, lk, hd), dv.view(b, lk, hd)


_ROUTE_COUNTERS = {"wgmma": "wgmma_launches", "mma_sync": "mma_launches", "tf32x3": "tf32x3_launches",
                   "wide": "wide_launches", "long": "long_launches", "tc_short": "tc_short_launches",
                   "fma": "fma_launches"}


def _count_routes(counter, d, route):
    """A backward launch on its wrapper's counters: launches, by head dim, and
    by the kernel that ran where the wrapper counts that kernel."""
    counter.launches += 1
    counter.dim_launches[d] += 1
    attr = _ROUTE_COUNTERS.get(route)
    if attr is not None and hasattr(counter, attr):
        setattr(counter, attr, getattr(counter, attr) + 1)


flash_attention_packed_backward.launches = 0
flash_attention_packed_backward.dim_launches = collections.Counter()
flash_attention_packed_backward.wgmma_launches = 0   # bf16 D = 64 and 512 (K13's kernels), on the wgmma kernels
flash_attention_packed_backward.mma_launches = 0   # bf16 D = 16 (K5's and K13's), on the mma.sync kernels
flash_attention_packed_backward.tf32x3_launches = 0   # fp32 D = 64 and 512 (K13's kernels), on split TF32 products
flash_attention_packed_backward.fma_launches = 0   # fp32 D = 16, and fp32 D = 64 TMA cannot address, on FMAs


def _bwd_scratch(b, h, lq, device):
    """fp32 scratch of the flash backwards (K5, K13): the dq kernel writes each
    row's LSE and delta = rowsum(g * o) there as [2, B*H, Lq rounded up to 4]
    (rows 16-byte aligned, read by the dk/dv kernel's TMA); K13's fp32 D = 512
    kernels write delta into the first half."""
    return torch.empty((2, b * h, (lq + 3) // 4 * 4), dtype=torch.float32, device=device)


# The JAX package's TPU dispatch (dot_product_attention, attention.py:1584-1644):
# below SHORT_SEQ (max of Lq, Lk) a blhd site folds `fold` problems into one
# _small_seq_kernel tile if that gives at least SMALL_MIN_ROWS rows; with both
# lengths at SHORT_SEQ or more it runs a flash kernel; everything else goes to
# mha_reference (attention.py:714, :717, :1609-1644).
SHORT_SEQ = 512
SMALL_MIN_ROWS = 112


def _best_fold(b: int, lq: int, lk: int) -> int:
    """The largest divisor of B that is at most SHORT_SEQ // max(Lq, Lk): JAX's
    _best_fold (attention.py:642-656) without its VMEM budget, which never
    binds below 512 folded rows at these widths (the VMEM models are not
    ported: ROADMAP, "Not to port")."""
    cap = max(1, SHORT_SEQ // max(lq, lk))
    return next(f for f in range(min(cap, b), 0, -1) if b % f == 0)


# head dims built into the kernels, forward: K1 (blhd sites; 512 at one head
# only), K2 (temporal sites) and K3 (bhld sites); backward: K5 (at one 512-dim
# head K13's kernels on the packed strides), K6 and K13 (K5 at 16 and 64); of
# the forward ones, those whose bf16 kernel has the
# normalise-first mode (fp32 has no rounding to order, so its kernels serve
# either way). A head dim the configs come to produce is one more entry here
# and one more case in the kernels' dispatch.
HEAD_DIMS = {"blhd": (16, 64, 512), "temporal": (16, 64, 512), "bhld": (16, 64, 80, 512)}
ONE_HEAD_DIMS = {"blhd": (512,)}   # taken at one head only
BACKWARD_HEAD_DIMS = {"blhd": (16, 64, 512), "temporal": (16, 64, 512), "bhld": (16, 64, 80, 512)}
NORMALISED_HEAD_DIMS = {"blhd": (16, 64), "bhld": (16, 64, 80)}


def _check_head_dim(where: str, kind: str, shape, d: int, heads: int = 1, backward: bool = False) -> None:
    """Refuse, before any launch, a head dim no kernel of the site takes
    (with `backward`, also the gradient's kernel)."""
    dims = BACKWARD_HEAD_DIMS[kind] if backward else HEAD_DIMS[kind]
    if d not in dims or (heads != 1 and d in ONE_HEAD_DIMS.get(kind, ())):
        one = f", {ONE_HEAD_DIMS[kind]} at one head only" if kind in ONE_HEAD_DIMS else ""
        raise ValueError(f"{where}: head dim {d} of shape {tuple(shape)} is not built into the "
                         f"{'backward ' if backward else ''}kernels (D in {dims}{one}); ROADMAP section C")


def _runs_mha_reference(layout: str, q, k, v) -> bool:
    """At an "mha_reference" site: whether mha_reference_site runs it (under a
    gradient, or where no normalise-first kernel takes the dtype and D)."""
    d, heads = q.shape[-1], q.shape[2 if layout == "blhd" else 1]
    takes = (d in (HEAD_DIMS if q.dtype == torch.float32 else NORMALISED_HEAD_DIMS)[layout]
             and (heads == 1 or d not in ONE_HEAD_DIMS.get(layout, ())))
    return _needs_grad(q, k, v) or not takes


def site_route(layout: str, b: int, lq: int, lk: int) -> str:
    """Which function JAX's TPU dispatch runs at an attention site: "one_key"
    (Lk = 1: V itself), "small_batched" (_small_seq_kernel; blhd only),
    "flash" (the packed flash kernel for blhd, _flash_kernel for bhld) or
    "mha_reference". The port runs K1 with the fp32 sum, K1 / K3 with theirs,
    and K1 / K3 in the normalise-first mode (or mha_reference_site) at these."""
    if lk == 1:
        return "one_key"
    if layout == "blhd" and max(lq, lk) < SHORT_SEQ and _best_fold(b, lq, lk) * lq >= SMALL_MIN_ROWS:
        return "small_batched"
    if lq >= SHORT_SEQ and lk >= SHORT_SEQ:
        return "flash"
    return "mha_reference"


def small_batched_attention(q, k, v, scale: Optional[float] = None):
    """Attention on [B, L, H, D] through K1 on the packed view, the kernel
    that site_route names for the site: the fp32 sum of _small_seq_kernel
    ("small_batched"), the rounded sum of the packed kernel's fused_psum
    ("flash"), or the normalise-first mode ("mha_reference"). On the TPU
    short problems fold into one MXU tile; on the GPU short and long problems
    alike are rows of K1's grid. An "mha_reference" site under a gradient, or
    of a dtype and D no normalise-first kernel takes, runs mha_reference_site."""
    b, lq, h, d = q.shape
    lk = k.shape[1]
    route = site_route("blhd", b, lq, lk)
    if route == "mha_reference" and _runs_mha_reference("blhd", q, k, v):
        return mha_reference_site(q, k, v, scale=scale, layout="blhd")
    if q.device.type == "cuda":
        _check_head_dim(f"'{route}' attention site", "blhd", q.shape, d, h, backward=_needs_grad(q, k, v))
    out = flash_attention_packed(
        q.reshape(b, lq, h * d), k.reshape(b, lk, h * d), v.reshape(b, lk, h * d),
        heads=h, scale=scale, psum_rounded=max(lq, lk) >= SHORT_SEQ, normalise_first=route == "mha_reference",
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
    """Plain version of K2 on [(b t), s, H, D]: the denominator is the fp32
    sum of the unrounded p, as in _temporal_direct_kernel."""
    temporal_attention_direct_reference.calls += 1
    bt, s, h, d = q.shape
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    out = _attention_base2(
        _to_canonical(q, t), _to_canonical(k, t), _to_canonical(v, t), scale, psum_rounded=False
    )
    return _from_canonical(out, t, bt // t).to(q.dtype)


temporal_attention_direct_reference.calls = 0


# past this many frames K2 and K6 run the tensor-core kernels of csrc/temporal_attention_long_tc.cu at D = 64
# and 512 (TMA boxes: 16-byte aligned bases) and the frame-walking kernels of csrc/temporal_attention_long.cu
# at D = 16, where K6 reads a scratch of three floats a query row
TILED_FRAMES = 32


def _check_temporal(name, t, *tensors):
    dtype = _cuda.check_cuda_tensors(name, *tensors)
    q = tensors[0]
    if q.dim() != 4 or any(x.shape != q.shape for x in tensors):
        raise ValueError(f"{name}: bad shapes {[tuple(x.shape) for x in tensors]}")
    if t <= 0 or q.shape[0] % t:
        raise ValueError(f"{name}: rows {q.shape[0]} vs t={t}")
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError(f"{name}: inputs must be contiguous")
    d = q.shape[-1]
    if (d == 512 or t > TILED_FRAMES and d != 16) and any(x.data_ptr() % 16 for x in tensors):
        where = "" if d == 512 else f"past {TILED_FRAMES} frames "
        raise ValueError(f"{name}: {where}at D = {d} every base must be 16-byte aligned (the kernels read their rows "
                         "by TMA or 16-byte vectors)")
    return dtype


def _temporal_attention_direct_forward(q, k, v, t: int, scale: Optional[float]):
    if q.device.type == "cpu":
        return temporal_attention_direct_reference(q, k, v, t, scale)
    dtype = _check_temporal("temporal_attention_direct", t, q, k, v)
    bt, s, h, d = q.shape
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    out = torch.empty_like(q)
    route = _cuda.call_routed(
        "vs_temporal_attention_direct", _cuda.DTYPE_CODES[dtype], d,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        bt // t, t, s, h, float(_rounded_qscale(scale, dtype)),
    )
    temporal_attention_direct.launches += 1
    temporal_attention_direct.dim_launches[d] += 1
    temporal_attention_direct.frame_launches[t] += 1
    temporal_attention_direct.mma_launches += route == "mma_sync"
    temporal_attention_direct.wide_launches += route == "wide"
    temporal_attention_direct.tc_short_launches += route == "tc_short"
    temporal_attention_direct.long_launches += route == "long"
    if route == "long":
        temporal_attention_direct.long_dim_launches[d] += 1
    return out


class _TemporalAttentionDirect(torch.autograd.Function):
    """K2 forward; K6 backward (the JAX package's _tad custom_vjp, without
    its canonical-layout transposes)."""

    @staticmethod
    def forward(ctx, q, k, v, t, scale):
        out = _temporal_attention_direct_forward(q, k, v, t, scale)
        ctx.save_for_backward(q, k, v, out)
        ctx.t, ctx.scale = t, scale
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out = ctx.saved_tensors
        dq, dk, dv = temporal_attention_direct_backward(q, k, v, out, g.contiguous(), ctx.t, ctx.scale)
        return dq, dk, dv, None, None


def temporal_attention_direct(q, k, v, t: int, scale: Optional[float] = None):
    """K2: softmax over the t frames of each (video, token, head), read from
    the spatial token layout [(b t), s, H, D] (contiguous, D in {16, 64, 512},
    any t and s). Up to 32 frames bf16 at D = 64 runs on the tensor cores
    (mma.sync, q/k/v boxes by TMA), D = 512 on the tensor cores too from the
    C entry's crossover (`.tc_short_launches`: eight warps a problem, bf16
    mma.sync, fp32 split TF32; 16-byte aligned bases) and on the wide kernel
    below it (`.wide_launches`, lanes across the head dim), the rest on CUDA
    cores; past 32 frames (`.long_launches`)
    D = 64 and 512 on the tensor cores in both dtypes (bf16 mma.sync, fp32
    split TF32; 16-byte aligned bases; at D = 64 up to 64 frames a block
    holds the whole problem), D = 16 on the frame-walking kernel.
    Differentiable: with grad on, the backward is K6."""
    if q.device.type == "cuda":
        _check_head_dim("temporal attention site", "temporal", q.shape, q.shape[-1], backward=_needs_grad(q, k, v))
    if _needs_grad(q, k, v):
        return _TemporalAttentionDirect.apply(q, k, v, t, scale)
    return _temporal_attention_direct_forward(q, k, v, t, scale)


temporal_attention_direct.launches = 0
temporal_attention_direct.dim_launches = collections.Counter()
temporal_attention_direct.frame_launches = collections.Counter()   # of .launches, by the frames t
temporal_attention_direct.mma_launches = 0   # of .launches, those on the tensor cores (bf16 D = 64)
temporal_attention_direct.wide_launches = 0   # of .launches, those on the D = 512 wide kernel
# of .launches, those on the D = 512 tensor-core kernel up to 32 frames (from csrc/temporal_attention.cu's
# kTc512FwdMinFrames*)
temporal_attention_direct.tc_short_launches = 0
temporal_attention_direct.long_launches = 0   # of .launches, those past 32 frames
temporal_attention_direct.long_dim_launches = collections.Counter()   # those by head dim (D = 16: the frame walk)


# -- K6: direct-layout temporal-attention backward -----------------------------


def temporal_attention_direct_backward_reference(q, k, v, out, g, t: int,
                                                 scale: Optional[float] = None):
    """Plain version of K6 (_small_seq_bwd_kernel's math on the t-length
    problems): the softmax recomputed as the true weights e / sum(e) in fp32,
    delta = rowsum(g * out), ds = p * (g v^T - delta); ds, and p where it
    feeds dv, rounded to the input dtype. [(b t), s, H, D] in and out."""
    temporal_attention_direct_backward_reference.calls += 1
    bt, s, h, d = q.shape
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    dt = q.dtype
    can = lambda x: _to_canonical(x, t).float()
    qf = can(q * _rounded_qscale(scale, dt).to(q.device))
    kf, vf, gf = can(k), can(v), can(g.to(dt))
    delta = (can(g) * can(out)).sum(-1).permute(0, 2, 1)[..., None]   # [(b s), h, t, 1]
    s2 = torch.einsum("bqhd,bkhd->bhqk", qf, kf)
    e = torch.exp2(s2 - s2.amax(dim=-1, keepdim=True))
    p = e / e.sum(dim=-1, keepdim=True)
    dp = torch.einsum("bqhd,bkhd->bhqk", gf, vf)
    ds = (p * (dp - delta)).to(dt).float()
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(dt).float(), gf)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf) * (1.0 / LOG2_E)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
    back = lambda x, like: _from_canonical(x, t, bt // t).to(like.dtype)
    return back(dq, q), back(dk, k), back(dv, v)


temporal_attention_direct_backward_reference.calls = 0


def temporal_attention_direct_backward(q, k, v, out, g, t: int, scale: Optional[float] = None):
    """K6: (dq, dk, dv) of K2, read and written in the UNet-native
    [(b t), s, H, D] layout (no canonical transposes). D = 64: bf16 one warp
    per (video, token, head) problem on the tensor cores (mma.sync, the five
    inputs in and the three gradients out by TMA); fp32 from 2 frames a block
    per problem on split TF32 products (`.tc_short_launches`) where every base
    is 16-byte aligned, on CUDA cores at one frame or where a base is not
    (`.fma_launches`). D = 16 on CUDA cores. D = 512 (the VideoAttnBlock's time mix) from 4 (bf16) or 5 (fp32) up to 32
    frames on the tensor cores, a block a problem (bf16 mma.sync,
    `.mma_launches`; fp32 split TF32 products, `.tf32x3_launches`); below that
    on the wide kernel, lanes across the head dim (`.wide_launches`). Past 32
    frames (`.long_launches`) D = 64 and 512 run the tensor-core kernels
    (16-byte aligned bases), D = 16 the frame-walking kernel, given a scratch
    of three floats a query row (read by the frame walk, and by the
    tensor-core kernels where shared memory cannot hold those statistics). The
    plain version on CPU."""
    if q.device.type == "cpu":
        return temporal_attention_direct_backward_reference(q, k, v, out, g, t, scale)
    dtype = _check_temporal("temporal_attention_direct_backward", t, q, k, v, out, g)
    _check_head_dim("temporal attention backward", "temporal", q.shape, q.shape[-1], backward=True)
    bt, s, h, d = q.shape
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    # past TILED_FRAMES: each query row's max, sum and delta = rowsum(g * out), read by the frame walk (D = 16) and
    # by the tensor-core kernels where shared memory cannot hold them
    work = torch.empty(bt * s * h * 3, dtype=torch.float32, device=q.device) if t > TILED_FRAMES else None
    route = _cuda.call_routed(
        "vs_temporal_attention_direct_bwd", _cuda.DTYPE_CODES[dtype], d,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), g.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), None if work is None else work.data_ptr(),
        bt // t, t, s, h, float(_rounded_qscale(scale, dtype)), float(scale),
    )
    _count_routes(temporal_attention_direct_backward, d, route)
    temporal_attention_direct_backward.frame_launches[t] += 1
    if route == "long":
        temporal_attention_direct_backward.long_dim_launches[d] += 1
    return dq, dk, dv


temporal_attention_direct_backward.launches = 0
temporal_attention_direct_backward.dim_launches = collections.Counter()
temporal_attention_direct_backward.frame_launches = collections.Counter()   # of .launches, by the frames t
temporal_attention_direct_backward.mma_launches = 0   # bf16 D = 64, and D = 512 at 4-32 frames, on mma.sync
temporal_attention_direct_backward.tf32x3_launches = 0   # fp32 D = 512 at 5-32 frames, on split TF32 products
temporal_attention_direct_backward.wide_launches = 0   # D = 512 below 4 / 5 frames, on the wide kernel
temporal_attention_direct_backward.tc_short_launches = 0   # fp32 D = 64 at 2-32 frames, on split TF32 products
# on CUDA cores: D = 16, and fp32 D = 64 at one frame or on a base off 16 bytes
temporal_attention_direct_backward.fma_launches = 0
temporal_attention_direct_backward.long_launches = 0   # past 32 frames
temporal_attention_direct_backward.long_dim_launches = collections.Counter()   # those by head dim (16: the frame walk)


# -- K3: bhld flash attention (forward, LSE under a gradient) ------------------


def flash_attention_reference(q, k, v, scale: Optional[float] = None, save_lse: bool = False,
                              normalise_first: bool = False):
    """Plain version of K3 on bhld [B, H, L, D]; save_lse also returns the
    base-2 LSE fp32 [B, Lq, H] (for one head, JAX's [B*H, Lq] of the heads=1
    forward under a gradient). The denominator sums the rounded p with the
    LSE (_fa_fwd runs the packed kernel with fused_psum), the fp32 p without
    (_flash_kernel); normalise_first as K3's (flash_attention)."""
    flash_attention_reference.calls += 1
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else scale
    if normalise_first:
        if save_lse:
            raise ValueError("flash_attention: the normalise-first route writes no LSE")
        out = _attention_normalised(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), scale)
        return out.transpose(1, 2).to(q.dtype)
    res = _attention_base2(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), scale, with_lse=save_lse,
        psum_rounded=save_lse,
    )
    if save_lse:
        return res[0].transpose(1, 2).to(q.dtype), res[1]
    return res.transpose(1, 2).to(q.dtype)


flash_attention_reference.calls = 0


def _check_bhld(name, q, k, v):
    dtype = _cuda.check_cuda_tensors(name, q, k, v)
    if q.dim() != 4 or k.shape != v.shape or q.shape[:2] != k.shape[:2] or q.shape[3] != k.shape[3]:
        raise ValueError(f"{name}: bad shapes {q.shape} {k.shape} {v.shape}")
    return dtype


def _flash_attention_forward(q, k, v, scale: Optional[float], save_lse: bool, normalise_first: bool = False,
                             streamed: bool = False):
    """K3 on CUDA tensors (the plain version on CPU): out, or (out, lse);
    streamed as K1's (_flash_attention_packed_forward)."""
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, scale, save_lse=save_lse, normalise_first=normalise_first)
    dtype = _check_bhld("flash_attention", q, k, v)
    b, h, lq, d = q.shape
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    out = torch.empty((b, h, lq, d), dtype=dtype, device=q.device)
    lse = torch.empty((b, lq, h), dtype=torch.float32, device=q.device) if save_lse else None
    strides = _cuda.strides_arg(q, k, v, out, dims=(0, 2, 1))
    _check_aligned_rows("flash_attention", dtype, d, strides, 9, q, k, v)
    route = _cuda.call_routed(
        "vs_flash_attention_bhld", _cuda.DTYPE_CODES[dtype], d,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr() if save_lse else None,
        b, h, lq, k.shape[2], strides, _kernel_qscale(scale, dtype, normalise_first),
        _sum_mode(save_lse, normalise_first, streamed),
    )
    resident = route.endswith("_resident")
    route = route.removesuffix("_resident")
    flash_attention.launches += 1
    flash_attention.dim_launches[d] += 1
    flash_attention.resident_launches += resident
    flash_attention.wgmma_launches += route == "wgmma"
    flash_attention.tf32x3_launches += route == "tf32x3"
    flash_attention.fma_launches += route == "fma"
    if normalise_first and dtype == torch.bfloat16:
        flash_attention.normalised_launches += 1
        flash_attention.normalised_dim_launches[d] += 1
    return (out, lse) if save_lse else out


class _FlashAttention(torch.autograd.Function):
    """K3 forward with LSE; K13 backward (the JAX package's _fa custom_vjp:
    _fa_fwd saves the LSE, _fa_bwd runs the packed backward with heads=1)."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        out, lse = _flash_attention_forward(q, k, v, scale, save_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(q, k, v, out, lse, g.contiguous(), ctx.scale)
        return dq, dk, dv, None


def flash_attention(q, k, v, scale: Optional[float] = None, normalise_first: bool = False):
    """K3: flash attention on bhld [B, H, L, D] through strides (D in
    {16, 64, 80, 512}: the VAE's single 512-dim head, CLIP's 80-dim heads and
    the tiny configs' 16), so a strided view (CLIP's [B, L, H, D] projections
    seen as bhld) is read in place. bf16 runs on the tensor cores (wgmma at D
    = 512 and 64, mma.sync at 80 and 16) and needs 16-byte aligned rows; fp32
    runs the tensor cores with split TF32 products at D = 512 (16-byte aligned
    rows too) and at D = 64 where TMA can address q, k and v
    (`.tf32x3_launches`), the FMA kernel at D = 16, 80 and unaligned D = 64
    (`.fma_launches`). normalise_first (bf16 D = 16, 64 and 80) computes
    mha_reference's softmax (no gradient). Differentiable otherwise: with grad
    on, the forward also writes the LSE and the backward is K13 (K5 at D = 16
    and 64)."""
    _refuse_normalised_grad("flash_attention", normalise_first, q, k, v)
    if _needs_grad(q, k, v):
        return _FlashAttention.apply(q, k, v, scale)
    return _flash_attention_forward(q, k, v, scale, save_lse=False, normalise_first=normalise_first)


flash_attention.launches = 0
flash_attention.dim_launches = collections.Counter()
flash_attention.wgmma_launches = 0   # D = 64 and 512 in bf16 (D = 16 and 80 run mma.sync)
flash_attention.tf32x3_launches = 0   # fp32 D = 512 (wgmma) and addressable D = 64 (mma.sync), split TF32
flash_attention.fma_launches = 0   # the other fp32 launches (D = 16, 80, unaligned D = 64), on FMAs
flash_attention.normalised_launches = 0   # bf16 launches in the normalise-first mode
flash_attention.normalised_dim_launches = collections.Counter()   # those by head dim
# of .normalised_launches, those on the kernels that hold a head's K and V in shared memory (D = 64 up
# to 128 keys, on K1's kernel; D = 80 up to 512)
flash_attention.resident_launches = 0


# -- K13: bhld flash-attention backward ----------------------------------------


def flash_attention_backward_reference(q, k, v, out, lse, g, scale: Optional[float] = None):
    """Plain version of K13: the packed backward's math with heads=1 on
    [B*H, L, D] (what the JAX package's _fa_bwd runs); lse fp32 [B, Lq, H].
    Returns (dq, dk, dv) bhld."""
    flash_attention_backward_reference.calls += 1
    b, h, lq, d = q.shape
    lk = k.shape[2]
    flat = lambda t, l: t.reshape(b * h, l, d)
    lse1 = lse.permute(0, 2, 1).reshape(b * h, lq, 1)
    dq, dk, dv = _packed_backward_math(flat(q, lq), flat(k, lk), flat(v, lk), flat(out, lq), lse1,
                                       flat(g, lq), 1, scale)
    return dq.reshape(b, h, lq, d), dk.reshape(b, h, lk, d), dv.reshape(b, h, lk, d)


flash_attention_backward_reference.calls = 0


def flash_attention_backward(q, k, v, out, lse, g, scale: Optional[float] = None):
    """K13: (dq, dk, dv) of K3 from its saved LSE, bhld [B, H, L, D] read and
    written through strides; two kernels, dq over key tiles and dk/dv over
    query tiles, each the only writer of its outputs (fp32 at D = 512: dq, dk
    and dv apart, on split TF32 products, `.tf32x3_launches`). D = 512 and 80; D = 16
    and 64 run K5 on the same strides (the JAX package routes every head dim
    through the one packed backward), counted on K5's wrapper. The plain
    version on CPU."""
    if q.device.type == "cpu":
        return flash_attention_backward_reference(q, k, v, out, lse, g, scale)
    dtype = _check_bhld("flash_attention_backward", q, k, v)
    _cuda.check_cuda_tensors("flash_attention_backward", q, out, g)
    b, h, lq, d = q.shape
    lk = k.shape[2]
    _check_head_dim("flash_attention_backward", "bhld", q.shape, d, backward=True)
    if out.shape != q.shape or g.shape != q.shape or lse.shape != (b, lq, h):
        raise ValueError(f"flash_attention_backward: bad shapes out {out.shape}, g {g.shape}, "
                         f"lse {lse.shape} for q {q.shape}")
    if lse.dtype != torch.float32 or not lse.is_contiguous() or lse.device != q.device:
        raise ValueError("flash_attention_backward: lse must be contiguous fp32 on q's device")
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    dq, dk, dv = (torch.empty_like(t, memory_format=torch.contiguous_format) for t in (q, k, v))
    strides = _cuda.strides_arg(q, k, v, out, g, dq, dk, dv, dims=(0, 2, 1))
    _check_aligned_rows("flash_attention_backward", dtype, d, strides, 15, q, k, v, out, g)
    k5 = d in (16, 64)
    route = _cuda.call_routed(
        "vs_flash_attention_packed_bwd" if k5 else "vs_flash_attention_bhld_bwd",
        _cuda.DTYPE_CODES[dtype], d,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), g.data_ptr(),
        lse.data_ptr(), _bwd_scratch(b, h, lq, q.device).data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        b, h, lq, lk, strides, float(_rounded_qscale(scale, dtype)), float(scale),
    )
    _count_routes(flash_attention_packed_backward if k5 else flash_attention_backward, d, route)
    return dq, dk, dv


flash_attention_backward.launches = 0
flash_attention_backward.dim_launches = collections.Counter()
flash_attention_backward.wgmma_launches = 0   # bf16 D = 512, on the wgmma kernels
flash_attention_backward.tf32x3_launches = 0   # fp32 D = 512, on split TF32 products (wgmma)


# -- dispatcher -------------------------------------------------------------


def dot_product_attention(q, k, v, scale: Optional[float] = None, layout: str = "bhld"):
    """Attention dispatcher (the JAX package's dot_product_attention).

    - One key (every SVD cross-attention site, spatial and temporal: the
      context is one pooled CLIP token): softmax over one key is 1, so the
      result is V broadcast over the queries; no kernel runs.
    - CPU tensors: plain attention with an fp32 softmax (what the JAX
      package runs on its CPU backend).
    - CUDA tensors: what site_route names, as JAX's TPU dispatch runs it: K1
      for blhd (small_batched_attention), K3 for bhld; at an "mha_reference"
      site K3 in its normalise-first mode (CLIP's 257 tokens), or
      mha_reference_site under a gradient and where no normalise-first kernel
      takes the dtype and D (a bf16 VAE attention under 512 tokens)."""
    l_axis = 1 if layout == "blhd" else 2
    lq, lk = q.shape[l_axis], k.shape[l_axis]
    route = site_route(layout, q.shape[0], lq, lk)
    if route == "one_key":
        shape = list(v.shape)
        shape[l_axis] = lq
        return v.expand(shape).to(q.dtype)
    if q.device.type == "cpu":
        return mha_reference(q, k, v, scale=scale, layout=layout)
    if layout == "blhd":
        return small_batched_attention(q, k, v, scale=scale)
    if route == "mha_reference" and _runs_mha_reference("bhld", q, k, v):
        return mha_reference_site(q, k, v, scale=scale, layout="bhld")
    _check_head_dim(f"'{route}' attention site", "bhld", q.shape, q.shape[-1], backward=_needs_grad(q, k, v))
    return flash_attention(q, k, v, scale=scale, normalise_first=route == "mha_reference")


PLAIN_COUNTERS = (
    mha_reference,
    flash_attention_packed_reference,
    temporal_attention_direct_reference,
    flash_attention_reference,
    flash_attention_packed_backward_reference,
    temporal_attention_direct_backward_reference,
    flash_attention_backward_reference,
)
KERNEL_COUNTERS = (
    flash_attention_packed,
    temporal_attention_direct,
    flash_attention,
    flash_attention_packed_backward,
    temporal_attention_direct_backward,
    flash_attention_backward,
)
