"""The (kt, 1, 1) temporal convolution: plain version and the K4 wrapper.

Counterpart of vidseg_diffusion_tpu/ops/temporal_conv.py:

    y[b, t] = sum_j x[b, t + j - kt//2] @ W[j] + bias    (zero frames off range)

on x [B, T, M, Cin], W [kt, Cin, Cout], bias [Cout]. The JAX package runs
its Pallas kernel only for 64 <= C <= 640 on the TPU (temporal_conv.py:179-196);
those thresholds are TPU facts, so here every CUDA call launches K4 and
every CPU call takes the plain version.

K4 reads W K-major, [kt, Cout, Cin] (each output channel's Cin weights
contiguous, as the tensor cores take them). `temporal_conv_1x1` takes W in
JAX's [kt, Cin, Cout] or as nn.Conv3d stores it, [Cout, Cin, kt, 1, 1] (the
TemporalConv module's parameter), and hands the kernel a K-major copy in x's
dtype that is kept for as long as the weight tensor lives and is not written
to (`k_major`; `temporal_conv_1x1.relays` counts the copies): a frozen model
pays one per parameter, a training step one per optimizer update. The kernel
entry reports which kernel ran: bf16 with Cin and Cout multiples of 8 and
16-byte aligned bases (every UNet and VAE time_stack) the persistent wgmma
kernel (`.wgmma_launches`), other bf16 (the VAE's 3-channel
conv_out_time_mix) a CUDA-core kernel sized to the row (`.narrow_launches`),
fp32 the FMA tile.

Gradients (the JAX package's _tc custom_vjp, temporal_conv.py:143-158, takes
the XLA VJP of the shifted-matmul reference): dx is the same (kt, 1, 1)
convolution applied to the output gradient with the taps reversed and each
tap's W transposed,

    dx[b, s] = sum_j g[b, s + j - kt//2] @ W[kt-1-j]^T,

so on CUDA dx is K4 itself, whose K-major weight for it is JAX's [kt, Cin,
Cout] flipped along the taps; dW and db are matrix products and sums outside
any kernel, as in JAX.
"""

from __future__ import annotations

import weakref
from typing import Optional

import torch
from torch.profiler import record_function

from vidseg_diffusion_tpu_torch.ops import _cuda


def temporal_conv_1x1_reference(x, w, bias):
    """Plain version: per-tap shifted matmuls with fp32 accumulation, bias
    added in fp32, one cast to the input dtype (the kernel's arithmetic)."""
    temporal_conv_1x1_reference.calls += 1
    b, t, m, _ = x.shape
    kt = w.shape[0]
    pad = kt // 2
    xf, wf = x.float(), w.float()
    out = torch.zeros((b, t, m, w.shape[2]), dtype=torch.float32, device=x.device)
    for j in range(kt):
        lo, hi = max(0, pad - j), min(t, t + pad - j)  # output frames with a source
        if lo < hi:
            out[:, lo:hi] += xf[:, lo + j - pad:hi + j - pad] @ wf[j]
    return (out + bias.float()).to(x.dtype)


temporal_conv_1x1_reference.calls = 0


def _jax_layout(w):
    """JAX's [kt, Cin, Cout] view of a weight given in it or as nn.Conv3d's
    [Cout, Cin, kt, 1, 1]."""
    return w if w.dim() == 3 else w[:, :, :, 0, 0].permute(2, 1, 0)


_RELAID = {}  # id(weight) -> (weakref to the weight, (version, storage pointer, dtype), the [kt, Cout, Cin] copy)


def k_major(weight: torch.Tensor, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """[kt, Cin, Cout] or [Cout, Cin, kt, 1, 1] -> contiguous [kt, Cout, Cin] in
    `dtype` (the weight's own when None), cached per weight tensor and version."""
    dtype = dtype or weight.dtype
    key, state = id(weight), (weight._version, weight.data_ptr(), dtype)
    hit = _RELAID.get(key)
    if hit is not None and hit[0]() is weight and hit[1] == state:
        return hit[2]
    with record_function("vs:TemporalConv"), torch.no_grad():
        relaid = _jax_layout(weight.detach()).transpose(1, 2).to(dtype).contiguous()
    if hit is None or hit[0]() is not weight:
        weakref.finalize(weight, _RELAID.pop, key, None)
    _RELAID[key] = (weakref.ref(weight), state, relaid)
    temporal_conv_1x1.relays += 1
    return relaid


def _launch(x, wk, bias):
    """K4 on a contiguous CUDA x [B, T, M, Cin] with the K-major weight wk
    [kt, Cout, Cin] (x's dtype) and bias [Cout] or None."""
    b, t, m, cin = x.shape
    kt, cout, _ = wk.shape
    y = torch.empty((b, t, m, cout), dtype=x.dtype, device=x.device)
    route = _cuda.call_routed(
        "vs_temporal_conv_1x1", _cuda.DTYPE_CODES[x.dtype], x.data_ptr(), wk.data_ptr(),
        None if bias is None else bias.data_ptr(), y.data_ptr(), b, t, m, cin, cout, kt,
    )
    temporal_conv_1x1.launches += 1
    temporal_conv_1x1.wgmma_launches += route == "wgmma"
    temporal_conv_1x1.narrow_launches += route == "narrow"
    return y


def _temporal_conv_forward(x, w, bias):
    if x.device.type == "cpu":
        return temporal_conv_1x1_reference(x, _jax_layout(w).to(x.dtype), bias.to(x.dtype))
    dtype = _cuda.check_cuda_tensors("temporal_conv_1x1", x)
    for p in (w, bias):
        if p.device != x.device or not p.is_floating_point():
            raise ValueError(f"temporal_conv_1x1: parameter {p.dtype} on {p.device} for x on {x.device}")
    if w.dim() not in (3, 5) or (w.dim() == 5 and tuple(w.shape[3:]) != (1, 1)):
        raise ValueError(f"temporal_conv_1x1: weight {tuple(w.shape)} is neither [kt, Cin, Cout] "
                         "nor [Cout, Cin, kt, 1, 1]")
    wj = _jax_layout(w)
    if x.dim() != 4 or wj.shape[1] != x.shape[3] or bias.shape != (wj.shape[2],):
        raise ValueError(f"temporal_conv_1x1: bad shapes {x.shape} {w.shape} {bias.shape}")
    if wj.shape[0] % 2 == 0:
        raise ValueError(f"temporal_conv_1x1: even tap count {wj.shape[0]}")
    if not (x.is_contiguous() and bias.is_contiguous()):
        raise ValueError("temporal_conv_1x1: x and bias must be contiguous")
    return _launch(x, k_major(w, dtype), bias.to(dtype))


def _weight_and_bias_grads(x, g, kt):
    """dW[j] = sum over rows of x[t + j - kt//2]^T g[t] (frames in range),
    db = sum of g; in the input dtype, as JAX's VJP of the reference."""
    t = x.shape[1]
    pad = kt // 2
    cin, cout = x.shape[3], g.shape[3]
    dw = torch.zeros((kt, cin, cout), dtype=x.dtype, device=x.device)
    for j in range(kt):
        lo, hi = max(0, pad - j), min(t, t + pad - j)
        if lo < hi:
            dw[j] = x[:, lo + j - pad:hi + j - pad].reshape(-1, cin).T @ g[:, lo:hi].reshape(-1, cout)
    return dw, g.float().sum(dim=(0, 1, 2)).to(x.dtype)


def temporal_conv_1x1_backward_reference(x, w, g):
    """Plain backward: (dx, dW, db) for w [kt, Cin, Cout], dx by the plain
    forward on g with the reversed, transposed taps."""
    temporal_conv_1x1_backward_reference.calls += 1
    zero = torch.zeros(w.shape[1], dtype=x.dtype, device=x.device)
    dx = temporal_conv_1x1_reference(g, w.flip(0).transpose(1, 2), zero)
    return (dx,) + _weight_and_bias_grads(x, g, w.shape[0])


temporal_conv_1x1_backward_reference.calls = 0


def temporal_conv_1x1_backward(x, w, g):
    """(dx, dW, db) of temporal_conv_1x1 for w [kt, Cin, Cout]: dx by a K4
    launch on g (no bias) whose K-major weight is w flipped along the taps;
    the plain version on CPU."""
    if x.device.type == "cpu":
        return temporal_conv_1x1_backward_reference(x, w, g)
    _cuda.check_cuda_tensors("temporal_conv_1x1", x, g)
    dx = _launch(g, w.flip(0).to(x.dtype).contiguous(), None)
    return (dx,) + _weight_and_bias_grads(x, g, w.shape[0])


class _TemporalConv1x1(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, bias):
        ctx.save_for_backward(x, w)
        ctx.bias_dtype = bias.dtype
        return _temporal_conv_forward(x, w, bias)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx, dw, db = temporal_conv_1x1_backward(x, _jax_layout(w).to(x.dtype), g.contiguous())
        if w.dim() == 5:
            dw = dw.permute(2, 1, 0)[..., None, None]
        return dx, dw.to(w.dtype), db.to(ctx.bias_dtype)


def temporal_conv_1x1(x, w, bias):
    """K4 on CUDA tensors (contiguous x [B, T, M, Cin], w [kt, Cin, Cout] or
    nn.Conv3d's [Cout, Cin, kt, 1, 1] in any floating dtype, bias [Cout], odd
    kt, any T including 1); the plain version on CPU. Differentiable: with
    grad on, dx is a second K4 launch."""
    if torch.is_grad_enabled() and any(a.requires_grad for a in (x, w, bias)):
        return _TemporalConv1x1.apply(x, w, bias)
    return _temporal_conv_forward(x, w, bias)


temporal_conv_1x1.launches = 0
temporal_conv_1x1.wgmma_launches = 0
temporal_conv_1x1.narrow_launches = 0
temporal_conv_1x1.relays = 0
