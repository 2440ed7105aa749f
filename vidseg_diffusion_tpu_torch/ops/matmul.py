"""matmul + bias: plain version and the K11 wrapper.

Counterpart of vidseg_diffusion_tpu/ops/matmul.py:

    y = x @ W^T + bias        (fp32 accumulation, one cast at the store)

on x [..., K] (contiguous, viewed [M, K]), W [N, K] and bias [N] or None. W is
nn.Linear's weight as it is stored: the JAX package's [K, N] kernel is its
transpose, and the card's tensor cores read [N, K] in place. The q/k/v
projections of CrossAttention have no bias (the JAX package hands its kernel
zeros there, models/layers.py:356).

The JAX package routes a projection to its Pallas kernel only for m >= 4096
on the TPU and keeps the route switched off by default (matmul.py:156-171):
both are TPU findings about XLA's epilogue fusions. Eager PyTorch fuses no
epilogue, so here every CUDA call launches K11 and every CPU call takes the
plain version.

Gradients (the JAX package's _mb custom_vjp, matmul.py:125-132, is closed-form
matrix products outside any kernel): dx = g @ W, dW = g^T @ x, db = sum g, with
fp32 accumulation. On the card they are matrix products in the input dtype
(the library accumulates those in fp32 and rounds once, the same arithmetic);
on the CPU the operands are widened to fp32 first.
"""

from __future__ import annotations

from typing import Optional

import torch

from vidseg_diffusion_tpu_torch.ops import _cuda


def matmul_bias_plain(x, weight, bias=None):
    """Plain version: fp32-accumulating x @ W^T, bias added in fp32, one cast
    to x's dtype (the kernel's arithmetic)."""
    matmul_bias_plain.calls += 1
    y = x.float() @ weight.float().t()
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


matmul_bias_plain.calls = 0


def _matmul_bias_forward(x, weight, bias):
    if x.device.type == "cpu":
        return matmul_bias_plain(x, weight, bias)
    tensors = (x, weight) if bias is None else (x, weight, bias)
    dtype = _cuda.check_cuda_tensors("matmul_bias", *tensors)
    if x.dim() < 2 or weight.dim() != 2 or weight.shape[1] != x.shape[-1]:
        raise ValueError(f"matmul_bias: bad shapes x {tuple(x.shape)}, weight {tuple(weight.shape)}")
    n, k = weight.shape
    if bias is not None and bias.shape != (n,):
        raise ValueError(f"matmul_bias: bias {tuple(bias.shape)} for {n} outputs")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("matmul_bias: inputs must be contiguous")
    m = x.numel() // k
    y = torch.empty(x.shape[:-1] + (n,), dtype=dtype, device=x.device)
    if m:
        _cuda.call(
            "vs_matmul_bias", _cuda.DTYPE_CODES[dtype], x.data_ptr(), weight.data_ptr(),
            None if bias is None else bias.data_ptr(), y.data_ptr(), m, k, n,
        )
        matmul_bias.launches += 1
    return y


def matmul_bias_backward(x, weight, g, need_bias: bool):
    """(dx, dW, db or None) of matmul_bias: matrix products with fp32
    accumulation outside any kernel, as in the JAX package."""
    acc = torch.float32 if x.device.type == "cpu" else x.dtype
    k, n = x.shape[-1], weight.shape[0]
    g2, x2 = g.reshape(-1, n).to(acc), x.reshape(-1, k).to(acc)
    dx = (g2 @ weight.to(acc)).to(x.dtype).reshape(x.shape)
    dw = (g2.t() @ x2).to(weight.dtype)
    db = g2.float().sum(dim=0).to(weight.dtype) if need_bias else None
    return dx, dw, db


class _MatmulBias(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias):
        ctx.save_for_backward(x, weight)
        ctx.need_bias = bias is not None
        return _matmul_bias_forward(x, weight, bias)

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        return matmul_bias_backward(x, weight, g, ctx.need_bias)


def matmul_bias(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor] = None):
    """K11 on CUDA tensors (contiguous x [..., K], weight [N, K], bias [N] or
    None -> [..., N]); the plain version on CPU. Differentiable: with grad on
    the backward is three matrix products; under no_grad nothing is saved."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in (x, weight, bias)):
        return _MatmulBias.apply(x, weight, bias)
    return _matmul_bias_forward(x, weight, bias)


matmul_bias.launches = 0
