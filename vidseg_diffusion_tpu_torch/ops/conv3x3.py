"""3x3 SAME convolution on channels-last activations: plain version and the
K12 wrapper.

Counterpart of vidseg_diffusion_tpu/ops/conv3x3.py:

    y[b, h, w] = sum over dy, dx of x[b, h+dy-1, w+dx-1] @ W[dy, dx] + bias

(zeros outside the image, stride 1, fp32 accumulation, one cast at the store)
on x [B, H, W, Cin]. The weight arrives as nn.Conv2d stores it, [Cout, Cin, 3,
3] (the state-dict layout; the JAX package's HWIO kernel is its transpose), and
the bias is [Cout] or None.

The JAX package keeps its Pallas kernel switched off (conv3x3.py:177-189): on
the TPU XLA fuses the GroupNorm statistics into its own convolutions. Eager
PyTorch fuses nothing there, so here every CUDA call launches K12 and every
CPU call takes the plain version.

K12 reads per-tap [Cout, Cin] slabs whose rows are contiguous channels, so the
wrapper re-lays the weight once as [9, Cout, Cin] in x's dtype and keeps the
copy for as long as the weight tensor lives and is not written to (its version
counter and storage pointer; ops/relayout.py): a frozen model pays one copy per
parameter, a training step one per optimizer update. The weight itself may be kept in
another floating dtype than x (fp32 parameters under bf16 activations, the JAX
modules' `dtype=` cast): the cast is part of the cached copy, so it is not paid
per call either. `relays` counts the copies made.

Gradients (the JAX package's _c3 custom_vjp, conv3x3.py:157-160, takes the VJP
of XLA's reference convolution, outside any kernel): torch.nn.grad's
conv2d_input and conv2d_weight on the channels-last views, db = sum g.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from vidseg_diffusion_tpu_torch.ops import _cuda
from vidseg_diffusion_tpu_torch.ops.relayout import RelayoutCache


def conv3x3_plain(x, weight, bias=None):
    """Plain version: nine shifted matmuls with fp32 accumulation over the
    zero-padded input, bias added in fp32, one cast to x's dtype (the
    kernel's arithmetic; no library convolution)."""
    conv3x3_plain.calls += 1
    b, h, w, _ = x.shape
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1))
    wf = weight.float()
    out = torch.zeros((b, h, w, weight.shape[0]), dtype=torch.float32, device=x.device)
    for dy in range(3):
        for dx in range(3):
            out += xp[:, dy:dy + h, dx:dx + w] @ wf[:, :, dy, dx].t()
    if bias is not None:
        out = out + bias.float()
    return out.to(x.dtype)


conv3x3_plain.calls = 0

_RELAID = RelayoutCache()   # the [9, Cout, Cin] copies


def _relayout_tap_major(weight, dtype):
    with record_function("vs:Conv3x3"):
        return weight.to(dtype).permute(2, 3, 0, 1).reshape(9, weight.shape[0], weight.shape[1]).contiguous()


def tap_major(weight: torch.Tensor, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """[Cout, Cin, 3, 3] -> contiguous [9, Cout, Cin] in `dtype` (the weight's
    own when None) with tap = 3*dy + dx, cached per weight tensor and version
    (ops/relayout.py)."""
    relaid, made = _RELAID.get(weight, dtype or weight.dtype, _relayout_tap_major)
    conv3x3_same.relays += made
    return relaid


def _conv3x3_forward(x, weight, bias):
    if x.device.type == "cpu":
        return conv3x3_plain(x, weight.to(x.dtype), bias)
    dtype = _cuda.check_cuda_tensors("conv3x3_same", *((x,) if bias is None else (x, bias)))
    if weight.device != x.device or not weight.is_floating_point():
        raise ValueError(f"conv3x3_same: weight {weight.dtype} on {weight.device} for x on {x.device}")
    if x.dim() != 4 or weight.dim() != 4 or tuple(weight.shape[1:]) != (x.shape[3], 3, 3):
        raise ValueError(f"conv3x3_same: bad shapes x {tuple(x.shape)}, weight {tuple(weight.shape)}")
    cout = weight.shape[0]
    if bias is not None and bias.shape != (cout,):
        raise ValueError(f"conv3x3_same: bias {tuple(bias.shape)} for {cout} outputs")
    if not x.is_contiguous() or (bias is not None and not bias.is_contiguous()):
        raise ValueError("conv3x3_same: x and bias must be contiguous")
    b, h, w, cin = x.shape
    w9 = tap_major(weight, dtype)
    y = torch.empty((b, h, w, cout), dtype=dtype, device=x.device)
    if y.numel():
        _cuda.call(
            "vs_conv3x3_same", _cuda.DTYPE_CODES[dtype], x.data_ptr(), w9.data_ptr(),
            None if bias is None else bias.data_ptr(), y.data_ptr(), b, h, w, cin, cout,
        )
        conv3x3_same.launches += 1
    return y


def conv3x3_backward(x, weight, g, need_bias: bool):
    """(dx, dW, db or None) of conv3x3_same through torch.nn.grad on the
    channels-last views (no copy), outside any kernel as in the JAX package.
    Computed in x's dtype; dW and db come back in the weight's."""
    xn, gn = x.permute(0, 3, 1, 2), g.permute(0, 3, 1, 2)
    dx = torch.nn.grad.conv2d_input(xn.shape, weight.to(x.dtype), gn, padding=1).permute(0, 2, 3, 1)
    dw = torch.nn.grad.conv2d_weight(xn, weight.shape, gn, padding=1).to(weight.dtype)
    db = g.float().sum(dim=(0, 1, 2)).to(weight.dtype) if need_bias else None
    return dx, dw, db


class _Conv3x3(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias):
        ctx.save_for_backward(x, weight)
        ctx.need_bias = bias is not None
        return _conv3x3_forward(x, weight, bias)

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        return conv3x3_backward(x, weight, g, ctx.need_bias)


def conv3x3_same(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor] = None):
    """K12 on CUDA tensors (contiguous x [B, H, W, Cin], weight [Cout, Cin, 3,
    3] in any floating dtype, bias [Cout] in x's or None -> [B, H, W, Cout]);
    the plain version on CPU.
    Differentiable: with grad on the backward is torch.nn.grad's; under
    no_grad nothing is saved."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in (x, weight, bias)):
        return _Conv3x3.apply(x, weight, bias)
    return _conv3x3_forward(x, weight, bias)


conv3x3_same.launches = 0
conv3x3_same.relays = 0
