"""The (kt, 1, 1) temporal convolution: plain version and the K4 wrapper.

Counterpart of vidseg_diffusion_tpu/ops/temporal_conv.py:

    y[b, t] = sum_j x[b, t + j - kt//2] @ W[j] + bias    (zero frames off range)

on x [B, T, M, Cin], W [kt, Cin, Cout], bias [Cout]. The JAX package runs
its Pallas kernel only for 64 <= C <= 640 on the TPU (temporal_conv.py:179-196);
those thresholds are TPU facts, so here every CUDA call launches K4 and
every CPU call takes the plain version.

Gradients (the JAX package's _tc custom_vjp, temporal_conv.py:143-158, takes
the XLA VJP of the shifted-matmul reference): dx is the same (kt, 1, 1)
convolution applied to the output gradient with the taps reversed and each
tap's W transposed,

    dx[b, s] = sum_j g[b, s + j - kt//2] @ W[kt-1-j]^T,

so on CUDA dx is K4 itself; dW and db are matrix products and sums outside
any kernel, as in JAX.
"""

from __future__ import annotations

import torch

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


def _temporal_conv_forward(x, w, bias):
    if x.device.type == "cpu":
        return temporal_conv_1x1_reference(x, w, bias)
    dtype = _cuda.check_cuda_tensors("temporal_conv_1x1", x, w, bias)
    if x.dim() != 4 or w.dim() != 3 or w.shape[1] != x.shape[3] or bias.shape != (w.shape[2],):
        raise ValueError(f"temporal_conv_1x1: bad shapes {x.shape} {w.shape} {bias.shape}")
    if w.shape[0] % 2 == 0:
        raise ValueError(f"temporal_conv_1x1: even tap count {w.shape[0]}")
    if not (x.is_contiguous() and w.is_contiguous() and bias.is_contiguous()):
        raise ValueError("temporal_conv_1x1: inputs must be contiguous")
    b, t, m, cin = x.shape
    kt, _, cout = w.shape
    y = torch.empty((b, t, m, cout), dtype=dtype, device=x.device)
    _cuda.call(
        "vs_temporal_conv_1x1", _cuda.DTYPE_CODES[dtype],
        x.data_ptr(), w.data_ptr(), bias.data_ptr(), y.data_ptr(),
        b, t, m, cin, cout, kt,
    )
    temporal_conv_1x1.launches += 1
    return y


def _reversed_transposed(w):
    """W'[j] = W[kt-1-j]^T: [kt, Cin, Cout] -> [kt, Cout, Cin]."""
    return w.flip(0).transpose(1, 2).contiguous()


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
    """Plain backward: (dx, dW, db), dx by the plain forward on g with the
    reversed, transposed taps."""
    temporal_conv_1x1_backward_reference.calls += 1
    zero = torch.zeros(w.shape[1], dtype=x.dtype, device=x.device)
    dx = temporal_conv_1x1_reference(g, _reversed_transposed(w), zero)
    return (dx,) + _weight_and_bias_grads(x, g, w.shape[0])


temporal_conv_1x1_backward_reference.calls = 0


def temporal_conv_1x1_backward(x, w, g):
    """(dx, dW, db) of temporal_conv_1x1: dx by a K4 launch on g with the
    reversed, transposed taps (zero bias); the plain version on CPU."""
    if x.device.type == "cpu":
        return temporal_conv_1x1_backward_reference(x, w, g)
    zero = torch.zeros(w.shape[1], dtype=x.dtype, device=x.device)
    dx = _temporal_conv_forward(g, _reversed_transposed(w), zero)
    return (dx,) + _weight_and_bias_grads(x, g, w.shape[0])


class _TemporalConv1x1(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, bias):
        ctx.save_for_backward(x, w)
        return _temporal_conv_forward(x, w, bias)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        return temporal_conv_1x1_backward(x, w, g.contiguous())


def temporal_conv_1x1(x, w, bias):
    """K4 on CUDA tensors (contiguous x [B, T, M, Cin], w [kt, Cin, Cout],
    bias [Cout], odd kt, any T including 1); the plain version on CPU.
    Differentiable: with grad on, dx is a second K4 launch."""
    if torch.is_grad_enabled() and any(a.requires_grad for a in (x, w, bias)):
        return _TemporalConv1x1.apply(x, w, bias)
    return _temporal_conv_forward(x, w, bias)


temporal_conv_1x1.launches = 0
