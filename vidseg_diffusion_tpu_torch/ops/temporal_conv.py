"""The (kt, 1, 1) temporal convolution: plain version and the K4 wrapper.

Counterpart of vidseg_diffusion_tpu/ops/temporal_conv.py:

    y[b, t] = sum_j x[b, t + j - kt//2] @ W[j] + bias    (zero frames off range)

on x [B, T, M, Cin], W [kt, Cin, Cout], bias [Cout]. The JAX package runs
its Pallas kernel only for 64 <= C <= 640 on the TPU (temporal_conv.py:179-196);
those thresholds are TPU facts, so here every CUDA call launches K4 and
every CPU call takes the plain version.
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


def temporal_conv_1x1(x, w, bias):
    """K4 on CUDA tensors (contiguous x [B, T, M, Cin], w [kt, Cin, Cout],
    bias [Cout], odd kt, any T including 1); the plain version on CPU."""
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


temporal_conv_1x1.launches = 0
