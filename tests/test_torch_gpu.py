"""The CUDA kernels (K1-K6) against their plain versions, on the card.

Every test here needs a CUDA card and skips without one. The file imports
no JAX, so on a machine with a card and no JAX it runs without the suite's
conftest:

    python -m pytest tests/test_torch_gpu.py --noconftest -q

Inputs come from a seeded generator on the card; kernel and plain version
see the same tensors. Forward tolerance: max |kernel - plain| <= TOL *
max(1, max |plain|), with TOL 1e-2 in bf16 (a bf16 rounding step or two of
the output: the kernels accumulate in fp32 in another order) and 1e-4 in
fp32. The backward kernels (K5, K6, and K4 launched for dx) are held to
their plain backward versions on each of dq/dk/dv (dx/dW/db) with chip_smoke.py's
bounds and no floor of 1: in bf16, max |kernel - plain| <= 2 bf16 steps at
max |plain| and ||kernel - plain|| <= RMS_TOL * ||plain|| (per kernel, as
chip_smoke.py); in fp32 both relative to 1e-4. A gradient that is 0 up to
rounding (K6's dq and dk at t = 1) is measured against GRAD_FLOOR times the
largest gradient of the same call. K1's saved LSE: within LSE_TOL (log2
units) of the plain LSE.
"""

import math

import pytest
import torch

from vidseg_diffusion_tpu_torch.ops import attention as A
from vidseg_diffusion_tpu_torch.ops import temporal_conv as TC

TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-4}
DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32}
RMS_TOL = {"K4": 5e-4, "K5": 1e-3, "K6": 2e-4}  # bf16 backward; fp32 is FP32_TOL
MAX_STEPS = 2
FP32_TOL = 1e-4
GRAD_FLOOR = 1e-2  # fp32 rounding noise of K6's t = 1 dq reads 5.8e-7 at a largest gradient of 3.5
LSE_TOL = 5e-3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False  # fp32 plain versions in full fp32
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = saved


def _randn(cuda, seed, dtype, *shape, scale=1.0):
    g = torch.Generator(device=cuda).manual_seed(seed)
    return (torch.randn(*shape, generator=g, device=cuda) * scale).to(dtype)


def _close(out, ref):
    assert out.shape == ref.shape and out.dtype == ref.dtype
    assert bool(torch.isfinite(out).all())
    err = (out.float() - ref.float()).abs().max().item()
    scale = max(1.0, ref.float().abs().max().item())
    assert err <= TOL[out.dtype] * scale, (err, scale)


def _close_grads(outs, refs, rms_tol):
    """The backward bounds of the module docstring, on each gradient."""
    floor_peak = GRAD_FLOOR * max(r.float().abs().max().item() for r in refs)
    floor_norm = GRAD_FLOOR * max(r.float().norm().item() for r in refs)
    for o, r in zip(outs, refs):
        assert o.shape == r.shape and o.dtype == r.dtype
        assert bool(torch.isfinite(o).all())
        diff = o.float() - r.float()
        peak = max(r.float().abs().max().item(), floor_peak)
        if o.dtype == torch.bfloat16:
            bound, rms_bound = MAX_STEPS * 2.0 ** (math.floor(math.log2(peak)) - 7), rms_tol
        else:
            bound, rms_bound = FP32_TOL * peak, FP32_TOL
        err = diff.abs().max().item()
        rms = diff.norm().item() / max(r.float().norm().item(), floor_norm)
        assert err <= bound and rms <= rms_bound, (err, bound, rms, rms_bound)


def _check(fn, plain, *args, rms_tol=None, **kwargs):
    """Run the kernel wrapper once (its launch counter moves, the plain
    version's call counter does not), then the plain version, and compare:
    a forward with _close, a backward (rms_tol given) with _close_grads."""
    launches, calls = fn.launches, plain.calls
    out = fn(*args, **kwargs)
    torch.cuda.synchronize()
    assert fn.launches == launches + 1 and plain.calls == calls
    ref = plain(*args, **kwargs)
    outs, refs = (out, ref) if isinstance(out, tuple) else ((out,), (ref,))
    if rms_tol is not None:
        _close_grads(outs, refs, rms_tol)
        return
    for o, r in zip(outs, refs):
        _close(o, r)


@pytest.mark.gpu
@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("b,lq,lk,h", [(2, 300, 300, 2), (28, 91, 91, 4), (6, 14, 14, 3), (2, 100, 37, 2)])
def test_flash_attention_packed(cuda, dt, b, lq, lk, h):
    dtype = DTYPES[dt]
    q = _randn(cuda, 1, dtype, b, lq, h * 64)
    k, v = (_randn(cuda, s, dtype, b, lk, h * 64) for s in (2, 3))
    _check(A.flash_attention_packed, A.flash_attention_packed_reference, q, k, v, heads=h)


@pytest.mark.gpu
def test_flash_attention_packed_refuses_unaligned_bf16(cuda):
    x = _randn(cuda, 4, torch.bfloat16, 1, 64 * 16 * 2 + 1)[:, 1:].reshape(1, 32, 64)
    with pytest.raises(ValueError, match="aligned"):
        A.flash_attention_packed(x, x, x, heads=1)


@pytest.mark.gpu
@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("b,t,s,h", [(2, 14, 20, 2), (2, 1, 16, 1), (1, 32, 9, 2), (3, 5, 91, 3)])
def test_temporal_attention_direct(cuda, dt, b, t, s, h):
    dtype = DTYPES[dt]
    q, k, v = (_randn(cuda, i, dtype, b * t, s, h, 64) for i in (5, 6, 7))
    _check(A.temporal_attention_direct, A.temporal_attention_direct_reference, q, k, v, t=t)


@pytest.mark.gpu
@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("b,h,l,d", [(2, 1, 100, 512), (1, 16, 257, 80), (2, 3, 70, 64)])
def test_flash_attention_bhld(cuda, dt, b, h, l, d):
    dtype = DTYPES[dt]
    q, k, v = (_randn(cuda, i, dtype, b, h, l, d) for i in (8, 9, 10))
    _check(A.flash_attention, A.flash_attention_reference, q, k, v)


@pytest.mark.gpu
@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("b,t,m,cin,cout", [(2, 5, 33, 40, 24), (1, 7, 50, 3, 3), (1, 1, 40, 64, 64),
                                            (2, 14, 20, 136, 200)])
def test_temporal_conv_1x1(cuda, dt, b, t, m, cin, cout):
    dtype = DTYPES[dt]
    x = _randn(cuda, 11, dtype, b, t, m, cin)
    w = _randn(cuda, 12, dtype, 3, cin, cout, scale=(3 * cin) ** -0.5)
    bias = _randn(cuda, 13, dtype, cout)
    _check(TC.temporal_conv_1x1, TC.temporal_conv_1x1_reference, x, w, bias)


@pytest.mark.gpu
@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("b,lq,lk,h", [(2, 300, 300, 2), (28, 91, 91, 4), (2, 100, 37, 2), (1, 64, 200, 1)])
def test_flash_attention_packed_backward(cuda, dt, b, lq, lk, h):
    """K5 against its plain version on the LSE that K1 saved; K1's LSE
    against the plain LSE."""
    dtype = DTYPES[dt]
    q = _randn(cuda, 21, dtype, b, lq, h * 64)
    k, v = (_randn(cuda, s, dtype, b, lk, h * 64) for s in (22, 23))
    g = _randn(cuda, 24, dtype, b, lq, h * 64)
    out, lse = A._flash_attention_packed_forward(q, k, v, h, None, save_lse=True)
    _, lse_ref = A.flash_attention_packed_reference(q, k, v, h, save_lse=True)
    assert (lse - lse_ref).abs().max().item() <= LSE_TOL
    _check(A.flash_attention_packed_backward, A.flash_attention_packed_backward_reference,
           q, k, v, out, lse, g, h, rms_tol=RMS_TOL["K5"])


@pytest.mark.gpu
@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("b,t,s,h", [(2, 14, 20, 2), (2, 1, 16, 1), (1, 32, 9, 2), (3, 5, 91, 3)])
def test_temporal_attention_direct_backward(cuda, dt, b, t, s, h):
    dtype = DTYPES[dt]
    q, k, v, g = (_randn(cuda, i, dtype, b * t, s, h, 64) for i in (25, 26, 27, 28))
    out = A.temporal_attention_direct(q, k, v, t=t)
    _check(A.temporal_attention_direct_backward, A.temporal_attention_direct_backward_reference,
           q, k, v, out, g, t, rms_tol=RMS_TOL["K6"])


@pytest.mark.gpu
@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("b,t,m,cin,cout", [(2, 5, 33, 40, 24), (1, 1, 40, 64, 64), (2, 14, 20, 136, 200)])
def test_temporal_conv_1x1_backward(cuda, dt, b, t, m, cin, cout):
    """dx is a K4 launch on g with the reversed, transposed taps."""
    dtype = DTYPES[dt]
    x = _randn(cuda, 31, dtype, b, t, m, cin)
    w = _randn(cuda, 32, dtype, 3, cin, cout, scale=(3 * cin) ** -0.5)
    g = _randn(cuda, 33, dtype, b, t, m, cout)
    launches, calls = TC.temporal_conv_1x1.launches, TC.temporal_conv_1x1_backward_reference.calls
    got = TC.temporal_conv_1x1_backward(x, w, g)
    torch.cuda.synchronize()
    assert TC.temporal_conv_1x1.launches == launches + 1
    assert TC.temporal_conv_1x1_backward_reference.calls == calls
    _close_grads(got, TC.temporal_conv_1x1_backward_reference(x, w, g), RMS_TOL["K4"])


@pytest.mark.gpu
def test_autograd_through_the_kernels(cuda):
    """On CUDA tensors that require grad the forward wrappers return outputs
    with a grad_fn and the backward launches K5, K6 and K4; K3 refuses."""
    b, l, h, t = 2, 70, 2, 5
    q, k, v = (_randn(cuda, i, torch.bfloat16, b, l, h * 64).requires_grad_() for i in (41, 42, 43))
    out = A.flash_attention_packed(q, k, v, heads=h)
    assert out.grad_fn is not None
    before = A.flash_attention_packed_backward.launches
    out.float().square().sum().backward()
    assert A.flash_attention_packed_backward.launches == before + 1
    assert all(x.grad is not None and x.grad.abs().sum() > 0 for x in (q, k, v))

    q4, k4, v4 = (_randn(cuda, i, torch.bfloat16, b * t, 9, h, 64).requires_grad_() for i in (44, 45, 46))
    out = A.temporal_attention_direct(q4, k4, v4, t=t)
    assert out.grad_fn is not None
    before = A.temporal_attention_direct_backward.launches
    out.float().square().sum().backward()
    assert A.temporal_attention_direct_backward.launches == before + 1

    x = _randn(cuda, 47, torch.bfloat16, b, t, 30, 64).requires_grad_()
    w = _randn(cuda, 48, torch.bfloat16, 3, 64, 64, scale=0.1).requires_grad_()
    bias = _randn(cuda, 49, torch.bfloat16, 64).requires_grad_()
    y = TC.temporal_conv_1x1(x, w, bias)
    assert y.grad_fn is not None
    before = TC.temporal_conv_1x1.launches
    y.float().sum().backward()
    assert TC.temporal_conv_1x1.launches == before + 1
    assert all(a.grad is not None for a in (x, w, bias))

    x4 = _randn(cuda, 50, torch.bfloat16, 1, 1, 40, 512).requires_grad_()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        A.flash_attention(x4, x4, x4)
    with torch.no_grad():
        assert A.flash_attention(x4, x4, x4).grad_fn is None
