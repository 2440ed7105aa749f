"""The CUDA kernels (K1-K12) against their plain versions, on the card.

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
units) of the plain LSE. The GroupNorm kernels (K7 + K8 forward, K9 + K10
backward) take the same bounds with RMS_TOL["GN"]; K7's mean and inv-std are
also held to fp64 statistics of the same input (STATS_TOL, relative). K11
(matmul_bias) and K12 (conv3x3_same) take chip_smoke.py's forward bounds too
(2 bf16 steps at max |plain|, RMS_TOL["K11"] / ["K12"]; fp32 1e-4).
"""

import math

import pytest
import torch

from vidseg_diffusion_tpu_torch.ops import attention as A
from vidseg_diffusion_tpu_torch.ops import conv3x3 as C3
from vidseg_diffusion_tpu_torch.ops import matmul as MM
from vidseg_diffusion_tpu_torch.ops import norm as N
from vidseg_diffusion_tpu_torch.ops import temporal_conv as TC

TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-4}
DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32}
RMS_TOL = {"K4": 5e-4, "K5": 1e-3, "K6": 2e-4, "GN": 5e-4, "K11": 5e-4, "K12": 5e-4}  # bf16; fp32 is FP32_TOL
STATS_TOL = 2e-5  # K7's fp32 mean (relative to the rms of x) and inv-std vs fp64
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


GN_SHAPES = [((2, 6, 8, 32), 8), ((3, 7, 13, 64), 16), ((2, 14, 8, 8, 32), 8), ((28, 91, 1280), 32),
             ((2, 33, 2560), 32), ((1, 5000, 128), 32), ((3, 17, 5, 6), 2), ((2, 9, 4, 36), 4)]


def _gn_inputs(cuda, dtype, shape, seed=60):
    c = shape[-1]
    x = _randn(cuda, seed, dtype, *shape) * 1.5 + 0.3
    w = _randn(cuda, seed + 1, dtype, c) * 0.5 + 1.0
    b = _randn(cuda, seed + 2, dtype, c)
    return x, w, b


@pytest.mark.gpu
@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("silu", [False, True])
@pytest.mark.parametrize("eps", [1e-5, 1e-6])
@pytest.mark.parametrize("shape,groups", GN_SHAPES)
def test_group_norm_forward(cuda, dt, silu, eps, shape, groups):
    """K7 + K8 vs the plain forward; K7's statistics vs fp64."""
    x, w, b = _gn_inputs(cuda, DTYPES[dt], shape)
    launches = N.group_norm_stats.launches, N.group_norm_apply.launches
    calls = N.group_norm_plain.calls
    y = N.group_norm(x, w, b, groups, eps, silu=silu)
    torch.cuda.synchronize()
    assert (N.group_norm_stats.launches, N.group_norm_apply.launches) == (launches[0] + 1, launches[1] + 1)
    assert N.group_norm_plain.calls == calls
    _close_grads((y,), (N.group_norm_plain(x, w, b, groups, eps, silu=silu),), RMS_TOL["GN"])
    _, _, mean, inv = N.group_norm_stats(x, w, b, groups, eps)
    xd = x.double().reshape(shape[0], -1, groups, shape[-1] // groups)
    mean64 = xd.mean(dim=(1, 3))
    var64 = xd.var(dim=(1, 3), unbiased=False)
    rms = xd.square().mean(dim=(1, 3)).sqrt()
    assert ((mean.double() - mean64).abs() / rms).max().item() <= STATS_TOL
    assert (inv.double() * (var64 + eps).sqrt() - 1).abs().max().item() <= STATS_TOL


@pytest.mark.gpu
@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("silu", [False, True])
@pytest.mark.parametrize("shape,groups", GN_SHAPES)
def test_group_norm_backward(cuda, dt, silu, shape, groups):
    """K9 + K10 vs the plain coefficient-form backward on the forward's
    statistics."""
    x, w, b = _gn_inputs(cuda, DTYPES[dt], shape, seed=70)
    dy = _randn(cuda, 75, DTYPES[dt], *shape)
    a, s, mean, inv = N.group_norm_stats(x, w, b, groups, 1e-5)
    launches = N.group_norm_backward_stats.launches, N.group_norm_backward_apply.launches
    calls = N.group_norm_backward_plain.calls
    coef, dw, db = N.group_norm_backward_stats(x, dy, w, a, s, mean, inv, groups, silu)
    dx = N.group_norm_backward_apply(x, dy, a, s, coef, silu)
    torch.cuda.synchronize()
    assert (N.group_norm_backward_stats.launches, N.group_norm_backward_apply.launches) == (
        launches[0] + 1, launches[1] + 1)
    assert N.group_norm_backward_plain.calls == calls
    ref = N.group_norm_backward_plain(x, dy, w, a, s, mean, inv, groups, silu)
    _close_grads((dx,), ref[:1], RMS_TOL["GN"])
    _close_grads((dw, db), ref[1:], RMS_TOL["GN"])


@pytest.mark.gpu
def test_group_norm_autograd_and_strided_input(cuda):
    """With grad on the CUDA path runs GroupNormFn (K9 + K10 in the backward),
    agrees with autograd through the plain forward, and is the same from run
    to run; a strided input is copied and counted."""
    x, w, b = _gn_inputs(cuda, torch.float32, (2, 10, 12, 64), seed=80)
    leaves = [t.clone().requires_grad_() for t in (x, w, b)]
    y = N.group_norm(*leaves, 32, 1e-5, silu=True)
    assert y.grad_fn is not None
    before = N.group_norm_backward_stats.launches, N.group_norm_backward_apply.launches
    y.square().sum().backward()
    assert (N.group_norm_backward_stats.launches, N.group_norm_backward_apply.launches) == (
        before[0] + 1, before[1] + 1)
    plain = [t.clone().requires_grad_() for t in (x, w, b)]
    N.group_norm_plain(*plain, 32, 1e-5, silu=True).square().sum().backward()
    _close_grads([t.grad for t in leaves], [t.grad for t in plain], None)
    again = [t.clone().requires_grad_() for t in (x, w, b)]
    N.group_norm(*again, 32, 1e-5, silu=True).square().sum().backward()
    assert all(torch.equal(p.grad, q.grad) for p, q in zip(leaves, again))

    xt = x.permute(0, 2, 1, 3)  # [2, 12, 10, 64], strided
    copies = N.group_norm.copies
    with torch.no_grad():
        _close(N.group_norm(xt, w, b, 32), N.group_norm_plain(xt, w, b, 32))
    assert N.group_norm.copies == copies + 1
    with pytest.raises(ValueError, match="contiguous"):
        N.group_norm_apply(xt, *N.group_norm_stats(x, w, b, 32, 1e-5)[:2], False)


def _check_forward(fn, plain, rms_tol, *args):
    """One launch of the wrapper (the plain version's counter does not move),
    then the plain version, held to the forward bounds of the docstring."""
    launches, calls = fn.launches, plain.calls
    out = fn(*args)
    torch.cuda.synchronize()
    assert fn.launches == launches + 1 and plain.calls == calls
    _close_grads((out,), (plain(*args),), rms_tol)
    return out


# ragged M (1, 28, 2156 rows), N (not a multiple of the 64- and 128-wide tiles),
# K (not a multiple of the 32-deep slice, and of the 8-element vector: 20, 5)
MM_SHAPES = [((28,), 1024, 320), ((2, 77, ), 1024, 640), ((3, 130), 320, 320), ((300,), 72, 200),
             ((257,), 20, 50), ((1,), 64, 128), ((5, 7, 9), 5, 3), ((4, 91), 1280, 1280)]


@pytest.mark.gpu
@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("lead,k,n", MM_SHAPES)
def test_matmul_bias(cuda, dt, with_bias, lead, k, n):
    dtype = DTYPES[dt]
    x = _randn(cuda, 90, dtype, *lead, k)
    w = _randn(cuda, 91, dtype, n, k, scale=k ** -0.5)
    bias = _randn(cuda, 92, dtype, n) if with_bias else None
    y = _check_forward(MM.matmul_bias, MM.matmul_bias_plain, RMS_TOL["K11"], x, w, bias)
    assert y.shape == tuple(lead) + (n,) and y.is_contiguous()


@pytest.mark.gpu
def test_matmul_bias_unaligned_operands_and_refusals(cuda):
    """A bias and an x that start off a 16-byte boundary (element loads), a
    strided x (refused), mixed dtypes (refused)."""
    bf = torch.bfloat16
    x = _randn(cuda, 93, bf, 40 * 64 + 1)[1:].view(40, 64)
    w = _randn(cuda, 94, bf, 48, 64, scale=0.125)
    bias = _randn(cuda, 95, bf, 49)[1:]
    _check_forward(MM.matmul_bias, MM.matmul_bias_plain, RMS_TOL["K11"], x, w, bias)
    with pytest.raises(ValueError, match="contiguous"):
        MM.matmul_bias(x[:, ::2], w[:, :32].contiguous())
    with pytest.raises(ValueError, match="dtypes"):
        MM.matmul_bias(x, w.float())


# image-boundary rows: B*H*W not a multiple of the 128-row tile, so tiles span
# two images; a 1-pixel-wide and a 1-pixel-high image; Cin off the slice and
# the vector (20, 5); Cout off the tile widths
C3_SHAPES = [(3, 7, 13, 64, 64), (2, 9, 5, 96, 320), (28, 7, 13, 40, 72), (2, 1, 11, 32, 32),
             (2, 6, 1, 32, 48), (1, 1, 1, 64, 64), (2, 5, 6, 20, 50), (3, 4, 4, 5, 3), (1, 16, 16, 320, 128)]


@pytest.mark.gpu
@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("b,h,w,cin,cout", C3_SHAPES)
def test_conv3x3_same(cuda, dt, with_bias, b, h, w, cin, cout):
    dtype = DTYPES[dt]
    x = _randn(cuda, 96, dtype, b, h, w, cin)
    weight = _randn(cuda, 97, dtype, cout, cin, 3, 3, scale=(9 * cin) ** -0.5)
    bias = _randn(cuda, 98, dtype, cout) if with_bias else None
    y = _check_forward(C3.conv3x3_same, C3.conv3x3_plain, RMS_TOL["K12"], x, weight, bias)
    # the plain version against the library convolution, in fp32 (TF32 off)
    if dtype == torch.float32:
        saved = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = False
        ref = torch.nn.functional.conv2d(x.permute(0, 3, 1, 2), weight, bias, padding=1).permute(0, 2, 3, 1)
        torch.backends.cudnn.allow_tf32 = saved
        _close_grads((y,), (ref,), None)


@pytest.mark.gpu
def test_conv3x3_images_do_not_mix(cuda):
    """Each image of a batch convolves as it does alone: rows of a tile that
    spans the last pixels of image b and the first of b + 1 read only their
    own image's halo."""
    bf = torch.bfloat16
    x = _randn(cuda, 99, bf, 5, 6, 7, 64)
    weight = _randn(cuda, 100, bf, 64, 64, 3, 3, scale=1 / 24)
    bias = _randn(cuda, 101, bf, 64)
    whole = C3.conv3x3_same(x, weight, bias)
    for i in range(x.shape[0]):
        assert torch.equal(whole[i:i + 1], C3.conv3x3_same(x[i:i + 1].contiguous(), weight, bias))


@pytest.mark.gpu
def test_conv3x3_weight_relay_is_cached_per_version(cuda):
    x = _randn(cuda, 102, torch.bfloat16, 1, 4, 4, 32)
    weight = _randn(cuda, 103, torch.bfloat16, 32, 32, 3, 3, scale=0.06)
    before = C3.conv3x3_same.relays
    y0 = C3.conv3x3_same(x, weight)
    y1 = C3.conv3x3_same(x, weight)
    assert C3.conv3x3_same.relays == before + 1 and torch.equal(y0, y1)
    weight.mul_(2.0)
    y2 = C3.conv3x3_same(x, weight)
    assert C3.conv3x3_same.relays == before + 2
    _close_grads((y2,), (C3.conv3x3_plain(x, weight),), RMS_TOL["K12"])


@pytest.mark.gpu
def test_conv3x3_module_with_fp32_weights_relays_once(cuda):
    """A ResBlock conv that keeps fp32 parameters under bf16 activations: the
    cast is part of the cached tap-major copy, so a second forward makes none."""
    from vidseg_diffusion_tpu_torch.models.layers import Conv3x3NHWC

    conv = Conv3x3NHWC(32, 48).to(cuda)
    x = _randn(cuda, 111, torch.bfloat16, 2, 5, 7, 32)
    before = C3.conv3x3_same.relays
    with torch.no_grad():
        y0 = conv(x)
        y1 = conv(x)
        want = C3.conv3x3_same(x, conv.weight.bfloat16(), conv.bias.bfloat16())
    assert C3.conv3x3_same.relays == before + 2  # the module's copy, and the pre-cast weight's
    assert y0.dtype == torch.bfloat16 and torch.equal(y0, y1) and torch.equal(y0, want)
    with torch.no_grad():
        conv(x)
    assert C3.conv3x3_same.relays == before + 2


@pytest.mark.gpu
@pytest.mark.parametrize("dt", list(DTYPES))
def test_autograd_through_matmul_bias_and_conv3x3(cuda, dt):
    """With grad on the wrappers return outputs with a grad_fn, the forward is
    one launch, and the gradients agree with autograd through the plain
    versions; under no_grad nothing is recorded."""
    dtype = DTYPES[dt]
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    x = _randn(cuda, 104, dtype, 3, 50, 72)
    w = _randn(cuda, 105, dtype, 40, 72, scale=72 ** -0.5)
    bias = _randn(cuda, 106, dtype, 40)
    xc = _randn(cuda, 107, dtype, 2, 6, 5, 24)
    wc = _randn(cuda, 108, dtype, 16, 24, 3, 3, scale=216 ** -0.5)
    bc = _randn(cuda, 109, dtype, 16)
    for fn, plain, args in ((MM.matmul_bias, MM.matmul_bias_plain, (x, w, bias)),
                            (C3.conv3x3_same, C3.conv3x3_plain, (xc, wc, bc))):
        leaves = [t.clone().requires_grad_() for t in args]
        launches = fn.launches
        y = fn(*leaves)
        assert y.grad_fn is not None and fn.launches == launches + 1
        g = _randn(cuda, 110, dtype, *y.shape)  # the same output gradient on both sides
        y.backward(g)
        assert fn.launches == launches + 1
        ref = [t.clone().requires_grad_() for t in args]
        plain(*ref).backward(g)
        _close_grads([t.grad for t in leaves], [t.grad for t in ref], 5e-4)
        with torch.no_grad():
            assert fn(*leaves).grad_fn is None
    torch.backends.cudnn.allow_tf32 = saved
