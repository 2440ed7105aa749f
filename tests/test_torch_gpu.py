"""The CUDA kernels (K1-K4) against their plain versions, on the card.

Every test here needs a CUDA card and skips without one. The file imports
no JAX, so on a machine with a card and no JAX it runs without the suite's
conftest:

    python -m pytest tests/test_torch_gpu.py --noconftest -q

Inputs come from a seeded generator on the card; kernel and plain version
see the same tensors. Tolerance: max |kernel - plain| <= TOL * max(1,
max |plain|), with TOL 1e-2 in bf16 (a bf16 rounding step or two of the
output: the kernels accumulate in fp32 in another order) and 1e-4 in fp32.
"""

import pytest
import torch

from vidseg_diffusion_tpu_torch.ops import attention as A
from vidseg_diffusion_tpu_torch.ops import temporal_conv as TC

TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-4}
DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32}


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


def _check(fn, plain, *args, **kwargs):
    """Run the kernel wrapper once (its launch counter moves, the plain
    version's call counter does not), then the plain version, and compare."""
    launches, calls = fn.launches, plain.calls
    out = fn(*args, **kwargs)
    torch.cuda.synchronize()
    assert fn.launches == launches + 1 and plain.calls == calls
    ref = plain(*args, **kwargs)
    assert out.shape == ref.shape and out.dtype == ref.dtype
    assert bool(torch.isfinite(out).all())
    err = (out.float() - ref.float()).abs().max().item()
    scale = max(1.0, ref.float().abs().max().item())
    assert err <= TOL[out.dtype] * scale, (err, scale)


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
