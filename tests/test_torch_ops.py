"""The PyTorch port's ops against the JAX package's, on the CPU.

Inputs are numpy arrays from a seed, fed to both. The JAX Pallas kernels
run in interpret mode (interpret=True, force=True where the dispatcher would
otherwise pick the jnp path), as the JAX package's own tests run them. The
port's kernel wrappers take their plain versions on CPU tensors, so these
tests hold the plain versions (the oracles of the CUDA kernels) to the TPU
kernels' math. Everything is fp32; tolerances are stated per test. The CUDA
kernels themselves are compared with these plain versions on the card by
tests/test_torch_gpu.py and chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vidseg_diffusion_tpu.engine import segmentation as jseg
from vidseg_diffusion_tpu.ops import attention as jatt
from vidseg_diffusion_tpu.ops import conv3x3 as jc3
from vidseg_diffusion_tpu.ops import image as jimg
from vidseg_diffusion_tpu.ops import kmeans as jkm
from vidseg_diffusion_tpu.ops import matmul as jmm
from vidseg_diffusion_tpu.ops import norm as jnorm
from vidseg_diffusion_tpu.ops import temporal_conv as jtc
from vidseg_diffusion_tpu_torch.engine import segmentation as tseg
from vidseg_diffusion_tpu_torch.ops import attention as tatt
from vidseg_diffusion_tpu_torch.ops import conv3x3 as tc3
from vidseg_diffusion_tpu_torch.ops import image as timg
from vidseg_diffusion_tpu_torch.ops import kmeans as tkm
from vidseg_diffusion_tpu_torch.ops import matmul as tmm
from vidseg_diffusion_tpu_torch.ops import norm as tnorm
from vidseg_diffusion_tpu_torch.ops import temporal_conv as ttc

OPS_TOL = 1e-5  # fp32, same math, different summation order


def _arrays(seed, *shapes, scale=1.0):
    rs = np.random.RandomState(seed)
    return [(rs.randn(*s) * scale).astype(np.float32) for s in shapes]


def _close(got, want, atol=OPS_TOL, rtol=OPS_TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=rtol)


T = torch.from_numpy


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the small CPU shapes here gain nothing from more,
    and idle OpenMP threads spin against the suite's other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- K1 ---------------------------------------------------------------------


@pytest.mark.parametrize("b,h,lq,lk", [(2, 2, 14, 14), (2, 3, 91, 91), (1, 2, 364, 364), (1, 2, 91, 300)])
def test_flash_attention_packed_plain_matches_pallas(b, h, lq, lk):
    d = 16
    q, k, v = _arrays(b * lq + lk, (b, lq, h * d), (b, lk, h * d), (b, lk, h * d))
    want = jatt.flash_attention_packed(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                       heads=h, interpret=True)
    before = tatt.flash_attention_packed_reference.calls
    got = tatt.flash_attention_packed(T(q), T(k), T(v), heads=h)
    assert tatt.flash_attention_packed_reference.calls == before + 1  # CPU -> plain version
    _close(got, want)


@pytest.mark.parametrize("b,lq,h", [(4, 14, 2), (2, 91, 3)])
def test_small_batched_attention_matches_pallas(b, lq, h):
    d = 16
    q, k, v = _arrays(lq, (b, lq, h, d), (b, lq, h, d), (b, lq, h, d))
    want = jatt.small_batched_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), interpret=True)
    _close(tatt.small_batched_attention(T(q), T(k), T(v)), want)


# -- K1 save_lse and K5 ----------------------------------------------------------


@pytest.mark.parametrize("lq,lk", [(128, 128), (200, 200), (200, 77)])
def test_flash_attention_packed_backward_plain_matches_pallas(lq, lk):
    """The plain K5 on JAX's saved LSE and output against the Pallas dq and
    dk/dv kernels in interpret mode (L = 200: the ragged tails of both
    grids); the plain save_lse LSE against the Pallas one."""
    b, h, d = 2, 2, 16
    q, g = _arrays(lq + 1, (b, lq, h * d), (b, lq, h * d))
    k, v = _arrays(lk + 2, (b, lk, h * d), (b, lk, h * d))
    jq, jk, jv, jg = map(jnp.asarray, (q, k, v, g))
    out, lse = jatt._flash_attention_packed_impl(jq, jk, jv, heads=h, save_lse=True, interpret=True)
    want = jatt._flash_attention_packed_bwd_impl(jq, jk, jv, out, lse, jg, heads=h, interpret=True)
    t_out, t_lse = tatt.flash_attention_packed_reference(T(q), T(k), T(v), heads=h, save_lse=True)
    _close(t_out, out)
    _close(t_lse, lse)
    before = tatt.flash_attention_packed_backward_reference.calls
    got = tatt.flash_attention_packed_backward(T(q), T(k), T(v), T(np.array(out)), T(np.array(lse)),
                                               T(g), heads=h)
    assert tatt.flash_attention_packed_backward_reference.calls == before + 1  # CPU -> plain version
    for a, w in zip(got, want):
        _close(a, w)


# -- K2 ---------------------------------------------------------------------


@pytest.mark.parametrize("b,t,s,h,d", [(2, 3, 32, 2, 16), (1, 14, 16, 2, 8), (2, 1, 16, 1, 16)])
def test_temporal_attention_direct_plain_matches_pallas(b, t, s, h, d):
    q, k, v = _arrays(s + t, (b * t, s, h, d), (b * t, s, h, d), (b * t, s, h, d))
    want = jatt.temporal_attention_direct(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), t=t,
                                          force=True, interpret=True)
    _close(tatt.temporal_attention_direct(T(q), T(k), T(v), t=t), want)


@pytest.mark.parametrize("s", [20, 91])
def test_temporal_attention_direct_unaligned_s_matches_jax_dispatch(s):
    """s % 16 != 0: JAX's dispatch falls back to the canonical rearrange; the
    port has one path for every s."""
    b, t, h, d = 2, 14, 2, 8
    q, k, v = _arrays(s, (b * t, s, h, d), (b * t, s, h, d), (b * t, s, h, d))
    want = jatt.temporal_attention_direct(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), t=t)
    _close(tatt.temporal_attention_direct(T(q), T(k), T(v), t=t), want)


# -- K6 ---------------------------------------------------------------------


@pytest.mark.parametrize("b,t,s,h,d", [(2, 3, 32, 2, 16), (1, 14, 16, 2, 8)])
def test_temporal_attention_direct_backward_plain_matches_pallas(b, t, s, h, d):
    """The plain K6 against jax.vjp of the direct-layout kernel in interpret
    mode, whose VJP runs the Pallas tiny-seq backward on the canonical
    transposes."""
    q, k, v, g = _arrays(s + t + 5, *[(b * t, s, h, d)] * 4)
    jfn = lambda q_, k_, v_: jatt.temporal_attention_direct(q_, k_, v_, t=t, force=True, interpret=True)
    out, vjp = jax.vjp(jfn, *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(g))
    got = tatt.temporal_attention_direct_backward(T(q), T(k), T(v), T(np.array(out)), T(g), t=t)
    for a, w in zip(got, want):
        _close(a, w)


# -- gradients through the kernel wrappers -----------------------------------


def _grads(fn, inputs, g):
    xs = [T(a).requires_grad_() for a in inputs]
    fn(*xs).backward(T(g))
    return [x.grad for x in xs]


_FUNCTIONS = {
    "K1/K5": (lambda q, k, v: tatt.flash_attention_packed(q, k, v, heads=2),
              lambda q, k, v: tatt.flash_attention_packed_reference(q, k, v, heads=2),
              [(2, 70, 32)] * 3, (2, 70, 32)),
    "K2/K6": (lambda q, k, v: tatt.temporal_attention_direct(q, k, v, t=5),
              lambda q, k, v: tatt.temporal_attention_direct_reference(q, k, v, t=5),
              [(10, 6, 2, 16)] * 3, (10, 6, 2, 16)),
    "K4": (ttc.temporal_conv_1x1, ttc.temporal_conv_1x1_reference,
           [(2, 5, 12, 16), (3, 16, 24), (24,)], (2, 5, 12, 24)),
    "K4 Conv3d weight": (ttc.temporal_conv_1x1,
                         lambda x, w, b: ttc.temporal_conv_1x1_reference(x, w[:, :, :, 0, 0].permute(2, 1, 0), b),
                         [(2, 5, 12, 16), (24, 16, 3, 1, 1), (24,)], (2, 5, 12, 24)),
    "K11": (tmm.matmul_bias, tmm.matmul_bias_plain, [(3, 17, 20), (24, 20), (24,)], (3, 17, 24)),
    "K11 no bias": (tmm.matmul_bias, tmm.matmul_bias_plain, [(30, 20), (24, 20)], (30, 24)),
    "K12": (tc3.conv3x3_same, tc3.conv3x3_plain, [(2, 5, 7, 8), (12, 8, 3, 3), (12,)], (2, 5, 7, 12)),
    "K12 no bias": (tc3.conv3x3_same, tc3.conv3x3_plain, [(2, 5, 7, 8), (12, 8, 3, 3)], (2, 5, 7, 12)),
}


@pytest.mark.parametrize("name", list(_FUNCTIONS))
def test_kernel_functions_backward_match_autograd_of_plain_forward(name):
    """On CPU tensors that require grad, each kernel wrapper runs as a
    torch.autograd.Function whose backward is its backward kernel's plain
    version; its gradients equal autograd's through the plain forward."""
    fn, plain, shapes, out_shape = _FUNCTIONS[name]
    inputs = _arrays(21, *shapes)
    (g,) = _arrays(22, out_shape)
    with torch.no_grad():
        assert fn(*map(T, inputs)).grad_fn is None  # no grad: the forward alone
    out = fn(*[T(a).requires_grad_() for a in inputs])
    assert out.grad_fn is not None and "Backward" in type(out.grad_fn).__name__
    for a, w in zip(_grads(fn, inputs, g), _grads(plain, inputs, g)):
        _close(a, w, atol=2e-5, rtol=2e-5)


def test_temporal_conv_grads_match_jax():
    """K4's Function against jax.grad through the Pallas temporal conv's
    custom_vjp (interpret mode); dx is the conv of g with reversed,
    transposed taps."""
    x, w, bias, g = _arrays(23, (2, 5, 12, 16), (3, 16, 24), (24,), (2, 5, 12, 24))
    jfn = lambda x_, w_, b_: jtc.temporal_conv_1x1(x_, w_, b_, interpret=True)
    _, vjp = jax.vjp(jfn, *map(jnp.asarray, (x, w, bias)))
    want = vjp(jnp.asarray(g))
    for a, ww in zip(_grads(ttc.temporal_conv_1x1, (x, w, bias), g), want):
        _close(a, ww, atol=5e-5, rtol=5e-5)


def test_flash_attention_bhld_refuses_a_gradient():
    """K3 takes a gradient now (the name is the one this test had while K3
    refused one): with grad on, the output carries K3's autograd Function
    (forward with the LSE, K13's plain backward on the CPU) and its gradients
    match autograd of the plain forward at ragged Lq != Lk, H > 1; under
    no_grad the forward alone runs, with no graph."""
    q, k, v, g = _arrays(24, (2, 2, 20, 16), (2, 2, 13, 16), (2, 2, 13, 16), (2, 2, 20, 16))
    with torch.no_grad():
        out = tatt.flash_attention(*map(T, (q, k, v)))
        assert out.grad_fn is None
        _close(out, tatt.flash_attention_reference(*map(T, (q, k, v))))
    calls = tatt.flash_attention_backward_reference.calls
    got = _grads(tatt.flash_attention, (q, k, v), g)
    assert tatt.flash_attention_backward_reference.calls == calls + 1
    for a, w in zip(got, _grads(tatt.flash_attention_reference, (q, k, v), g)):
        _close(a, w, atol=2e-5, rtol=2e-5)


# -- K3 ---------------------------------------------------------------------


# fp32: same math, 1e-5. bf16 (the dtype the card's tensor-core kernels take, at
# the head dims they are built for: 512 and 80, ragged lengths, Lq != Lk): the
# Pallas kernel rounds p to bf16 against a running max per key block, the plain
# version against the row's max, so outputs may land a bf16 step apart; held to
# the card's own bounds (chip_smoke.py): <= 2 bf16 steps at max |want| and a
# relative RMS error <= 4e-3.
K3_CASES = [(2, 1, 100, 100, 128, "fp32"), (1, 4, 257, 257, 16, "fp32"), (1, 1, 64, 64, 512, "fp32"),
            (1, 1, 70, 70, 512, "bf16"), (1, 1, 130, 77, 512, "bf16"), (2, 1, 200, 200, 512, "bf16"),
            (1, 2, 257, 257, 80, "bf16"), (1, 3, 100, 37, 80, "bf16"), (1, 1, 130, 77, 512, "fp32")]


@pytest.mark.parametrize("b,h,lq,lk,d,dt", K3_CASES)
def test_flash_attention_bhld_plain_matches_pallas(b, h, lq, lk, d, dt):
    q, k, v = _arrays(lq + d, (b, h, lq, d), (b, h, lk, d), (b, h, lk, d))
    if dt == "fp32":
        want = jatt.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), interpret=True)
        _close(tatt.flash_attention(T(q), T(k), T(v)), want)
        return
    jb = lambda a: jnp.asarray(a, jnp.bfloat16)
    want = np.asarray(jatt.flash_attention(jb(q), jb(k), jb(v), interpret=True).astype(jnp.float32))
    got = tatt.flash_attention(T(q).bfloat16(), T(k).bfloat16(), T(v).bfloat16())
    assert got.dtype == torch.bfloat16
    diff = got.float().numpy() - want
    assert np.abs(diff).max() <= 2 * _bf16_step(np.abs(want).max())
    assert np.linalg.norm(diff) <= 4e-3 * np.linalg.norm(want)


# -- dispatcher ---------------------------------------------------------------


@pytest.mark.parametrize("layout", ["bhld", "blhd"])
def test_dot_product_attention_matches_jax_cpu_dispatch(layout):
    shape = (2, 3, 40, 16) if layout == "bhld" else (2, 40, 3, 16)
    q, k, v = _arrays(1, shape, shape, shape)
    want = jatt.dot_product_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), layout=layout)
    _close(tatt.dot_product_attention(T(q), T(k), T(v), layout=layout), want)


def test_single_key_shortcut_returns_v_without_attention():
    """lk == 1 (every SVD cross-attention site): V broadcast over the queries,
    and neither a kernel nor a plain attention runs."""
    q, k, v = _arrays(2, (6, 50, 2, 16), (6, 1, 2, 16), (6, 1, 2, 16))
    want = jatt.dot_product_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), layout="blhd")
    counters = [f.calls for f in tatt.PLAIN_COUNTERS] + [f.launches for f in tatt.KERNEL_COUNTERS]
    got = tatt.dot_product_attention(T(q), T(k), T(v), layout="blhd")
    assert counters == [f.calls for f in tatt.PLAIN_COUNTERS] + [f.launches for f in tatt.KERNEL_COUNTERS]
    _close(got, want, atol=0, rtol=0)


def test_plain_versions_keep_bf16_roundings():
    """The kernels' plain versions pre-scale q and round p in the input
    dtype like the Pallas kernels; in bf16 they stay within bf16 rounding of
    the fp32 math."""
    q, k, v = _arrays(3, (2, 64, 2 * 16), (2, 64, 2 * 16), (2, 64, 2 * 16))
    f32 = tatt.flash_attention_packed_reference(T(q), T(k), T(v), heads=2)
    bf = tatt.flash_attention_packed_reference(*(T(a).bfloat16() for a in (q, k, v)), heads=2)
    assert bf.dtype == torch.bfloat16
    np.testing.assert_allclose(bf.float().numpy(), f32.numpy(), atol=3e-2)


# -- K4 ---------------------------------------------------------------------


@pytest.mark.parametrize("b,t,m,cin,cout", [(2, 5, 12, 16, 24), (1, 1, 20, 8, 8), (1, 3, 30, 3, 3), (2, 14, 6, 16, 16)])
def test_temporal_conv_plain_matches_pallas(b, t, m, cin, cout):
    x, w, bias = _arrays(t * m, (b, t, m, cin), (3, cin, cout), (cout,))
    want = jtc.temporal_conv_1x1(jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias), interpret=True)
    _close(ttc.temporal_conv_1x1(T(x), T(w), T(bias)), want, atol=2e-5, rtol=2e-5)
    ref = jtc.temporal_conv_1x1_reference(jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias))
    _close(ttc.temporal_conv_1x1_reference(T(x), T(w), T(bias)), ref, atol=2e-5, rtol=2e-5)


def test_temporal_conv_k_major_copy_is_cached_per_weight_version():
    """The [kt, Cout, Cin] copy K4 reads: tap j holds W[:, :, j, 0, 0] of a
    Conv3d weight (W[j].T of a JAX [kt, Cin, Cout] one); made once per weight
    tensor and again after the weight is written to."""
    (w,) = _arrays(35, (6, 4, 3, 1, 1))
    wt = T(w.copy())
    before = ttc.temporal_conv_1x1.relays
    wk = ttc.k_major(wt)
    assert wk.shape == (3, 6, 4) and wk.is_contiguous()
    for j in range(3):
        np.testing.assert_array_equal(wk[j].numpy(), w[:, :, j, 0, 0])
    assert ttc.k_major(wt) is wk and ttc.temporal_conv_1x1.relays == before + 1
    wt.mul_(2.0)
    assert ttc.k_major(wt) is not wk and ttc.temporal_conv_1x1.relays == before + 2
    np.testing.assert_array_equal(ttc.k_major(wt)[1].numpy(), 2.0 * w[:, :, 1, 0, 0])
    wj = T(w[:, :, :, 0, 0].transpose(2, 1, 0).copy())   # the same weight in JAX's layout
    assert torch.equal(ttc.k_major(wj), ttc.k_major(wt) / 2.0)
    assert ttc.temporal_conv_1x1.relays == before + 3


def test_temporal_conv_mixed_dtype_weight_casts_once_in_the_cached_copy():
    """An fp32 Conv3d weight under bf16 activations: the K-major copy is made in
    the activation's dtype and found again on the next call; the result and
    the gradients are those of the weight cast beforehand, dW in the weight's
    dtype and layout."""
    x, w, bias = _arrays(36, (2, 3, 5, 8), (12, 8, 3, 1, 1), (12,))
    wt = T(w * 0.2)
    before = ttc.temporal_conv_1x1.relays
    wk = ttc.k_major(wt, torch.bfloat16)
    assert wk.dtype == torch.bfloat16 and ttc.k_major(wt, torch.bfloat16) is wk
    assert ttc.temporal_conv_1x1.relays == before + 1
    assert torch.equal(wk[2], wt.bfloat16()[:, :, 2, 0, 0])
    xb, bb = T(x).bfloat16(), T(bias).bfloat16()
    assert torch.equal(ttc.temporal_conv_1x1(xb, wt, bb), ttc.temporal_conv_1x1(xb, wt.bfloat16(), bb))
    xg, wg = xb.clone().requires_grad_(), wt.clone().requires_grad_()
    ttc.temporal_conv_1x1(xg, wg, bb).float().square().sum().backward()
    xr, wr = xb.clone().requires_grad_(), wt.bfloat16().requires_grad_()
    ttc.temporal_conv_1x1(xr, wr, bb).float().square().sum().backward()
    assert wg.grad.dtype == torch.float32 and wg.grad.shape == wt.shape and xg.grad.dtype == torch.bfloat16
    assert torch.equal(xg.grad, xr.grad) and torch.equal(wg.grad, wr.grad.float())


def test_temporal_conv_dx_with_the_flipped_k_major_weight_matches_jax_vjp():
    """The backward's K4 launch reads JAX's [kt, Cin, Cout] weight flipped
    along the taps as its K-major [kt, N = Cin, K = Cout] operand: the plain
    forward on g with that operand (each tap read transposed, as K-major) is
    jax.vjp's dx of JAX's reference, at T = 1, 2 and 5 and kt = 3 and 5."""
    for t, kt in ((1, 3), (2, 3), (5, 3), (5, 5)):
        x, w, bias, g = _arrays(37 + t + kt, (2, t, 7, 8), (kt, 8, 12), (12,), (2, t, 7, 12))
        _, vjp = jax.vjp(jtc.temporal_conv_1x1_reference, *map(jnp.asarray, (x, w, bias)))
        want = vjp(jnp.asarray(g))[0]
        operand = T(w).flip(0)                      # what the kernel path hands K4 for dx
        dx = ttc.temporal_conv_1x1_reference(T(g), operand.transpose(1, 2), torch.zeros(8))
        _close(dx, want, atol=2e-5, rtol=2e-5)
        _close(ttc.temporal_conv_1x1_backward(T(x), T(w), T(g))[0], want, atol=2e-5, rtol=2e-5)


# -- K11, K12 ------------------------------------------------------------------

MM_CASES = [(100, 64, 128), (28, 40, 24), (91, 72, 50), (2156, 32, 40), (1, 8, 8)]
# the last two: widths of the card's 160-column tile (two whole tiles; one and a tail)
C3_CASES = [(2, 8, 12, 32, 32), (1, 6, 10, 16, 48), (2, 4, 7, 8, 8), (3, 1, 5, 8, 16), (2, 5, 1, 8, 8),
            (1, 5, 6, 16, 320), (2, 3, 2, 8, 168)]


def _bf16_step(want):
    """One bf16 rounding step at each element of `want` (fp32 numpy)."""
    return 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
@pytest.mark.parametrize("m,k,n", MM_CASES)
def test_matmul_bias_plain_matches_pallas(m, k, n, dt):
    """The plain version (weight [N, K], nn.Linear's layout) against the
    Pallas kernel in interpret mode (kernel [K, N]): fp32 1e-5, bf16 within
    one bf16 step; a missing bias is JAX's zeros bias."""
    x, w, bias = _arrays(m + n, (m, k), (n, k), (n,))
    w *= k ** -0.5
    if dt == "fp32":
        want = jmm.matmul_bias(jnp.asarray(x), jnp.asarray(w.T), jnp.asarray(bias), interpret=True)
        _close(tmm.matmul_bias(T(x), T(w), T(bias)), want)
        want0 = jmm.matmul_bias(jnp.asarray(x), jnp.asarray(w.T), jnp.zeros((n,)), interpret=True)
        _close(tmm.matmul_bias(T(x), T(w)), want0)
        return
    jb = lambda a: jnp.asarray(a, jnp.bfloat16)
    want = np.asarray(jmm.matmul_bias(jb(x), jb(w.T), jb(bias), interpret=True).astype(jnp.float32))
    got = tmm.matmul_bias(T(x).bfloat16(), T(w).bfloat16(), T(bias).bfloat16())
    assert got.dtype == torch.bfloat16
    assert (np.abs(got.float().numpy() - want) <= _bf16_step(want)).all()


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
@pytest.mark.parametrize("b,h,w_,cin,cout", C3_CASES)
def test_conv3x3_plain_matches_pallas(b, h, w_, cin, cout, dt):
    """The plain version (weight [Cout, Cin, 3, 3], nn.Conv2d's layout) against
    the Pallas kernel in interpret mode (kernel HWIO) and XLA's reference
    convolution: fp32 1e-5, bf16 within one bf16 step."""
    x, w, bias = _arrays(h * w_ + cout, (b, h, w_, cin), (cout, cin, 3, 3), (cout,))
    x *= 0.3
    w *= (9 * cin) ** -0.5
    hwio = np.ascontiguousarray(w.transpose(2, 3, 1, 0))
    if dt == "fp32":
        want = jc3.conv3x3_same(jnp.asarray(x), jnp.asarray(hwio), jnp.asarray(bias), interpret=True)
        _close(tc3.conv3x3_same(T(x), T(w), T(bias)), want)
        _close(tc3.conv3x3_plain(T(x), T(w), T(bias)),
               jc3.conv3x3_reference(jnp.asarray(x), jnp.asarray(hwio), jnp.asarray(bias)))
        _close(tc3.conv3x3_same(T(x), T(w)),
               jc3.conv3x3_same(jnp.asarray(x), jnp.asarray(hwio), jnp.zeros((cout,)), interpret=True))
        return
    jb = lambda a: jnp.asarray(a, jnp.bfloat16)
    want = np.asarray(jc3.conv3x3_same(jb(x), jb(hwio), jb(bias), interpret=True).astype(jnp.float32))
    got = tc3.conv3x3_same(T(x).bfloat16(), T(w).bfloat16(), T(bias).bfloat16())
    assert got.dtype == torch.bfloat16
    assert (np.abs(got.float().numpy() - want) <= _bf16_step(want)).all()


def test_matmul_bias_grads_match_jax():
    """K11's Function against jax.grad through the Pallas kernel's custom_vjp
    (interpret mode; tests/test_kernel_grads.py's loss)."""
    x, w, bias = _arrays(31, (100, 64), (128, 64), (128,))
    w *= 0.1
    loss = lambda x_, w_, b_: jnp.sum(jmm.matmul_bias(x_, w_, b_, interpret=True) ** 2)
    dx, dwt, db = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(w.T), jnp.asarray(bias))
    leaves = [T(a).requires_grad_() for a in (x, w, bias)]
    tmm.matmul_bias(*leaves).square().sum().backward()
    for got, want in zip(leaves, (dx, np.asarray(dwt).T, db)):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(want), rtol=2e-5,
                                   atol=2e-5 * np.abs(np.asarray(want)).max())


def test_conv3x3_grads_match_jax():
    """K12's Function against jax.grad through the Pallas kernel's custom_vjp
    (interpret mode), whose backward is the VJP of XLA's reference conv."""
    x, w, bias = _arrays(32, (2, 6, 10, 16), (16, 16, 3, 3), (16,))
    x *= 0.3
    w *= 0.1
    hwio = np.ascontiguousarray(w.transpose(2, 3, 1, 0))
    loss = lambda x_, w_, b_: jnp.sum(jc3.conv3x3_same(x_, w_, b_, interpret=True) ** 2)
    dx, dw, db = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(hwio), jnp.asarray(bias))
    leaves = [T(a).requires_grad_() for a in (x, w, bias)]
    tc3.conv3x3_same(*leaves).square().sum().backward()
    for got, want in zip(leaves, (dx, np.asarray(dw).transpose(3, 2, 0, 1), db)):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(want), rtol=2e-5,
                                   atol=2e-5 * np.abs(np.asarray(want)).max())


def test_conv3x3_tap_major_copy_is_cached_per_weight_version():
    """The [9, Cout, Cin] copy K12 reads: tap 3*dy + dx holds W[:, :, dy, dx];
    made once per weight tensor and again after the weight is written to."""
    (w,) = _arrays(33, (6, 4, 3, 3))
    wt = T(w.copy())
    before = tc3.conv3x3_same.relays
    w9 = tc3.tap_major(wt)
    assert w9.shape == (9, 6, 4) and w9.is_contiguous()
    for dy in range(3):
        for dx in range(3):
            np.testing.assert_array_equal(w9[3 * dy + dx].numpy(), w[:, :, dy, dx])
    assert tc3.tap_major(wt) is w9 and tc3.conv3x3_same.relays == before + 1
    wt.mul_(2.0)
    assert tc3.tap_major(wt) is not w9 and tc3.conv3x3_same.relays == before + 2
    np.testing.assert_array_equal(tc3.tap_major(wt)[4].numpy(), 2.0 * w[:, :, 1, 1])


def test_conv3x3_mixed_dtype_weight_casts_once_in_the_cached_copy():
    """An fp32 weight under bf16 activations: the tap-major copy is made in the
    activation's dtype and found again on the next call; the result and the
    gradients are those of the weight cast beforehand, dW in the weight's dtype."""
    x, w, bias = _arrays(34, (2, 5, 6, 8), (12, 8, 3, 3), (12,))
    wt = T(w * 0.2)
    before = tc3.conv3x3_same.relays
    w9 = tc3.tap_major(wt, torch.bfloat16)
    assert w9.dtype == torch.bfloat16 and tc3.tap_major(wt, torch.bfloat16) is w9
    assert tc3.conv3x3_same.relays == before + 1
    assert torch.equal(w9[5], wt.bfloat16()[:, :, 1, 2])
    xb, bb = T(x).bfloat16(), T(bias).bfloat16()
    assert torch.equal(tc3.conv3x3_same(xb, wt, bb), tc3.conv3x3_same(xb, wt.bfloat16(), bb))
    xg, wg = xb.clone().requires_grad_(), wt.clone().requires_grad_()
    tc3.conv3x3_same(xg, wg, bb).float().square().sum().backward()
    xr, wr = xb.clone().requires_grad_(), wt.bfloat16().requires_grad_()
    tc3.conv3x3_same(xr, wr, bb).float().square().sum().backward()
    assert wg.grad.dtype == torch.float32 and xg.grad.dtype == torch.bfloat16
    assert torch.equal(xg.grad, xr.grad) and torch.equal(wg.grad, wr.grad.float())


# -- wrappers never fall back -----------------------------------------------


def test_wrappers_raise_off_cpu_and_cuda():
    """A tensor that is neither on the CPU nor on a CUDA card is refused, not
    sent to the plain version."""
    q = torch.empty((1, 16, 64), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        tatt.flash_attention_packed(q, q, q, heads=1)
    x4 = torch.empty((2, 16, 1, 64), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        tatt.temporal_attention_direct(x4, x4, x4, t=2)
    with pytest.raises(ValueError, match="CUDA"):
        tatt.flash_attention(x4, x4, x4)
    with pytest.raises(ValueError, match="CUDA"):
        ttc.temporal_conv_1x1(torch.empty((1, 2, 4, 8), device="meta"),
                              torch.empty((3, 8, 8), device="meta"), torch.empty((8,), device="meta"))
    with pytest.raises(ValueError, match="CUDA"):
        tmm.matmul_bias(torch.empty((4, 8), device="meta"), torch.empty((6, 8), device="meta"))
    with pytest.raises(ValueError, match="CUDA"):
        tc3.conv3x3_same(torch.empty((1, 4, 4, 8), device="meta"), torch.empty((6, 8, 3, 3), device="meta"))
    lse = torch.empty((1, 16, 1), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        tatt.flash_attention_packed_backward(q, q, q, q, lse, q, heads=1)
    with pytest.raises(ValueError, match="CUDA"):
        tatt.temporal_attention_direct_backward(x4, x4, x4, x4, x4, t=2)


# -- GroupNorm, image ops, segmentation, kmeans ------------------------------


@pytest.mark.parametrize("shape,groups", [((2, 6, 5, 64), 32), ((2, 3, 4, 5, 40), 8)])
def test_group_norm_matches_jax(shape, groups):
    x, s, b = _arrays(7, shape, (shape[-1],), (shape[-1],))
    want = jnorm.group_norm_xla(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b), groups=groups, eps=1e-6)
    _close(tnorm.group_norm(T(x), T(s), T(b), groups, 1e-6), want)
    want = jnorm.group_norm_reference(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b), groups=groups,
                                      silu=True)
    _close(tnorm.group_norm(T(x), T(s), T(b), groups, 1e-5, silu=True), want)


# -- K7-K10: GroupNorm ---------------------------------------------------------

GN_CASES = [((2, 6, 8, 32), 8), ((3, 7, 13, 64), 16), ((2, 14, 8, 8, 32), 8)]  # tests/test_ops_norm.py


def _gn_arrays(shape, seed=0, near_constant=False):
    rs = np.random.RandomState(seed)
    c = shape[-1]
    x = rs.randn(*shape).astype(np.float32) * 2.0 + 0.5
    if near_constant:  # E[x^2] - E[x]^2 cancels: the variance clamp decides
        x = (100.0 + 1e-4 * rs.randn(*shape)).astype(np.float32)
    return x, (1.0 + 0.1 * rs.randn(c)).astype(np.float32), (0.1 * rs.randn(c)).astype(np.float32)


@pytest.mark.parametrize("silu", [False, True])
@pytest.mark.parametrize("shape,groups", GN_CASES)
def test_group_norm_plain_matches_pallas(shape, groups, silu):
    """The plain forward (the oracle of K7 + K8) against the TPU kernels in
    interpret mode: the fused group_norm_silu (stats + apply kernels; 4-D
    input, the 5-D case flattened as its dispatcher does) and
    group_norm_split (stats kernel + XLA apply). fp32, 1e-5."""
    x, s, b = _gn_arrays(shape)
    calls = tnorm.group_norm_plain.calls
    got = tnorm.group_norm(T(x), T(s), T(b), groups, 1e-5, silu=silu)
    assert tnorm.group_norm_plain.calls == calls + 1  # CPU -> plain version
    x4 = jnp.asarray(x).reshape(shape[0], -1, shape[-2], shape[-1])
    fused = jnorm.group_norm_silu(x4, jnp.asarray(s), jnp.asarray(b), groups=groups, eps=1e-5,
                                  silu=silu, interpret=True).reshape(shape)
    split = jnorm.group_norm_split(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b), groups=groups,
                                   eps=1e-5, silu=silu, interpret=True)
    _close(got, fused)
    _close(got, split)


@pytest.mark.parametrize("shape,groups", GN_CASES)
def test_group_norm_near_constant_input_stays_finite(shape, groups):
    """E[x^2] - E[x]^2 goes negative from fp32 rounding on a near-constant
    group; the variance is clamped at 0 as in the JAX package
    (norm.py:116-119), so the output is finite and bounded by the eps floor:
    |x - mean| * rsqrt(eps). (The values themselves are rounding noise on
    both sides and are not compared.)"""
    x, s, b = _gn_arrays(shape, near_constant=True)
    got = tnorm.group_norm(T(x), T(s), T(b), groups, 1e-5)
    want = jnorm.group_norm_split(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b), groups=groups,
                                  eps=1e-5, interpret=True)
    bound = np.abs(s).max() * 1e-2 * 1e-5 ** -0.5 + np.abs(b).max()  # |x - mean| < 1e-2
    assert bool(torch.isfinite(got).all()) and np.isfinite(np.asarray(want)).all()
    assert got.abs().max().item() <= bound and np.abs(np.asarray(want)).max() <= bound


@pytest.mark.parametrize("shape,groups", GN_CASES)
def test_group_norm_plain_bf16_is_one_step_from_pallas(shape, groups):
    """bf16 activations: statistics and the affine in fp32, one rounding at
    the end, as the TPU kernels; equal up to one bf16 step of the output."""
    x, s, b = _gn_arrays(shape, seed=1)
    xb = T(x).to(torch.bfloat16)
    got = tnorm.group_norm(xb, T(s), T(b), groups, 1e-6, silu=True).float().numpy()
    x4 = jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16).reshape(shape[0], -1, shape[-2], shape[-1])
    want = np.asarray(jnorm.group_norm_silu(x4, jnp.asarray(s), jnp.asarray(b), groups=groups, eps=1e-6,
                                            silu=True, interpret=True).astype(jnp.float32)).reshape(shape)
    step = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 2.0 ** -126))) - 7)
    assert np.all(np.abs(got - want) <= step)


def _gn_torch_grads(x, s, b, g, groups, silu, dtype=torch.float32):
    """(dx, dgamma, dbeta) through GroupNormFn on the CPU: activations and
    the incoming gradient in `dtype`, parameters in fp32."""
    leaves = [T(x).to(dtype).requires_grad_(), T(s).requires_grad_(), T(b).requires_grad_()]
    calls = tnorm.group_norm_backward_plain.calls
    y = tnorm.group_norm(*leaves, groups, 1e-5, silu=silu)
    assert isinstance(y.grad_fn, tnorm.GroupNormFn._backward_cls)
    y.backward(T(g).to(dtype))
    assert tnorm.group_norm_backward_plain.calls == calls + 1  # CPU -> plain coefficient form
    return [t.grad.float().numpy() for t in leaves]


@pytest.mark.parametrize("dt,tol", [("fp32", 2e-5), ("bf16", 5e-2)])
@pytest.mark.parametrize("shape,groups", GN_CASES)
def test_group_norm_backward_matches_pallas(shape, groups, dt, tol):
    """GroupNormFn's backward on the CPU (the plain coefficient form, the
    oracle of K9 + K10) against jax.grad through _gn, whose VJP is the Pallas
    backward kernels in interpret mode (silu=False, all it covers): dx, dgamma,
    dbeta, relative to the largest gradient; bf16 at the JAX test's 5e-2."""
    x, s, b = _gn_arrays(shape, seed=2)
    g = np.random.RandomState(3).randn(*shape).astype(np.float32)
    jdt = jnp.float32 if dt == "fp32" else jnp.bfloat16
    tdt = torch.float32 if dt == "fp32" else torch.bfloat16
    xj, gj = jnp.asarray(x).astype(jdt), jnp.asarray(g).astype(jdt)
    loss = lambda xx, ss, bb: jnp.sum(jnorm._gn(groups, 1e-5, True, xx, ss, bb).astype(jnp.float32)
                                      * gj.astype(jnp.float32))
    want = jax.grad(loss, argnums=(0, 1, 2))(xj, jnp.asarray(s), jnp.asarray(b))
    xr, gr = np.array(xj.astype(jnp.float32)), np.array(gj.astype(jnp.float32))
    for o, w in zip(_gn_torch_grads(xr, s, b, gr, groups, False, tdt), want):
        w = np.asarray(w.astype(jnp.float32))
        assert np.abs(o - w).max() <= tol * np.abs(w).max()


@pytest.mark.parametrize("shape,groups", GN_CASES)
def test_group_norm_silu_backward_matches_jax_grad(shape, groups):
    """silu=True: the backward recomputes z = a x + s and uses
    u = dy * d silu(z)/dz; against jax.grad of _gn_core(..., silu=True)."""
    x, s, b = _gn_arrays(shape, seed=4)
    g = np.random.RandomState(5).randn(*shape).astype(np.float32)
    loss = lambda xx, ss, bb: jnp.sum(jnorm._gn_core(xx, ss, bb, groups, 1e-5, True)[0] * jnp.asarray(g))
    want = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b))
    for o, w in zip(_gn_torch_grads(x, s, b, g, groups, True), want):
        assert np.abs(o - np.asarray(w)).max() <= 2e-5 * np.abs(np.asarray(w)).max()


@pytest.mark.parametrize("silu", [False, True])
def test_group_norm_fn_gradcheck_fp64(silu):
    rs = np.random.RandomState(6)
    x = torch.tensor(rs.randn(2, 3, 4, 8), dtype=torch.float64, requires_grad=True)
    w = torch.tensor(1.0 + 0.3 * rs.randn(8), dtype=torch.float64, requires_grad=True)
    b = torch.tensor(rs.randn(8), dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(lambda *a: tnorm.group_norm(*a, 4, 1e-5, silu), (x, w, b))


def test_group_norm_saves_nothing_without_grad_and_counts_copies():
    x, s, b = _gn_arrays((2, 5, 6, 16), seed=7)
    leaves = [T(a).requires_grad_() for a in (x, s, b)]
    with torch.no_grad():
        assert tnorm.group_norm(*leaves, 4).grad_fn is None
    assert tnorm.group_norm(T(x), T(s), T(b), 4).grad_fn is None   # nothing requires grad
    copies = tnorm.group_norm.copies
    xt = T(x).permute(0, 2, 1, 3)  # strided view: copied once, and counted
    _close(tnorm.group_norm(xt, T(s), T(b), 4), tnorm.group_norm_plain(xt.contiguous(), T(s), T(b), 4))
    assert tnorm.group_norm.copies == copies + 1
    with pytest.raises(ValueError, match="divisible"):
        tnorm.group_norm(T(x), T(s), T(b), 5)


def test_group_norm_plan_covers_every_row():
    """The chunking the wrappers hand to the kernels (rows per chunk a
    multiple of the rows a block covers per pass, chunks * rows >= R), at the
    main-path shapes and at odd ones, for K8-K10's grid and K7's."""
    for b, r, c, itemsize in [(28, 5824, 320, 2), (28, 91, 1280, 2), (28, 91, 2560, 4), (1, 2609152, 128, 2),
                              (7, 372736, 128, 2), (2, 81536, 320, 2), (3, 91, 6, 2), (1, 1, 32, 4)]:
        for target in (tnorm._TARGET_BLOCKS, tnorm._STATS_TARGET_BLOCKS):   # K8-K10, and K7's one wave
            vec, rows, chunks = tnorm._plan(b, r, c, itemsize, True, target)
            assert vec in (1, 16 // itemsize) and c % vec == 0
            assert rows * chunks >= r > rows * (chunks - 1)
            assert rows % (256 // min(c // vec, 256)) == 0
            assert tnorm._plan(b, r, c, itemsize, False, target)[0] == 1  # unaligned pointers: element loads


# chip_smoke.py's GroupNorm sites (bf16 unless marked) and where the forward goes:
# the fused one-launch kernel where one sample's slab of whole groups with rows of
# a multiple of 16 bytes fits in 196 608 bytes of shared memory, K7 + K8 elsewhere
GN_ROUTE_SITES = [
    ((28, 56, 104, 320), 2, "stream", None),      # ds1: 4 groups of 10 channels, 466 KB
    ((28, 56, 104, 960), 2, "stream", None),      # ds1 concat
    ((28, 28, 52, 640), 2, "fused", 2),           # ds2: two groups of 20 channels, 116 KB
    ((28, 28, 52, 1920), 2, "stream", None),      # ds2 concat: two groups of 60 channels, 349 KB
    ((28, 14, 26, 1280), 2, "fused", 1),          # ds4: 29 KB
    ((28, 7, 13, 1280), 2, "fused", 1),           # mid: 7 KB
    ((28, 7, 13, 2560), 2, "fused", 1),           # ds8 concat: 15 KB
    ((2, 14, 7, 13, 1280), 2, "fused", 1),        # time_stack ds8: 102 KB
    ((2, 14, 14, 26, 1280), 2, "stream", None),   # time_stack ds4: 408 KB
    ((2, 14, 56, 104, 320), 2, "stream", None),   # time_stack ds1
    ((7, 448, 832, 128), 2, "stream", None),      # VAE
    ((1, 7, 448, 832, 128), 2, "stream", None),   # VAE time_stack
    ((7, 56, 104, 512), 2, "fused", 1),           # VAE mid: 16 channels of 2 bytes, 186 KB
    ((28, 56, 104, 320), 4, "stream", None),      # ds1 fp32
    ((28, 7, 13, 1280), 4, "fused", 1),           # mid fp32: 15 KB
    ((2, 1536, 2048), 2, "fused", 1),             # the slab's edge: 1536 rows of 128 bytes
    ((2, 1537, 2048), 2, "stream", None),         # one row more
    ((28, 7, 13, 1280), 2, "stream", "unaligned"),  # x off a 16-byte boundary
]


@pytest.mark.parametrize("shape,itemsize,route,arg", GN_ROUTE_SITES)
def test_group_norm_route_sends_each_site_where_it_fits(shape, itemsize, route, arg):
    """group_norm_route at the main paths' GroupNorm sites (32 groups): the
    fused kernel and its groups per block where the slab fits, else K7 + K8
    with a plan that covers every row."""
    b, c = shape[0], shape[-1]
    r = int(np.prod(shape)) // (b * c)
    got, detail = tnorm.group_norm_route(b, r, c, 32, itemsize, arg != "unaligned")
    assert got == route
    if route == "fused":
        assert detail == arg and r * arg * (c // 32) * itemsize <= tnorm._SLAB_MAX_BYTES
        assert arg * (c // 32) * itemsize % 16 == 0
    else:
        vec, rows, chunks = detail
        assert rows * chunks >= r > rows * (chunks - 1)


@pytest.mark.parametrize("src,dst", [((16, 24), (7, 13)), ((4, 6), (8, 9)), ((30, 40), (224, 224)), ((5, 5), (5, 3))])
def test_resize_bicubic_matches_jax(src, dst):
    (x,) = _arrays(11, (2, 3) + src)
    want = jimg.resize_bicubic(jnp.asarray(x), dst)
    _close(timg.resize_bicubic(T(x), dst), want)


@pytest.mark.parametrize("src,dst", [((8, 10), (16, 20)), ((16, 24), (7, 13))])
def test_resize_nearest_and_lanczos_match_jax(src, dst):
    (x,) = _arrays(12, (2, 3) + src)
    _close(timg.resize_nearest(T(x), dst), jimg.resize_nearest(jnp.asarray(x), dst), atol=0, rtol=0)
    _close(timg.resize_lanczos(T(x), dst), jimg.resize_lanczos(jnp.asarray(x), dst))


def test_gaussian_blur_matches_jax():
    (x,) = _arrays(13, (2, 3, 17, 23), scale=50.0)
    _close(timg.gaussian_blur(T(x), 5, 3.0), jimg.gaussian_blur(jnp.asarray(x), 5, 3.0), atol=1e-4)


def test_compute_difference_uint8_wrap_matches_jax():
    """uint8 wraparound of the difference and its square, blur, truncation:
    exact agreement on uint8-valued inputs."""
    rs = np.random.RandomState(14)
    a = rs.randint(0, 256, (2, 3, 20, 24, 3)).astype(np.float32)
    b = np.clip(a + rs.randint(-40, 40, a.shape), 0, 255).astype(np.float32)
    want = jseg.compute_difference(jnp.asarray(a), jnp.asarray(b), mode="uint8_wrap")
    got = tseg.compute_difference(T(a), T(b))
    _close(got, want, atol=0, rtol=0)
    masks = (rs.rand(2, 3, 5, 6) > 0.5).astype(np.float32)
    want = jseg.segmentation_argmax(want, masks=jnp.asarray(masks), filter_s=0.7,
                                    labels=jnp.asarray([3, 7]))
    got = tseg.segmentation_argmax(got, masks=T(masks), filter_s=0.7, labels=torch.tensor([3, 7]))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_kmeans_with_shared_init_centers_matches_jax():
    """With JAX's kmeans++ centres handed over, the Lloyd restarts and the
    best-inertia pick agree."""
    rs = np.random.RandomState(15)
    pts = np.concatenate([rs.randn(60, 8) + 4 * rs.randn(1, 8) for _ in range(3)]).astype(np.float32)
    key = jax.random.PRNGKey(5)
    want_c, want_l, want_i = jkm.kmeans_fit(key, jnp.asarray(pts), k=3)
    keys = jax.random.split(key, 10)
    init = np.array(jax.jit(jax.vmap(lambda kk: jkm._kmeanspp_init(kk, jnp.asarray(pts), 3)))(keys))
    c, labels, inertia = tkm.kmeans_fit(T(pts), 3, init_centers=T(init))
    np.testing.assert_array_equal(labels.numpy(), np.asarray(want_l))
    np.testing.assert_array_equal(tkm.kmeans_predict(c, T(pts)).numpy(),
                                  np.asarray(jkm.kmeans_predict(want_c, jnp.asarray(pts))))
    _close(c, want_c, atol=1e-4, rtol=1e-4)
    _close(inertia, want_i, atol=1e-2, rtol=1e-5)


def test_kmeans_own_seeding_finds_the_clusters():
    rs = np.random.RandomState(16)
    centers = np.array([[0, 0], [10, 0], [0, 10]], np.float32)
    pts = np.concatenate([c + 0.1 * rs.randn(30, 2) for c in centers]).astype(np.float32)
    _, labels, _ = tkm.kmeans_fit(T(pts), 3, generator=torch.Generator().manual_seed(0))
    labels = labels.numpy().reshape(3, 30)
    assert all(len(set(row)) == 1 for row in labels) and len({row[0] for row in labels}) == 3
