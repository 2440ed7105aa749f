"""The PyTorch port's ops against the JAX package's, on the CPU.

Inputs are numpy arrays from a seed, fed to both. The JAX Pallas kernels
run in interpret mode (interpret=True, force=True where the dispatcher would
otherwise pick the jnp path), as the JAX package's own tests run them. The
port's kernel wrappers take their plain versions on CPU tensors, so these
tests hold the plain versions (the oracles of the CUDA kernels) to the TPU
kernels' math. Everything is fp32 but the denominator tests, which need bf16
to tell the two sums apart; tolerances are stated per test. The CUDA
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


@pytest.mark.parametrize("lq", [512, 600])
def test_flash_attention_packed_one_512_head_matches_pallas(lq):
    """K1 at one 512-dim head (the VideoDecoder VideoAttnBlock's attn2 on
    [B, L, 1 x 512]): the plain version against the packed Pallas kernel in
    interpret mode, the flash sites' rounded sum (fused_psum)."""
    b, h, d = 1, 1, 512
    q, k, v = _arrays(lq + 3, (b, lq, h * d), (b, lq, h * d), (b, lq, h * d))
    want = jatt.flash_attention_packed(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), heads=h, interpret=True)
    assert tatt.site_route("blhd", b, lq, lq) == "flash"
    _close(tatt.small_batched_attention(*(T(x).reshape(b, lq, h, d) for x in (q, k, v))).reshape(b, lq, d), want)


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


@pytest.mark.parametrize("b,t,s,h,d", [(2, 3, 32, 2, 16), (1, 14, 16, 2, 8), (2, 1, 16, 1, 16),
                                       (1, 7, 32, 1, 512)])   # the VideoAttnBlock's one 512-dim head
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


# -- the softmax denominator in bf16 -------------------------------------------
#
# Each attention kernel of the port sums the denominator as the JAX kernel of
# its site does: the fp32 sum of the unrounded p (_temporal_direct_kernel for K2,
# _small_seq_kernel at K1's short sites, _flash_kernel for K3 without a
# gradient) or the sum of the p rounded to bf16 (the packed kernel's fused_psum:
# K1 at the long sites, K3 under a gradient). In fp32 the two agree, so these
# run in bf16 (inputs of std 1.5 from numpy). Bound for each: every element
# within one bf16 step of JAX's at max |JAX|, and at most 0.1 % of the
# elements differing at all (the sums run in another order; the other
# denominator puts 3-6 % of the elements a step off). The LSE of the cases
# that save one: within LSE_BF16_TOL (log2 units; reads <= 2.8e-4 at 512 keys,
# 1.3e-3 to 1.5e-3 with the other denominator).
LSE_BF16_TOL = 5e-4


def _bf16_inputs(seed, *shapes):
    return [(a * 1.5).astype(np.float32) for a in _arrays(seed, *shapes)]


def _holds_to_jax(got, want):
    got = got.float().numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32))
    diff = np.abs(got - want)
    step = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    assert diff.max() <= step, (diff.max(), step)
    assert np.mean(diff > 0) <= 1e-3, np.mean(diff > 0)


_JB = lambda a: jnp.asarray(a, jnp.bfloat16)
_TB = lambda a: T(a).bfloat16()


@pytest.mark.parametrize("t", [14, 3])
def test_temporal_attention_direct_bf16_sums_the_fp32_p(t):
    """K2's plain version against the direct-layout Pallas kernel."""
    shape = (2 * t, 32, 2, 64)
    q, k, v = _bf16_inputs(t, shape, shape, shape)
    want = jatt.temporal_attention_direct(_JB(q), _JB(k), _JB(v), t=t, force=True, interpret=True)
    _holds_to_jax(tatt.temporal_attention_direct(_TB(q), _TB(k), _TB(v), t=t), want)


@pytest.mark.parametrize("with_lse", [False, True])
def test_flash_attention_bhld_bf16_denominator(with_lse):
    """K3's plain version without a gradient against _flash_attention_impl
    (the fp32 sum); with its LSE against the packed kernel with heads = 1 and
    fused_psum (the rounded sum), as _fa_fwd runs it under a gradient. At
    D = 64: at D = 512 the summation order alone puts 0.15 % of the elements a
    step apart (test_flash_attention_bhld_plain_matches_pallas holds D = 512 in
    bf16 to two steps)."""
    b, l, d = 1 + with_lse, 256, 64
    shape = (b, 1, l, d)
    q, k, v = _bf16_inputs(d + l, shape, shape, shape)
    if not with_lse:
        want = jatt._flash_attention_impl(_JB(q), _JB(k), _JB(v), interpret=True)
        _holds_to_jax(tatt.flash_attention(_TB(q), _TB(k), _TB(v)), want)
        return
    flat = lambda a: _JB(a).reshape(b, l, d)
    want, lse = jatt._flash_attention_packed_impl(flat(q), flat(k), flat(v), heads=1, save_lse=True,
                                                  fused_psum=True, interpret=True)
    got, got_lse = tatt.flash_attention_reference(_TB(q), _TB(k), _TB(v), save_lse=True)
    _holds_to_jax(got.reshape(b, l, d), want)
    assert np.abs(got_lse.numpy().reshape(b, l) - np.asarray(lse).reshape(b, l)).max() <= LSE_BF16_TOL


@pytest.mark.parametrize("route", ["short", "long"])
def test_flash_attention_packed_bf16_denominator(route):
    """K1 through small_batched_attention, the port's route for every blhd
    site: at a short site (max(Lq, Lk) < 512) against the folded tiny-seq
    Pallas kernel (the fp32 sum); at a long one, with the LSE that K5 reads,
    against the packed kernel with fused_psum (the rounded sum)."""
    if route == "short":
        shape = (4, 91, 4, 64)
        q, k, v = _bf16_inputs(5, shape, shape, shape)
        want = jatt.small_batched_attention(_JB(q), _JB(k), _JB(v), interpret=True)
        _holds_to_jax(tatt.small_batched_attention(_TB(q), _TB(k), _TB(v)), want)
        return
    b, lq, lk, h = 2, 640, 576, 2   # both lengths >= 512: JAX's dispatch runs the packed kernel here
    (q,) = _bf16_inputs(1, (b, lq, h * 64))
    k, v = _bf16_inputs(2, (b, lk, h * 64), (b, lk, h * 64))
    want, lse = jatt._flash_attention_packed_impl(_JB(q), _JB(k), _JB(v), heads=h, save_lse=True,
                                                  fused_psum=True, interpret=True)
    blhd = lambda a, l: _TB(a).reshape(b, l, h, 64)
    _holds_to_jax(tatt.small_batched_attention(blhd(q, lq), blhd(k, lk), blhd(v, lk)).reshape(b, lq, -1), want)
    _, got_lse = tatt.flash_attention_packed_reference(_TB(q), _TB(k), _TB(v), h, save_lse=True)
    assert np.abs(got_lse.numpy() - np.asarray(lse)).max() <= LSE_BF16_TOL


@pytest.mark.parametrize("site", ["temporal", "short", "long", "one_512_head"])
def test_new_head_dims_sum_the_denominator_of_their_jax_kernel(site):
    """The plain versions the card's new head-dim instances are held to, in
    bf16 against the JAX kernel of their site: 16-dim heads at a temporal site
    (the direct kernel, the fp32 sum), a short blhd site (the folded tiny-seq
    kernel, the fp32 sum) and a long one (the packed kernel with fused_psum, the
    rounded sum); one 512-dim blhd head (the VideoAttnBlock's attn2: the packed
    kernel with fused_psum), at _holds_to_jax's bound."""
    if site == "temporal":
        t, shape = 14, (28, 32, 2, 16)
        q, k, v = _bf16_inputs(31, shape, shape, shape)
        want = jatt.temporal_attention_direct(_JB(q), _JB(k), _JB(v), t=t, force=True, interpret=True)
        _holds_to_jax(tatt.temporal_attention_direct(_TB(q), _TB(k), _TB(v), t=t), want)
        return
    if site == "short":
        shape = (6, 64, 2, 16)
        q, k, v = _bf16_inputs(32, shape, shape, shape)
        want = jatt.small_batched_attention(_JB(q), _JB(k), _JB(v), interpret=True)
        _holds_to_jax(tatt.small_batched_attention(_TB(q), _TB(k), _TB(v)), want)
        return
    b, l, h, d = (2, 600, 2, 16) if site == "long" else (1, 520, 1, 512)
    q, k, v = _bf16_inputs(33, *[(b, l, h * d)] * 3)
    want = jatt._flash_attention_packed_impl(_JB(q), _JB(k), _JB(v), heads=h, fused_psum=True, interpret=True)
    blhd = lambda a: _TB(a).reshape(b, l, h, d)
    assert tatt.site_route("blhd", b, l, l) == "flash"
    _holds_to_jax(tatt.small_batched_attention(blhd(q), blhd(k), blhd(v)).reshape(b, l, -1), want)


# -- the normalise-first route (JAX's mha_reference sites) ----------------------


@pytest.mark.parametrize("layout,shape", [
    ("blhd", (2, 640, 77, 2, 64)),    # the SD 2.1 cross-attention's 77 keys: one key tile
    ("blhd", (2, 640, 300, 2, 64)),   # keys over several tiles: the two-pass walk
    ("bhld", (1, 2, 257, 257, 80)),   # CLIP ViT-H's 257 tokens at D = 80
    ("blhd", (2, 639, 77, 2, 64)),    # a ragged query tail (the last 64-row tile has 63 rows)
    ("blhd", (1, 600, 80, 2, 64)),    # 80 keys: the most one 80-key product holds
    ("blhd", (1, 600, 81, 2, 64)),    # 81: one 128-key product
    ("blhd", (1, 600, 129, 2, 64)),   # 129: past one product, keys streamed in 128-key tiles (m, l first)
    ("blhd", (1, 520, 511, 1, 64)),   # 511 keys streamed
    ("bhld", (2, 2, 257, 257, 64)),   # CLIP ViT-L/14 (the safety filter) at D = 64
    ("bhld", (1, 2, 250, 300, 80)),   # D = 80, a ragged 32-row tile, Lk > 256 off the 32-key steps
    # the resident kernels' edges: D = 64 holds up to 128 keys in one S product of 80 or 128 keys over a
    # persistent walk of 64-row query tiles; D = 80 up to 512 keys in 32-key steps over 32-row tiles
    ("blhd", (1, 512, 2, 8, 64)),     # two keys, the fewest the route takes (one key is site_route's one_key)
    ("blhd", (1, 513, 64, 4, 64)),    # a one-row last tile
    ("blhd", (2, 575, 79, 2, 64)),    # 79 keys, a 63-row last tile
    ("blhd", (1, 520, 127, 3, 64)),   # one key under a 128-key product
    ("blhd", (1, 512, 128, 4, 64)),   # a full 128-key product
    ("blhd", (2, 1000, 100, 3, 64)),  # three heads a row: the walk crosses (batch, head) inside a block
    ("bhld", (1, 4, 100, 77, 64)),    # K3 at D = 64, 77 keys: the resident kernel through K3's strides
    ("bhld", (1, 4, 200, 128, 64)),
    ("bhld", (1, 8, 33, 2, 80)),      # D = 80, two keys
    ("bhld", (1, 8, 31, 32, 80)),     # one full 32-key step, a ragged 32-row tile
    ("bhld", (1, 8, 64, 33, 80)),     # a step and one key
    ("bhld", (1, 3, 300, 256, 80)),   # eight full steps
    ("bhld", (2, 1, 97, 200, 80)),    # two batch items, a ragged tile
    ("bhld", (1, 2, 40, 511, 80)),    # sixteen steps, the last one key short
    ("bhld", (1, 2, 100, 480, 80)),   # fifteen steps
])
def test_normalise_first_route_matches_mha_reference(layout, shape):
    """Where JAX's TPU dispatch sends a site to mha_reference (lengths on both
    sides of 512, bhld shorter than 512), the port's normalise-first plain
    version (K1 through small_batched_attention, which takes the route from
    site_route; K3 with normalise_first) holds to JAX's mha_reference in bf16
    at _holds_to_jax's bound. The flash sums put 56-61 % of the elements a
    step off here."""
    if layout == "blhd":
        b, lq, lk, h, d = shape
        q, k, v = _bf16_inputs(lk, (b, lq, h, d), (b, lk, h, d), (b, lk, h, d))
        assert tatt.site_route("blhd", b, lq, lk) == "mha_reference"
        got = tatt.small_batched_attention(_TB(q), _TB(k), _TB(v))
    else:
        b, h, lq, lk, d = shape
        q, k, v = _bf16_inputs(lk, (b, h, lq, d), (b, h, lk, d), (b, h, lk, d))
        assert tatt.site_route("bhld", b, lq, lk) == "mha_reference"
        got = tatt.flash_attention(_TB(q), _TB(k), _TB(v), normalise_first=True)
    _holds_to_jax(got, jatt.mha_reference(_JB(q), _JB(k), _JB(v), layout=layout))


def _grads_held_to_jax(got, want):
    """_holds_to_jax's bound on each gradient: within one bf16 step at its max
    |want|, at most 0.1 % of the elements differing; returns whether it held."""
    for g_, w_ in zip(got, want):
        g_, w_ = g_.float().numpy(), np.asarray(jnp.asarray(w_, jnp.float32))
        diff = np.abs(g_ - w_)
        step = 2.0 ** (np.floor(np.log2(np.abs(w_).max())) - 7)
        if diff.max() > step or np.mean(diff > 0) > 1e-3:
            return False
    return True


@pytest.mark.parametrize("layout,shape", [
    ("blhd", (2, 640, 77, 2, 64)),    # the SD 2.1 cross-attention's 77 keys
    ("blhd", (2, 640, 300, 2, 64)),   # keys over several tiles
    ("bhld", (1, 2, 257, 257, 80)),   # CLIP ViT-H's 257 tokens at D = 80
])
def test_mha_reference_site_gradients_match_jax_grad(layout, shape):
    """Under a gradient, a site JAX's TPU dispatch sends to mha_reference runs
    mha_reference_site (counted apart from the plain versions), and its
    gradients hold to jax.grad through JAX's mha_reference in bf16 at
    _holds_to_jax's bound; the flash route it replaced (K1 / K3 with the LSE,
    then the K5 / K13 plain backward) misses that bound."""
    if layout == "blhd":
        b, lq, lk, h, d = shape
        sq, sk = (b, lq, h, d), (b, lk, h, d)
    else:
        b, h, lq, lk, d = shape
        sq, sk = (b, h, lq, d), (b, h, lk, d)
    q, k, v, g = _bf16_inputs(lk, sq, sk, sk, sq)
    assert tatt.site_route(layout, b, lq, lk) == "mha_reference"
    loss = lambda *x: jnp.sum(jatt.mha_reference(*x, layout=layout).astype(jnp.float32) * _JB(g).astype(jnp.float32))
    want = jax.grad(loss, argnums=(0, 1, 2))(_JB(q), _JB(k), _JB(v))

    def grads(fn):
        xs = [_TB(a).requires_grad_() for a in (q, k, v)]
        fn(*xs).backward(_TB(g))
        return [x.grad for x in xs]

    calls = tatt.mha_reference_site.calls, tatt.mha_reference.calls
    if layout == "blhd":
        got = grads(tatt.small_batched_attention)
        flat = lambda x: x.reshape(b, x.shape[1], h * d)
        old = grads(lambda *x: tatt._FlashAttentionPacked.apply(*map(flat, x), h, None, max(lq, lk) >= 512).reshape(sq))
    else:
        assert tatt._runs_mha_reference("bhld", *(_TB(a).requires_grad_() for a in (q, k, v)))
        got = grads(lambda *x: tatt.mha_reference_site(*x, layout="bhld"))
        old = grads(lambda *x: tatt._FlashAttention.apply(*x, None))
    assert (tatt.mha_reference_site.calls, tatt.mha_reference.calls) == (calls[0] + 1, calls[1])
    assert _grads_held_to_jax(got, want)
    assert not _grads_held_to_jax(old, want)


@pytest.mark.parametrize("layout,shape,dtype,runs_site", [
    ("bhld", (1, 1, 300, 512), torch.bfloat16, True),    # a VAE attention of a frame under 181 x 181 px
    ("bhld", (1, 16, 257, 80), torch.bfloat16, False),   # CLIP: K3's normalise-first mode
    ("bhld", (1, 1, 300, 512), torch.float32, False),    # fp32: the FMA kernel serves the site
    ("blhd", (1, 91, 4, 40), torch.bfloat16, True),      # one video item, 40-dim heads
    ("blhd", (2, 640, 2, 64), torch.bfloat16, False),    # K1's normalise-first mode
    ("blhd", (1, 91, 2, 16), torch.bfloat16, False),     # the tiny configs' heads: K1's mma.sync mode
    ("bhld", (1, 4, 257, 16), torch.bfloat16, False),    # a tiny CLIP tower: K3's mma.sync mode
    ("blhd", (1, 91, 1, 512), torch.bfloat16, True),     # one 512-dim head: no normalise-first kernel
    ("blhd", (1, 91, 1, 512), torch.float32, False),     # fp32: the FMA kernel serves it
    ("blhd", (1, 91, 2, 512), torch.float32, True),      # 512 at two heads: no kernel at all
])
def test_mha_reference_sites_run_where_no_normalise_first_kernel_takes_them(layout, shape, dtype, runs_site):
    """Without a gradient, an "mha_reference" site runs mha_reference_site
    only where no normalise-first kernel takes its dtype and head dim."""
    x = torch.zeros(shape, dtype=dtype)
    lq = shape[2] if layout == "bhld" else shape[1]
    assert tatt.site_route(layout, shape[0], lq, lq if lq != 640 else 77) == "mha_reference"
    assert tatt._runs_mha_reference(layout, x, x, x) == runs_site


def test_flash_sites_refuse_head_dims_no_kernel_takes():
    """A "flash" / "small_batched" site whose head dim no kernel takes is refused
    by name (route, shape, the D the kernels take, ROADMAP section C) before any
    launch; the check reads the shape alone."""
    with pytest.raises(ValueError, match=r"'flash' attention site: head dim 40 .*\(16, 64, 512\).*"
                                         r"\(512,\) at one head only.*ROADMAP section C"):
        tatt._check_head_dim("'flash' attention site", "blhd", (2, 640, 4, 40), 40, 4)
    with pytest.raises(ValueError, match=r"head dim 128 .*\(16, 64, 80, 512\)"):
        tatt._check_head_dim("'flash' attention site", "bhld", (1, 1, 640, 128), 128)
    tatt._check_head_dim("temporal attention site", "temporal", (28, 91, 5, 64), 64)


# the head dims the configs produce at kernel sites (16: the tiny configs; 64;
# CLIP's 80 at bhld; 512: the VAE's bhld sites and the VideoDecoder's
# VideoAttnBlock, one blhd head and its temporal site, forward and, since the
# SVD first stage trains, backward): (kind, D, heads, forward, backward); 40
# and 128 stay refused, and 512 at more than one blhd head
HEAD_DIM_TABLE = [
    ("blhd", 16, 4, True, True), ("blhd", 64, 5, True, True), ("blhd", 512, 1, True, True),
    ("blhd", 512, 2, False, False), ("blhd", 80, 16, False, False), ("blhd", 40, 4, False, False),
    ("temporal", 16, 2, True, True), ("temporal", 64, 5, True, True), ("temporal", 512, 1, True, True),
    ("temporal", 80, 1, False, False), ("temporal", 40, 1, False, False),
    ("bhld", 16, 4, True, True), ("bhld", 64, 1, True, True), ("bhld", 80, 16, True, True),
    ("bhld", 512, 1, True, True), ("bhld", 40, 4, False, False), ("bhld", 128, 1, False, False),
]


@pytest.mark.parametrize("kind,d,heads,forward,backward", HEAD_DIM_TABLE)
def test_head_dims_admitted_are_the_configs(kind, d, heads, forward, backward):
    """_check_head_dim admits exactly the table: forward K1 at D in {16, 64,
    512 at one head}, K2 at {16, 64, 512}, K3 at {16, 64, 80, 512}; backward
    K5 at {16, 64, 512 at one head (K13's kernels)}, K6 at {16, 64, 512}, K13
    at all four; every other D gets the named ValueError."""
    shape = (2, 640, heads, d)
    for backward_kernels, admitted in ((False, forward), (True, backward)):
        if admitted:
            tatt._check_head_dim("site", kind, shape, d, heads, backward=backward_kernels)
        else:
            with pytest.raises(ValueError, match=rf"site: head dim {d} .*ROADMAP section C"):
                tatt._check_head_dim("site", kind, shape, d, heads, backward=backward_kernels)


def test_every_config_head_dim_is_admitted():
    """The head dims of every shipped inference config's UNet attention (its
    num_head_channels) and of the SVD VAE's one head are in HEAD_DIMS at the
    sites that run them."""
    import glob
    import os

    import yaml

    seen = set()
    for path in glob.glob(os.path.join(os.path.dirname(__file__), "..", "configs", "inference", "*.yaml")):
        with open(path) as f:
            net = yaml.safe_load(f)["model"]["params"]["network_config"]["params"]
        if "num_head_channels" in net and net["num_head_channels"] > 0:
            seen.add(net["num_head_channels"])
    assert seen and seen <= {16, 64}
    for d in seen:
        for kind in ("blhd", "temporal", "bhld"):
            tatt._check_head_dim("site", kind, (2, 640, 1, d), d)


# every attention site of the four paths at full width (B = 28 is the CFG batch
# of 14 frames and the training batch of 2 x 14 frames; SD 2.1's 77-token text
# context; CLIP ViT-H; the VAE's one 512-dim head at 448x832 and in ae_grad's
# 64x64), then the edges: one video item at the mid level, and 511 / 512
ROUTE_SITES = [
    ("blhd", 28, 5824, 5824), ("blhd", 28, 1456, 1456), ("blhd", 28, 364, 364), ("blhd", 28, 91, 91),
    ("blhd", 28, 5824, 1), ("blhd", 28, 91, 1), ("blhd", 28, 5824, 77), ("blhd", 28, 1456, 77),
    ("blhd", 28, 364, 77), ("blhd", 28, 91, 77), ("blhd", 2, 5824, 5824),
    ("bhld", 1, 257, 257), ("bhld", 7, 5824, 5824), ("bhld", 2, 5824, 5824), ("bhld", 2, 64, 64),
    ("blhd", 1, 91, 91), ("blhd", 1, 91, 77), ("blhd", 2, 91, 91), ("blhd", 28, 16, 16), ("blhd", 3, 37, 37),
    ("blhd", 2, 511, 511), ("blhd", 2, 512, 512), ("blhd", 2, 512, 511), ("blhd", 2, 511, 512),
    ("blhd", 1, 600, 77), ("blhd", 2, 77, 600), ("bhld", 1, 511, 511), ("bhld", 1, 512, 512),
    ("bhld", 1, 512, 511), ("bhld", 2, 5824, 1),
]


@pytest.mark.parametrize("layout,b,lq,lk", ROUTE_SITES)
def test_site_route_is_jax_tpu_dispatch(monkeypatch, layout, b, lq, lk):
    """JAX's dot_product_attention with the backend reported as "tpu" and its
    four targets replaced by recorders (traced by jax.eval_shape: nothing is
    computed) calls the function the port's site_route names."""
    called = []

    def recorder(name):
        def record(q, k, v, *args, **kwargs):
            called.append(name)
            return jnp.zeros(q.shape, q.dtype)
        return record

    for attr, name in (("small_batched_attention", "small_batched"), ("flash_attention_packed", "flash"),
                       ("flash_attention", "flash"), ("mha_reference", "mha_reference")):
        monkeypatch.setattr(jatt, attr, recorder(name))
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    h, d = (16, 80) if layout == "bhld" and lq == 257 else (1 if layout == "bhld" else 5, 64)
    dims = (lambda l: (b, h, l, d)) if layout == "bhld" else (lambda l: (b, l, h, d))
    spec = lambda l: jax.ShapeDtypeStruct(dims(l), jnp.bfloat16)
    jax.eval_shape(lambda q, k, v: jatt.dot_product_attention(q, k, v, layout=layout),
                   spec(lq), spec(lk), spec(lk))
    assert called == ([] if lk == 1 else [tatt.site_route(layout, b, lq, lk)])
    assert lk == 1 or tatt.site_route(layout, b, lq, lk) != "one_key"


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
    _gn_backward_vs_pallas(shape, groups, dt, tol)


@pytest.mark.parametrize("dt,tol", [("fp32", 2e-5), ("bf16", 5e-2)])
def test_group_norm_backward_matches_pallas_at_a_cluster_slab(dt, tol):
    """The same at [2, 48, 48, 320], 32 groups, whose backward the card runs on
    a cluster of two blocks (the 369 KB slab of x and dy over four groups of ten
    channels, two in fp32, is more than one block holds): the coefficient form
    held to JAX's Pallas backward at a multi-block slab's row count."""
    shape = (2, 48, 48, 320)
    itemsize = 4 if dt == "fp32" else 2
    route, plan = tnorm.group_norm_backward_route(2, 48 * 48, 320, 32, itemsize, True)
    assert (route, plan.n) == ("cluster", 2)
    _gn_backward_vs_pallas(shape, 32, dt, tol)


def _gn_backward_vs_pallas(shape, groups, dt, tol):
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


# the backward's route at chip_smoke.py's GroupNorm sites, the null-text
# inversion's at 512x512 (UNet ds1, its concatenation, ds2), the autoencoder
# step's (2 frames of 448x832: the first stage at 112x208 x 512, 224x416 x 256,
# 448x832 x 128) and the edges: with 64 bf16 (32 fp32) channels a group, rows
# of 128 bytes, one block holds 868 rows of x and dy, two blocks one row more,
# a cluster of 16 blocks 13888 rows and no cluster 13889 (17 blocks' worth);
# rows narrower than 32 bytes take the stream route (TMA moves them row by row),
# and so does a slab that needs a cluster of 8 or more over 128 (sample, slab)
# items or more (K9 + K10 read faster there on the card).
# (shape, itemsize, route, blocks a cluster, pointers)
GN_BWD_ROUTE_SITES = [
    ((28, 56, 104, 320), 2, "stream", 0, None),      # ds1: 4 groups of 10 channels, 910 KB: cluster 8, 224 items
    ((28, 56, 104, 960), 2, "stream", 0, None),      # ds1 concat: 2.8 MB: cluster 16, 224 items
    ((28, 28, 52, 640), 2, "cluster", 2, None),      # ds2: 233 KB
    ((28, 28, 52, 1920), 2, "cluster", 4, None),     # ds2 concat: 699 KB
    ((28, 14, 26, 1280), 2, "fused", 1, None),       # ds4: 58 KB
    ((28, 7, 13, 1280), 2, "fused", 1, None),        # mid: 15 KB
    ((28, 7, 13, 2560), 2, "fused", 1, None),        # ds8 concat: 29 KB
    ((2, 14, 7, 13, 1280), 2, "fused", 1, None),     # time_stack ds8: 204 KB beside the sums
    ((2, 14, 14, 26, 1280), 2, "cluster", 4, None),  # time_stack ds4: 815 KB
    ((7, 56, 104, 512), 2, "cluster", 2, None),      # VAE mid: 373 KB
    ((2, 64, 64, 320), 2, "cluster", 4, None),       # NTI ds1: 655 KB
    ((2, 64, 64, 960), 2, "cluster", 16, None),      # NTI ds1 concat: 1.97 MB
    ((2, 32, 32, 640), 2, "fused", 1, None),         # NTI ds2: 164 KB
    ((2, 112, 208, 512), 2, "cluster", 8, None),     # autoencoder: 1.49 MB, 64 items
    ((2, 112, 208, 512), 4, "cluster", 16, None),    # the same in fp32: 2.98 MB
    ((2, 224, 416, 256), 2, "stream", 0, None),      # autoencoder: 2.98 MB, but rows of 16 bytes (one group)
    ((2, 14, 56, 104, 320), 2, "stream", 0, None),   # time_stack ds1: 13 MB
    ((7, 448, 832, 128), 2, "stream", 0, None),      # VAE
    ((1, 7, 448, 832, 128), 2, "stream", 0, None),   # VAE time_stack
    ((2, 448, 832, 128), 2, "stream", 0, None),      # autoencoder at 448x832
    ((2, 48, 48, 320), 2, "cluster", 2, None),       # the CPU test's multi-block slab: 369 KB
    ((2, 96, 96, 64), 2, "stream", 0, None),         # 288 KB, but rows of 16 bytes (four groups of two channels)
    ((2, 96, 96, 512), 2, "cluster", 4, None),       # one group of 16 channels: rows of 32 bytes, the narrowest taken
    ((28, 56, 104, 320), 4, "stream", 0, None),      # ds1 fp32: 932 KB: cluster 8, 448 items
    ((2, 96, 96, 512), 4, "cluster", 8, None),       # fp32 rows of 64 bytes, 64 items
    ((3, 5000, 2048), 2, "cluster", 8, None),        # cluster 8 over 96 items
    ((4, 5000, 2048), 2, "stream", 0, None),         # cluster 8 over 128 items: the stream route
    ((28, 7, 13, 1280), 4, "fused", 1, None),        # mid fp32: 29 KB
    ((2, 14, 7, 13, 1280), 4, "cluster", 2, None),   # time_stack ds8 fp32: 408 KB
    ((2, 14, 56, 104, 320), 4, "stream", 0, None),   # time_stack ds1 fp32
    ((2, 868, 2048), 2, "fused", 1, None),           # the last slab one block holds
    ((2, 869, 2048), 2, "cluster", 2, None),         # one row more
    ((2, 13888, 2048), 2, "cluster", 16, None),      # a cluster of exactly 16
    ((2, 13889, 2048), 2, "stream", 0, None),        # 17 blocks' worth
    ((28, 7, 13, 1280), 2, "stream", 0, "unaligned"),  # x off a 16-byte boundary: element loads
]


@pytest.mark.parametrize("shape,itemsize,route,n,arg", GN_BWD_ROUTE_SITES)
def test_group_norm_backward_route_sends_each_site_where_it_fits(shape, itemsize, route, n, arg):
    """group_norm_backward_route (32 groups): the slab kernel with its cluster
    size where one sample's slab of x and dy fits in the shared memory of a
    block or a cluster, within the 227 KB a block may take, its blocks'
    rows covering R (none left empty) in TMA boxes of up to 256 rows of 16-byte
    multiples; else K9 + K10 with a plan that covers every row."""
    b, c = shape[0], shape[-1]
    r = int(np.prod(shape)) // (b * c)
    got, plan = tnorm.group_norm_backward_route(b, r, c, 32, itemsize, arg != "unaligned")
    assert got == route
    if route == "stream":
        vec, rows, chunks = plan
        assert vec == (1 if arg == "unaligned" else 16 // itemsize)
        assert rows * chunks >= r > rows * (chunks - 1)
        assert b * chunks <= tnorm._BWD_STATS_TARGET_BLOCKS   # one wave: K9's last block finds every partial
        return
    w = plan.gc * (c // 32)
    assert plan.n == n and plan.n * plan.rows >= r > (plan.n - 1) * plan.rows
    assert w * itemsize % 16 == 0 and w <= 256 and 32 % plan.gc == 0
    assert plan.box_rows <= 256 and plan.rows % plan.box_rows == 0 and plan.rows // plan.box_rows <= 32
    assert 2 * plan.rows * w * itemsize < plan.smem <= tnorm._BWD_SMEM_MAX


@pytest.mark.parametrize("shape,itemsize,route,n,arg", [c for c in GN_BWD_ROUTE_SITES if c[2] != "stream"])
def test_group_norm_backward_route_takes_the_stream_route_where_the_card_places_nothing(shape, itemsize, route, n,
                                                                                         arg):
    """A card that answers it places no block or cluster of a site's slab plan
    (a MIG slice; a part with fewer SMs a GPC than a cluster of 8 or 16
    needs) sends every slab site to K9 + K10 before any launch, with the
    stream route's plan, and counts it (.unplaced); a card that places only
    clusters of up to 4 keeps the one-block and the 2- and 4-block sites and
    sends the 8- and 16-block ones (the autoencoder's [2, 112, 208, 512], the
    NTI's concatenation) to the stream route; the query is asked with the
    plan's cluster size and shared memory."""
    b, c = shape[0], shape[-1]
    r = int(np.prod(shape)) // (b * c)
    asked = []

    def none(n_, smem):
        asked.append((n_, smem))
        return 0

    unplaced = tnorm.group_norm_backward_route.unplaced
    got, plan = tnorm.group_norm_backward_route(b, r, c, 32, itemsize, True, none)
    stream_plan = tnorm._plan(b, r, c, itemsize, True, tnorm._BWD_STATS_TARGET_BLOCKS)
    assert (got, plan) == ("stream", stream_plan)
    assert tnorm.group_norm_backward_route.unplaced == unplaced + 1
    shape_plan = tnorm.group_norm_backward_route(b, r, c, 32, itemsize, True)[1]
    assert asked == [(n, shape_plan.smem)]
    small = lambda n_, smem: 132 if n_ <= 4 else 0
    got, plan = tnorm.group_norm_backward_route(b, r, c, 32, itemsize, True, small)
    assert (got, plan) == ((route, shape_plan) if n <= 4 else ("stream", stream_plan))


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
