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
from vidseg_diffusion_tpu.ops import image as jimg
from vidseg_diffusion_tpu.ops import kmeans as jkm
from vidseg_diffusion_tpu.ops import norm as jnorm
from vidseg_diffusion_tpu.ops import temporal_conv as jtc
from vidseg_diffusion_tpu_torch.engine import segmentation as tseg
from vidseg_diffusion_tpu_torch.ops import attention as tatt
from vidseg_diffusion_tpu_torch.ops import image as timg
from vidseg_diffusion_tpu_torch.ops import kmeans as tkm
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
    """K3 has no backward yet: an input that needs one raises (naming the
    ROADMAP item) instead of returning a detached output."""
    (x,) = _arrays(24, (1, 2, 20, 16))
    xt = T(x).requires_grad_()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tatt.flash_attention(xt, xt, xt)
    with torch.no_grad():
        _close(tatt.flash_attention(xt, xt, xt), tatt.flash_attention_reference(T(x), T(x), T(x)))


# -- K3 ---------------------------------------------------------------------


@pytest.mark.parametrize("b,h,l,d", [(2, 1, 100, 128), (1, 4, 257, 16), (1, 1, 64, 512)])
def test_flash_attention_bhld_plain_matches_pallas(b, h, l, d):
    q, k, v = _arrays(l + d, (b, h, l, d), (b, h, l, d), (b, h, l, d))
    want = jatt.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), interpret=True)
    _close(tatt.flash_attention(T(q), T(k), T(v)), want)


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
