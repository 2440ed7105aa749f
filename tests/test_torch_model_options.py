"""The model options that only some configs set, held to the JAX package.

The AlphaBlender's merge_strategy 'fixed' (alpha is merge_factor, a buffer
under the reference's key) and 'learned' (sigmoid(mix_factor), no image-only
mask), and a video_kernel_size other than (3, 1, 1): (2, 1, 1) takes K4's
path with an even tap count, (3, 3, 3) and (1, 3, 3) the per-tap 2-D
convolutions JAX computes with lax.conv. Each variant is configs/inference/
svd_tiny.yaml rewritten to a temporary YAML, read by both packages'
load_model_spec; the UNet and the VideoDecoder get the same random weights
(moved by io/convert.py) and inputs, in fp32 and in bf16.

Tolerances: fp32 as tests/test_torch_models.py (MODULE_TOL 1e-4 for a
module, UNET_TOL 2e-4 for the whole UNet, absolute and relative). bf16 has
no figure there. Both packages round each op's output to bf16 in their own
order, which puts the tiny UNet's output 2-3 % (by norm) from fp32 in either
package and from each other, the default config included. So a bf16 output
is held by norm twice: to JAX's bf16 output within BF16_NORM_TOL, and to
JAX's fp32 output no farther than BF16_VS_FP32 times JAX's own bf16 output
is (the port must not round worse than JAX). Both figures were chosen from
the readings on these variants (the figures beside the constants).
"""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from vidseg_diffusion_tpu import config as jconfig
from vidseg_diffusion_tpu.models import unet as junet
from vidseg_diffusion_tpu.models import vae as jvae
from vidseg_diffusion_tpu_torch import config as tconfig
from vidseg_diffusion_tpu_torch.io import convert
from vidseg_diffusion_tpu_torch.models import layers as tl
from vidseg_diffusion_tpu_torch.models import unet as tunet
from vidseg_diffusion_tpu_torch.models import vae as tvae
from vidseg_diffusion_tpu_torch.ops import temporal_conv as ttc

MODULE_TOL = 1e-4    # fp32 modules (tests/test_torch_models.py)
UNET_TOL = 2e-4      # fp32 whole UNet (tests/test_torch_models.py)
BF16_NORM_TOL = 4e-2   # ||port - JAX|| / ||JAX|| in bf16 (read: UNet 0.025-0.029, decoder 0.025-0.027)
BF16_VS_FP32 = 1.25    # ||port - JAX fp32|| <= this x ||JAX bf16 - JAX fp32|| (read: UNet 0.86-1.01, decoder 0.85-0.87)
TINY = "configs/inference/svd_tiny.yaml"
T = 3
MERGE_FACTOR = 0.3

# (name, UNet network params, VideoDecoder params) written over svd_tiny.yaml's
VARIANTS = {
    "fixed": ({"merge_strategy": "fixed", "merge_factor": MERGE_FACTOR}, {}),
    "learned": ({"merge_strategy": "learned", "merge_factor": MERGE_FACTOR}, {}),
    "k211": ({"video_kernel_size": [2, 1, 1]}, {"video_kernel_size": [2, 1, 1]}),
    "k333": ({"video_kernel_size": [3, 3, 3]}, {"video_kernel_size": [3, 3, 3]}),
    "k133": ({"video_kernel_size": [1, 3, 3]}, {"video_kernel_size": [1, 3, 3]}),
}
KERNEL_VARIANTS = ("k211", "k333", "k133")
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _write_variant(tmp_path, name):
    with open(TINY) as f:
        root = yaml.safe_load(f)
    unet_params, dec_params = VARIANTS[name]
    params = root["model"]["params"]
    params["network_config"]["params"].update(unet_params)
    params["first_stage_config"]["params"]["decoder_config"]["params"].update(dec_params)
    path = tmp_path / f"svd_tiny_{name}.yaml"
    path.write_text(yaml.safe_dump(root))
    return str(path)


def _specs(tmp_path, name, dtype):
    path = _write_variant(tmp_path, name)
    jd, td = DTYPES[dtype]
    return jconfig.load_model_spec(path, dtype=jd), tconfig.load_model_spec(path, dtype=td)


def _init_tree(module, seed, *args, **kwargs):
    """Random numpy params in the shapes of module.init(*args) (as
    tests/test_torch_models.py draws them: weights N(0, 1/fan_in), norm
    scales 1 + N(0, 0.1), other vectors N(0, 0.05))."""
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args, **kwargs)["params"])
    rs = np.random.RandomState(seed)

    def draw(path, leaf):
        shape = leaf.shape
        if len(shape) >= 2:
            return (rs.randn(*shape) / np.sqrt(np.prod(shape[:-1]))).astype(np.float32)
        if path[-1].key == "scale":
            return (1 + 0.1 * rs.randn(*shape)).astype(np.float32)
        return (0.05 * rs.randn(*shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, flax.core.unfreeze(shapes))


def _apply(module, params, *args, **kwargs):
    return jax.jit(lambda p: module.apply({"params": p}, *args, **kwargs))(params)


def _fill_fixed_mix_factors(sd, module_keys, merge_factor):
    """An AlphaBlender with merge_strategy 'fixed' keeps alpha in a
    `mix_factor` buffer, as the reference does, where the JAX package has no
    leaf: add every `*time_mixer.mix_factor` key of the target module's state
    dict (`module_keys`) that `sd` lacks, holding [merge_factor]."""
    out = dict(sd)
    for key in module_keys:
        if key.endswith("time_mixer.mix_factor") and key not in out:
            out[key] = np.full((1,), merge_factor, np.float32)
    return out


def _load(module, tree, key_fn, merge_factor=None):
    sd = convert.jax_to_state_dict(tree, key_fn)
    if merge_factor is not None:
        sd = _fill_fixed_mix_factors(sd, module.state_dict(), merge_factor)
    module.load_state_dict({k: torch.tensor(v) for k, v in sd.items()}, strict=True)
    return module.eval()


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _hold(got, jax_out, tol, fp32_jax_out=None):
    """fp32 (fp32_jax_out None): elementwise within tol; bf16: by norm to
    JAX's bf16 output and, against JAX's fp32 output, as close as JAX's."""
    got = got.detach().float().numpy()
    want = np.asarray(jax_out, dtype=np.float32)
    assert np.isfinite(got).all()
    if fp32_jax_out is None:
        np.testing.assert_allclose(got, want, atol=tol, rtol=tol)
        return
    ref = np.asarray(fp32_jax_out)
    assert _rel(got, want) <= BF16_NORM_TOL, (_rel(got, want), _rel(got, ref), _rel(want, ref))
    assert _rel(got, ref) <= BF16_VS_FP32 * _rel(want, ref), (_rel(got, want), _rel(got, ref), _rel(want, ref))


def _unet_inputs():
    rs = np.random.RandomState(5)
    return (rs.randn(2 * T, 8, 8, 8).astype(np.float32), rs.randn(2 * T).astype(np.float32),
            rs.randn(2 * T, 1, 1024).astype(np.float32), rs.randn(2 * T, 768).astype(np.float32))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("name", list(VARIANTS))
def test_unet_variant_matches_jax(tmp_path, name, dtype):
    """The tiny video UNet under each variant against JAX's: its
    time_stack convolutions run K4's plain version at (kt, 1, 1), even kt
    included, and per-tap 2-D convolutions where kh or kw is above 1."""
    jspec, tspec = _specs(tmp_path, name, dtype)
    assert tspec.unet_config.merge_strategy == jspec.unet_config.merge_strategy
    assert tspec.unet_config.video_kernel_size == jspec.unet_config.video_kernel_size
    jm = junet.UNetModel(jspec.unet_config)
    x, ts, ctx, y = _unet_inputs()
    ioi = np.zeros((2, T), np.float32)
    params = _init_tree(jm, 9, *map(jnp.asarray, (x, ts, ctx, y)), num_video_frames=T,
                        image_only_indicator=jnp.asarray(ioi))
    fixed = tspec.unet_config.merge_strategy == "fixed"
    tm = _load(tunet.UNetModel(tspec.unet_config), params, convert.unet_key_fn,
               merge_factor=tspec.unet_config.merge_factor if fixed else None)
    mixers = [m for m in tm.modules() if isinstance(m, tl.AlphaBlender)]
    assert mixers and all(m.merge_strategy == tspec.unet_config.merge_strategy for m in mixers)
    if fixed:
        assert all(float(m.mix_factor) == pytest.approx(MERGE_FACTOR) for m in mixers)
        assert not any(n.endswith("mix_factor") for n, _ in tm.named_parameters())
    want = _apply(jm, params, *map(jnp.asarray, (x, ts, ctx, y)), num_video_frames=T,
                  image_only_indicator=jnp.asarray(ioi))
    k4, taps = ttc.temporal_conv_1x1_reference.calls, tunet.TemporalConv.conv2d_taps
    with torch.no_grad():
        got = tm(*map(torch.from_numpy, (x, ts, ctx, y)), num_video_frames=T,
                 image_only_indicator=torch.from_numpy(ioi))
    convs = [m for m in tm.modules() if isinstance(m, tunet.TemporalConv)]
    kt, kh, kw = tspec.unet_config.video_kernel_size
    if (kh, kw) == (1, 1):
        assert ttc.temporal_conv_1x1_reference.calls - k4 == len(convs)
        assert tunet.TemporalConv.conv2d_taps == taps
    else:
        assert ttc.temporal_conv_1x1_reference.calls == k4
        assert tunet.TemporalConv.conv2d_taps - taps == kt * len(convs)
    fp32 = None
    if dtype == "bfloat16":
        fp32 = _apply(junet.UNetModel(_specs(tmp_path, name, "float32")[0].unet_config), params,
                      *map(jnp.asarray, (x, ts, ctx, y)), num_video_frames=T, image_only_indicator=jnp.asarray(ioi))
    _hold(got, want, UNET_TOL, fp32)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("name", KERNEL_VARIANTS)
def test_video_decoder_variant_matches_jax(tmp_path, name, dtype):
    """The VideoDecoder with the variant's video_kernel_size in its
    time_stack convolutions and conv_out's time_mix_conv, against JAX's."""
    jspec, tspec = _specs(tmp_path, name, dtype)
    assert tspec.vae_config.video_kernel_size == tuple(VARIANTS[name][1]["video_kernel_size"])
    z = np.random.RandomState(8).randn(T, 8, 8, 4).astype(np.float32)
    jd = jvae.Decoder(jspec.vae_config)
    params = _init_tree(jd, 2, jnp.asarray(z), timesteps=T)
    td = _load(tvae.Decoder(tspec.vae_config), params, convert.vae_key_fn)
    assert td.conv_out.time_mix_conv.kernel == tspec.vae_config.video_kernel_size
    with torch.no_grad():
        got = td(torch.from_numpy(z), T)
    fp32 = None
    if dtype == "bfloat16":
        fp32 = _apply(jvae.Decoder(_specs(tmp_path, name, "float32")[0].vae_config), params, jnp.asarray(z),
                      timesteps=T)
    _hold(got, _apply(jd, params, jnp.asarray(z), timesteps=T), MODULE_TOL, fp32)


@pytest.mark.parametrize("kernel", [(2, 1, 1), (3, 1, 1), (4, 1, 1), (3, 3, 3)])
def test_temporal_conv_gradients_match_jax_vjp(kernel):
    """dx, dW and db of TemporalConv against jax.vjp of JAX's TemporalConv
    on the same weights and cotangent (fp32). At kt = 2 and 4 dx reads the
    taps one frame off unless the even tap count is handled (`_dx_taps`)."""
    rs = np.random.RandomState(21)
    x = rs.randn(2, 5, 3, 4, 6).astype(np.float32)
    g = rs.randn(2, 5, 3, 4, 8).astype(np.float32)
    jc = junet.TemporalConv(8, kernel)
    params = _init_tree(jc, 22, jnp.asarray(x))
    want, vjp = jax.vjp(lambda p, a: jc.apply({"params": p}, a), params, jnp.asarray(x))
    jgrad_p, jgrad_x = vjp(jnp.asarray(g))
    tc = _load(tunet.TemporalConv(6, 8, kernel), params, convert.unet_key_fn)
    xt = torch.from_numpy(x).requires_grad_(True)
    out = tc(xt)
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), atol=MODULE_TOL, rtol=MODULE_TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgrad_x), atol=MODULE_TOL, rtol=MODULE_TOL)
    dw = convert.to_torch_layout(np.asarray(jgrad_p["kernel"]), "kernel")
    np.testing.assert_allclose(tc.weight.grad.numpy(), dw, atol=MODULE_TOL, rtol=MODULE_TOL)
    np.testing.assert_allclose(tc.bias.grad.numpy(), np.asarray(jgrad_p["bias"]), atol=MODULE_TOL, rtol=MODULE_TOL)


@pytest.mark.parametrize("kt", [2, 4])
def test_even_kt_backward_matches_the_plain_forward_gradient(kt):
    """temporal_conv_1x1's backward (the K4 route's arithmetic, on the CPU
    its plain version) against autograd through the forward's plain version
    written without K4's tap offset: the two agree only if dx shifts by
    kt - 1 - kt//2."""
    rs = np.random.RandomState(kt)
    x = torch.from_numpy(rs.randn(2, 6, 5, 4).astype(np.float32)).requires_grad_(True)
    w = torch.from_numpy(rs.randn(kt, 4, 3).astype(np.float32)).requires_grad_(True)
    b = torch.from_numpy(rs.randn(3).astype(np.float32)).requires_grad_(True)
    g = torch.from_numpy(rs.randn(2, 6, 5, 3).astype(np.float32))
    got = torch.autograd.grad(ttc.temporal_conv_1x1(x, w, b), (x, w, b), g)
    pad = kt // 2
    xp = torch.nn.functional.pad(x, (0, 0, 0, 0, pad, pad))
    ref = sum(xp[:, j:j + 6] @ w[j] for j in range(kt)) + b
    want = torch.autograd.grad(ref, (x, w, b), g)
    for a, e in zip(got, want):
        torch.testing.assert_close(a, e, atol=1e-5, rtol=1e-5)


def test_alpha_blender_strategies_without_an_indicator():
    """'fixed' mixes with merge_factor itself (rounded to x's dtype), 'learned'
    with sigmoid(mix_factor) over the whole batch; neither reads
    image_only_indicator, so None is accepted, as in JAX."""
    rs = np.random.RandomState(3)
    xs, xt = (torch.from_numpy(rs.randn(6, 4, 8).astype(np.float32)) for _ in range(2))
    fixed = tl.AlphaBlender(MERGE_FACTOR, "fixed")
    assert "mix_factor" in dict(fixed.named_buffers()) and not list(fixed.parameters())
    torch.testing.assert_close(fixed(xs, xt, None), MERGE_FACTOR * xs + (1 - MERGE_FACTOR) * xt)
    learned = tl.AlphaBlender(MERGE_FACTOR, "learned", broadcast="b_t")
    a = torch.sigmoid(torch.tensor(MERGE_FACTOR))
    torch.testing.assert_close(learned(xs, xt, None), a * xs + (1 - a) * xt)
    xb, tb = xs.bfloat16(), xt.bfloat16()
    ab = torch.tensor(MERGE_FACTOR).bfloat16()
    assert torch.equal(fixed(xb, tb), ab * xb + (1.0 - ab) * tb)
    with pytest.raises(ValueError, match="merge_strategy"):
        tl.AlphaBlender(0.5, "mean")


def test_fixed_mix_factor_loads_from_a_reference_state_dict(tmp_path):
    """A reference (sgm) state dict carries the 'fixed' AlphaBlender's
    mix_factor buffer: it loads strictly into the port's UNet and its value
    is the one the forward mixes with; _fill_fixed_mix_factors fills the keys
    a converted JAX tree lacks from merge_factor."""
    _, tspec = _specs(tmp_path, "fixed", "float32")
    tm = tunet.UNetModel(tspec.unet_config)
    keys = [k for k in tm.state_dict() if k.endswith("time_mixer.mix_factor")]
    assert keys and any(k.startswith("middle_block.1.") for k in keys)   # SpatialVideoTransformer's too
    sd = {k: v.clone() for k, v in tm.state_dict().items()}
    for k in keys:
        sd[k] = torch.full((1,), 0.7)
    tm.load_state_dict(sd, strict=True)
    mixers = [m for m in tm.modules() if isinstance(m, tl.AlphaBlender)]
    assert all(float(m.mix_factor) == pytest.approx(0.7) for m in mixers)
    xs, xt = torch.ones(2, 3), torch.zeros(2, 3)
    torch.testing.assert_close(mixers[0](xs, xt), torch.full((2, 3), 0.7))
    without = {k: v.numpy() for k, v in sd.items() if k not in keys}
    filled = _fill_fixed_mix_factors(without, tm.state_dict(), MERGE_FACTOR)
    assert set(filled) == set(sd)
    assert all(float(filled[k][0]) == pytest.approx(MERGE_FACTOR) for k in keys)
