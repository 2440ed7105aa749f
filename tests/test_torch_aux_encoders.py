"""The port's auxiliary encoders (vidseg_diffusion_tpu_torch/models/aux_encoders.py)
against the JAX package's models/aux_encoders.py on the same weights and
inputs (numpy, seeded; weights moved by io/convert.py's module_key_fn).

Tolerances: the embedding table lookups and routing bit for bit; the
SpatialRescaler's resizes and channel_mapper conv within 1e-5 of max |JAX|
(fp32 weight-matrix products, summed in another order); the LowScaleEncoder
within 1e-6 of max |JAX| on the noise levels and noise JAX draws from its key.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vidseg_diffusion_tpu.models import aux_encoders as jaux
from vidseg_diffusion_tpu.models.conditioner import Conditioner as JConditioner
from vidseg_diffusion_tpu.models.conditioner import EmbedderSpec as JSpec
from vidseg_diffusion_tpu_torch.io import convert
from vidseg_diffusion_tpu_torch.models import aux_encoders as taux
from vidseg_diffusion_tpu_torch.models.conditioner import Conditioner, EmbedderSpec

RESCALE_RTOL = 1e-5
LOW_SCALE_RTOL = 1e-6


def _close(got, want, rtol):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= rtol * max(float(np.abs(want).max()), 1e-30), err


def _load(module, params):
    sd = convert.jax_to_state_dict(jax.tree.map(np.asarray, params), convert.module_key_fn)
    module.load_state_dict({k: torch.tensor(v) for k, v in sd.items()})
    return module


@pytest.mark.parametrize("add_sequence_dim", [False, True])
def test_class_embedder_and_unconditional_class(add_sequence_dim):
    jm = jaux.ClassEmbedder(embed_dim=16, n_classes=10, add_sequence_dim=add_sequence_dim)
    labels = np.array([1, 9, 0, 4], np.int32)
    params = jm.init(jax.random.PRNGKey(3), jnp.asarray(labels))["params"]
    tm = _load(taux.ClassEmbedder(16, n_classes=10, add_sequence_dim=add_sequence_dim), params)
    uc_j = np.asarray(jm.get_unconditional_class(4))
    uc_t = tm.get_unconditional_class(4)
    assert uc_t.dtype == torch.int32 and uc_t.tolist() == uc_j.tolist() == [9] * 4
    for c in (labels, uc_j):
        want = np.asarray(jm.apply({"params": params}, jnp.asarray(c)))
        with torch.no_grad():
            np.testing.assert_array_equal(tm(torch.from_numpy(c)).numpy(), want)
    assert want.shape == ((4, 1, 16) if add_sequence_dim else (4, 16))


@pytest.mark.parametrize("multiplier", [0.5, 0.75])
@pytest.mark.parametrize("method", sorted(jaux._RESIZE_METHOD))
def test_spatial_rescaler_matches_jax(method, multiplier):
    """Two stages of every resize method, on images and (wrap_video) videos,
    with the channel mapper (3x3, bias) remapping 3 -> 5 channels."""
    assert taux._RESIZE_METHOD == jaux._RESIZE_METHOD
    rng = np.random.RandomState(0)
    x = rng.rand(2, 12, 20, 3).astype(np.float32)
    xv = rng.rand(1, 2, 12, 20, 3).astype(np.float32)
    kw = dict(n_stages=2, method=method, multiplier=multiplier)
    plain_j = jaux.SpatialRescaler(**kw)
    plain_t = taux.SpatialRescaler(**kw)
    want = plain_j.apply(plain_j.init(jax.random.PRNGKey(0), jnp.asarray(x)), jnp.asarray(x))
    with torch.no_grad():
        _close(plain_t(torch.from_numpy(x)), want, RESCALE_RTOL)

    remap = dict(kw, out_channels=5, bias=True, wrap_video=True, kernel_size=3, remap_output=True)
    jm = jaux.SpatialRescaler(**remap)
    params = jm.init(jax.random.PRNGKey(1), jnp.asarray(xv))["params"]
    params = jax.tree.map(lambda p: p + 0.1, params)   # a nonzero bias
    tm = _load(taux.SpatialRescaler(in_channels=3, **remap), params)
    for inp in (xv, x):
        want = jm.apply({"params": params}, jnp.asarray(inp))
        with torch.no_grad():
            _close(tm(torch.from_numpy(inp)), want, RESCALE_RTOL)


def test_low_scale_encoder_on_jax_draws():
    """LowScaleEncoder with the noise level and noise JAX draws from its key:
    the q_sample at those levels, the nearest resize to out_size, the levels
    returned; decode divides by the scale factor."""
    kw = dict(out_size=6, scale_factor=0.5, max_noise_level=20, timesteps=100, linear_start=1e-4,
              linear_end=2e-2)
    encode = lambda x: x[:, ::2, ::2, :2] * 1.5
    jenc = jaux.LowScaleEncoder(encode_fn=encode, decode_fn=lambda z: z, **kw)
    tenc = taux.LowScaleEncoder(encode_fn=encode, decode_fn=lambda z: z, **kw)
    x = np.random.RandomState(2).uniform(-1, 1, (3, 8, 8, 3)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    z_j, lvl_j = jenc(jnp.asarray(x), key)
    k_t, k_n = jax.random.split(key)
    lvl = np.array(jax.random.randint(k_t, (3,), 0, kw["max_noise_level"]))
    noise = np.array(jax.random.normal(k_n, (3, 4, 4, 2), jnp.float32))
    np.testing.assert_array_equal(lvl, np.asarray(lvl_j))
    z_t, lvl_t = tenc(torch.from_numpy(x), noise_level=torch.from_numpy(lvl), noise=torch.from_numpy(noise))
    assert lvl_t.tolist() == lvl.tolist()
    _close(z_t, z_j, LOW_SCALE_RTOL)
    assert tuple(z_t.shape) == (3, 6, 6, 2)
    _close(tenc.decode(z_t), jenc.decode(z_j), LOW_SCALE_RTOL)
    t = np.array([0, 7, 19])
    _close(tenc.q_sample(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(x[::-1].copy())),
           jenc.q_sample(jnp.asarray(x), jnp.asarray(t), jnp.asarray(x[::-1].copy())), LOW_SCALE_RTOL)
    # drawn from a generator: levels in range, finite
    z_g, lvl_g = tenc(torch.from_numpy(x), generator=torch.Generator().manual_seed(0))
    assert ((lvl_g >= 0) & (lvl_g < kw["max_noise_level"])).all() and torch.isfinite(z_g).all()


def test_identity_and_clip_t5_pair_routing():
    """The (clip, t5) pair through one embedder: both outputs routed to
    crossattn and concatenated on the feature axis, as JAX's Conditioner does;
    the force-zeroed key zeroes both."""
    x = np.arange(6.0, dtype=np.float32).reshape(2, 3)
    assert taux.identity_encoder(x) is x
    clip_np = lambda t: np.ones((t.shape[0], 7, 4), np.float32) * t[:, :1, None]
    t5_np = lambda t: 2.0 * np.ones((t.shape[0], 7, 6), np.float32) + t[:, :1, None]
    pair = (np.array([[3, 1], [5, 2]], np.int32), np.array([[1, 0, 0], [2, 0, 0]], np.int32))
    jc = JConditioner(embedders=(JSpec("txt_pair", jaux.clip_t5_text_fn(lambda t: jnp.asarray(clip_np(np.asarray(t))),
                                                                        lambda t: jnp.asarray(t5_np(np.asarray(t))))),))
    tc = Conditioner(embedders=(EmbedderSpec("txt_pair", taux.clip_t5_text_fn(
        lambda t: torch.from_numpy(clip_np(t)), lambda t: torch.from_numpy(t5_np(t)))),))
    for zero in ((), ("txt_pair",)):
        want = jc({"txt_pair": pair}, force_zero_embeddings=zero)
        got = tc({"txt_pair": pair}, force_zero_embeddings=zero)
        assert got.keys() == want.keys() == {"crossattn"}
        np.testing.assert_array_equal(got["crossattn"].numpy(), np.asarray(want["crossattn"]))
    assert tuple(got["crossattn"].shape) == (2, 7, 10)
