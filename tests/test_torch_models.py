"""The PyTorch port's modules against the JAX package's, on the CPU.

Each JAX module is initialized from a seed at a small size, its parameter
tree is moved into the port's module with io/convert.py (load_state_dict
strict: every sgm key present, none extra), both run on the same numpy
inputs in fp32, and the outputs agree within the stated tolerance. The
parameter trees take their shapes from the JAX init (jax.eval_shape, which
skips the slow eager init) and their values from numpy: no leaf is zero, so
no sub-module is an identity that would hide a mismatch. The conversion is
checked both ways: the JAX package's convert_state_dict on the port's state
dict gives back the tree.
"""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vidseg_diffusion_tpu.io.checkpoint import (
    convert_state_dict,
    unet_key_fn as j_unet_key_fn,
    vae_key_fn as j_vae_key_fn,
)
from vidseg_diffusion_tpu.models import clip as jclip
from vidseg_diffusion_tpu.models import conditioner as jcond
from vidseg_diffusion_tpu.models import layers as jl
from vidseg_diffusion_tpu.models import unet as junet
from vidseg_diffusion_tpu.models import vae as jvae
from vidseg_diffusion_tpu.models import video_layers as jvl
from vidseg_diffusion_tpu_torch.io import convert
from vidseg_diffusion_tpu_torch.models import clip as tclip
from vidseg_diffusion_tpu_torch.models import conditioner as tcond
from vidseg_diffusion_tpu_torch.models import layers as tl
from vidseg_diffusion_tpu_torch.models import unet as tunet
from vidseg_diffusion_tpu_torch.models import vae as tvae
from vidseg_diffusion_tpu_torch.models import video_layers as tvl

MODULE_TOL = 1e-4   # fp32 modules
UNET_TOL = 2e-4     # fp32 whole UNet (the figure the verify recipe uses)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the small CPU shapes here gain nothing from more,
    and idle OpenMP threads spin against the suite's other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _init_tree(module, seed, *args, **kwargs):
    """Random numpy params in the shapes of module.init(*args): weights
    N(0, 1/fan_in) (fan_in over all dims but the last, JAX's convention),
    norm scales 1 + N(0, 0.1), other vectors N(0, 0.05)."""
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
    """module.apply under one jit: eager flax compiles op by op, far slower."""
    return jax.jit(lambda p: module.apply({"params": p}, *args, **kwargs))(params)


def _load(module, tree, key_fn, strip=""):
    sd = convert.jax_to_state_dict(tree, key_fn, strip_prefix=strip)
    module.load_state_dict({k: torch.tensor(v) for k, v in sd.items()}, strict=True)
    return module.eval()


def _round_trip(tree, module, key_fn, prefix=""):
    sd = {prefix + k: v.detach().numpy() for k, v in module.state_dict().items()}
    back, unused = convert_state_dict(tree, sd, key_fn)
    assert not unused
    flat_a = flax.traverse_util.flatten_dict(tree)
    flat_b = flax.traverse_util.flatten_dict(back)
    assert flat_a.keys() == flat_b.keys()
    for path in flat_a:
        np.testing.assert_array_equal(np.asarray(flat_b[path]), flat_a[path], err_msg=str(path))


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=tol, rtol=tol)


def _mods(t, l, seed):
    rs = np.random.RandomState(seed)
    masks = (rs.rand(t, l) > 0.5).astype(np.float32)
    lam = np.linspace(-3, 4, t).astype(np.float32)
    gate = np.array([True] * (t - 1) + [False])
    jm = jl.Modulation(masks=jnp.asarray(masks), lam=jnp.asarray(lam), frame_gate=jnp.asarray(gate),
                       enabled=jnp.asarray(True))
    tm = tl.Modulation(masks=torch.from_numpy(masks), lam=torch.from_numpy(lam),
                       frame_gate=torch.from_numpy(gate), enabled=torch.tensor(True))
    return jm, tm


def test_cross_attention_with_harvest():
    x = np.random.RandomState(0).randn(4, 10, 16).astype(np.float32)
    jm = jl.CrossAttention(heads=2, dim_head=8)
    params = _init_tree(jm, 0, jnp.asarray(x))
    want, state = _apply(jm, params, jnp.asarray(x), mutable=["intermediates"])
    tm = _load(tl.CrossAttention(16, 2, 8), params, convert.unet_key_fn)
    sow = {}
    got = tm(torch.from_numpy(x), sow=sow)
    _close(got, want, MODULE_TOL)
    for name in ("q", "k"):  # flat [B, L, H*D] harvest
        assert tuple(sow[name].shape) == (4, 10, 16)
        _close(sow[name], state["intermediates"][name][0], MODULE_TOL)
    with pytest.raises(ValueError, match="injected"):  # layers.py:367-373 hazard
        tm(torch.from_numpy(x), injection=tl.AttnInjection(gate=torch.tensor(True),
                                                          q=torch.zeros(4, 16, 10)))


def test_basic_transformer_block_with_modulation():
    t, l, c = 3, 12, 16
    rs = np.random.RandomState(1)
    x = rs.randn(2 * t, l, c).astype(np.float32)
    ctx = rs.randn(2 * t, 1, 24).astype(np.float32)
    jmod, tmod = _mods(t, l, 2)
    jb = jl.BasicTransformerBlock(heads=2, dim_head=8)
    params = _init_tree(jb, 1, jnp.asarray(x), jnp.asarray(ctx))
    want = _apply(jb, params, jnp.asarray(x), jnp.asarray(ctx),
                    modulation=jl.BlockModulation(self_attn=jmod, cross_attn=jmod, ff_out=jmod))
    tb = _load(tl.BasicTransformerBlock(c, 2, 8, 24), params, convert.unet_key_fn)
    got = tb(torch.from_numpy(x), torch.from_numpy(ctx),
             tl.BlockModulation(self_attn=tmod, cross_attn=tmod, ff_out=tmod))
    _close(got, want, MODULE_TOL)


def test_spatial_transformer():
    rs = np.random.RandomState(12)
    x = rs.randn(2, 4, 5, 16).astype(np.float32)
    ctx = rs.randn(2, 1, 24).astype(np.float32)
    jm = jl.SpatialTransformer(heads=2, dim_head=8)
    params = _init_tree(jm, 4, jnp.asarray(x), jnp.asarray(ctx))
    want = _apply(jm, params, jnp.asarray(x), jnp.asarray(ctx))
    tm = _load(tl.SpatialTransformer(16, 2, 8, 24), params, convert.unet_key_fn)
    _close(tm(torch.from_numpy(x), torch.from_numpy(ctx)), want, MODULE_TOL)


def test_video_transformer_block_direct_layout(monkeypatch):
    monkeypatch.delenv("VIDSEG_TEMPORAL_LAYOUT", raising=False)  # JAX default: direct
    t, s, c = 3, 10, 16
    rs = np.random.RandomState(3)
    x = rs.randn(2 * t, s, c).astype(np.float32)
    ctx = rs.randn(2 * t, 1, 24).astype(np.float32)
    jmod, tmod = _mods(t, s, 4)
    jb = jvl.VideoTransformerBlock(heads=2, dim_head=8)
    params = _init_tree(jb, 2, jnp.asarray(x), jnp.asarray(ctx), t)
    want = _apply(jb, params, jnp.asarray(x), jnp.asarray(ctx), t,
                    modulation=jl.BlockModulation(self_attn=jmod))
    tb = _load(tvl.VideoTransformerBlock(c, 2, 8, 24), params, convert.unet_key_fn)
    got = tb(torch.from_numpy(x), torch.from_numpy(ctx), t, tl.BlockModulation(self_attn=tmod))
    _close(got, want, MODULE_TOL)


_TINY_UNET = dict(in_channels=8, out_channels=4, model_channels=32, num_res_blocks=1,
                  attention_resolutions=(2, 1), channel_mult=(1, 2), num_head_channels=16,
                  context_dim=24, adm_in_channels=12)


@pytest.fixture(scope="module")
def tiny_unet():
    """The tiny video UNet of examples/tiny_e2e.py, every leaf random."""
    cfg = junet.UNetConfig(video=True, **_TINY_UNET)
    t = 3
    jm = junet.UNetModel(cfg)
    params = _init_tree(
        jm, 9, jnp.zeros((2 * t, 8, 8, 8)), jnp.zeros((2 * t,)), jnp.zeros((2 * t, 1, 24)),
        jnp.zeros((2 * t, 12)), num_video_frames=t, image_only_indicator=jnp.zeros((2, t)),
    )
    tm = _load(tunet.UNetModel(tunet.UNetConfig(**_TINY_UNET)), params, convert.unet_key_fn)
    return jm, params, tm, t


def test_video_unet_matches_jax_with_hooks(tiny_unet, monkeypatch):
    monkeypatch.delenv("VIDSEG_TEMPORAL_LAYOUT", raising=False)
    jm, params, tm, t = tiny_unet
    rs = np.random.RandomState(5)
    x = rs.randn(2 * t, 8, 8, 8).astype(np.float32)
    ts = rs.randn(2 * t).astype(np.float32)
    ctx = rs.randn(2 * t, 1, 24).astype(np.float32)
    y = rs.randn(2 * t, 12).astype(np.float32)
    ioi = np.zeros((2, t), np.float32)
    _, _, out_layout = jm.config.block_layout()
    blk = max(i for i, s in enumerate(out_layout) if s.get("attn") and s["ds"] == 1)
    jmod, tmod = _mods(t, 64, 6)
    jhooks = junet.UNetHooks(
        output_mod={blk: jvl.SiteModulation(spatial=jl.BlockModulation(cross_attn=jmod, self_attn=jmod),
                                            temporal=jl.BlockModulation(ff_out=jmod))},
        sow_blocks=(blk,),
    )
    want, state = _apply(jm, params, *map(jnp.asarray, (x, ts, ctx, y)), num_video_frames=t,
                           image_only_indicator=jnp.asarray(ioi), hooks=jhooks, mutable=["intermediates"])
    thooks = tunet.UNetHooks(
        output_mod={blk: tvl.SiteModulation(spatial=tl.BlockModulation(cross_attn=tmod, self_attn=tmod),
                                            temporal=tl.BlockModulation(ff_out=tmod))},
        sow_blocks=(blk,), intermediates={},
    )
    with torch.no_grad():
        got = tm(*map(torch.from_numpy, (x, ts, ctx, y)), num_video_frames=t,
                 image_only_indicator=torch.from_numpy(ioi), hooks=thooks)
    _close(got, want, UNET_TOL)
    jq = state["intermediates"][f"output_blocks_{blk}_1"]["transformer_blocks_0"]["attn1"]["q"][0]
    tq = thooks.intermediates[f"output_blocks_{blk}_1"]["transformer_blocks_0"]["attn1"]["q"]
    _close(tq, jq, UNET_TOL)


def test_unet_state_dict_round_trip(tiny_unet):
    _, params, tm, _ = tiny_unet
    _round_trip(params, tm, j_unet_key_fn)


_TINY_VAE = dict(ch=16, ch_mult=(1, 2, 2, 2), num_res_blocks=1)


def test_vae_encoder_and_video_decoder():
    t = 3
    rs = np.random.RandomState(8)
    frames = rs.uniform(-1, 1, (t, 64, 64, 3)).astype(np.float32)
    z = rs.randn(t, 8, 8, 4).astype(np.float32)
    jcfg = jvae.VAEConfig(video_decoder=True, **_TINY_VAE)
    tcfg = tvae.VAEConfig(video_decoder=True, **_TINY_VAE)
    je, jd = jvae.Encoder(jcfg), jvae.Decoder(jcfg)
    ep = _init_tree(je, 1, jnp.asarray(frames))
    dp = _init_tree(jd, 2, jnp.asarray(z), timesteps=t)
    te = _load(tvae.Encoder(tcfg), ep, convert.vae_key_fn)
    td = _load(tvae.Decoder(tcfg), dp, convert.vae_key_fn)
    with torch.no_grad():
        _close(te(torch.from_numpy(frames)), _apply(je, ep, jnp.asarray(frames)), MODULE_TOL)
        _close(td(torch.from_numpy(z), t), _apply(jd, dp, jnp.asarray(z), timesteps=t), MODULE_TOL)
        mom = rs.randn(2, 4, 4, 8).astype(np.float32)
        _close(tvae.gaussian_sample(torch.from_numpy(mom)), jvae.gaussian_sample(jnp.asarray(mom), None), 0)
    _round_trip(ep, te, j_vae_key_fn)
    _round_trip(dp, td, j_vae_key_fn)


def test_clip_vision_tower_and_preprocess():
    kw = dict(width=64, layers=2, heads=4, output_dim=32)
    frames = np.random.RandomState(9).uniform(-1, 1, (2, 40, 48, 3)).astype(np.float32)
    jm = jclip.CLIPVisionTransformer(jclip.CLIPVisionConfig(**kw))
    params = _init_tree(jm, 3, jnp.zeros((1, 224, 224, 3)))
    want = _apply(jm, params, jclip.clip_preprocess(jnp.asarray(frames)))
    tm = _load(tclip.CLIPVisionTransformer(tclip.CLIPVisionConfig(**kw)), params,
               convert.clip_vision_key_fn, strip="visual.")
    with torch.no_grad():
        pre = tclip.clip_preprocess(torch.from_numpy(frames))
        _close(pre, jclip.clip_preprocess(jnp.asarray(frames)), 1e-5)
        _close(tm(pre), want, MODULE_TOL)
    _round_trip(params, tm, jclip.clip_vision_key_fn, prefix="visual.")


def test_split_packed_qkv_matches_jax():
    rs = np.random.RandomState(10)
    sd = {"transformer.resblocks.0.attn.in_proj_weight": rs.randn(12, 4),
          "transformer.resblocks.0.attn.in_proj_bias": rs.randn(12),
          "transformer.resblocks.0.attn.out_proj.weight": rs.randn(4, 4)}
    want = jclip.split_packed_qkv(sd)
    got = convert.split_packed_qkv(sd)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_svd_conditioner_routing_and_uc():
    rs = np.random.RandomState(11)
    img = rs.uniform(-1, 1, (1, 16, 16, 3)).astype(np.float32)
    vals = {"fps_id": np.array([6.0], np.float32), "motion_bucket_id": np.array([127.0], np.float32),
            "cond_aug": np.array([0.02], np.float32)}
    w_clip, w_vae = rs.randn(3, 24).astype(np.float32), rs.randn(3, 4).astype(np.float32)
    jc = jcond.build_svd_conditioner(
        lambda f: jnp.mean(f, axis=(1, 2)) @ jnp.asarray(w_clip),
        lambda f: (f[:, ::8, ::8, :] @ jnp.asarray(w_vae)),
    )
    tc = tcond.build_svd_conditioner(
        lambda f: f.mean(dim=(1, 2)) @ torch.from_numpy(w_clip),
        lambda f: f[:, ::8, ::8, :] @ torch.from_numpy(w_vae),
    )
    batch = dict(vals, cond_frames_without_noise=img, cond_frames=img)
    zero = ["cond_frames", "cond_frames_without_noise"]
    jcu = jc.get_unconditional_conditioning({k: jnp.asarray(v) for k, v in batch.items()},
                                            force_uc_zero_embeddings=zero)
    tcu = tc.get_unconditional_conditioning({k: torch.from_numpy(v) for k, v in batch.items()},
                                            force_uc_zero_embeddings=zero)
    for want, got in zip(jcu, tcu):
        assert want.keys() == got.keys() == {"crossattn", "vector", "concat"}
        for key in want:
            _close(got[key], want[key], 1e-5)  # fp32 sin/cos of args up to ~127
