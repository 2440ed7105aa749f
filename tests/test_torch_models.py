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
from vidseg_diffusion_tpu.diffusion import denoiser as jden
from vidseg_diffusion_tpu.diffusion import discretization as jdisc
from vidseg_diffusion_tpu.diffusion import guidance as jguide
from vidseg_diffusion_tpu.diffusion import sampling as jsamp
from vidseg_diffusion_tpu.diffusion import scaling as jscal
from vidseg_diffusion_tpu.engine import diffusion_engine as jde
from vidseg_diffusion_tpu.io import tokenizer as jtok
from vidseg_diffusion_tpu.models import clip as jclip
from vidseg_diffusion_tpu.models import conditioner as jcond
from vidseg_diffusion_tpu.models import layers as jl
from vidseg_diffusion_tpu.models import unet as junet
from vidseg_diffusion_tpu.models import vae as jvae
from vidseg_diffusion_tpu.models import video_layers as jvl
from vidseg_diffusion_tpu_torch.diffusion import denoiser as tden
from vidseg_diffusion_tpu_torch.diffusion import discretization as tdisc
from vidseg_diffusion_tpu_torch.diffusion import guidance as tguide
from vidseg_diffusion_tpu_torch.diffusion import sampling as tsamp
from vidseg_diffusion_tpu_torch.diffusion import scaling as tscal
from vidseg_diffusion_tpu_torch.engine import diffusion_engine as tde
from vidseg_diffusion_tpu_torch.io import convert
from vidseg_diffusion_tpu_torch.io import tokenizer as ttok
from vidseg_diffusion_tpu_torch.models import clip as tclip
from vidseg_diffusion_tpu_torch.models import conditioner as tcond
from vidseg_diffusion_tpu_torch.models import layers as tl
from vidseg_diffusion_tpu_torch.models import unet as tunet
from vidseg_diffusion_tpu_torch.models import vae as tvae
from vidseg_diffusion_tpu_torch.models import video_layers as tvl
from vidseg_diffusion_tpu_torch.ops import conv3x3 as tc3
from vidseg_diffusion_tpu_torch.ops import matmul as tmm

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


def test_video_transformer_block_injection_direct_layout(monkeypatch):
    """Injected temporal q/k, in the direct layout [(b t), s, H*D], replace
    the computed ones where the gate is on (and not where it is off); a
    folded-layout tensor [(b s), t, H*D] has the same element count and is
    refused by the port's shape check."""
    monkeypatch.delenv("VIDSEG_TEMPORAL_LAYOUT", raising=False)  # JAX default: direct
    t, s, c = 3, 10, 16
    rs = np.random.RandomState(11)
    x = rs.randn(2 * t, s, c).astype(np.float32)
    ctx = rs.randn(2 * t, 1, 24).astype(np.float32)
    q, k = rs.randn(2, 2 * t, s, c).astype(np.float32)
    jb = jvl.VideoTransformerBlock(heads=2, dim_head=8)
    params = _init_tree(jb, 12, jnp.asarray(x), jnp.asarray(ctx), t)
    tb = _load(tvl.VideoTransformerBlock(c, 2, 8, 24), params, convert.unet_key_fn)
    outs = {}
    for gate in (True, False):
        jinj = jl.BlockInjection(attn1=jl.AttnInjection(gate=jnp.asarray(gate), q=jnp.asarray(q),
                                                        k=jnp.asarray(k)))
        want = _apply(jb, params, jnp.asarray(x), jnp.asarray(ctx), t, injection=jinj)
        tinj = tl.BlockInjection(attn1=tl.AttnInjection(gate=torch.tensor(gate), q=torch.from_numpy(q),
                                                        k=torch.from_numpy(k)))
        sow = {}
        outs[gate] = tb(torch.from_numpy(x), torch.from_numpy(ctx), t, None, tinj, sow)
        _close(outs[gate], want, MODULE_TOL)
        assert torch.equal(sow["attn1"]["q"], torch.from_numpy(q)) == gate
    plain = tb(torch.from_numpy(x), torch.from_numpy(ctx), t)
    assert torch.equal(outs[False], plain) and not torch.allclose(outs[True], plain)
    folded = torch.from_numpy(q).reshape(2, t, s, c).transpose(1, 2).reshape(2 * s, t, c)
    with pytest.raises(ValueError, match="injected"):
        tb(torch.from_numpy(x), torch.from_numpy(ctx), t, None,
           tl.BlockInjection(attn1=tl.AttnInjection(gate=torch.tensor(True), q=folded)))


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
    _video_unet_matches_jax_with_hooks(*tiny_unet)


def test_video_unet_matches_jax_with_hooks_at_33_frames(tiny_unet, monkeypatch):
    """The same UNet and hooks over 33 frames: every temporal site past the
    32 frames at which the card's tiled K2 kernels stop (JAX's direct kernel
    takes a 16-token tile there)."""
    monkeypatch.delenv("VIDSEG_TEMPORAL_LAYOUT", raising=False)
    jm, params, tm, _ = tiny_unet
    _video_unet_matches_jax_with_hooks(jm, params, tm, 33)


def _video_unet_matches_jax_with_hooks(jm, params, tm, t):
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


# -- the SD 2.1 family: image UNet, text tower, image decoder, discrete denoiser --

_TINY_IMAGE_UNET = dict(in_channels=4, out_channels=4, model_channels=32, num_res_blocks=1,
                        attention_resolutions=(2, 1), channel_mult=(1, 2), num_head_channels=16,
                        context_dim=24, adm_in_channels=None)
_LK = 7   # context tokens: cross-attention with Lq != Lk and real to_k / to_v projections


@pytest.fixture(scope="module")
def tiny_image_unet():
    """A tiny image UNet (video False, no class embedding), every leaf random."""
    cfg = junet.UNetConfig(video=False, **_TINY_IMAGE_UNET)
    t = 3
    jm = junet.UNetModel(cfg)
    params = _init_tree(jm, 19, jnp.zeros((2 * t, 8, 8, 4)), jnp.zeros((2 * t,)), jnp.zeros((2 * t, _LK, 24)))
    tm = _load(tunet.UNetModel(tunet.UNetConfig(video=False, **_TINY_IMAGE_UNET)), params,
               convert.unet_key_fn)
    return jm, params, tm, t


def test_image_unet_matches_jax_with_hooks(tiny_image_unet):
    """The SD 2.1 UNet: ResBlock + SpatialTransformer, a 7-token context,
    modulation on the spatial cross-attention and the ff output, injected
    self- and cross-attention q/k, and the q/k harvest of both sites."""
    jm, params, tm, t = tiny_image_unet
    rs = np.random.RandomState(15)
    x = rs.randn(2 * t, 8, 8, 4).astype(np.float32)
    ts = rs.randint(0, 1000, 2 * t).astype(np.float32)
    ctx = rs.randn(2 * t, _LK, 24).astype(np.float32)
    _, _, out_layout = jm.config.block_layout()
    blk = max(i for i, s in enumerate(out_layout) if s.get("attn") and s["ds"] == 1)
    inj_blk = min(i for i, s in enumerate(out_layout) if s.get("attn") and s["ds"] == 2)
    ch = out_layout[inj_blk]["ch"]
    q1, k1, q2 = rs.randn(3, 2 * t, 16, ch).astype(np.float32)
    k2 = rs.randn(2 * t, _LK, ch).astype(np.float32)
    jmod, tmod = _mods(t, 64, 16)
    jhooks = junet.UNetHooks(
        output_mod={blk: jvl.SiteModulation(spatial=jl.BlockModulation(cross_attn=jmod, ff_out=jmod))},
        output_inj={inj_blk: jvl.SiteInjection(spatial=jl.BlockInjection(
            attn1=jl.AttnInjection(gate=jnp.asarray(True), q=jnp.asarray(q1), k=jnp.asarray(k1)),
            attn2=jl.AttnInjection(gate=jnp.asarray(True), q=jnp.asarray(q2), k=jnp.asarray(k2))))},
        sow_blocks=(blk,),
    )
    want, state = _apply(jm, params, *map(jnp.asarray, (x, ts, ctx)), hooks=jhooks, mutable=["intermediates"])
    on = torch.tensor(True)
    thooks = tunet.UNetHooks(
        output_mod={blk: tvl.SiteModulation(spatial=tl.BlockModulation(cross_attn=tmod, ff_out=tmod))},
        output_inj={inj_blk: tvl.SiteInjection(spatial=tl.BlockInjection(
            attn1=tl.AttnInjection(gate=on, q=torch.from_numpy(q1), k=torch.from_numpy(k1)),
            attn2=tl.AttnInjection(gate=on, q=torch.from_numpy(q2), k=torch.from_numpy(k2))))},
        sow_blocks=(blk,), intermediates={},
    )
    with torch.no_grad():
        got = tm(*map(torch.from_numpy, (x, ts, ctx)), hooks=thooks)
        plain = tm(*map(torch.from_numpy, (x, ts, ctx)))
    _close(got, want, UNET_TOL)
    assert not torch.allclose(got, plain, atol=1e-3)
    _close(plain, _apply(jm, params, *map(jnp.asarray, (x, ts, ctx))), UNET_TOL)
    for attn, lk in (("attn1", 64), ("attn2", _LK)):
        for name, l in (("q", 64), ("k", lk)):
            jt = state["intermediates"][f"output_blocks_{blk}_1"]["transformer_blocks_0"][attn][name][0]
            tt = thooks.intermediates[f"output_blocks_{blk}_1"]["transformer_blocks_0"][attn][name]
            assert tuple(tt.shape) == (2 * t, l, out_layout[blk]["ch"])
            _close(tt, jt, UNET_TOL)


def test_image_unet_state_dict_round_trip(tiny_image_unet):
    _, params, tm, _ = tiny_image_unet
    assert not any(k.startswith("label_emb") or "time_stack" in k for k in tm.state_dict())
    _round_trip(params, tm, j_unet_key_fn)


def test_projections_and_resblock_convs_go_through_the_kernel_wrappers(tiny_unet, tiny_image_unet):
    """Each CrossAttention calls matmul_bias once per projection (to_q, to_k,
    to_v, to_out) and each ResBlock conv3x3_same once per 3x3 convolution, in
    the video and the image UNet; no other layer does. On the CPU the wrappers
    take their plain versions, whose call counters are read here."""
    x = torch.from_numpy(np.random.RandomState(17).randn(4, 10, 16).astype(np.float32))
    attn = tl.CrossAttention(16, 2, 8, context_dim=24)
    calls = tmm.matmul_bias_plain.calls
    with torch.no_grad():
        attn(x, torch.zeros(4, 3, 24))
    assert tmm.matmul_bias_plain.calls == calls + 4
    res = tunet.ResBlock(32, 64, 16)
    calls = tc3.conv3x3_plain.calls
    with torch.no_grad():
        res(torch.zeros(2, 4, 4, 32), torch.zeros(2, 16))
    assert tc3.conv3x3_plain.calls == calls + 2
    for (_, _, tm, t), video in ((tiny_unet, True), (tiny_image_unet, False)):
        n_attn = sum(isinstance(m, tl.CrossAttention) for m in tm.modules())
        n_res = sum(isinstance(m, tunet.ResBlock) for m in tm.modules())
        assert n_attn > 0 and n_res > 0
        cfg = tm.config
        args = [torch.zeros(2 * t, 8, 8, cfg.in_channels), torch.zeros(2 * t), torch.zeros(2 * t, 1, 24)]
        kw = dict(y=torch.zeros(2 * t, 12), num_video_frames=t, image_only_indicator=torch.zeros(2, t)) if video else {}
        mm, c3 = tmm.matmul_bias_plain.calls, tc3.conv3x3_plain.calls
        with torch.no_grad():
            tm(*args, **kw)
        assert tmm.matmul_bias_plain.calls - mm == 4 * n_attn
        assert tc3.conv3x3_plain.calls - c3 == 2 * n_res


def test_temporal_conv_and_video_resblock_match_jax():
    """TemporalConv (its Conv3d weight handed to temporal_conv_1x1, which reads
    the K-major copy on the card) and the VideoResBlock whose time_stack holds
    two of them, against JAX's TemporalConv / VideoResBlock (temporal_conv_1x1's
    math) on the same weights, at T = 3 and T = 1."""
    rs = np.random.RandomState(19)
    for t in (3, 1):
        x5 = rs.randn(2, t, 4, 5, 16).astype(np.float32)
        jc = junet.TemporalConv(24)
        params = _init_tree(jc, 19, jnp.asarray(x5))
        tc = _load(tunet.TemporalConv(16, 24), params, convert.unet_key_fn)
        _close(tc(torch.from_numpy(x5)), _apply(jc, params, jnp.asarray(x5)), MODULE_TOL)

        x = rs.randn(2 * t, 4, 5, 16).astype(np.float32)
        emb = rs.randn(2 * t, 12).astype(np.float32)
        jb = junet.VideoResBlock(out_channels=32)
        ind = np.zeros((2, t), np.float32)
        params = _init_tree(jb, 20, jnp.asarray(x), jnp.asarray(emb), num_video_frames=t,
                            image_only_indicator=jnp.asarray(ind))
        want = _apply(jb, params, jnp.asarray(x), jnp.asarray(emb), num_video_frames=t,
                      image_only_indicator=jnp.asarray(ind))
        tb = _load(tunet.VideoResBlock(16, 32, 12), params, convert.unet_key_fn)
        got = tb(torch.from_numpy(x), torch.from_numpy(emb), num_video_frames=t,
                 image_only_indicator=torch.from_numpy(ind))
        _close(got, want, MODULE_TOL)


def test_clip_text_tower():
    """The OpenCLIP text tower in its SD 2.1 form (penultimate layer, then
    ln_final) on the empty prompt's tokens and on random ids."""
    kw = dict(width=64, heads=4, layers=3)
    rs = np.random.RandomState(18)
    tokens = np.concatenate([jtok.tokenize_empty(1), rs.randint(0, 49408, (2, 77)).astype(np.int32)])
    jm = jclip.CLIPTextTransformer(jclip.CLIPTextConfig(**kw), penultimate=True)
    params = _init_tree(jm, 6, jnp.zeros((1, 77), jnp.int32))
    want = _apply(jm, params, jnp.asarray(tokens))
    tm = _load(tclip.CLIPTextTransformer(tclip.CLIPTextConfig(**kw)), params, convert.clip_text_key_fn)
    assert len(tm.transformer.resblocks) == 2   # the last block is never run, so never built
    with torch.no_grad():
        got = tm(torch.from_numpy(tokens))
    assert tuple(got.shape) == (3, 77, 64)
    _close(got, want, MODULE_TOL)
    _round_trip(params, tm, jclip.clip_text_key_fn)
    # causal: a change of the last token leaves the earlier positions alone
    moved = tokens.copy()
    moved[:, -1] = (moved[:, -1] + 1) % 49408
    with torch.no_grad():
        assert torch.equal(tm(torch.from_numpy(moved))[:, :-1], got[:, :-1])


def test_tokenizer_copy_matches_jax_package():
    np.testing.assert_array_equal(ttok.tokenize_empty(2), jtok.tokenize_empty(2))
    np.testing.assert_array_equal(ttok.tokenize_empty(3, 16), jtok.tokenize_empty(3, 16))
    np.testing.assert_array_equal(ttok.tokenize_empty(2), jtok.tokenize(["", " "]))
    assert ttok.tokenize_empty(1).dtype == jtok.tokenize_empty(1).dtype
    assert (ttok.SOT, ttok.EOT, ttok.CONTEXT_LENGTH) == (jtok.SOT, jtok.EOT, jtok.CONTEXT_LENGTH)


def test_sd_text_conditioner_routes_to_crossattn():
    rs = np.random.RandomState(20)
    table = rs.randn(50, 8).astype(np.float32)
    tokens = rs.randint(0, 50, (2, 77))
    jc = jcond.build_sd_text_conditioner(lambda tok: jnp.asarray(table)[tok])
    tc = tcond.build_sd_text_conditioner(lambda tok: torch.from_numpy(table)[tok])
    jcu = jc.get_unconditional_conditioning({"txt_tokens": jnp.asarray(tokens)})
    tcu = tc.get_unconditional_conditioning({"txt_tokens": torch.from_numpy(tokens)})
    for want, got in zip(jcu, tcu):
        assert want.keys() == got.keys() == {"crossattn"}
        _close(got["crossattn"], want["crossattn"], 0)


def test_vae_image_decoder_and_first_stage_quant_convs():
    """The image decoder (SD 2.1: no time mix), and the first stage around it
    with an AutoencoderKL checkpoint's 1x1 quant / post-quant convolutions."""
    rs = np.random.RandomState(21)
    frames = rs.uniform(-1, 1, (3, 64, 64, 3)).astype(np.float32)
    z = rs.randn(3, 8, 8, 4).astype(np.float32)
    jcfg, tcfg = jvae.VAEConfig(**_TINY_VAE), tvae.VAEConfig(**_TINY_VAE)
    je, jd = jvae.Encoder(jcfg), jvae.Decoder(jcfg)
    ep = _init_tree(je, 4, jnp.asarray(frames))
    dp = _init_tree(jd, 5, jnp.asarray(z))
    te = _load(tvae.Encoder(tcfg), ep, convert.vae_key_fn)
    td = _load(tvae.Decoder(tcfg), dp, convert.vae_key_fn)
    assert not any("time_stack" in k or "mix_factor" in k for k in td.state_dict())
    with torch.no_grad():
        _close(td(torch.from_numpy(z)), _apply(jd, dp, jnp.asarray(z)), MODULE_TOL)
    _round_trip(dp, td, j_vae_key_fn)
    qk, qb = rs.randn(1, 1, 8, 8).astype(np.float32) * 0.3, rs.randn(8).astype(np.float32) * 0.1
    pk, pb = rs.randn(1, 1, 4, 4).astype(np.float32) * 0.5, rs.randn(4).astype(np.float32) * 0.1
    jfs = jde.FirstStage(je, jd, ep, dp, scale_factor=0.18215, quant_conv=(qk, qb), post_quant_conv=(pk, pb))
    quant, post = tl.Conv2dNHWC(8, 8, 1), tl.Conv2dNHWC(4, 4, 1)
    quant.load_state_dict({"weight": torch.from_numpy(qk.transpose(3, 2, 0, 1).copy()), "bias": torch.from_numpy(qb)})
    post.load_state_dict({"weight": torch.from_numpy(pk.transpose(3, 2, 0, 1).copy()), "bias": torch.from_numpy(pb)})
    tfs = tde.FirstStage(te, td, 0.18215, quant, post)
    _close(tfs.encode(torch.from_numpy(frames), chunk=2), jfs.encode(jnp.asarray(frames), chunk=2), MODULE_TOL)
    _close(tfs.decode(torch.from_numpy(z), chunk=2), jfs.decode(jnp.asarray(z), chunk=2), MODULE_TOL)


@pytest.mark.parametrize("n", [10, 25, 1000])
def test_legacy_ddpm_discretization(n):
    jd, td = jdisc.LegacyDDPMDiscretization(), tdisc.LegacyDDPMDiscretization()
    for kw in (dict(), dict(do_append_zero=False, flip=True)):
        np.testing.assert_array_equal(td(n, **kw).numpy(), np.asarray(jd(n, **kw)))


def test_discrete_denoiser_with_vanilla_cfg_takes_a_euler_step():
    """One Euler step of the SD 2.1 stack: DiscreteDenoiser (sigma snapped to
    the 1000-entry table, c_noise the table index) with EpsScaling, VanillaCFG
    on the [uc; c] batch, the LegacyDDPM sampler schedule."""
    rs = np.random.RandomState(22)
    x = rs.randn(3, 4, 4, 4).astype(np.float32)
    w = rs.randn(4, 4).astype(np.float32) * 0.5
    cu, cc = rs.randn(2, 3, 5, 4).astype(np.float32)
    jden_ = jden.DiscreteDenoiser(jscal.EpsScaling(), jdisc.LegacyDDPMDiscretization())
    tden_ = tden.DiscreteDenoiser(tscal.EpsScaling(), tdisc.LegacyDDPMDiscretization())
    sig = np.array([0.03, 0.9, 14.6], np.float32)
    idx = tden_.sigma_to_idx(torch.from_numpy(sig))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jden_.sigma_to_idx(jnp.asarray(sig))))
    np.testing.assert_array_equal(tden_.possibly_quantize_sigma(torch.from_numpy(sig)).numpy(),
                                  np.asarray(jden_.possibly_quantize_sigma(jnp.asarray(sig))))
    jg, tg = jguide.VanillaCFG(scale=5.0), tguide.VanillaCFG(scale=5.0)
    js = jsamp.EulerEDMSampler(jdisc.LegacyDDPMDiscretization(), num_steps=10)
    ts = tsamp.EulerEDMSampler(tdisc.LegacyDDPMDiscretization(), num_steps=10)
    np.testing.assert_array_equal(ts.sigmas().numpy(), np.asarray(js.sigmas()))
    seen = {}

    def jnet(xs, c_noise, cond):
        seen["j"] = np.asarray(c_noise)
        return jnp.tanh(xs @ jnp.asarray(w)) * (1 + c_noise[:, None, None, None] / 1000.0) + cond["crossattn"].mean(1)[:, None, None, :]

    def tnet(xs, c_noise, cond):
        seen["t"] = c_noise.numpy()
        out = torch.tanh(xs @ torch.from_numpy(w)) * (1 + c_noise[:, None, None, None] / 1000.0)
        return out + cond["crossattn"].mean(1)[:, None, None, :], {}

    def jdenoise(xx, sigma, i):
        s = jnp.full((xx.shape[0],), sigma, xx.dtype)
        x_in, s_in, cond = jg.prepare_inputs(xx, s, {"crossattn": jnp.asarray(cc)}, {"crossattn": jnp.asarray(cu)})
        return jg(jden_(jnet, x_in, s_in, cond), sigma), {}

    def tdenoise(xx, sigma, i):
        s = torch.full((xx.shape[0],), sigma, dtype=xx.dtype)
        x_in, s_in, cond = tg.prepare_inputs(xx, s, {"crossattn": torch.from_numpy(cc)},
                                             {"crossattn": torch.from_numpy(cu)})
        den, aux = tden_(tnet, x_in, s_in, cond)
        return tg(den, sigma), aux

    sigmas = ts.sigmas().tolist()
    want, _ = js.step(jdenoise, jnp.asarray(x), js.sigmas()[4], js.sigmas()[5], 4)
    got, _ = ts.step(tdenoise, torch.from_numpy(x), sigmas[4], sigmas[5], 4)
    np.testing.assert_array_equal(seen["t"], seen["j"])
    assert seen["t"].dtype.kind == "i" and seen["t"].shape == (6,)
    _close(got, want, 1e-5)


def _toy_denoiser(scale_by):
    """A seeded denoiser that depends on sigma and the step: x * (1 - a(sigma))
    + b * sin(i), the same arithmetic in both frameworks (fp32)."""
    def jfn(x, sigma, i):
        return x * (1.0 - sigma / (sigma + 1.0) * scale_by) + 0.01 * jnp.sin(jnp.float32(i)), None

    def tfn(x, sigma, i):
        s = torch.tensor(sigma, dtype=torch.float32)
        return x * (1.0 - s / (s + 1.0) * scale_by) + 0.01 * torch.sin(torch.tensor(float(i))), None

    return jfn, tfn


@pytest.mark.parametrize("disc", ["edm", "legacy"])
def test_sigmas_flip_and_inversion_match_jax(disc):
    """EulerEDMSampler.sigmas(flip=True) (reversed, 1e-8 added to the first
    entry) bit for bit, and inversion on a seeded toy denoiser: x_T and the
    [num_steps + 1] latents from the pre-scaled start (JAX's
    test_diffusion_core.py::test_inversion_shapes_and_final_scale shapes),
    within 1e-6 of the scale."""
    if disc == "edm":
        jd, td = jdisc.EDMDiscretization(sigma_min=0.1, sigma_max=10.0), tdisc.EDMDiscretization(sigma_min=0.1,
                                                                                               sigma_max=10.0)
    else:
        jd, td = jdisc.LegacyDDPMDiscretization(), tdisc.LegacyDDPMDiscretization()
    js, ts = jsamp.EulerEDMSampler(jd, num_steps=5), tsamp.EulerEDMSampler(td, num_steps=5)
    np.testing.assert_array_equal(ts.sigmas(flip=True).numpy(), np.asarray(js.sigmas(flip=True)))
    js7, ts7 = jsamp.EulerEDMSampler(jd, num_steps=7), tsamp.EulerEDMSampler(td, num_steps=7)
    np.testing.assert_array_equal(ts7.sigmas(flip=True).numpy(), np.asarray(js7.sigmas(flip=True)))
    assert ts.sigmas(flip=True)[0].item() == np.float32(1e-8)
    np.testing.assert_array_equal(ts.sigmas().numpy(), np.asarray(js.sigmas()))   # the unflipped schedule
    x = np.random.RandomState(5).randn(2, 3, 4, 4).astype(np.float32)
    jfn, tfn = _toy_denoiser(0.7)
    jx, jlat = js.inversion(jfn, jnp.asarray(x))
    tx, tlat = ts.inversion(tfn, torch.from_numpy(x))
    assert tlat.shape == jlat.shape == (6, 2, 3, 4, 4) and tx.shape == x.shape and tx.dtype == torch.float32
    scale = max(1.0, float(np.abs(jlat).max()))
    _close(tlat / scale, np.asarray(jlat) / scale, 1e-6)
    _close(tx, jx, 1e-6 * max(1.0, float(np.abs(jx).max())))
    np.testing.assert_array_equal(tlat[0].numpy(), np.asarray(jlat[0]))   # the pre-scale: x * 1


def test_inversion_promotes_a_bf16_latent_to_fp32():
    """JAX multiplies the latent by its fp32 pre-scale, which promotes bf16:
    the port's inversion keeps the latents in fp32 too."""
    ts = tsamp.EulerEDMSampler(tdisc.EDMDiscretization(sigma_min=0.1, sigma_max=10.0), num_steps=3)
    x = torch.ones(1, 2, dtype=torch.bfloat16)
    xt, lat = ts.inversion(lambda x, s, i: (x * 0.5, None), x)
    assert xt.dtype == lat.dtype == torch.float32


_VIDEO_VAE = dict(ch=16, ch_mult=(1, 2), num_res_blocks=1, video_decoder=True)


@pytest.mark.parametrize("time_mode", ["all", "attn-only"])
def test_video_decoder_time_modes_match_jax(time_mode):
    """The VideoDecoder at time_mode 'all' (video ResnetBlocks, VideoAttnBlock,
    conv_out's time mix) and 'attn-only' (plain ResnetBlocks, VideoAttnBlock):
    fp32 against JAX's Decoder, weights moved by io/convert.py (the reference's
    keys: mid.attn_1.time_mix_block.*, mid.attn_1.video_time_embed.{0,2}.*,
    mid.attn_1.mix_factor) and back by the JAX package's convert_state_dict
    with the port's key function; a 16 x 16 latent, so the mid attention's
    64 tokens and the temporal attention over 3 frames are real."""
    t = 3
    z = np.random.RandomState(9).randn(t, 16, 16, 4).astype(np.float32)
    jd = jvae.Decoder(jvae.VAEConfig(time_mode=time_mode, **_VIDEO_VAE))
    params = _init_tree(jd, 3, jnp.asarray(z), timesteps=t)
    mix = params["mid_attn_1"]["mix_factor"]
    params["mid_attn_1"]["mix_factor"] = np.full_like(mix, 0.3)   # both branches of the merge weigh in
    td = _load(tvae.Decoder(tvae.VAEConfig(time_mode=time_mode, **_VIDEO_VAE)), params, convert.vae_key_fn)
    assert isinstance(td.mid.attn_1, tvae.VideoAttnBlock)
    assert isinstance(td.mid.block_1, tvae.VideoVAEResnetBlock) == (time_mode == "all")
    assert isinstance(td.conv_out, tvae.AE3DConv) == (time_mode == "all")
    keys = set(td.state_dict())
    assert {"mid.attn_1.mix_factor", "mid.attn_1.video_time_embed.0.weight", "mid.attn_1.video_time_embed.2.bias",
            "mid.attn_1.time_mix_block.ff_in.net.0.proj.weight", "mid.attn_1.time_mix_block.attn2.to_out.0.weight",
            "mid.attn_1.time_mix_block.norm_in.weight"} <= keys
    with torch.no_grad():
        _close(td(torch.from_numpy(z), t), _apply(jd, params, jnp.asarray(z), timesteps=t), MODULE_TOL)
    _round_trip(params, td, convert.vae_key_fn)


def test_video_decoder_refuses_an_unknown_time_mode():
    with pytest.raises(ValueError, match="time_mode"):
        tvae.Decoder(tvae.VAEConfig(time_mode="temporal", **_VIDEO_VAE))


def test_jax_video_attn_block_attn2_layout_hazard(monkeypatch):
    """Pinned JAX hazard (ROADMAP section C): JAX's VideoAttnBlock builds its
    time_mix_block with no context, so attn2 is a self-attention over the rows
    of whatever layout the block runs in: the s tokens of each frame in the
    direct layout (the default, which the port follows), the t frames of each
    token in the folded one (the reference's). The two layouts give different
    outputs; the port equals the direct one."""
    t, c = 3, 32
    x = np.random.RandomState(4).randn(t, 4, 4, c).astype(np.float32)
    jb = jvae.VideoAttnBlock()
    params = _init_tree(jb, 6, jnp.asarray(x), timesteps=t)
    params["mix_factor"] = np.full_like(params["mix_factor"], 0.3)
    monkeypatch.setenv("VIDSEG_TEMPORAL_LAYOUT", "direct")
    direct = np.asarray(_apply(jb, params, jnp.asarray(x), timesteps=t))
    monkeypatch.setenv("VIDSEG_TEMPORAL_LAYOUT", "folded")
    folded = np.asarray(_apply(jb, params, jnp.asarray(x), timesteps=t))
    assert np.abs(direct - folded).max() > 1e-2 * np.abs(direct).max()
    tb = tvae.VideoAttnBlock(c)
    sd = convert.jax_to_state_dict(params, lambda p: convert.vae_key_fn(("mid_attn_1",) + p)[len("mid.attn_1."):])
    tb.load_state_dict({k: torch.tensor(v) for k, v in sd.items()}, strict=True)
    with torch.no_grad():
        got = tb.eval()(torch.from_numpy(x), t)
    _close(got, direct, MODULE_TOL)
