"""The whole SD 2.1 VidSeg slice: the port's run_single_video against the JAX
package's on configs/inference/sd_tiny.yaml, on the CPU, in fp32.

Both run from the same weights (the JAX pipeline's random parameters moved
into the port with io/convert.py: image UNet, text tower, image VAE), the
same empty-prompt tokens and the same random draws: the port is handed the
add_noise noise and the kmeans initial centres that the JAX pipeline draws
from its keys. The settings are the SD sweep's at a small size: modulate block
7 (re-targeted to the tiny UNet's half-resolution attention block), cluster
block 7, the SD blend window (latent blending ends one step after the first
modulated step), lambda on the spatial cross-attention. The JAX feature-pass
x0, cached trajectory and final run latents are captured by wrapping its
engine entry points (the JAX package is not changed). The same comparison
runs a second time with is_injected_features: the spatial self- and
cross-attention q/k that both feature passes cache must agree, and so must
the injected runs; and a third time with inversion_type 'inversion', as
the packages run it and with the flipped schedule's first sigma raised to
the denoiser table's smallest (the inversion's arithmetic where it is well
conditioned).
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vidseg_diffusion_tpu.engine import vidseg as jvidseg
from vidseg_diffusion_tpu.engine.build import build_pipeline as j_build
from vidseg_diffusion_tpu.engine.masks import _normalize
from vidseg_diffusion_tpu.io.checkpoint import unet_key_fn
from vidseg_diffusion_tpu.io.tokenizer import tokenize_empty as j_tokenize_empty
from vidseg_diffusion_tpu.models.clip import clip_text_key_fn
from vidseg_diffusion_tpu.ops.kmeans import _kmeanspp_init
from vidseg_diffusion_tpu.pipelines.single_video import VidSegArgs as JArgs
from vidseg_diffusion_tpu.pipelines.single_video import run_single_video as j_run
from vidseg_diffusion_tpu_torch.engine import vidseg as tvidseg
from vidseg_diffusion_tpu_torch.engine.build import build_pipeline as t_build
from vidseg_diffusion_tpu_torch.io import convert
from vidseg_diffusion_tpu_torch.diffusion.discretization import LegacyDDPMDiscretization
from vidseg_diffusion_tpu_torch.io.tokenizer import tokenize_empty
from vidseg_diffusion_tpu_torch.pipelines.single_video import VidSegArgs, run_single_video

CONFIG = "configs/inference/sd_tiny.yaml"
T, HPX, WPX, STEPS, MASKS, SEED = 3, 64, 64, 6, 2, 1
MOD_STEP = 3
ARGS = dict(num_steps=STEPS, num_masks=MASKS, modulate_block_idx=(7,), modulate_timestep=(MOD_STEP,),
            feature_timestep=(5,), decoding_t=2, seed=SEED, sd_blend_window=True)
LATENT_RTOL = 1e-3   # fp32 through 3 + 2*2*6 UNet steps: |port - jax| <= 1e-3 * max(1, max|jax|)
INJECTED = ("_spatial_self_", "_spatial_cross_")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the small CPU shapes here gain nothing from more,
    and idle OpenMP threads spin against the suite's other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sd(tree, key_fn, strip=""):
    np_tree = jax.tree.map(np.asarray, tree)
    return {k: torch.tensor(v) for k, v in convert.jax_to_state_dict(np_tree, key_fn, strip).items()}


def _run_both(**flags):
    """(JAX result, captured JAX tensors, port result, captured port cache)."""
    frames = np.random.RandomState(0).uniform(-1, 1, (T, HPX, WPX, 3)).astype(np.float32)
    names = [str(i) for i in range(T)]
    jp = j_build(CONFIG, num_steps=STEPS, num_frames=T)

    captured = {}
    eng = jvidseg.VidSegEngine
    orig_xt, orig_runs, orig_invert = eng.jit_xt_cache, eng.modulated_runs_host_stepped, eng.jit_invert

    def xt_cache(self):
        f = orig_xt.func(self)

        def run(*a, **kw):
            x0, cache = f(*a, **kw)
            captured.update(x0=np.asarray(x0), xt=np.asarray(cache["xt"]))
            captured["qk"] = {n: np.asarray(v) for n, v in cache.items() if any(s in n for s in INJECTED)}
            return x0, cache

        return run

    def runs_stepped(self, *a, **kw):
        out = orig_runs(self, *a, **kw)
        captured["finals"] = np.asarray(out)
        return out

    def invert(self):
        f = orig_invert.func(self)

        def run(*a):
            captured["inverted"] = np.asarray(f(*a))
            return captured["inverted"]

        return run

    mp = pytest.MonkeyPatch()
    mp.setattr(eng, "jit_xt_cache", property(xt_cache))
    mp.setattr(eng, "modulated_runs_host_stepped", runs_stepped)
    mp.setattr(eng, "jit_invert", property(invert))
    try:
        jres = j_run(jp, frames, names, JArgs(mesh="off", runs_chunk=1, **ARGS, **flags),
                     text_tokens=j_tokenize_empty(1), write_outputs=False)
    finally:
        mp.undo()

    # the random draws of run_single_video's image branch, from the same keys
    rng = jax.random.PRNGKey(SEED)
    noise = np.asarray(jax.random.normal(jax.random.fold_in(rng, 2), (T, HPX // 8, WPX // 8, 4)))
    pts = _normalize(jnp.asarray(jres.cluster_features, jnp.float32))[T:]
    pts = pts.reshape(-1, pts.shape[-1])
    keys = jax.random.split(jax.random.fold_in(rng, 3), 10)
    init = np.array(jax.jit(jax.vmap(lambda k: _kmeanspp_init(k, pts, MASKS)))(keys))

    tp = t_build(CONFIG, num_steps=STEPS, num_frames=T, device="cpu")
    assert tp.clip is None and tp.cond_encoder is None and not tp.spec.unet_config.video
    tp.unet.load_state_dict(_sd(jp.unet_params, unet_key_fn))
    tp.first_stage.encoder.load_state_dict(_sd(jp.first_stage.params_encoder, convert.vae_key_fn))
    tp.first_stage.decoder.load_state_dict(_sd(jp.first_stage.params_decoder, convert.vae_key_fn))
    tparams = inspect.getclosurevars(jp.clip_apply).nonlocals["tparams"]
    tp.text.load_state_dict(_sd(tparams, clip_text_key_fn))
    tcache = {}
    orig_pass, orig_tinvert = tvidseg.VidSegEngine.xt_cache_pass, tvidseg.VidSegEngine.invert

    def xt_cache_pass(self, *a, **kw):
        x0, cache = orig_pass(self, *a, **kw)
        tcache.update(cache)
        return x0, cache

    def tinvert(self, *a):
        tcache["inverted"] = orig_tinvert(self, *a)
        return tcache["inverted"]

    # the latents that enter the step after the SD blend window: the feature
    # pass's first, then those of the 2 * MASKS runs in order
    after_blend = []
    orig_step = tvidseg.EulerEDMSampler.step

    def step(self, denoise_fn, x, sigma, next_sigma, i):
        if i == MOD_STEP + 2:
            after_blend.append(x.numpy().copy())
        return orig_step(self, denoise_fn, x, sigma, next_sigma, i)

    mp.setattr(tvidseg.VidSegEngine, "xt_cache_pass", xt_cache_pass)
    mp.setattr(tvidseg.VidSegEngine, "invert", tinvert)
    mp.setattr(tvidseg.EulerEDMSampler, "step", step)
    try:
        tres = run_single_video(tp, frames, names, VidSegArgs(**ARGS, **flags), write_outputs=False,
                                noise=noise, kmeans_init=init, text_tokens=tokenize_empty(1))
    finally:
        mp.undo()
    tcache["after_blend"] = after_blend
    return jres, captured, tres, tcache


@pytest.fixture(scope="module")
def runs():
    return _run_both()


@pytest.fixture(scope="module")
def injected_runs():
    return _run_both(is_injected_features=True)


@pytest.fixture(scope="module")
def inversion_runs():
    return _run_both(inversion_type="inversion")


def _rel_close(got, want, rtol):
    scale = max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) <= rtol * scale


def _labels_match(tres, jres):
    """Diff maps equal on >= 99% of pixels and within one uint8 quantum
    elsewhere; labels equal wherever JAX's top-2 margin exceeds one quantum
    (as tests/test_torch_pipeline.py holds the SVD slice)."""
    d = np.abs(tres.diff_maps - jres.diff_maps)
    assert (d == 0).mean() >= 0.99 and d.max() <= 1
    maxes = jres.diff_maps.max(axis=(-2, -1), keepdims=True)
    norm = jres.diff_maps / (maxes + 1e-5)
    top2 = np.sort(norm, axis=0)[-2:]
    sure = (top2[1] - top2[0]) * maxes.min(axis=0) > 1.0
    assert sure.mean() > 0.5
    np.testing.assert_array_equal(tres.seg_raw[sure], jres.seg_raw[sure])
    assert tres.seg_filtered.shape == jres.seg_filtered.shape == (T, HPX, WPX)


def test_sd_feature_pass_and_runs_match_jax(runs):
    jres, cap, tres, tcache = runs
    assert tcache["t0"] == MOD_STEP and cap["xt"].shape[0] == STEPS - MOD_STEP
    _rel_close(tres.feature_x0, cap["x0"], LATENT_RTOL)
    _rel_close(tres.cached_xt, cap["xt"], LATENT_RTOL)
    np.testing.assert_allclose(tres.cluster_features, jres.cluster_features, atol=1e-3, rtol=1e-3)
    np.testing.assert_array_equal(tres.masks, jres.masks)
    assert tres.final_latents.shape == cap["finals"].shape == (2, MASKS, T, HPX // 8, WPX // 8, 4)
    _rel_close(tres.final_latents, cap["finals"], LATENT_RTOL)


def test_sd_difference_maps_and_labels_match_jax(runs):
    jres, _, tres, _ = runs
    _labels_match(tres, jres)
    assert set(np.unique(tres.seg_raw)) <= set(range(MASKS))


def test_sd_blend_window_pins_outside_until_its_last_step(runs):
    """With the SD window latent blending stops at min(modulate_timestep) + 1:
    right after that step the outside-mask cells equal the cached trajectory
    exactly, and the steps after it move them again."""
    _, _, tres, tcache = runs
    blend_end = MOD_STEP + 1
    assert blend_end < STEPS - 1
    fin, entered = tres.final_latents, tcache["after_blend"]
    assert len(entered) == 1 + 2 * MASKS   # the feature pass, then the runs
    pinned = np.stack(entered[1:]).reshape(fin.shape)
    assert np.abs(fin[0] - fin[1]).max() > 1e-3
    ori = tres.cached_xt[blend_end - tres.cache_t0]
    np.testing.assert_array_equal(entered[0], ori)
    for s in range(2):
        for m in range(MASKS):
            keep = 1 - tres.masks_latent[m][..., None]
            assert np.abs((pinned[s, m] - ori) * keep).max() == 0.0
            assert np.abs((pinned[s, m] - ori) * (1 - keep)).max() > 0.0
            assert np.abs((fin[s, m] - tres.cached_xt[-1]) * keep).max() > 0.0


def test_sd_injection_harvest_matches_jax(injected_runs):
    """The feature pass caches the spatial self- and cross-attention q and k of
    every attention-bearing output block ([2T, L, C]; the cross-attention k
    over the 77 context tokens), windowed from the first modulated step."""
    _, cap, tres, tcache = injected_runs
    names = sorted(n for n in tcache if any(s in n for s in INJECTED))
    assert names and names == sorted(cap["qk"]) and len(names) % 4 == 0
    for n in names:
        got, want = tcache[n].numpy(), cap["qk"][n]
        assert got.shape == want.shape and got.shape[:2] == (STEPS - MOD_STEP, 2 * T)
        assert got.shape[2] == 77 or not n.endswith("_spatial_cross_k")
        np.testing.assert_allclose(got, want, atol=1e-4 * max(1.0, float(np.abs(want).max())), rtol=0)
    assert tres.injected_cache_bytes == sum(tcache[n].numel() * 4 for n in names)


def test_sd_injected_runs_match_jax(runs, injected_runs):
    jres, cap, tres, tcache = injected_runs
    _rel_close(tres.feature_x0, cap["x0"], LATENT_RTOL)
    _rel_close(tres.final_latents, cap["finals"], LATENT_RTOL)
    np.testing.assert_array_equal(tres.masks, jres.masks)
    _labels_match(tres, jres)
    plain = runs[2]
    np.testing.assert_array_equal(plain.cached_xt, tres.cached_xt)
    assert np.abs(plain.final_latents - tres.final_latents).max() > 1e-5   # exact 0 without injection
    blocks = len([n for n in tcache if n.endswith("_spatial_self_q")])
    assert tres.injected_sites == 2 * MASKS * (STEPS - MOD_STEP) * blocks > 0
    assert plain.injected_sites == 0 and plain.injected_cache_bytes == 0


def test_sd_inversion_runs_match_jax(inversion_runs):
    """inversion_type 'inversion' on the image backbone: the inverted latent,
    the feature pass over all STEPS from it (cache window t0 = 0) and the
    modulated runs against JAX's; equal masks, diff maps and label maps.

    Pinned JAX hazard: the flipped schedule starts at sigma = 1e-8, which the
    DiscreteDenoiser snaps to its table's smallest sigma (~0.03) for c_out,
    while the Euler step divides by 1e-8: the first step moves the latent by
    ~0.03^2 / 1e-8 times the predicted noise. The latents reach ~1e6, every
    decoded frame saturates, both +-lambda decodes agree, and the difference
    maps are zero in both packages (so the labels are the argmax's tie)."""
    jres, cap, tres, tcache = inversion_runs
    assert tcache["inverted"].shape == cap["inverted"].shape == (T, HPX // 8, WPX // 8, 4)
    _rel_close(tcache["inverted"].numpy(), cap["inverted"], LATENT_RTOL)
    assert tres.cache_t0 == 0 and tres.cached_xt.shape == cap["xt"].shape == (STEPS, T, HPX // 8, WPX // 8, 4)
    _rel_close(tres.cached_xt, cap["xt"], LATENT_RTOL)
    _rel_close(tres.feature_x0, cap["x0"], LATENT_RTOL)
    np.testing.assert_array_equal(tres.masks, jres.masks)
    _rel_close(tres.final_latents, cap["finals"], LATENT_RTOL)
    assert np.abs(cap["inverted"]).max() > 1e3 and np.abs(tcache["inverted"].numpy()).max() > 1e3
    np.testing.assert_array_equal(tres.diff_maps, jres.diff_maps)
    np.testing.assert_array_equal(tres.seg_raw, jres.seg_raw)
    np.testing.assert_array_equal(tres.seg_filtered, jres.seg_filtered)


def test_sd_inversion_well_conditioned_matches_jax():
    """The inversion with the flipped schedule's first sigma raised, in both
    packages, to the smallest sigma of the DiscreteDenoiser's 1000-entry
    table, where its c_out is the step's own sigma (the first step is then an
    epsilon step): the inverted latent, every cached step, x0 and the runs
    within LATENT_RTOL, equal masks, the diff maps within one uint8 quantum
    (98.2-98.4 % equal measured: the decoded maps peak at about 20 quanta
    here) and the labels equal wherever JAX's top-2 margin exceeds
    LABEL_MARGIN quanta (they part at near-ties: measured, 30-43 of 12288
    pixels, each at a margin of at most one quantum)."""
    from test_torch_pipeline import LABEL_MARGIN, raised_first_sigma

    mp = raised_first_sigma(float(LegacyDDPMDiscretization()(1000, do_append_zero=False).min()))
    try:
        jres, cap, tres, tcache = _run_both(inversion_type="inversion")
    finally:
        mp.undo()
    _rel_close(tcache["inverted"].numpy(), cap["inverted"], LATENT_RTOL)
    assert tres.cache_t0 == 0 and tres.cached_xt.shape == cap["xt"].shape == (STEPS, T, HPX // 8, WPX // 8, 4)
    _rel_close(tres.cached_xt, cap["xt"], LATENT_RTOL)
    _rel_close(tres.feature_x0, cap["x0"], LATENT_RTOL)
    np.testing.assert_array_equal(tres.masks, jres.masks)
    _rel_close(tres.final_latents, cap["finals"], LATENT_RTOL)
    assert np.abs(cap["finals"]).max() < 1e2   # no blow-up: the hazard above is gone
    assert np.abs(tres.diff_maps.astype(np.int32) - jres.diff_maps.astype(np.int32)).max() <= 1
    maxes = jres.diff_maps.max(axis=(-2, -1), keepdims=True)
    top2 = np.sort(jres.diff_maps / (maxes + 1e-5), axis=0)[-2:]
    sure = (top2[1] - top2[0]) * maxes.min(axis=0) > LABEL_MARGIN
    assert sure.mean() > 0.3
    np.testing.assert_array_equal(tres.seg_raw[sure], jres.seg_raw[sure])


def test_sd_path_needs_text_tokens():
    tp = t_build(CONFIG, num_steps=STEPS, num_frames=T, device="cpu")
    frames = np.zeros((T, HPX, WPX, 3), np.float32)
    with pytest.raises(ValueError, match="tokenized text"):
        run_single_video(tp, frames, ["0", "1", "2"], VidSegArgs(**ARGS), write_outputs=False)


def test_build_pipeline_loads_an_sd_checkpoint(tmp_path):
    """A checkpoint with the reference's key names loads into the SD stack:
    open_clip's packed in_proj, the text tower's unused last block and
    text_projection (left alone), and the AutoencoderKL's quant convolutions."""
    src = t_build(CONFIG, num_steps=STEPS, num_frames=T, seed=3, device="cpu")
    sd = {}
    for prefix, module in (("model.diffusion_model.", src.unet),
                           ("first_stage_model.encoder.", src.first_stage.encoder),
                           ("first_stage_model.decoder.", src.first_stage.decoder)):
        sd.update({prefix + k: v for k, v in module.state_dict().items()})
    text = dict(src.text.state_dict())
    n_blocks = len(src.text.transformer.resblocks)
    for k in [k for k in text if k.startswith(f"transformer.resblocks.{n_blocks - 1}.")]:
        text[k.replace(f"resblocks.{n_blocks - 1}.", f"resblocks.{n_blocks}.")] = text[k].clone()
    for i in range(n_blocks + 1):
        base = f"transformer.resblocks.{i}.attn."
        for leaf in ("weight", "bias"):
            text[base + "in_proj_" + leaf] = torch.cat([text.pop(f"{base}{n}.{leaf}") for n in "qkv"])
            text[f"{base}out_proj.{leaf}"] = text.pop(f"{base}out.{leaf}")
    text["text_projection"] = torch.zeros(64, 64)
    sd.update({"conditioner.embedders.0.model." + k: v for k, v in text.items()})
    g = torch.Generator().manual_seed(5)
    sd["first_stage_model.quant_conv.weight"] = torch.randn(8, 8, 1, 1, generator=g)
    sd["first_stage_model.quant_conv.bias"] = torch.randn(8, generator=g)
    sd["first_stage_model.post_quant_conv.weight"] = torch.randn(4, 4, 1, 1, generator=g)
    sd["first_stage_model.post_quant_conv.bias"] = torch.randn(4, generator=g)
    path = tmp_path / "sd.ckpt"
    torch.save({"state_dict": sd}, path)
    dst = t_build(CONFIG, ckpt_path=str(path), num_steps=STEPS, num_frames=T, device="cpu")
    for a, b in ((src.unet, dst.unet), (src.text, dst.text),
                 (src.first_stage.encoder, dst.first_stage.encoder),
                 (src.first_stage.decoder, dst.first_stage.decoder)):
        sa, sb = a.state_dict(), b.state_dict()
        assert sa.keys() == sb.keys()
        assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert src.first_stage.quant_conv is None
    assert torch.equal(dst.first_stage.quant_conv.weight, sd["first_stage_model.quant_conv.weight"])
    assert torch.equal(dst.first_stage.post_quant_conv.bias, sd["first_stage_model.post_quant_conv.bias"])
    z = torch.randn(2, 8, 8, 4, generator=g)
    assert not torch.allclose(dst.first_stage.decode(z), src.first_stage.decode(z))
