"""The whole SVD VidSeg slice: the port's run_single_video against the JAX
package's on configs/inference/svd_tiny.yaml, on the CPU, in fp32.

Both run from the same weights (the JAX pipeline's random parameters moved
into the port with io/convert.py) and the same random draws: the port is
handed the cond-aug noise, the add_noise noise and the kmeans initial
centres that the JAX pipeline draws from its keys. The JAX feature-pass x0,
cached trajectory and final run latents are captured by wrapping its engine
entry points (the JAX package is not changed). The same comparison runs a
second time with is_injected_features: the temporal self-attention q/k that
both feature passes cache (JAX in its default direct layout) must agree, and
so must the injected runs.
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
from vidseg_diffusion_tpu.models.clip import clip_vision_key_fn
from vidseg_diffusion_tpu.ops.kmeans import _kmeanspp_init
from vidseg_diffusion_tpu.pipelines.single_video import VidSegArgs as JArgs
from vidseg_diffusion_tpu.pipelines.single_video import run_single_video as j_run
from vidseg_diffusion_tpu_torch.engine import vidseg as tvidseg
from vidseg_diffusion_tpu_torch.engine.build import build_pipeline as t_build
from vidseg_diffusion_tpu_torch.io import convert
from vidseg_diffusion_tpu_torch.pipelines.single_video import VidSegArgs, run_single_video

CONFIG = "configs/inference/svd_tiny.yaml"
T, HPX, WPX, STEPS, MASKS, SEED = 3, 64, 64, 6, 2, 1
ARGS = dict(num_steps=STEPS, num_masks=MASKS, modulate_timestep=(3,), feature_timestep=(5,),
            decoding_t=3, seed=SEED)
LATENT_RTOL = 1e-3   # fp32 through 3 + 2*2*3 UNet steps: |port - jax| <= 1e-3 * max(1, max|jax|)


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


def _run_both(out_dir, **flags):
    """(JAX result, captured JAX tensors, port result, captured port cache)."""
    frames = np.random.RandomState(0).uniform(-1, 1, (T, HPX, WPX, 3)).astype(np.float32)
    names = [str(i) for i in range(T)]
    jp = j_build(CONFIG, num_steps=STEPS, num_frames=T)

    captured = {}
    eng = jvidseg.VidSegEngine
    orig_xt, orig_runs = eng.jit_xt_cache, eng.modulated_runs_host_stepped

    def xt_cache(self):
        f = orig_xt.func(self)

        def run(*a, **kw):
            x0, cache = f(*a, **kw)
            captured.update(x0=np.asarray(x0), xt=np.asarray(cache["xt"]))
            captured["qk"] = {n: np.asarray(v) for n, v in cache.items() if "_temporal_self_" in n}
            return x0, cache

        return run

    def runs_stepped(self, *a, **kw):
        out = orig_runs(self, *a, **kw)
        captured["finals"] = np.asarray(out)
        return out

    mp = pytest.MonkeyPatch()
    mp.setattr(eng, "jit_xt_cache", property(xt_cache))
    mp.setattr(eng, "modulated_runs_host_stepped", runs_stepped)
    try:
        jres = j_run(jp, frames, names, JArgs(mesh="off", runs_chunk=1, **ARGS, **flags),
                     write_outputs=False)
    finally:
        mp.undo()

    # the random draws of run_single_video, from the same keys
    rng0 = jax.random.PRNGKey(SEED)
    r_aug, rng = jax.random.split(rng0)[0], jax.random.fold_in(rng0, 1)
    aug = np.asarray(jax.random.normal(r_aug, (1, HPX, WPX, 3)))
    noise = np.asarray(jax.random.normal(jax.random.fold_in(rng, 2), (T, HPX // 8, WPX // 8, 4)))
    pts = _normalize(jnp.asarray(jres.cluster_features, jnp.float32))[T:]
    pts = pts.reshape(-1, pts.shape[-1])
    keys = jax.random.split(jax.random.fold_in(rng, 3), 10)
    init = np.array(jax.jit(jax.vmap(lambda k: _kmeanspp_init(k, pts, MASKS)))(keys))

    tp = t_build(CONFIG, num_steps=STEPS, num_frames=T, device="cpu")
    tp.unet.load_state_dict(_sd(jp.unet_params, unet_key_fn))
    tp.first_stage.encoder.load_state_dict(_sd(jp.first_stage.params_encoder, convert.vae_key_fn))
    tp.first_stage.decoder.load_state_dict(_sd(jp.first_stage.params_decoder, convert.vae_key_fn))
    closure = inspect.getclosurevars(jp.condition_video).nonlocals
    tp.clip.load_state_dict(_sd(closure["vparams"], clip_vision_key_fn, "visual."))
    tp.cond_encoder.load_state_dict(_sd(closure["cenc_params"], convert.vae_key_fn))
    tcache = {}
    orig_pass = tvidseg.VidSegEngine.xt_cache_pass

    def xt_cache_pass(self, *a, **kw):
        x0, cache = orig_pass(self, *a, **kw)
        tcache.update(cache)
        return x0, cache

    mp.setattr(tvidseg.VidSegEngine, "xt_cache_pass", xt_cache_pass)
    try:
        tres = run_single_video(
            tp, frames, names, VidSegArgs(feature_folder=str(out_dir), **ARGS, **flags),
            write_outputs=out_dir is not None, cond_aug_noise=aug, noise=noise, kmeans_init=init)
    finally:
        mp.undo()
    return jres, captured, tres, tcache


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out_dir = tmp_path_factory.mktemp("vidseg")
    jres, captured, tres, _ = _run_both(out_dir)
    return jres, captured, tres, out_dir


@pytest.fixture(scope="module")
def injected_runs():
    return _run_both(None, is_injected_features=True)


def _rel_close(got, want, rtol):
    scale = max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) <= rtol * scale


def test_feature_pass_and_runs_match_jax(runs):
    jres, cap, tres, _ = runs
    _rel_close(tres.feature_x0, cap["x0"], LATENT_RTOL)
    _rel_close(tres.cached_xt, cap["xt"], LATENT_RTOL)
    np.testing.assert_allclose(tres.cluster_features, jres.cluster_features, atol=1e-3, rtol=1e-3)
    np.testing.assert_array_equal(tres.masks, jres.masks)
    assert tres.final_latents.shape == cap["finals"].shape == (2, MASKS, T, HPX // 8, WPX // 8, 4)
    _rel_close(tres.final_latents, cap["finals"], LATENT_RTOL)


def test_runs_differ_and_blending_pins_outside(runs):
    _, _, tres, _ = runs
    fin = tres.final_latents
    assert np.abs(fin[0] - fin[1]).max() > 1e-3
    for s in range(2):
        for m in range(MASKS):
            outside = (fin[s, m] - tres.cached_xt[-1]) * (1 - tres.masks_latent[m][..., None])
            assert np.abs(outside).max() == 0.0


def test_difference_maps_and_labels_match_jax(runs):
    """Diff maps: uint8 quanta, equal on >= 99% of pixels and within 1
    elsewhere (a decode difference of 1e-5 can still move a truncation by one
    quantum). Labels: equal wherever JAX's top-2 margin exceeds one quantum.
    The argmax compares maps normalized by their max, so the margin is
    counted in quanta of the frame's smallest map max (a one-quantum change
    of a map moves its normalized value by 1/max)."""
    jres, _, tres, _ = runs
    d = np.abs(tres.diff_maps - jres.diff_maps)
    assert (d == 0).mean() >= 0.99 and d.max() <= 1
    maxes = jres.diff_maps.max(axis=(-2, -1), keepdims=True)          # [M, T, 1, 1]
    norm = jres.diff_maps / (maxes + 1e-5)
    top2 = np.sort(norm, axis=0)[-2:]
    sure = (top2[1] - top2[0]) * maxes.min(axis=0) > 1.0
    assert sure.mean() > 0.5
    np.testing.assert_array_equal(tres.seg_raw[sure], jres.seg_raw[sure])
    assert set(np.unique(tres.seg_raw)) <= set(range(MASKS))
    assert tres.seg_filtered.shape == jres.seg_filtered.shape == (T, HPX, WPX)


def test_outputs_tree_written(runs):
    _, _, _, out_dir = runs
    assert len(list(out_dir.glob("default/kmeans_masks/*/kmeans_time_5_frame_0/mask_*.png"))) == MASKS
    assert len(list(out_dir.glob("default/segmentation_map_raw/*/0.png"))) == 1


def test_injection_harvest_matches_jax(injected_runs):
    """The feature pass caches temporal self-attention q and k of every
    attention-bearing output block, in the direct layout [(b t), s, H*D],
    windowed from the first modulated step; equal to JAX's at 1e-4."""
    _, cap, tres, tcache = injected_runs
    names = sorted(n for n in tcache if "_temporal_self_" in n)
    assert names and names == sorted(cap["qk"])
    assert len(names) % 2 == 0 and tcache["t0"] == min(ARGS["modulate_timestep"])
    for n in names:
        got, want = tcache[n].numpy(), cap["qk"][n]
        assert got.shape == want.shape and got.shape[:2] == (STEPS - tcache["t0"], 2 * T)
        np.testing.assert_allclose(got, want, atol=1e-4 * max(1.0, float(np.abs(want).max())), rtol=0)
    assert tres.injected_cache_bytes == sum(tcache[n].numel() * 4 for n in names)


def test_injected_runs_match_jax(injected_runs):
    jres, cap, tres, _ = injected_runs
    _rel_close(tres.feature_x0, cap["x0"], LATENT_RTOL)
    _rel_close(tres.final_latents, cap["finals"], LATENT_RTOL)
    np.testing.assert_array_equal(tres.masks, jres.masks)
    d = np.abs(tres.diff_maps - jres.diff_maps)
    assert (d == 0).mean() >= 0.99 and d.max() <= 1
    maxes = jres.diff_maps.max(axis=(-2, -1), keepdims=True)
    norm = jres.diff_maps / (maxes + 1e-5)
    top2 = np.sort(norm, axis=0)[-2:]
    sure = (top2[1] - top2[0]) * maxes.min(axis=0) > 1.0
    assert sure.mean() > 0.5
    np.testing.assert_array_equal(tres.seg_raw[sure], jres.seg_raw[sure])


def test_injection_changes_the_runs_and_counts_its_sites(runs, injected_runs):
    """Injected runs differ from the un-injected ones (same frames, noise and
    masks), still differ between +lambda and -lambda, keep the outside-mask
    cells on the cached trajectory, and every (run, gated step, injected
    block) took cached q/k."""
    _, _, plain, _ = runs
    _, _, tres, tcache = injected_runs
    np.testing.assert_array_equal(plain.masks, tres.masks)
    np.testing.assert_array_equal(plain.cached_xt, tres.cached_xt)
    assert np.abs(plain.final_latents - tres.final_latents).max() > 1e-5  # exact 0 without injection
    fin = tres.final_latents
    assert np.abs(fin[0] - fin[1]).max() > 1e-3
    for s in range(2):
        for m in range(MASKS):
            outside = (fin[s, m] - tres.cached_xt[-1]) * (1 - tres.masks_latent[m][..., None])
            assert np.abs(outside).max() == 0.0
    blocks = len([n for n in tcache if n.endswith("_temporal_self_q")])
    gated_steps = STEPS - min(ARGS["modulate_timestep"])
    assert tres.injected_sites == 2 * MASKS * gated_steps * blocks > 0
    assert plain.injected_sites == 0 and plain.injected_cache_bytes == 0


@pytest.mark.parametrize("flag,value", [
    ("is_refine_mask", True),
    ("feature_extraction_mode", "match_gt_mask"), ("inversion_type", "inversion"),
])
def test_unported_flags_raise(flag, value):
    args = VidSegArgs(**{**ARGS, flag: value})
    frames = np.zeros((T, HPX, WPX, 3), np.float32)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        run_single_video(None, frames, ["0", "1", "2"], args, write_outputs=False)


def test_build_pipeline_loads_an_sgm_checkpoint(tmp_path):
    """A checkpoint with the reference's key names (open_clip's packed
    in_proj included) loads into the port's modules unchanged."""
    src = t_build(CONFIG, num_steps=STEPS, num_frames=T, seed=3, device="cpu")
    sd = {}
    for prefix, module in (("model.diffusion_model.", src.unet),
                           ("first_stage_model.encoder.", src.first_stage.encoder),
                           ("first_stage_model.decoder.", src.first_stage.decoder),
                           ("conditioner.embedders.3.encoder.encoder.", src.cond_encoder)):
        sd.update({prefix + k: v for k, v in module.state_dict().items()})
    clip = dict(src.clip.state_dict())
    for i in range(len(src.clip.transformer.resblocks)):
        base = f"transformer.resblocks.{i}.attn."
        for leaf in ("weight", "bias"):
            clip[base + "in_proj_" + leaf] = torch.cat([clip.pop(f"{base}{n}.{leaf}") for n in "qkv"])
            clip[f"{base}out_proj.{leaf}"] = clip.pop(f"{base}out.{leaf}")
    sd.update({"conditioner.embedders.0.open_clip.model.visual." + k: v for k, v in clip.items()})
    path = tmp_path / "svd.ckpt"
    torch.save({"state_dict": sd}, path)
    dst = t_build(CONFIG, ckpt_path=str(path), num_steps=STEPS, num_frames=T, device="cpu")
    for a, b in ((src.unet, dst.unet), (src.clip, dst.clip), (src.cond_encoder, dst.cond_encoder),
                 (src.first_stage.encoder, dst.first_stage.encoder),
                 (src.first_stage.decoder, dst.first_stage.decoder)):
        sa, sb = a.state_dict(), b.state_dict()
        assert sa.keys() == sb.keys()
        assert all(torch.equal(sa[k], sb[k]) for k in sa)
    with pytest.raises(FileNotFoundError):
        t_build(CONFIG, ckpt_path=str(tmp_path / "missing.ckpt"), device="cpu")


def test_feature_timestep_before_cache_window_raises():
    tp = t_build(CONFIG, num_steps=STEPS, num_frames=T, device="cpu")
    frames = np.zeros((T, HPX, WPX, 3), np.float32)
    args = VidSegArgs(**{**ARGS, "feature_timestep": (1,)})
    with pytest.raises(ValueError, match="precedes the cache window"):
        run_single_video(tp, frames, ["0", "1", "2"], args, write_outputs=False)
