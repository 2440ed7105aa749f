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
so must the injected runs; and a third time with is_aggre_attn (the cluster
features are the mean of three blocks' q, rounded where jnp.mean rounds).
A fourth run hands both the same precomputed masks (mask_override), a fifth
runs inversion_type 'inversion' (the latents inverted over every step). The
signature and cluster_feature_hw are held to the JAX function's too
(match_gt_mask with gt_mask / gt_state and is_refine_mask: test_torch_masks.py).
"""

import inspect
import types

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
from vidseg_diffusion_tpu.config import load_model_spec as j_spec
from vidseg_diffusion_tpu.pipelines.single_video import VidSegArgs as JArgs
from vidseg_diffusion_tpu.pipelines.single_video import cluster_feature_hw as j_cluster_hw
from vidseg_diffusion_tpu.pipelines.single_video import run_single_video as j_run
from vidseg_diffusion_tpu_torch.engine import vidseg as tvidseg
from vidseg_diffusion_tpu_torch.engine.build import build_pipeline as t_build
from vidseg_diffusion_tpu_torch.engine.masks import aggregate_blocks
from vidseg_diffusion_tpu_torch.config import load_model_spec as t_spec
from vidseg_diffusion_tpu_torch.io import convert
from vidseg_diffusion_tpu_torch.pipelines.single_video import VidSegArgs, cluster_feature_hw, run_single_video

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


def _run_both(out_dir, config=CONFIG, mask_override=None, **flags):
    """(JAX result, captured JAX tensors, port result, captured port cache);
    mask_override goes to both run_single_videos."""
    frames = np.random.RandomState(0).uniform(-1, 1, (T, HPX, WPX, 3)).astype(np.float32)
    names = [str(i) for i in range(T)]
    jp = j_build(config, num_steps=STEPS, num_frames=T)

    captured = {}
    eng = jvidseg.VidSegEngine
    orig_xt, orig_runs, orig_invert = eng.jit_xt_cache, eng.modulated_runs_host_stepped, eng.jit_invert

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

    def invert(self):
        f = orig_invert.func(self)

        def run(*a):
            out = f(*a)
            captured["inverted"] = np.asarray(out)
            return out

        return run

    mp = pytest.MonkeyPatch()
    mp.setattr(eng, "jit_xt_cache", property(xt_cache))
    mp.setattr(eng, "modulated_runs_host_stepped", runs_stepped)
    mp.setattr(eng, "jit_invert", property(invert))
    try:
        jres = j_run(jp, frames, names, JArgs(mesh="off", runs_chunk=1, **ARGS, **flags),
                     write_outputs=False, mask_override=mask_override)
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

    tp = t_build(config, num_steps=STEPS, num_frames=T, device="cpu")
    tp.unet.load_state_dict(_sd(jp.unet_params, unet_key_fn))
    tp.first_stage.encoder.load_state_dict(_sd(jp.first_stage.params_encoder, convert.vae_key_fn))
    tp.first_stage.decoder.load_state_dict(_sd(jp.first_stage.params_decoder, convert.vae_key_fn))
    closure = inspect.getclosurevars(jp.condition_video).nonlocals
    tp.clip.load_state_dict(_sd(closure["vparams"], clip_vision_key_fn, "visual."))
    tp.cond_encoder.load_state_dict(_sd(closure["cenc_params"], convert.vae_key_fn))
    tcache = {}
    orig_pass, orig_tinvert = tvidseg.VidSegEngine.xt_cache_pass, tvidseg.VidSegEngine.invert

    def xt_cache_pass(self, *a, **kw):
        x0, cache = orig_pass(self, *a, **kw)
        tcache.update(cache)
        return x0, cache

    def tinvert(self, *a):
        tcache["inverted"] = orig_tinvert(self, *a)
        return tcache["inverted"]

    mp.setattr(tvidseg.VidSegEngine, "xt_cache_pass", xt_cache_pass)
    mp.setattr(tvidseg.VidSegEngine, "invert", tinvert)
    try:
        tres = run_single_video(
            tp, frames, names, VidSegArgs(feature_folder=str(out_dir), **ARGS, **flags),
            write_outputs=out_dir is not None, mask_override=mask_override, cond_aug_noise=aug, noise=noise,
            kmeans_init=init)
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


@pytest.fixture(scope="module")
def aggre_runs(tmp_path_factory):
    """is_aggre_attn clusters on blocks 8, 7 and 6 of the reference UNet,
    three blocks of one resolution; svd_tiny.yaml's output levels hold two
    blocks each, so its third block resolves to the finer level and both
    pipelines refuse to stack it. svd_tiny.yaml with num_res_blocks 2 (three
    output blocks per level) runs it."""
    with open(CONFIG) as f:
        text = f.read()
    unet = text.index("network_config:")
    assert text.index("num_res_blocks: 1") > unet   # the UNet's comes first
    path = tmp_path_factory.mktemp("aggre") / "svd_tiny_3_blocks.yaml"
    path.write_text(text.replace("num_res_blocks: 1", "num_res_blocks: 2", 1))
    return _run_both(None, config=str(path), is_aggre_attn=True)


@pytest.fixture(scope="module")
def inversion_runs():
    """inversion_type 'inversion': the latents inverted over all STEPS, then the
    feature pass from step 0 (JAX single_video.py:372-387)."""
    return _run_both(None, inversion_type="inversion")


OVERRIDE_MASKS = 3   # not MASKS: the override, not args.num_masks, sets the run count


@pytest.fixture(scope="module")
def override_runs():
    """Both pipelines on the same precomputed one-hot masks [K, T, fh*fw]
    at the clustering block's token resolution: vertical bands, as an
    object-shaped mask would be (per-token noise masks leave the K
    difference maps too alike for the label check to say anything)."""
    fh, fw = j_cluster_hw(types.SimpleNamespace(spec=j_spec(CONFIG, num_frames=T)),
                          JArgs(**ARGS), HPX, WPX, T)
    cols = np.arange(fh * fw) % fw
    labels = np.broadcast_to(cols * OVERRIDE_MASKS // fw, (T, fh * fw))
    masks = (labels[None] == np.arange(OVERRIDE_MASKS)[:, None, None]).astype(np.float32)
    return _run_both(None, mask_override=masks) + (masks,)


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
    _diff_maps_and_labels_match(jres, tres)


def _diff_maps_and_labels_match(jres, tres, quanta=1, margin=1.0, min_sure=0.5):
    """Diff maps within `quanta` uint8 quanta, all but 1 % of the pixels within
    quanta - 1; labels equal where JAX's top-2 margin exceeds `margin` quanta,
    which more than `min_sure` of the pixels do."""
    d = np.abs(tres.diff_maps - jres.diff_maps)
    assert (d <= quanta - 1).mean() >= 0.99 and d.max() <= quanta
    maxes = jres.diff_maps.max(axis=(-2, -1), keepdims=True)          # [M, T, 1, 1]
    norm = jres.diff_maps / (maxes + 1e-5)
    top2 = np.sort(norm, axis=0)[-2:]
    sure = (top2[1] - top2[0]) * maxes.min(axis=0) > margin
    assert sure.mean() > min_sure
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


def _labels_match(jres, tres):
    """Diff maps within one uint8 quantum (equal on >= 99% of pixels), labels
    equal wherever JAX's top-2 margin exceeds one quantum (see
    test_difference_maps_and_labels_match_jax)."""
    d = np.abs(tres.diff_maps - jres.diff_maps)
    assert (d == 0).mean() >= 0.99 and d.max() <= 1
    maxes = jres.diff_maps.max(axis=(-2, -1), keepdims=True)
    norm = jres.diff_maps / (maxes + 1e-5)
    top2 = np.sort(norm, axis=0)[-2:]
    sure = (top2[1] - top2[0]) * maxes.min(axis=0) > 1.0
    assert sure.mean() > 0.5
    np.testing.assert_array_equal(tres.seg_raw[sure], jres.seg_raw[sure])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_aggregate_blocks_matches_jnp_mean_bit_for_bit(dtype):
    """--is_aggre_attn's block mean against jnp.mean(jnp.stack(feats), axis=0)
    (the JAX pipeline's, single_video.py:452): the sum in fp32, times the
    fp32 reciprocal of the count (what XLA makes of the division), one
    rounding to the features' dtype, so bf16 stays bf16; every bit equal."""
    rs = np.random.RandomState(3)
    feats = [rs.randn(6, 40, 24).astype(np.float32) * 3 for _ in range(3)]
    jf = [jnp.asarray(f, dtype) for f in feats]
    want = np.asarray(jnp.mean(jnp.stack(jf), axis=0).astype(jnp.float32))
    tdt = getattr(torch, dtype)
    got = aggregate_blocks([torch.from_numpy(f).to(tdt) for f in feats])
    assert got.dtype == tdt
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_aggre_attn_runs_match_jax(aggre_runs):
    """is_aggre_attn on svd_tiny.yaml: the aggregated cluster features, the
    masks, the latents (1e-3) and the labels equal JAX's."""
    jres, cap, tres, _ = aggre_runs
    np.testing.assert_allclose(tres.cluster_features, jres.cluster_features, atol=1e-3, rtol=1e-3)
    np.testing.assert_array_equal(tres.masks, jres.masks)
    _rel_close(tres.feature_x0, cap["x0"], LATENT_RTOL)
    _rel_close(tres.final_latents, cap["finals"], LATENT_RTOL)
    _labels_match(jres, tres)


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


def test_mask_override_runs_match_jax(override_runs):
    """mask_override replaces the clustering in both pipelines (JAX
    single_video.py:458-463): the masks are the override's, the labels
    arange(K), the latents within 1e-3 and the label maps JAX's."""
    jres, cap, tres, _, masks = override_runs
    k = OVERRIDE_MASKS
    np.testing.assert_array_equal(tres.unique_labels, np.arange(k))
    np.testing.assert_array_equal(tres.unique_labels, jres.unique_labels)
    np.testing.assert_array_equal(tres.masks, jres.masks)
    np.testing.assert_array_equal(tres.masks.reshape(masks.shape), masks)
    assert tres.final_latents.shape == cap["finals"].shape == (2, k, T, HPX // 8, WPX // 8, 4)
    _rel_close(tres.feature_x0, cap["x0"], LATENT_RTOL)
    _rel_close(tres.final_latents, cap["finals"], LATENT_RTOL)
    _labels_match(jres, tres)
    assert set(np.unique(tres.seg_raw)) <= set(range(k))
    assert tres.gt_state is None and jres.gt_state is None


@pytest.mark.parametrize("config,hpx,wpx,flags,want", [
    ("configs/inference/svd_tiny.yaml", 64, 64, {}, None),
    ("configs/inference/sd_tiny.yaml", 64, 64, {}, None),
    ("configs/inference/svd_tiny.yaml", 128, 192, {"is_aggre_attn": True}, None),
    # the full-width configs at the main paths' 448x832 (56x104 latents): the
    # clustering blocks 8 (SVD) and 7 (SD) sit at latent divisor 2
    ("configs/inference/svd.yaml", 448, 832, {}, (28, 52)),
    ("configs/inference/sd_2_1.yaml", 448, 832, {}, (28, 52)),
])
def test_cluster_feature_hw_matches_jax(config, hpx, wpx, flags, want):
    """The clustering block's token resolution from the configs alone (no
    model is built), equal to the JAX function's."""
    got = cluster_feature_hw(types.SimpleNamespace(spec=t_spec(config, num_frames=T)),
                             VidSegArgs(**flags), hpx, wpx, T)
    ref = j_cluster_hw(types.SimpleNamespace(spec=j_spec(config, num_frames=T)), JArgs(**flags), hpx, wpx, T)
    assert got == tuple(ref)
    if want is not None:
        assert got == want


# The inversion's first Euler step starts at sigma = 1e-8 (the flipped schedule's
# 0 + 1e-8): there fp32 rounds the denoised latent x * c_skip + F * c_out to x
# itself or to one ulp beside it, so d = (x - denoised) / sigma is a multiple of
# ulp(x) / 1e-8, and input differences of ~1e-7 between the two frameworks move
# some elements by a whole such quantum (times sigma_1 - sigma_0), and the
# later steps carry it on. The inverted latent and the feature pass's latents
# read 0.66-1.21 x LATENT_RTOL (the worst at the noisiest steps, and from run
# to run as the CPU's thread count orders the sums); with the first sigma
# raised to 1e-3 in both packages they read 0.005-0.010 x. The run is held to
# INVERT_RTOL.
INVERT_RTOL = 2 * LATENT_RTOL


def test_inversion_runs_match_jax(inversion_runs):
    """The inverted latent, the feature pass over all STEPS from it (cache window
    t0 = 0) and the modulated runs against JAX's (INVERT_RTOL, above);
    equal masks; diff maps and labels as test_difference_maps_and_labels_match_jax
    holds them, at two quanta (JAX's test_pipeline_tiny.py::test_inversion_type_wired drives the
    same flag)."""
    jres, cap, tres, tcache = inversion_runs
    assert tcache["inverted"].shape == cap["inverted"].shape == (T, HPX // 8, WPX // 8, 4)
    _rel_close(tcache["inverted"].numpy(), cap["inverted"], INVERT_RTOL)
    assert tres.cache_t0 == 0   # JAX's window: cap["xt"] holds all STEPS steps
    assert tres.cached_xt.shape == cap["xt"].shape == (STEPS, T, HPX // 8, WPX // 8, 4)
    for i in range(STEPS):
        _rel_close(tres.cached_xt[i], cap["xt"][i], INVERT_RTOL)
    _rel_close(tres.feature_x0, cap["x0"], INVERT_RTOL)
    np.testing.assert_array_equal(tres.masks, jres.masks)
    _rel_close(tres.final_latents, cap["finals"], INVERT_RTOL)
    # latents up to INVERT_RTOL apart decode up to two quanta apart (measured:
    # 2; 91 % of the pixels equal, all but 4e-5 within one); the top two maps
    # may then each move by two quanta in opposite directions, so the labels
    # are held where JAX's margin exceeds four (0.40 of the pixels)
    _diff_maps_and_labels_match(jres, tres, quanta=2, margin=4.0, min_sure=0.3)


# Diff maps within one quantum of JAX's move a normalised map d / max(d) by up
# to two quanta of 1 / max (its pixel and its max each by one), and the top
# two maps may move in opposite directions: a label is determined by the maps
# wherever JAX's top-2 margin exceeds four quanta of the smallest max.
LABEL_MARGIN = 4.0


def raised_first_sigma(first):
    """A MonkeyPatch that starts both packages' flipped schedules at `first`
    instead of 0 + 1e-8 (the unflipped schedule is unchanged): the inversion's
    first Euler step is then well conditioned, and a parity test of the
    inversion's arithmetic can hold it at the tolerance of the other runs."""
    from vidseg_diffusion_tpu.diffusion import sampling as jsamp
    from vidseg_diffusion_tpu_torch.diffusion import sampling as tsamp

    jsig, tsig = jsamp.EulerEDMSampler.sigmas, tsamp.EulerEDMSampler.sigmas

    def j_sigmas(self, *a, **kw):
        sig = jsig(self, *a, **kw)
        return sig.at[0].set(first) if kw.get("flip") else sig

    def t_sigmas(self, flip=False):
        sig = tsig(self, flip)
        if flip:
            sig[0] = first
        return sig

    mp = pytest.MonkeyPatch()
    mp.setattr(jsamp.EulerEDMSampler, "sigmas", j_sigmas)
    mp.setattr(tsamp.EulerEDMSampler, "sigmas", t_sigmas)
    return mp


def test_inversion_well_conditioned_matches_jax():
    """The inversion path with the flipped schedule's first sigma raised to
    1e-3 in both packages (the EDM schedule's sigma_min is 2e-3): the
    inverted latent, every cached step, x0 and the runs within LATENT_RTOL,
    equal masks, the diff maps within one uint8 quantum (all but 1 % equal),
    so that a wrong inversion step cannot hide behind INVERT_RTOL. Labels:
    equal wherever JAX's top-2 margin exceeds LABEL_MARGIN quanta (they part
    at near-ties: measured, 3-8 of 12288 pixels, each at a margin of at most
    one quantum)."""
    mp = raised_first_sigma(1e-3)
    try:
        jres, cap, tres, tcache = _run_both(None, inversion_type="inversion")
    finally:
        mp.undo()
    _rel_close(tcache["inverted"].numpy(), cap["inverted"], LATENT_RTOL)
    assert tres.cache_t0 == 0 and tres.cached_xt.shape == cap["xt"].shape == (STEPS, T, HPX // 8, WPX // 8, 4)
    _rel_close(tres.cached_xt, cap["xt"], LATENT_RTOL)
    _rel_close(tres.feature_x0, cap["x0"], LATENT_RTOL)
    np.testing.assert_array_equal(tres.masks, jres.masks)
    _rel_close(tres.final_latents, cap["finals"], LATENT_RTOL)
    _diff_maps_and_labels_match(jres, tres, margin=LABEL_MARGIN, min_sure=0.3)


def test_inversion_replaces_add_noise(runs, inversion_runs):
    """The inverted latent is not the add_noise one: the feature pass, and so
    the runs, start from another latent."""
    _, cap, tres, _ = runs
    _, icap, ires, _ = inversion_runs
    assert float(np.abs(ires.feature_x0 - tres.feature_x0).max()) > 1e-3
    assert tres.cache_t0 == min(ARGS["modulate_timestep"]) and ires.cache_t0 == 0


def test_signature_follows_jax():
    """run_single_video's parameters are JAX's, in JAX's order and with its
    defaults, `process_group` (the runs over ranks) in the place of `mesh`
    (the in-process runs mesh, not ported); the port's own draws follow as
    keyword-only parameters."""
    jsig = inspect.signature(j_run).parameters
    tsig = inspect.signature(run_single_video).parameters
    shared = [n if n != "mesh" else "process_group" for n in jsig]
    positional = [n for n, p in tsig.items() if p.kind == p.POSITIONAL_OR_KEYWORD]
    assert positional == shared
    assert all(tsig[n].default == jsig[n].default for n in jsig if n != "mesh")
    assert tsig["process_group"].default is None and jsig["mesh"].default is None
    extra = [n for n, p in tsig.items() if p.kind == p.KEYWORD_ONLY]
    assert extra == ["cond_aug_noise", "noise", "kmeans_init"]


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


@pytest.mark.parametrize("argv,want", [([], "add_noise"), (["--inversion_type", "inversion"], "inversion")])
def test_single_video_cli_passes_inversion_type(argv, want):
    """The single-video CLI's --inversion_type reaches run_single_video's
    VidSegArgs (add_noise by default, as the JAX CLI runs)."""
    from unittest import mock

    from vidseg_diffusion_tpu_torch.pipelines import single_video as tsv
    from vidseg_diffusion_tpu_torch.scripts import svd_single_video_inference as cli

    seen = {}
    frames = np.zeros((T, HPX, WPX, 3), np.float32)
    with mock.patch("vidseg_diffusion_tpu_torch.io.video.list_video_frames", lambda p: ["0", "1", "2"]), \
            mock.patch("vidseg_diffusion_tpu_torch.io.video.load_frames", lambda paths: (frames, paths, (HPX, WPX))), \
            mock.patch("vidseg_diffusion_tpu_torch.engine.build.build_pipeline_from_args", lambda *a: None), \
            mock.patch.object(tsv, "run_single_video",
                              lambda pipe, fr, names, args, **kw: seen.update(args=args) or types.SimpleNamespace(
                                  unique_labels=np.arange(2))):
        cli.main(["--input_video_path", "video", "--device", "cpu"] + argv)
    assert seen["args"].inversion_type == want
    with pytest.raises(SystemExit):
        cli.parse_args(["--inversion_type", "ddim"])
