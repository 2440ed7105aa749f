"""Shared set-up of the port's sweep tests (test_torch_vspw.py,
test_torch_masks.py): a JAX pipeline and the port's with its weights, the
random draws JAX makes in run_single_video handed to the port's, synthetic
VSPW trees, and the pixels JAX's difference maps decide."""

import inspect
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch
from PIL import Image

from vidseg_diffusion_tpu.engine import segmentation as jseg
from vidseg_diffusion_tpu.engine.build import build_pipeline as j_build
from vidseg_diffusion_tpu.engine.masks import _normalize
from vidseg_diffusion_tpu.io.checkpoint import unet_key_fn
from vidseg_diffusion_tpu.models.clip import clip_text_key_fn, clip_vision_key_fn
from vidseg_diffusion_tpu.ops.kmeans import _kmeanspp_init
from vidseg_diffusion_tpu.pipelines import single_video as jsv
from vidseg_diffusion_tpu_torch.engine.build import build_pipeline as t_build
from vidseg_diffusion_tpu_torch.io import convert

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SVD, SD = "configs/inference/svd_tiny.yaml", "configs/inference/sd_tiny.yaml"
T, HPX, WPX, STEPS, SEED = 3, 64, 64, 6, 1
GT_IDS = (0, 3, 7)
# the sweep CLIs' flags at the tiny size (both packages' defaults otherwise)
FLAGS = dict(num_steps=STEPS, modulate_timestep=(3,), feature_timestep=(5,), num_masks=3, seed=SEED)


def _sd(tree, key_fn, strip=""):
    np_tree = jax.tree.map(np.asarray, tree)
    return {k: torch.tensor(v) for k, v in convert.jax_to_state_dict(np_tree, key_fn, strip).items()}


def _pair(config):
    """(JAX pipeline, port pipeline on the CPU with the JAX weights)."""
    jp = j_build(config, num_steps=STEPS, num_frames=T)
    tp = t_build(config, num_steps=STEPS, num_frames=T, device="cpu")
    tp.unet.load_state_dict(_sd(jp.unet_params, unet_key_fn))
    tp.first_stage.encoder.load_state_dict(_sd(jp.first_stage.params_encoder, convert.vae_key_fn))
    tp.first_stage.decoder.load_state_dict(_sd(jp.first_stage.params_decoder, convert.vae_key_fn))
    if tp.spec.unet_config.video:
        closure = inspect.getclosurevars(jp.condition_video).nonlocals
        tp.clip.load_state_dict(_sd(closure["vparams"], clip_vision_key_fn, "visual."))
        tp.cond_encoder.load_state_dict(_sd(closure["cenc_params"], convert.vae_key_fn))
    else:
        tp.text.load_state_dict(_sd(inspect.getclosurevars(jp.clip_apply).nonlocals["tparams"], clip_text_key_fn))
    return jp, tp


class Draws:
    """The draws of JAX's run_single_video (same seed in every window), handed
    to the port's; the k-means centres of each first window are drawn on the
    cluster features JAX's match_gt_mask was given there, in call order."""

    def __init__(self, video, num_masks, seed=SEED):
        rng = jax.random.PRNGKey(seed)
        self.aug = None
        if video:
            self.aug = np.asarray(jax.random.normal(jax.random.split(rng)[0], (1, HPX, WPX, 3)))
            rng = jax.random.fold_in(rng, 1)
        self.noise = np.asarray(jax.random.normal(jax.random.fold_in(rng, 2), (T, HPX // 8, WPX // 8, 4)))
        self.keys = jax.random.split(jax.random.fold_in(rng, 3), 10)
        self.num_masks = num_masks
        self.inits = []

    def record(self, mp):
        """Wrap JAX's match_gt_mask: each first window's features -> centres."""
        orig = jsv.match_gt_mask

        def match(rng, features, num_masks, num_frames, gt_mask=None, state=None, **kw):
            if state is None:
                pts = _normalize(jnp.asarray(features, jnp.float32))[num_frames:]
                pts = pts.reshape(-1, pts.shape[-1])
                self.inits.append(np.array(jax.vmap(lambda k: _kmeanspp_init(k, pts, num_masks))(self.keys)))
            return orig(rng, features, num_masks, num_frames, gt_mask=gt_mask, state=state, **kw)

        mp.setattr(jsv, "match_gt_mask", match)

    def handed(self, run):
        """The port's run_single_video with JAX's draws by keyword."""
        def wrapped(*a, **kw):
            kw.update(noise=self.noise, cond_aug_noise=self.aug)
            gt_state = kw.get("gt_state", a[6] if len(a) > 6 else None)
            if gt_state is None:
                kw["kmeans_init"] = self.inits.pop(0)
            return run(*a, **kw)
        return wrapped


def _frames(seed, n):
    """[n, H, W, 3] frames in [-1, 1] whose texture follows the GT's three
    column blocks, plus noise."""
    rs = np.random.RandomState(seed)
    cols = np.arange(WPX) * 3 // WPX
    base = np.array([[0.8, -0.5, -0.5], [-0.5, 0.8, -0.5], [-0.5, -0.5, 0.8]], np.float32)[cols]
    return np.clip(base[None, None] + 0.3 * rs.randn(n, HPX, WPX, 3), -1, 1).astype(np.float32)


def _gt_image():
    return np.broadcast_to(np.array(GT_IDS, np.uint8)[np.arange(WPX) * 3 // WPX], (HPX, WPX)).copy()


def _make_video(root, name, seed, n, masks=True, ext=".png"):
    odir = os.path.join(root, name, "origin")
    os.makedirs(odir)
    frames = _frames(seed, n)
    for i in range(n):
        Image.fromarray(((frames[i] + 1) * 127.5).round().astype(np.uint8)).save(os.path.join(odir, f"{i}.png"))
    if masks:
        mdir = os.path.join(root, name, "mask")
        os.makedirs(mdir)
        for i in range(n):
            Image.fromarray(_gt_image()).save(os.path.join(mdir, f"{i}{ext}"))


def _sure(jres):
    """[T, H, W] pixels whose raw and filtered labels JAX's difference maps
    decide by more than one uint8 quantum (a one-quantum change of a map
    moves its max-normalised value by 1 / max, the filter's weights are <= 1)."""
    diff = np.asarray(jres.diff_maps, np.float64)
    if diff.shape[0] == 1:
        return np.ones(diff.shape[1:], bool)
    maxes = diff.max(axis=(-2, -1), keepdims=True)
    norm = diff / (maxes + 1e-5)
    filt = np.asarray(jseg.filter_difference(jnp.asarray(norm, jnp.float32), jnp.asarray(jres.masks), 0.7))
    sure = np.ones(diff.shape[1:], bool)
    for n in (norm, filt):
        top2 = np.sort(n, axis=0)[-2:]
        sure &= (top2[1] - top2[0]) * maxes.min(axis=0) > 1.0
    return sure
