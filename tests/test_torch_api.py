"""The sampling API of the port against the JAX package's inference/api.py,
on the CPU in fp32: SamplingPipeline's four entry points on the tiny configs.

Each JAX pipeline is built once per module (random weights, numpy on the
CPU) and its weights move into the port's (io/convert.py): the UNet, the VAE,
the text towers (HF CLIP-L, bigG, from the conditioner's closures; SD 2.1's OpenCLIP tower) or the
SVD image tower and conditioning-frame encoder. The port is handed the
draws JAX makes from its keys: the initial noise, the add_noise noise, the
per-step noise of a stochastic sampler and img2vid's cond-frame
augmentation. Compared: `make_cond`'s layout and values (crossattn [2, 77,
80], vector [2, 144]; uc's text zeroed for the base, the negative prompt's
for the refiner), text_to_image on sd_xl_tiny.yaml at 64x64 (Euler, and DPM++
2S ancestral with JAX's per-step draws) and on sd_tiny.yaml (Heun), the base -> refiner handoff on
sd_xl_refiner_tiny.yaml (txt2noisy_strength, add_noise False),
image_to_image at strength 0.5, and image_to_video on svd_tiny.yaml at 2
frames and 2 steps. Tolerance: latents and images within 2e-4 of max(1, max
|JAX|) (fp32 through 3-4 CFG steps of a UNet; read 2.4e-6 to 4.1e-6, img2vid
2.6e-5), conditioning within 1e-5 (read <= 4.8e-7).
"""

import inspect

import jax
import numpy as np
import pytest
import torch

from vidseg_diffusion_tpu.engine.build import build_pipeline as j_build
from vidseg_diffusion_tpu.inference import api as japi
from vidseg_diffusion_tpu.io.checkpoint import unet_key_fn
from vidseg_diffusion_tpu.models.clip import clip_text_key_fn, clip_vision_key_fn, hf_clip_text_key_fn
from vidseg_diffusion_tpu_torch.engine.build import build_pipeline as t_build
from vidseg_diffusion_tpu_torch.inference import api as tapi
from vidseg_diffusion_tpu_torch.io import convert
from vidseg_diffusion_tpu_torch.io.tokenizer import TINY_VOCAB, tokenize

LATENT_RTOL = 2e-4
IMAGE_TOL = 2e-4
COND_TOL = 1e-5
SIZE, STEPS = 64, 3
TOKENS = tokenize(["a photo of a cat"], bpe_path=TINY_VOCAB)
NEGATIVE = tokenize(["dog"], bpe_path=TINY_VOCAB)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sd(tree, key_fn, strip=""):
    np_tree = jax.tree.map(np.asarray, tree)
    return {k: torch.tensor(v) for k, v in convert.jax_to_state_dict(np_tree, key_fn, strip).items()}


def _carry(jp, tp):
    """The JAX pipeline's weights into the port's."""
    tp.unet.load_state_dict(_sd(jp.unet_params, unet_key_fn))
    tp.first_stage.encoder.load_state_dict(_sd(jp.first_stage.params_encoder, convert.vae_key_fn))
    tp.first_stage.decoder.load_state_dict(_sd(jp.first_stage.params_decoder, convert.vae_key_fn))
    if tp.kind == "svd":
        closure = inspect.getclosurevars(jp.condition_video).nonlocals
        tp.clip.load_state_dict(_sd(closure["vparams"], clip_vision_key_fn, "visual."))
        tp.cond_encoder.load_state_dict(_sd(closure["cenc_params"], convert.vae_key_fn))
        return tp
    fns = [e.fn for e in jp.conditioner.embedders[: 2 if tp.kind == "sdxl" else 1]]
    if tp.kind == "sdxl":
        tp.text_l.load_state_dict(_sd(inspect.getclosurevars(fns[0]).nonlocals["tl_params"], hf_clip_text_key_fn))
    tp.text_g.load_state_dict(_sd(inspect.getclosurevars(fns[-1]).nonlocals["tg_params"], clip_text_key_fn))
    return tp


def _pair(config, **kw):
    jp = j_build(config, **kw)
    return japi.SamplingPipeline(jp), tapi.SamplingPipeline(_carry(jp, t_build(config, device="cpu", **kw)))


@pytest.fixture(scope="module")
def base():
    return _pair("configs/inference/sd_xl_tiny.yaml")


@pytest.fixture(scope="module")
def refiner():
    return _pair("configs/inference/sd_xl_refiner_tiny.yaml")


def _params(mod, **kw):
    return mod.SamplingParams(**{**dict(width=SIZE, height=SIZE, steps=STEPS, orig_width=SIZE, orig_height=SIZE),
                                 **kw})


def _rel_close(got, want, rtol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= rtol * max(1.0, float(np.abs(want).max())), err


def _draws(key, shape, n=None):
    if n is None:
        return np.array(jax.random.normal(key, shape))
    return np.stack([np.array(jax.random.normal(k, shape)) for k in jax.random.split(key, n)])


@pytest.mark.parametrize("which", ["base", "refiner"])
def test_make_cond_layout_and_values(base, refiner, which):
    """Base: crossattn [CLIP-L 32 | bigG 48], vector [pooled 48 | 3 x 2 x 16],
    uc's text zeroed (the pooled segment too), its sizes kept. Refiner: uc is
    the negative prompt's (not zeroed), its aesthetic segment the negative
    score's. Both against JAX's _make_cond."""
    (ja, ta) = base if which == "base" else refiner
    jp, tp = _params(japi, aesthetic_score=6.0, negative_aesthetic_score=2.5), \
        _params(tapi, aesthetic_score=6.0, negative_aesthetic_score=2.5)
    for neg in (None, NEGATIVE):
        jc, juc = ja._make_cond(jp, TOKENS, neg, 2)
        tc, tuc = ta.make_cond(tp, TOKENS, neg, 2)
        for w, g in ((jc, tc), (juc, tuc)):
            assert w.keys() == g.keys() == {"crossattn", "vector"}
            for k in w:
                _rel_close(g[k], w[k], COND_TOL)
    if which == "base":
        assert tuple(tc["crossattn"].shape) == (2, 77, 80) and tuple(tc["vector"].shape) == (2, 144)
        assert tuc["crossattn"].abs().max() == 0 and tuc["vector"][:, :48].abs().max() == 0
        torch.testing.assert_close(tuc["vector"][:, 48:], tc["vector"][:, 48:])
    else:
        assert tuple(tc["crossattn"].shape) == (2, 77, 48) and tuple(tc["vector"].shape) == (2, 128)
        assert tuc["crossattn"].abs().max() > 0 and not torch.allclose(tuc["crossattn"], tc["crossattn"])
        assert not torch.allclose(tuc["vector"][:, -16:], tc["vector"][:, -16:])
        torch.testing.assert_close(tuc["vector"][:, 48:-16], tc["vector"][:, 48:-16])


@pytest.mark.parametrize("sampler", ["EulerEDMSampler", "DPMPP2SAncestralSampler"])
def test_text_to_image_matches_jax(base, sampler):
    """txt2img on sd_xl_tiny.yaml: the initial noise JAX draws from its first
    key, the per-step draws (DPM++ 2S ancestral) from its second."""
    ja, ta = base
    rng = jax.random.PRNGKey(11)
    r_init, r_loop = jax.random.split(rng)
    shape = (1, SIZE // 8, SIZE // 8, 4)
    jframes, jz = ja.text_to_image(_params(japi, sampler=japi.Sampler(sampler)), TOKENS, rng=rng,
                                   return_latents=True)
    tframes, tz = ta.text_to_image(_params(tapi, sampler=tapi.Sampler(sampler)), TOKENS,
                                   noise=torch.from_numpy(_draws(r_init, shape)),
                                   step_noise=torch.from_numpy(_draws(r_loop, shape, STEPS)), return_latents=True)
    assert tuple(tframes.shape) == (1, SIZE, SIZE, 3)
    _rel_close(tz, jz, LATENT_RTOL)
    _rel_close(tframes, jframes, IMAGE_TOL)
    assert float(np.abs(np.asarray(jz)).max()) > 0.1


def test_text_to_image_sd_text_matches_jax():
    """txt2img on sd_tiny.yaml (SD 2.1's one OpenCLIP text tower; uc the
    empty prompt framed with the prompt's SOT / EOT) with Heun, whose
    correction branch the port runs where JAX's jnp.where keeps it."""
    jp = j_build("configs/inference/sd_tiny.yaml")
    tp = t_build("configs/inference/sd_tiny.yaml", device="cpu")
    tp.unet.load_state_dict(_sd(jp.unet_params, unet_key_fn))
    tp.first_stage.decoder.load_state_dict(_sd(jp.first_stage.params_decoder, convert.vae_key_fn))
    tp.text.load_state_dict(_sd(inspect.getclosurevars(jp.clip_apply).nonlocals["tparams"], clip_text_key_fn))
    ja, ta = japi.SamplingPipeline(jp), tapi.SamplingPipeline(tp)
    rng = jax.random.PRNGKey(16)
    r_init, _ = jax.random.split(rng)
    jframes, jz = ja.text_to_image(_params(japi, sampler=japi.Sampler.HEUN_EDM), TOKENS, rng=rng,
                                   return_latents=True)
    tframes, tz = ta.text_to_image(_params(tapi, sampler=tapi.Sampler.HEUN_EDM), TOKENS,
                                   noise=torch.from_numpy(_draws(r_init, (1, SIZE // 8, SIZE // 8, 4))),
                                   return_latents=True)
    _rel_close(tz, jz, LATENT_RTOL)
    _rel_close(tframes, jframes, IMAGE_TOL)


def test_base_to_refiner_handoff_matches_jax(base, refiner):
    """text_to_image with txt2noisy_strength stops at a nonzero sigma and
    returns its latents; the refiner finishes them with add_noise False at
    the same strength."""
    (jb, tb), (jr, tr) = base, refiner
    rng = jax.random.PRNGKey(12)
    r_init, _ = jax.random.split(rng)
    shape = (1, SIZE // 8, SIZE // 8, 4)
    strength = 0.5
    _, jz = jb.text_to_image(_params(japi, steps=4), TOKENS, rng=rng, txt2noisy_strength=strength,
                             return_latents=True)
    _, tz = tb.text_to_image(_params(tapi, steps=4), TOKENS, noise=torch.from_numpy(_draws(r_init, shape)),
                             txt2noisy_strength=strength, return_latents=True)
    _rel_close(tz, jz, LATENT_RTOL)
    jout = jr.refiner(japi.SamplingParams(steps=4, img2img_strength=strength), jz, TOKENS, add_noise=False,
                      rng=jax.random.PRNGKey(13))
    tout = tr.refiner(tapi.SamplingParams(steps=4, img2img_strength=strength), tz, TOKENS, add_noise=False)
    _rel_close(tout, jout, IMAGE_TOL)


def test_image_to_image_matches_jax(base):
    """img2img at strength 0.5: encode, the add_noise noise JAX draws from
    its first key, 2 of 3 steps, decode."""
    ja, ta = base
    img = np.random.RandomState(0).uniform(-1, 1, (1, SIZE, SIZE, 3)).astype(np.float32)
    rng = jax.random.PRNGKey(14)
    r_noise, _ = jax.random.split(rng)
    jout = ja.image_to_image(_params(japi, img2img_strength=0.5), img, TOKENS, rng=rng)
    z = ta.pipeline.first_stage.encode(torch.from_numpy(img))
    tout = ta.image_to_image(_params(tapi, img2img_strength=0.5), img, TOKENS,
                             noise=torch.from_numpy(_draws(r_noise, tuple(z.shape))))
    _rel_close(tout, jout, IMAGE_TOL)
    # strength ~0: no step runs, the input latent comes back decoded
    t0 = ta.image_to_image(_params(tapi, img2img_strength=0.0), img, TOKENS)
    torch.testing.assert_close(t0, ta.decode(z))


def test_image_to_video_matches_jax():
    """img2vid on svd_tiny.yaml at 2 frames of 32x32, 2 steps, decoding_t 2:
    JAX's cond-frame augmentation (first key) and initial noise (second)."""
    ja, ta = _pair("configs/inference/svd_tiny.yaml", num_steps=2, num_frames=2)
    params = dict(width=32, height=32, num_frames=2, steps=2, decoding_t=2, max_cfg=2.5, min_cfg=1.0)
    img = np.random.RandomState(1).uniform(-1, 1, (1, 32, 32, 3)).astype(np.float32)
    rng = jax.random.PRNGKey(15)
    r_aug, r_init = jax.random.split(rng)
    jout = ja.image_to_video(japi.VideoSamplingParams(**params), img, rng=rng)
    tout = ta.image_to_video(tapi.VideoSamplingParams(**params), img,
                             noise=torch.from_numpy(_draws(r_init, (2, 4, 4, 4))),
                             aug_noise=torch.from_numpy(_draws(r_aug, img.shape)))
    assert tuple(tout.shape) == (2, 32, 32, 3)
    _rel_close(tout, jout, IMAGE_TOL)
    with pytest.raises(ValueError, match="video"):
        tapi.SamplingPipeline(t_build("configs/inference/sd_xl_tiny.yaml", device="cpu")).image_to_video(
            tapi.VideoSamplingParams(**params), img)


def test_floored_inversion_and_nti_path_run_on_the_cpu():
    """scripts/api_path.py's null-text inversion path on sd_tiny.yaml at
    64x64: the package's inversion over a schedule whose flipped start is
    the denoiser table's smallest sigma (FlooredDiscretization; the rest of
    the schedule unchanged), then null_text_optimization (the loss summed
    over the outer steps falls from the first inner step to the last, every
    uc finite) and `edit`, finite and apart from the base-only run."""
    from vidseg_diffusion_tpu_torch.scripts import api_path

    api = api_path.build("configs/inference/sd_tiny.yaml", "cpu", torch.float32, seed=0)
    sampler = api.make_sampler(tapi.SamplingParams(steps=4))
    floored = api_path.FlooredDiscretization(sampler.discretization, 0.03)
    plain, raised = sampler.sigmas(flip=True), type(sampler)(floored, 4).sigmas(flip=True)
    assert raised[0].item() == pytest.approx(0.03, abs=1e-7) and torch.equal(raised[1:], plain[1:])
    losses = {}
    latents, ucs, edited, base_only = api_path.nti_and_edit(
        api, size=64, steps=4, inner=2, on_loss=lambda i, k, loss: losses.setdefault(i, []).append(loss.item()))
    assert latents.shape == (5, 1, 8, 8, 4) and bool(torch.isfinite(latents).all())
    assert sum(v[-1] for v in losses.values()) < sum(v[0] for v in losses.values())
    assert len(ucs) == 4 and all(bool(torch.isfinite(u).all()) for u in ucs)
    assert bool(torch.isfinite(edited).all()) and float((edited - base_only).abs().max()) > 0
