"""The port's safety filter, watermark and FID (vidseg_diffusion_tpu_torch/
utils/safety.py, utils/watermark.py, scripts/detect_watermark.py,
eval/fid.py) against the JAX package's on the same inputs (numpy, seeded).

Tolerances: the heads' probabilities, the watermark's bits and pixels, the
dither and the detector's output exactly; blurred frames within 1e-5 of max
|JAX| (fp32 convolutions summed in another order); FID within 1e-10 of the
value (relative) against JAX with x64 on (both in float64), and the CLIP-FID
path within 1e-4 (fp32 CLIP features). JAX's FID casts to float64 only take
effect with jax_enable_x64 on (eval/fid.py:18-22); the port computes in
float64 always, so with x64 off the two differ at fp32 precision
(test_fid_float64_always_where_jax_needs_x64).
"""

import runpy
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

scipy_linalg = pytest.importorskip("scipy.linalg")

from vidseg_diffusion_tpu.eval import fid as jfid  # noqa: E402
from vidseg_diffusion_tpu.models.clip import CLIPVisionConfig as JVisionConfig  # noqa: E402
from vidseg_diffusion_tpu.models.clip import CLIPVisionTransformer as JVision  # noqa: E402
from vidseg_diffusion_tpu.models.clip import clip_vision_key_fn  # noqa: E402
from vidseg_diffusion_tpu.utils import safety as jsafety  # noqa: E402
from vidseg_diffusion_tpu.utils import watermark as jwm  # noqa: E402
from vidseg_diffusion_tpu_torch.eval import fid as tfid  # noqa: E402
from vidseg_diffusion_tpu_torch.io import convert  # noqa: E402
from vidseg_diffusion_tpu_torch.models.clip import CLIPVisionConfig, CLIPVisionTransformer  # noqa: E402
from vidseg_diffusion_tpu_torch.scripts import detect_watermark  # noqa: E402
from vidseg_diffusion_tpu_torch.utils import safety as tsafety  # noqa: E402
from vidseg_diffusion_tpu_torch.utils import watermark as twm  # noqa: E402

BLUR_RTOL = 1e-5
FID_RTOL = 1e-10
CLIP_FID_RTOL = 1e-4


@pytest.fixture
def x64():
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


def _close(got, want, rtol):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    err = float(np.abs(got.astype(np.float64) - want.astype(np.float64)).max())
    assert err <= rtol * max(float(np.abs(want).max()), 1e-30), err


def test_predict_proba_equal():
    rs = np.random.RandomState(0)
    x = (rs.randn(5, 16) * 3).astype(np.float16)
    w, b = rs.randn(2, 16).astype(np.float32), rs.randn(2).astype(np.float32)
    np.testing.assert_array_equal(tsafety.predict_proba(x, w, b), jsafety.predict_proba(x, w, b))


@pytest.mark.parametrize("size", [32, 64])
def test_safety_filter_matches_jax(size):
    """Four frames: flagged by both heads (blurred twice), by p only, by w
    only, by neither; fixed features (the tower stands in); a 99-tap blur on
    frames narrower than its 49-pixel pad reflects again, as jnp.pad does."""
    rs = np.random.RandomState(1)
    d = 8
    half = lambda a, b: [a] * 4 + [b] * 4
    feats = np.array([half(1, 1), half(1, -1), half(-1, 1), half(-1, -1)], np.float32)
    p_head = (np.array([half(1, 0)], np.float32), np.array([0.0], np.float32))   # flags frames 0, 1
    w_head = (np.array([half(0, 1)], np.float32), np.array([0.0], np.float32))   # flags frames 0, 2
    frames = rs.rand(4, size, size, 3).astype(np.float32)
    jf = jsafety.SafetyFilter(clip_image_fn=lambda f: jnp.asarray(feats[: f.shape[0]]), p_head=p_head, w_head=w_head)
    tf = tsafety.SafetyFilter(clip_image_fn=lambda f: torch.from_numpy(feats[: f.shape[0]]), p_head=p_head,
                              w_head=w_head)
    s_j, s_t = jf.scores(jnp.asarray(frames)), tf.scores(torch.from_numpy(frames))
    np.testing.assert_array_equal(s_t, s_j)
    flagged = (s_j[0] > 0.5, s_j[1] > 0.5)
    assert flagged[0].tolist() == [True, True, False, False] and flagged[1].tolist() == [True, False, True, False]
    want = np.asarray(jf(jnp.asarray(frames)))
    got = tf(torch.from_numpy(frames))
    _close(got, want, BLUR_RTOL)
    np.testing.assert_array_equal(got[3].numpy(), frames[3])
    once = tsafety.blur_frames(torch.from_numpy(frames[:1]))
    assert float((got[0] - once[0]).abs().max()) > 1e-4   # frame 0 took both blurs
    # unconfigured: a pass-through reporting zeros
    np.testing.assert_array_equal(tsafety.SafetyFilter()(torch.from_numpy(frames)).numpy(), frames)
    assert not tsafety.SafetyFilter().scores(torch.from_numpy(frames)).any()


def test_safety_filter_from_npz(tmp_path):
    rs = np.random.RandomState(2)
    p = tmp_path / "p_head_v1.npz"
    np.savez(p, weights=rs.randn(1, 4).astype(np.float32), biases=rs.randn(1).astype(np.float32))
    jf = jsafety.SafetyFilter.from_npz(None, str(p), "")
    tf = tsafety.SafetyFilter.from_npz(None, str(p), "")
    assert tf.w_head is None and jf.w_head is None
    for a, b in zip(tf.p_head, jf.p_head):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("shape,strength", [((1, 8, 8, 3), 0.0), ((2, 16, 24, 3), 0.05),
                                            ((1, 256, 256, 3), 1.0), ((1, 264, 272, 4), 0.3)])
def test_embed_watermark_regimes_match_jax(shape, strength):
    """strength 0: the identity; RGB of 256x256 or more: the DWT-DCT message;
    smaller (or not RGB): the dither."""
    frames = np.random.RandomState(3).rand(*shape).astype(np.float32)
    want = np.asarray(jsafety.embed_watermark(jnp.asarray(frames), strength))
    ft = torch.from_numpy(frames)
    got = tsafety.embed_watermark(ft, strength)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got is ft) == (strength == 0.0)


def test_watermark_bits_round_trip_equal_to_jax():
    img = np.random.RandomState(4).rand(2, 256, 320, 3)
    emb_t, emb_j = twm.embed_watermark_frames(img), jwm.embed_watermark_frames(img)
    np.testing.assert_array_equal(emb_t, emb_j)
    bits_t, bits_j = twm.decode_watermark_bits(emb_t), jwm.decode_watermark_bits(emb_j)
    np.testing.assert_array_equal(bits_t, bits_j)
    assert (twm.watermark_match_bits(emb_t) == 48).all()
    np.testing.assert_array_equal(twm.watermark_match_bits(img), jwm.watermark_match_bits(img))
    assert twm.WATERMARK_BITS == jwm.WATERMARK_BITS and twm.MATCH_VALUES == jwm.MATCH_VALUES
    assert [twm.classify_match(n) for n in range(49)] == [jwm.classify_match(n) for n in range(49)]


def test_detect_watermark_cli_prints_as_the_repository_script(tmp_path, capsys, monkeypatch):
    from PIL import Image

    img = np.random.RandomState(5).rand(256, 256, 3)
    marked = (twm.embed_watermark_frames(img) * 255).round().astype(np.uint8)
    paths = [tmp_path / "marked.png", tmp_path / "plain.png", tmp_path / "small.png", tmp_path / "missing.png"]
    Image.fromarray(marked).save(paths[0])
    Image.fromarray((img * 255).astype(np.uint8)).save(paths[1])
    Image.fromarray(np.zeros((32, 32, 3), np.uint8)).save(paths[2])
    files = [str(p) for p in paths]
    detect_watermark.main(files)
    got = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["detect_watermark.py"] + files)
    runpy.run_path("scripts/util/detect_watermark.py", run_name="__main__")
    want = capsys.readouterr().out
    assert got == want
    assert "Very likely watermarked" in got and "Bits that matched the watermark 48 of 48" in got


def _stats(rs, d, n):
    f = rs.rand(n, d) * 2 - 1
    return f, f.mean(axis=0), np.cov(f, rowvar=False)


def _oracle(mu1, s1, mu2, s2):
    """pytorch_fid's calculate_frechet_distance with scipy's sqrtm."""
    covmean = scipy_linalg.sqrtm(s1.dot(s2))
    diff = mu1 - mu2
    return diff.dot(diff) + np.trace(s1) + np.trace(s2) - 2 * np.trace(covmean.real)


def test_fid_functions_match_jax_in_x64(x64):
    rs = np.random.RandomState(6)
    f1, mu1, s1 = _stats(rs, 64, 500)
    f2, mu2, s2 = _stats(rs, 64, 400)
    psd = s1 + 0.1 * np.eye(64)
    _close(tfid.matrix_sqrt_psd(torch.from_numpy(psd)), jfid.matrix_sqrt_psd(jnp.asarray(psd)), FID_RTOL * 1e3)
    for got, want in zip(tfid.feature_stats(torch.from_numpy(f1)), jfid.feature_stats(jnp.asarray(f1))):
        assert got.dtype == torch.float64
        _close(got, want, FID_RTOL)
    got = tfid.frechet_distance(*(torch.from_numpy(a) for a in (mu1, s1, mu2, s2)))
    want = jfid.frechet_distance(*(jnp.asarray(a) for a in (mu1, s1, mu2, s2)))
    assert got.dtype == torch.float64
    _close(got, want, FID_RTOL)
    assert float(got) == pytest.approx(_oracle(mu1, s1, mu2, s2), rel=1e-8, abs=1e-8)
    _close(tfid.fid_from_features(torch.from_numpy(f1), torch.from_numpy(f2)),
           jfid.fid_from_features(jnp.asarray(f1), jnp.asarray(f2)), FID_RTOL)
    assert abs(float(tfid.fid_from_features(torch.from_numpy(f1), torch.from_numpy(f1)))) < 1e-9


def test_fid_float64_always_where_jax_needs_x64():
    """From fp32 features: the port computes in float64 and tracks the scipy
    oracle to 1e-8; JAX without x64 computes in fp32 (its casts are no-ops)."""
    rs = np.random.RandomState(7)
    f1, f2 = (rs.rand(n, 64).astype(np.float32) * 2 - 1 for n in (500, 400))
    got = tfid.fid_from_features(torch.from_numpy(f1), torch.from_numpy(f2))
    j32 = jfid.fid_from_features(jnp.asarray(f1), jnp.asarray(f2))
    assert got.dtype == torch.float64 and j32.dtype == jnp.float32
    f1d, f2d = f1.astype(np.float64), f2.astype(np.float64)
    want = _oracle(f1d.mean(0), np.cov(f1d, rowvar=False), f2d.mean(0), np.cov(f2d, rowvar=False))
    assert float(got) == pytest.approx(want, rel=1e-8, abs=1e-8)


def test_clip_fid_matches_jax(x64):
    """CLIP-FID through a tiny CLIP image tower (the JAX test's: 32 px, patch
    16, width 32), JAX's weights carried over; batching seam-free; identical
    populations score ~0; an empty batch raises as in JAX."""
    kw = dict(image_size=32, patch_size=16, width=32, heads=4, layers=2, output_dim=16)
    jt = JVision(JVisionConfig(**kw))
    params = jt.init(jax.random.PRNGKey(0), np.zeros((1, 32, 32, 3), np.float32))["params"]
    tt = CLIPVisionTransformer(CLIPVisionConfig(**kw))
    sd = convert.jax_to_state_dict(jax.tree.map(np.asarray, params), clip_vision_key_fn, "visual.")
    tt.load_state_dict({k: torch.tensor(v) for k, v in sd.items()})
    rs = np.random.RandomState(8)
    imgs1 = (rs.rand(7, 32, 32, 3) * 2 - 1).astype(np.float32)
    imgs2 = np.clip(imgs1 + 0.5, -1.0, 1.0)
    jfn = lambda f: jt.apply({"params": params}, jnp.asarray((np.asarray(f) + 1.0) / 2.0, jnp.float32))
    tfn = lambda f: tt((f + 1.0) / 2.0)
    tfeat = tfid.clip_features(tfn, torch.from_numpy(imgs1), batch_size=3)
    jfeat = jfid.clip_features(jfn, imgs1, batch_size=3)
    _close(tfeat, jfeat, CLIP_FID_RTOL)
    torch.testing.assert_close(tfeat, tfid.clip_features(tfn, torch.from_numpy(imgs1), batch_size=7))
    got = tfid.clip_fid(tfn, torch.from_numpy(imgs1), torch.from_numpy(imgs2), batch_size=4)
    want = jfid.clip_fid(jfn, imgs1, imgs2, batch_size=4)
    assert float(got) == pytest.approx(float(want), rel=CLIP_FID_RTOL)
    assert abs(float(tfid.clip_fid(tfn, torch.from_numpy(imgs1), torch.from_numpy(imgs1)))) < 1e-6
    with pytest.raises(ValueError, match="at least one image"):
        tfid.clip_features(tfn, torch.zeros(0, 32, 32, 3))
