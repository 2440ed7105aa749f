"""The port's sampler family against the JAX package's, on the CPU in fp32.

Each sampler's loop runs on a synthetic, nonlinear denoiser written once in
jnp and once in torch (the same function of x, sigma and the step index),
over whole schedules, windows with t_start > 0 and t_end < n, and the final
sigma = 0 step; the per-step noise is JAX's: jax.random.split(rng, t_end -
t_start)[k] drawn in x's shape, handed to the port as `noise`. Also: the LMS
coefficient table, `edit`'s window and aux, null_text_optimization's uc list
(optax's Adam against the port's own, 1e-5), finite Heun / DPM++ 2S gradients at
the last step (mirroring tests/test_samplers_extra.py), the denoiser call
counts, Txt2NoisyDiscretizationWrapper's prune index and t_end (mirroring
tests/test_img2vid.py) and the img2img strength window (mirroring
tests/test_inference_api.py). Tolerance: fp32 loops of a few steps, 1e-5
relative to max |JAX| (the sigma arithmetic is fp32 in both).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vidseg_diffusion_tpu.diffusion import discretization as jdisc
from vidseg_diffusion_tpu.diffusion import sampling as jsamp
from vidseg_diffusion_tpu.diffusion import sampling_extra as jextra
from vidseg_diffusion_tpu.inference import api as japi
from vidseg_diffusion_tpu_torch.diffusion import discretization as tdisc
from vidseg_diffusion_tpu_torch.diffusion import sampling as tsamp
from vidseg_diffusion_tpu_torch.diffusion import sampling_extra as textra
from vidseg_diffusion_tpu_torch.inference import api as tapi

TOL = 1e-5
STEPS = 6
SHAPE = (2, 4, 4, 3)


def _dn_jax(x, sigma, i):
    return jnp.tanh(x) * 0.9 + 0.05 * x / (1.0 + sigma) + 0.01 * i, None


def _dn_torch(x, sigma, i):
    return torch.tanh(x) * 0.9 + 0.05 * x / (1.0 + sigma) + 0.01 * i, None


def _close(got, want, tol=TOL):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * max(1.0, np.abs(want).max()), np.abs(got - want).max()


def _pair(name, disc, **kw):
    jd = {"edm": jdisc.EDMDiscretization(sigma_max=80.0), "ddpm": jdisc.LegacyDDPMDiscretization()}[disc]
    td = {"edm": tdisc.EDMDiscretization(sigma_max=80.0), "ddpm": tdisc.LegacyDDPMDiscretization()}[disc]
    jmod, tmod = (jsamp, tsamp) if hasattr(tsamp, name) else (jextra, textra)
    return getattr(jmod, name)(jd, STEPS, **kw), getattr(tmod, name)(td, STEPS, **kw)


SAMPLERS = [
    ("EulerEDMSampler", "edm", {}),
    ("EulerEDMSampler", "ddpm", dict(s_churn=1.0, s_tmin=0.5, s_tmax=10.0)),
    ("HeunEDMSampler", "edm", {}),
    ("HeunEDMSampler", "ddpm", dict(s_churn=2.0, s_noise=1.003)),
    ("EulerAncestralSampler", "edm", dict(eta=1.0)),
    ("EulerAncestralSampler", "ddpm", dict(eta=0.5)),
    ("DPMPP2SAncestralSampler", "edm", {}),
    ("DPMPP2SAncestralSampler", "ddpm", dict(eta=0.7)),
    ("DPMPP2MSampler", "edm", {}),
    ("DPMPP2MSampler", "ddpm", {}),
    ("LinearMultistepSampler", "edm", dict(order=4)),
    ("LinearMultistepSampler", "ddpm", dict(order=3)),
]
WINDOWS = [(0, None), (2, None), (0, 4), (1, 5)]


@pytest.mark.parametrize("window", WINDOWS, ids=lambda w: f"{w[0]}-{w[1]}")
@pytest.mark.parametrize("name,disc,kw", SAMPLERS, ids=lambda v: v if isinstance(v, str) else "")
def test_sampler_loop_matches_jax(name, disc, kw, window):
    """The loop's final latent on JAX's per-step draws; the denoiser calls the
    port makes are what denoiser_calls reckons (Heun / DPM++ 2S: one more
    where the correction branch runs)."""
    jsampler, tsampler = _pair(name, disc, **kw)
    t_start, t_end = window
    x = np.random.RandomState(0).randn(*SHAPE).astype(np.float32)
    rng = jax.random.PRNGKey(7)
    n_loop = (t_end if t_end is not None else STEPS) - t_start
    draws = np.stack([np.asarray(jax.random.normal(k, SHAPE, jnp.float32))
                      for k in jax.random.split(rng, n_loop)])
    want, _ = jsampler(_dn_jax, jnp.asarray(x), t_start=t_start, t_end=t_end, rng=rng)
    calls = []

    def dn(x, sigma, i):
        calls.append(i)
        return _dn_torch(x, sigma, i)

    got, auxes = tsampler(dn, torch.from_numpy(x), t_start=t_start, t_end=t_end, noise=torch.from_numpy(draws))
    _close(got, want)
    assert len(auxes) == n_loop
    assert len(calls) == tsamp.denoiser_calls(tsampler, t_start, t_end)
    second_order = name in ("HeunEDMSampler", "DPMPP2SAncestralSampler")
    assert len(calls) == n_loop + (second_order * (n_loop - (t_end is None)))


@pytest.mark.parametrize("name", ["EulerEDMSampler", "DPMPP2MSampler", "LinearMultistepSampler"])
def test_post_step_fn_and_no_prescale_match_jax(name):
    """post_step_fn after every step (each of the three loops that call it)
    and prescale False, on a window with t_start > 0."""
    jsampler, tsampler = _pair(name, "edm")
    x = np.random.RandomState(8).randn(*SHAPE).astype(np.float32)
    want, _ = jsampler(_dn_jax, jnp.asarray(x), t_start=1, prescale=False,
                       post_step_fn=lambda x, i: x * 0.97 + 0.02 * i)
    got, _ = tsampler(_dn_torch, torch.from_numpy(x), t_start=1, prescale=False,
                      post_step_fn=lambda x, i: x * 0.97 + 0.02 * i)
    _close(got, want)


def test_heun_and_dpmpp2s_make_2n_minus_1_calls():
    """n steps ending at sigma = 0: the last step takes the Euler branch alone."""
    for name in ("HeunEDMSampler", "DPMPP2SAncestralSampler"):
        _, s = _pair(name, "edm")
        assert tsamp.denoiser_calls(s) == 2 * STEPS - 1


def test_ancestral_step_and_to_d_match_jax():
    for a, b in ((14.6, 3.1), (2.0, 0.0), (0.5, 0.49)):
        for eta in (1.0, 0.3):
            jd, ju = jsamp.get_ancestral_step(jnp.float32(a), jnp.float32(b), eta)
            td, tu = tsamp.get_ancestral_step(a, b, eta)
            _close(td, jd, 1e-6)
            _close(tu, ju, 1e-6)
    x, d = np.random.RandomState(1).randn(2, *SHAPE).astype(np.float32)
    _close(tsamp.to_d(torch.from_numpy(x), 2.5, torch.from_numpy(d)),
           jsamp.to_d(jnp.asarray(x), jnp.float32(2.5)[None], jnp.asarray(d)), 1e-6)


@pytest.mark.parametrize("t_start,order", [(0, 4), (3, 4), (1, 2)])
def test_lms_coefficient_table(t_start, order):
    """lms_coefficients against JAX's linear_multistep_coeff per (loop step,
    j) with the order capped at the loop step + 1, exactly (both scipy quad on
    the same float64 sigmas)."""
    sig_j = np.asarray(jsamp.EulerEDMSampler(jdisc.EDMDiscretization(sigma_max=80.0), STEPS).sigmas(),
                       np.float64)
    got = textra.lms_coefficients(torch.tensor(sig_j, dtype=torch.float32), t_start, STEPS, order)
    for si, i in enumerate(range(t_start, STEPS)):
        cur = min(si + 1, order)
        want = [jextra.linear_multistep_coeff(cur, sig_j, i, j) for j in range(cur)]
        np.testing.assert_array_equal(got[si, :cur], np.float32(want))
        assert (got[si, cur:] == 0).all()
    assert textra.linear_multistep_coeff(1, np.array([10.0, 5.0, 2.0, 0.0]), 0, 0) == pytest.approx(-5.0, rel=1e-4)


def test_lms_t_start_first_step_is_euler():
    """At t_start > 0 the first loop step has one derivative: the Euler step."""
    _, lms = _pair("LinearMultistepSampler", "edm", order=4)
    _, euler = _pair("EulerEDMSampler", "edm")
    x = torch.from_numpy(np.random.RandomState(3).randn(*SHAPE).astype(np.float32))
    a, _ = lms(_dn_torch, x, t_start=4, t_end=5, prescale=False)
    b, _ = euler(_dn_torch, x, t_start=4, t_end=5, prescale=False)
    torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("window", [(0, 5), (2, 3), (4, 10)])
def test_edit_matches_jax_and_returns_base_aux(window):
    """The edit denoiser drives the steps of the window; every step's aux is
    the base denoiser's; the base denoiser runs at every step, the edit
    denoiser at the window's steps alone."""
    jsampler, tsampler = _pair("EulerEDMSampler", "edm")
    x = np.random.RandomState(4).randn(*SHAPE).astype(np.float32)
    calls = {"base": [], "edit": []}

    def jedit(x, s, i):
        return x * 0.2 + 0.1, None

    def tedit(x, s, i):
        calls["edit"].append(i)
        return x * 0.2 + 0.1, ("edit", i)

    def tbase(x, s, i):
        calls["base"].append(i)
        return _dn_torch(x, s, i)[0], ("base", i)

    want, _ = jextra.edit(jsampler, _dn_jax, jedit, jnp.asarray(x), window[0], window[1])
    got, auxes = textra.edit(tsampler, tbase, tedit, torch.from_numpy(x), window[0], window[1])
    _close(got, want)
    assert auxes == [("base", i) for i in range(STEPS)]
    assert calls == {"base": list(range(STEPS)), "edit": [i for i in range(STEPS) if window[0] <= i <= window[1]]}


def test_null_text_optimization_matches_jax():
    """The uc of every outer step, optax's scale_by_adam in JAX, the port's
    own Adam update, on a denoiser that reads uc (tests/test_samplers_extra.py
    TestNTI, with a nonlinear denoiser and several inner steps)."""
    pytest.importorskip("optax")
    jsampler, tsampler = _pair("EulerEDMSampler", "edm")
    rs = np.random.RandomState(5)
    x0 = rs.randn(*SHAPE).astype(np.float32)
    uc0 = rs.randn(*SHAPE).astype(np.float32) * 0.3
    traj = (np.cumsum(rs.randn(STEPS + 1, *SHAPE).astype(np.float32), axis=0) * 0.5 + x0)[::-1].copy()

    def jmake(uc):
        return lambda x, s, i: (jnp.tanh(x + uc) * 0.8 + 0.1 * uc * s, None)

    def tmake(uc):
        return lambda x, s, i: (torch.tanh(x + uc) * 0.8 + 0.1 * uc * s, None)

    want = jextra.null_text_optimization(jsampler, jmake, jnp.asarray(traj), jnp.asarray(uc0),
                                         num_inner_steps=4, lr=5e-2)
    losses = []
    got = textra.null_text_optimization(tsampler, tmake, torch.from_numpy(traj), torch.from_numpy(uc0),
                                        num_inner_steps=4, lr=5e-2, on_loss=lambda i, k, l: losses.append(l))
    assert len(got) == len(want) == STEPS and len(losses) == 4 * STEPS
    for g, w in zip(got, want):
        _close(g, w)   # reads <= 3.8e-6; each uc moves ~0.19 from its start
        assert np.abs(g.numpy() - uc0).max() > 0.1
    assert not got[0].requires_grad


def test_heun_and_dpmpp2s_gradients_finite_at_the_last_step():
    """A gradient through the step to sigma = 0 (null-text optimization
    differentiates a step): the port runs the Euler branch alone there."""
    x = torch.from_numpy(np.random.RandomState(6).randn(*SHAPE).astype(np.float32)).requires_grad_()
    for name in ("HeunEDMSampler", "DPMPP2SAncestralSampler"):
        _, s = _pair(name, "edm")
        sig = s.sigmas().tolist()
        out, _ = s.step(lambda z, sg, i: (z * 0.3, None), x, sig[STEPS - 1], sig[STEPS], STEPS - 1)
        (g,) = torch.autograd.grad((out ** 2).sum(), x)
        assert torch.isfinite(g).all(), name


def _reference_txt2noisy(sigmas, strength, original_steps):
    """scripts/demo/discretization.py:45-59 literally (tests/test_img2vid.py)."""
    asc = sigmas[::-1]
    steps = len(asc) if original_steps is None else original_steps + 1
    prune_index = max(min(int(strength * steps) - 1, steps - 1), 0)
    return asc[prune_index:][::-1]


@pytest.mark.parametrize("steps", [10, 25, 40])
@pytest.mark.parametrize("strength", [0.0, 0.15, 0.2, 0.5, 1.0])
def test_txt2noisy_wrapper_prunes_like_jax(steps, strength):
    """The pruned schedule (original_steps given and not), its prune index and
    t_end against JAX's wrapper and the reference oracle."""
    jd, td = jdisc.EDMDiscretization(0.002, 80.0, 7.0), tdisc.EDMDiscretization(0.002, 80.0, 7.0)
    full = np.asarray(jd(steps, do_append_zero=True))
    for orig in (steps, None):
        jw = japi.Txt2NoisyDiscretizationWrapper(jd, strength=strength, original_steps=orig)
        tw = tapi.Txt2NoisyDiscretizationWrapper(td, strength=strength, original_steps=orig)
        got = tw(steps, do_append_zero=True).numpy()
        np.testing.assert_allclose(got, np.asarray(jw(steps, do_append_zero=True)), rtol=1e-6)
        np.testing.assert_allclose(got, _reference_txt2noisy(full, strength, orig), rtol=1e-6)
        assert tw.prune_index(steps + 1) == jw.prune_index(steps + 1)
        np.testing.assert_allclose(tw(steps, flip=True).numpy(), np.asarray(jw(steps, flip=True)), rtol=1e-6)
    tw = tapi.Txt2NoisyDiscretizationWrapper(td, strength=strength, original_steps=steps)
    assert tw.t_end(steps) == japi.Txt2NoisyDiscretizationWrapper(jd, strength, steps).t_end(steps)
    np.testing.assert_allclose(full[: tw.t_end(steps) + 1], tw(steps).numpy(), rtol=1e-6)
    with pytest.raises(ValueError):
        tapi.Txt2NoisyDiscretizationWrapper(td, strength=1.5)


def test_img2img_strength_window_matches_the_reference_wrapper():
    """img2img_t_start keeps the sigmas the reference's
    Img2ImgDiscretizationWrapper keeps (helpers.py:77-98: flip, keep
    max(int(strength * len), 1), flip back)."""
    for steps in (10, 25, 40, 50):
        sigmas = np.linspace(14.6, 0.0, steps + 1)
        for strength in (0.0, 0.05, 0.2, 0.3, 0.5, 0.75, 0.999, 1.0):
            asc = sigmas[::-1]
            kept = asc[: max(int(strength * len(asc)), 1)][::-1]
            t_start = tapi.img2img_t_start(steps, strength)
            np.testing.assert_allclose(sigmas[t_start:], kept)
            assert (t_start >= steps) == (len(kept) <= 1)
