"""The PyTorch port's autoencoder-training slice against the JAX package's,
on the CPU.

Inputs are numpy arrays from a seed; weights come from the JAX module's
shapes (jax.eval_shape) filled by numpy and are moved into the port's
modules with io/convert.py; JAX applies run under one jax.jit. Where JAX
draws (the posterior's noise, Gumbel's uniforms), the test replays the draw
from JAX's key and hands the array to the port. Tolerances are stated per
test; everything is fp32 unless a case says bf16.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_models import _apply, _init_tree, _load
from test_torch_ops import _bf16_step
from vidseg_diffusion_tpu.engine import train as jtrain
from vidseg_diffusion_tpu.models import lpips as jlp
from vidseg_diffusion_tpu.models import regularizers as jreg
from vidseg_diffusion_tpu.models import vae as jvae
from vidseg_diffusion_tpu.ops import attention as jatt
from vidseg_diffusion_tpu_torch.engine import train as ttrain
from vidseg_diffusion_tpu_torch.engine.diffusion_engine import FirstStage
from vidseg_diffusion_tpu_torch.io import convert
from vidseg_diffusion_tpu_torch.models import lpips as tlp
from vidseg_diffusion_tpu_torch.models import regularizers as treg
from vidseg_diffusion_tpu_torch.models import vae as tvae
from vidseg_diffusion_tpu_torch.ops import attention as tatt
from vidseg_diffusion_tpu_torch.scripts import autoencoder_train_path as ae_path

REG_TOL = 1e-5      # fp32 elementwise math and small reductions
MODULE_TOL = 1e-4   # fp32 modules (VGG16, the discriminator)
# fp32 VAE parameter gradients, per parameter: ||port - JAX|| <= GRAD_TOL *
# max(||JAX||, GRAD_FLOOR * the largest parameter gradient norm), as
# tests/test_torch_train.py holds the UNet's
GRAD_TOL = 2e-4
GRAD_FLOOR = 1e-3
STEP_LOG_TOL = 1e-4   # per-step logs of the two-phase step
# what the first Adam step moved each parameter by, port vs JAX, by norm:
# ||d_port - d_JAX|| <= STEP_UPDATE_TOL * ||d_JAX||. Adam divides each
# element's update by the root of its squared-gradient average, so an element
# whose gradient is near 0 takes a full step on rounding noise; the test's
# Adam eps (1e-5, both sides) keeps such elements in the linear regime. The
# attention k biases have a true gradient of 0 (a bias on k adds one constant
# to every logit of a row, which the softmax removes): both sides step on
# rounding noise, and they are not compared. Later steps are held by their
# logs, which read the parameters the earlier steps left. With LPIPS the
# generator's gradient has elements ~1e-6 of its largest (the unit
# normalization of near-dead VGG features divides by their norm), whose
# rounding differences move such updates by up to 2e-2 of a tensor's: that
# case is held by its logs (and LPIPS's gradient by the module test).
STEP_UPDATE_TOL = 1e-3
T = torch.from_numpy


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the small CPU shapes here gain nothing from more,
    and idle OpenMP threads spin against the suite's other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, tol):
    np.testing.assert_allclose(torch.as_tensor(got).detach().numpy(), np.asarray(want), atol=tol, rtol=tol)


# -- regularizers ---------------------------------------------------------------


def test_diagonal_gaussian_matches_jax():
    """sample (on the noise JAX draws from its key), mode and kl; logvar is
    clipped to [-30, 20] (the moments reach past both ends)."""
    rs = np.random.RandomState(0)
    moments = rs.randn(3, 4, 5, 8).astype(np.float32) * 3
    moments[0, 0, 0, 4], moments[1, 0, 0, 5] = 40.0, -50.0
    rng = jax.random.PRNGKey(1)
    jp = jreg.DiagonalGaussian.from_moments(jnp.asarray(moments))
    tp = treg.DiagonalGaussian.from_moments(T(moments))
    noise = np.asarray(jax.random.normal(rng, jp.mean.shape, jp.mean.dtype))
    _close(tp.sample(T(noise)), jp.sample(rng), REG_TOL)
    _close(tp.mode(), jp.mode(), 0)
    _close(tp.kl(), jp.kl(), REG_TOL)
    jz, jlog = jreg.diagonal_gaussian_regularizer(jnp.asarray(moments), rng)
    tz, tlog = treg.diagonal_gaussian_regularizer(T(moments), noise=T(noise))
    _close(tz, jz, REG_TOL)
    _close(tlog["kl_loss"], jlog["kl_loss"], REG_TOL)
    jz, _ = jreg.diagonal_gaussian_regularizer(jnp.asarray(moments), rng, sample=False)
    _close(treg.diagonal_gaussian_regularizer(T(moments), noise=T(noise), sample=False)[0], jz, 0)


def test_vector_quantize_matches_jax():
    """Values, indices, loss, and the straight-through gradient of a loss
    of both outputs, w.r.t. z and the codebook, against jax.grad."""
    rs = np.random.RandomState(2)
    z, cb, w = rs.randn(2, 3, 4, 6).astype(np.float32), rs.randn(10, 6).astype(np.float32), \
        rs.randn(2, 3, 4, 6).astype(np.float32)

    def jloss(z_, cb_):
        zq, _, log = jreg.vector_quantize(z_, cb_, beta=0.3)
        return jnp.sum(zq * w) + log["vq_loss"]

    jzq, jidx, jlog = jreg.vector_quantize(jnp.asarray(z), jnp.asarray(cb), beta=0.3)
    tz, tcb = T(z).requires_grad_(), T(cb).requires_grad_()
    tzq, tidx, tlog = treg.vector_quantize(tz, tcb, beta=0.3)
    _close(tzq, jzq, REG_TOL)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    _close(tlog["vq_loss"], jlog["vq_loss"], REG_TOL)
    ((tzq * T(w)).sum() + tlog["vq_loss"]).backward()
    gz, gcb = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(z), jnp.asarray(cb))
    _close(tz.grad, gz, REG_TOL)
    _close(tcb.grad, gcb, REG_TOL)


@pytest.mark.parametrize("train", [False, True])
def test_ema_vector_quantize_matches_jax(train):
    """Outputs, perplexity, the straight-through gradient w.r.t. z, and
    (train on) the new codebook's weight, cluster sizes and averages."""
    rs = np.random.RandomState(3)
    z, w = rs.randn(4, 5, 6).astype(np.float32), rs.randn(4, 5, 6).astype(np.float32)
    weight = rs.randn(12, 6).astype(np.float32)
    cluster = rs.rand(12).astype(np.float32)
    avg = rs.randn(12, 6).astype(np.float32)
    jcb = jreg.EMACodebook(weight=jnp.asarray(weight), cluster_size=jnp.asarray(cluster),
                           embed_avg=jnp.asarray(avg), decay=0.9)
    tcb = treg.EMACodebook(weight=T(weight), cluster_size=T(cluster), embed_avg=T(avg), decay=0.9)
    jzq, jidx, jlog, jnew = jreg.ema_vector_quantize(jnp.asarray(z), jcb, beta=0.25, train=train)
    tz = T(z).requires_grad_()
    tzq, tidx, tlog, tnew = treg.ema_vector_quantize(tz, tcb, beta=0.25, train=train)
    _close(tzq, jzq, REG_TOL)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    for key in ("loss/vq", "perplexity"):
        _close(tlog[key], jlog[key], REG_TOL)
    for field in ("weight", "cluster_size", "embed_avg"):
        _close(getattr(tnew, field), getattr(jnew, field), REG_TOL)
    assert (tnew is tcb) == (not train)
    ((tzq * T(w)).sum() + tlog["loss/vq"]).backward()
    gz = jax.grad(lambda z_: jnp.sum(jreg.ema_vector_quantize(z_, jcb, 0.25, train)[0] * w)
                  + jreg.ema_vector_quantize(z_, jcb, 0.25, train)[2]["loss/vq"])(jnp.asarray(z))
    _close(tz.grad, gz, REG_TOL)


@pytest.mark.parametrize("drawn", [True, False])
def test_gumbel_quantize_matches_jax(drawn):
    """On the uniforms JAX draws from its key, and with rng=None (the
    deterministic softmax): values, indices, the KL loss, and the
    straight-through gradient w.r.t. the logits."""
    rs = np.random.RandomState(4)
    logits, cb, w = rs.randn(3, 7, 9).astype(np.float32), rs.randn(9, 5).astype(np.float32), \
        rs.randn(3, 7, 5).astype(np.float32)
    rng = jax.random.PRNGKey(5) if drawn else None
    uniform = (np.asarray(jax.random.uniform(rng, logits.shape, minval=1e-10, maxval=1.0))
               if drawn else None)
    jzq, jidx, jlog = jreg.gumbel_quantize(rng, jnp.asarray(logits), jnp.asarray(cb), tau=0.7)
    tl = T(logits).requires_grad_()
    tzq, tidx, tlog = treg.gumbel_quantize(tl, T(cb), None if uniform is None else T(uniform), tau=0.7)
    _close(tzq, jzq, REG_TOL)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    _close(tlog["loss/vq"], jlog["loss/vq"], REG_TOL)
    ((tzq * T(w)).sum() + tlog["loss/vq"]).backward()

    def jloss(lg):
        zq, _, log = jreg.gumbel_quantize(rng, lg, jnp.asarray(cb), tau=0.7)
        return jnp.sum(zq * w) + log["loss/vq"]

    _close(tl.grad, jax.grad(jloss)(jnp.asarray(logits)), REG_TOL)


# -- LPIPS, the discriminator, the adversarial losses ----------------------------


@pytest.fixture(scope="module")
def lpips_pair():
    """JAX LPIPS params (VGG16 trunk + five heads, the heads non-negative as
    trained ones are) and the port's LPIPS carrying them, at 32x32 inputs."""
    x = jnp.zeros((2, 32, 32, 3))
    jm = jlp.LPIPS()
    params = _init_tree(jm, 11, x, x)
    for i in range(5):
        params[f"lin_{i}"]["kernel"] = np.abs(params[f"lin_{i}"]["kernel"])
    tm = _load(tlp.LPIPS(), params, convert.autoencoder_loss_key_fn)
    return jm, params, tm


def test_vgg16_taps_and_lpips_match_jax(lpips_pair):
    """The five VGG16 taps (before each max-pool), the LPIPS distance and its
    gradient w.r.t. the second input (1e-5 by norm; reads 2e-6); identical
    inputs give 0."""
    jm, params, tm = lpips_pair
    rs = np.random.RandomState(6)
    x, y = (rs.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32) for _ in range(2))
    jtaps = _apply(jlp.VGG16Features(), params["vgg"], jnp.asarray(x))
    with torch.no_grad():
        ttaps = tm.vgg(T(x))
        assert [tuple(t.shape) for t in ttaps] == [(2, 32, 32, 64), (2, 16, 16, 128), (2, 8, 8, 256),
                                                   (2, 4, 4, 512), (2, 2, 2, 512)]
        for a, b in zip(ttaps, jtaps):
            scale = float(np.abs(np.asarray(b)).max())
            _close(a / scale, np.asarray(b) / scale, MODULE_TOL)
        want = _apply(jm, params, jnp.asarray(x), jnp.asarray(y))
        _close(tm(T(x), T(y)), want, MODULE_TOL)
        assert float(np.asarray(want).min()) > 0
        assert float(tm(T(x), T(x)).abs().max()) == 0.0
    gj = jax.jit(jax.grad(lambda b: jnp.sum(jm.apply({"params": params}, jnp.asarray(x), b))))(jnp.asarray(y))
    ty = T(y).requires_grad_()
    tm(T(x), ty).sum().backward()
    assert np.linalg.norm(ty.grad.numpy() - np.asarray(gj)) <= 1e-5 * np.linalg.norm(np.asarray(gj))


@pytest.mark.parametrize("size", [32, 37])
def test_discriminator_matches_jax(size):
    """NLayerDiscriminator at an even and an odd input: flax's SAME padding
    of the 4x4 convolutions (1 before, 2 after for the stride-1 ones and for
    a stride-2 one on an odd size) and GroupNorm(group_size=1) with eps 1e-6."""
    rs = np.random.RandomState(7)
    x = rs.uniform(-1, 1, (2, size, size, 3)).astype(np.float32)
    jm = jlp.NLayerDiscriminator(ndf=8, n_layers=3)
    params = _init_tree(jm, 12, jnp.asarray(x))
    tm = _load(tlp.NLayerDiscriminator(ndf=8, n_layers=3), params, convert.autoencoder_loss_key_fn)
    want = _apply(jm, params, jnp.asarray(x))
    with torch.no_grad():
        got = tm(T(x))
    assert got.shape == want.shape
    _close(got, want, MODULE_TOL)


def test_adversarial_losses_match_jax():
    rs = np.random.RandomState(8)
    real, fake = rs.randn(2, 5, 5, 1).astype(np.float32), rs.randn(2, 5, 5, 1).astype(np.float32)
    _close(tlp.hinge_d_loss(T(real), T(fake)), jlp.hinge_d_loss(jnp.asarray(real), jnp.asarray(fake)), REG_TOL)
    _close(tlp.vanilla_d_loss(T(real), T(fake)), jlp.vanilla_d_loss(jnp.asarray(real), jnp.asarray(fake)),
           REG_TOL)
    _close(tlp.generator_adv_loss(T(fake)), jlp.generator_adv_loss(jnp.asarray(fake)), REG_TOL)


# -- K3 under autograd ----------------------------------------------------------

# (b, h, lq, d, dtype): D = 32 and 64 as tests/test_kernel_grads.py, D = 512 at
# ragged lengths, bhld with H > 1
K3_GRAD_CASES = [(2, 2, 128, 32, "fp32"), (2, 1, 200, 32, "fp32"), (1, 2, 100, 64, "fp32"),
                 (1, 1, 72, 512, "fp32"), (2, 1, 200, 512, "fp32"), (1, 1, 72, 512, "bf16"),
                 (1, 2, 130, 64, "bf16")]


@pytest.mark.parametrize("b,h,l,d,dt", K3_GRAD_CASES)
def test_flash_attention_grads_match_jax(b, h, l, d, dt, monkeypatch):
    """K3's autograd Function (the CPU plain path: forward with the base-2
    LSE, the packed backward's math with heads=1) against jax.vjp of the
    JAX package's flash_attention in interpret mode with its Pallas backward
    (VIDSEG_PALLAS_ATTN_BWD=1). fp32 at 1e-5 of max |grad|; bf16 within 2
    bf16 steps at max |grad| and a relative RMS error of 4e-3 (the Pallas
    kernel rounds p against a running max per key block, the plain version
    against the row's max)."""
    monkeypatch.setenv("VIDSEG_PALLAS_ATTN_BWD", "1")
    rs = np.random.RandomState(l + d)
    q, k, v, g = (rs.randn(b, h, l, d).astype(np.float32) for _ in range(4))
    jdt, tdt = (jnp.float32, torch.float32) if dt == "fp32" else (jnp.bfloat16, torch.bfloat16)
    _, vjp = jax.vjp(lambda *a: jatt.flash_attention(*a, interpret=True),
                     *(jnp.asarray(a, jdt) for a in (q, k, v)))
    want = [np.asarray(w.astype(jnp.float32)) for w in vjp(jnp.asarray(g, jdt))]
    leaves = [T(a).to(tdt).requires_grad_() for a in (q, k, v)]
    calls = tatt.flash_attention_backward_reference.calls
    out = tatt.flash_attention(*leaves)
    assert type(out.grad_fn).__name__ == "_FlashAttentionBackward"
    got = torch.autograd.grad(out, leaves, T(g).to(tdt))
    assert tatt.flash_attention_backward_reference.calls == calls + 1
    for a, w in zip(got, want):
        assert a.dtype == tdt
        a = a.float().numpy()
        if dt == "fp32":
            np.testing.assert_allclose(a, w, atol=1e-5 * np.abs(w).max(), rtol=0)
        else:
            assert np.abs(a - w).max() <= 2 * _bf16_step(np.abs(w).max())
            assert np.linalg.norm(a - w) <= 4e-3 * np.linalg.norm(w)


# -- the VAE under autograd -------------------------------------------------------

# the smallest image VAE with a mid attention whose GroupNorms hold two channels
# per group (with one, a conv bias before a norm has a gradient of 0 and both
# sides read rounding noise, which Adam would blow up to +-lr)
_AE_VAE = dict(ch=64, ch_mult=(1, 2), num_res_blocks=1)


def _tiny_vae(seed, x, z):
    cfg = dict(_AE_VAE)
    je, jd = jvae.Encoder(jvae.VAEConfig(**cfg)), jvae.Decoder(jvae.VAEConfig(**cfg))
    ep, dp = _init_tree(je, seed, jnp.asarray(x)), _init_tree(jd, seed + 1, jnp.asarray(z))
    te = _load(tvae.Encoder(tvae.VAEConfig(**cfg)), ep, convert.vae_key_fn).train()
    td = _load(tvae.Decoder(tvae.VAEConfig(**cfg)), dp, convert.vae_key_fn).train()
    return je, jd, ep, dp, te, td


def test_vae_parameter_gradients_match_jax():
    """d(sum(decode(mode(encode(x))) * g))/d(params) of a tiny image VAE with
    its mid attentions, port vs jax.grad on the same weights: 2e-4 by norm
    with a floor. Nothing in the encoder or decoder detaches: every
    parameter has a gradient."""
    rs = np.random.RandomState(9)
    x = rs.uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)
    g = rs.randn(2, 16, 16, 3).astype(np.float32)
    je, jd, ep, dp, te, td = _tiny_vae(13, x, np.zeros((2, 8, 8, 4), np.float32))

    def loss(p):
        mom = je.apply({"params": p["encoder"]}, jnp.asarray(x))
        return jnp.sum(jd.apply({"params": p["decoder"]}, mom[..., :4]) * g)

    jg = jax.jit(jax.grad(loss))({"encoder": ep, "decoder": dp})
    want = {f"encoder.{k}": v for k, v in convert.jax_to_state_dict(jg["encoder"], convert.vae_key_fn).items()}
    want.update({f"decoder.{k}": v for k, v in convert.jax_to_state_dict(jg["decoder"], convert.vae_key_fn).items()})
    fs = FirstStage(te, td)
    (fs.reconstruct(fs.moments(T(x))[..., :4]) * T(g)).sum().backward()
    got = {n: p.grad for n, p in fs.modules().named_parameters()}
    assert got.keys() == want.keys() and all(v is not None for v in got.values())
    floor = GRAD_FLOOR * max(np.linalg.norm(w) for w in want.values())
    for name, w in want.items():
        err = np.linalg.norm(got[name].numpy() - w)
        assert err <= GRAD_TOL * max(np.linalg.norm(w), floor), (name, err, np.linalg.norm(w))


# -- the two-phase step -------------------------------------------------------------


@pytest.mark.parametrize("disc_loss,disc_start,with_lpips", [("hinge", 0, True), ("vanilla", 0, False),
                                                             ("hinge", 10, False)])
def test_autoencoder_train_step_matches_jax(disc_loss, disc_start, with_lpips, lpips_pair):
    """Three steps of AutoencoderTrainStep against make_autoencoder_train_step
    with optax.adam, on the posterior noise JAX draws from each step's key:
    per-step logs at 1e-4, and (without LPIPS) what the first step moved
    every generator and discriminator parameter by (STEP_UPDATE_TOL). Hinge and vanilla; the
    adversarial term on from step 0, or (disc_start 10) computed and weighted
    by 0 in every step."""
    rs = np.random.RandomState(10)
    x = rs.uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)
    je, jd, ep, dp, te, td = _tiny_vae(14, x, np.zeros((2, 8, 8, 4), np.float32))
    jdisc = jlp.NLayerDiscriminator(ndf=8, n_layers=2)
    discp = _init_tree(jdisc, 15, jnp.asarray(x))
    tdisc = _load(tlp.NLayerDiscriminator(ndf=8, n_layers=2), discp, convert.autoencoder_loss_key_fn).train()
    cfg = dataclasses.replace(jlp.AutoencoderLossConfig(), disc_start=disc_start, disc_loss=disc_loss,
                              kl_weight=1e-2)
    tcfg = dataclasses.replace(tlp.AutoencoderLossConfig(), disc_start=disc_start, disc_loss=disc_loss,
                               kl_weight=1e-2)
    jl_apply, tl_fn = None, None
    if with_lpips:
        jm, lparams, tm = lpips_pair
        jl_apply = lambda a, b: jm.apply({"params": lparams}, a, b)
        tl_fn = tm.requires_grad_(False)
    lr, eps = 1e-4, 1e-5
    step = jax.jit(jtrain.make_autoencoder_train_step(
        lambda p, a: je.apply({"params": p["encoder"]}, a), lambda p, z: jd.apply({"params": p["decoder"]}, z),
        lambda p, a: jdisc.apply({"params": p}, a), jl_apply, optax.adam(lr, eps=eps), optax.adam(lr, eps=eps), cfg))
    gp = {"encoder": ep, "decoder": dp}
    gopt, dopt = optax.adam(lr, eps=eps).init(gp), optax.adam(lr, eps=eps).init(discp)
    fs = FirstStage(te, td)
    trainer = ttrain.AutoencoderTrainStep(
        fs.moments, fs.reconstruct, tdisc, tl_fn, torch.optim.Adam(fs.modules().parameters(), lr=lr, eps=eps),
        torch.optim.Adam(tdisc.parameters(), lr=lr, eps=eps), tcfg)
    def params_of(gen, disc):
        sd = {f"{part}.{k}": v for part in ("encoder", "decoder")
              for k, v in convert.jax_to_state_dict(gen[part], convert.vae_key_fn).items()}
        sd.update({f"disc.{k}": v for k, v in convert.jax_to_state_dict(disc, convert.autoencoder_loss_key_fn).items()})
        return sd

    before = params_of(gp, discp)
    for i in range(3):
        rng = jax.random.PRNGKey(20 + i)
        noise = np.asarray(jax.random.normal(rng, (2, 8, 8, 4)))
        gp, discp, gopt, dopt, jlogs = step(gp, discp, gopt, dopt, rng, jnp.asarray(x), jnp.asarray(i))
        tlogs = trainer.step(T(x), i, noise=T(noise))
        assert tlogs.keys() == jlogs.keys()
        for key in jlogs:
            _close(tlogs[key], jlogs[key], STEP_LOG_TOL)
        if i == 0 and not with_lpips:
            want = params_of(gp, discp)
            got = dict(fs.modules().named_parameters())
            got.update({f"disc.{k}": v for k, v in tdisc.named_parameters()})
            assert got.keys() == want.keys()
            for name, w in want.items():
                if name.endswith("attn_1.k.bias"):
                    continue
                d_jax, d_port = w - before[name], got[name].detach().numpy() - before[name]
                err = np.linalg.norm(d_port - d_jax)
                assert err <= STEP_UPDATE_TOL * np.linalg.norm(d_jax), (name, err, np.linalg.norm(d_jax))
    assert trainer.step_count == 3 and ("p_loss" in tlogs) == with_lpips


def test_autoencoder_train_path_takes_a_step_on_a_tiny_config():
    """scripts/autoencoder_train_path.py builds its trainer (full LPIPS and
    discriminator, a tiny first stage) on the CPU and takes a step: finite
    logs, p_loss > 0, the generator and discriminator weights move, LPIPS's
    do not."""
    tiny = tvae.VAEConfig(ch=32, ch_mult=(1, 2), num_res_blocks=1, dtype=torch.float32)
    trainer, fs = ae_path.build(device="cpu", vae=tiny)
    before = {n: p.detach().clone() for n, p in fs.modules().named_parameters()}
    disc0 = {n: p.detach().clone() for n, p in trainer.discriminator.named_parameters()}
    lp0 = {n: p.detach().clone() for n, p in trainer.lpips_fn.named_parameters()}
    x = ae_path.batch(device="cpu", dtype=torch.float32, height=32, width=32)
    logs = trainer.step(x, 0, generator=ae_path.noise_generator("cpu"))
    assert set(logs) == {"rec_loss", "p_loss", "kl_loss", "total", "g_adv", "g_loss", "d_loss"}
    assert all(torch.isfinite(v) for v in logs.values()) and logs["p_loss"] > 0
    assert ae_path.LOSS_CONFIG.disc_start == 0 and logs["g_loss"] != logs["total"]
    assert any(not torch.equal(before[n], p) for n, p in fs.modules().named_parameters())
    assert any(not torch.equal(disc0[n], p) for n, p in trainer.discriminator.named_parameters())
    assert all(torch.equal(lp0[n], p) for n, p in trainer.lpips_fn.named_parameters())
