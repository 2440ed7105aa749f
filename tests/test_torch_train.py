"""The PyTorch port's training path against the JAX package's, on the CPU.

Inputs and weights are numpy arrays from a seed, fed to both. Where JAX
draws sigma and noise from its key, the test replays the draw (the split of
diffusion/loss.py:77) and hands the arrays to the port's loss, which takes
them in place of its generators. Everything is fp32; tolerances are stated
per test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_models import _init_tree, _load
from vidseg_diffusion_tpu.diffusion import denoiser as jden
from vidseg_diffusion_tpu.diffusion import loss as jloss
from vidseg_diffusion_tpu.diffusion import scaling as jscal
from vidseg_diffusion_tpu.engine import train as jtrain
from vidseg_diffusion_tpu.models import unet as junet
from vidseg_diffusion_tpu.utils import ema as jema
from vidseg_diffusion_tpu_torch.diffusion import denoiser as tden
from vidseg_diffusion_tpu_torch.diffusion import loss as tloss
from vidseg_diffusion_tpu_torch.diffusion import scaling as tscal
from vidseg_diffusion_tpu_torch.engine import train as ttrain
from vidseg_diffusion_tpu_torch.engine.build import randomize_
from vidseg_diffusion_tpu_torch.io import convert
from vidseg_diffusion_tpu_torch.models import unet as tunet
from vidseg_diffusion_tpu_torch.ops import attention as tatt
from vidseg_diffusion_tpu_torch.ops import temporal_conv as ttc
from vidseg_diffusion_tpu_torch.scripts import train_path
from vidseg_diffusion_tpu_torch.utils import ema as tema

LOSS_TOL = 1e-6     # fp32 elementwise math and one mean
# fp32 UNet gradients, per parameter: ||port - JAX|| <= GRAD_TOL * max(||JAX||,
# GRAD_FLOOR * the largest parameter gradient norm). The floor is for the
# biases that feed a GroupNorm of one channel per group (model_channels 32):
# their true gradient is 0 and both sides read rounding noise (~1e-6 of a
# largest norm ~370). The sound readings: worst 6.3e-5 with the floor.
GRAD_TOL = 2e-4
GRAD_FLOOR = 1e-3
T = torch.from_numpy


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the small CPU shapes here gain nothing from more,
    and idle OpenMP threads spin against the suite's other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_draws(loss_mod, rng, x0):
    """The sigma and noise JAX's StandardDiffusionLoss draws from `rng`."""
    r_sigma, r_noise = jax.random.split(rng)
    sigma = loss_mod.sigma_sampler(r_sigma, x0.shape[0]).astype(x0.dtype)
    noise = jax.random.normal(r_noise, x0.shape, dtype=x0.dtype)
    return np.array(sigma), np.array(noise)


# -- loss ---------------------------------------------------------------------


@pytest.mark.parametrize("loss_type", ["l2", "l1"])
@pytest.mark.parametrize("weighting", ["unit", "eps", "v"])
def test_standard_diffusion_loss_matches_jax(loss_type, weighting):
    rs = np.random.RandomState(0)
    x0 = rs.randn(6, 5, 4, 3).astype(np.float32)
    w = rs.randn(3).astype(np.float32)
    jw = {"unit": jloss.unit_weighting, "eps": jloss.eps_weighting, "v": jloss.v_weighting}[weighting]
    tw = {"unit": tloss.unit_weighting, "eps": tloss.eps_weighting, "v": tloss.v_weighting}[weighting]
    jl = jloss.StandardDiffusionLoss(jden.Denoiser(jscal.VScalingWithEDMcNoise()), jloss.EDMSigmaSampling(),
                                     weighting=jw, loss_type=loss_type)
    tl = tloss.StandardDiffusionLoss(tden.Denoiser(tscal.VScalingWithEDMcNoise()), tloss.EDMSigmaSampling(),
                                     weighting=tw, loss_type=loss_type)
    # a network that uses both its input and c_noise
    jnet = lambda x, c, cond: x @ jnp.diag(jnp.asarray(w)) + c[:, None, None, None] * 0.1
    tnet = lambda x, c, cond: (x @ torch.diag(T(w)) + c[:, None, None, None] * 0.1, None)
    rng = jax.random.PRNGKey(3)
    want = jl(jnet, rng, jnp.asarray(x0), {})
    sigma, noise = _jax_draws(jl, rng, jnp.asarray(x0))
    got = tl(tnet, T(x0), {}, sigma=T(sigma), noise=T(noise))
    np.testing.assert_allclose(got.item(), float(want), rtol=LOSS_TOL * 10, atol=LOSS_TOL)


def test_sigma_samplers_and_lpips():
    """The sigma samplers' draws, and the lpips loss type against JAX's: the
    LPIPS distance of the denoised prediction to x0 (weights moved by
    io/convert.py), averaged over the batch without the sigma weighting; a
    missing lpips_fn raises."""
    from vidseg_diffusion_tpu.models import lpips as jlp
    from vidseg_diffusion_tpu_torch.models import lpips as tlp

    g = torch.Generator().manual_seed(0)
    s = tloss.EDMSigmaSampling()(4096, generator=g)
    # log sigma ~ N(-1.2, 1.2): the sample moments within 5 standard errors
    assert abs(s.log().mean().item() + 1.2) < 5 * 1.2 / 64 and abs(s.log().std().item() - 1.2) < 0.1
    table = torch.tensor([0.1, 0.5, 2.0, 14.6])
    d = tloss.DiscreteSigmaSampling(table)(64, generator=g)
    assert set(d.tolist()) <= set(table.tolist()) and len(set(d.tolist())) > 1
    with pytest.raises(ValueError, match="lpips_fn"):
        tloss.StandardDiffusionLoss(tden.Denoiser(tscal.EpsScaling()), tloss.EDMSigmaSampling(),
                                    loss_type="lpips")

    x0 = np.random.RandomState(5).uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)
    jm = jlp.LPIPS()
    params = _init_tree(jm, 6, jnp.asarray(x0), jnp.asarray(x0))
    tm = _load(tlp.LPIPS(), params, convert.module_key_fn)
    jl = jloss.StandardDiffusionLoss(jden.Denoiser(jscal.EpsScaling()), jloss.EDMSigmaSampling(),
                                     weighting=jloss.eps_weighting, loss_type="lpips",
                                     lpips_fn=lambda a, b: jm.apply({"params": params}, a, b))
    tl = tloss.StandardDiffusionLoss(tden.Denoiser(tscal.EpsScaling()), tloss.EDMSigmaSampling(),
                                     weighting=tloss.eps_weighting, loss_type="lpips", lpips_fn=tm)
    jnet = lambda x, c, cond: 0.5 * x
    tnet = lambda x, c, cond: (0.5 * x, None)
    rng = jax.random.PRNGKey(7)
    want = jax.jit(lambda x: jl(jnet, rng, x, {}))(jnp.asarray(x0))
    sigma, noise = _jax_draws(jl, rng, jnp.asarray(x0))
    with torch.no_grad():
        got = tl(tnet, T(x0), {}, sigma=T(sigma), noise=T(noise))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-4, atol=1e-6)


def test_loss_generators_are_one_per_site():
    """The sigma draw and the noise draw each come from their own generator:
    reseeding only the noise generator leaves sigma as it was."""
    x0 = torch.zeros(3, 2, 2, 1)
    seen = []

    def net(x, c, cond):
        seen.append(c.clone())
        return x, None

    tl = tloss.StandardDiffusionLoss(tden.Denoiser(tscal.VScalingWithEDMcNoise()), tloss.EDMSigmaSampling())
    tl(net, x0, {}, generators=(torch.Generator().manual_seed(1), torch.Generator().manual_seed(2)))
    tl(net, x0, {}, generators=(torch.Generator().manual_seed(1), torch.Generator().manual_seed(5)))
    assert torch.equal(seen[0], seen[1])


# -- EMA and LR schedules -----------------------------------------------------


def test_ema_matches_jax():
    rs = np.random.RandomState(1)
    shapes = {"a": (3, 4), "b": (5,)}
    steps = [{k: rs.randn(*s).astype(np.float32) for k, s in shapes.items()} for _ in range(4)]
    model = torch.nn.Module()
    for k, s in shapes.items():
        model.register_parameter(k, torch.nn.Parameter(T(steps[0][k].copy())))
    jstate = jema.ema_init({k: jnp.asarray(v) for k, v in steps[0].items()})
    tstate = tema.ema_init(model)
    for p in steps[1:]:
        with torch.no_grad():
            for k in shapes:
                getattr(model, k).copy_(T(p[k]))
        jstate = jema.ema_update(jstate, {k: jnp.asarray(v) for k, v in p.items()}, decay=0.9)
        tema.ema_update(tstate, model, decay=0.9)
    assert tstate.num_updates == int(jstate.num_updates) == 3
    for k in shapes:
        np.testing.assert_allclose(tstate.params[k].numpy(), np.asarray(jstate.params[k]), atol=1e-6)


_SCHEDULES = {
    "warmup_cosine": dict(warm_up_steps=5, lr_min=0.1, lr_max=1.0, lr_start=0.01, max_decay_steps=30),
    "warmup_cosine2": dict(warm_up_steps=[3, 4], f_min=[0.1, 0.2], f_max=[1.0, 0.8],
                           f_start=[0.0, 0.1], cycle_lengths=[10, 15]),
    "linear": dict(warm_up_steps=[3, 4], f_min=[0.1, 0.2], f_max=[1.0, 0.8],
                   f_start=[0.0, 0.1], cycle_lengths=[10, 15]),
}


@pytest.mark.parametrize("name", list(_SCHEDULES))
def test_lr_schedules_match_jax(name):
    """Every step through both cycles and past the end, boundary steps
    included; the torch schedules drive LambdaLR."""
    fn = {"warmup_cosine": "lambda_warmup_cosine", "warmup_cosine2": "lambda_warmup_cosine2",
          "linear": "lambda_linear"}[name]
    jf, tf = getattr(jema, fn)(**_SCHEDULES[name]), getattr(tema, fn)(**_SCHEDULES[name])
    steps = list(range(0, 40))
    want = np.asarray(jax.vmap(jf)(jnp.asarray(steps)))
    got = np.asarray([tf(s) for s in steps])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    opt = torch.optim.SGD([torch.nn.Parameter(torch.zeros(1))], lr=1.0)
    sched = torch.optim.lr_scheduler.LambdaLR(opt, tf)
    for s in steps[:12]:
        assert opt.param_groups[0]["lr"] == pytest.approx(tf(s))
        opt.step()
        sched.step()


# -- the training step --------------------------------------------------------


def test_train_step_with_adam_matches_jax():
    """The linear network of tests/test_training.py (x * w, eps scaling,
    EDM sigmas), Adam 5e-2 with EMA: losses, w and the EMA of w per step."""
    jl = jloss.StandardDiffusionLoss(jden.Denoiser(jscal.EpsScaling()), jloss.EDMSigmaSampling())
    init, step = jtrain.make_diffusion_train_step(
        lambda p: (lambda x, c, cond: x * p["w"]), jl, optax.adam(5e-2), use_ema=True)
    state = init({"w": jnp.asarray(0.0)})
    batch = np.array(jax.random.normal(jax.random.PRNGKey(0), (8, 4, 4, 2)))

    model = torch.nn.Module()
    model.w = torch.nn.Parameter(torch.tensor(0.0))
    tl = tloss.StandardDiffusionLoss(tden.Denoiser(tscal.EpsScaling()), tloss.EDMSigmaSampling())
    trainer = ttrain.DiffusionTrainStep(
        model, lambda m: (lambda x, c, cond: (x * m.w, None)), tl, torch.optim.Adam(model.parameters(), lr=5e-2))
    jstep = jax.jit(step)
    for i in range(5):
        rng = jax.random.PRNGKey(i)
        sigma, noise = _jax_draws(jl, rng, jnp.asarray(batch))
        state, logs = jstep(state, rng, jnp.asarray(batch), {})
        loss = trainer.step(T(batch), {}, sigma=T(sigma), noise=T(noise))
        np.testing.assert_allclose(loss.item(), float(logs["loss"]), rtol=1e-5)
        np.testing.assert_allclose(model.w.item(), float(state.params["w"]), rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(trainer.ema.params["w"].item(), float(state.ema.params["w"]),
                                   rtol=1e-5, atol=1e-7)
    assert trainer.step_count == int(state.step) == 5


# -- the video UNet's gradients ----------------------------------------------

# the smallest video UNet with a spatial and a temporal attention site (the
# middle block's SpatialVideoTransformer) and its temporal convolutions (the
# time_stack of every VideoResBlock)
_GRAD_UNET = dict(in_channels=8, out_channels=4, model_channels=32, num_res_blocks=1,
                  attention_resolutions=(), channel_mult=(1,), num_head_channels=16,
                  context_dim=24, adm_in_channels=12)


def _unet_inputs(t, seed):
    rs = np.random.RandomState(seed)
    return (rs.randn(2 * t, 8, 8, 8).astype(np.float32), rs.randn(2 * t).astype(np.float32),
            rs.randn(2 * t, 1, 24).astype(np.float32), rs.randn(2 * t, 12).astype(np.float32),
            rs.randn(2 * t, 8, 8, 4).astype(np.float32))


def _backward_calls():
    return (tatt.temporal_attention_direct_backward_reference.calls,
            ttc.temporal_conv_1x1_backward_reference.calls)


def _port_grads(tm, inputs, t):
    x, ts, ctx, y, g = map(T, inputs)
    tm.zero_grad(set_to_none=True)
    out = tm(x, ts, ctx, y, num_video_frames=t, image_only_indicator=torch.zeros(2, t))
    (out * g).sum().backward()
    return {n: p.grad for n, p in tm.named_parameters()}


def test_video_unet_gradients_match_jax(monkeypatch):
    """d(sum(out * g))/d(params), port vs JAX, on the same weights. The
    port's CPU path runs the temporal attention and the temporal convs
    through their autograd Functions (K6's and K4's plain backward
    versions); JAX takes XLA's VJPs. What feeds only the query or key of a
    one-key cross-attention (attn2's q/k projections and the norm2 before
    them) gets no gradient in the port (the V shortcut) and zeros in JAX."""
    monkeypatch.delenv("VIDSEG_TEMPORAL_LAYOUT", raising=False)
    t = 3
    inputs = _unet_inputs(t, 4)
    jm = junet.UNetModel(junet.UNetConfig(video=True, **_GRAD_UNET))
    params = _init_tree(jm, 5, *map(jnp.asarray, inputs[:4]), num_video_frames=t,
                        image_only_indicator=jnp.zeros((2, t)))
    x, ts, ctx, y, g = map(jnp.asarray, inputs)

    def loss(p):
        out = jm.apply({"params": p}, x, ts, ctx, y, num_video_frames=t,
                       image_only_indicator=jnp.zeros((2, t)))
        return jnp.sum(out * g)

    want = convert.jax_to_state_dict(jax.jit(jax.grad(loss))(params), convert.unet_key_fn)
    tm = _load(tunet.UNetModel(tunet.UNetConfig(**_GRAD_UNET)), params, convert.unet_key_fn)
    calls = _backward_calls()
    got = _port_grads(tm, inputs, t)
    assert all(n > c for n, c in zip(_backward_calls(), calls))  # K6's and K4's plain backward ran
    assert got.keys() == want.keys()
    floor = GRAD_FLOOR * max(np.linalg.norm(w) for w in want.values())
    for name, w in want.items():
        gp = got[name]
        if gp is None:
            assert any(s in name for s in ("attn2.to_q", "attn2.to_k", "norm2.")), name
            assert not np.any(w), name
            continue
        err = np.linalg.norm(gp.numpy() - w)
        assert err <= GRAD_TOL * max(np.linalg.norm(w), floor), (name, err, np.linalg.norm(w))


def test_remat_gradients_equal_no_remat_bit_for_bit():
    """torch.utils.checkpoint per block recomputes the same forward: every
    gradient is bitwise the one without remat; inference is unaffected."""
    t = 2
    inputs = _unet_inputs(t, 6)
    plain = tunet.UNetModel(tunet.UNetConfig(**_GRAD_UNET))
    randomize_(plain, torch.Generator().manual_seed(0))
    remat = tunet.UNetModel(tunet.UNetConfig(remat=True, **_GRAD_UNET))
    remat.load_state_dict(plain.state_dict())
    a, b = _port_grads(plain, inputs, t), _port_grads(remat, inputs, t)
    assert a.keys() == b.keys()
    for name in a:
        assert (a[name] is None) == (b[name] is None), name
        if a[name] is not None:
            assert torch.equal(a[name], b[name]), name
    with torch.no_grad():
        x, ts, ctx, y, _ = map(T, inputs)
        kw = dict(num_video_frames=t, image_only_indicator=torch.zeros(2, t))
        assert torch.equal(plain(x, ts, ctx, y, **kw), remat(x, ts, ctx, y, **kw))


def test_unet_backward_runs_group_norm_fn_once_per_site():
    """Every GroupNorm module of the UNet goes through GroupNormFn: one plain
    coefficient-form backward per module per loss.backward(), and with remat
    one extra plain forward per module inside a checkpointed block."""
    from vidseg_diffusion_tpu_torch.models.layers import GroupNorm32
    from vidseg_diffusion_tpu_torch.ops import norm as tnorm

    t = 2
    inputs = _unet_inputs(t, 8)
    for remat in (False, True):
        tm = tunet.UNetModel(tunet.UNetConfig(remat=remat, **_GRAD_UNET))
        randomize_(tm, torch.Generator().manual_seed(0))
        sites = sum(isinstance(m, GroupNorm32) for m in tm.modules())
        fwd, bwd = tnorm.group_norm_plain.calls, tnorm.group_norm_backward_plain.calls
        grads = _port_grads(tm, inputs, t)
        assert tnorm.group_norm_backward_plain.calls - bwd == sites
        recomputed = sites - 1 if remat else 0   # all but the `out` norm sit in checkpointed blocks
        assert tnorm.group_norm_plain.calls - fwd == sites + recomputed
        gn = [n for n, m in tm.named_modules() if isinstance(m, GroupNorm32)]
        assert all(grads[f"{n}.weight"] is not None and grads[f"{n}.bias"] is not None for n in gn)


def test_training_setup_takes_a_step_on_a_tiny_unet():
    """scripts/train_path.py's network and loss drive the trainer on a tiny
    remat UNet: finite loss, every parameter with a gradient finite, the
    weights and the EMA move."""
    t = 2
    unet = tunet.UNetModel(tunet.UNetConfig(remat=True, **dict(_GRAD_UNET, context_dim=1024,
                                                                 adm_in_channels=768)))
    train_path.init_normal_(unet, torch.Generator().manual_seed(1))
    before = {n: p.detach().clone() for n, p in unet.named_parameters()}
    trainer = ttrain.DiffusionTrainStep(unet, train_path.network_factory(t), train_path.loss_module(),
                                        torch.optim.Adam(unet.parameters(), lr=1e-3))
    rs = np.random.RandomState(2)
    latents = T(rs.randn(2 * t, 8, 8, 4).astype(np.float32))
    cond = {"crossattn": T(rs.randn(2 * t, 1, 1024).astype(np.float32)),
            "vector": T(rs.randn(2 * t, 768).astype(np.float32)),
            "concat": T(rs.randn(2 * t, 8, 8, 4).astype(np.float32))}
    loss = trainer.step(latents, cond, generators=(torch.Generator().manual_seed(3),
                                                  torch.Generator().manual_seed(4)))
    assert torch.isfinite(loss)
    grads = {n: p.grad for n, p in unet.named_parameters() if p.grad is not None}
    assert all(torch.isfinite(g).all() for g in grads.values())
    assert any(not torch.equal(before[n], p) for n, p in unet.named_parameters())
    assert any(not torch.equal(before[n], trainer.ema.params[n]) for n in before)
