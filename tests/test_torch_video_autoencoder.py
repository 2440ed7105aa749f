"""Training svd.yaml's own first stage (Encoder + the temporal VideoDecoder)
in the PyTorch port against the JAX package, on the CPU.

The two attention backwards the VideoDecoder's VideoAttnBlock needs at its
one 512-dim head (the packed backward, K5's sites, at one head; the
direct-layout temporal backward, K6's, at D = 512) as plain versions against
jax.vjp of the JAX functions run as the JAX package's own CPU tests run them
(Pallas in interpret mode); then AutoencoderTrainStep on an Encoder and a
VideoDecoder at 'conv-only', 'all' and 'attn-only' against
make_autoencoder_train_step with optax.adam, on the same weights (moved by
io/convert.py), frames and posterior noise. Inputs come from numpy seeds.
Tolerances are stated per test.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_models import _init_tree, _load
from test_torch_ops import _bf16_step
from vidseg_diffusion_tpu.engine import train as jtrain
from vidseg_diffusion_tpu.models import lpips as jlp
from vidseg_diffusion_tpu.models import vae as jvae
from vidseg_diffusion_tpu.ops import attention as jatt
from vidseg_diffusion_tpu_torch.engine import train as ttrain
from vidseg_diffusion_tpu_torch.engine.diffusion_engine import FirstStage
from vidseg_diffusion_tpu_torch.io import convert
from vidseg_diffusion_tpu_torch.models import lpips as tlp
from vidseg_diffusion_tpu_torch.models import vae as tvae
from vidseg_diffusion_tpu_torch.ops import attention as tatt
from vidseg_diffusion_tpu_torch.scripts import autoencoder_train_path as ae_path

T = torch.from_numpy
# fp32 attention gradients: max |port - JAX| <= ATTN_TOL * max |JAX| (same
# math, another summation order); bf16: within two bf16 steps at max |JAX|
# and a relative RMS error of BF16_RMS (the Pallas kernels round p against a
# running max per key block, the plain versions against the row's max)
ATTN_TOL = 1e-5
BF16_RMS = 4e-3
STEP_LOG_TOL = 1e-4   # per-step logs of the two-phase step
# fp32 first-stage parameter gradients of step 1, per parameter: ||port - JAX||
# <= GRAD_TOL * max(||JAX||, GRAD_FLOOR * the largest gradient norm), as
# tests/test_torch_autoencoder.py holds the image VAE's
GRAD_TOL = 2e-4
GRAD_FLOOR = 1e-3
# what step 1 moved each parameter by, port vs JAX, by norm (Adam eps 1e-5 on
# both sides; the mid attention's k bias, whose true gradient is 0, steps on
# rounding noise and is not compared), as tests/test_torch_autoencoder.py
STEP_UPDATE_TOL = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the small CPU shapes gain nothing from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _arrays(seed, *shapes):
    rs = np.random.RandomState(seed)
    return [rs.randn(*s).astype(np.float32) for s in shapes]


def _held(got, want, dt):
    """The attention-gradient bounds above, for each of dq, dk, dv."""
    for a, w in zip(got, want):
        w = np.asarray(w.astype(jnp.float32))
        a = a.float().numpy()
        assert a.shape == w.shape
        if dt == "fp32":
            np.testing.assert_allclose(a, w, atol=ATTN_TOL * np.abs(w).max(), rtol=0)
        else:
            assert np.abs(a - w).max() <= 2 * _bf16_step(np.abs(w).max())
            assert np.linalg.norm(a - w) <= BF16_RMS * np.linalg.norm(w)


_DT = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


# -- the packed backward at one 512-dim head (the VideoAttnBlock's attn2) --------


@pytest.mark.parametrize("lq,dt", [(300, "fp32"), (520, "fp32"), (300, "bf16")])
def test_packed_backward_at_one_512_head_matches_jax_vjp(lq, dt):
    """Autograd through K1's Function at one 512-dim head (the CPU plain path:
    the forward with its LSE and the rounded sum, the packed backward's math)
    against jax.vjp of flash_attention_packed(heads=1, interpret=True), whose
    VJP runs the Pallas packed backward; 300 tokens leave ragged tails of
    JAX's key and query blocks, 520 more than one tile."""
    q, k, v, g = _arrays(lq + 11, *[(1, lq, 512)] * 4)
    jdt, tdt = _DT[dt]
    _, vjp = jax.vjp(lambda *a: jatt.flash_attention_packed(*a, heads=1, interpret=True),
                     *(jnp.asarray(a, jdt) for a in (q, k, v)))
    want = vjp(jnp.asarray(g, jdt))
    leaves = [T(a).to(tdt).requires_grad_() for a in (q, k, v)]
    calls = tatt.flash_attention_packed_backward_reference.calls
    out = tatt.flash_attention_packed(*leaves, heads=1)
    assert type(out.grad_fn).__name__ == "_FlashAttentionPackedBackward"
    got = torch.autograd.grad(out, leaves, T(g).to(tdt))
    assert tatt.flash_attention_packed_backward_reference.calls == calls + 1
    assert all(a.dtype == tdt for a in got)
    _held(got, want, dt)


# -- the temporal backward at D = 512 (the VideoAttnBlock's time mix) -------------


@pytest.mark.parametrize("t,dt", [(7, "fp32"), (14, "fp32"), (7, "bf16"), (33, "fp32")])
def test_temporal_backward_at_512_matches_jax_vjp(t, dt):
    """Autograd through K2's Function at one 512-dim head, t = 7 (the 7-frame
    training clip), 14 (a decode of 14 latents) and 33 (past the 32 frames of
    the card's tiled kernels), against jax.vjp of the
    direct-layout kernel in interpret mode, whose VJP runs the Pallas tiny-seq
    backward on the canonical transposes; [(b t), s, 1, 512] in and out."""
    b, s = 1, 16
    q, k, v, g = _arrays(t + 29, *[(b * t, s, 1, 512)] * 4)
    jdt, tdt = _DT[dt]
    _, vjp = jax.vjp(lambda *a: jatt.temporal_attention_direct(*a, t=t, force=True, interpret=True),
                     *(jnp.asarray(a, jdt) for a in (q, k, v)))
    want = vjp(jnp.asarray(g, jdt))
    leaves = [T(a).to(tdt).requires_grad_() for a in (q, k, v)]
    calls = tatt.temporal_attention_direct_backward_reference.calls
    out = tatt.temporal_attention_direct(*leaves, t=t)
    got = torch.autograd.grad(out, leaves, T(g).to(tdt))
    assert tatt.temporal_attention_direct_backward_reference.calls == calls + 1
    _held(got, want, dt)


def test_the_two_512_backwards_are_admitted():
    """The head-dim table admits the two gradients at one 512-dim head
    (blhd and temporal) and still refuses 512 at two blhd heads."""
    tatt._check_head_dim("site", "blhd", (7, 5824, 1, 512), 512, 1, backward=True)
    tatt._check_head_dim("site", "temporal", (7, 5824, 1, 512), 512, 1, backward=True)
    with pytest.raises(ValueError, match=r"head dim 512 .*\(512,\) at one head only"):
        tatt._check_head_dim("site", "blhd", (7, 5824, 2, 512), 512, 2, backward=True)


# -- the autoencoder step on an Encoder + VideoDecoder ------------------------------

# the smallest first stage whose GroupNorms hold two channels a group (see
# tests/test_torch_autoencoder.py), with the temporal VideoDecoder; one clip of
# FRAMES frames of SIZE^2, so the mid attentions see 64 tokens of a 128-dim head
# and the VideoAttnBlock's time mix FRAMES frames
_VIDEO_AE = dict(ch=64, ch_mult=(1, 2), num_res_blocks=1, video_decoder=True)
FRAMES, SIZE = 3, 16


def _video_first_stage(time_mode, x, z):
    cfg = dict(_VIDEO_AE, time_mode=time_mode)
    je, jd = jvae.Encoder(jvae.VAEConfig(**cfg)), jvae.Decoder(jvae.VAEConfig(**cfg))
    ep = _init_tree(je, 21, jnp.asarray(x))
    dp = _init_tree(jd, 22, jnp.asarray(z), timesteps=FRAMES)
    if "mid_attn_1" in dp and "mix_factor" in dp["mid_attn_1"]:
        dp["mid_attn_1"]["mix_factor"] = np.full_like(dp["mid_attn_1"]["mix_factor"], 0.3)   # both branches weigh in
    te = _load(tvae.Encoder(tvae.VAEConfig(**cfg)), ep, convert.vae_key_fn).train()
    td = _load(tvae.Decoder(tvae.VAEConfig(**cfg)), dp, convert.vae_key_fn).train()
    return je, jd, ep, dp, te, td


@pytest.mark.parametrize("time_mode", ["conv-only", "all", "attn-only"])
def test_video_autoencoder_train_step_matches_jax(time_mode):
    """Two steps of AutoencoderTrainStep on Encoder + VideoDecoder (its
    temporal layers seeing the clip's FRAMES frames: FirstStage.reconstruct)
    against make_autoencoder_train_step with optax.adam (decode_apply closing
    over timesteps), on the posterior noise JAX draws from each step's key:
    every log of both steps at STEP_LOG_TOL; every first-stage parameter's
    step-1 gradient (JAX's: the Adam first moment over 1 - b1) within
    GRAD_TOL by norm with a floor, none missing; what step 1 moved every
    generator and discriminator parameter by within STEP_UPDATE_TOL; the
    VideoDecoder's merges (mix_factor) among the moved. Hinge loss, the
    adversarial term on from step 0, no LPIPS (its near-dead features are
    held by tests/test_torch_autoencoder.py)."""
    rs = np.random.RandomState(23)
    x = rs.uniform(-1, 1, (FRAMES, SIZE, SIZE, 3)).astype(np.float32)
    zshape = (FRAMES, SIZE // 2, SIZE // 2, 4)
    je, jd, ep, dp, te, td = _video_first_stage(time_mode, x, np.zeros(zshape, np.float32))
    assert isinstance(td.mid.attn_1, tvae.VideoAttnBlock) == (time_mode != "conv-only")
    assert isinstance(td.conv_out, tvae.AE3DConv) == (time_mode != "attn-only")
    jdisc = jlp.NLayerDiscriminator(ndf=8, n_layers=2)
    discp = _init_tree(jdisc, 24, jnp.asarray(x))
    tdisc = _load(tlp.NLayerDiscriminator(ndf=8, n_layers=2), discp, convert.module_key_fn).train()
    cfg = dataclasses.replace(jlp.AutoencoderLossConfig(), disc_start=0, kl_weight=1e-2)
    tcfg = dataclasses.replace(tlp.AutoencoderLossConfig(), disc_start=0, kl_weight=1e-2)
    lr, eps, b1 = 1e-4, 1e-5, 0.9
    step = jax.jit(jtrain.make_autoencoder_train_step(
        lambda p, a: je.apply({"params": p["encoder"]}, a),
        lambda p, z: jd.apply({"params": p["decoder"]}, z, timesteps=FRAMES),
        lambda p, a: jdisc.apply({"params": p}, a), None, optax.adam(lr, b1=b1, eps=eps),
        optax.adam(lr, b1=b1, eps=eps), cfg))
    gp = {"encoder": ep, "decoder": dp}
    gopt, dopt = optax.adam(lr, b1=b1, eps=eps).init(gp), optax.adam(lr, b1=b1, eps=eps).init(discp)
    fs = FirstStage(te, td)
    trainer = ttrain.AutoencoderTrainStep(
        fs.moments, fs.reconstruct, tdisc, None, torch.optim.Adam(fs.modules().parameters(), lr=lr, eps=eps),
        torch.optim.Adam(tdisc.parameters(), lr=lr, eps=eps), tcfg)

    def state_dict_of(gen, disc=None):
        sd = {f"{part}.{k}": np.asarray(v) for part in ("encoder", "decoder")
              for k, v in convert.jax_to_state_dict(gen[part], convert.vae_key_fn).items()}
        if disc is not None:
            sd.update({f"disc.{k}": v for k, v in convert.jax_to_state_dict(disc, convert.module_key_fn).items()})
        return sd

    before = state_dict_of(gp, discp)
    for i in range(2):
        rng = jax.random.PRNGKey(40 + i)
        noise = np.asarray(jax.random.normal(rng, zshape))
        gp, discp, gopt, dopt, jlogs = step(gp, discp, gopt, dopt, rng, jnp.asarray(x), jnp.asarray(i))
        tlogs = trainer.step(T(x), i, noise=T(noise.copy()))
        assert tlogs.keys() == jlogs.keys()
        for key in jlogs:
            np.testing.assert_allclose(tlogs[key].numpy(), np.asarray(jlogs[key]), atol=STEP_LOG_TOL,
                                       rtol=STEP_LOG_TOL, err_msg=f"step {i} {key}")
        if i:
            continue
        # step 1's generator gradients: the port's .grad, JAX's from Adam's first moment
        want = {k: v / (1 - b1) for k, v in state_dict_of(gopt[0].mu).items()}
        got = {n: p.grad for n, p in fs.modules().named_parameters()}
        assert got.keys() == want.keys() and all(v is not None for v in got.values())
        floor = GRAD_FLOOR * max(np.linalg.norm(w) for w in want.values())
        for name, w in want.items():
            err = np.linalg.norm(got[name].numpy() - w)
            assert err <= GRAD_TOL * max(np.linalg.norm(w), floor), (name, err, np.linalg.norm(w))
        after = state_dict_of(gp, discp)
        mine = {n: p.detach().numpy() for n, p in fs.modules().named_parameters()}
        mine.update({f"disc.{k}": p.detach().numpy() for k, p in tdisc.named_parameters()})
        assert mine.keys() == after.keys()
        for name, w in after.items():
            if name.endswith("attn_1.k.bias"):
                continue
            d_jax, d_port = w - before[name], mine[name] - before[name]
            err = np.linalg.norm(d_port - d_jax)
            assert err <= STEP_UPDATE_TOL * np.linalg.norm(d_jax), (name, err, np.linalg.norm(d_jax))
        merges = [n for n in mine if n.endswith("mix_factor")]
        assert merges and all(not np.array_equal(mine[n], before[n]) for n in merges)
    assert trainer.step_count == 2


@pytest.mark.parametrize("time_mode", ["conv-only", "all"])
def test_autoencoder_train_path_builds_svd_first_stage(time_mode):
    """scripts/autoencoder_train_path.py with svd.yaml's first stage: the
    config read from the YAML (the VideoDecoder, video_kernel_size (3,1,1), no
    quant convs), and a tiny first stage of that kind built on the CPU taking
    a step on a clip of three frames: finite logs, p_loss > 0, every
    first-stage parameter with a gradient, the decoder's merges moved."""
    cfg = ae_path.svd_vae_config(time_mode)
    assert cfg.video_decoder and cfg.time_mode == time_mode and tuple(cfg.video_kernel_size) == (3, 1, 1)
    assert (cfg.ch, cfg.ch_mult, cfg.num_res_blocks, cfg.z_channels) == (128, (1, 2, 4, 4), 2, 4)
    assert ae_path.SVD_FRAMES == 7
    tiny = dataclasses.replace(cfg, ch=32, ch_mult=(1, 2), num_res_blocks=1, dtype=torch.float32)
    trainer, fs = ae_path.build(device="cpu", vae=tiny)
    assert fs.quant_conv is None and fs.post_quant_conv is None
    before = {n: p.detach().clone() for n, p in fs.modules().named_parameters()}
    x = ae_path.batch(device="cpu", dtype=torch.float32, height=32, width=32, frames=3)
    logs = trainer.step(x, 0, generator=ae_path.noise_generator("cpu"))
    assert all(torch.isfinite(v) for v in logs.values()) and logs["p_loss"] > 0
    assert all(p.grad is not None for p in fs.modules().parameters())
    merges = [n for n in before if n.endswith("mix_factor")]
    assert merges and all(not torch.equal(before[n], p) for n, p in fs.modules().named_parameters()
                          if n in merges)
