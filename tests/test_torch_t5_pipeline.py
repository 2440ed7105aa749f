"""build_pipeline with the T5 and the class conditioner, port against the JAX
package, on the two tiny YAMLs of tests/test_aux_encoders.py (an image UNet,
AutoencoderKL, the T5 embedder with t5_cfg or the ClassEmbedder), written to
a temp dir.

Each JAX pipeline is built once per module (random weights); its UNet, VAE
and conditioning tower move into the port's (io/convert.py). Compared: the
conditioner outputs (1e-5 of max |JAX|), `make_cond` with the default
negative JAX builds (zeros, column 0 the prompt's first id, column 1 its
largest: for T5 ids as for CLIP's; for labels [b, 1] JAX's scatter drops
column 1, so the negative is the label itself and uc equals c), and, for
T5, text_to_image for 4 steps against JAX's SamplingPipeline with JAX's
initial noise handed over (LATENT_RTOL / IMAGE_TOL of test_torch_api.py).
A checkpoint in the reference's layout (with HF's tied embed_tokens) loads
and fixes the tower's architecture from its shapes.
"""

import inspect

import jax
import numpy as np
import pytest
import torch

from vidseg_diffusion_tpu.engine.build import build_pipeline as j_build
from vidseg_diffusion_tpu.inference import api as japi
from vidseg_diffusion_tpu.io.checkpoint import unet_key_fn
from vidseg_diffusion_tpu.models.t5 import byt5_tokenize
from vidseg_diffusion_tpu_torch.engine.build import build_pipeline as t_build
from vidseg_diffusion_tpu_torch.inference import api as tapi
from vidseg_diffusion_tpu_torch.io import convert

LATENT_RTOL = 2e-4
IMAGE_TOL = 2e-4
COND_TOL = 1e-5
SIZE, STEPS = 64, 4

_YAML = """
model:
  target: sgm.models.diffusion.DiffusionEngine
  params:
    scale_factor: 0.18215
    denoiser_config:
      target: sgm.modules.diffusionmodules.denoiser.Denoiser
      params:
        scaling_config:
          target: sgm.modules.diffusionmodules.denoiser_scaling.EpsScaling
    network_config:
      target: sgm.modules.diffusionmodules.openaimodel.UNetModel
      params:
        in_channels: 4
        out_channels: 4
        model_channels: 32
        attention_resolutions: [1]
        num_res_blocks: 1
        channel_mult: [1]
        num_head_channels: 16
        transformer_depth: 1
        context_dim: 16
    first_stage_config:
      target: sgm.models.autoencoder.AutoencoderKL
      params:
        embed_dim: 4
        ddconfig:
          double_z: true
          z_channels: 4
          in_channels: 3
          out_ch: 3
          ch: 16
          ch_mult: [1]
          num_res_blocks: 1
    conditioner_config:
      target: sgm.modules.GeneralConditioner
      params:
        emb_models:
          - is_trainable: False
            input_key: txt
            target: sgm.modules.encoders.modules.{EMB}
            params: {PARAMS}
"""
T5_PARAMS = "{t5_cfg: {vocab_size: 384, d_model: 16, d_kv: 4, num_heads: 4, d_ff: 32, num_layers: 2}}"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _write(tmp, emb, params):
    path = tmp / f"{emb}.yaml"
    path.write_text(_YAML.replace("{EMB}", emb).replace("{PARAMS}", params))
    return str(path)


def _sd(tree, key_fn):
    return {k: torch.tensor(v) for k, v in convert.jax_to_state_dict(jax.tree.map(np.asarray, tree), key_fn).items()}


def _pair(config):
    """(JAX pipeline, port pipeline with the JAX pipeline's weights)."""
    jp = j_build(config)
    tp = t_build(config, device="cpu")
    tp.unet.load_state_dict(_sd(jp.unet_params, unet_key_fn))
    tp.first_stage.encoder.load_state_dict(_sd(jp.first_stage.params_encoder, convert.vae_key_fn))
    tp.first_stage.decoder.load_state_dict(_sd(jp.first_stage.params_decoder, convert.vae_key_fn))
    closure = inspect.getclosurevars(jp.clip_apply).nonlocals
    if tp.kind == "t5_text":
        tp.t5.load_state_dict(_sd(closure["t5_params"], convert.t5_key_fn))
    else:
        tp.class_embedder.load_state_dict(_sd(closure["ce_params"], convert.module_key_fn))
    return jp, tp


@pytest.fixture(scope="module")
def t5(tmp_path_factory):
    return _pair(_write(tmp_path_factory.mktemp("t5"), "FrozenT5Embedder", T5_PARAMS))


@pytest.fixture(scope="module")
def cls(tmp_path_factory):
    return _pair(_write(tmp_path_factory.mktemp("cls"), "ClassEmbedder",
                        "{embed_dim: 16, n_classes: 7, add_sequence_dim: True}"))


def _close(got, want, rtol):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= rtol * max(1.0, float(np.abs(want).max())), err


def _ids(b, l, seed):
    return np.random.RandomState(seed).randint(2, 384, (b, l)).astype(np.int32)


def test_t5_pipeline_builds_and_conditions_as_jax(t5):
    jp, tp = t5
    assert jp.conditioner.kind == tp.kind == "t5_text"
    assert tp.spec.t5_config.d_model == 16 and tp.spec.t5_config.num_layers == 2
    for ids in (np.asarray(byt5_tokenize(["a", "bb"], 9)), _ids(3, 77, 0)):
        want = jp.conditioner({"txt_t5_tokens": ids})
        got = tp.conditioner({"txt_t5_tokens": torch.tensor(ids)})
        assert got.keys() == want.keys() == {"crossattn"}
        assert tuple(got["crossattn"].shape) == (ids.shape[0], ids.shape[1], 16)
        _close(got["crossattn"], want["crossattn"], COND_TOL)
        _close(tp.clip_apply(ids), jp.clip_apply(ids), COND_TOL)


def test_class_pipeline_builds_and_conditions_as_jax(cls):
    jp, tp = cls
    assert jp.conditioner.kind == tp.kind == "class"
    labels = np.array([0, 6, 3], np.int32)
    want = jp.conditioner({"cls": labels})
    got = tp.conditioner({"cls": torch.from_numpy(labels)})
    assert got.keys() == want.keys() == {"crossattn"} and tuple(got["crossattn"].shape) == (3, 1, 16)
    np.testing.assert_array_equal(got["crossattn"].numpy(), np.asarray(want["crossattn"]))
    uc = tp.class_embedder.get_unconditional_class(3)
    assert uc.tolist() == [6, 6, 6]


@pytest.mark.parametrize("negative", [False, True])
def test_t5_make_cond_matches_jax(t5, negative):
    """c / uc of the CFG pair on T5 ids; the default negative is the CLIP
    convention JAX applies to T5 ids too: [first id, largest id, 0, ...]."""
    jp, tp = t5
    ids = _ids(1, 12, 1)
    neg = _ids(1, 12, 2) if negative else None
    jc, juc = japi.SamplingPipeline(jp)._make_cond(japi.SamplingParams(), ids, neg, 2)
    tc, tuc = tapi.SamplingPipeline(tp).make_cond(tapi.SamplingParams(), ids, neg, 2)
    for w, g in ((jc, tc), (juc, tuc)):
        assert w.keys() == g.keys() == {"crossattn"}
        _close(g["crossattn"], w["crossattn"], COND_TOL)
    if not negative:
        framed = np.zeros_like(ids)
        framed[:, 0], framed[:, 1] = ids[:, 0], ids.max(axis=1)
        _close(tuc["crossattn"][:1], tp.clip_apply(framed), 0.0)


def test_class_make_cond_default_negative_is_the_label(tmp_path):
    """Labels [b, 1] with add_sequence_dim False (crossattn [b, 1, 16]): JAX
    sets the negative's column 1, which does not exist, and the scatter drops
    it, so uc is the label's own embedding; the port mirrors it. 1-D labels
    raise IndexError in both."""
    jp, tp = _pair(_write(tmp_path, "ClassEmbedder", "{embed_dim: 16, n_classes: 7, add_sequence_dim: False}"))
    labels = np.array([[4]], np.int32)
    jc, juc = japi.SamplingPipeline(jp)._make_cond(japi.SamplingParams(), labels, None, 2)
    tc, tuc = tapi.SamplingPipeline(tp).make_cond(tapi.SamplingParams(), labels, None, 2)
    np.testing.assert_array_equal(tc["crossattn"].numpy(), np.asarray(jc["crossattn"]))
    np.testing.assert_array_equal(tuc["crossattn"].numpy(), np.asarray(juc["crossattn"]))
    np.testing.assert_array_equal(tuc["crossattn"].numpy(), tc["crossattn"].numpy())
    with pytest.raises(IndexError):
        japi.SamplingPipeline(jp)._make_cond(japi.SamplingParams(), labels[:, 0], None, 1)
    with pytest.raises(IndexError):
        tapi.SamplingPipeline(tp).make_cond(tapi.SamplingParams(), labels[:, 0], None, 1)


def test_t5_text_to_image_matches_jax(t5):
    """text_to_image, 4 Euler steps, CFG 5, on T5 ids with the default
    negative: JAX's initial noise (its first key's draw) handed over."""
    jp, tp = t5
    ids = _ids(1, 12, 3)
    rng = jax.random.PRNGKey(21)
    r_init, _ = jax.random.split(rng)
    noise = np.array(jax.random.normal(r_init, (1, SIZE // 8, SIZE // 8, 4)))
    jframes, jz = japi.SamplingPipeline(jp).text_to_image(japi.SamplingParams(width=SIZE, height=SIZE, steps=STEPS),
                                                          ids, rng=rng, return_latents=True)
    tframes, tz = tapi.SamplingPipeline(tp).text_to_image(tapi.SamplingParams(width=SIZE, height=SIZE, steps=STEPS),
                                                          ids, noise=torch.from_numpy(noise), return_latents=True)
    _close(tz, jz, LATENT_RTOL)
    _close(tframes, jframes, IMAGE_TOL)
    assert float(np.abs(np.asarray(jz)).max()) > 0.1


def test_t5_checkpoint_loads_with_its_architecture(t5, tmp_path):
    """A reference-layout checkpoint: model.diffusion_model.*, first_stage_model.*,
    conditioner.embedders.0.transformer.* with HF's tied
    encoder.embed_tokens.weight; the tower's shape comes from it (3 layers,
    where the YAML's t5_cfg says 2), and every weight lands."""
    _, tp = t5
    t5_sd = {k: v.clone() for k, v in tp.t5.state_dict().items()}
    t5_sd["encoder.block.2.layer.0.SelfAttention.q.weight"] = t5_sd["encoder.block.1.layer.0.SelfAttention.q.weight"]
    for k in list(t5_sd):
        if k.startswith("encoder.block.1."):
            t5_sd[k.replace("block.1.", "block.2.")] = t5_sd[k] * 0.5
    t5_sd["encoder.embed_tokens.weight"] = t5_sd["shared.weight"]
    sd = {f"conditioner.embedders.0.transformer.{k}": v for k, v in t5_sd.items()}
    sd.update({f"model.diffusion_model.{k}": v for k, v in tp.unet.state_dict().items()})
    sd.update({f"first_stage_model.encoder.{k}": v for k, v in tp.first_stage.encoder.state_dict().items()})
    sd.update({f"first_stage_model.decoder.{k}": v for k, v in tp.first_stage.decoder.state_dict().items()})
    path = str(tmp_path / "t5.ckpt")
    torch.save({"state_dict": sd}, path)
    loaded = t_build(_write(tmp_path, "FrozenT5Embedder", T5_PARAMS), ckpt_path=path, device="cpu")
    assert loaded.spec.t5_config.num_layers == 3 and len(loaded.t5.encoder.block) == 3
    for k, v in loaded.t5.state_dict().items():
        torch.testing.assert_close(v, t5_sd[k], rtol=0, atol=0)
