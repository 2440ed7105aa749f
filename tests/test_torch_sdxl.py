"""The SDXL modules of the port against the JAX package's, on the CPU in fp32.

Weights come from the JAX module's parameter shapes (jax.eval_shape) filled by
numpy and move into the port with io/convert.py (load_state_dict strict), and
back through the JAX package's convert_state_dict: the sd_xl_tiny UNet with
its per-level transformer depth and class embedding, the quick-GELU CLIP-L
tower under HF CLIPTextModel's keys, the pooled bigG tower (argmax-token
pooling, text_projection), the OpenCLIP tower at layer 'last', and the SDXL
base / refiner conditioners (several outputs per embedder, a separate uc
batch, force-zero keys). Modules 1e-4, the UNet 2e-4 (tests/test_torch_models.py).
Also: every YAML of configs/inference/ through both loaders, and the
full-width stacks' structure (their modules built on the meta device) against the
JAX package's parameter shapes.
"""

import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_models import MODULE_TOL, UNET_TOL, _apply, _close, _init_tree, _load, _round_trip
from vidseg_diffusion_tpu import config as jconfig
from vidseg_diffusion_tpu.io.checkpoint import unet_key_fn as j_unet_key_fn
from vidseg_diffusion_tpu.models import clip as jclip
from vidseg_diffusion_tpu.models import conditioner as jcond
from vidseg_diffusion_tpu.models import unet as junet
from vidseg_diffusion_tpu_torch import config as tconfig
from vidseg_diffusion_tpu_torch.engine import build as tbuild
from vidseg_diffusion_tpu_torch.engine.build import build_pipeline
from vidseg_diffusion_tpu_torch.io import convert
from vidseg_diffusion_tpu_torch.io.tokenizer import TINY_VOCAB, tokenize, tokenize_empty
from vidseg_diffusion_tpu_torch.models import clip as tclip
from vidseg_diffusion_tpu_torch.models import conditioner as tcond
from vidseg_diffusion_tpu_torch.models import unet as tunet

CONFIGS = sorted(glob.glob("configs/inference/*.yaml"))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tokens():
    """Tiny-vocabulary prompts (EOT, their largest id, at different places)
    and the empty prompt."""
    return np.concatenate([tokenize(["a photo of a cat", "dog"], bpe_path=TINY_VOCAB), tokenize_empty(1)])


@pytest.mark.parametrize("with_regex", [True, False], ids=["regex", "re"])
def test_bpe_tokenizer_matches_jax(monkeypatch, with_regex):
    """The port's copy of the BPE encoder against the JAX package's on the
    tiny vocabulary: letters, digits, punctuation, underscores, special
    tokens, HTML entities, an over-long prompt (EOT forced last), the empty
    prompt. With only the standard library's `re` ("re": `regex` not
    importable) both encoders refuse to build, as the pattern's \\p{L} /
    \\p{N} classes need `regex`, and the empty prompt still needs no
    vocabulary."""
    import builtins

    from vidseg_diffusion_tpu.io import tokenizer as jtok
    from vidseg_diffusion_tpu_torch.io import tokenizer as ttok

    prompts = ["a photo of a cat", "Dog, photo!! 12 cat_dog", "  <start_of_text>to  &amp; of  ", "photo " * 60, ""]
    want = jtok.tokenize(prompts, bpe_path=TINY_VOCAB)
    if with_regex:
        np.testing.assert_array_equal(ttok.ClipBPETokenizer(TINY_VOCAB)(prompts), want)
    else:
        real_import = builtins.__import__
        monkeypatch.setattr(builtins, "__import__", lambda name, *a, **kw: (_ for _ in ()).throw(ImportError(name))
                            if name == "regex" else real_import(name, *a, **kw))
        for encoder in (ttok.ClipBPETokenizer, jtok.ClipBPETokenizer):
            with pytest.raises(ImportError, match="regex"):
                encoder(TINY_VOCAB)
    assert ttok.tokenize([""]).tolist() == jtok.tokenize_empty(1).tolist()
    with pytest.raises(ValueError, match="BPE"):
        monkeypatch.delenv("VIDSEG_BPE_PATH", raising=False)
        monkeypatch.setattr(ttok, "default_bpe_path", lambda: None)
        ttok.tokenize(["a cat"])


def test_sdxl_tiny_unet_per_level_depth():
    """sd_xl_tiny.yaml's UNet (depths [1, 2]: the middle block takes the last
    level's; adm 144): two transformer blocks at every level-1 site and in the
    middle block (level 0 has no attention), the class
    embedding, the output against JAX's."""
    jcfg = jconfig.load_model_spec("configs/inference/sd_xl_tiny.yaml").unet_config
    tcfg = tconfig.load_model_spec("configs/inference/sd_xl_tiny.yaml").unet_config
    assert tcfg.transformer_depth == jcfg.transformer_depth == (1, 2)
    rs = np.random.RandomState(0)
    x = rs.randn(2, 16, 16, 4).astype(np.float32)
    t = np.array([3.0, 700.0], np.float32)
    ctx = rs.randn(2, 77, 80).astype(np.float32)
    y = rs.randn(2, 144).astype(np.float32)
    jm = junet.UNetModel(jcfg)
    params = _init_tree(jm, 1, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx), jnp.asarray(y))
    want = _apply(jm, params, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx), jnp.asarray(y))
    tm = _load(tunet.UNetModel(tcfg), params, convert.unet_key_fn)
    depths = [len(m[1].transformer_blocks) for m in list(tm.input_blocks) + list(tm.output_blocks) if len(m) > 1
              and hasattr(m[1], "transformer_blocks")]
    assert depths == [2, 2, 2] and len(tm.middle_block[1].transformer_blocks) == 2   # level 1: one in, two out
    assert tm.label_emb[0][0].in_features == 144
    with torch.no_grad():
        got = tm(*(torch.from_numpy(a) for a in (x, t, ctx, y)))
    _close(got, want, UNET_TOL)
    _round_trip(params, tm, j_unet_key_fn)


def test_hf_clip_l_tower_quick_gelu():
    """The SDXL CLIP-L tower (FrozenCLIPEmbedder, layer 'hidden'): JAX's
    quick-GELU tower with penultimate and no final LayerNorm, against the
    port's HFCLIPTextTransformer under HF's key names."""
    cfg = dict(width=32, heads=2, layers=3)
    jm = jclip.CLIPTextTransformer(jclip.CLIPTextConfig(act="quick_gelu", **cfg), penultimate=True, final_ln=False)
    params = _init_tree(jm, 2, jnp.zeros((1, 77), jnp.int32))
    tokens = _tokens()
    want = _apply(jm, params, jnp.asarray(tokens))
    tm = _load(tclip.HFCLIPTextTransformer(tclip.CLIPTextConfig(act="quick_gelu", **cfg), layer_idx=2), params,
               convert.hf_clip_text_key_fn)
    assert "text_model.encoder.layers.1.self_attn.out_proj.weight" in tm.state_dict()
    with torch.no_grad():
        got = tm(torch.from_numpy(tokens))
    _close(got, want, MODULE_TOL)
    _round_trip(params, tm, jclip.hf_clip_text_key_fn)


def test_bigg_tower_pooled():
    """The SDXL bigG tower (FrozenOpenCLIPEmbedder2): every block runs; the
    hidden states are the penultimate block's output without ln_final, the
    pooled output ln_final(last) at the argmax token times text_projection
    (24-dim heads, as sd_xl_tiny's)."""
    cfg = dict(width=48, heads=2, layers=3)
    jm = jclip.CLIPTextTransformer(jclip.CLIPTextConfig(**cfg), penultimate=True, final_ln=False,
                                   return_pooled=True)
    params = _init_tree(jm, 3, jnp.zeros((1, 77), jnp.int32))
    tokens = _tokens()
    want_h, want_p = _apply(jm, params, jnp.asarray(tokens))
    tm = _load(tclip.CLIPTextTransformer(tclip.CLIPTextConfig(**cfg), return_pooled=True), params,
               convert.clip_text_key_fn)
    with torch.no_grad():
        got_h, got_p = tm(torch.from_numpy(tokens))
    assert tuple(got_h.shape) == (3, 77, 48) and tuple(got_p.shape) == (3, 48)
    _close(got_h, want_h, MODULE_TOL)
    _close(got_p, want_p, MODULE_TOL)
    _round_trip(params, tm, jclip.clip_text_key_fn)


def test_openclip_text_tower_layer_last():
    """FrozenOpenCLIPEmbedder at layer 'last': every block, then ln_final
    (JAX's tower with penultimate False)."""
    cfg = dict(width=32, heads=4, layers=2)
    jm = jclip.CLIPTextTransformer(jclip.CLIPTextConfig(**cfg), penultimate=False)
    params = _init_tree(jm, 4, jnp.zeros((1, 77), jnp.int32))
    tokens = _tokens()
    want = _apply(jm, params, jnp.asarray(tokens))
    tm = _load(tclip.CLIPTextTransformer(tclip.CLIPTextConfig(**cfg), penultimate=False), params,
               convert.clip_text_key_fn)
    assert len(tm.transformer.resblocks) == 2
    with torch.no_grad():
        _close(tm(torch.from_numpy(tokens)), want, MODULE_TOL)


@pytest.fixture(scope="module")
def towers():
    """(JAX tower fns, port towers): a CLIP-L (32 wide) and a bigG (48 wide)
    on the same numpy weights."""
    lcfg, gcfg = dict(width=32, heads=2, layers=2), dict(width=48, heads=2, layers=2)
    jl = jclip.CLIPTextTransformer(jclip.CLIPTextConfig(act="quick_gelu", **lcfg), penultimate=True,
                                   final_ln=False)
    jg = jclip.CLIPTextTransformer(jclip.CLIPTextConfig(**gcfg), penultimate=True, final_ln=False,
                                   return_pooled=True)
    lp, gp = _init_tree(jl, 5, jnp.zeros((1, 77), jnp.int32)), _init_tree(jg, 6, jnp.zeros((1, 77), jnp.int32))
    tl = _load(tclip.HFCLIPTextTransformer(tclip.CLIPTextConfig(act="quick_gelu", **lcfg), 1), lp,
               convert.hf_clip_text_key_fn)
    tg = _load(tclip.CLIPTextTransformer(tclip.CLIPTextConfig(**gcfg), return_pooled=True), gp,
               convert.clip_text_key_fn)
    lp, gp = jax.tree.map(jnp.asarray, lp), jax.tree.map(jnp.asarray, gp)
    jl_fn = jax.jit(lambda t: jl.apply({"params": lp}, t))
    jg_fn = jax.jit(lambda t: jg.apply({"params": gp}, t))
    return (jl_fn, jg_fn), (tl, tg)


def _batches(refiner, pair):
    tok = tokenize(["a photo of a cat"], bpe_path=TINY_VOCAB)
    neg = tokenize(["dog"], bpe_path=TINY_VOCAB)
    c = {"txt_tokens": tok, "original_size_as_tuple": np.array([[64.0, 48.0]], np.float32),
         "crop_coords_top_left": np.array([[0.0, 8.0]], np.float32)}
    if refiner:
        c["aesthetic_score"] = np.array([[6.0]], np.float32)
        uc = dict(c, aesthetic_score=np.array([[2.5]], np.float32))
    else:
        c["target_size_as_tuple"] = np.array([[64.0, 64.0]], np.float32)
        uc = dict(c)
    uc["txt_tokens"] = neg
    conv = (lambda d: {k: jnp.asarray(v) for k, v in d.items()}) if pair == "jax" else (
        lambda d: {k: torch.from_numpy(v) for k, v in d.items()})
    bc = conv(c)
    buc = {k: (bc[k] if uc[k] is c[k] else v) for k, v in conv(uc).items()}   # shared values stay shared
    return bc, buc


@pytest.mark.parametrize("refiner", [False, True], ids=["base", "refiner"])
def test_sdxl_conditioners_match_jax(towers, refiner):
    """c and uc of the SDXL base (uc's text outputs zeroed: hidden and pooled)
    and refiner (a negative prompt and aesthetic score, nothing zeroed) with
    size_outdim 16; each tower runs once where uc zeroes its output, twice
    where uc reads the negative prompt; force_cond_zero_embeddings zeroes c."""
    (jl_fn, jg_fn), (tl, tg) = towers
    runs = []
    count = lambda name, m: (lambda t: runs.append(name) or m(t))
    if refiner:
        jc = jcond.build_sdxl_refiner_conditioner(jg_fn, size_outdim=16)
        tc = tcond.build_sdxl_refiner_conditioner(count("g", tg), size_outdim=16)
        widths = {"crossattn": 48, "vector": 48 + 32 + 32 + 16}
    else:
        jc = jcond.build_sdxl_conditioner(jl_fn, jg_fn, size_outdim=16)
        tc = tcond.build_sdxl_conditioner(count("l", tl), count("g", tg), size_outdim=16)
        widths = {"crossattn": 32 + 48, "vector": 48 + 3 * 32}
    zero = [] if refiner else ["txt_tokens"]
    jb, jbu = _batches(refiner, "jax")
    tb, tbu = _batches(refiner, "torch")
    want = jc.get_unconditional_conditioning(jb, jbu, force_uc_zero_embeddings=zero)
    with torch.no_grad():
        got = tc.get_unconditional_conditioning(tb, tbu, force_uc_zero_embeddings=zero)
    assert sorted(runs) == (["g", "g"] if refiner else ["g", "l"])
    for w, g in zip(want, got):
        assert w.keys() == g.keys() == {"crossattn", "vector"}
        for key in w:
            assert g[key].shape[-1] == widths[key]
            _close(g[key], w[key], MODULE_TOL)
    uc = got[1]
    assert (uc["crossattn"].abs().max() == 0) != refiner
    assert (uc["vector"][:, :48].abs().max() == 0) != refiner   # the pooled segment
    with torch.no_grad():
        c0, _ = tc.get_unconditional_conditioning(tb, tbu, force_cond_zero_embeddings=["crop_coords_top_left"])
    wc0, _ = jc.get_unconditional_conditioning(jb, jbu, force_cond_zero_embeddings=["crop_coords_top_left"])
    _close(c0["vector"], wc0["vector"], MODULE_TOL)


def _sampler_fields(s):
    if s is None:
        return None
    keys = ("num_steps", "s_churn", "s_tmin", "s_tmax", "s_noise")
    return (type(s).__name__, type(s.discretization).__name__) + tuple(getattr(s, k) for k in keys)


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_every_inference_yaml_parses_as_jax_parses_it(path):
    """The network, first stage, denoiser, sampler and guider of every YAML in
    configs/inference/ as JAX's load_model_spec reads them (mirroring
    TestVendoredConfigs); the conditioner's kind as JAX's build picks it."""
    j = jconfig.load_model_spec(path, num_frames=14)
    t = tconfig.load_model_spec(path, num_frames=14)
    ju, tu = j.unet_config, t.unet_config
    for f in ("in_channels", "out_channels", "model_channels", "num_res_blocks", "attention_resolutions",
              "channel_mult", "num_head_channels", "transformer_depth", "context_dim", "adm_in_channels", "video",
              "merge_strategy", "merge_factor", "video_kernel_size", "remat"):
        assert getattr(tu, f) == getattr(ju, f), f
    for f in ("ch", "out_ch", "in_channels", "z_channels", "ch_mult", "num_res_blocks", "double_z",
              "video_decoder", "video_kernel_size"):
        assert getattr(t.vae_config, f) == getattr(j.vae_config, f), f
    assert type(t.denoiser).__name__ == type(j.denoiser).__name__
    assert type(t.denoiser.scaling).__name__ == type(j.denoiser.scaling).__name__
    assert _sampler_fields(t.sampler) == _sampler_fields(j.sampler)
    assert type(t.guider).__name__ == type(j.guider).__name__
    assert getattr(t.guider, "scale", None) == getattr(j.guider, "scale", None)
    assert t.scale_factor == j.scale_factor
    targets = [e["target"].rsplit(".", 1)[-1] for e in j.conditioner_node["params"]["emb_models"]]
    kind = ("svd" if "FrozenOpenCLIPImagePredictionEmbedder" in targets else
            ("sdxl" if "FrozenCLIPEmbedder" in targets else "sdxl_refiner") if "FrozenOpenCLIPEmbedder2" in targets
            else "sd_text")
    assert t.kind == kind


def test_other_sampler_and_guider_targets():
    """Every sampler, discretization, guider and scaling target the port
    ports, from a YAML node (sd_xl_refiner's written with each in turn)."""
    import yaml

    from vidseg_diffusion_tpu_torch.diffusion import guidance, sampling, sampling_extra, scaling

    with open("configs/inference/sd_xl_refiner_tiny.yaml") as f:
        root = yaml.safe_load(f)
    node = root["model"]["params"]["sampler_config"]
    for name in tconfig.SAMPLERS:
        node["target"] = "sgm.modules.diffusionmodules.sampling." + name
        node["params"].update(eta=0.5, order=3)
        s = tconfig._sampler(node, None)
        assert type(s).__name__ == name and s.num_steps == 6
        assert getattr(s, "eta", 0.5) == 0.5 and getattr(s, "order", 3) == 3
    assert isinstance(tconfig._guider(None, None), guidance.IdentityGuider)
    assert tconfig._guider({"target": "x.LinearPredictionGuider", "params": {"max_scale": 2.5}}, 7).num_frames == 7
    for name, cls in tconfig.SCALINGS.items():
        assert getattr(scaling, name) is cls
    assert tconfig.SAMPLERS["DPMPP2MSampler"] is sampling_extra.DPMPP2MSampler
    assert tconfig.SAMPLERS["HeunEDMSampler"] is sampling.HeunEDMSampler
    node["target"] = "sgm.X.UnknownSampler"
    with pytest.raises(NotImplementedError):
        tconfig._sampler(node, None)


@pytest.mark.parametrize("scaling", ["EDMScaling", "VScaling"])
def test_scalings_match_jax(scaling):
    from vidseg_diffusion_tpu.diffusion import scaling as js
    from vidseg_diffusion_tpu_torch.diffusion import scaling as ts

    sigma = np.array([0.03, 0.5, 3.0, 80.0], np.float32)
    for w, g in zip(getattr(js, scaling)()(jnp.asarray(sigma)), getattr(ts, scaling)()(torch.from_numpy(sigma))):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)


def _torch_shapes(tree, key_fn):
    """{state-dict key: torch shape} of a flax shape tree."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        names = tuple(p.key for p in path)
        s = tuple(leaf.shape)
        if names[-1] == "kernel":   # io/convert.py's to_torch_layout
            s = s[::-1] if len(s) == 2 else (s[-1], s[-2]) + s[:-2]
        out[key_fn(names)] = s
    return out


@pytest.mark.parametrize("name", ["sd_xl_base", "sd_xl_refiner", "sd_2_1_768"])
def test_full_width_stack_structure(name):
    """The full-width stack's modules, built on the meta device (no weights,
    no memory) as build_pipeline builds them: the UNet's keys and shapes are
    the JAX package's parameter tree's (jax.eval_shape of the full-width
    init), and the text towers hold the keys a checkpoint carries for what
    they run."""
    path = f"configs/inference/{name}.yaml"
    tspec = tconfig.load_model_spec(path)
    with torch.device("meta"):
        unet = tunet.UNetModel(tspec.unet_config)
        towers = {field: module for field, (module, _) in tbuild._towers(tspec).items()}
    spec = jconfig.load_model_spec(path)
    cfg = spec.unet_config
    args = [jnp.zeros((2, 16, 16, 4)), jnp.zeros((2,)), jnp.zeros((2, 1, cfg.context_dim))]
    if cfg.adm_in_channels:
        args.append(jnp.zeros((2, cfg.adm_in_channels)))
    shapes = jax.eval_shape(lambda: junet.UNetModel(cfg).init(jax.random.PRNGKey(0), *args))["params"]
    want = _torch_shapes(shapes, j_unet_key_fn)
    got = {k: tuple(v.shape) for k, v in unet.state_dict().items()}
    assert got == want
    assert tspec.kind == {"sd_xl_base": "sdxl", "sd_xl_refiner": "sdxl_refiner", "sd_2_1_768": "sd_text"}[name]
    if tspec.kind == "sdxl":
        text_l, text_g = towers["text_l"], towers["text_g"]
        assert len(text_l.text_model.encoder.layers) == 11 and text_l.config.act == "quick_gelu"
        assert len(text_g.transformer.resblocks) == 32 and tuple(text_g.text_projection.shape) == (1280, 1280)
    if tspec.kind == "sdxl_refiner":
        assert set(towers) == {"text_g"} and towers["text_g"].config.width == 1280


def test_build_pipeline_loads_an_sdxl_checkpoint(tmp_path):
    """A checkpoint with the reference's SDXL key names loads into the tiny
    SDXL stack: HF CLIP-L under conditioner.embedders.0.transformer (with a
    layer past layer_idx, the final LayerNorm and position_ids, left unused),
    bigG under conditioner.embedders.1.model with open_clip's packed in_proj."""
    src = build_pipeline("configs/inference/sd_xl_tiny.yaml", device="cpu", seed=3)
    sd = {}
    for prefix, module in (("model.diffusion_model.", src.unet),
                           ("first_stage_model.encoder.", src.first_stage.encoder),
                           ("first_stage_model.decoder.", src.first_stage.decoder)):
        sd.update({prefix + k: v for k, v in module.state_dict().items()})
    lsd = dict(src.text_l.state_dict())
    n = len(src.text_l.text_model.encoder.layers)
    for k in [k for k in lsd if k.startswith(f"text_model.encoder.layers.{n - 1}.")]:
        lsd[k.replace(f"layers.{n - 1}.", f"layers.{n}.")] = lsd[k].clone()
    lsd["text_model.final_layer_norm.weight"] = torch.ones(32)
    lsd["text_model.embeddings.position_ids"] = torch.arange(77)[None]
    sd.update({"conditioner.embedders.0.transformer." + k: v for k, v in lsd.items()})
    gsd = dict(src.text_g.state_dict())
    for i in range(len(src.text_g.transformer.resblocks)):
        base = f"transformer.resblocks.{i}.attn."
        for leaf in ("weight", "bias"):
            gsd[base + "in_proj_" + leaf] = torch.cat([gsd.pop(f"{base}{q}.{leaf}") for q in "qkv"])
            gsd[f"{base}out_proj.{leaf}"] = gsd.pop(f"{base}out.{leaf}")
    sd.update({"conditioner.embedders.1.model." + k: v for k, v in gsd.items()})
    path = tmp_path / "sdxl.ckpt"
    torch.save({"state_dict": sd}, path)
    dst = build_pipeline("configs/inference/sd_xl_tiny.yaml", ckpt_path=str(path), device="cpu")
    for a, b in ((src.unet, dst.unet), (src.text_l, dst.text_l), (src.text_g, dst.text_g),
                 (src.first_stage.decoder, dst.first_stage.decoder)):
        sa, sb = a.state_dict(), b.state_dict()
        assert sa.keys() == sb.keys() and all(torch.equal(sa[k], sb[k]) for k in sa)
