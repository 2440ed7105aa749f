"""The port's T5 / ByT5 tower (vidseg_diffusion_tpu_torch/models/t5.py)
against the JAX package's models/t5.py on the same weights and ids.

Weights: numpy draws (seeded) in the shapes of JAX's param tree
(`jax.eval_shape` of init; matrices N(0, 1 / rows), scales 1 + N(0, 0.04)),
moved into the port by io/convert.py's t5_key_fn. Tolerances: fp32 within
1e-5 of max |JAX| (two layers of matmuls); bf16 within 2 bf16 steps at max
|JAX| (reads 0: the port rounds where XLA rounds, gelu_new op by op and each
RMSNorm on the residual sum before its rounding). relative_position_bucket
bit for bit over relative positions -512 ... 512.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vidseg_diffusion_tpu.io.checkpoint import convert_state_dict
from vidseg_diffusion_tpu.models import t5 as jt5
from vidseg_diffusion_tpu_torch.io import convert
from vidseg_diffusion_tpu_torch.models import t5 as tt5

FP32_RTOL = 1e-5
BF16_STEPS = 2
TOKENS = np.array(jt5.byt5_tokenize(["a swan swims", "x"], max_length=13))
DTYPES = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _cfg(ff: str, dtype=jnp.float32, **kw):
    base = dict(vocab_size=384, d_model=32, d_kv=8, num_heads=4, d_ff=64, num_layers=2,
                relative_attention_num_buckets=32, relative_attention_max_distance=128, feed_forward_proj=ff)
    base.update(kw)
    return jt5.T5Config(dtype=dtype, **base)


def _params(cfg, seed=0):
    shapes = jax.eval_shape(lambda: jt5.T5Encoder(cfg).init(jax.random.PRNGKey(0), jnp.zeros((1, 13), jnp.int32)))
    rng = np.random.RandomState(seed)

    def draw(s):
        if len(s.shape) == 1:
            return (1.0 + 0.2 * rng.randn(*s.shape)).astype(np.float32)
        return (rng.randn(*s.shape) / np.sqrt(s.shape[0])).astype(np.float32)

    return jax.tree.map(draw, shapes["params"])


def _port(cfg, params, dtype):
    fields = {k: getattr(cfg, k) for k in tt5.T5Config.__dataclass_fields__ if k != "dtype"}
    model = tt5.T5Encoder(tt5.T5Config(dtype=dtype, **fields))
    sd = convert.jax_to_state_dict(params, convert.t5_key_fn)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    return model.to(dtype)


def _jax(cfg, params, tokens):
    cast = jax.tree.map(lambda p: jnp.asarray(p, cfg.dtype), params)
    return np.asarray(jax.jit(lambda p, t: jt5.T5Encoder(cfg).apply({"params": p}, t))(cast, jnp.asarray(tokens)),
                      np.float32)


def _bf16_steps(got, want):
    """max |got - want| in units of the bf16 spacing at max |want|."""
    return float(np.abs(got - want).max() / 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7))


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("ff", ["gated-gelu", "relu"])
def test_t5_tower_matches_jax(ff, dtype):
    jdt, tdt = DTYPES[dtype]
    cfg = _cfg(ff, jdt)
    params = _params(cfg)
    want = _jax(cfg, params, TOKENS)
    with torch.no_grad():
        got = _port(cfg, params, tdt)(torch.from_numpy(TOKENS)).float().numpy()
    assert got.shape == want.shape == (2, 13, 32)
    if dtype == "fp32":
        err = float(np.abs(got - want).max())
        assert err <= FP32_RTOL * float(np.abs(want).max()), err
    else:
        assert _bf16_steps(got, want) <= BF16_STEPS


@pytest.mark.parametrize("num_buckets,max_distance", [(32, 128), (8, 20)])
def test_relative_position_bucket_bit_equal(num_buckets, max_distance):
    rel = np.arange(-512, 513, dtype=np.int32)
    want = np.asarray(jt5.relative_position_bucket(jnp.asarray(rel), num_buckets, max_distance))
    got = tt5.relative_position_bucket(torch.from_numpy(rel), num_buckets, max_distance).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("ff", ["gated-gelu", "relu"])
def test_key_map_round_trip_and_config_from_state_dict(ff):
    """The port's keys are JAX's t5_key_fn's for every path; the JAX package's
    convert_state_dict gives the tree back from the port's state dict; both
    packages read the same T5Config from it (max_distance is not in the
    shapes: 128 in both)."""
    cfg = _cfg(ff, relative_attention_num_buckets=8)
    params = _params(cfg, seed=1)
    sd = convert.jax_to_state_dict(params, convert.t5_key_fn)
    model = tt5.T5Encoder(tt5.T5Config(**{k: getattr(cfg, k) for k in tt5.T5Config.__dataclass_fields__
                                          if k != "dtype"}))
    assert set(sd) == set(model.state_dict())
    paths = jax.tree_util.tree_flatten_with_path(params)[0]
    for path, _ in paths:
        keys = tuple(p.key for p in path)
        assert convert.t5_key_fn(keys) == jt5.t5_key_fn(keys)
    back, unused = convert_state_dict(jax.tree.map(np.zeros_like, params), sd, jt5.t5_key_fn)
    assert not unused
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(np.asarray(a), b)
    jcfg, tcfg = jt5.t5_config_from_state_dict(sd), tt5.t5_config_from_state_dict(sd)
    fields = [f for f in tt5.T5Config.__dataclass_fields__ if f != "dtype"]
    assert {f: getattr(tcfg, f) for f in fields} == {f: getattr(jcfg, f) for f in fields}
    assert tcfg.feed_forward_proj == ff and tcfg.num_layers == 2 and tcfg.relative_attention_num_buckets == 8


def test_state_dict_with_tied_embed_tokens_loads():
    """HF's T5EncoderModel state dict also carries encoder.embed_tokens.weight
    (tied to shared.weight): it loads, and the tower gives what it gives
    without it."""
    cfg = _cfg("gated-gelu")
    params = _params(cfg, seed=2)
    sd = {k: torch.from_numpy(v) for k, v in convert.jax_to_state_dict(params, convert.t5_key_fn).items()}
    tied = dict(sd, **{"encoder.embed_tokens.weight": sd["shared.weight"]})
    a = _port(cfg, params, torch.float32)
    b = tt5.T5Encoder(a.config)
    b.load_state_dict(tied)
    with torch.no_grad():
        torch.testing.assert_close(b(torch.from_numpy(TOKENS)), a(torch.from_numpy(TOKENS)), rtol=0, atol=0)


@pytest.mark.parametrize("texts,max_length", [(["a swan swims", "x", ""], 13), ("héllo wörld ✓", 77),
                                              (["long " * 30], 16)])
def test_byt5_tokenize_equal(texts, max_length):
    want = np.asarray(jt5.byt5_tokenize(texts, max_length=max_length))
    got = tt5.byt5_tokenize(texts, max_length=max_length)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_t5_tokenize_raises_as_jax(tmp_path):
    """Without sentencepiece both raise the same ImportError; with it, both
    refuse a spiece.model that does not exist."""
    missing = str(tmp_path / "spiece.model")
    with pytest.raises(Exception) as want:
        jt5.t5_tokenize(["a"], missing)
    with pytest.raises(Exception) as got:
        tt5.t5_tokenize(["a"], missing)
    assert type(got.value) is type(want.value)
    assert str(got.value) == str(want.value)
