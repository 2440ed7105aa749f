"""The PyTorch port imports no JAX and nothing of the JAX package, runs on
the card unless asked for the CPU, and its kernels never fall back.

Importing every module of vidseg_diffusion_tpu_torch in a fresh interpreter,
reading its colour map and tokenizing a prompt with its own copy of the tiny
BPE vocabulary leaves jax, flax and every module of
vidseg_diffusion_tpu out of sys.modules; no source line of the port or of
chip_smoke.py names the JAX package in an import or an attribute path.
Loading the kernel library where nvcc cannot be found raises a clear error
instead of returning anything.
"""

import glob
import json
import os
import re
import subprocess
import sys

import pytest

from vidseg_diffusion_tpu_torch.ops import _cuda

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import importlib, json, pkgutil, sys
import vidseg_diffusion_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
foreign = lambda: sorted(m for m in sys.modules
                         if m.split(".")[0] in ("jax", "flax", "jaxlib", "vidseg_diffusion_tpu"))
after_import = foreign()
from vidseg_diffusion_tpu_torch.engine.segmentation import soft_color_map
palette = soft_color_map()
after_color_map = foreign()
from vidseg_diffusion_tpu_torch.io.tokenizer import TINY_VOCAB, tokenize
tokens = tokenize(["a photo of a cat"], bpe_path=TINY_VOCAB)
after_tokenize = foreign()
from vidseg_diffusion_tpu_torch.engine.segmentation import camvid_color_map
from vidseg_diffusion_tpu_torch.models.t5 import byt5_tokenize
from vidseg_diffusion_tpu_torch.utils.watermark import embed_watermark_frames
import numpy as np
camvid = camvid_color_map()
byt5 = byt5_tokenize(["a swan"], 8)
marked = embed_watermark_frames(np.full((256, 256, 3), 0.5))
print(json.dumps({"modules": names, "jax": after_import, "after_color_map": after_color_map,
                  "palette": list(palette.shape), "after_tokenize": after_tokenize,
                  "tokens": tokens[0, :8].tolist(), "vocab": TINY_VOCAB, "camvid": list(camvid.shape),
                  "byt5": byt5[0].tolist(), "after_slice_14": foreign()}))
"""


def test_port_imports_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    out = subprocess.run([sys.executable, "-c", _PROBE], capture_output=True, text=True,
                         cwd=ROOT, env=env, timeout=300, check=True)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    expected = {"ops.attention", "ops.temporal_conv", "models.unet", "models.vae", "models.clip",
                "engine.vidseg", "engine.build", "pipelines.single_video", "io.convert",
                "scripts.svd_single_video_inference", "diffusion.loss", "engine.train", "utils.ema",
                "scripts.train_path", "scripts.profile_train", "ops.norm", "io.video", "io.native",
                "ops.matmul", "ops.conv3x3", "io.tokenizer", "scripts.sd_path", "scripts.main_path",
                "scripts.profile_single_video", "diffusion.denoiser", "diffusion.discretization",
                "diffusion.guidance", "models.conditioner", "models.lpips", "models.regularizers",
                "scripts.autoencoder_train_path", "scripts.time_kernels", "ops.knn", "ops.matching",
                "engine.masks", "eval.metrics", "pipelines.vspw", "scripts.svd_pipeline_vspw",
                "scripts.sd_pipeline_vspw", "diffusion.sampling", "diffusion.sampling_extra",
                "diffusion.scaling", "inference.api", "scripts.api_path", "models.t5", "models.aux_encoders",
                "utils.safety", "utils.watermark", "eval.fid", "io.data", "utils.profiling",
                "scripts.demo.serve", "scripts.demo.sampling", "scripts.detect_watermark",
                "parallel.mesh", "parallel.fsdp", "parallel.runs", "ops.relayout"}
    assert expected <= {m.split(".", 1)[1] for m in res["modules"]}
    assert res["jax"] == []
    assert res["after_color_map"] == [] and res["palette"] == [128, 3]
    # a prompt tokenized with the port's own copy of the tiny vocabulary
    assert res["after_tokenize"] == [] and res["tokens"][0] != 0 and 0 not in res["tokens"][:5]
    assert res["vocab"].startswith(os.path.join(ROOT, "vidseg_diffusion_tpu_torch", "assets"))
    # the CamVid palette from the port's own asset, ByT5 ids, a watermark: still no JAX
    assert res["camvid"] == [32, 3] and res["byt5"] == [100, 35, 118, 122, 100, 113, 1, 0]
    assert res["after_slice_14"] == []


def test_port_sources_do_not_name_the_jax_package():
    """No import of, and no attribute path into, vidseg_diffusion_tpu in the
    port's package or in chip_smoke.py (file paths in prose, written with
    slashes, are how the docstrings name the JAX counterparts)."""
    pattern = re.compile(r"vidseg_diffusion_tpu\.|import\s+vidseg_diffusion_tpu\b")
    files = glob.glob(os.path.join(ROOT, "vidseg_diffusion_tpu_torch", "**", "*.py"), recursive=True)
    files.append(os.path.join(ROOT, "chip_smoke.py"))
    assert len(files) > 40
    hits = []
    for path in files:
        with open(path) as f:
            for n, line in enumerate(f, 1):
                if pattern.search(line):
                    hits.append(f"{os.path.relpath(path, ROOT)}:{n}: {line.strip()}")
    assert hits == []


def test_entry_points_default_to_the_card(tmp_path):
    """build_pipeline (also with the T5 conditioner), the CLIs (single video,
    both VSPW sweeps, the demo server and the demo sampling CLI), DemoApp,
    prefetch_to_device and the full-width path scripts (SVD, SD 2.1,
    diffusion and autoencoder training, the sampling API's) run on cuda
    unless the caller asks for the CPU; without a card the default raises
    instead of falling back."""
    import inspect

    import torch
    import yaml

    from vidseg_diffusion_tpu_torch.engine.build import build_pipeline
    from vidseg_diffusion_tpu_torch.scripts import svd_single_video_inference as cli
    from vidseg_diffusion_tpu_torch.scripts import autoencoder_train_path, main_path, sd_path, train_path
    from vidseg_diffusion_tpu_torch.scripts import api_path, sd_pipeline_vspw, svd_pipeline_vspw
    from vidseg_diffusion_tpu_torch.io.data import prefetch_to_device
    from vidseg_diffusion_tpu_torch.scripts.demo import sampling as demo_cli
    from vidseg_diffusion_tpu_torch.scripts.demo import serve

    assert inspect.signature(build_pipeline).parameters["device"].default == "cuda"
    for script in (main_path, sd_path, autoencoder_train_path, api_path):
        assert inspect.signature(script.build).parameters["device"].default == "cuda"
    for fn in (autoencoder_train_path.batch, autoencoder_train_path.noise_generator):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    assert cli.parse_args([]).device == "cuda" and cli.parse_args(["--device", "cpu"]).device == "cpu"
    for sweep_cli in (svd_pipeline_vspw, sd_pipeline_vspw):
        assert sweep_cli.parse_args(["--data_root", "x"]).device == "cuda"
        args = sweep_cli.parse_args(["--data_root", "x", "--device", "cpu"])
        assert args.device == "cpu" and args.dtype is None   # bf16 on the card, fp32 on the CPU (build)
    assert train_path.DEVICE == "cuda"
    for demo in (serve, demo_cli):
        assert demo.parse_args([]).device == "cuda" and demo.parse_args(["--device", "cpu"]).device == "cpu"
        assert demo.parse_args([]).dtype is None
    assert inspect.signature(serve.DemoApp).parameters["device"].default == "cuda"
    assert inspect.signature(prefetch_to_device).parameters["device"].default == "cuda"
    t5_yaml = tmp_path / "t5.yaml"   # sd_tiny.yaml with the T5 embedder in place of OpenCLIP's
    with open(os.path.join(ROOT, "configs/inference/sd_tiny.yaml")) as f:
        cfg = yaml.safe_load(f)
    cfg["model"]["params"]["conditioner_config"]["params"]["emb_models"] = [dict(
        target="sgm.modules.encoders.modules.FrozenT5Embedder",
        params={"t5_cfg": dict(vocab_size=64, d_model=16, d_kv=4, num_heads=4, d_ff=32, num_layers=1)})]
    t5_yaml.write_text(yaml.safe_dump(cfg))
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            build_pipeline(os.path.join(ROOT, "configs/inference/svd_tiny.yaml"), num_steps=2, num_frames=2)
        with pytest.raises((RuntimeError, AssertionError)):
            build_pipeline(os.path.join(ROOT, "configs/inference/sd_tiny.yaml"), num_steps=2, num_frames=2)
        with pytest.raises((RuntimeError, AssertionError)):   # the sampling API's full-width stack
            build_pipeline(os.path.join(ROOT, "configs/inference/sd_xl_base.yaml"))
        with pytest.raises((RuntimeError, AssertionError)):   # the T5-conditioned stack, and the demo on it
            build_pipeline(str(t5_yaml))
        with pytest.raises((RuntimeError, AssertionError)):
            serve.DemoApp(str(t5_yaml))
        with pytest.raises((RuntimeError, AssertionError)):
            next(prefetch_to_device(iter([torch.zeros(2)])))
    assert build_pipeline(str(t5_yaml), device="cpu").kind == "t5_text"


def test_kernel_library_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_cuda, "BUILD_DIR", str(tmp_path))  # no prebuilt library
    monkeypatch.setattr(_cuda, "_find_nvcc", lambda: None)
    _cuda.load_library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="nvcc was not found"):
            _cuda.load_library()
    finally:
        _cuda.load_library.cache_clear()
    assert not list(tmp_path.iterdir())


def test_failed_build_is_not_repeated(monkeypatch, tmp_path):
    """A compiler failure raises with the compiler's words, and every later
    load in the process raises the same at once instead of compiling every
    source again (each wrapper call would otherwise spend a build's time)."""
    log = tmp_path / "calls"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(f"#!/bin/sh\necho run >> {log}\necho 'error: no such thing' >&2\nexit 1\n")
    nvcc.chmod(0o755)
    monkeypatch.setattr(_cuda, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(_cuda, "_find_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(_cuda, "_FAILED_BUILDS", {})
    _cuda.load_library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="no such thing"):
            _cuda.load_library()
        calls = len(log.read_text().splitlines())
        assert calls == len(_cuda._sources())
        with pytest.raises(RuntimeError, match="no such thing"):
            _cuda.load_library()
        assert len(log.read_text().splitlines()) == calls
    finally:
        _cuda.load_library.cache_clear()


def test_kernel_sources_are_packaged_and_hashed():
    srcs = [os.path.basename(p) for p in _cuda._sources()]
    assert srcs == ["conv3x3.cu", "flash_attention.cu", "flash_attention_bhld_bwd.cu",
                    "flash_attention_bwd.cu", "flash_attention_bwd_x3.cu", "flash_attention_x3.cu", "group_norm.cu",
                    "group_norm_bwd.cu",
                    "matmul_bias.cu",
                    "temporal_attention.cu", "temporal_attention_bwd.cu", "temporal_attention_bwd_512.cu",
                    "temporal_attention_long.cu", "temporal_attention_long_tc.cu", "temporal_conv.cu"]
    assert len(_cuda._source_hash()) == 16
    # the shared headers are part of the hash: an edited tile rebuilds its kernels
    headers = sorted(os.path.basename(p) for p in glob.glob(os.path.join(_cuda.CSRC, "*.cuh")))
    assert headers == ["common.cuh", "flash_x3_tile.cuh", "gemm_tile.cuh", "group_norm.cuh", "temporal_tile.cuh",
                       "tf32x3_attention.cuh", "wgmma_tile.cuh"]
