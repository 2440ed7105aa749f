"""The PyTorch port imports no JAX and nothing of the JAX package, runs on
the card unless asked for the CPU, and its kernels never fall back.

Importing every module of vidseg_diffusion_tpu_torch in a fresh interpreter,
and reading its colour map, leaves jax, flax and every module of
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
print(json.dumps({"modules": names, "jax": after_import, "after_color_map": foreign(),
                  "palette": list(palette.shape)}))
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
                "scripts.sd_pipeline_vspw"}
    assert expected <= {m.split(".", 1)[1] for m in res["modules"]}
    assert res["jax"] == []
    assert res["after_color_map"] == [] and res["palette"] == [128, 3]


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


def test_entry_points_default_to_the_card():
    """build_pipeline, the CLIs (single video and both VSPW sweeps) and the
    full-width path scripts (SVD, SD 2.1, diffusion and autoencoder training)
    run on cuda unless the caller asks for the CPU; without a card the
    default raises instead of falling back."""
    import inspect

    import torch

    from vidseg_diffusion_tpu_torch.engine.build import build_pipeline
    from vidseg_diffusion_tpu_torch.scripts import svd_single_video_inference as cli
    from vidseg_diffusion_tpu_torch.scripts import autoencoder_train_path, main_path, sd_path, train_path
    from vidseg_diffusion_tpu_torch.scripts import sd_pipeline_vspw, svd_pipeline_vspw

    assert inspect.signature(build_pipeline).parameters["device"].default == "cuda"
    for script in (main_path, sd_path, autoencoder_train_path):
        assert inspect.signature(script.build).parameters["device"].default == "cuda"
    for fn in (autoencoder_train_path.batch, autoencoder_train_path.noise_generator):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    assert cli.parse_args([]).device == "cuda" and cli.parse_args(["--device", "cpu"]).device == "cpu"
    for sweep_cli in (svd_pipeline_vspw, sd_pipeline_vspw):
        assert sweep_cli.parse_args(["--data_root", "x"]).device == "cuda"
        args = sweep_cli.parse_args(["--data_root", "x", "--device", "cpu"])
        assert args.device == "cpu" and args.dtype is None   # bf16 on the card, fp32 on the CPU (build)
    assert train_path.DEVICE == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            build_pipeline(os.path.join(ROOT, "configs/inference/svd_tiny.yaml"), num_steps=2, num_frames=2)
        with pytest.raises((RuntimeError, AssertionError)):
            build_pipeline(os.path.join(ROOT, "configs/inference/sd_tiny.yaml"), num_steps=2, num_frames=2)


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
                    "flash_attention_bwd.cu", "group_norm.cu", "group_norm_bwd.cu", "matmul_bias.cu",
                    "temporal_attention.cu", "temporal_attention_bwd.cu", "temporal_conv.cu"]
    assert len(_cuda._source_hash()) == 16
    # the shared headers are part of the hash: an edited tile rebuilds its kernels
    headers = sorted(os.path.basename(p) for p in glob.glob(os.path.join(_cuda.CSRC, "*.cuh")))
    assert headers == ["common.cuh", "gemm_tile.cuh", "group_norm.cuh", "temporal_tile.cuh", "wgmma_tile.cuh"]
