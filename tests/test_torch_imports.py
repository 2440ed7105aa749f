"""The PyTorch port imports no JAX, and its kernels never fall back.

Importing every module of vidseg_diffusion_tpu_torch in a fresh interpreter
leaves jax and flax out of sys.modules. Loading the kernel library where
nvcc cannot be found raises a clear error instead of returning anything.
"""

import json
import os
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
print(json.dumps({"modules": names,
                  "jax": sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "flax", "jaxlib"))}))
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
                "scripts.train_path", "scripts.profile_train"}
    assert expected <= {m.split(".", 1)[1] for m in res["modules"]}
    assert res["jax"] == []


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


def test_kernel_sources_are_packaged_and_hashed():
    srcs = [os.path.basename(p) for p in _cuda._sources()]
    assert srcs == ["flash_attention.cu", "flash_attention_bwd.cu", "temporal_attention.cu",
                    "temporal_attention_bwd.cu", "temporal_conv.cu"]
    assert len(_cuda._source_hash()) == 16
