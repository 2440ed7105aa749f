"""Python face of the native IO runtime (native/vidseg_native.cpp).

The port's own copy of vidseg_diffusion_tpu/io/native.py (the port imports
nothing of the JAX package); it builds the same native/vidseg_native.cpp.

Builds the extension on first use (g++ + libpng are baked into the image)
and exposes:
- read_png / write_png: libpng codecs that release the GIL
- ParallelFrameWriter: a thread pool writing artifact PNGs (masks, modulated
  frames, seg maps) concurrently with device compute — the reference serializes
  every PIL save on the Python thread (svd_single_video_inference.py:174-190)
Falls back to PIL transparently when the toolchain is unavailable.
"""

from __future__ import annotations

import os
import subprocess
import sys
import sysconfig
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Tuple

import numpy as np

_NATIVE = None
_TRIED = False
_LOCK = threading.Lock()


def _native_dir() -> str:
    return os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
        "native",
    )


def load_native(build: bool = True):
    """Import vidseg_native, building it in-place on first use. Returns the
    module or None."""
    global _NATIVE, _TRIED
    with _LOCK:
        # once a build attempt failed, never retry in-process: read/write
        # call this per FRAME, and each doomed setup.py subprocess can
        # block minutes on the fallback path
        if _NATIVE is not None or _TRIED:
            return _NATIVE
        _TRIED = True
        nd = _native_dir()
        if nd not in sys.path:
            sys.path.insert(0, nd)
        try:
            import vidseg_native  # noqa

            _NATIVE = vidseg_native
            return _NATIVE
        except ImportError:
            pass
        if not build:
            return None
        try:
            subprocess.run(
                [sys.executable, "setup.py", "build_ext", "--inplace"],
                cwd=nd, check=True, capture_output=True, timeout=300,
            )
            import importlib

            _NATIVE = importlib.import_module("vidseg_native")
        except Exception as e:  # toolchain missing → PIL fallback
            print(f"vidseg_native unavailable ({e}); falling back to PIL",
                  file=sys.stderr)
            _NATIVE = None
        return _NATIVE


def read_png(path: str) -> np.ndarray:
    """[H, W, C] uint8 (C ∈ {1,3,4}); grayscale returns [H, W, 1]."""
    native = load_native()
    if native is not None:
        h, w, c, data = native.read_png_file(path)
        return np.frombuffer(data, np.uint8).reshape(h, w, c)
    from PIL import Image

    img = Image.open(path)
    if img.mode == "P":
        # match the native codec: png_set_palette_to_rgb expands palettes
        # (vidseg_native.cpp:84); raw indices would diverge per environment
        img = img.convert("RGB")
    arr = np.asarray(img)
    return arr if arr.ndim == 3 else arr[..., None]


def write_png(path: str, pixels: np.ndarray, level: int = 6) -> None:
    pixels = np.ascontiguousarray(pixels, dtype=np.uint8)
    if pixels.ndim == 2:
        pixels = pixels[..., None]
    native = load_native()
    if native is not None:
        h, w, c = pixels.shape
        native.write_png_file(path, pixels.tobytes(), h, w, c, level)
        return
    from PIL import Image

    img = pixels[..., 0] if pixels.shape[-1] == 1 else pixels
    Image.fromarray(img).save(path)


class ParallelFrameWriter:
    """Asynchronous PNG artifact writer. With the native codec the encodes
    run GIL-free, so N workers give real parallelism; with the PIL fallback
    it still overlaps file IO with compute."""

    def __init__(self, workers: int = 4):
        self._pool = ThreadPoolExecutor(max_workers=workers)
        self._futures = []

    def submit(self, path: str, pixels: np.ndarray, level: int = 6):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        arr = np.ascontiguousarray(pixels, dtype=np.uint8)
        self._futures.append(self._pool.submit(write_png, path, arr, level))

    def wait(self):
        for f in self._futures:
            f.result()
        self._futures.clear()

    def close(self):
        self.wait()
        self._pool.shutdown()
