"""Difference maps -> segmentation (PyTorch port of engine/segmentation.py).

compute_difference in the reference's uint8_wrap mode: the +/- lambda frames
are uint8 PNG arrays in the reference, so the difference and its square
wrap mod 256 (process_output.py:13); torch's uint8 arithmetic wraps the same
way. The blurred map is clipped and truncated to uint8 (Image.convert("L")).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from vidseg_diffusion_tpu_torch.ops.image import gaussian_blur, resize_lanczos


def compute_difference(frames_a: torch.Tensor, frames_b: torch.Tensor) -> torch.Tensor:
    """[..., H, W, 3] uint8-valued frames -> blurred, uint8-quantized
    difference [..., H, W] as fp32, in the JAX package's uint8_wrap mode."""
    delta = frames_a.to(torch.uint8) - frames_b.to(torch.uint8)   # wraps mod 256
    ss = (delta * delta).float().sum(dim=-1)                       # square wraps mod 256
    d = gaussian_blur(torch.sqrt(ss), 5, 3.0)
    return d.clamp(0.0, 255.0).to(torch.uint8).float()


def filter_difference(diff: torch.Tensor, masks: torch.Tensor, filter_s: float) -> torch.Tensor:
    """d*m + s*d*(1-m) with the mask Lanczos-resized to the map size and
    clamped like PIL's uint8 output (process_output.py:30-38)."""
    mh, mw = diff.shape[-2:]
    m = resize_lanczos(masks.float() * 255.0, (mh, mw)).clamp(0.0, 255.0) / 255.0
    return diff * m + filter_s * diff * (1.0 - m)


def segmentation_argmax(diff: torch.Tensor, masks: Optional[torch.Tensor] = None,
                        filter_s: Optional[float] = None,
                        labels: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-map max normalization, optional filtering, argmax over the mask
    axis, mapped to label ids (process_output.py:109-161). [M, T, H, W] ->
    [T, H, W] int32."""
    norm = diff / (diff.amax(dim=(-2, -1), keepdim=True) + 1e-5)
    if filter_s is not None and masks is not None:
        norm = filter_difference(norm, masks, filter_s)
    seg = norm.argmax(dim=0)
    if labels is not None:
        seg = labels.to(seg.device)[seg]
    return seg.to(torch.int32)


def soft_color_map(n: int = 128, seed: int = 0) -> np.ndarray:
    """Palette for colorized label maps: the reference's 119-entry table
    (the package's assets/color_map_soft.txt), extended by golden-ratio hues."""
    import colorsys

    table = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         "assets", "color_map_soft.txt")
    base = np.loadtxt(table, delimiter=",", dtype=np.int64).astype(np.uint8)
    if n <= base.shape[0]:
        return base[:n]
    extra = n - base.shape[0]
    rng = np.random.RandomState(seed)
    hues = (np.arange(extra) * 0.61803398875) % 1.0
    sat = 0.35 + 0.25 * rng.rand(extra)
    val = 0.75 + 0.2 * rng.rand(extra)
    rgb = np.array([colorsys.hsv_to_rgb(h, s, v) for h, s, v in zip(hues, sat, val)])
    return np.concatenate([base, (rgb * 255).astype(np.uint8)], axis=0)


def camvid_color_map() -> np.ndarray:
    """The CamVid palette, [32, 3] uint8 (the reference's
    scripts/util/color_map_camvid.txt; the package's own copy in
    assets/color_map_camvid.txt)."""
    table = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         "assets", "color_map_camvid.txt")
    return np.loadtxt(table, delimiter=",", dtype=np.int64).astype(np.uint8)
