"""Image ops: Gaussian blur and the resizes of the segmentation path and
the SpatialRescaler.

Counterpart of vidseg_diffusion_tpu/ops/image.py. `resize_bicubic` is
jax.image.resize(method="cubic") written out: the Keys cubic with a = -0.5,
and, when downscaling, the kernel stretched by the scale (antialiasing;
`antialias=False` keeps it unstretched, as jax.image.resize(...,
antialias=False)); `resize_linear` is its 'linear' (triangle kernel) without
antialiasing, the SpatialRescaler's.
torch's F.interpolate(mode="bicubic") uses a = -0.75 without antialiasing
and gives other values, so the weights are built here, per axis, in fp32
as JAX builds them.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def _lanczos3(x: torch.Tensor) -> torch.Tensor:
    y = 3.0 * torch.sin(math.pi * x) * torch.sin(math.pi * x / 3.0)
    out = torch.where(x > 1e-3, y / torch.where(x != 0, math.pi**2 * x**2, 1.0), 1.0)
    return torch.where(x > 3.0, 0.0, out)


def _triangle(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(1.0 - x, min=0.0)


def _weight_mat(in_size: int, out_size: int, kernel, device, antialias: bool = True) -> torch.Tensor:
    """[in_size, out_size] interpolation weights (jax compute_weight_mat with
    scale = out/in, translation 0)."""
    scale = out_size / in_size
    inv_scale = 1.0 / scale
    kernel_scale = max(inv_scale, 1.0) if antialias else 1.0
    f32 = dict(dtype=torch.float32, device=device)
    sample_f = (torch.arange(out_size, **f32) + 0.5) * inv_scale - 0.5
    x = (sample_f[None, :] - torch.arange(in_size, **f32)[:, None]).abs() / kernel_scale
    w = kernel(x)
    total = w.sum(dim=0, keepdim=True)
    eps = 1000.0 * torch.finfo(torch.float32).eps
    w = torch.where(total.abs() > eps, w / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[None, :], w, 0.0)


def _resize(img: torch.Tensor, shape: Tuple[int, int], kernel, antialias: bool = True) -> torch.Tensor:
    x = img if img.is_floating_point() else img.float()
    h, w = x.shape[-2:]
    oh, ow = shape
    if oh != h:
        x = torch.einsum("...hw,ho->...ow", x, _weight_mat(h, oh, kernel, x.device, antialias).to(x.dtype))
    if ow != w:
        x = torch.einsum("...hw,wo->...ho", x, _weight_mat(w, ow, kernel, x.device, antialias).to(x.dtype))
    return x


def resize_bicubic(img: torch.Tensor, shape: Tuple[int, int], antialias: bool = True) -> torch.Tensor:
    """Bicubic resize of the trailing [H, W] dims (jax.image.resize 'cubic');
    integer input is promoted to fp32 as JAX promotes it."""
    return _resize(img, shape, _keys_cubic, antialias)


def resize_linear(img: torch.Tensor, shape: Tuple[int, int]) -> torch.Tensor:
    """Linear resize of the trailing [H, W] dims (jax.image.resize 'linear',
    antialias=False)."""
    return _resize(img, shape, _triangle, antialias=False)


def resize_lanczos(img: torch.Tensor, shape: Tuple[int, int]) -> torch.Tensor:
    """Lanczos-3 resize of the trailing [H, W] dims (jax 'lanczos3')."""
    return _resize(img, shape, _lanczos3)


def resize_nearest(img: torch.Tensor, shape: Tuple[int, int]) -> torch.Tensor:
    """Nearest resize of the trailing [H, W] dims (jax.image.resize
    'nearest': source index floor((i + 0.5) * in / out) in fp32)."""
    x = img
    for axis, n in ((-2, shape[0]), (-1, shape[1])):
        m = x.shape[axis]
        if m == n:
            continue
        offs = (torch.arange(n, dtype=torch.float32) + 0.5) * (m / n)
        idx = torch.floor(offs).to(torch.long).to(x.device)
        x = x.index_select(x.dim() + axis, idx)
    return x


def gaussian_kernel1d(ksize: int, sigma: float) -> torch.Tensor:
    """cv2.getGaussianKernel: truncated, normalized Gaussian."""
    r = (ksize - 1) / 2.0
    x = torch.arange(ksize, dtype=torch.float32) - r
    k = torch.exp(-(x * x) / (2.0 * sigma * sigma))
    return k / k.sum()


def _reflect_index(n: int, pad: int, device) -> torch.Tensor:
    """Source rows of an axis of n padded by `pad` on each side in numpy's
    'reflect' mode (REFLECT_101, repeated for pads wider than the axis)."""
    i = torch.arange(-pad, n + pad, device=device)
    if n == 1:
        return torch.zeros_like(i)
    i = torch.remainder(i, 2 * (n - 1))
    return torch.where(i >= n, 2 * (n - 1) - i, i)


def gaussian_blur(img: torch.Tensor, ksize: int = 5, sigma: float = 3.0) -> torch.Tensor:
    """Separable Gaussian blur of the trailing two dims with REFLECT_101
    borders (cv2's default), in fp32. The pad is gathered by index, so pads
    wider than the image reflect again, as jnp.pad(mode="reflect") does (the
    safety filter's 99-tap blur on small frames; F.pad refuses them)."""
    k = gaussian_kernel1d(ksize, sigma).to(img.device)
    pad = ksize // 2
    shape = img.shape
    h, w = shape[-2:]
    x = img.reshape(-1, 1, h, w).float()
    x = x[:, :, _reflect_index(h, pad, x.device)][..., _reflect_index(w, pad, x.device)]
    x = F.conv2d(x, k.view(1, 1, ksize, 1))
    x = F.conv2d(x, k.view(1, 1, 1, ksize))
    return x.reshape(shape)
