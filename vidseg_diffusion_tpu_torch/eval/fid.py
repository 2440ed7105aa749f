"""Frechet distance (FID math) on the device, in float64; CLIP-FID.

Counterpart of vidseg_diffusion_tpu/eval/fid.py. The reference's extractor
(sgm/modules/encoders/modules.py:187-205, InceptionV3) wraps pytorch_fid
weights that are not in the repository, so, as in the JAX package
(PARITY.md), the features come from any frames -> embedding callable: the
CLIP image tower is the in-framework choice (CLIP-FID). The formula is
pytorch_fid's calculate_frechet_distance,

    d^2 = |mu1 - mu2|^2 + tr(S1 + S2 - 2 sqrtm(S1 S2)),

with tr sqrtm(S1 S2) = tr sqrtm(sqrt(S1) S2 sqrt(S1)) so every root is a
symmetric eigendecomposition (torch.linalg.eigh) on the device. Everything
runs in float64 always: JAX's casts to float64 take effect only with
jax_enable_x64 on, and in its default fp32 a 2048-wide covariance loses
digits against the scipy oracle.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch


def matrix_sqrt_psd(a: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Symmetric PSD square root by eigendecomposition (tiny negative
    eigenvalues from roundoff clamped to 0)."""
    w, v = torch.linalg.eigh(a)
    w = torch.clamp(w, min=0.0)
    return (v * torch.sqrt(w + eps)[None, :]) @ v.T


def feature_stats(feats: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mu [D], Sigma [D, D]) of feature rows [N, D] in float64; the unbiased
    covariance (ddof 1) of np.cov(rowvar=False), as pytorch_fid."""
    feats = feats.to(torch.float64)
    mu = feats.mean(dim=0)
    x = feats - mu[None]
    return mu, (x.T @ x) / (feats.shape[0] - 1)


def frechet_distance(mu1: torch.Tensor, sigma1: torch.Tensor, mu2: torch.Tensor,
                     sigma2: torch.Tensor) -> torch.Tensor:
    mu1, mu2, sigma1, sigma2 = (t.to(torch.float64) for t in (mu1, mu2, sigma1, sigma2))
    diff = mu1 - mu2
    s1h = matrix_sqrt_psd(sigma1)
    w = torch.clamp(torch.linalg.eigvalsh(s1h @ sigma2 @ s1h), min=0.0)
    return diff @ diff + torch.trace(sigma1) + torch.trace(sigma2) - 2.0 * torch.sqrt(w).sum()


def fid_from_features(feats1: torch.Tensor, feats2: torch.Tensor) -> torch.Tensor:
    """FID between two feature populations [N1, D], [N2, D]."""
    mu1, s1 = feature_stats(feats1)
    mu2, s2 = feature_stats(feats2)
    return frechet_distance(mu1, s1, mu2, s2)


@torch.no_grad()
def clip_features(clip_image_fn: Callable[[torch.Tensor], torch.Tensor], images: torch.Tensor,
                  batch_size: int = 32) -> torch.Tensor:
    """[-1, 1] images [N, H, W, 3] -> embedding rows [N, D], batch_size
    images a call of `clip_image_fn` (e.g. a CLIP tower after
    models/clip.clip_preprocess)."""
    images = torch.as_tensor(images)
    if images.shape[0] == 0:
        raise ValueError("clip_features needs at least one image (got an empty batch); FID additionally needs "
                         "N >= 2 rows per population for a non-degenerate covariance")
    feats = [clip_image_fn(images[i:i + batch_size]) for i in range(0, images.shape[0], batch_size)]
    return torch.cat(feats, dim=0)


def clip_fid(clip_image_fn: Callable[[torch.Tensor], torch.Tensor], images1: torch.Tensor,
             images2: torch.Tensor, batch_size: int = 32) -> torch.Tensor:
    """CLIP-FID between two image populations ([N, H, W, 3] in [-1, 1])."""
    return fid_from_features(clip_features(clip_image_fn, images1, batch_size),
                             clip_features(clip_image_fn, images2, batch_size))
