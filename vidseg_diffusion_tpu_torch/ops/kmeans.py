"""KMeans on the device: kmeans++ seeding, restarts, Lloyd iterations.

Counterpart of vidseg_diffusion_tpu/ops/kmeans.py (sklearn KMeans semantics:
greedy kmeans++ with 2 + log2(k) local trials, n_init restarts keeping the
lowest inertia, Lloyd updates with empty clusters reseeded to distinct
farthest points, per-restart freezing once the centre shift drops under
tol). The restarts run as a batch axis. Seeding draws from an explicit
torch.Generator; `init_centers` [n_init, K, D] replaces the seeding
altogether, so a test can hand over the centres the JAX package drew.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def _sq_dists(x: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """Squared distances via |x|^2 - 2 x.c + |c|^2, clamped at 0.
    x [N, D], centers [..., K, D] -> [..., N, K]."""
    x2 = (x * x).sum(dim=1, keepdim=True)
    c2 = (centers * centers).sum(dim=-1)
    xc = x @ centers.transpose(-1, -2)
    return (x2 - 2.0 * xc + c2[..., None, :]).clamp_min(0.0)


def kmeanspp_init(x: torch.Tensor, k: int, generator: Optional[torch.Generator]) -> torch.Tensor:
    """Greedy kmeans++ seeding (sklearn _kmeans_plusplus) -> [K, D]. The
    draws come from `generator` (a CPU torch.Generator) on the host."""
    n, d = x.shape
    n_trials = 2 + int(math.log2(max(k, 2)))
    first = int(torch.randint(0, n, (1,), generator=generator))
    centers = torch.zeros((k, d), dtype=x.dtype, device=x.device)
    centers[0] = x[first]
    min_d2 = _sq_dists(x, x[first][None])[:, 0]
    for i in range(1, k):
        p = (min_d2 / min_d2.sum().clamp_min(1e-12)).cpu()
        cand_idx = torch.multinomial(p, n_trials, replacement=True, generator=generator)
        cand = x[cand_idx.to(x.device)]
        d2_cand = torch.minimum(_sq_dists(x, cand), min_d2[:, None])
        best = int(torch.argmin(d2_cand.sum(dim=0)))
        centers[i] = cand[best]
        min_d2 = d2_cand[:, best]
    return centers


def _lloyd(x, centers, n_iter: int, tol: float):
    """Lloyd iterations for R restarts at once. centers [R, K, D].
    Returns (centers [R, K, D], labels [R, N], inertia [R])."""
    r, k, _ = centers.shape
    prev_shift = torch.full((r,), float("inf"), device=x.device)
    for _ in range(n_iter):
        frozen = prev_shift < tol
        d2 = _sq_dists(x, centers)                          # [R, N, K]
        labels = d2.argmin(dim=2)
        onehot = F.one_hot(labels, k).to(x.dtype)           # [R, N, K]
        counts = onehot.sum(dim=1)                          # [R, K]
        sums = onehot.transpose(1, 2) @ x                   # [R, K, D]
        new = sums / counts.clamp_min(1.0)[..., None]
        # empty clusters take DISTINCT farthest points (one per empty slot)
        far_idx = torch.topk(d2.min(dim=2).values, k, dim=1).indices  # [R, K]
        empty = counts == 0
        rank = (torch.cumsum(empty.to(torch.int64), dim=1) - 1).clamp(0, k - 1)
        repl = x[torch.gather(far_idx, 1, rank)]            # [R, K, D]
        new = torch.where(empty[..., None], repl, new)
        new = torch.where(frozen[:, None, None], centers, new)
        shift = ((new - centers) ** 2).sum(dim=(1, 2))
        prev_shift = torch.where(frozen, prev_shift, shift)
        centers = new
    d2 = _sq_dists(x, centers)
    return centers, d2.argmin(dim=2), d2.min(dim=2).values.sum(dim=1)


def kmeans_fit(
    x: torch.Tensor,
    k: int,
    n_init: int = 10,
    n_iter: int = 50,
    tol: float = 1e-4,
    generator: Optional[torch.Generator] = None,
    init_centers: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fit KMeans on x [N, D]. Returns (centers [K, D], labels [N], inertia)
    of the restart with the lowest inertia. `init_centers` [n_init, K, D]
    skips the kmeans++ seeding."""
    x = x.float()
    if init_centers is None:
        init_centers = torch.stack([kmeanspp_init(x, k, generator) for _ in range(n_init)])
    centers, labels, inertia = _lloyd(x, init_centers.to(x), n_iter, tol)
    best = int(torch.argmin(inertia))
    return centers[best], labels[best], inertia[best]


def kmeans_predict(centers: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return _sq_dists(x.float(), centers).argmin(dim=1)
