"""Dense feature tracking and trajectory voting (PyTorch port of
ops/matching.py).

Counterparts of the reference's correspondence refinement
(feature_extraction.py: dense_feature_matching_iterative :176-323,
dense_tracking :326-364, correct_low_res_mask :367-461): frame-to-frame
cosine-similarity argmax matching of every token with first-frame ("aux")
blending, the positive-jump spatial filter, and a majority vote along each
point trajectory. Each transition is one [P, C] x [C, L] product.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _l2norm(x: torch.Tensor) -> torch.Tensor:
    return x / torch.sqrt((x * x).sum(dim=-1, keepdim=True))


def blend_weight(f_idx: int):
    """(w, 1 - w) of transition f_idx as JAX computes them in fp32:
    w = f / (f + 1) with both operands fp32."""
    w = torch.tensor(float(f_idx), dtype=torch.float32) / torch.tensor(f_idx + 1.0, dtype=torch.float32)
    return w, torch.tensor(1.0, dtype=torch.float32) - w


def tracking_scores(f: torch.Tensor, pos: torch.Tensor, f_idx: int, use_aux: bool = True) -> torch.Tensor:
    """[P, L] scores of the step from frame f_idx to f_idx + 1 for the points
    at `pos` of l2-normalised features f [T, L, C]: w * cos(src, next frame)
    + (1 - w) * cos(src, frame 0) with w = f / (f + 1) (feature_extraction.py
    :277-296), the plain cosine without use_aux."""
    src = f[f_idx][pos]
    cos = src @ f[f_idx + 1].T
    if use_aux:
        w, w1 = (x.to(f.device) for x in blend_weight(f_idx))
        cos = w * cos + w1 * (src @ f[0].T)
    return cos


def dense_tracking(features: torch.Tensor, use_aux: bool = True) -> torch.Tensor:
    """Track every token of frame 0 through all frames of features [T, L, C]
    (the cond half of the CFG batch). Returns linear token positions [T, P = L]
    (int64); row 0 is the identity grid."""
    t, l, _ = features.shape
    f = _l2norm(features.float())
    pos = torch.arange(l, device=features.device)
    traj = [pos]
    for f_idx in range(t - 1):
        pos = torch.argmax(tracking_scores(f, pos, f_idx, use_aux), dim=1)
        traj.append(pos)
    return torch.stack(traj)


def positive_jump_filter(positions: torch.Tensor, width: int, threshold: int = 1) -> torch.Tensor:
    """Keep mask [P] (bool): drop a trajectory if any step moves more than
    `threshold` in +h or +w (feature_extraction.py:392-409; the signed,
    positive-only comparison is the reference's and is kept)."""
    hs = torch.div(positions, width, rounding_mode="floor")
    ws = positions % width
    dh = hs[1:] - hs[:-1]
    dw = ws[1:] - ws[:-1]
    return ~((dh > threshold) | (dw > threshold)).any(dim=0)


def trajectory_majority_vote(positions: torch.Tensor, seg_maps: torch.Tensor, keep: torch.Tensor,
                             num_classes: int) -> torch.Tensor:
    """Relabel each kept trajectory's cells to its most common label
    (anchor_label_method='common', feature_extraction.py:411-421); a tie goes
    to the label met first along the trajectory (Counter.most_common). Where
    kept trajectories share a cell, the last of them writes it, on either
    device. positions [T, P], seg_maps [T, L] int, keep [P] bool -> [T, L]."""
    t, p = positions.shape
    labels = torch.gather(seg_maps.long(), 1, positions)                     # [T, P]
    onehot = F.one_hot(labels, num_classes).float()                          # [T, P, C]
    counts = onehot.sum(dim=0)                                               # [P, C]
    steps = torch.arange(t, dtype=torch.float32, device=positions.device)[:, None, None]
    first = torch.where(onehot > 0, steps, torch.tensor(float(t), device=positions.device)).amin(dim=0)
    voted = torch.argmax(counts * (t + 1) + (t - first), dim=1)              # [P]
    l = seg_maps.shape[1]
    writer = torch.full((t, l), -1, dtype=torch.int64, device=positions.device)
    kept = torch.nonzero(keep).flatten()
    writer.scatter_reduce_(1, positions[:, kept], kept.expand(t, -1), reduce="amax")
    written = writer >= 0
    return torch.where(written, voted[writer.clamp_min(0)], seg_maps.long()).to(seg_maps.dtype)
