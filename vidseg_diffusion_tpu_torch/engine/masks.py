"""Mask extraction (PyTorch port of engine/masks.py): the three
feature -> mask modes.

- kmeans_masks: joint KMeans over all frames' cond-half tokens.
- match_gt_mask: KMeans, then a majority-overlap mapping of the clusters to
  the first frame's GT labels, then KNN(4) propagation to every frame; the
  carried GTMatchState chains sliding windows (svd_pipeline_vspw.py:229-232).
- correct_low_res_mask (--is_refine_mask): dense tracking and a majority
  vote along the surviving trajectories (ops/matching.py).

Features arrive as the harvested [2T, L, C] spatial-attention q (uc half
first); masks leave as [K, T, L] float binaries.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from vidseg_diffusion_tpu_torch.ops.kmeans import kmeans_fit
from vidseg_diffusion_tpu_torch.ops.knn import knn_predict
from vidseg_diffusion_tpu_torch.ops.matching import (
    dense_tracking,
    positive_jump_filter,
    trajectory_majority_vote,
)


def _normalize(features: torch.Tensor) -> torch.Tensor:
    """Per-token max-abs channel normalization (feature_extraction.py:39)."""
    return features / features.abs().amax(dim=-1, keepdim=True)


def aggregate_blocks(features: Sequence[torch.Tensor]) -> torch.Tensor:
    """--is_aggre_attn: the mean over blocks (feature_extraction.py:739-745)
    as the JAX pipeline's jnp.mean(jnp.stack(feats), axis=0) computes it: the
    blocks summed in order in fp32 (bf16 and fp16 are upcast), times the
    fp32 reciprocal of the count (XLA compiles jnp.mean's division by the
    count into that product), rounded once to the features' dtype: bf16
    features reach kmeans_masks as bf16, as in JAX."""
    stacked = torch.stack(list(features))
    acc = torch.float32 if stacked.dtype in (torch.bfloat16, torch.float16) else stacked.dtype
    inv_count = torch.tensor(1.0 / stacked.shape[0], dtype=acc, device=stacked.device)
    return (stacked.sum(dim=0, dtype=acc) * inv_count).to(stacked.dtype)


def kmeans_masks(
    features: torch.Tensor,
    num_masks: int,
    num_frames: int,
    generator: Optional[torch.Generator] = None,
    init_centers: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, np.ndarray]:
    """Joint KMeans over the cond half's tokens of all frames. Returns
    (masks [K, T, L], unique_labels [K]) (feature_extraction.py:44-85)."""
    cond = _normalize(features.float())[num_frames:]
    flat = cond.reshape(-1, cond.shape[-1])
    _, labels, _ = kmeans_fit(flat, num_masks, generator=generator, init_centers=init_centers)
    labels = labels.reshape(num_frames, -1)
    masks = F.one_hot(labels, num_masks).permute(2, 0, 1).float()
    return masks, np.arange(num_masks)


def _one_hot_masks(labels: torch.Tensor, k: int) -> torch.Tensor:
    """[T, L] dense labels -> [K, T, L] float binaries."""
    return F.one_hot(labels.long(), k).permute(2, 0, 1).float()


@dataclasses.dataclass
class GTMatchState:
    """The state carried across sliding windows (ref_mask / ref_feature_map /
    ref_unique_labels, svd_pipeline_vspw.py:229-232): the previous window's
    features and their dense label indices into unique_labels, which maps
    them back to the original (VSPW) label ids."""

    ref_features: torch.Tensor   # [N, C] fp32, on the features' device
    ref_labels: torch.Tensor     # [N] dense indices
    unique_labels: np.ndarray    # [K] original label ids


def match_gt_mask(
    features: torch.Tensor,                  # [2T, L, C]
    num_masks: int,
    num_frames: int,
    gt_mask: Optional[np.ndarray] = None,    # [L] original label ids of frame 0
    state: Optional[GTMatchState] = None,
    knn_k: int = 4,
    generator: Optional[torch.Generator] = None,
    init_centers: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, GTMatchState]:
    """First window: KMeans clusters -> majority-overlap mapping to the GT
    labels (feature_extraction.py:589-595; the clusters stand in for the GT
    when gt_mask is None) -> KNN propagation to all frames (:608-613). Later
    windows: KNN against the carried state. Returns (masks [K, T, L] in
    unique_labels order, the next state: every token of this window)."""
    cond = _normalize(features.float())[num_frames:]   # [T, L, C]
    flat = cond.reshape(-1, cond.shape[-1])
    l = cond.shape[1]
    if state is None:
        _, km_labels, _ = kmeans_fit(flat, num_masks, generator=generator, init_centers=init_centers)
        frame0_clusters = km_labels[:l].cpu().numpy()
        gt = frame0_clusters if gt_mask is None else np.asarray(gt_mask).reshape(-1)
        ref_mask = np.zeros(l, dtype=np.int64)
        for cl in np.unique(frame0_clusters):
            vals, counts = np.unique(gt[frame0_clusters == cl], return_counts=True)
            ref_mask[frame0_clusters == cl] = vals[np.argmax(counts)]
        unique_labels = np.unique(ref_mask)
        dense = np.searchsorted(unique_labels, ref_mask)
        state = GTMatchState(ref_features=cond[0], ref_labels=torch.from_numpy(dense).to(flat.device),
                             unique_labels=unique_labels)
    k_classes = len(state.unique_labels)
    pred = knn_predict(state.ref_features, state.ref_labels, flat, k=knn_k, num_classes=max(k_classes, 1))
    masks = _one_hot_masks(pred.reshape(num_frames, l), k_classes)
    return masks, GTMatchState(ref_features=flat, ref_labels=pred, unique_labels=state.unique_labels)


def correct_low_res_mask(
    features: torch.Tensor,   # [2T, L, C] spatial q of the tracking block
    masks: torch.Tensor,      # [K, T, L] binary masks
    num_frames: int,
    width: int,               # token-grid width
) -> torch.Tensor:
    """--is_refine_mask: track every token, drop positive-jump trajectories,
    relabel along the survivors by majority vote (feature_extraction.py
    :367-461). Returns the refined masks [K, T, L]."""
    k = masks.shape[0]
    cond = _normalize(features.float())[num_frames:]
    seg = torch.argmax(masks, dim=0)
    traj = dense_tracking(cond, use_aux=True)
    keep = positive_jump_filter(traj, width=width, threshold=1)
    return _one_hot_masks(trajectory_majority_vote(traj, seg, keep, num_classes=k), k)
