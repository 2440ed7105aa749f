"""KMeans proto-masks (PyTorch port of engine/masks.py kmeans_masks).

Features arrive as the harvested [2T, L, C] spatial-attention q (uc half
first); masks leave as [K, T, L] float binaries. The match_gt_mask and
refinement modes are not ported yet (ROADMAP Queue A).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from vidseg_diffusion_tpu_torch.ops.kmeans import kmeans_fit


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
