"""Safety filtering and watermarking (PyTorch).

Counterpart of vidseg_diffusion_tpu/utils/safety.py: the reference's
DeepFloydDataFiltering (scripts/util/detection/nsfw_and_watermark_dectection.py:39-76:
CLIP ViT-L/14 image features -> logistic heads from p_head_v1.npz /
w_head_v1.npz) and sgm/inference/helpers.py's embed_watermark (:16-59).
As in the reference, the VidSeg path builds no filter and never applies one.

- The .npz heads carry `weights` [K, D] and `biases` [K]; the features are
  the raw CLIP image embeddings cast to fp16 (not L2-normalized) before the
  heads (:63-64); predict_proba is the stable two-branch sigmoid (:12-17),
  in numpy on the host.
- A frame either head flags (threshold 0.5) is Gaussian-blurred (kernel 99,
  sigma 100; ops/image.gaussian_blur on the frames' device), and the two
  heads' blurs apply one after the other: a frame both flag is blurred
  twice.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from vidseg_diffusion_tpu_torch.ops.image import gaussian_blur
from vidseg_diffusion_tpu_torch.utils.watermark import embed_watermark_frames

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def predict_proba(x: np.ndarray, weights: np.ndarray, biases: np.ndarray) -> np.ndarray:
    """Stable logistic head: x [B, D], weights [K, D], biases [K] -> [K, B]."""
    logits = x @ weights.T + biases
    proba = np.where(logits >= 0, 1.0 / (1.0 + np.exp(-logits)), np.exp(logits) / (1.0 + np.exp(logits)))
    return proba.T


def blur_frames(frames: torch.Tensor) -> torch.Tensor:
    """GaussianBlur(99, 100) of channels-last frames [B, H, W, C], in fp32,
    returned in the frames' dtype."""
    chw = frames.movedim(-1, 1)
    return gaussian_blur(chw, ksize=99, sigma=100.0).movedim(1, -1).to(frames.dtype)


@dataclasses.dataclass
class SafetyFilter:
    """CLIP-feature logistic-head NSFW / watermark filter. `clip_image_fn`
    maps frames [B, H, W, 3] to raw CLIP image embeddings [B, D]; heads are
    (weights [K, D], biases [K]) numpy pairs. Without a tower or heads it is
    a no-op reporting scores of 0 (the .npz files are distributed
    separately)."""

    clip_image_fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
    p_head: Optional[Tuple[np.ndarray, np.ndarray]] = None
    w_head: Optional[Tuple[np.ndarray, np.ndarray]] = None
    p_threshold: float = 0.5
    w_threshold: float = 0.5

    @classmethod
    def from_npz(cls, clip_image_fn, p_head_path: str, w_head_path: str, **kw) -> "SafetyFilter":
        def load(path):
            if not path:
                return None
            with np.load(path) as z:
                return np.asarray(z["weights"]), np.asarray(z["biases"])

        return cls(clip_image_fn=clip_image_fn, p_head=load(p_head_path), w_head=load(w_head_path), **kw)

    def scores(self, frames: torch.Tensor) -> np.ndarray:
        """[2, B] (p, w) probabilities of the first head row; zeros when
        unconfigured."""
        b = frames.shape[0]
        out = np.zeros((2, b))
        if self.clip_image_fn is None or (self.p_head is None and self.w_head is None):
            return out
        with torch.no_grad():
            feats = self.clip_image_fn(frames).float().cpu().numpy().astype(np.float16)
        for row, head in enumerate((self.p_head, self.w_head)):
            if head is not None:
                out[row] = predict_proba(feats, *head)[0]
        return out

    def __call__(self, frames: torch.Tensor) -> torch.Tensor:
        """Frames [B, H, W, C] (any range) with the flagged ones blurred,
        first by the p head's flags, then by the w head's; unchanged when
        unconfigured."""
        s = self.scores(frames)
        for flagged in (s[0] > self.p_threshold, s[1] > self.w_threshold):
            if flagged.any():
                mask = torch.as_tensor(flagged, device=frames.device)[:, None, None, None]
                frames = torch.where(mask, blur_frames(frames), frames)
        return frames


def embed_watermark(frames: torch.Tensor, strength: float = 0.0) -> torch.Tensor:
    """The watermark hook: strength <= 0 is the identity (the shipped
    pipelines never watermark); RGB frames of 256x256 or more get the
    reference's fixed 48-bit message by the DWT-DCT scheme (utils/watermark.py,
    numpy on the host, back on the frames' device in their dtype); smaller
    frames get a deterministic low-amplitude dither so presence checks see a
    signal at toy sizes."""
    if strength <= 0.0:
        return frames
    h, w = frames.shape[-3:-1]
    if h * w >= 256 * 256 and frames.shape[-1] == 3:
        out = embed_watermark_frames(frames.detach().float().cpu().numpy().astype(np.float64))
        return torch.as_tensor(out).to(device=frames.device, dtype=frames.dtype)
    yy = torch.arange(h, device=frames.device)[:, None]
    xx = torch.arange(w, device=frames.device)[None, :]
    pattern = (((yy * 7 + xx * 13) % 17).float() / 17.0 - 0.5) * strength
    return frames + pattern[..., None]
