"""Segmentation metrics: mIoU and mVC (video consistency), on torch tensors.

Port of vidseg_diffusion_tpu/eval/metrics.py (the VSPW metrics; the
reference repo has no evaluation code):

- mean_iou: per-class intersection-over-union averaged over the classes
  present in the ground truth, from a confusion matrix accumulated over all
  frames and videos.
- video_consistency (mVC_c): over every window of c consecutive frames, the
  pixels whose prediction is the same in every frame of the window among
  those whose ground truth is (VSPW_code get_common), averaged over the
  windows that have such ground-truth pixels.

Counts are int64 (bincount), exact at any size; the JAX package counts in
fp32, exact only up to 2**24 pixels in one cell. As there, a prediction
outside [0, num_classes) (a 255 carried over from a GT region, say) is left
out of the matrix, as jax.nn.one_hot leaves it out.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def _as_tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(x)


def confusion_matrix(pred, gt, num_classes: int, ignore_label: int = 255) -> torch.Tensor:
    """[num_classes, num_classes] int64 counts (rows = gt, cols = pred)."""
    pred = _as_tensor(pred).reshape(-1).long()
    gt = _as_tensor(gt).reshape(-1).long()
    keep = ((gt != ignore_label) & (gt >= 0) & (gt < num_classes)
            & (pred >= 0) & (pred < num_classes))
    idx = gt[keep] * num_classes + pred[keep]
    return torch.bincount(idx, minlength=num_classes * num_classes).reshape(num_classes, num_classes)


def iou_from_confusion(cm: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(per-class IoU [C] float64, presence mask [C]: the class is in the GT)."""
    inter = torch.diagonal(cm)
    union = cm.sum(dim=0) + cm.sum(dim=1) - inter
    present = cm.sum(dim=1) > 0
    iou = torch.where(union > 0, inter.double() / union.clamp_min(1).double(), torch.zeros((), dtype=torch.float64))
    return iou, present


def _mean_present(cm: torch.Tensor) -> float:
    iou, present = iou_from_confusion(cm)
    return float(iou[present].sum() / max(int(present.sum()), 1))


def mean_iou(pred, gt, num_classes: int, ignore_label: int = 255) -> float:
    """mIoU over the classes present in the GT."""
    return _mean_present(confusion_matrix(pred, gt, num_classes, ignore_label))


def _vc_windows(pred: torch.Tensor, gt: torch.Tensor, clip_len: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-window (numerator, denominator) int64 counts, [T - clip_len + 1]
    each: |pred-consistent and gt-consistent| and |gt-consistent|, where
    consistent means one label across every frame of the window."""
    num, den = [], []
    for s in range(gt.shape[0] - clip_len + 1):
        p, g = pred[s:s + clip_len], gt[s:s + clip_len]
        gt_consistent = (g == g[:1]).all(dim=0)
        pred_consistent = (p == p[:1]).all(dim=0)
        num.append((pred_consistent & gt_consistent).sum())
        den.append(gt_consistent.sum())
    return torch.stack(num), torch.stack(den)


def video_consistency(pred, gt, clip_len: int = 8) -> Optional[float]:
    """mVC_c of one video, pred / gt [T, H, W]; None if T < clip_len or no
    window has a GT-consistent pixel (the official code's 0/0 under a
    nanmean)."""
    pred, gt = _as_tensor(pred), _as_tensor(gt)
    if gt.shape[0] < clip_len:
        return None
    num, den = _vc_windows(pred, gt, clip_len)
    valid = den > 0
    if not bool(valid.any()):
        return None
    return float((num[valid].double() / den[valid].double()).sum() / int(valid.sum()))


class SegmentationEvaluator:
    """Accumulates a sweep's per-video (pred, gt) label maps; reads mIoU,
    mVC_8 and mVC_16 at the end."""

    def __init__(self, num_classes: int, ignore_label: int = 255):
        self.num_classes = num_classes
        self.ignore_label = ignore_label
        self._cm: Optional[torch.Tensor] = None
        self._vc8 = []
        self._vc16 = []

    def add_video(self, pred, gt):
        pred, gt = _as_tensor(pred), _as_tensor(gt)
        cm = confusion_matrix(pred, gt, self.num_classes, self.ignore_label)
        self._cm = cm if self._cm is None else self._cm + cm
        for store, c in ((self._vc8, 8), (self._vc16, 16)):
            vc = video_consistency(pred, gt, c)
            if vc is not None:
                store.append(vc)

    @property
    def confusion(self) -> Optional[torch.Tensor]:
        return self._cm

    @property
    def has_videos(self) -> bool:
        return self._cm is not None

    def results(self):
        if self._cm is None:
            return {}
        out = {"mIoU": _mean_present(self._cm)}
        if self._vc8:
            out["mVC_8"] = sum(self._vc8) / len(self._vc8)
        if self._vc16:
            out["mVC_16"] = sum(self._vc16) / len(self._vc16)
        return out
