"""VSPW dataset sweep (PyTorch port of pipelines/vspw.py): sliding-window
batches, GT-seeded label propagation, per-video fault isolation, and mIoU /
mVC evaluation on the fly.

Counterpart of scripts/sampling/svd_pipeline_vspw.py / sd_pipeline_vspw.py:
- 14-frame sliding windows with tail overlap (the last partial window
  re-aligned to end at the last frame, svd_pipeline_vspw.py:243-250);
- the first window seeds labels from the first frame's GT mask
  (`video_dir.replace("origin", "mask")`), later windows propagate them by
  KNN against the carried GTMatchState (:229-232; feature_extraction.py
  :567-613);
- a video that raises is journaled as failed and the sweep goes on
  (:651-676); a JSON-lines manifest makes a re-run skip finished videos;
  --exp_start_idx / --num_exp slice the video list (:610-611, 645-647);
- evaluation (mIoU, mVC_8 / mVC_16, eval/metrics.py).

One device: the JAX package's device mesh, its per-host sharding and its
thread pool are TPU scale-out and are not ported (ROADMAP, "Not to port").
"""

from __future__ import annotations

import dataclasses
import json
import os
import traceback
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
from PIL import Image

from vidseg_diffusion_tpu_torch.engine.build import Pipeline
from vidseg_diffusion_tpu_torch.eval.metrics import SegmentationEvaluator
from vidseg_diffusion_tpu_torch.io.video import list_video_frames, load_frames
from vidseg_diffusion_tpu_torch.parallel.mesh import process_slice
from vidseg_diffusion_tpu_torch.pipelines.single_video import VidSegArgs, cluster_feature_hw, run_single_video

GT_EXTENSIONS = (".png", ".jpg")


def sliding_batches(n: int, num_frames: int) -> List[Tuple[int, int]]:
    """[(start, end)] windows covering n frames; the final partial window is
    re-aligned to end at n (tail overlap, svd_pipeline_vspw.py:243-250)."""
    out = []
    start = 0
    while start < n:
        end = start + num_frames
        if end > n:
            end = n
            start = max(0, end - num_frames)
        out.append((start, end))
        if end >= n:
            break
        start = end
    return out


def _gt_path(video_dir: str, frame_name: str) -> Optional[str]:
    mask_dir = video_dir.replace("origin", "mask")
    for ext in GT_EXTENSIONS:
        p = os.path.join(mask_dir, frame_name + ext)
        if os.path.exists(p):
            return p
    return None


def load_label_image(path: str, fh: int, fw: int) -> np.ndarray:
    """A GT label image at feature resolution, flat [fh * fw] (PIL NEAREST,
    feature_extraction.py:580-584)."""
    return np.asarray(Image.open(path).resize((fw, fh), Image.NEAREST)).reshape(-1)


def load_gt_mask(video_dir: str, frame_name: str, fh: int, fw: int) -> Optional[np.ndarray]:
    """A frame's GT mask at feature resolution (load_label_image), from
    .../mask/ beside .../origin/; None when the frame has none."""
    p = _gt_path(video_dir, frame_name)
    return None if p is None else load_label_image(p, fh, fw)


@dataclasses.dataclass
class VSPWVideoResult:
    seg: Dict[str, np.ndarray]  # frame name -> label map, in the loader's frame order
    unique_labels: np.ndarray


def run_vspw_video(
    pipeline: Pipeline,
    video_dir: str,
    args: VidSegArgs,
    num_frames: int = 14,
    text_tokens: Optional[np.ndarray] = None,
    timings: Optional[Dict[str, float]] = None,   # out-param: stage seconds summed over the windows
) -> VSPWVideoResult:
    """One video in sliding windows, the GT match state carried from each
    window to the next; a frame of two windows keeps the later label map.
    With match_gt_mask the first window is seeded by the first frame's GT."""
    frames_all, names_all, ori_hw = load_frames(list_video_frames(video_dir))
    fh, fw = cluster_feature_hw(pipeline, args, frames_all.shape[1], frames_all.shape[2], num_frames)
    seg_out: Dict[str, np.ndarray] = {}
    gt_state = None
    unique_labels = None
    for bi, (s, e) in enumerate(sliding_batches(len(names_all), num_frames)):
        names = names_all[s:e]
        gt_mask = None
        if bi == 0 and args.feature_extraction_mode == "match_gt_mask":
            gt_mask = load_gt_mask(video_dir, names_all[0], fh, fw)
        window_timings: Optional[Dict[str, float]] = {} if timings is not None else None
        result = run_single_video(pipeline, frames_all[s:e], names, args, ori_hw=ori_hw, gt_mask=gt_mask,
                                  gt_state=gt_state, text_tokens=text_tokens, write_outputs=False,
                                  timings=window_timings)
        if timings is not None:
            for k, v in window_timings.items():
                timings[k] = timings.get(k, 0.0) + v
        gt_state = result.gt_state
        unique_labels = result.unique_labels
        for i, name in enumerate(names):
            seg_out[name] = result.seg_filtered[i]
    return VSPWVideoResult(seg=seg_out, unique_labels=unique_labels)


def _done_in_manifest(manifest_path: Optional[str]) -> set:
    done = set()
    if manifest_path and os.path.exists(manifest_path):
        with open(manifest_path) as f:
            for line in f:
                try:
                    rec = json.loads(line)
                    if rec.get("status") == "done":
                        done.add(rec["video"])
                except (ValueError, KeyError, AttributeError):   # a torn or foreign line
                    continue
    return done


def run_vspw_sweep(
    pipeline: Pipeline,
    data_root: str,
    video_names: Sequence[str],
    args: VidSegArgs,
    num_frames: int = 14,
    exp_start_idx: int = 0,
    num_exp: Optional[int] = None,
    text_tokens: Optional[np.ndarray] = None,
    num_classes: int = 124,
    evaluate: bool = True,
    manifest_path: Optional[str] = None,
    process_shard: bool = False,
) -> Dict:
    """Sweep <data_root>/<video>/origin for the named videos, skipping failed
    ones (svd_pipeline_vspw.py:651-676) and scoring the label maps against
    <video>/mask when every frame has one.

    `manifest_path` journals each video as a JSON line ("done" or "failed"); a
    re-run skips the done ones and does not score them again, so its metrics
    cover the fresh videos only (`metrics_partial`). `process_shard` cuts the
    video list (after exp_start_idx / num_exp) to this process's contiguous
    share of the process group (parallel/mesh.py::process_slice) before the
    manifest is read, as JAX :200-203 does: each process runs and scores its
    own videos, and nothing is gathered."""
    names = list(video_names)[exp_start_idx:]
    if num_exp is not None:
        names = names[:num_exp]
    if process_shard:
        names = names[process_slice(len(names))]
    already = _done_in_manifest(manifest_path)

    def journal(rec):
        if manifest_path:
            os.makedirs(os.path.dirname(manifest_path) or ".", exist_ok=True)
            with open(manifest_path, "a") as f:
                f.write(json.dumps(rec) + "\n")

    evaluator = SegmentationEvaluator(num_classes) if evaluate else None
    done = evaluated = 0
    failed: List[Tuple[str, str]] = []
    skipped = sum(1 for v in names if v in already)
    for vname in (v for v in names if v not in already):
        video_dir = os.path.join(data_root, vname, "origin")
        try:
            res = run_vspw_video(pipeline, video_dir, args, num_frames=num_frames, text_tokens=text_tokens)
            if evaluate:
                # scored before "done" is journaled: a scoring error journals the video as failed
                pred, gt = _load_gt_for_eval(video_dir, res)
                if pred is not None:
                    evaluator.add_video(pred, gt)
                    evaluated += 1
            done += 1
            journal({"video": vname, "status": "done"})
        except Exception as e:  # per-video fault isolation
            traceback.print_exc()
            failed.append((vname, str(e)))
            journal({"video": vname, "status": "failed", "error": str(e)})
    out = {"videos_done": done, "videos_failed": failed, "videos_skipped": skipped}
    if evaluate and evaluator.has_videos:
        out.update(evaluator.results())
        out["videos_evaluated"] = evaluated
        if skipped:
            out["metrics_partial"] = True
    return out


def _load_gt_for_eval(video_dir: str, res: VSPWVideoResult):
    """(pred [T, H, W], gt [T, H, W]) in the loader's numeric frame order, the
    GT nearest-resized to the label maps where their sizes differ; (None,
    None) when a frame has no GT."""
    preds, gts = [], []
    for name, seg in res.seg.items():
        p = _gt_path(video_dir, name)
        if p is None:
            return None, None
        img = Image.open(p)
        gt = np.asarray(img)
        if gt.shape != seg.shape:
            gt = np.asarray(img.resize((seg.shape[1], seg.shape[0]), Image.NEAREST))
        preds.append(seg)
        gts.append(gt)
    return np.stack(preds), np.stack(gts)
