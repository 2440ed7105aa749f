"""Frame/video IO: loading, %64 resizing, PNG output trees (numpy + PIL).

The port's own copy of vidseg_diffusion_tpu/io/video.py.

Counterpart of the reference's PIL/cv2 frame handling
(svd_single_video_inference.py:220-245 loading + %64 resize; :174-190 frame
writing; feature_extraction.py:79-110 mask PNG trees).
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
from PIL import Image


def list_video_frames(input_video_path: str) -> List[str]:
    """Sorted frame paths (numeric stem sort, svd_single_video_inference.py
    :222-224)."""
    names = [
        f for f in os.listdir(input_video_path)
        if f.endswith(".png") or f.endswith(".jpg")
    ]
    names = sorted(names, key=lambda x: int(x.split(".")[0]))
    return [os.path.join(input_video_path, f) for f in names]


def load_frames(
    paths: Sequence[str],
) -> Tuple[np.ndarray, List[str], Tuple[int, int]]:
    """Load frames, RGBA→RGB, resize down to multiples of 64 (PIL default
    bicubic resample, :238-240). Returns ([T, H, W, 3] float32 in [-1, 1],
    frame names, original (h, w))."""
    imgs, names = [], []
    ori_hw = None
    for p in paths:
        img = Image.open(p)
        if img.mode != "RGB":
            img = img.convert("RGB")
        w, h = img.size
        if ori_hw is None:
            ori_hw = (h, w)
        if h % 64 != 0 or w % 64 != 0:
            img = img.resize((w - w % 64, h - h % 64))
        imgs.append(np.asarray(img, dtype=np.float32) / 255.0 * 2.0 - 1.0)
        names.append(os.path.basename(p).split(".")[0])
    return np.stack(imgs), names, ori_hw


def save_frames_png(
    frames: np.ndarray,  # [T, H, W, 3] in [0, 1]
    folder: str,
    frame_names: Sequence[str],
    ori_hw: Optional[Tuple[int, int]] = None,
    writer=None,
):
    """Write per-frame PNGs, optionally resized back to the original size
    (cv2.resize in the reference, :183-190; PIL bilinear here). With a
    ParallelFrameWriter the encodes run off-thread (GIL-free native codec)."""
    os.makedirs(folder, exist_ok=True)
    arr = np.clip(frames * 255.0, 0, 255).astype(np.uint8)
    for i, name in enumerate(frame_names):
        px = arr[i]
        if ori_hw is not None:
            px = np.asarray(
                Image.fromarray(px).resize((ori_hw[1], ori_hw[0]), Image.BILINEAR)
            )
        path = os.path.join(folder, f"{name}.png")
        if writer is not None:
            writer.submit(path, px)
        else:
            from vidseg_diffusion_tpu_torch.io.native import write_png

            write_png(path, px)


def save_binary_masks(
    masks: np.ndarray,  # [K, T, h, w] 0/1
    folder: str,
    frame_names: Sequence[str],
    feature_timestep: int,
    labels: Optional[Sequence[int]] = None,
):
    """Reference mask tree: {folder}/kmeans_time_{t}_frame_{name}/mask_{i}.png
    (feature_extraction.py:73-85)."""
    from vidseg_diffusion_tpu_torch.io.native import ParallelFrameWriter

    k, t = masks.shape[:2]
    label_ids = labels if labels is not None else range(k)
    writer = ParallelFrameWriter(workers=4)
    for fi, name in enumerate(frame_names):
        sub = os.path.join(folder, f"kmeans_time_{feature_timestep}_frame_{name}")
        os.makedirs(sub, exist_ok=True)
        for ki, lab in enumerate(label_ids):
            m = (masks[ki, fi] * 255).astype(np.uint8)
            writer.submit(os.path.join(sub, f"mask_{int(lab)}.png"), m)
    writer.close()


def save_label_maps(
    seg: np.ndarray,  # [T, h, w] int labels
    folder: str,
    frame_names: Sequence[str],
    color_map: Optional[np.ndarray] = None,
    color_folder: Optional[str] = None,
):
    """Raw-label PNGs (external eval input, process_output.py:159-161) and
    optional colorized maps."""
    os.makedirs(folder, exist_ok=True)
    for i, name in enumerate(frame_names):
        Image.fromarray(seg[i].astype(np.uint8)).save(
            os.path.join(folder, f"{name}.png")
        )
    if color_map is not None and color_folder is not None:
        os.makedirs(color_folder, exist_ok=True)
        for i, name in enumerate(frame_names):
            Image.fromarray(color_map[seg[i] % len(color_map)]).save(
                os.path.join(color_folder, f"{name}.jpg")
            )
