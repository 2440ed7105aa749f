"""Datasets and host -> device prefetch (PyTorch).

The port's own copy of vidseg_diffusion_tpu/io/data.py (the reference's
sgm/data webdataset shim and toy data modules, training-only there,
dataset.py:8-17): VideoFolderDataset over <video>/origin frame folders,
synthetic_image_dataset and batch_iterator (seeded numpy, the same order as
JAX's), brace_expand, ShardedTarDataset (webdataset semantics: grouping by
path-qualified key, last-extension decoding, reservoir shuffle, per-process
shard slicing) and batched. prefetch_to_device is a background thread that
keeps a bounded queue of batches already on the device: numpy arrays become
tensors, pinned in host memory when the device is a card, and move with
non_blocking copies.
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Callable, Iterator, Optional, Sequence

import numpy as np
import torch


def _to_device(item, device: torch.device):
    """numpy arrays and tensors in `item` (or its tuple / list / dict) on
    `device`; other leaves unchanged."""
    if isinstance(item, np.ndarray) and item.dtype != object:
        item = torch.from_numpy(np.ascontiguousarray(item))
    if isinstance(item, torch.Tensor):
        if device.type == "cuda":
            return item.pin_memory().to(device, non_blocking=True)
        return item.to(device)
    if isinstance(item, (tuple, list)):
        return type(item)(_to_device(x, device) for x in item)
    if isinstance(item, dict):
        return {k: _to_device(v, device) for k, v in item.items()}
    return item


def prefetch_to_device(iterator: Iterator, size: int = 2, device="cuda") -> Iterator:
    """Batches of `iterator` on `device` (the card unless the caller asks for
    the CPU), in order: a background thread stages up to `size` of them
    while the current one computes. An exception in the producer is raised
    in the consumer."""
    device = torch.device(device)
    q: "queue.Queue" = queue.Queue(maxsize=size)
    sentinel = object()

    def producer():
        try:
            for item in iterator:
                q.put(_to_device(item, device))
            q.put(sentinel)
        except BaseException as e:  # noqa: BLE001 - re-raised in the consumer
            q.put(e)

    threading.Thread(target=producer, daemon=True).start()
    while True:
        item = q.get()
        if item is sentinel:
            return
        if isinstance(item, BaseException):
            raise item
        yield item


def _process_slot():
    """(rank, world size) of this process for shard slicing."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class VideoFolderDataset:
    """Iterates (frames [T,H,W,3] in [-1,1], names, video_name) over a VSPW-
    style root of <video>/origin frame folders."""

    def __init__(
        self,
        root: str,
        video_names: Optional[Sequence[str]] = None,
        subdir: str = "origin",
    ):
        self.root = root
        self.subdir = subdir
        if video_names is None:
            video_names = sorted(
                d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d))
            )
        self.video_names = list(video_names)

    def __len__(self):
        return len(self.video_names)

    def __iter__(self):
        from vidseg_diffusion_tpu_torch.io.video import list_video_frames, load_frames

        for name in self.video_names:
            d = os.path.join(self.root, name, self.subdir)
            if not os.path.isdir(d):
                d = os.path.join(self.root, name)
            paths = list_video_frames(d)
            frames, fnames, ori_hw = load_frames(paths)
            yield frames, fnames, name, ori_hw


def synthetic_image_dataset(
    n: int, shape=(32, 32, 3), num_classes: int = 10, seed: int = 0
):
    """Toy in-memory dataset (MNIST/CIFAR stand-in; the reference's toy data
    modules download via torchvision, unavailable offline)."""
    rng = np.random.RandomState(seed)
    x = rng.rand(n, *shape).astype(np.float32) * 2.0 - 1.0
    y = rng.randint(0, num_classes, n)
    return x, y


def batch_iterator(x: np.ndarray, y: np.ndarray, batch: int, seed: int = 0):
    rng = np.random.RandomState(seed)
    n = x.shape[0]
    while True:
        idx = rng.permutation(n)
        for s in range(0, n - batch + 1, batch):
            sel = idx[s : s + batch]
            yield x[sel], y[sel]


# ---------------------------------------------------------------------------
# Sharded-tar streaming dataset (webdataset semantics)
# ---------------------------------------------------------------------------
# The reference delegates to webdataset via the missing `sdata` submodule
# (sgm/data/dataset.py:8-17 hard-exits without it). This is the equivalent
# reader, self-contained: brace-expanded shard lists, sequential tar
# streaming, sample grouping by key, extension-keyed decoding, reservoir
# shuffle, and per-process shard slicing (the torch.distributed rank and world
# size, one process when none is initialised).


def brace_expand(pattern: str) -> list:
    """webdataset-style "{000..009}" brace expansion (single range)."""
    import re

    m = re.search(r"\{(\d+)\.\.(\d+)\}", pattern)
    if not m:
        return [pattern]
    lo, hi = m.group(1), m.group(2)
    width = len(lo)
    return [
        pattern[: m.start()] + str(i).zfill(width) + pattern[m.end():]
        for i in range(int(lo), int(hi) + 1)
    ]


def _default_decode(name: str, data: bytes):
    # decode by the LAST extension (webdataset semantics): a multi-suffix
    # member like `key.seg.png` is still a png — the full post-key suffix
    # ("seg.png") remains the sample-dict key (grouping happens upstream)
    ext = name.rsplit(".", 1)[-1].lower()
    if ext in ("jpg", "jpeg", "png", "ppm", "bmp", "webp"):
        import io as _io

        from PIL import Image

        return np.asarray(Image.open(_io.BytesIO(data)).convert("RGB"))
    if ext in ("cls", "id"):
        return int(data)
    if ext == "json":
        import json

        return json.loads(data)
    if ext in ("npy", "npz"):
        import io as _io

        return np.load(_io.BytesIO(data), allow_pickle=False)
    if ext in ("txt", "text", "caption"):
        return data.decode("utf-8")
    return data


class ShardedTarDataset:
    """Streaming reader over tar shards, one sample per basename key.

    Files `key.ext` within a shard are grouped into `{"__key__": key,
    ext: decoded}` dicts (webdataset's grouping contract). Shards stream
    sequentially (`tarfile 'r|'`) so samples never materialize the whole
    shard; `shuffle` applies a reservoir buffer over samples. With
    `shard_by_process=True` the shard list is sliced
    `[process_index::process_count]` so each host ingests a disjoint subset
    — the DP ingest layout for a multi-host mesh."""

    def __init__(
        self,
        shards,                       # pattern str or list of paths
        decode: Optional[Callable] = None,
        shuffle: int = 0,             # reservoir size; 0 = in-order
        seed: int = 0,
        shard_by_process: bool = False,
        repeat: bool = False,
    ):
        if isinstance(shards, str):
            shards = brace_expand(shards)
        self.shards = list(shards)
        if shard_by_process:
            rank, world = _process_slot()
            self.shards = self.shards[rank::world]
        self.decode = decode or _default_decode
        self.shuffle = shuffle
        self.seed = seed
        self.repeat = repeat

    def _iter_samples(self, rng: np.random.RandomState):
        import tarfile

        shards = list(self.shards)
        if self.shuffle:
            rng.shuffle(shards)
        for shard in shards:
            with tarfile.open(shard, mode="r|*") as tf:
                key, sample = None, {}
                for member in tf:
                    if not member.isfile():
                        continue
                    base = os.path.basename(member.name)
                    stem, _, ext = base.partition(".")
                    # webdataset keys are PATH-qualified (dir/stem): two
                    # videos' `0001.png` in different subdirs must not
                    # merge into one sample
                    d = os.path.dirname(member.name)
                    k = f"{d}/{stem}" if d else stem
                    if key is not None and k != key:
                        yield sample
                        sample = {}
                    key = k
                    sample["__key__"] = k
                    data = tf.extractfile(member).read()
                    sample[ext] = self.decode(base, data)
                if sample:
                    yield sample

    def __iter__(self):
        rng = np.random.RandomState(self.seed)
        while True:
            it = self._iter_samples(rng)
            if not self.shuffle:
                yield from it
            else:
                buf = []
                for sample in it:
                    if len(buf) < self.shuffle:
                        buf.append(sample)
                        continue
                    j = rng.randint(0, len(buf))
                    buf[j], sample = sample, buf[j]
                    yield sample
                rng.shuffle(buf)
                yield from buf
            if not self.repeat:
                return


def batched(iterator: Iterator, batch: int, keys: Optional[Sequence[str]] = None):
    """Collate dict samples into stacked-array batches of size `batch`
    (drops the final partial batch, webdataset .batched semantics)."""
    buf = []
    for sample in iterator:
        buf.append(sample)
        if len(buf) == batch:
            ks = keys or [k for k in buf[0] if k != "__key__"]
            yield {k: np.stack([b[k] for b in buf]) for k in ks}
            buf = []
