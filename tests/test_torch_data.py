"""The port's data readers, prefetch, profiling utilities and CamVid palette
(vidseg_diffusion_tpu_torch/io/data.py, utils/profiling.py,
engine/segmentation.camvid_color_map) against the JAX package's, mirroring
tests/test_sharded_tar.py and tests/test_aux_modules.py (TestData,
TestProfiling, test_camvid_color_map, test_video_folder_dataset).

Everything compared is exact: the same samples in the same seeded order,
the same decoded arrays, the same palette. prefetch_to_device runs to the
CPU here (the card is chip_smoke.py's `safety` phase).
"""

import io
import json
import os
import tarfile
import time

import numpy as np
import pytest
import torch

from vidseg_diffusion_tpu.engine.segmentation import camvid_color_map as j_camvid
from vidseg_diffusion_tpu.io import data as jdata
from vidseg_diffusion_tpu_torch.engine.segmentation import camvid_color_map
from vidseg_diffusion_tpu_torch.io import data as tdata
from vidseg_diffusion_tpu_torch.utils import profiling


def _write_shard(path, keys, px=4, subdir=""):
    from PIL import Image

    with tarfile.open(path, "w") as tf:
        for i, key in enumerate(keys):
            buf = io.BytesIO()
            Image.fromarray(np.full((px, px, 3), i * 10 % 255, np.uint8)).save(buf, format="PNG")
            for name, data in ((f"{key}.png", buf.getvalue()), (f"{key}.cls", str(i % 3).encode()),
                               (f"{key}.json", json.dumps({"i": i}).encode()), (f"{key}.seg.png", buf.getvalue())):
                ti = tarfile.TarInfo(os.path.join(subdir, name))
                ti.size = len(data)
                tf.addfile(ti, io.BytesIO(data))


def _same_samples(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            np.testing.assert_array_equal(np.asarray(g[k]), np.asarray(w[k]))


@pytest.mark.parametrize("pattern", ["s-{000..002}.tar", "plain.tar", "x-{8..11}.tar"])
def test_brace_expand(pattern):
    assert tdata.brace_expand(pattern) == jdata.brace_expand(pattern)


def test_grouping_and_decoding(tmp_path):
    shard = str(tmp_path / "s-000.tar")
    _write_shard(shard, [f"k{i:03d}" for i in range(5)])
    got = list(tdata.ShardedTarDataset([shard]))
    _same_samples(got, list(jdata.ShardedTarDataset([shard])))
    assert got[0]["__key__"] == "k000" and got[0]["png"].shape == (4, 4, 3) and got[2]["cls"] == 2
    assert got[1]["json"] == {"i": 1} and got[3]["seg.png"].shape == (4, 4, 3)


def test_path_qualified_keys(tmp_path):
    shard = str(tmp_path / "s.tar")
    _write_shard(shard, ["0001"], subdir="vidA")
    with tarfile.open(shard, "a") as tf:
        data = b"7"
        ti = tarfile.TarInfo("vidB/0001.cls")
        ti.size = len(data)
        tf.addfile(ti, io.BytesIO(data))
    got = list(tdata.ShardedTarDataset([shard]))
    _same_samples(got, list(jdata.ShardedTarDataset([shard])))
    assert [s["__key__"] for s in got] == ["vidA/0001", "vidB/0001"]


def test_multi_shard_pattern_and_batching(tmp_path):
    for i in range(3):
        _write_shard(str(tmp_path / f"s-{i:03d}.tar"), [f"s{i}k{j}" for j in range(4)])
    pattern = str(tmp_path / "s-{000..002}.tar")
    got = list(tdata.batched(iter(tdata.ShardedTarDataset(pattern)), 4, keys=["png", "cls"]))
    want = list(jdata.batched(iter(jdata.ShardedTarDataset(pattern)), 4, keys=["png", "cls"]))
    _same_samples(got, want)
    assert len(got) == 3 and got[0]["png"].shape == (4, 4, 4, 3) and got[0]["cls"].shape == (4,)


@pytest.mark.parametrize("seed", [1, 2])
def test_reservoir_shuffle_order_equals_jax(tmp_path, seed):
    shards = []
    for i in range(2):
        shards.append(str(tmp_path / f"s-{i}.tar"))
        _write_shard(shards[-1], [f"s{i}k{j:03d}" for j in range(10)])
    got = [s["__key__"] for s in tdata.ShardedTarDataset(shards, shuffle=8, seed=seed)]
    want = [s["__key__"] for s in jdata.ShardedTarDataset(shards, shuffle=8, seed=seed)]
    assert got == want and sorted(got) != got and len(set(got)) == 20


def test_repeat_and_shard_by_process(tmp_path):
    shard = str(tmp_path / "s-000.tar")
    _write_shard(shard, ["a", "b"])
    it = iter(tdata.ShardedTarDataset([shard], repeat=True))
    assert [next(it)["__key__"] for _ in range(5)] == ["a", "b", "a", "b", "a"]
    # one process (no torch.distributed group): every shard, as JAX's single process
    assert tdata.ShardedTarDataset(["a", "b", "c"], shard_by_process=True).shards == \
        jdata.ShardedTarDataset(["a", "b", "c"], shard_by_process=True).shards == ["a", "b", "c"]


def test_synthetic_dataset_and_batches_equal_jax():
    got, want = tdata.synthetic_image_dataset(20, (8, 8, 3), 4, seed=3), jdata.synthetic_image_dataset(20, (8, 8, 3), 4,
                                                                                                       seed=3)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    it_t, it_j = tdata.batch_iterator(*got, 5, seed=1), jdata.batch_iterator(*want, 5, seed=1)
    for _ in range(6):   # past one epoch
        for g, w in zip(next(it_t), next(it_j)):
            np.testing.assert_array_equal(g, w)


def test_prefetch_preserves_order_on_the_device():
    items = [(np.full((2,), i, np.float32), {"label": np.int64(i), "name": f"v{i}"}) for i in range(6)]
    out = list(tdata.prefetch_to_device(iter(items), size=2, device="cpu"))
    assert len(out) == 6
    for i, (x, d) in enumerate(out):
        assert isinstance(x, torch.Tensor) and x.device.type == "cpu"
        np.testing.assert_array_equal(x.numpy(), np.full((2,), i, np.float32))
        assert d["name"] == f"v{i}"


def test_prefetch_raises_the_producers_error():
    def broken():
        yield np.zeros(2)
        raise RuntimeError("shard 3 is corrupt")

    it = tdata.prefetch_to_device(broken(), device="cpu")
    next(it)
    with pytest.raises(RuntimeError, match="corrupt"):
        next(it)


def test_video_folder_dataset_equals_jax(tmp_path):
    from PIL import Image

    for vid in ("vidB", "vidA"):
        d = tmp_path / vid / "origin"
        d.mkdir(parents=True)
        for i in range(3):
            Image.fromarray(np.full((64, 64, 3), i * 10 + (vid == "vidB"), np.uint8)).save(d / f"{i}.png")
    got, want = list(tdata.VideoFolderDataset(str(tmp_path))), list(jdata.VideoFolderDataset(str(tmp_path)))
    assert len(tdata.VideoFolderDataset(str(tmp_path))) == 2
    assert [g[2] for g in got] == [w[2] for w in want] == ["vidA", "vidB"]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g[0]), np.asarray(w[0]))
        assert list(g[1]) == list(w[1]) == ["0", "1", "2"] and tuple(g[3]) == tuple(w[3])


def test_step_timer(tmp_path):
    t = profiling.StepTimer()
    out = t.measure("op", lambda: torch.ones(8) * 2)
    assert torch.equal(out, torch.full((8,), 2.0))
    with t.time("stage") as done:
        time.sleep(0.01)
        done((torch.zeros(2), {"x": torch.ones(1)}))
    s = t.summary()
    assert s["op"]["count"] == 1 and s["op"]["mean_s"] > 0 and s["stage"]["min_s"] >= 0.01
    t.dump(str(tmp_path / "steps.json"))
    with open(tmp_path / "steps.json") as f:
        assert json.load(f) == json.loads(json.dumps(s))


def test_trace_writes_a_chrome_trace_naming_its_spans(tmp_path):
    with profiling.trace(str(tmp_path / "trace")):
        with profiling.annotate("vs:probe"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    with open(tmp_path / "trace" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "vs:probe" for e in events)


def test_camvid_color_map_equals_jax():
    got, want = camvid_color_map(), j_camvid()
    assert got.dtype == np.uint8 and got.shape == want.shape == (32, 3)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[0], [64, 128, 64])
