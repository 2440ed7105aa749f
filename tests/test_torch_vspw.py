"""The VSPW sweep of the PyTorch port against the JAX package, on the CPU:
the sliding windows, the GT loader, the metrics, run_vspw_sweep and both
sweep CLIs (match_gt_mask and is_refine_mask through run_single_video are in
test_torch_masks.py; the shared set-up in torch_vspw_parity.py).

The pipelines are configs/inference/svd_tiny.yaml and sd_tiny.yaml with the
JAX pipeline's random weights moved into the port (io/convert.py). The port
is handed the random draws JAX makes from the same keys: the cond-aug noise,
the add_noise noise and, in a first window, the k-means initial centres drawn
on JAX's own cluster features (captured by wrapping the JAX package's
match_gt_mask; the JAX package is not changed). Held exactly: the masks,
unique_labels and the carried state's labels (its features at 1e-4, the
harvest's bound); the label maps wherever JAX's top-2 margin exceeds one
uint8 quantum of the difference maps (as tests/test_torch_pipeline.py holds
them: a decode difference of 1e-5 can move a truncation by one quantum); the
metrics at 1e-6 on the same maps.
"""

import argparse
import importlib.util
import json
import os
import types
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from torch_vspw_parity import FLAGS, GT_IDS, ROOT, SD, SVD, Draws, _make_video, _pair, _sure
from vidseg_diffusion_tpu.eval import metrics as jmetrics
from vidseg_diffusion_tpu.pipelines import single_video as jsv
from vidseg_diffusion_tpu.pipelines import vspw as jvspw
from vidseg_diffusion_tpu_torch.eval import metrics as tmetrics
from vidseg_diffusion_tpu_torch.pipelines import single_video as tsv
from vidseg_diffusion_tpu_torch.pipelines import vspw as tvspw
from vidseg_diffusion_tpu_torch.scripts import sd_pipeline_vspw as sd_cli
from vidseg_diffusion_tpu_torch.scripts import svd_pipeline_vspw as svd_cli

T = 3
NUM_CLASSES = 8


@pytest.fixture(scope="module")
def svd_pair():
    return _pair(SVD)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- sliding windows, the GT loader ------------------------------------------------


@pytest.mark.parametrize("num_frames", [3, 14])
def test_sliding_batches_match_jax(num_frames):
    for n in range(1, 41):
        got = tvspw.sliding_batches(n, num_frames)
        assert got == jvspw.sliding_batches(n, num_frames)
        assert got[-1][1] == n and all(e - s == min(n, num_frames) for s, e in got)


@pytest.mark.parametrize("ext", [".png", ".jpg", None])
def test_load_gt_mask_matches_jax(tmp_path, ext):
    odir = tmp_path / "v" / "origin"
    mdir = tmp_path / "v" / "mask"
    odir.mkdir(parents=True), mdir.mkdir()
    gt = np.random.RandomState(0).randint(0, 9, (37, 53)).astype(np.uint8)
    if ext is not None:
        Image.fromarray(gt).save(mdir / f"00012{ext}", quality=100)
    got = tvspw.load_gt_mask(str(odir), "00012", 6, 7)
    want = jvspw.load_gt_mask(str(odir), "00012", 6, 7)
    if ext is None:
        assert got is None and want is None
        return
    assert got.shape == (42,)
    np.testing.assert_array_equal(got, want)


# -- metrics --------------------------------------------------------------------------


def _maps(seed, t=20, h=12, w=10, c=5):
    rs = np.random.RandomState(seed)
    gt = rs.randint(0, c, (t, h, w)).astype(np.uint8)
    gt[:, :4] = gt[:1, :4]            # temporally consistent regions, so mVC has windows
    gt[rs.rand(t, h, w) < 0.05] = 255
    pred = np.where(rs.rand(t, h, w) < 0.7, gt, rs.randint(0, c, (t, h, w))).astype(np.uint8)
    pred[gt == 255] = rs.randint(0, c)
    return pred, gt


@pytest.mark.parametrize("t", [5, 9, 20])
def test_metrics_match_jax(t):
    """confusion_matrix exactly; IoU, mIoU, mVC_8 / mVC_16 (None below the
    window) and the evaluator over two videos at 1e-6."""
    c = 5
    pred, gt = _maps(t, t=t, c=c)
    cm = tmetrics.confusion_matrix(torch.from_numpy(pred), torch.from_numpy(gt), c)
    jcm = jmetrics.confusion_matrix(jnp.asarray(pred), jnp.asarray(gt), c)
    assert cm.dtype == torch.int64
    np.testing.assert_array_equal(cm.numpy(), np.asarray(jcm).astype(np.int64))
    iou, present = tmetrics.iou_from_confusion(cm)
    jiou, jpresent = jmetrics.iou_from_confusion(jcm)
    np.testing.assert_allclose(iou.numpy(), np.asarray(jiou), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(present.numpy(), np.asarray(jpresent))
    assert abs(tmetrics.mean_iou(pred, gt, c) - jmetrics.mean_iou(jnp.asarray(pred), jnp.asarray(gt), c)) <= 1e-6
    for clip in (8, 16):
        got = tmetrics.video_consistency(pred, gt, clip)
        want = jmetrics.video_consistency(jnp.asarray(pred), jnp.asarray(gt), clip)
        assert (got is None) == (want is None) == (t < clip)
        assert got is None or abs(got - want) <= 1e-6
    ev, jev = tmetrics.SegmentationEvaluator(c), jmetrics.SegmentationEvaluator(c)
    for seed in (t, t + 100):
        p, g = _maps(seed, t=t, c=c)
        ev.add_video(p, g)
        jev.add_video(p, g)
    got, want = ev.results(), jev.results()
    assert got.keys() == want.keys()
    assert all(abs(got[k] - want[k]) <= 1e-6 for k in got)


def test_video_consistency_excludes_windows_without_gt_consistent_pixels():
    """A window where no GT pixel keeps its label is left out of the mean
    (the official code's nanmean); with no such window at all, None."""
    gt = np.zeros((9, 2, 2), np.uint8)
    gt[8] = 1                      # the second 8-frame window has no consistent pixel
    pred = np.zeros_like(gt)
    pred[:8, 0, 0] = np.arange(8)   # one pixel of the first window inconsistent
    assert tmetrics.video_consistency(pred, gt, 8) == 0.75
    assert jmetrics.video_consistency(jnp.asarray(pred), jnp.asarray(gt), 8) == 0.75
    gt[1::2] = 1
    assert tmetrics.video_consistency(pred, gt, 8) is None


def test_confusion_drops_predictions_outside_the_classes_as_jax():
    """A predicted 255 (carried over from a GT region) or any id >=
    num_classes is left out of the matrix, as JAX's one_hot leaves it out; an
    ignored GT pixel too."""
    gt = np.array([0, 1, 2, 2, 255, 1], np.uint8)
    pred = np.array([0, 255, 2, 7, 1, 1], np.uint8)
    want = np.zeros((3, 3), np.int64)
    want[0, 0] = want[2, 2] = want[1, 1] = 1
    np.testing.assert_array_equal(tmetrics.confusion_matrix(pred, gt, 3).numpy(), want)
    np.testing.assert_array_equal(np.asarray(jmetrics.confusion_matrix(jnp.asarray(pred), jnp.asarray(gt), 3)), want)


def test_confusion_counts_exactly_past_2_to_the_24():
    """One cell past 2**24 pixels (a 100-frame 448x832 video holds 3.7e7):
    int64 counts stay exact where fp32 counts stop being."""
    n = 2 ** 24 + 3
    ones = np.ones(n, np.uint8)
    cm = tmetrics.confusion_matrix(ones, ones, 2)
    assert cm.dtype == torch.int64 and int(cm[1, 1]) == n and int(cm.sum()) == n
    assert float(np.float32(n)) != n   # what an fp32 count of that cell would read


# -- run_single_video: match_gt_mask over two windows, is_refine_mask ------------------


# -- the sweep and its CLIs ---------------------------------------------------------


def _recording(run, sure):
    """run_single_video that records, per frame name, the pixels JAX's
    difference maps decide (the later window's, as the sweep keeps)."""
    def wrapped(*a, **kw):
        res = run(*a, **kw)
        sure.update(zip(a[2], _sure(res)))
        return res
    return wrapped


def _jax_sweep(jp, root, names, flags, manifest, text_tokens=None, sd=False):
    """JAX's run_vspw_sweep with the CLI's VidSegArgs (single device); returns
    (output, {video: result}, draws, {frame name: decided pixels})."""
    draws = Draws(not sd, flags["num_masks"])
    maps, sure = {}, {}
    orig = jvspw.run_vspw_video

    def video(*a, **kw):
        res = orig(*a, **kw)
        maps[os.path.basename(os.path.dirname(a[1]))] = res
        return res

    mp = pytest.MonkeyPatch()
    draws.record(mp)
    mp.setattr(jvspw, "run_vspw_video", video)
    mp.setattr(jvspw, "run_single_video", _recording(jvspw.run_single_video, sure))
    try:
        vargs = jsv.VidSegArgs(mesh="off", runs_chunk=1, feature_extraction_mode="match_gt_mask",
                               sd_blend_window=sd, **({"modulate_block_idx": (7,)} if sd else {}), **flags)
        out = jvspw.run_vspw_sweep(jp, root, names, vargs, num_frames=T, num_classes=NUM_CLASSES,
                                   manifest_path=manifest, text_tokens=text_tokens)
    finally:
        mp.undo()
    return out, maps, draws, sure


def _cli_argv(root, manifest, config, flags, extra=()):
    argv = ["--data_root", root, "--num_frames", str(T), "--num_classes", str(NUM_CLASSES), "--device", "cpu",
            "--model_config", os.path.join(ROOT, config), "--manifest", manifest]
    for k in ("num_steps", "num_masks", "seed"):
        argv += [f"--{k}", str(flags[k])]
    for k in ("modulate_timestep", "feature_timestep"):
        argv += [f"--{k}", ",".join(map(str, flags[k]))]
    return argv + list(extra)


def _capturing(mp, results, evaluators):
    """Patch the port's sweep module so that each finished video's result
    lands in `results` and the sweep's evaluator in `evaluators`."""
    run_video, evaluator = tvspw.run_vspw_video, tvspw.SegmentationEvaluator

    def video(*a, **kw):
        res = run_video(*a, **kw)
        results[os.path.basename(os.path.dirname(a[1]))] = res
        return res

    def make_evaluator(*a, **kw):
        evaluators.append(evaluator(*a, **kw))
        return evaluators[-1]

    mp.setattr(tvspw, "run_vspw_video", video)
    mp.setattr(tvspw, "SegmentationEvaluator", make_evaluator)


def _port_sweep(cli, tp, argv, draws):
    """The CLI's sweep (its parser, VidSegArgs and run_vspw_sweep call) on the
    port pipeline, with JAX's draws; returns (output, video results, evaluator)."""
    args = cli.parse_args(argv)
    results, evaluators = {}, []
    with pytest.MonkeyPatch.context() as mp:
        _capturing(mp, results, evaluators)
        mp.setattr(tvspw, "run_single_video", draws.handed(tvspw.run_single_video))
        out = cli.sweep(args, tp)
    return out, results, evaluators[0]


METRICS = ("mIoU", "mVC_8", "mVC_16")


def _same_sweep(root, out, jout, results, jmaps, sure, ev):
    """Counts equal JAX's; each video's unique_labels and frame order equal,
    its label maps wherever JAX's maps are decided; the sweep's metrics equal
    JAX's evaluator on the same maps (1e-6), and JAX's own sweep metrics its
    evaluator on its maps; the sweep's confusion matrix is a recount of the
    maps it returned."""
    assert {k: v for k, v in out.items() if k not in METRICS} == {k: v for k, v in jout.items() if k not in METRICS}
    assert results.keys() == jmaps.keys()
    jev, jev_own = jmetrics.SegmentationEvaluator(NUM_CLASSES), jmetrics.SegmentationEvaluator(NUM_CLASSES)
    recount = torch.zeros((NUM_CLASSES, NUM_CLASSES), dtype=torch.int64)
    for v in results:
        assert list(results[v].seg) == list(jmaps[v].seg)
        np.testing.assert_array_equal(results[v].unique_labels, jmaps[v].unique_labels)
        for name in results[v].seg:
            assert sure[name].mean() > 0.5
            np.testing.assert_array_equal(results[v].seg[name][sure[name]], jmaps[v].seg[name][sure[name]])
        video_dir = os.path.join(root, v, "origin")
        pred, gt = tvspw._load_gt_for_eval(video_dir, results[v])
        if pred is not None:
            jev.add_video(pred, gt)
            jev_own.add_video(*jvspw._load_gt_for_eval(video_dir, jmaps[v]))
            recount += tmetrics.confusion_matrix(pred, gt, NUM_CLASSES)
    for mine, theirs in ((out, jev.results()), (jout, jev_own.results())):
        assert set(mine) & set(METRICS) == set(theirs)
        assert all(abs(mine[k] - theirs[k]) <= 1e-6 for k in theirs)
    if ev.has_videos:
        assert torch.equal(ev.confusion, recount)


def test_svd_sweep_cli_matches_jax(svd_pair, tmp_path):
    """The SVD sweep CLI's path on a tree of a 4- and a 5-frame video with
    GT masks (windows (0,3),(1,4) and (0,3),(2,5): tail overlaps and carried
    states) and a video whose origin/ is empty: label maps, unique_labels,
    counts, mIoU and mVC equal JAX's sweep; the empty video fails alone; a
    second call on the manifest skips the finished videos and runs none."""
    jp, tp = svd_pair
    root = str(tmp_path / "data")
    _make_video(root, "vid_a", 1, 4)
    _make_video(root, "vid_b", 2, 5, ext=".jpg")
    os.makedirs(os.path.join(root, "vid_c", "origin"))
    jout, jmaps, draws, sure = _jax_sweep(jp, root, ["vid_a", "vid_b", "vid_c"], FLAGS, str(tmp_path / "j.jsonl"))
    manifest = str(tmp_path / "t.jsonl")
    argv = _cli_argv(root, manifest, SVD, FLAGS)
    out, results, ev = _port_sweep(svd_cli, tp, argv, draws)
    assert [v for v, _ in out["videos_failed"]] == ["vid_c"] and out["videos_done"] == 2
    assert 0.0 <= out["mIoU"] <= 1.0 and out["videos_evaluated"] == 2
    _same_sweep(root, out, jout, results, jmaps, sure, ev)
    assert set(results["vid_a"].unique_labels) <= set(GT_IDS)   # vid_b's GT is a lossy .jpg
    recs = [json.loads(line) for line in open(manifest)]
    assert {r["video"]: r["status"] for r in recs} == {"vid_a": "done", "vid_b": "done", "vid_c": "failed"}

    calls = []
    with mock.patch.object(tvspw, "run_single_video", lambda *a, **k: calls.append(a)):
        again = svd_cli.sweep(svd_cli.parse_args(argv), tp)
    assert calls == [] and again["videos_skipped"] == 2 and again["videos_done"] == 0
    assert [v for v, _ in again["videos_failed"]] == ["vid_c"] and "mIoU" not in again


def test_sweep_without_masks_runs_and_scores_nothing(svd_pair, tmp_path):
    """A tree without mask/ (ROADMAP section C): match_gt_mask falls back to
    the clusters, every frame gets a label map, and nothing is scored."""
    _, tp = svd_pair
    root = str(tmp_path / "data")
    _make_video(root, "vid_a", 3, 4, masks=False)
    results = {}
    with pytest.MonkeyPatch.context() as mp:
        _capturing(mp, results, [])
        out = svd_cli.sweep(svd_cli.parse_args(_cli_argv(root, str(tmp_path / "m.jsonl"), SVD, FLAGS)), tp)
    assert out == {"videos_done": 1, "videos_failed": [], "videos_skipped": 0}
    assert sorted(results["vid_a"].seg, key=int) == ["0", "1", "2", "3"]
    assert set(results["vid_a"].unique_labels) <= set(range(FLAGS["num_masks"]))


def test_sd_sweep_cli_matches_jax(tmp_path):
    """The SD 2.1 sweep CLI's path (clustering block 7, modulation at its
    step, the SD blend window, the empty prompt) on sd_tiny.yaml over a
    4-frame video: equal to JAX's sweep."""
    from vidseg_diffusion_tpu.io.tokenizer import tokenize_empty as j_tokenize_empty

    jp, tp = _pair(SD)
    root = str(tmp_path / "data")
    _make_video(root, "vid_a", 4, 4)
    jout, jmaps, draws, sure = _jax_sweep(jp, root, ["vid_a"], FLAGS, str(tmp_path / "j.jsonl"),
                                    text_tokens=j_tokenize_empty(1), sd=True)
    argv = _cli_argv(root, str(tmp_path / "t.jsonl"), SD, FLAGS, extra=("--modulate_block_idx", "7"))
    out, results, ev = _port_sweep(sd_cli, tp, argv, draws)
    assert out["videos_done"] == 1 and not out["videos_failed"]
    _same_sweep(root, out, jout, results, jmaps, sure, ev)


def _jax_cli_parser(name):
    spec = importlib.util.spec_from_file_location(f"jax_cli_{name}", os.path.join(ROOT, "scripts/sampling", name))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    with mock.patch.object(argparse.ArgumentParser, "parse_args", lambda self, *a, **k: self):
        return module.parse_args()


def _flags(parser):
    return {a.dest: a.default for a in parser._actions if a.dest != "help"}


@pytest.mark.parametrize("name,cli", [("svd_pipeline_vspw.py", svd_cli), ("sd_pipeline_vspw.py", sd_cli)])
def test_sweep_cli_flags_are_jax_less_the_tpu_ones(name, cli):
    """JAX's flags less --runs_chunk and --data_groups (TPU dispatch and its
    device mesh), plus --device, which defaults to cuda; shared defaults
    equal (--dtype: bf16 on the card, as the JAX CLI's on the TPU)."""
    jflags, tflags = _flags(_jax_cli_parser(name)), _flags(cli.build_parser())
    assert set(jflags) - set(tflags) == {"runs_chunk", "data_groups"}
    assert set(tflags) - set(jflags) == {"device"} and tflags["device"] == "cuda"
    assert all(tflags[k] == jflags[k] for k in tflags if k != "device")
    args = cli.parse_args(["--data_root", "x"])
    assert args.num_masks == 20 and args.feature_extraction_mode == "match_gt_mask"


def test_single_video_cli_honours_gt_mask_path(tmp_path):
    """svd_single_video_inference with match_gt_mask loads --gt_mask_path
    nearest-resized to the clustering block's token grid and hands it to
    run_single_video; without the flag it refuses to start."""
    from vidseg_diffusion_tpu_torch.scripts import svd_single_video_inference as cli

    root = str(tmp_path / "data")
    _make_video(root, "v", 7, 3)
    gt_path = os.path.join(root, "v", "mask", "0.png")
    argv = ["--input_video_path", os.path.join(root, "v", "origin"), "--device", "cpu", "--model_config",
            os.path.join(ROOT, SVD), "--num_steps", "6", "--modulate_timestep", "3", "--feature_timestep", "5",
            "--feature_extraction_mode", "match_gt_mask", "--feature_folder", str(tmp_path / "out")]
    with pytest.raises(SystemExit, match="--gt_mask_path"):
        cli.main(argv)
    seen = {}

    def record(pipeline, frames, names, vargs, **kw):
        seen.update(kw, fh_fw=tsv.cluster_feature_hw(pipeline, vargs, frames.shape[1], frames.shape[2], len(names)))
        return types.SimpleNamespace(unique_labels=np.array(GT_IDS))

    with mock.patch.object(tsv, "run_single_video", record):
        cli.main(argv + ["--gt_mask_path", gt_path])
    fh, fw = seen["fh_fw"]
    want = np.asarray(Image.open(gt_path).resize((fw, fh), Image.NEAREST)).reshape(-1)
    np.testing.assert_array_equal(seen["gt_mask"], want)
    assert set(np.unique(want)) == set(GT_IDS)


@pytest.mark.parametrize("cli_name", ["svd_single_video_inference", "svd_pipeline_vspw", "sd_pipeline_vspw"])
def test_cli_refuses_missing_checkpoint(cli_name, tmp_path):
    """Each of the port's three inference CLIs builds through one helper, and a
    --ckpt_path that does not exist raises instead of running random weights."""
    cli = importlib.import_module(f"vidseg_diffusion_tpu_torch.scripts.{cli_name}")
    root = str(tmp_path / "data")
    _make_video(root, "v", 8, 3)
    config = SVD if cli_name != "sd_pipeline_vspw" else SD
    argv = ["--device", "cpu", "--model_config", os.path.join(ROOT, config), "--num_steps", "6",
            "--ckpt_path", str(tmp_path / "missing.ckpt")]
    if cli_name == "svd_single_video_inference":
        argv += ["--input_video_path", os.path.join(root, "v", "origin"), "--feature_folder", str(tmp_path / "out")]
    else:
        argv += ["--data_root", root, "--num_frames", "3"]
    calls = []
    with mock.patch.object(tvspw, "run_vspw_video", lambda *a, **k: calls.append(a)), \
            mock.patch.object(tsv, "run_single_video", lambda *a, **k: calls.append(a)):
        with pytest.raises(FileNotFoundError, match="missing.ckpt"):
            cli.main(argv)
    assert calls == []
