"""The mask modes of the PyTorch port against the JAX package, on the CPU:
ops/knn.py, match_gt_mask with its carried GTMatchState, ops/matching.py
and correct_low_res_mask (--is_refine_mask), then run_single_video with
match_gt_mask over two chained windows and with is_refine_mask on
svd_tiny.yaml (the set-up of torch_vspw_parity.py: JAX's weights and draws;
label maps held wherever JAX's difference maps decide them, as
tests/test_torch_pipeline.py holds them).

Inputs are seeded numpy arrays handed to both packages; KMeans starts from
the initial centres JAX draws from the same key (handed over by keyword, as
kmeans_masks takes them). Everything is held exactly. dense_tracking takes an
argmax of fp32 cosines, which a near-tie could flip between XLA and torch:
where a position differs, both candidates must score within 2 fp32 ulps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from torch_vspw_parity import FLAGS, GT_IDS, HPX, SVD, WPX, Draws, _frames, _gt_image, _pair, _sure
from vidseg_diffusion_tpu.engine import masks as jmasks
from vidseg_diffusion_tpu.ops import knn as jknn
from vidseg_diffusion_tpu.ops import matching as jmatch
from vidseg_diffusion_tpu.ops.kmeans import _kmeanspp_init
from vidseg_diffusion_tpu.pipelines import single_video as jsv
from vidseg_diffusion_tpu_torch.engine import masks as tmasks
from vidseg_diffusion_tpu_torch.ops import knn as tknn
from vidseg_diffusion_tpu_torch.ops import matching as tmatch
from vidseg_diffusion_tpu_torch.pipelines import single_video as tsv

T, FH, FW, C, K = 3, 6, 8, 16, 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _features(seed, t=T, fh=FH, fw=FW, c=C, drift=0):
    """[2T, L, C] features whose cond half follows a 3-region layout (left,
    middle, right columns), drifting `drift` columns a frame, plus noise."""
    rs = np.random.RandomState(seed)
    protos = rs.randn(3, c) * 2
    cols = np.arange(fh * fw) % fw
    feats = []
    for f in range(t):
        region = np.clip((cols - drift * f) * 3 // fw, 0, 2)
        feats.append(protos[region] + 0.6 * rs.randn(fh * fw, c))
    cond = np.stack(feats)
    return np.concatenate([rs.randn(*cond.shape), cond]).astype(np.float32)


def _gt(fh=FH, fw=FW):
    """First-frame GT ids at the feature grid: 0 | 3 | 7 in column blocks."""
    cols = np.arange(fh * fw) % fw
    return np.array([0, 3, 7], np.uint8)[np.clip(cols * 3 // fw, 0, 2)]


def _jax_init(rng, feats, k, t=T):
    """The initial centres kmeans_fit(rng, ...) draws inside match_gt_mask."""
    pts = jmasks._normalize(jnp.asarray(feats))[t:]
    pts = pts.reshape(-1, pts.shape[-1])
    keys = jax.random.split(rng, 10)
    return torch.from_numpy(np.array(jax.vmap(lambda key: _kmeanspp_init(key, pts, k))(keys)))


# -- knn_predict ----------------------------------------------------------------


@pytest.mark.parametrize("n,m,d,classes,k", [(50, 40, 8, 3, 4), (200, 96, 16, 5, 4), (31, 7, 4, 2, 3)])
def test_knn_predict_matches_jax(n, m, d, classes, k):
    rs = np.random.RandomState(n)
    ref = rs.randn(m, d).astype(np.float32)
    ref_y = rs.randint(0, classes, m).astype(np.int32)
    x = rs.randn(n, d).astype(np.float32)
    want = np.asarray(jknn.knn_predict(jnp.asarray(ref), jnp.asarray(ref_y), jnp.asarray(x), k=k,
                                       num_classes=classes))
    got = tknn.knn_predict(torch.from_numpy(ref), torch.from_numpy(ref_y), torch.from_numpy(x), k=k,
                           num_classes=classes)
    np.testing.assert_array_equal(got.numpy(), want)


def test_knn_vote_tie_takes_the_smallest_label():
    """Two votes each for labels 2 and 1: sklearn's mode() (and JAX's argmax)
    take 1."""
    ref = torch.tensor([[0.0], [1.0], [2.0], [3.0], [50.0]])
    ref_y = torch.tensor([2, 1, 2, 1, 0])
    assert tknn.knn_predict(ref, ref_y, torch.tensor([[1.5]]), k=4, num_classes=3).tolist() == [1]


# -- match_gt_mask -----------------------------------------------------------------


@pytest.mark.parametrize("with_gt", [True, False])
def test_match_gt_mask_two_windows_match_jax(with_gt):
    """First window (KMeans on JAX's centres, the overlap mapping to the GT,
    or to the clusters themselves without one, KNN(4) to every frame), then a
    second window voting against the carried state: masks and every state
    field equal JAX's."""
    rng = jax.random.PRNGKey(7)
    f1, f2 = _features(1, drift=1), _features(2, drift=1)
    gt = _gt() if with_gt else None
    jm1, js1 = jmasks.match_gt_mask(rng, jnp.asarray(f1), K, T, gt_mask=gt)
    tm1, ts1 = tmasks.match_gt_mask(torch.from_numpy(f1), K, T, gt_mask=gt, init_centers=_jax_init(rng, f1, K))
    jm2, js2 = jmasks.match_gt_mask(rng, jnp.asarray(f2), K, T, state=js1)
    tm2, ts2 = tmasks.match_gt_mask(torch.from_numpy(f2), K, T, state=ts1)
    for tm, jm, ts, js in ((tm1, jm1, ts1, js1), (tm2, jm2, ts2, js2)):
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
        np.testing.assert_array_equal(ts.unique_labels, js.unique_labels)
        np.testing.assert_array_equal(ts.ref_labels.numpy(), np.asarray(js.ref_labels))
        np.testing.assert_array_equal(ts.ref_features.numpy(), np.asarray(js.ref_features))
    if with_gt:
        assert set(ts1.unique_labels) <= {0, 3, 7} and len(ts1.unique_labels) > 1
    assert ts2.ref_features.shape == (T * FH * FW, C)


# -- ops/matching.py ------------------------------------------------------------------


def _ulp(x):
    return np.spacing(np.abs(np.float32(x))).astype(np.float32)


@pytest.mark.parametrize("t,fh,fw,drift", [(3, 6, 8, 1), (5, 4, 10, 0), (4, 7, 7, 2)])
def test_dense_tracking_matches_jax(t, fh, fw, drift):
    """Trajectories equal JAX's; where a position differs, JAX's and the
    port's candidates score within 2 fp32 ulps of each other (a near-tie of
    the argmax)."""
    cond = _features(t + fh, t=t, fh=fh, fw=fw, drift=drift)[t:]
    want = np.asarray(jmatch.dense_tracking(jnp.asarray(cond)))
    got = tmatch.dense_tracking(torch.from_numpy(cond)).numpy()
    assert got.shape == want.shape == (t, fh * fw)
    f = tmatch._l2norm(torch.from_numpy(cond))
    for step in range(1, t):
        differ = np.nonzero(got[step] != want[step])[0]
        if differ.size == 0:
            continue
        np.testing.assert_array_equal(got[:step], want[:step])   # same sources for this step
        scores = tmatch.tracking_scores(f, torch.from_numpy(got[step - 1]), step - 1).numpy()
        for p in differ:
            a, b = scores[p, got[step, p]], scores[p, want[step, p]]
            assert abs(a - b) <= 2 * _ulp(max(abs(a), abs(b))), (step, p, a, b)
        return   # later steps start from different points


@pytest.mark.parametrize("width,threshold", [(8, 1), (5, 1), (8, 2)])
def test_positive_jump_filter_matches_jax(width, threshold):
    rs = np.random.RandomState(width + threshold)
    pos = rs.randint(0, width * 6, (4, 40)).astype(np.int32)
    pos[:, :10] = pos[:1, :10]   # still points
    want = np.asarray(jmatch.positive_jump_filter(jnp.asarray(pos), width=width, threshold=threshold))
    got = tmatch.positive_jump_filter(torch.from_numpy(pos).long(), width, threshold)
    np.testing.assert_array_equal(got.numpy(), want)
    assert want[:10].all()


def test_trajectory_majority_vote_matches_jax():
    """Votes with ties (the first-met label wins), dropped trajectories that
    share cells with kept ones, and duplicate targets."""
    rs = np.random.RandomState(11)
    t, l, k = 5, 30, 4
    pos = rs.randint(0, l, (t, l)).astype(np.int32)
    pos[0] = np.arange(l)
    seg = rs.randint(0, k, (t, l)).astype(np.int32)
    keep = rs.rand(l) > 0.3
    want = np.asarray(jmatch.trajectory_majority_vote(jnp.asarray(pos), jnp.asarray(seg), jnp.asarray(keep), k))
    got = tmatch.trajectory_majority_vote(torch.from_numpy(pos).long(), torch.from_numpy(seg),
                                          torch.from_numpy(keep), k)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("drift", [0, 1])
def test_correct_low_res_mask_matches_jax(drift):
    feats = _features(5, drift=drift)
    labels = np.clip((np.arange(FH * FW) % FW) * 3 // FW, 0, 2)
    labels = np.broadcast_to(labels, (T, FH * FW)).copy()
    labels[1, ::5] = 3   # noise the vote should repair
    masks = (labels[None] == np.arange(K)[:, None, None]).astype(np.float32)
    want = np.asarray(jmasks.correct_low_res_mask(jnp.asarray(feats), jnp.asarray(masks), T, width=FW))
    got = tmasks.correct_low_res_mask(torch.from_numpy(feats), torch.from_numpy(masks), T, width=FW)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.shape == (K, T, FH * FW) and np.array_equal(got.sum(0).numpy(), np.ones((T, FH * FW)))


# -- run_single_video: match_gt_mask over two windows, is_refine_mask ------------------


@pytest.fixture(scope="module")
def svd_pair():
    return _pair(SVD)


def _run_windows(pair, frames, gt_mask, windows, **flags):
    """Both pipelines over consecutive windows, the state of each carried to
    the next; returns [(JAX result, port result)]."""
    jp, tp = pair
    draws = Draws(True, flags.get("num_masks", FLAGS["num_masks"]))
    args = dict(FLAGS, feature_extraction_mode="match_gt_mask", **flags)
    out, jstate, tstate = [], None, None
    mp = pytest.MonkeyPatch()
    draws.record(mp)
    try:
        for i, (s, e) in enumerate(windows):
            names = [str(n) for n in range(s, e)]
            gt = gt_mask if i == 0 else None
            jres = jsv.run_single_video(jp, frames[s:e], names, jsv.VidSegArgs(mesh="off", **args), gt_mask=gt,
                                        gt_state=jstate, write_outputs=False)
            tres = draws.handed(tsv.run_single_video)(tp, frames[s:e], names, tsv.VidSegArgs(**args), gt_mask=gt,
                                                      gt_state=tstate, write_outputs=False)
            jstate, tstate = jres.gt_state, tres.gt_state
            out.append((jres, tres))
    finally:
        mp.undo()
    return out


def _same_state(ts, js):
    np.testing.assert_array_equal(ts.unique_labels, js.unique_labels)
    np.testing.assert_array_equal(ts.ref_labels.numpy(), np.asarray(js.ref_labels))
    np.testing.assert_allclose(ts.ref_features.numpy(), np.asarray(js.ref_features), atol=1e-4, rtol=0)


def _same_result(tres, jres):
    np.testing.assert_array_equal(tres.masks, jres.masks)
    np.testing.assert_array_equal(tres.unique_labels, jres.unique_labels)
    sure = _sure(jres)
    assert sure.mean() > 0.5, sure.mean()   # the bar of tests/test_torch_pipeline.py
    np.testing.assert_array_equal(tres.seg_raw[sure], jres.seg_raw[sure])
    np.testing.assert_array_equal(tres.seg_filtered[sure], jres.seg_filtered[sure])
    assert set(np.unique(tres.seg_filtered)) <= set(tres.unique_labels)


@pytest.mark.parametrize("with_gt", [True, False])
def test_match_gt_mask_windows_match_jax(svd_pair, with_gt):
    """Two chained windows (0-3 and 2-5, the tail overlap): masks,
    unique_labels (the GT's ids, or the clusters' without a GT), label maps
    and the carried state (its features at 1e-4, the harvest's bound) equal
    JAX's; the second window starts from the first one's state."""
    frames = _frames(5, 5)
    fh, fw = tsv.cluster_feature_hw(svd_pair[1], tsv.VidSegArgs(**FLAGS), HPX, WPX, T)
    gt = np.asarray(Image.fromarray(_gt_image()).resize((fw, fh), Image.NEAREST)).reshape(-1) if with_gt else None
    windows = _run_windows(svd_pair, frames, gt, [(0, 3), (2, 5)])
    for jres, tres in windows:
        _same_result(tres, jres)
        _same_state(tres.gt_state, jres.gt_state)
        assert tres.gt_state.ref_features.shape == (T * fh * fw, tres.cluster_features.shape[-1])
    if with_gt:
        assert set(windows[0][1].unique_labels) <= set(GT_IDS) and len(windows[0][1].unique_labels) > 1


def test_refine_mask_matches_jax(svd_pair):
    """is_refine_mask: the feature pass also harvests block 7's spatial q and
    the masks are corrected along its dense tracks; equal to JAX's."""
    frames = _frames(6, 3)
    fh, fw = tsv.cluster_feature_hw(svd_pair[1], tsv.VidSegArgs(**FLAGS), HPX, WPX, T)
    gt = np.asarray(Image.fromarray(_gt_image()).resize((fw, fh), Image.NEAREST)).reshape(-1)
    (jres, tres), = _run_windows(svd_pair, frames, gt, [(0, 3)], is_refine_mask=True)
    _same_result(tres, jres)
    (_, plain), = _run_windows(svd_pair, frames, gt, [(0, 3)])
    assert plain.masks.shape == tres.masks.shape


def test_refine_round_trip_across_resolutions_matches_jax():
    """A tracking block at another token resolution than the clustering
    block (no shipped config has one; a reduced topology can): the masks go
    to its grid by a bicubic resize thresholded at 0.5, are refined there and
    come back the same way, as JAX's run_single_video does (:477-498)."""
    from vidseg_diffusion_tpu.ops.image import resize_bicubic

    t, (h_lat, w_lat), (fh, fw), tdiv = T, (16, 24), (8, 12), 4
    th, tw = h_lat // tdiv, w_lat // tdiv
    feats = _features(9, t=t, fh=th, fw=tw, drift=1)
    labels = np.clip((np.arange(fh * fw) % fw) * 3 // fw, 0, 2)
    masks = (np.broadcast_to(labels, (t, fh * fw))[None] == np.arange(K)[:, None, None]).astype(np.float32)
    tm = resize_bicubic(jnp.asarray(masks).reshape(K, t, fh, fw), (th, tw))
    tm = (tm > 0.5).astype(jnp.float32).reshape(K, t, -1)
    refined = jmasks.correct_low_res_mask(jnp.asarray(feats), tm, t, width=tw)
    rm = resize_bicubic(refined.reshape(K, t, th, tw), (fh, fw))
    want = np.asarray((rm > 0.5).astype(jnp.float32).reshape(K, t, fh * fw))
    got = tsv._refine(torch.from_numpy(feats), torch.from_numpy(masks), t, (h_lat, w_lat), (fh, fw), tdiv)
    np.testing.assert_array_equal(got.numpy(), want)
