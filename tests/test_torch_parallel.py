"""More than one process on the CPU (gloo): the port's parallel/ package held
to the JAX package's, or to the port's one-process path where JAX's
counterpart is an in-process mesh.

- leaf_shard_dim / param_shard_dim against JAX's _leaf_spec: the shapes of
  tests/test_fsdp.py and every leaf of the tiny video UNet, through
  io/convert.py's layout permutation (square kernels tie, and the tie must
  fall on the same logical axis in both packages);
- process_slice against JAX's, rank and world mocked;
- two FSDPTrainStep steps on 2 ranks, each on its video of the batch,
  against the one-process steps: the step-1 gradients FSDP reduced (rtol
  1e-5), parameters, EMA and the loss (fp32);
- two FSDPTrainStep steps on 2 ranks in bf16 within the rounding bounds
  chip_smoke.py --ranks holds on the card, which planted faults fail;
- at world 1 in bf16, the wrapped steps against the unwrapped ones: they
  differ, and only by the association of gradient sums that FSDP's
  per-module input nodes impose (an unwrapped model given the same nodes is
  bit-equal to the wrapped one);
- run_single_video with the runs over 2 ranks (num_masks 3: the ranks hold
  2 and 1 masks) bit-equal on both ranks to a one-rank group's run, and over
  4 ranks (one holds no mask);
- run_vspw_sweep(process_shard=True) for each of 2 mocked ranks: the union
  of the videos done is the one-process list, each video's labels equal.

Workers are subprocesses that join a group through a file:// rendezvous in
the test's tmp_path (no port to collide under xdist), one torch thread each,
each with a timeout.
"""

import dataclasses
import os
import subprocess
import sys
from unittest import mock

import numpy as np
import pytest
import torch

from vidseg_diffusion_tpu_torch.config import load_model_spec
from vidseg_diffusion_tpu_torch.engine.train import DiffusionTrainStep
from vidseg_diffusion_tpu_torch.models.unet import UNetModel
from vidseg_diffusion_tpu_torch.parallel import fsdp as tfsdp
from vidseg_diffusion_tpu_torch.parallel import mesh as tmesh
from vidseg_diffusion_tpu_torch.scripts import train_path

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(ROOT, "configs/inference/svd_tiny.yaml")
T, N_VIDEOS, HW = 3, 2, 8
LR, EMA_DECAY, STEPS = 1e-4, 0.999, 2
# Adam divides each gradient element by its own magnitude, so an element
# near zero, summed over the ranks in another order, moves by a share of an
# lr step (four bias elements of output_blocks.3 read 2.9e-6 apart at lr
# 1e-4): the parameters and EMA are held to a tenth of a step. The
# gradients, whose scale the step hides, are held to GRAD_RTOL, with an
# absolute floor of GRAD_RTOL times the largest gradient element of the
# model: some tensors' gradients are zero but for roundings (a bias that a
# GroupNorm follows reads 1e-10 where the largest element is above 1e-3).
PARAM_RTOL, PARAM_ATOL = 1e-5, LR / 10
GRAD_RTOL = 1e-5
WORKER_TIMEOUT = 300
# run_single_video at the tiny size (tests/torch_vspw_parity.py's flags)
RUN_FLAGS = dict(num_steps=6, modulate_timestep=(3,), feature_timestep=(5,), num_masks=3, seed=1)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---- set-ups shared by the test process and its workers ---------------------

def tiny_trainer(wrap: bool, dtype=torch.float32, input_nodes: bool = False) -> DiffusionTrainStep:
    """svd_tiny.yaml's UNet (remat on) with N(0, 0.02) weights from a seed,
    Adam and an EMA; FSDP-wrapped before the optimizer when `wrap` (an
    FSDPTrainStep, each rank on its share of the videos), given FSDP's input
    nodes unwrapped when `input_nodes`."""
    spec = load_model_spec(TINY, num_frames=T, dtype=dtype)
    unet = UNetModel(dataclasses.replace(spec.unet_config, remat=True)).to(dtype)
    train_path.init_normal_(unet, torch.Generator().manual_seed(0))
    if input_nodes:
        fsdp_input_nodes(unet)
    args = (train_path.network_factory(T), train_path.loss_module())
    if not wrap:
        return DiffusionTrainStep(unet, *args, torch.optim.Adam(unet.parameters(), lr=LR), ema_decay=EMA_DECAY)
    tfsdp.fsdp_wrap(unet)
    return tfsdp.FSDPTrainStep(unet, *args, torch.optim.Adam(unet.parameters(), lr=LR), ema_decay=EMA_DECAY,
                               unit=T)


class _InputNode(torch.autograd.Function):
    """An identity on a module's inputs, as FSDP2's RegisterPostBackwardFunction."""

    @staticmethod
    def forward(ctx, *xs):
        return xs

    @staticmethod
    def backward(ctx, *grads):
        return grads


def fsdp_input_nodes(model):
    """Give an unwrapped UNet the autograd nodes fsdp_wrap's FSDP puts on the
    inputs of each wrapped module: one identity over the inputs that need a
    gradient, in each forward but not in a remat recompute (FSDP registers
    none there). A tensor read by several modules then sums its gradients in
    the wrapped model's association."""
    def hook(module, args):
        if not torch.is_grad_enabled() or torch._C._current_graph_task_id() != -1:
            return None
        at = [i for i, a in enumerate(args) if torch.is_tensor(a) and a.requires_grad]
        if not at:
            return None
        args = list(args)
        for i, out in zip(at, _InputNode.apply(*[args[i] for i in at])):
            args[i] = out
        return tuple(args)

    for module in tfsdp.wrapped_modules(model):
        module.register_forward_pre_hook(hook)


def train_batch(step: int, dtype=torch.float32):
    """(latents, cond, sigma, noise) of a step: N_VIDEOS videos of T frames."""
    rs = np.random.RandomState(100 + step)
    n = N_VIDEOS * T
    f = lambda *s: torch.from_numpy(rs.randn(*s).astype(np.float32)).to(dtype)
    latents, concat = f(n, HW, HW, 4), f(n, HW, HW, 4)
    cond = {"crossattn": f(n, 1, 1024), "vector": f(n, 768), "concat": concat}
    sigma = torch.from_numpy(np.exp(rs.randn(n) * 1.2 - 1.2).astype(np.float32))
    return latents, cond, sigma, f(n, HW, HW, 4)


def run_steps(trainer: DiffusionTrainStep, dtype=torch.float32):
    """STEPS steps on the whole batch: (losses, the step-1 gradients whole,
    the params and EMA whole after the last step), fp32 numpy."""
    losses, grads = [], None
    for step in range(STEPS):
        latents, cond, sigma, noise = train_batch(step, dtype)
        losses.append(trainer.step(latents, cond, sigma=sigma, noise=noise).float())
        if step == 0:
            grads = {n: tfsdp.full_tensor(p.grad).float().numpy().copy()
                     for n, p in trainer.model.named_parameters() if p.grad is not None}
    params, ema = tfsdp.replicated_state(trainer.model, trainer.ema)
    as_np = lambda d: {n: v.float().numpy().copy() for n, v in d.items()}
    return torch.stack(losses).numpy(), grads, as_np(params), as_np(ema)


def run_frames():
    return np.random.RandomState(3).uniform(-1, 1, (T, 64, 64, 3)).astype(np.float32)


_WORKER = r"""
import os, sys
import numpy as np
import torch
import torch.distributed as dist
sys.path.insert(0, os.path.join(sys.argv[6], "tests"))
torch.set_num_threads(1)
mode, rank, world, init, out = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5]
from vidseg_diffusion_tpu_torch.parallel.mesh import initialize_distributed
group = initialize_distributed("file://" + init, world, rank, device="cpu")
assert initialize_distributed("file://" + init, world, rank, device="cpu") is group
assert dist.get_backend() == "gloo" and dist.get_world_size() == world and dist.get_rank() == rank
import test_torch_parallel as P
if mode in ("train", "train_bf16"):
    dtype = torch.bfloat16 if mode == "train_bf16" else torch.float32
    trainer = P.tiny_trainer(wrap=True, dtype=dtype)
    losses, grads, params, ema = P.run_steps(trainer, dtype)
    kinds = {n: type(p).__name__ for n, p in trainer.model.named_parameters()}
    if rank == 0:
        np.savez(out, losses=losses, **{"g:" + n: v for n, v in grads.items()},
                 **{"p:" + n: v for n, v in params.items()}, **{"e:" + n: v for n, v in ema.items()})
    assert set(kinds.values()) == {"DTensor"}, set(kinds.values())
else:
    from vidseg_diffusion_tpu_torch.engine.build import build_pipeline
    from vidseg_diffusion_tpu_torch.pipelines.single_video import VidSegArgs, run_single_video
    pipe = build_pipeline(P.TINY, num_steps=P.RUN_FLAGS["num_steps"], num_frames=P.T, device="cpu", seed=0)
    folder = out + ".outputs"
    res = run_single_video(pipe, P.run_frames(), [f"{i:05d}" for i in range(P.T)],
                           VidSegArgs(feature_folder=folder, **P.RUN_FLAGS), process_group=group)
    np.savez(out, final_latents=res.final_latents, diff_maps=res.diff_maps, seg_raw=res.seg_raw,
             seg_filtered=res.seg_filtered, masks=res.masks, unique_labels=res.unique_labels)
dist.destroy_process_group()
print("WORKER_OK", rank)
"""


def _launch(tmp_path, mode, world, tag):
    """Start `world` workers of one group; returns [(proc, rank, out path)]."""
    env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH", "WORLD_SIZE", "RANK", "LOCAL_RANK")}
    env["PYTHONPATH"] = ROOT
    init = str(tmp_path / f"{tag}.init")
    procs = []
    for rank in range(world):
        out = str(tmp_path / f"{tag}_{rank}.npz")
        procs.append((subprocess.Popen([sys.executable, "-c", _WORKER, mode, str(rank), str(world), init, out, ROOT],
                                       stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env, cwd=ROOT),
                      rank, out))
    return procs


def _wait(procs):
    """Each worker's saved arrays (None where it saved none)."""
    for p, rank, _ in procs:
        try:
            text, _ = p.communicate(timeout=WORKER_TIMEOUT)
        except subprocess.TimeoutExpired:
            for q, _, _ in procs:
                q.kill()
            raise
        text = text.decode()
        assert p.returncode == 0 and f"WORKER_OK {rank}" in text, text[-4000:]
    return [np.load(out) if os.path.exists(out) else None for _, _, out in procs]


# ---- shard dims ---------------------------------------------------------------

def test_leaf_shard_dim_matches_jax_leaf_spec_on_test_fsdp_shapes():
    from vidseg_diffusion_tpu.parallel.fsdp import _leaf_spec

    shapes = [(3, 3, 16, 32), (32,), (32, 24), (), (7, 5), (3, 3, 64, 64), (1,), (4, 4), (24, 32), (3, 1, 1, 8, 8)]
    for world in (2, 4, 8):
        for shape in shapes:
            spec = _leaf_spec(shape, world)   # PartitionSpec() when replicated
            want = spec.index("__AXIS__") if len(spec) else None
            assert tfsdp.leaf_shard_dim(shape, world) == want, (shape, world)


def test_param_shard_dim_matches_jax_on_every_tiny_unet_leaf():
    """Every leaf of the tiny video UNet: JAX's choice on the flax kernel,
    moved through the convert permutation, is the port parameter's dim
    (square 3x3 convs, [C, C] projections and [3, 1, 1, C, C] temporal
    kernels tie; the first dim JAX meets wins)."""
    import flax
    import jax
    import jax.numpy as jnp

    from vidseg_diffusion_tpu import config as jconfig
    from vidseg_diffusion_tpu.models import unet as junet
    from vidseg_diffusion_tpu.parallel.fsdp import _leaf_spec
    from vidseg_diffusion_tpu_torch.io import convert

    jm = junet.UNetModel(jconfig.load_model_spec(TINY, num_frames=T).unet_config)
    x = jnp.zeros((2 * T, HW, HW, 8))
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), x, jnp.zeros((2 * T,)), jnp.zeros((2 * T, 1, 1024)),
                                            jnp.zeros((2 * T, 768)), num_video_frames=T,
                                            image_only_indicator=jnp.zeros((2, T)))["params"])
    flat = flax.traverse_util.flatten_dict(flax.core.unfreeze(shapes))
    tm = UNetModel(load_model_spec(TINY, num_frames=T).unet_config)
    params = dict(tm.named_parameters())
    perms = {2: (1, 0), 4: (3, 2, 0, 1), 5: (4, 3, 0, 1, 2)}
    for world in (2, 4):
        dims = tfsdp.shard_dims(tm, world)
        ties = 0
        for path, leaf in flat.items():
            name = convert.unet_key_fn(path)
            spec = _leaf_spec(leaf.shape, world)
            jdim = spec.index("__AXIS__") if len(spec) else None
            kernel = path[-1] == "kernel"
            tdim = None if jdim is None else (perms[len(leaf.shape)].index(jdim) if kernel else jdim)
            assert dims[name] == tdim, (name, leaf.shape, world)
            if kernel and tdim is not None:
                torch_shape = tuple(params[name].shape)
                assert torch_shape[tdim] == leaf.shape[jdim]
                ties += sum(d == leaf.shape[jdim] for d in leaf.shape) > 1
        assert ties > 0 and len(dims) == len(flat)


# ---- process_slice --------------------------------------------------------------

def test_process_slice_matches_jax():
    from vidseg_diffusion_tpu.parallel import mesh as jmesh

    for world in (1, 2, 3, 4):
        for n in (0, 1, 5, 10, 13):
            for rank in range(world):
                with mock.patch.object(jmesh.jax, "process_count", return_value=world), \
                        mock.patch.object(jmesh.jax, "process_index", return_value=rank):
                    want = jmesh.process_slice(n)
                with mock.patch.object(tmesh.dist, "is_initialized", return_value=True), \
                        mock.patch.object(tmesh.dist, "get_world_size", return_value=world), \
                        mock.patch.object(tmesh.dist, "get_rank", return_value=rank):
                    assert tmesh.process_slice(n) == want, (n, world, rank)
    assert tmesh.process_slice(7) == slice(0, 7)   # outside a process group: everything


def test_initialize_distributed_defaults_to_the_card():
    """Without a card the default (NCCL) raises instead of joining with gloo."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        tmesh.initialize_distributed("file:///nonexistent/init", 1, 0)


# ---- FSDP training ----------------------------------------------------------------

def test_fsdp_train_steps_on_two_ranks_match_one_process(tmp_path):
    """Two FSDPTrainStep steps on 2 ranks, each on one of the two videos (and
    its share of sigma / noise), against the same two steps on one process:
    the step-1 gradients as FSDP reduced them (a sum over the ranks where a
    mean is due reads twice the one-process gradient), every parameter and
    EMA tensor, and the loss of the whole batch."""
    procs = _launch(tmp_path, "train", 2, "train")
    trainer = tiny_trainer(wrap=False)
    init = {n: p.detach().numpy().copy() for n, p in trainer.model.named_parameters()}
    losses, grads, params, ema = run_steps(trainer)
    got = _wait(procs)[0]
    np.testing.assert_allclose(got["losses"], losses, rtol=PARAM_RTOL, atol=PARAM_ATOL)
    assert sorted(n[2:] for n in got.files if n.startswith("g:")) == sorted(grads)
    floor = GRAD_RTOL * max(np.abs(g).max() for g in grads.values())
    for name, g in grads.items():
        np.testing.assert_allclose(got["g:" + name], g, rtol=GRAD_RTOL, atol=floor, err_msg=name)
    moved_one, moved_two = [], []
    for name, p in params.items():
        np.testing.assert_allclose(got["p:" + name], p, rtol=PARAM_RTOL, atol=PARAM_ATOL, err_msg=name)
        np.testing.assert_allclose(got["e:" + name], ema[name], rtol=PARAM_RTOL, atol=PARAM_ATOL, err_msg=name)
        # the parameters the steps moved are the same ones, most of them
        moved_one += [name] if not np.array_equal(p, init[name]) else []
        moved_two += [name] if not np.array_equal(got["p:" + name], init[name]) else []
    assert moved_two == moved_one and len(moved_one) > 0.8 * len(params)


def test_fsdp_bf16_steps_on_two_ranks_within_the_rounding_bounds(tmp_path):
    """In bf16 over 2 ranks, the bounds chip_smoke.py --ranks holds on the
    card. The reduced step-1 gradients lie within a bf16 sum's rounding (2 x
    2^-8 x the mean magnitude) of the mean of each video's gradient computed
    alone with FSDP's input nodes (what each rank computes); the params and
    EMA after the steps within what two Adam steps on other gradients can
    move an element of the one-process run (2 x 2 x 1.05 lr + 4 bf16 steps).
    A sum where the mean is due, and a leaf whose halves trade places, fail
    them."""
    procs = _launch(tmp_path, "train_bf16", 2, "bf16")
    bf16 = torch.bfloat16
    latents, cond, sigma, noise = train_batch(0, bf16)
    ref = tiny_trainer(wrap=False, dtype=bf16, input_nodes=True)
    mean, scale = {}, {}
    for video in range(N_VIDEOS):
        share = slice(video * T, (video + 1) * T)
        ref.model.zero_grad(set_to_none=True)
        ref.loss_mod(ref.network_factory(ref.model), latents[share], {k: v[share] for k, v in cond.items()},
                     sigma=sigma[share], noise=noise[share]).backward()
        for name, p in ref.model.named_parameters():
            if p.grad is not None:
                mean[name] = mean.get(name, 0) + p.grad.float().numpy() / N_VIDEOS
                scale[name] = scale.get(name, 0) + np.abs(p.grad.float().numpy()) / N_VIDEOS
    _, _, params, ema = run_steps(tiny_trainer(wrap=False, dtype=bf16), bf16)
    got = _wait(procs)[0]

    def grad_beyond(factor):
        return sum(int((np.abs(got["g:" + n] * factor - m) > 2 * 2.0 ** -8 * scale[n]).sum()) for n, m in mean.items())

    def adam_beyond(swap=None):
        bad = 0
        for pre, want in (("p:", params), ("e:", ema)):
            for name, w in want.items():
                a = got[pre + name]
                if name == swap:
                    a = np.roll(a, a.shape[0] // 2, 0)
                ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(w), 2.0 ** -126))) - 7)
                bad += int((np.abs(a - w) > 2 * STEPS * 1.05 * LR + 4 * ulp).sum())
        return bad

    assert sorted(n[2:] for n in got.files if n.startswith("g:")) == sorted(mean)
    assert grad_beyond(1) == 0 and grad_beyond(2) > 0
    big = max(params, key=lambda n: params[n].size)
    assert adam_beyond() == 0 and adam_beyond(big) > 0


def test_fsdp_gap_at_world_one_is_the_association_of_fsdp_input_nodes(tmp_path):
    """In bf16 the wrapped steps on a one-rank group differ from the
    unwrapped ones, whose gradient sums of multi-consumer tensors (the
    UNet's emb, a block input its skip also reads) associate otherwise: an
    unwrapped model given FSDP's input nodes (fsdp_input_nodes) is bit-equal
    to the wrapped one in the step-1 gradients, parameters and EMA."""
    tmesh.initialize_distributed(f"file://{tmp_path / 'init'}", 1, 0, device="cpu")
    try:
        runs = {kind: run_steps(tiny_trainer(wrap=kind == "wrapped", dtype=torch.bfloat16,
                                             input_nodes=kind == "nodes"), torch.bfloat16)
                for kind in ("wrapped", "nodes", "plain")}
    finally:
        torch.distributed.destroy_process_group()

    def differing(a, b):
        return sum(int((a[part][n] != b[part][n]).sum()) for part in (1, 2, 3) for n in a[part])

    np.testing.assert_array_equal(runs["nodes"][0], runs["wrapped"][0])
    assert differing(runs["nodes"], runs["wrapped"]) == 0
    assert differing(runs["plain"], runs["wrapped"]) > 0


def test_rank_share_takes_equal_shares_of_whole_videos():
    x = torch.arange(12)
    for rank, want in ((0, [0, 1, 2, 3, 4, 5]), (1, [6, 7, 8, 9, 10, 11])):
        with mock.patch.object(tfsdp.dist, "get_world_size", return_value=2), \
                mock.patch.object(tfsdp.dist, "get_rank", return_value=rank):
            assert tfsdp.rank_share(x, unit=3).tolist() == want
    with mock.patch.object(tfsdp.dist, "get_world_size", return_value=4), \
            mock.patch.object(tfsdp.dist, "get_rank", return_value=0):
        with pytest.raises(ValueError):   # 4 videos of 3 frames over 4 ranks hold; 12 rows of 2 do not split
            tfsdp.rank_share(x, unit=2)
        assert tfsdp.rank_share(x, unit=3).tolist() == [0, 1, 2]


def test_relayout_invalidate_retires_only_the_copies_it_names():
    """ops/relayout.py: retiring one weight's copy remakes that copy on its
    next use, and leaves another weight's copy cached."""
    from vidseg_diffusion_tpu_torch.ops import relayout

    cache = relayout.RelayoutCache()
    a, b = torch.randn(4, 3), torch.randn(4, 3)
    copy = lambda w, dt: w.t().to(dt).contiguous()
    assert cache.get(a, torch.float32, copy)[1] and cache.get(b, torch.float32, copy)[1]
    assert not cache.get(a, torch.float32, copy)[1]
    with torch.no_grad():
        a.data.add_(1.0)   # refilled without a version bump, at the same storage
    assert not cache.get(a, torch.float32, copy)[1]
    relayout.invalidate([a])
    copy_a, remade = cache.get(a, torch.float32, copy)
    assert remade and torch.equal(copy_a, a.t())
    assert not cache.get(b, torch.float32, copy)[1]
    relayout._CACHES.remove(cache)


def test_fsdp_shards_along_jax_dims(tmp_path):
    """fsdp_wrap's placements on a one-rank group: each parameter's DTensor
    shards on shard_dims' choice (Shard(0) where JAX replicates)."""
    from torch.distributed.tensor import Shard

    tmesh.initialize_distributed(f"file://{tmp_path / 'init'}", 1, 0, device="cpu")
    try:
        unet = UNetModel(load_model_spec(TINY, num_frames=T).unet_config)
        want = tfsdp.shard_dims(unet, 1)
        tfsdp.fsdp_wrap(unet)
        for name, p in unet.named_parameters():
            dim = want[name] if want[name] is not None else 0
            assert p.placements == (Shard(dim),), (name, p.placements)
    finally:
        torch.distributed.destroy_process_group()


# ---- the runs over ranks ---------------------------------------------------------------

def _runs_bit_equal_to_one_rank(tmp_path, world):
    procs = _launch(tmp_path, "runs", world, "many") + _launch(tmp_path, "runs", 1, "one")
    results = _wait(procs)
    one = results[world]
    assert one["final_latents"].shape[:2] == (2, 3)
    for got in results[:world]:
        for key in ("final_latents", "diff_maps", "seg_raw", "seg_filtered", "masks", "unique_labels"):
            np.testing.assert_array_equal(got[key], one[key], err_msg=key)
    assert os.path.isdir(str(tmp_path / "many_0.npz.outputs"))
    assert not any(os.path.exists(str(tmp_path / f"many_{r}.npz.outputs")) for r in range(1, world))


def test_runs_over_two_ranks_are_bit_equal_to_one_rank(tmp_path):
    """run_single_video with num_masks 3 over a 2-rank group (rank 0 runs
    masks 0 and 2, rank 1 mask 1, both signs each) and over a 1-rank group,
    launched the same way: both ranks return the one-rank run's final
    latents, difference maps and label maps bit for bit; only rank 0
    writes outputs."""
    _runs_bit_equal_to_one_rank(tmp_path, 2)


def test_runs_over_four_ranks_with_a_rank_without_a_mask(tmp_path):
    """The same over 4 ranks: rank 3 holds no mask and joins every
    collective with padding alone."""
    _runs_bit_equal_to_one_rank(tmp_path, 4)


def test_runs_of_rank_cover_every_run_once():
    from vidseg_diffusion_tpu_torch.parallel.runs import runs_of_rank

    for m in (1, 3, 10):
        for world in (1, 2, 4, 12):
            runs = [runs_of_rank(m, q, world) for q in range(world)]
            assert sorted(sum(runs, [])) == list(range(2 * m))
            for mine in runs:   # whole (+lambda, -lambda) pairs
                assert all((r + m) % (2 * m) in mine for r in mine)
            assert len(runs[0]) == max(len(r) for r in runs)


# ---- the sweep's process split ---------------------------------------------------------

def test_vspw_sweep_process_shard_covers_the_list_once(tmp_path):
    """run_vspw_sweep(process_shard=True) for ranks 0 and 1 of 2 (mocked, as
    tests/test_vspw_sweep.py mocks JAX's process index): each rank runs a
    contiguous share, the shares make the one-process list, and each video's
    labels equal the one-process sweep's."""
    from torch_vspw_parity import _make_video

    from vidseg_diffusion_tpu_torch.engine.build import build_pipeline
    from vidseg_diffusion_tpu_torch.pipelines import vspw as tvspw
    from vidseg_diffusion_tpu_torch.pipelines.single_video import VidSegArgs

    root = str(tmp_path / "data")
    names = ["vid_a", "vid_b", "vid_c"]
    for i, name in enumerate(names):
        _make_video(root, name, i + 1, 3 + (i == 0))
    pipe = build_pipeline(TINY, num_steps=RUN_FLAGS["num_steps"], num_frames=T, device="cpu", seed=0)
    args = VidSegArgs(**RUN_FLAGS)
    ran = {}

    def spy(*a, **k):
        res = real(*a, **k)
        ran.setdefault(tag, {})[os.path.basename(os.path.dirname(a[1]))] = res
        return res

    real = tvspw.run_vspw_video
    outs = {}
    with mock.patch.object(tvspw, "run_vspw_video", spy):
        for tag, rank in (("all", None), ("r0", 0), ("r1", 1)):
            kw = dict(num_frames=T, num_classes=8, manifest_path=str(tmp_path / f"{tag}.jsonl"))
            if rank is None:
                outs[tag] = tvspw.run_vspw_sweep(pipe, root, names, args, **kw)
                continue
            with mock.patch.object(tmesh.dist, "is_initialized", return_value=True), \
                    mock.patch.object(tmesh.dist, "get_world_size", return_value=2), \
                    mock.patch.object(tmesh.dist, "get_rank", return_value=rank):
                outs[tag] = tvspw.run_vspw_sweep(pipe, root, names, args, process_shard=True, **kw)
    assert list(ran["r0"]) == names[:2] and list(ran["r1"]) == names[2:]
    assert list(ran["r0"]) + list(ran["r1"]) == list(ran["all"])
    assert outs["r0"]["videos_done"] + outs["r1"]["videos_done"] == outs["all"]["videos_done"] == 3
    for tag in ("r0", "r1"):
        for name, res in ran[tag].items():
            want = ran["all"][name]
            assert list(res.seg) == list(want.seg)
            np.testing.assert_array_equal(res.unique_labels, want.unique_labels)
            for frame in res.seg:
                np.testing.assert_array_equal(res.seg[frame], want.seg[frame])
