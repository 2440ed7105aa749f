"""GroupNorm (+ SiLU) with fp32 statistics: plain versions and the K7-K10 wrappers.

Counterpart of vidseg_diffusion_tpu/ops/norm.py. Statistics are per (batch,
group) over every non-batch, non-channel axis of a channels-last x [B, ..., C],
computed from per-channel sums in fp32 whatever the activation dtype, folded
into a per-channel scale a and shift s, then y = x * a + s (optionally
* sigmoid(y)) in fp32 and one cast back.

On a CUDA tensor `group_norm` launches the hand-written kernels of
csrc/group_norm.cu and csrc/group_norm_bwd.cu (or raises). The forward takes
one of two routes, which `group_norm_route` picks from the shape:

- `group_norm_fused` where one sample's slab of whole groups (rows of a
  multiple of 16 bytes) fits in a block's shared memory (the UNet's ds2 to
  mid sites): one launch reads x once and writes y, a, s, mean and inv;
- elsewhere K7 `group_norm_stats`: one read of x -> a, s [B, C] and mean,
  inv [B, G] in one launch (the JAX package's _stats_kernel +
  _affine_from_stats), then K8 `group_norm_apply`: one read, one write (its
  _apply_kernel);

and the backward takes one of three routes, which
`group_norm_backward_route` picks from the shape and the dtype:

- "fused" / "cluster": `group_norm_backward_slab`, one launch, where one
  sample's slab of x and dy over whole groups fits in the shared memory of one
  block or of a cluster of up to 16 blocks (the UNet from ds2 down, and its
  ds1 at the inversion's two samples; the autoencoder step from 112 x 208
  down), save a cluster of 8 or 16 over a large batch (the UNet's ds1 at 28
  frames), which K9 + K10 run faster: x and dy read once, dx, dgamma and
  dbeta written (both TPU kernels and the coefficient math of
  _gn_bwd_pallas);
- "stream" elsewhere: K9 `group_norm_backward_stats`, one read of x and dy ->
  the coefficients a2, b2, c2 [B, C] and dgamma, dbeta (its
  _gn_bwd_stats_kernel and the coefficient math), then K10
  `group_norm_backward_apply`: dx = a2 * u + b2 * x + c2 (its
  _gn_bwd_apply_kernel). Two launches, nothing between them.

The JAX package keeps these kernels switched off on the TPU because XLA fuses
the statistics into the preceding convolution; eager PyTorch fuses nothing,
so here every CUDA call goes through them. With silu=True the backward
kernels recompute z = a * x + s and use u = dy * d silu(z)/dz in place of
dy (the JAX custom VJP covers silu=False only; this form is jax.grad of its
_gn_core(..., silu=True)), so no fp32 activation is saved. On a CPU tensor the
plain versions below run, forward and backward.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.profiler import record_function

from vidseg_diffusion_tpu_torch.ops import _cuda

_THREADS = 256        # threads per block of the streaming kernels (csrc/group_norm.cuh)
_TILE_VECS = 256      # channel vectors per column tile
_TARGET_BLOCKS = 1024  # about eight blocks per SM of an H100
_STATS_TARGET_BLOCKS = 528  # K7: one wave of four blocks an SM (csrc/group_norm.cu kStatsBlocksPerSM)
_SLAB_MAX_BYTES = 196608  # the fused kernel's slab in shared memory (csrc/group_norm.cu kSlabMaxBytes)
# the backward (csrc/group_norm_bwd.cu): a slab block's threads, the shared memory a
# block may take on the H100, TMA boxes a block, the largest cluster; K9's one wave
_BWD_SLAB_THREADS = 512
_BWD_SMEM_MAX = 232448
_BWD_MAX_BOXES = 64
_BWD_BOX_BYTES = 8192   # a TMA box of x or dy: the threads sum one while the next lands
_BWD_MAX_CLUSTER = 16
_BWD_STATS_TARGET_BLOCKS = 396  # three blocks an SM of an H100 (two and four read slower on the card)
_BWD_SLAB_MIN_ROW = 32  # bytes of a slab's row: TMA moves a narrower box row by row, slower than K9 + K10
# a cluster of 8 or 16 blocks works item by item, each item's sums exchanged across
# its SMs: with this many (sample, slab) items K9 + K10's one wave reads faster on the
# card (UNet ds1 and its concatenation, bf16 and fp32); with fewer (two samples of the
# autoencoder or the inversion) or on a cluster of 2 or 4 the cluster reads faster
_BWD_STREAM_ITEMS = 128


def _stats_dtype(x):
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def _rep(g, c):
    """[B, G] -> [B, C]"""
    return g.repeat_interleave(c // g.shape[1], dim=1)


def group_norm_affine_plain(x, weight, bias, groups: int, eps: float):
    """Plain version of K7: (a, s) [B, C] with y = x * a + s, and the (mean,
    inv) [B, G] statistics, all fp32."""
    b, c = x.shape[0], x.shape[-1]
    ct = _stats_dtype(x)
    red = tuple(range(1, x.dim() - 1))
    xf = x.to(ct)
    s = xf.sum(dim=red)                  # [B, C]
    ss = (xf * xf).sum(dim=red)          # [B, C]
    n = (x.numel() // (b * c)) * (c // groups)
    mean = s.view(b, groups, -1).sum(-1) / n
    var = (ss.view(b, groups, -1).sum(-1) / n - mean * mean).clamp_min(0.0)
    inv = torch.rsqrt(var + eps)
    a = _rep(inv, c) * weight.to(ct)
    shift = bias.to(ct) - _rep(mean * inv, c) * weight.to(ct)
    return a, shift, mean, inv


def group_norm_apply_plain(x, a, s, silu: bool):
    """Plain version of K8."""
    bcast = (x.shape[0],) + (1,) * (x.dim() - 2) + (x.shape[-1],)
    y = x.to(a.dtype) * a.view(bcast) + s.view(bcast)
    if silu:
        y = y * torch.sigmoid(y)
    return y.to(x.dtype)


def group_norm_plain(x, weight, bias, groups: int = 32, eps: float = 1e-5, silu: bool = False):
    """x [B, ..., C] (channels last): the plain forward."""
    group_norm_plain.calls += 1
    a, s, _, _ = group_norm_affine_plain(x, weight, bias, groups, eps)
    return group_norm_apply_plain(x, a, s, silu)


group_norm_plain.calls = 0


def _upstream_plain(x, dy, a, s, silu: bool):
    """(x, u) in the statistics dtype: u is the gradient that reaches the
    affine output z = x * a + s (dy itself without SiLU)."""
    ct = _stats_dtype(x)
    xf, u = x.to(ct), dy.to(ct)
    if silu:
        bcast = (x.shape[0],) + (1,) * (x.dim() - 2) + (x.shape[-1],)
        z = xf * a.view(bcast) + s.view(bcast)
        sg = torch.sigmoid(z)
        u = u * sg * (1.0 + z * (1.0 - sg))
    return xf, u


def group_norm_backward_coef_plain(x, dy, weight, a, s, mean, inv, groups: int, silu: bool):
    """Plain version of K9: coef [B, 3, C] = (a2, b2, c2) with
    dx = a2 * u + b2 * x + c2, and (dweight, dbias) in weight's dtype
    (norm.py:276-292 of the JAX package)."""
    b, c = x.shape[0], x.shape[-1]
    red = tuple(range(1, x.dim() - 1))
    xf, u = _upstream_plain(x, dy, a, s, silu)
    r1 = u.sum(dim=red)                  # [B, C]  sum u
    rx = (u * xf).sum(dim=red)           # [B, C]  sum u x
    n = (x.numel() // (b * c)) * (c // groups)
    wf = weight.to(xf.dtype)[None]
    grp = lambda t: t.view(b, groups, -1).sum(-1)
    s_u = grp(r1 * wf)
    s_ux = inv * (grp(rx * wf) - mean * s_u)
    m1, m2 = s_u / n, s_ux / n
    coef = torch.stack([_rep(inv, c) * wf, _rep(-inv * inv * m2, c),
                        _rep(inv * (mean * inv * m2 - m1), c)], dim=1)
    dweight = (_rep(inv, c) * (rx - _rep(mean, c) * r1)).sum(0).to(weight.dtype)
    return coef, dweight, r1.sum(0).to(weight.dtype)


def group_norm_backward_apply_plain(x, dy, a, s, coef, silu: bool):
    """Plain version of K10."""
    xf, u = _upstream_plain(x, dy, a, s, silu)
    bcast = (x.shape[0],) + (1,) * (x.dim() - 2) + (x.shape[-1],)
    a2, b2, c2 = (coef[:, i].view(bcast) for i in range(3))
    return (a2 * u + b2 * xf + c2).to(x.dtype)


def group_norm_backward_plain(x, dy, weight, a, s, mean, inv, groups: int, silu: bool):
    """Plain backward in coefficient form (the arithmetic of K9 + K10):
    (dx, dweight, dbias) from the forward's a, s [B, C] and mean, inv [B, G]."""
    group_norm_backward_plain.calls += 1
    coef, dweight, dbias = group_norm_backward_coef_plain(x, dy, weight, a, s, mean, inv, groups, silu)
    return group_norm_backward_apply_plain(x, dy, a, s, coef, silu), dweight, dbias


group_norm_backward_plain.calls = 0


def _plan(b: int, r: int, c: int, itemsize: int, aligned: bool, target: int = _TARGET_BLOCKS):
    """How the kernels cut [B, R, C] (see csrc/group_norm.cuh): the channel
    vector width in elements (16 bytes when C and the pointers allow it), the
    rows per chunk and the chunk count, aiming at `target` blocks."""
    vec = 16 // itemsize
    if c % vec or not aligned:
        vec = 1
    cv = c // vec
    tiles = -(-cv // _TILE_VECS)
    rows_per_pass = _THREADS // min(cv, _TILE_VECS)
    max_chunks = max(1, target // (b * tiles))
    rows = max(4 * rows_per_pass, -(-r // max_chunks))
    rows = -(-rows // rows_per_pass) * rows_per_pass
    return vec, rows, -(-r // rows)


def _slab_groups(c: int, groups: int, itemsize: int):
    """The fewest whole groups whose rows are a multiple of 16 bytes (the
    forward's rule, and a TMA box's), or None."""
    cg = c // groups
    return next((k for k in range(1, groups + 1) if groups % k == 0 and k * cg * itemsize % 16 == 0), None)


def group_norm_route(b: int, r: int, c: int, groups: int, itemsize: int, aligned: bool):
    """The forward's route for x [B, R, C]: ("fused", gc) where gc whole groups
    of one sample (the fewest whose rows are a multiple of 16 bytes) fit in the
    fused kernel's shared-memory slab, else ("stream", the K7 / K8 plan)."""
    cg = c // groups
    gc = _slab_groups(c, groups, itemsize) if aligned else None
    if gc is not None and r * gc * cg * itemsize <= _SLAB_MAX_BYTES and gc * cg <= _THREADS:
        return "fused", gc
    return "stream", _plan(b, r, c, itemsize, aligned)


class SlabPlan(NamedTuple):
    """How the slab kernel holds one sample's slab: n blocks a cluster (1:
    "fused"), gc whole groups a slab, rows a block in TMA boxes of box_rows,
    smem bytes of dynamic shared memory a block."""
    n: int
    gc: int
    rows: int
    box_rows: int
    smem: int


def _slab_smem(rows: int, box_rows: int, w: int, itemsize: int, gc: int) -> int:
    """A slab block's dynamic shared memory (csrc/group_norm_bwd.cu slab_layout):
    x's and dy's boxes (each rounded up to 128 bytes), the threads' sums, the
    block's and the cluster's per-channel sums, the group means, two sets of an
    item's gamma, mean and inv, one mbarrier a box, and the alignment of the
    base."""
    nbox = rows // box_rows
    box_bytes = -(-box_rows * w * itemsize // 128) * 128
    par = 2 * nbox * box_bytes + _BWD_SLAB_THREADS * 16 + 16 * w + 8 * gc
    return -(-(par + 8 * (w + 2 * gc)) // 8) * 8 + 8 * nbox + 128


def group_norm_backward_route(b: int, r: int, c: int, groups: int, itemsize: int, aligned: bool):
    """The backward's route for x, dy [B, R, C]: ("fused", SlabPlan) where one
    sample's slab of x and dy over the fewest whole groups with rows of a
    multiple of 16 bytes (at most 256 channels, a TMA box's width, and at least
    32 bytes; boxes of about 8 KB and at most 256 rows) fits in one block's
    shared memory, ("cluster", SlabPlan) where it fits across the n
    blocks of a cluster (the smallest power of two up to 16; 16 is a cluster
    size the H100 places only on request) unless n is 8 or more and the batch
    brings _BWD_STREAM_ITEMS (sample, slab) items or more, else ("stream", the
    K9 plan: vec, rows per chunk, chunks)."""
    gc = _slab_groups(c, groups, itemsize) if aligned else None
    if gc is not None and gc * (c // groups) <= 256 and gc * (c // groups) * itemsize >= _BWD_SLAB_MIN_ROW:
        w = gc * (c // groups)
        n = 1
        while n <= _BWD_MAX_CLUSTER:
            share = -(-r // n)
            box = -(-share // max(-(-share // 256), -(-share * w * itemsize // _BWD_BOX_BYTES)))
            nbox = -(-share // box)
            smem = _slab_smem(nbox * box, box, w, itemsize, gc)
            if nbox <= _BWD_MAX_BOXES and smem <= _BWD_SMEM_MAX:
                if n >= 8 and b * (groups // gc) >= _BWD_STREAM_ITEMS:
                    break
                return ("fused" if n == 1 else "cluster"), SlabPlan(n, gc, nbox * box, box, smem)
            n *= 2
    return "stream", _plan(b, r, c, itemsize, aligned, _BWD_STATS_TARGET_BLOCKS)


def _flat(name, x, *same):
    """Checks shared by the four wrappers; returns (dtype code, B, R, C, plan)."""
    dtype = _cuda.check_cuda_tensors(name, x, *same)
    if x.dim() < 2:
        raise ValueError(f"{name}: needs [B, ..., C], got {tuple(x.shape)}")
    for t in (x, *same):
        if t.shape != x.shape or not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous and of one shape")
    b, c = x.shape[0], x.shape[-1]
    r = x.numel() // (b * c)
    if min(b, r, c) < 1 or max(r, c) >= 2 ** 31:
        raise ValueError(f"{name}: bad shape {tuple(x.shape)}")
    aligned = all(t.data_ptr() % 16 == 0 for t in (x, *same))
    return _cuda.DTYPE_CODES[dtype], b, r, c, _plan(b, r, c, x.element_size(), aligned)


def _check_params(name, x, groups, *params):
    c = x.shape[-1]
    if c % groups:
        raise ValueError(f"{name}: {c} channels not divisible by {groups} groups")
    for p in params:
        if p.device != x.device or p.shape != (c,) or not p.is_contiguous():
            raise ValueError(f"{name}: parameters must be contiguous [{c}] on {x.device}")
        if p.dtype != params[0].dtype or p.dtype not in _cuda.DTYPE_CODES:
            raise ValueError(f"{name}: parameter dtype {p.dtype}")
    return _cuda.DTYPE_CODES[params[0].dtype]


def _statistics(x, b, c, groups, scratch=0):
    """a, s fp32 [B, C], mean, inv fp32 [B, G] and `scratch` more floats, as
    contiguous views of one allocation."""
    buf = torch.empty(2 * b * c + 2 * b * groups + scratch, dtype=torch.float32, device=x.device)
    a, s = buf[:b * c].view(b, c), buf[b * c:2 * b * c].view(b, c)
    mean = buf[2 * b * c:2 * b * c + b * groups].view(b, groups)
    inv = buf[2 * b * c + b * groups:2 * b * c + 2 * b * groups].view(b, groups)
    return a, s, mean, inv, buf[2 * b * c + 2 * b * groups:]


_COUNTERS = {}  # device -> int32 arrival counters of K7, K9 and the slab kernel, zero between calls (each leaves them zero)


def _arrival_counters(device, b):
    counters = _COUNTERS.get(device)
    if counters is None or counters.numel() < b:
        counters = _COUNTERS[device] = torch.zeros(max(b, 64), dtype=torch.int32, device=device)
    return counters


def group_norm_stats(x, weight, bias, groups: int, eps: float):
    """K7 on a contiguous CUDA x [B, ..., C]: (a, s) fp32 [B, C], (mean, inv)
    fp32 [B, G], in one launch. weight and bias are [C], fp32 or bf16."""
    code, b, r, c, _ = _flat("group_norm_stats", x)
    wcode = _check_params("group_norm_stats", x, groups, weight, bias)
    vec, rows, chunks = _plan(b, r, c, x.element_size(), x.data_ptr() % 16 == 0, _STATS_TARGET_BLOCKS)
    tiles = -(-(c // vec) // _TILE_VECS)
    a, s, mean, inv, partial = _statistics(x, b, c, groups, b * chunks * tiles * 2 * groups)
    _cuda.call(
        "vs_group_norm_stats", code, x.data_ptr(), partial.data_ptr(), _arrival_counters(x.device, b).data_ptr(),
        weight.data_ptr(), bias.data_ptr(), wcode, a.data_ptr(), s.data_ptr(), mean.data_ptr(), inv.data_ptr(),
        b, r, c, groups, vec, rows, chunks, float(eps),
    )
    group_norm_stats.launches += 1
    return a, s, mean, inv


group_norm_stats.launches = 0


def group_norm_fused(x, weight, bias, groups: int, eps: float, silu: bool):
    """The one-launch forward on a contiguous CUDA x [B, ..., C] whose route
    is "fused": (y, a, s, mean, inv) as group_norm_apply and group_norm_stats
    would give them."""
    code, b, r, c, _ = _flat("group_norm_fused", x)
    wcode = _check_params("group_norm_fused", x, groups, weight, bias)
    route, gc = group_norm_route(b, r, c, groups, x.element_size(), x.data_ptr() % 16 == 0)
    if route != "fused":
        raise ValueError(f"group_norm_fused: no slab of whole groups of {tuple(x.shape)} fits in shared memory")
    y = torch.empty_like(x)
    a, s, mean, inv, _ = _statistics(x, b, c, groups)
    _cuda.call(
        "vs_group_norm_fused", code, x.data_ptr(), weight.data_ptr(), bias.data_ptr(), wcode, y.data_ptr(),
        a.data_ptr(), s.data_ptr(), mean.data_ptr(), inv.data_ptr(), b, r, c, groups, gc, float(eps),
        int(bool(silu)),
    )
    group_norm_fused.launches += 1
    return y, a, s, mean, inv


group_norm_fused.launches = 0


def _check_coef(name, x, *coefs, width=1):
    want = (x.shape[0], x.shape[-1]) if width == 1 else (x.shape[0], width, x.shape[-1])
    for t in coefs:
        if (t.device != x.device or t.dtype != torch.float32 or t.shape != want
                or not t.is_contiguous()):
            raise ValueError(f"{name}: coefficients must be contiguous fp32 {want} on {x.device}")


def group_norm_apply(x, a, s, silu: bool):
    """K8 on a contiguous CUDA x: y = x * a[b, c] + s[b, c] (* sigmoid(y))."""
    code, b, r, c, (vec, rows, chunks) = _flat("group_norm_apply", x)
    _check_coef("group_norm_apply", x, a, s)
    y = torch.empty_like(x)
    _cuda.call(
        "vs_group_norm_apply", code, x.data_ptr(), a.data_ptr(), s.data_ptr(), y.data_ptr(),
        b, r, c, vec, rows, chunks, int(bool(silu)),
    )
    group_norm_apply.launches += 1
    return y


group_norm_apply.launches = 0


def _check_stats(name, x, groups, mean, inv):
    for t in (mean, inv):
        if (t.device != x.device or t.dtype != torch.float32 or t.shape != (x.shape[0], groups)
                or not t.is_contiguous()):
            raise ValueError(f"{name}: mean and inv must be contiguous fp32 [{x.shape[0]}, {groups}] on {x.device}")


def group_norm_backward_slab(x, dy, weight, a, s, mean, inv, groups: int, silu: bool):
    """K9 + K10 in one launch on contiguous CUDA x, dy whose backward route is
    "fused" or "cluster": (dx, dweight, dbias), the parameter gradients in
    weight's dtype. Counts its launches, and apart those on a cluster of more
    than one block (.cluster_launches)."""
    name = "group_norm_backward_slab"
    code, b, r, c, _ = _flat(name, x, dy)
    wcode = _check_params(name, x, groups, weight)
    _check_coef(name, x, a, s)
    _check_stats(name, x, groups, mean, inv)
    route, plan = group_norm_backward_route(b, r, c, groups, x.element_size(),
                                            x.data_ptr() % 16 == 0 and dy.data_ptr() % 16 == 0)
    if route == "stream":
        raise ValueError(f"group_norm_backward_slab: no slab of whole groups of {tuple(x.shape)} fits in the "
                         "shared memory of a cluster")
    dx = torch.empty_like(x)
    scratch = torch.empty((b, 2, c), dtype=torch.float32, device=x.device)   # each item's dweight, dbias shares
    dparams = torch.empty((2, c), dtype=weight.dtype, device=x.device)
    _cuda.call(
        "vs_group_norm_bwd_slab", code, x.data_ptr(), dy.data_ptr(), a.data_ptr(), s.data_ptr(), weight.data_ptr(),
        wcode, mean.data_ptr(), inv.data_ptr(), dx.data_ptr(), scratch.data_ptr(),
        _arrival_counters(x.device, groups // plan.gc).data_ptr(), dparams[0].data_ptr(), dparams[1].data_ptr(),
        b, r, c, groups, plan.gc, plan.n, plan.rows, plan.box_rows, int(bool(silu)),
    )
    group_norm_backward_slab.launches += 1
    group_norm_backward_slab.cluster_launches += plan.n > 1
    return dx, dparams[0], dparams[1]


group_norm_backward_slab.launches = 0
group_norm_backward_slab.cluster_launches = 0


def group_norm_backward_stats(x, dy, weight, a, s, mean, inv, groups: int, silu: bool):
    """K9 on contiguous CUDA x, dy, in one launch: coef fp32 [B, 3, C] (a2, b2,
    c2) for K10 and (dweight, dbias) in weight's dtype."""
    name = "group_norm_backward_stats"
    code, b, r, c, _ = _flat(name, x, dy)
    wcode = _check_params(name, x, groups, weight)
    _check_coef(name, x, a, s)
    _check_stats(name, x, groups, mean, inv)
    aligned = x.data_ptr() % 16 == 0 and dy.data_ptr() % 16 == 0
    vec, rows, chunks = _plan(b, r, c, x.element_size(), aligned, _BWD_STATS_TARGET_BLOCKS)
    # the partial sums [B, chunks, 2, C], coef [B, 3, C] and each item's dweight, dbias shares [B, 2, C]
    n_partial = b * chunks * 2 * c
    f32 = torch.empty(n_partial + b * 5 * c, dtype=torch.float32, device=x.device)
    partial, coef, shares = f32[:n_partial], f32[n_partial:n_partial + b * 3 * c].view(b, 3, c), f32[n_partial + b * 3 * c:]
    dparams = torch.empty((2, c), dtype=weight.dtype, device=x.device)
    _cuda.call(
        "vs_group_norm_bwd_stats", code, x.data_ptr(), dy.data_ptr(), a.data_ptr(), s.data_ptr(),
        partial.data_ptr(), _arrival_counters(x.device, b + 1).data_ptr(), weight.data_ptr(), wcode,
        mean.data_ptr(), inv.data_ptr(), coef.data_ptr(), shares.data_ptr(), dparams[0].data_ptr(),
        dparams[1].data_ptr(), b, r, c, groups, vec, rows, chunks, int(bool(silu)),
    )
    group_norm_backward_stats.launches += 1
    return coef, dparams[0], dparams[1]


group_norm_backward_stats.launches = 0


def group_norm_backward_apply(x, dy, a, s, coef, silu: bool):
    """K10 on contiguous CUDA x, dy: dx = a2 * u + b2 * x + c2, u as in K9."""
    name = "group_norm_backward_apply"
    code, b, r, c, (vec, rows, chunks) = _flat(name, x, dy)
    _check_coef(name, x, a, s)
    _check_coef(name, x, coef, width=3)
    dx = torch.empty_like(x)
    _cuda.call(
        "vs_group_norm_bwd_apply", code, x.data_ptr(), dy.data_ptr(), a.data_ptr(), s.data_ptr(),
        coef.data_ptr(), dx.data_ptr(), b, r, c, vec, rows, chunks, int(bool(silu)),
    )
    group_norm_backward_apply.launches += 1
    return dx


group_norm_backward_apply.launches = 0


def _contiguous(t):
    """The kernels read [B, R, C] through one pointer: a strided input is
    copied, and the copy is counted (group_norm.copies) so a run can show
    whether a hot site pays for one."""
    if t.is_contiguous():
        return t
    group_norm.copies += 1
    return t.contiguous()


def _forward(x, weight, bias, groups, eps, silu):
    """(y, a, s, mean, inv): on CUDA the fused kernel or K7 + K8, as
    group_norm_route says; the plain versions on CPU."""
    if x.device.type == "cpu":
        group_norm_plain.calls += 1
        a, s, mean, inv = group_norm_affine_plain(x, weight, bias, groups, eps)
        return group_norm_apply_plain(x, a, s, silu), a, s, mean, inv
    b, c = x.shape[0], x.shape[-1]
    r = x.numel() // max(1, b * c)
    if group_norm_route(b, r, c, groups, x.element_size(), x.data_ptr() % 16 == 0)[0] == "fused":
        return group_norm_fused(x, weight, bias, groups, eps, silu)
    a, s, mean, inv = group_norm_stats(x, weight, bias, groups, eps)
    return group_norm_apply(x, a, s, silu), a, s, mean, inv


def _backward(x, dy, weight, a, s, mean, inv, groups, silu):
    """(dx, dweight, dbias) from the forward's statistics: on CUDA the slab
    kernel or K9 + K10, as group_norm_backward_route says from x (a dy off a
    16-byte boundary on a slab route is copied, and counted); the plain
    coefficient form on CPU."""
    if x.device.type == "cpu":
        return group_norm_backward_plain(x, dy, weight, a, s, mean, inv, groups, silu)
    b, c = x.shape[0], x.shape[-1]
    route, _ = group_norm_backward_route(b, x.numel() // max(1, b * c), c, groups, x.element_size(),
                                         x.data_ptr() % 16 == 0)
    if route != "stream":
        if dy.data_ptr() % 16:
            group_norm.copies += 1
            dy = dy.clone()
        return group_norm_backward_slab(x, dy, weight, a, s, mean, inv, groups, silu)
    coef, dw, db = group_norm_backward_stats(x, dy, weight, a, s, mean, inv, groups, silu)
    return group_norm_backward_apply(x, dy, a, s, coef, silu), dw, db


class GroupNormFn(torch.autograd.Function):
    """GroupNorm (+ SiLU) whose backward is the slab kernel or K9 + K10 on
    CUDA and the plain coefficient form on CPU. Saves x, the parameters and the
    [B, C] / [B, G] statistics; never an fp32 activation."""

    @staticmethod
    def forward(ctx, x, weight, bias, groups, eps, silu):
        x = _contiguous(x)
        y, a, s, mean, inv = _forward(x, weight, bias, groups, eps, silu)
        ctx.save_for_backward(x, weight, a, s, mean, inv)
        ctx.groups, ctx.silu = groups, silu
        return y

    @staticmethod
    def backward(ctx, dy):
        x, weight, a, s, mean, inv = ctx.saved_tensors
        dx, dw, db = _backward(x, _contiguous(dy), weight, a, s, mean, inv, ctx.groups, ctx.silu)
        return dx, dw, db, None, None, None


def group_norm(x, weight, bias, groups: int = 32, eps: float = 1e-5, silu: bool = False):
    """GroupNorm (+ SiLU) of x [B, ..., C] (channels last). CUDA tensors go
    through the fused kernel or K7 + K8 (the slab kernel or K9 + K10 in the
    backward) or raise;
    CPU tensors through the plain versions. Under torch.no_grad() nothing is
    saved."""
    if x.shape[-1] % groups:
        raise ValueError(f"group_norm: {x.shape[-1]} channels not divisible by {groups} groups")
    with record_function("vs:GroupNorm"):
        if torch.is_grad_enabled() and any(t.requires_grad for t in (x, weight, bias)):
            return GroupNormFn.apply(x, weight, bias, groups, eps, silu)
        return _forward(_contiguous(x), weight, bias, groups, eps, silu)[0]


group_norm.copies = 0

KERNEL_COUNTERS = (group_norm_stats, group_norm_apply, group_norm_fused, group_norm_backward_slab,
                   group_norm_backward_stats, group_norm_backward_apply)
PLAIN_COUNTERS = (group_norm_plain, group_norm_backward_plain)
