"""The split-TF32 arithmetic of the fp32 D = 512 attention kernels, on the CPU.

csrc/tf32x3_attention.cuh runs every product of the fp32 attention at D = 512
(K3 / K1 forward, K13 / K5 backward) on the tensor cores in TF32, as three
products of split operands: x = hi + lo with hi = x cut to TF32 (its low 13
bits dropped, which is what the tensor cores read of an fp32 value) and
lo = x - hi rounded to TF32 (10 mantissa bits; nearest, ties away from zero, as
cvt.rna.tf32.f32 rounds, done on the fp32 bits), and
a b ~ hi_a lo_b + lo_a hi_b + hi_a hi_b summed in fp32. No CUDA runs here:
a test-local emulation of that arithmetic (numpy fp32 products of the TF32
parts, exact in fp32, summed by BLAS) is held to the JAX package's Pallas
kernels in interpret mode (the forward to _flash_attention_impl, the backward
to jax.vjp of flash_attention with its Pallas backward) within FP32_TOL of max
|JAX| and to a float64 evaluation of the same math within a relative RMS error
of 1e-5. The negative control, one TF32 pass (each operand cut, as the tensor
cores read raw fp32), reads above 1e-4 of max |fp64|
at max error: the bounds tell the two classes apart. The card tests
(tests/test_torch_gpu.py) and chip_smoke.py hold the kernels themselves to
their plain versions and to fp64 with the same bounds.

K6 at D = 512 (csrc/temporal_attention_bwd_512.cu: the direct-layout
temporal backward, t <= 16 frames) runs the same split on mma.sync, each chain
on the tensor cores one 32-channel panel (S, dP) or the t keys / frames (dq,
dk, dv) long and added in fp32. Its emulation is held to jax.vjp of the
direct-layout Pallas kernel in interpret mode (whose VJP runs the Pallas
tiny-seq backward) within FP32_TOL and to fp64 within RMS_TOL; one TF32 pass
reads above K6's relative RMS bound of 2e-4 (chip_smoke.py's rms_tol).

The kernels of csrc/temporal_attention_long_tc.cu (K2 and K6 at D = 64 and
512 past 32 frames; K6 in fp32 at D = 64 from 2 to 32 frames and K2 at D =
512 up to 32 frames) are emulated with their chains (a 32-channel panel, a
16-row tile) and held the same way, with a negative control each.

K5 in fp32 at D = 64 (csrc/flash_attention_bwd_x3.cu: S and dP a chain a
32-column panel, dq / dk / dv a chain a 32-row tile) is held to jax.vjp of the
packed flash attention (its Pallas backward in interpret mode) and K11 in fp32
(the split-TF32 consumer of csrc/wgmma_tile.cuh's persistent loop: a chain a
32-channel slice, the bias added in fp32) to _matmul_bias_impl in interpret
mode, each within FP32_TOL of JAX and RMS_TOL of float64, with a one-pass
negative control each.

K1 / K3 in fp32 at D = 64 (csrc/flash_attention_x3.cu: S a chain a 32-column
panel, a base-2 online softmax over 32-key tiles, P V a chain a key tile) is
held to _flash_attention_packed_impl (o and LSE) and _small_batched_attention_impl
in interpret mode, and K4 in fp32 (the same persistent loop as K11: a chain a
tap's 32-channel slice) to _temporal_conv_impl in interpret mode, each within
FP32_TOL of JAX and RMS_TOL of float64, with a one-pass negative control each.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from vidseg_diffusion_tpu.ops import attention as jatt
from vidseg_diffusion_tpu.ops import matmul as jmm
from vidseg_diffusion_tpu.ops import temporal_conv as jtc

FP32_TOL = 1e-4    # max |emulation - JAX| / max(1, max |JAX|)
RMS_TOL = 1e-5     # ||emulation - fp64|| / ||fp64||
LOG2_E = 1.4426950408889634
D = 512


def _tf32(x):
    """fp32 -> the nearest TF32 value (ties away from zero), as fp32."""
    bits = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _cut(x):
    """fp32 -> TF32 by dropping the low 13 bits, as the tensor cores read it."""
    bits = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    return (bits & np.uint32(0xFFFFE000)).view(np.float32)


def _split(x):
    hi = _cut(x)
    return hi, _tf32(x - hi)


def _mm_split(a, b):
    """a @ b as the kernels compute it: three TF32 products, fp32 sums."""
    ah, al = _split(a)
    bh, bl = _split(b)
    return (ah @ bl + al @ bh) + ah @ bh


def _mm_one_pass(a, b):
    return _cut(a) @ _cut(b)


def _mm64(a, b):
    return a.astype(np.float64) @ b.astype(np.float64)


def _forward(q, k, v, mm):
    """One [L, D] head: o and the base-2 LSE (the kernels' online softmax,
    which agrees with this up to fp32 rounding)."""
    dt = np.float64 if mm is _mm64 else np.float32
    qs = q.astype(dt) * dt(np.float32(LOG2_E / np.sqrt(D)))
    s = mm(qs, k.T)
    m = s.max(-1, keepdims=True)
    p = np.exp2(s - m)
    l = p.sum(-1, keepdims=True)
    return mm(p, v) / l, (m + np.log2(l))[:, 0]


def _backward(q, k, v, o, lse, g, mm):
    """dq, dk, dv of one head from the forward's o and LSE (K13's math)."""
    dt = np.float64 if mm is _mm64 else np.float32
    qs = q.astype(dt) * dt(np.float32(LOG2_E / np.sqrt(D)))
    p = np.exp2(mm(qs, k.T) - lse[:, None])
    delta = (g.astype(dt) * o).sum(-1)
    ds = p * (mm(g, v.T) - delta[:, None])
    return mm(ds, k) * dt(1 / np.sqrt(D)), mm(ds.T, qs) / dt(LOG2_E), mm(p.T, g)


def _inputs(seed, lq, lk, n):
    rs = np.random.RandomState(seed)
    shapes = [(lq, D), (lk, D), (lk, D), (lq, D)][:n]
    return [rs.randn(*s).astype(np.float32) for s in shapes]


def _max_err(got, want):
    return np.abs(got - want).max() / max(1.0, np.abs(want).max())


def _rel_rms(got, want):
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def test_split_forward_matches_the_pallas_kernel_and_fp64():
    """The forward at D = 512, Lq != Lk (320 queries, 448 keys) against
    _flash_attention_impl in interpret mode and against fp64."""
    q, k, v = _inputs(0, 320, 448, 3)
    want = np.asarray(jatt._flash_attention_impl(*(jnp.asarray(a)[None, None] for a in (q, k, v)),
                                                 interpret=True))[0, 0]
    got, _ = _forward(q, k, v, _mm_split)
    ref, _ = _forward(q, k, v, _mm64)
    assert _max_err(got, want) <= FP32_TOL
    assert _rel_rms(got, ref) <= RMS_TOL


def test_split_backward_matches_jax_vjp_and_fp64(monkeypatch):
    """dq, dk, dv at D = 512, Lq != Lk (256 queries, 384 keys) against
    jax.vjp of flash_attention with its Pallas backward in interpret mode
    (VIDSEG_PALLAS_ATTN_BWD=1) and against fp64, each from the emulated
    forward's o and LSE (the kernels' backward reads the forward kernel's)."""
    monkeypatch.setenv("VIDSEG_PALLAS_ATTN_BWD", "1")
    q, k, v, g = _inputs(1, 256, 384, 4)
    _, vjp = jax.vjp(lambda *a: jatt.flash_attention(*a, interpret=True),
                     *(jnp.asarray(a)[None, None] for a in (q, k, v)))
    want = [np.asarray(w)[0, 0] for w in vjp(jnp.asarray(g)[None, None])]
    o, lse = _forward(q, k, v, _mm_split)
    got = _backward(q, k, v, o, lse, g, _mm_split)
    o64, lse64 = _forward(q, k, v, _mm64)
    ref = _backward(q, k, v, o64, lse64, g, _mm64)
    for name, a, w, r in zip(("dq", "dk", "dv"), got, want, ref):
        assert _max_err(a, w) <= FP32_TOL, name
        assert _rel_rms(a, r) <= RMS_TOL, name


@pytest.mark.parametrize("which", ["forward", "backward"])
def test_one_tf32_pass_fails_the_bounds(which):
    """The negative control: one TF32 pass (no lo parts) reads above 1e-4 of
    max |fp64| at max error where the split reads under 1e-5."""
    q, k, v, g = _inputs(2, 256, 384, 4)
    o64, lse64 = _forward(q, k, v, _mm64)
    runs = {}
    for name, mm in (("split", _mm_split), ("one", _mm_one_pass)):
        o, lse = _forward(q, k, v, mm)
        runs[name] = [o] if which == "forward" else list(_backward(q, k, v, o, lse, g, mm))
    refs = [o64] if which == "forward" else list(_backward(q, k, v, o64, lse64, g, _mm64))
    err = {n: max(np.abs(a - r).max() / np.abs(r).max() for a, r in zip(runs[n], refs)) for n in runs}
    assert err["one"] > FP32_TOL, err
    assert err["split"] < 1e-5, err


def test_split_parts_are_tf32_and_exact():
    """hi and lo carry 10 mantissa bits each, hi + lo recovers x to 2^-21 of
    |x|, and lo's rounding is to nearest with ties away from zero."""
    x = np.random.RandomState(3).randn(4096).astype(np.float32) * np.float32(10.0) ** np.arange(-3, 5).repeat(512)
    hi, lo = _split(x)
    for part in (hi, lo):
        assert not np.any(part.view(np.uint32) & np.uint32(0x1FFF))
    assert np.all(np.abs(hi.astype(np.float64) + lo - x) <= np.abs(x).astype(np.float64) * 2.0 ** -21)
    one = np.float32(1.0)
    tie = (one.view(np.uint32) | np.uint32(0x1000)).view(np.float32)   # halfway between two TF32 values
    assert _tf32(np.array([tie, -tie])).tolist() == [1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10)]


# -- K6 at D = 512: the time mix's backward on the direct layout --------------------

K6_RMS_TOL = 2e-4    # K6's rms_tol in chip_smoke.py (relative RMS against the plain version)
PANEL = 32           # fp32 channels a chain on the tensor cores sums before the fp32 add


def _mm_split_panels(a, b):
    """a @ b over the channels as K6's kernel sums S and dP: each 32-channel
    panel on the tensor cores (the split, in fp32), the panels added in fp32."""
    out = np.zeros((a.shape[0], b.shape[1]), np.float32)
    for c in range(0, a.shape[1], PANEL):
        out += _mm_split(a[:, c:c + PANEL], b[c:c + PANEL])
    return out


def _k6_backward(q, k, v, o, g, mm, mm_channels):
    """dq, dk, dv of one problem (t frames x 512): the kernel's math with the
    products on `mm` (over the frames) and `mm_channels` (over the channels)."""
    dt = np.float64 if mm is _mm64 else np.float32
    scale = dt(1 / np.sqrt(D))
    qf = q.astype(dt) * dt(np.float32(LOG2_E / np.sqrt(D)))
    s = mm_channels(qf, k.T.astype(dt))
    e = np.exp2(s - s.max(-1, keepdims=True))
    p = e / e.sum(-1, keepdims=True)
    delta = (g.astype(dt) * o).sum(-1)
    ds = p * (mm_channels(g.astype(dt), v.T.astype(dt)) - delta[:, None])
    return mm(ds, k.astype(dt)) * scale, mm(ds.T, qf) / dt(LOG2_E), mm(p.T, g.astype(dt))


def _k6_run(t, s, seed, mm, mm_channels):
    """q, k, v, g [t, s, 1, 512] (one video), o from JAX's forward: the
    emulated gradients in the direct layout, and jax.vjp's."""
    rs = np.random.RandomState(seed)
    q, k, v, g = ((rs.randn(t, s, 1, D) * 1.5).astype(np.float32) for _ in range(4))
    fwd = lambda *a: jatt.temporal_attention_direct(*a, t=t, force=True, interpret=True)
    o, vjp = jax.vjp(fwd, *(jnp.asarray(a) for a in (q, k, v)))
    o = np.asarray(o)
    want = [np.asarray(w) for w in vjp(jnp.asarray(g))]
    got = [np.zeros((t, s, 1, D), np.float64 if mm is _mm64 else np.float32) for _ in range(3)]
    for j in range(s):
        for out, x in zip(got, _k6_backward(q[:, j, 0], k[:, j, 0], v[:, j, 0], o[:, j, 0], g[:, j, 0], mm,
                                            mm_channels)):
            out[:, j, 0] = x
    return got, want


@pytest.mark.parametrize("t", [7, 14])
def test_k6_split_matches_jax_vjp_and_fp64(t):
    """K6's split products at D = 512, t = 7 (the training clip) and 14 (a
    decode of 14 latents), 16 tokens: against jax.vjp of the direct-layout
    Pallas kernel (interpret mode) within FP32_TOL of max |JAX| and against
    fp64 of the same math within RMS_TOL."""
    got, want = _k6_run(t, 16, 40 + t, _mm_split, _mm_split_panels)
    ref, _ = _k6_run(t, 16, 40 + t, _mm64, _mm64)
    for name, a, w, r in zip(("dq", "dk", "dv"), got, want, ref):
        assert _max_err(a, w) <= FP32_TOL, name
        assert _rel_rms(a, r) <= RMS_TOL, name


def test_k6_one_tf32_pass_fails_its_bound():
    """The negative control at t = 14: one TF32 pass (no lo parts) reads above
    K6's relative RMS bound of 2e-4 against fp64 on some gradient, the split
    under RMS_TOL on every one."""
    ref, _ = _k6_run(14, 16, 60, _mm64, _mm64)
    one, _ = _k6_run(14, 16, 60, _mm_one_pass, _mm_one_pass)
    split, _ = _k6_run(14, 16, 60, _mm_split, _mm_split_panels)
    assert max(_rel_rms(a, r) for a, r in zip(one, ref)) > K6_RMS_TOL
    assert max(_rel_rms(a, r) for a, r in zip(split, ref)) < RMS_TOL


# -- K2 and K6 past 32 frames (csrc/temporal_attention_long_tc.cu) ------------------
#
# fp32 at D = 64 and 512: a team of D / 64 warps a problem, each warp's partial
# of S and dP over its 64 channels (two 32-channel chains on the tensor cores,
# added in fp32), the team's partials added in warp order; the row max over
# every key before any exp2; O, dq over 16-key tiles and dk, dv over 16-query
# tiles, one split chain a tile, the tiles added in fp32.

LONG_TILE = 16       # keys (O, dq) or queries (dk, dv) a chain of the fp32 kernels past 32 frames


def _long_channels(a, b, mm):
    """a @ b over the channels as the long kernels sum S and dP: per warp its
    two 32-channel chains added, then the warps' partials in warp order."""
    total = None
    for w in range(0, a.shape[1], 64):
        part = mm(a[:, w:w + PANEL], b[w:w + PANEL]) + mm(a[:, w + PANEL:w + 64], b[w + PANEL:w + 64])
        total = part if total is None else total + part
    return total


def _long_tiles(a, b, mm):
    """a @ b over the frames in tiles of LONG_TILE, one chain a tile, the tiles added."""
    out = mm(a[:, :LONG_TILE], b[:LONG_TILE])
    for c in range(LONG_TILE, a.shape[1], LONG_TILE):
        out = out + mm(a[:, c:c + LONG_TILE], b[c:c + LONG_TILE])
    return out


def _long_problem(q, k, v, o, g, d, mm):
    """O (o and g None) or dq, dk, dv of one problem [t, d] with the products on `mm`."""
    dt = np.float64 if mm is _mm64 else np.float32
    qf = q.astype(dt) * dt(np.float32(LOG2_E / np.sqrt(d)))
    k, v = k.astype(dt), v.astype(dt)
    s = _long_channels(qf, k.T, mm)
    e = np.exp2(s - s.max(-1, keepdims=True))
    if g is None:
        return (_long_tiles(e, v, mm) / e.sum(-1, keepdims=True),)
    g = g.astype(dt)
    p = e / e.sum(-1, keepdims=True)
    ds = p * (_long_channels(g, v.T, mm) - (g * o).sum(-1)[:, None])
    return (_long_tiles(ds, k, mm) * dt(1 / np.sqrt(d)), _long_tiles(ds.T, qf, mm) / dt(LOG2_E),
            _long_tiles(p.T, g, mm))


def _long_run(t, d, seed, mm, backward):
    """q, k, v (and g) [t, 16, H, d] (one video; H = 2 at D = 64, 1 at 512): the
    emulated output or gradients in the direct layout, and JAX's (the forward
    _temporal_direct_impl in interpret mode; the gradients jax.vjp of the
    direct-layout kernel, whose VJP runs the Pallas tiny-seq backward)."""
    h, s = (2 if d == 64 else 1), 16
    rs = np.random.RandomState(seed)
    q, k, v, g = ((rs.randn(t, s, h, d) * 1.5).astype(np.float32) for _ in range(4))
    if backward:
        fwd = lambda *a: jatt.temporal_attention_direct(*a, t=t, force=True, interpret=True)
        o, vjp = jax.vjp(fwd, *(jnp.asarray(a) for a in (q, k, v)))
        o = np.asarray(o)
        want = [np.asarray(w) for w in vjp(jnp.asarray(g))]
    else:
        o = g = None
        want = [np.asarray(jatt._temporal_direct_impl(*(jnp.asarray(a) for a in (q, k, v)), t, interpret=True))]
    got = [np.zeros((t, s, h, d), np.float64 if mm is _mm64 else np.float32) for _ in want]
    for j in range(s):
        for hh in range(h):
            x = lambda a: None if a is None else a[:, j, hh]
            for out, r in zip(got, _long_problem(x(q), x(k), x(v), x(o), x(g), d, mm)):
                out[:, j, hh] = r
    return got, want


@pytest.mark.parametrize("backward", [False, True], ids=["K2", "K6"])
@pytest.mark.parametrize("d", [64, 512])
@pytest.mark.parametrize("t", [33, 48])
def test_long_split_matches_jax_and_fp64(t, d, backward):
    """The long kernels' split products past 32 frames against JAX's direct
    kernel (or jax.vjp of it) in interpret mode within FP32_TOL of max |JAX|
    and against fp64 of the same math within RMS_TOL."""
    got, want = _long_run(t, d, 70 + t + d, _mm_split, backward)
    ref, _ = _long_run(t, d, 70 + t + d, _mm64, backward)
    for name, a, w, r in zip(("dq", "dk", "dv") if backward else ("o",), got, want, ref):
        assert _max_err(a, w) <= FP32_TOL, name
        assert _rel_rms(a, r) <= RMS_TOL, name


@pytest.mark.parametrize("d", [64, 512])
def test_long_one_tf32_pass_fails_its_bound(d):
    """The negative control at t = 48: one TF32 pass (no lo parts) reads above
    K6's relative RMS bound of 2e-4 against fp64 on some gradient and above
    RMS_TOL on K2's output, the split under RMS_TOL on every one."""
    for backward, bound in ((True, K6_RMS_TOL), (False, RMS_TOL)):
        ref, _ = _long_run(48, d, 90 + d, _mm64, backward)
        one, _ = _long_run(48, d, 90 + d, _mm_one_pass, backward)
        split, _ = _long_run(48, d, 90 + d, _mm_split, backward)
        assert max(_rel_rms(a, r) for a, r in zip(one, ref)) > bound, backward
        assert max(_rel_rms(a, r) for a, r in zip(split, ref)) < RMS_TOL, backward


# -- up to 32 frames on the same kernels (route 9, "tc_short") ----------------------
#
# K6 in fp32 at D = 64 from 2 to 32 frames runs the resident kernel on 16 or 32
# rows and K2 at D = 512 the team kernel: the products, chains and orders above
# (S and dP a warp's two 32-channel chains, at D = 512 the eight warps'
# partials in warp order; O, dq over 16-key tiles and dk, dv over 16-query
# tiles, a chain a tile, the tiles added in fp32), so the emulation is
# _long_run's. The key side of that K6 reads the query side's p and ds from
# shared memory: the same values as the emulation's one p and ds.

SHORT_CASES = [(7, 64, True), (14, 64, True), (17, 64, True), (32, 64, True), (7, 512, False), (14, 512, False),
               (32, 512, False)]


@pytest.mark.parametrize("t,d,backward", SHORT_CASES,
                         ids=[f"{'K6' if b else 'K2'}-{d}-{t}" for t, d, b in SHORT_CASES])
def test_short_split_matches_jax_and_fp64(t, d, backward):
    """K6 in fp32 at D = 64 (t = 7, 14, 17, 32: one 16-row tile, two, the
    ragged second tile) and K2 at D = 512 (t = 7, 14, 32) up to 32 frames:
    the split products against JAX's direct kernel (jax.vjp of it for K6) in
    interpret mode within FP32_TOL of max |JAX| and against fp64 of the same
    math within RMS_TOL."""
    got, want = _long_run(t, d, 110 + t + d, _mm_split, backward)
    ref, _ = _long_run(t, d, 110 + t + d, _mm64, backward)
    for name, a, w, r in zip(("dq", "dk", "dv") if backward else ("o",), got, want, ref):
        assert _max_err(a, w) <= FP32_TOL, name
        assert _rel_rms(a, r) <= RMS_TOL, name


def test_short_k6_one_tf32_pass_fails_its_bound():
    """The negative control for K6 in fp32 at D = 64, t = 14: one TF32 pass
    (no lo parts) reads above K6's relative RMS bound of 2e-4 against fp64 on
    some gradient, the split under RMS_TOL on every one."""
    ref, _ = _long_run(14, 64, 130, _mm64, True)
    one, _ = _long_run(14, 64, 130, _mm_one_pass, True)
    split, _ = _long_run(14, 64, 130, _mm_split, True)
    assert max(_rel_rms(a, r) for a, r in zip(one, ref)) > K6_RMS_TOL
    assert max(_rel_rms(a, r) for a, r in zip(split, ref)) < RMS_TOL


# -- K5 in fp32 at D = 64 (csrc/flash_attention_bwd_x3.cu) ---------------------------
#
# mma.sync m16n8k8 on split TF32: S and dP one chain a 32-column panel of the head
# dim, the two added in fp32; dQ over 32-key tiles and dK, dV over 32-query tiles,
# one chain a tile, the tiles added in fp32 in order. Both kernels read K1's o and
# LSE; here JAX's packed forward (interpret mode) gives them, and JAX's backward is
# jax.vjp of the packed flash attention, whose VJP runs the Pallas backward kernels.

K5_TILE = 32         # walked rows (keys for dq, queries for dk / dv) a chain of K5's fp32 kernels


def _tiled(a, b, mm, tile):
    """a @ b over the contraction in tiles of `tile`, one chain a tile, the tiles added in order."""
    out = mm(a[:, :tile], b[:tile])
    for c in range(tile, a.shape[1], tile):
        out = out + mm(a[:, c:c + tile], b[c:c + tile])
    return out


def _k5_head(q, k, v, o, lse, g, mm):
    """dq, dk, dv of one [L, 64] head from the forward's o and base-2 LSE, with
    K5's chains (fp32 with `mm` a split or one-pass product, float64 with _mm64)."""
    dt = np.float64 if mm is _mm64 else np.float32
    d = q.shape[1]
    q, k, v, o, lse, g = (x.astype(dt) for x in (q, k, v, o, lse, g))
    qf = q * dt(np.float32(LOG2_E / np.sqrt(d)))
    s = mm(qf[:, :PANEL], k[:, :PANEL].T) + mm(qf[:, PANEL:], k[:, PANEL:].T)
    dp = mm(g[:, :PANEL], v[:, :PANEL].T) + mm(g[:, PANEL:], v[:, PANEL:].T)
    p = np.exp2(s - lse[:, None])
    ds = p * (dp - (g * o).sum(-1)[:, None])
    return (_tiled(ds, k, mm, K5_TILE) * dt(np.float32(1 / np.sqrt(d))),
            _tiled(ds.T, qf, mm, K5_TILE) * dt(np.float32(1 / LOG2_E)), _tiled(p.T, g, mm, K5_TILE))


def _k5_run(b, lq, lk, h, seed, mms):
    """q, g [b, lq, h x 64], k, v [b, lk, h x 64]: jax.vjp's gradients (the Pallas
    backward in interpret mode) and, for each of `mms`, K5's math per head on
    JAX's forward o and LSE."""
    rs = np.random.RandomState(seed)
    q, g = ((rs.randn(b, lq, h * 64) * 1.5).astype(np.float32) for _ in range(2))
    k, v = ((rs.randn(b, lk, h * 64) * 1.5).astype(np.float32) for _ in range(2))
    out, vjp = jax.vjp(lambda *a: jatt.flash_attention_packed(*a, heads=h, interpret=True),
                       *(jnp.asarray(a) for a in (q, k, v)))
    want = [np.asarray(w) for w in vjp(jnp.asarray(g))]
    _, lse = jatt._flash_attention_packed_impl(*(jnp.asarray(a) for a in (q, k, v)), h, interpret=True,
                                               save_lse=True, fused_psum=jatt._fused_psum_enabled())
    o, lse = np.asarray(out), np.asarray(lse)   # lse [b, lq, h]
    runs = []
    for mm in mms:
        got = [np.zeros(x.shape, np.float64 if mm is _mm64 else np.float32) for x in (q, k, v)]
        for bi in range(b):
            for hh in range(h):
                c = slice(64 * hh, 64 * hh + 64)
                for x, r in zip(got, _k5_head(q[bi, :, c], k[bi, :, c], v[bi, :, c], o[bi, :, c], lse[bi, :, hh],
                                              g[bi, :, c], mm)):
                    x[bi, :, c] = r
        runs.append(got)
    return want, runs


K5_CASES = [(1, 100, 77, 2), (2, 45, 130, 5), (1, 96, 96, 3), (1, 33, 200, 4)]


@pytest.mark.parametrize("b,lq,lk,h", K5_CASES, ids=[f"{b}x{lq}x{lk}x{h}" for b, lq, lk, h in K5_CASES])
def test_k5_d64_split_matches_jax_vjp_and_fp64(monkeypatch, b, lq, lk, h):
    """K5 in fp32 at D = 64 with its kernels' chains (Lq != Lk both ways, ragged
    lengths off the 32-row tiles, heads 2 to 5): within FP32_TOL of max |JAX| of
    jax.vjp of the packed flash attention (its Pallas backward in interpret mode)
    and within RMS_TOL of the same math in float64 on the same o and LSE."""
    monkeypatch.setenv("VIDSEG_PALLAS_ATTN_BWD", "1")
    want, (got, ref) = _k5_run(b, lq, lk, h, 150 + lq + lk, (_mm_split, _mm64))
    for name, a, w, r in zip(("dq", "dk", "dv"), got, want, ref):
        assert _max_err(a, w) <= FP32_TOL, name
        assert _rel_rms(a, r) <= RMS_TOL, name


def test_k5_d64_one_tf32_pass_fails_its_bound(monkeypatch):
    """The negative control: K5's math with one TF32 pass (no lo parts) reads
    above RMS_TOL against float64 on some gradient, the split under it on every
    one."""
    monkeypatch.setenv("VIDSEG_PALLAS_ATTN_BWD", "1")
    _, (one, split, ref) = _k5_run(1, 100, 77, 2, 170, (_mm_one_pass, _mm_split, _mm64))
    assert max(_rel_rms(a, r) for a, r in zip(one, ref)) > RMS_TOL
    assert max(_rel_rms(a, r) for a, r in zip(split, ref)) < RMS_TOL


# -- K11 in fp32 (the persistent wgmma loop's split-TF32 consumer) --------------------
#
# Each 32-channel slice of K sums its three products on the tensor cores from zero
# and is added to the tile's accumulator in fp32 (_mm_split_panels), then the bias
# in fp32. The kernel forms both operands' lo parts as _split does (x's in shared
# memory, W's by a pass before the products).

def _k11(x, w, bias, mm_panels):
    y = mm_panels(x, w.T)
    return y if bias is None else y + bias


@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("m,k,n", [(77, 320, 640), (130, 640, 320), (201, 1024, 160), (193, 1032, 168)])
def test_k11_split_matches_the_pallas_kernel_and_fp64(m, k, n, with_bias):
    """K11 in fp32 with its chains at K = 320, 640, 1024 and 1032 (a last slice
    of 8 channels) and a ragged M and N, with and without a bias: within FP32_TOL of max |JAX| of _matmul_bias_impl in
    interpret mode (zeros for a missing bias, as the JAX layers hand it) and
    within RMS_TOL of float64."""
    rs = np.random.RandomState(m + k + n + with_bias)
    x = rs.randn(m, k).astype(np.float32)
    w = (rs.randn(n, k) / np.sqrt(k)).astype(np.float32)   # nn.Linear's [N, K]; JAX's kernel is its transpose
    bias = rs.randn(n).astype(np.float32) if with_bias else None
    want = np.asarray(jmm._matmul_bias_impl(jnp.asarray(x), jnp.asarray(w.T),
                                            jnp.asarray(bias if with_bias else np.zeros(n, np.float32)),
                                            interpret=True))
    got = _k11(x, w, bias, _mm_split_panels)
    ref = _k11(x.astype(np.float64), w.astype(np.float64), None if bias is None else bias.astype(np.float64), _mm64)
    assert _max_err(got, want) <= FP32_TOL
    assert _rel_rms(got, ref) <= RMS_TOL


def test_k11_one_tf32_pass_fails_its_bound():
    """The negative control: one TF32 pass (no lo parts) reads above RMS_TOL
    against float64, the split under it."""
    rs = np.random.RandomState(190)
    x, w = rs.randn(130, 640).astype(np.float32), (rs.randn(320, 640) / np.sqrt(640)).astype(np.float32)
    ref = _mm64(x, w.T)
    one = sum(_mm_one_pass(x[:, c:c + PANEL], w.T[c:c + PANEL]) for c in range(0, 640, PANEL))
    assert _rel_rms(one, ref) > RMS_TOL
    assert _rel_rms(_k11(x, w, None, _mm_split_panels), ref) < RMS_TOL



# -- K1 / K3 in fp32 at D = 64 (csrc/flash_attention_x3.cu) --------------------------
#
# mma.sync m16n8k8 on split TF32: qf = q * qscale in fp32, S one chain a 32-column
# panel of the head dim (the two added in fp32: _mm_split_panels), a base-2 online
# softmax over 32-key tiles (the running max and sum rescaled by exp2(m_old - m_new)),
# and P V one chain a key tile, added to the rescaled output in fp32; o = acc / l,
# LSE = m + log2 l. In fp32 the bf16 kernels' roundings are the identity, so the one
# kernel stands for _flash_kernel_packed (with its LSE), _small_seq_kernel and
# _flash_kernel.

K1_TILE = 32         # keys a tile of K1's fp32 kernel: one P V chain


def _k1_head(q, k, v, mm):
    """o and the base-2 LSE of one [L, 64] head with K1's chains (fp32 with `mm`
    a split or one-pass product, float64 with _mm64)."""
    dt = np.float64 if mm is _mm64 else np.float32
    d = q.shape[1]
    q, k, v = (x.astype(dt) for x in (q, k, v))
    qf = q * dt(np.float32(LOG2_E / np.sqrt(d)))
    panels = (lambda a, b: a @ b) if mm is _mm64 else (
        lambda a, b: _mm_split_panels(a, b) if mm is _mm_split else sum(
            _mm_one_pass(a[:, c:c + PANEL], b[c:c + PANEL]) for c in range(0, a.shape[1], PANEL)))
    s = panels(qf, k.T)
    m = np.full(q.shape[0], -np.inf, dt)
    l = np.zeros(q.shape[0], dt)
    acc = np.zeros(q.shape, dt)
    for c in range(0, k.shape[0], K1_TILE):
        st = s[:, c:c + K1_TILE]
        mx = np.maximum(m, st.max(-1))
        alpha = np.exp2(m - mx)
        p = np.exp2(st - mx[:, None])
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[:, None] + mm(p, v[c:c + K1_TILE])
        m = mx
    return acc / l[:, None], m + np.log2(l)


def _k1_run(q, k, v, h, mms):
    """q [b, lq, h x 64], k, v [b, lk, h x 64]: for each of `mms`, K1's o and LSE [b, lq, h]."""
    runs = []
    for mm in mms:
        dt = np.float64 if mm is _mm64 else np.float32
        o, lse = np.zeros(q.shape, dt), np.zeros(q.shape[:2] + (h,), dt)
        for bi in range(q.shape[0]):
            for hh in range(h):
                c = slice(64 * hh, 64 * hh + 64)
                o[bi, :, c], lse[bi, :, hh] = _k1_head(q[bi, :, c], k[bi, :, c], v[bi, :, c], mm)
        runs.append((o, lse))
    return runs


def _k1_inputs(b, lq, lk, h, seed):
    rs = np.random.RandomState(seed)
    return ((rs.randn(b, lq, h * 64) * 1.5).astype(np.float32), (rs.randn(b, lk, h * 64) * 1.5).astype(np.float32),
            rs.randn(b, lk, h * 64).astype(np.float32))


K1_CASES = [(1, 77, 91, 2), (2, 91, 77, 3), (1, 257, 257, 2), (1, 100, 45, 5), (2, 33, 130, 1)]


@pytest.mark.parametrize("b,lq,lk,h", K1_CASES, ids=[f"{b}x{lq}x{lk}x{h}" for b, lq, lk, h in K1_CASES])
def test_k1_d64_split_matches_the_pallas_kernel_and_fp64(b, lq, lk, h):
    """K1 in fp32 at D = 64 with its kernel's chains (77, 91 and 257 tokens,
    Lq != Lk both ways, lengths off the 32-key tiles): o and LSE within FP32_TOL
    of max |JAX| of _flash_attention_packed_impl in interpret mode (save_lse)
    and within RMS_TOL of the same math in float64."""
    q, k, v = _k1_inputs(b, lq, lk, h, 210 + lq + lk)
    want_o, want_lse = jatt._flash_attention_packed_impl(*(jnp.asarray(a) for a in (q, k, v)), h, interpret=True,
                                                         save_lse=True, fused_psum=jatt._fused_psum_enabled())
    (o, lse), (o64, lse64) = _k1_run(q, k, v, h, (_mm_split, _mm64))
    assert _max_err(o, np.asarray(want_o)) <= FP32_TOL
    assert _max_err(lse, np.asarray(want_lse)) <= FP32_TOL
    assert _rel_rms(o, o64) <= RMS_TOL
    assert _rel_rms(lse, lse64) <= RMS_TOL


@pytest.mark.parametrize("b,l,h", [(4, 91, 2), (2, 77, 3)])
def test_k1_d64_split_matches_the_short_site_kernel(b, l, h):
    """K1 in fp32 at a short site (the one kernel serves _small_seq_kernel's
    fp32 sum too): within FP32_TOL of max |JAX| of
    _small_batched_attention_impl in interpret mode and within RMS_TOL of
    float64."""
    q, k, v = _k1_inputs(b, l, l, h, 230 + l)
    heads = lambda a: jnp.asarray(a).reshape(b, l, h, 64)
    want = np.asarray(jatt._small_batched_attention_impl(heads(q), heads(k), heads(v), interpret=True))
    (o, _), (o64, _) = _k1_run(q, k, v, h, (_mm_split, _mm64))
    assert _max_err(o, want.reshape(b, l, h * 64)) <= FP32_TOL
    assert _rel_rms(o, o64) <= RMS_TOL


def test_k1_d64_one_tf32_pass_fails_its_bound():
    """The negative control: K1's math with one TF32 pass (no lo parts) reads
    above RMS_TOL against float64, the split under it."""
    q, k, v = _k1_inputs(1, 257, 257, 2, 250)
    (one, _), (split, _), (ref, _) = _k1_run(q, k, v, 2, (_mm_one_pass, _mm_split, _mm64))
    assert _rel_rms(one, ref) > RMS_TOL
    assert _rel_rms(split, ref) < RMS_TOL


# -- K4 in fp32 (the persistent wgmma loop's split-TF32 consumer, csrc/temporal_conv.cu) --
#
# y[b, t] = sum_j x[b, t + j - kt // 2] @ W[j] + bias: a tile's slices are its taps
# whose frame exists (in tap order) by 32-channel slices of Cin, each slice's three
# products summed on the tensor cores from zero and added to the tile's accumulator in
# fp32 (the last slice of Cin = 1032 holds 8 channels, the rest zeros), then the bias.

def _k4(x, w, bias, mm):
    """K4's output [B, T, M, Cout] with its chains: x [B, T, M, Cin], w [kt, Cin,
    Cout] (JAX's layout), bias [Cout] or None; `mm` a split or one-pass product
    in fp32, or _mm64."""
    dt = np.float64 if mm is _mm64 else np.float32
    b, t, m, cin = x.shape
    kt, cout = w.shape[0], w.shape[2]
    x, w = x.astype(dt), w.astype(dt)
    y = np.zeros((b, t, m, cout), dt)
    for bi in range(b):
        for f in range(t):
            for j in range(kt):
                src = f + j - kt // 2
                if not 0 <= src < t:
                    continue
                for c in range(0, cin, PANEL):
                    y[bi, f] += mm(x[bi, src, :, c:c + PANEL], w[j, c:c + PANEL])
    return y if bias is None else y + bias.astype(dt)


K4_CASES = [(1, 1, 9, 320, 160, 3), (2, 2, 7, 320, 96, 1), (1, 14, 5, 320, 160, 3), (1, 2, 6, 1032, 168, 3),
            (1, 14, 4, 1032, 64, 1)]


@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("b,t,m,cin,cout,kt", K4_CASES, ids=[f"t{t}_cin{ci}_kt{kt}" for _, t, _, ci, _, kt in K4_CASES])
def test_k4_split_matches_the_pallas_kernel_and_fp64(b, t, m, cin, cout, kt, with_bias):
    """K4 in fp32 with its chains at kt = 1 and 3, T = 1, 2 and 14, Cin = 320
    and 1032 (a last slice of 8 channels), with and without a bias: within
    FP32_TOL of max |JAX| of _temporal_conv_impl in interpret mode (zeros for
    a missing bias) and within RMS_TOL of float64."""
    rs = np.random.RandomState(b + t + m + cin + cout + kt + with_bias)
    x = rs.randn(b, t, m, cin).astype(np.float32)
    w = (rs.randn(kt, cin, cout) / np.sqrt(kt * cin)).astype(np.float32)
    bias = rs.randn(cout).astype(np.float32) if with_bias else None
    want = np.asarray(jtc._temporal_conv_impl(jnp.asarray(x), jnp.asarray(w),
                                              jnp.asarray(bias if with_bias else np.zeros(cout, np.float32)),
                                              interpret=True))
    got = _k4(x, w, bias, _mm_split)
    assert _max_err(got, want) <= FP32_TOL
    assert _rel_rms(got, _k4(x, w, bias, _mm64)) <= RMS_TOL


def test_k4_one_tf32_pass_fails_its_bound():
    """The negative control: K4's math with one TF32 pass (no lo parts) reads
    above RMS_TOL against float64, the split under it."""
    rs = np.random.RandomState(260)
    x = rs.randn(1, 3, 16, 320).astype(np.float32)
    w = (rs.randn(3, 320, 160) / np.sqrt(960)).astype(np.float32)
    ref = _k4(x, w, None, _mm64)
    assert _rel_rms(_k4(x, w, None, _mm_one_pass), ref) > RMS_TOL
    assert _rel_rms(_k4(x, w, None, _mm_split), ref) < RMS_TOL
