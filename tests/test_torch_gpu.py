"""The CUDA kernels (K1-K13, the fused GroupNorm forward) against their plain
versions, on the card.

Every test here needs a CUDA card and skips without one. The file imports
no JAX, so on a machine with a card and no JAX it runs without the suite's
conftest:

    python -m pytest tests/test_torch_gpu.py --noconftest -q

Inputs come from a seeded generator on the card; kernel and plain version
see the same tensors. Forward tolerance: max |kernel - plain| <= TOL *
max(1, max |plain|), with TOL 1e-2 in bf16 (a bf16 rounding step or two of
the output: the kernels accumulate in fp32 in another order) and 1e-4 in
fp32. The backward kernels (K5, K6, and K4 launched for dx) are held to
their plain backward versions on each of dq/dk/dv (dx/dW/db) with chip_smoke.py's
bounds and no floor of 1: in bf16, max |kernel - plain| <= 2 bf16 steps at
max |plain| and ||kernel - plain|| <= RMS_TOL * ||plain|| (per kernel, as
chip_smoke.py); in fp32 both relative to 1e-4. A gradient that is 0 up to
rounding (K6's dq and dk at t = 1) is measured against GRAD_FLOOR times the
largest gradient of the same call. K1's saved LSE: within LSE_TOL (log2
units) of the plain LSE. The GroupNorm kernels (K7 + K8 forward; the slab
kernel or K9 + K10 backward) take the same bounds with RMS_TOL["GN"]; K7's mean and inv-std are
also held to fp64 statistics of the same input (STATS_TOL, relative). K11
(matmul_bias) and K12 (conv3x3_same) take chip_smoke.py's forward bounds too
(2 bf16 steps at max |plain|, RMS_TOL["K11"] / ["K12"]; fp32 1e-4). K13
(the bhld backward of K3) takes the backward bounds with RMS_TOL["K13"], on
the LSE that K3 writes under a gradient (held to the plain LSE within
LSE_TOL). Modules under autograd (the VAE's AttnBlock) hold the card's
parameter gradients to the CPU's plain path within GRAD_REL_TOL by norm.
K1 (bf16, D = 64, also through K3's bhld entry), K11 and K4 (bf16 that TMA
can address) run wgmma kernels: their wrappers' route counters
(`.wgmma_launches`) must move with the launch counters, an unaddressable K11
input must take the mma.sync tile and a K4 input off the 8-element vector or
off a 16-byte boundary the narrow kernel (`.narrow_launches`); K1 takes
chip_smoke.py's forward bounds there (RMS_TOL["K1"]). K2 and K6 at D = 64 run
on the tensor cores in bf16 up to 32 frames: their `.mma_launches` counters
move with every bf16 launch and with no fp32 one, within chip_smoke.py's
bounds (RMS_TOL["K2"], ["K6"]); fp32 K2 there runs on CUDA cores, fp32 K6
from 2 frames on the resident split-TF32 kernel of
csrc/temporal_attention_long_tc.cu (`.tc_short_launches`, also held to the
plain version in float64 within FP64_RMS_TOL; one frame and a base off 16
bytes on CUDA cores, `.fma_launches`); past 32 frames
(`.long_launches`, by head dim `.dim_launches`) D = 64 and 512 run the
tensor-core kernels of csrc/temporal_attention_long_tc.cu in both dtypes and
D = 16 the frame-walking kernels, with no frame cap (t = 200), bitwise
repeatable, an unaligned base refused before any launch. The attention kernels sum the softmax
denominator as the JAX kernel of their site does (K1 at a short site and K3
without a gradient: the fp32 p; K1 at a long site and K3 under a gradient: the
rounded p), each held to the plain version with that sum; at the sites JAX's
TPU dispatch sends to mha_reference (ops.attention.site_route) the dispatcher
runs their normalise-first mode (`.normalised_launches`), held to
mha_reference within one bf16 step and 0.1 % of the elements differing. K5 and
K13 (bf16 D = 512) run wgmma kernels: `.wgmma_launches` moves with every bf16
launch; K5 and K13 at bf16 D = 16 the mma.sync kernels (K5's `.mma_launches`),
K6 at D = 512 from 4 (bf16) / 5 (fp32) to 32 frames its tensor-core kernels
(bf16 `.mma_launches`), below them the wide kernel (`.wide_launches`); K2 at
D = 512 up to 32 frames the team kernel of temporal_attention_long_tc.cu from
K2_TC512_FRAMES (`.tc_short_launches`; fp32 also within FP64_RMS_TOL of
float64), the wide kernel below them. In fp32
at D = 512, K1 / K3, K5 / K13 and K6 from 5 to 32 frames run the kernels on split TF32 products
(`.tf32x3_launches`), also held to the plain versions run in float64 (relative
RMS within FP64_RMS_TOL); so do K1 / K3 and K5 at D = 64 and K11 and K4 where
TMA can address their inputs (the others on `.fma_launches`). Those tensor-core backwards give the same bits from
run to run and from a thread that has launched nothing. The GroupNorm forward
takes the fused one-launch kernel or K7 + K8 as ops.norm.group_norm_route
says, the backward the slab kernel (one launch, on one block or a cluster) or
K9 + K10 as ops.norm.group_norm_backward_route says; both are bitwise the
same from run to run on every route.
"""

import math
import os

import pytest
import torch

from vidseg_diffusion_tpu_torch.ops import attention as A
from vidseg_diffusion_tpu_torch.ops import conv3x3 as C3
from vidseg_diffusion_tpu_torch.ops import matmul as MM
from vidseg_diffusion_tpu_torch.ops import norm as N
from vidseg_diffusion_tpu_torch.ops import temporal_conv as TC

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-4}
DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32}
RMS_TOL = {"K1": 4e-3, "K2": 1e-3, "K3": 4e-3, "K4": 5e-4, "K5": 1e-3, "K6": 2e-4, "GN": 5e-4, "K11": 5e-4, "K12": 5e-4,
           "K13": 1e-3}  # bf16; fp32 is FP32_TOL
STATS_TOL = 2e-5  # K7's fp32 mean (relative to the rms of x) and inv-std vs fp64
MAX_STEPS = 2
FP32_TOL = 1e-4
GRAD_FLOOR = 1e-2  # fp32 rounding noise of K6's t = 1 dq reads 5.8e-7 at a largest gradient of 3.5
LSE_TOL = 5e-3
GRAD_REL_TOL = 1e-4  # fp32 module gradients, card vs CPU, by norm (chip_smoke.py's bound)
FP64_RMS_TOL = 1e-5  # the split-TF32 kernels vs the plain version in float64, relative RMS (chip_smoke.py's)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False  # fp32 plain versions in full fp32
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = saved


def _randn(cuda, seed, dtype, *shape, scale=1.0):
    g = torch.Generator(device=cuda).manual_seed(seed)
    return (torch.randn(*shape, generator=g, device=cuda) * scale).to(dtype)


def _close(out, ref):
    assert out.shape == ref.shape and out.dtype == ref.dtype
    assert bool(torch.isfinite(out).all())
    err = (out.float() - ref.float()).abs().max().item()
    scale = max(1.0, ref.float().abs().max().item())
    assert err <= TOL[out.dtype] * scale, (err, scale)


def _close_grads(outs, refs, rms_tol):
    """The backward bounds of the module docstring, on each gradient."""
    floor_peak = GRAD_FLOOR * max(r.float().abs().max().item() for r in refs)
    floor_norm = GRAD_FLOOR * max(r.float().norm().item() for r in refs)
    for o, r in zip(outs, refs):
        assert o.shape == r.shape and o.dtype == r.dtype
        assert bool(torch.isfinite(o).all())
        diff = o.float() - r.float()
        peak = max(r.float().abs().max().item(), floor_peak)
        if o.dtype == torch.bfloat16:
            bound, rms_bound = MAX_STEPS * 2.0 ** (math.floor(math.log2(peak)) - 7), rms_tol
        else:
            bound, rms_bound = FP32_TOL * peak, FP32_TOL
        err = diff.abs().max().item()
        rms = diff.norm().item() / max(r.float().norm().item(), floor_norm)
        assert err <= bound and rms <= rms_bound, (err, bound, rms, rms_bound)


def _check(fn, plain, *args, rms_tol=None, **kwargs):
    """Run the kernel wrapper once (its launch counter moves, the plain
    version's call counter does not), then the plain version, and compare:
    a forward with _close, a backward (rms_tol given) with _close_grads."""
    launches, calls = fn.launches, plain.calls
    out = fn(*args, **kwargs)
    torch.cuda.synchronize()
    assert fn.launches == launches + 1 and plain.calls == calls
    ref = plain(*args, **kwargs)
    outs, refs = (out, ref) if isinstance(out, tuple) else ((out,), (ref,))
    if rms_tol is not None:
        _close_grads(outs, refs, rms_tol)
        return
    for o, r in zip(outs, refs):
        _close(o, r)


@pytest.mark.gpu
@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("b,lq,lk,h", [(2, 300, 300, 2), (28, 91, 91, 4), (6, 14, 14, 3), (2, 100, 37, 2)])
def test_flash_attention_packed(cuda, dt, b, lq, lk, h):
    dtype = DTYPES[dt]
    q = _randn(cuda, 1, dtype, b, lq, h * 64)
    k, v = (_randn(cuda, s, dtype, b, lk, h * 64) for s in (2, 3))
    _check(A.flash_attention_packed, A.flash_attention_packed_reference, q, k, v, heads=h)


@pytest.mark.gpu
def test_flash_attention_packed_refuses_unaligned_bf16(cuda):
    x = _randn(cuda, 4, torch.bfloat16, 1, 64 * 16 * 2 + 1)[:, 1:].reshape(1, 32, 64)
    with pytest.raises(ValueError, match="aligned"):
        A.flash_attention_packed(x, x, x, heads=1)


# K1's wgmma kernel (bf16): one query row and one key, Lq off the 64-row tile
# at 77 / 91 / 364 keys (the short-walk shape of the kernel), 5824 keys (the
# long-walk shape: two warpgroups, 128-key tiles) with Lq on and off the tile
K1_WGMMA_SHAPES = [(3, 1, 1, 2), (2, 1, 77, 2), (2, 77, 77, 3), (28, 91, 77, 4), (4, 91, 91, 20),
                   (2, 364, 364, 20), (1, 5824, 77, 5), (1, 5824, 5824, 2), (2, 130, 5824, 1)]


@pytest.mark.gpu
@pytest.mark.parametrize("b,lq,lk,h", K1_WGMMA_SHAPES)
def test_flash_attention_packed_wgmma_route(cuda, b, lq, lk, h):
    """bf16 K1 runs the wgmma kernel (its route counter moves with its launch
    counter) within chip_smoke.py's bounds of the plain version, and its
    saved LSE within LSE_TOL of the plain LSE."""
    bf = torch.bfloat16
    q = _randn(cuda, 120, bf, b, lq, h * 64)
    k, v = (_randn(cuda, s, bf, b, lk, h * 64) for s in (121, 122))
    wg = A.flash_attention_packed.wgmma_launches
    out = _check_forward(A.flash_attention_packed, A.flash_attention_packed_reference, RMS_TOL["K1"], q, k, v, h)
    assert A.flash_attention_packed.wgmma_launches == wg + 1 and out.shape == q.shape
    out2, lse = A._flash_attention_packed_forward(q, k, v, h, None, save_lse=True)
    _, lse_ref = A.flash_attention_packed_reference(q, k, v, h, save_lse=True)
    assert torch.equal(out2, out) and lse.shape == (b, lq, h)
    assert (lse - lse_ref).abs().max().item() <= LSE_TOL


@pytest.mark.gpu
@pytest.mark.parametrize("b,l,h", [(2, 300, 4), (1, 3000, 2)])
def test_flash_attention_packed_reads_fused_qkv_slices_in_place(cuda, b, l, h):
    """q, k, v as strided slices of one fused [B, L, 3*H*64] projection (a row
    stride of 3*H*64) are read in place by the tensor maps: no copy, same
    result as the plain version on contiguous copies."""
    bf = torch.bfloat16
    qkv = _randn(cuda, 123, bf, b, l, 3 * h * 64)
    q, k, v = qkv.split(h * 64, dim=-1)
    assert not q.is_contiguous() and q.stride(1) == 3 * h * 64
    wg = A.flash_attention_packed.wgmma_launches
    out = A.flash_attention_packed(q, k, v, h)
    torch.cuda.synchronize()
    assert A.flash_attention_packed.wgmma_launches == wg + 1
    ref = A.flash_attention_packed_reference(q.contiguous(), k.contiguous(), v.contiguous(), h)
    _close_grads((out,), (ref,), RMS_TOL["K1"])


@pytest.mark.gpu
@pytest.mark.parametrize("lq,lk", [(300, 300), (130, 3000)])
def test_flash_attention_packed_autograd_matches_the_plain_forward(cuda, lq, lk):
    """Autograd through K1 (its wgmma kernel writing the LSE) and K5 against
    autograd through the plain forward, same bf16 inputs and output gradient:
    each of dq, dk, dv within 1e-2 of its norm. (K5 rounds p and ds to bf16
    before its products, as the JAX kernels do, and autograd of the plain
    forward does not; a wrong LSE or a wrong p moves the gradients by O(1).)"""
    bf, h, b = torch.bfloat16, 2, 2
    q = _randn(cuda, 124, bf, b, lq, h * 64)
    k, v = (_randn(cuda, s, bf, b, lk, h * 64) for s in (125, 126))
    g = _randn(cuda, 127, bf, b, lq, h * 64)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    k5 = A.flash_attention_packed_backward.launches
    A.flash_attention_packed(*leaves, h).backward(g)
    assert A.flash_attention_packed_backward.launches == k5 + 1
    ref = [t.clone().requires_grad_() for t in (q, k, v)]
    A.flash_attention_packed_reference(*ref, h).backward(g)
    for got, want in zip(leaves, ref):
        assert bool(torch.isfinite(got.grad).all())
        rel = (got.grad.float() - want.grad.float()).norm().item() / want.grad.float().norm().item()
        assert rel <= 1e-2, rel


@pytest.mark.gpu
def test_flash_attention_bhld_d64_takes_the_wgmma_kernel(cuda):
    """K3 at D = 64 in bf16 (contiguous bhld and [B, L, H, D] seen as bhld)
    runs K1's wgmma kernel: its route counter moves, the output and the LSE
    agree with the plain version."""
    bf = torch.bfloat16
    for q, k, v in (tuple(_randn(cuda, i, bf, 2, 3, 100, 64) for i in (128, 129, 130)),
                    tuple(_randn(cuda, i, bf, 2, 90, 3, 64).transpose(1, 2) for i in (131, 132, 133))):
        wg = A.flash_attention.wgmma_launches
        _check_forward(A.flash_attention, A.flash_attention_reference, RMS_TOL["K1"], q, k, v)
        out, lse = A._flash_attention_forward(q, k, v, None, save_lse=True)
        assert A.flash_attention.wgmma_launches == wg + 2
        _, lse_ref = A.flash_attention_reference(q, k, v, save_lse=True)
        assert (lse - lse_ref).abs().max().item() <= LSE_TOL


@pytest.mark.gpu
@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("b,t,s,h", [(2, 14, 20, 2), (2, 1, 16, 1), (1, 32, 9, 2), (3, 5, 91, 3)])
def test_temporal_attention_direct(cuda, dt, b, t, s, h):
    dtype = DTYPES[dt]
    q, k, v = (_randn(cuda, i, dtype, b * t, s, h, 64) for i in (5, 6, 7))
    _check(A.temporal_attention_direct, A.temporal_attention_direct_reference, q, k, v, t=t)


# K2 / K6 on their routes: one frame, the main path's 14, a full 16-frame box,
# one frame past it and two full boxes (32-frame boxes, two row tiles), then past
# 32 frames (the tensor-core tiles of temporal_attention_long_tc.cu); tokens off the 8- and 4-token units; one
# head, the ds1 and the ds4 / mid head counts
TEMPORAL_ROUTE_CASES = [(t, s, h) for t in (1, 14, 16, 17, 32, 33, 48, 64) for s in (9, 91, 364) for h in (1, 5, 20)]


@pytest.mark.gpu
@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("t,s,h", TEMPORAL_ROUTE_CASES)
def test_temporal_attention_direct_mma_route(cuda, dt, t, s, h):
    """bf16 K2 runs on the tensor cores up to 32 frames (its route counter
    moves with its launch counter), fp32 on CUDA cores (it does not), both past
    32 frames on the long route's tensor-core kernel (`.long_launches`), each within
    chip_smoke.py's forward bounds of the plain version."""
    dtype = DTYPES[dt]
    q, k, v = (_randn(cuda, i, dtype, 2 * t, s, h, 64) for i in (140, 141, 142))
    fn = A.temporal_attention_direct
    mma, long_ = fn.mma_launches, fn.long_launches
    launches, calls = fn.launches, A.temporal_attention_direct_reference.calls
    out = fn(q, k, v, t=t)
    torch.cuda.synchronize()
    assert fn.launches == launches + 1
    assert A.temporal_attention_direct_reference.calls == calls
    tiled = t <= A.TILED_FRAMES
    assert (fn.mma_launches, fn.long_launches) == (mma + (tiled and dtype == torch.bfloat16), long_ + (not tiled))
    _close_grads((out,), (A.temporal_attention_direct_reference(q, k, v, t=t),), RMS_TOL["K2"])


@pytest.mark.gpu
@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("t,s,h", TEMPORAL_ROUTE_CASES)
def test_temporal_attention_direct_backward_mma_route(cuda, dt, t, s, h):
    """bf16 K6 runs on the tensor cores up to 32 frames (`.mma_launches`),
    fp32 from 2 frames on the resident split-TF32 kernel
    (`.tc_short_launches`; one frame on CUDA cores), both past
    32 frames on the long route's tensor-core kernel (the route counters say
    which), each within chip_smoke.py's backward bounds of the plain version on
    every gradient."""
    dtype = DTYPES[dt]
    q, k, v, g = (_randn(cuda, i, dtype, 2 * t, s, h, 64) for i in (143, 144, 145, 146))
    out = A.temporal_attention_direct_reference(q, k, v, t=t)
    fn = A.temporal_attention_direct_backward
    mma, short, long_ = fn.mma_launches, fn.tc_short_launches, fn.long_launches
    _check(fn, A.temporal_attention_direct_backward_reference, q, k, v, out, g, t, rms_tol=RMS_TOL["K6"])
    tiled, bf16 = t <= A.TILED_FRAMES, dtype == torch.bfloat16
    assert (fn.mma_launches, fn.tc_short_launches, fn.long_launches) == (
        mma + (tiled and bf16), short + (1 < t <= A.TILED_FRAMES and not bf16), long_ + (not tiled))


def _denominator_held(out, lse, plain, rounded):
    """The output and LSE of a kernel told to sum the rounded p (or the fp32
    p) against `plain(psum_rounded)` -> (out, lse) of either sum, at one key
    tile, where the kernel's p equal the plain version's: at least 1 % of the
    elements differ from the plain output with the other sum (inputs of std
    1.5: 3-6 % on the CPU) and ten times fewer from the one with the same sum
    (the summation order alone: 0.02 % at D = 64, 0.2 % at D = 512 on the
    card), and the LSE lies ten times closer, on average, to the same sum's."""
    own, other = plain(rounded), plain(not rounded)
    frac = lambda ref: (out.float() != ref[0].float()).float().mean().item()
    assert frac(other) >= 1e-2 and frac(own) <= 0.1 * frac(other), (frac(own), frac(other))
    if lse is not None:
        gap = lambda ref: (lse - ref[1]).abs().mean().item()
        assert gap(own) <= 0.1 * gap(other), (gap(own), gap(other))


@pytest.mark.gpu
@pytest.mark.parametrize("rounded", [False, True])
def test_flash_attention_packed_sums_the_denominator_it_is_told(cuda, rounded):
    """K1's wgmma kernel, 60 keys (one key tile): psum_rounded False (the
    short sites) sums the fp32 p, True (the long sites) the rounded p, with
    and without the LSE."""
    bf, b, l, h = torch.bfloat16, 28, 60, 4
    q, k, v = (_randn(cuda, 147 + i, bf, b, l, h * 64, scale=1.5) for i in range(3))
    plain = lambda r: A.flash_attention_packed_reference(q, k, v, h, save_lse=True, psum_rounded=r)
    wg = A.flash_attention_packed.wgmma_launches
    out = A.flash_attention_packed(q, k, v, h, psum_rounded=rounded)
    out_lse, lse = A._flash_attention_packed_forward(q, k, v, h, None, save_lse=True, psum_rounded=rounded)
    torch.cuda.synchronize()
    assert A.flash_attention_packed.wgmma_launches == wg + 2 and torch.equal(out, out_lse)
    _denominator_held(out, lse, plain, rounded)


@pytest.mark.gpu
@pytest.mark.parametrize("b,l,h", [(28, 91, 20), (28, 364, 20), (2, 600, 2)])
def test_small_batched_attention_takes_the_denominator_of_its_site(cuda, b, l, h):
    """small_batched_attention (every blhd site on the card) runs K1's wgmma
    kernel with the fp32 sum at the short sites (max(Lq, Lk) < 512: the SVD
    ds4 and mid spatial sites) and the rounded sum at the long ones: held to
    the plain version with that sum within chip_smoke.py's K1 bounds."""
    bf = torch.bfloat16
    q, k, v = (_randn(cuda, 150 + i, bf, b, l, h, 64) for i in range(3))
    wg = A.flash_attention_packed.wgmma_launches
    out = A.small_batched_attention(q, k, v)
    torch.cuda.synchronize()
    assert A.flash_attention_packed.wgmma_launches == wg + 1
    packed = [x.reshape(b, l, h * 64) for x in (q, k, v)]
    ref = A.flash_attention_packed_reference(*packed, h, psum_rounded=l >= A.SHORT_SEQ)
    _close_grads((out.reshape(b, l, h * 64),), (ref,), RMS_TOL["K1"])


@pytest.mark.gpu
@pytest.mark.parametrize("d,lk", [(512, 32), (64, 60), (80, 60)])
def test_flash_attention_bhld_denominator_without_and_with_a_gradient(cuda, d, lk):
    """K3 at one key tile: without a gradient the fp32 sum (_flash_kernel: D =
    512, the VAE's mid attention, D = 64 on K1's kernel and D = 80), with the
    LSE the rounded sum. CLIP's D = 80 site takes the normalise-first route
    from the dispatcher (test_normalise_first_route_holds_to_mha_reference)."""
    bf = torch.bfloat16
    q = _randn(cuda, 153, bf, 2, 3, 100, d, scale=1.5)
    k, v = (_randn(cuda, 154 + i, bf, 2, 3, lk, d, scale=1.5) for i in range(2))
    blhd = [x.transpose(1, 2) for x in (q, k, v)]

    def plain(rounded):
        out, lse = A._attention_base2(*blhd, d ** -0.5, with_lse=True, psum_rounded=rounded)
        return out.transpose(1, 2).to(bf), lse

    _denominator_held(A.flash_attention(q, k, v), None, plain, False)
    out, lse = A._flash_attention_forward(q, k, v, None, save_lse=True)
    torch.cuda.synchronize()
    _denominator_held(out, lse, plain, True)


def _held_to_mha_reference(out, ref):
    """tests/test_torch_ops.py's bound for the normalise-first route: every
    element within one bf16 step of mha_reference's at max |ref|, at most
    0.1 % of the elements differing (the flash sums put 56-61 % a step off)."""
    assert out.shape == ref.shape and out.dtype == ref.dtype == torch.bfloat16
    diff = (out.float() - ref.float()).abs()
    step = 2.0 ** (math.floor(math.log2(ref.float().abs().max().item())) - 7)
    assert diff.max().item() <= step, (diff.max().item(), step)
    assert (diff > 0).float().mean().item() <= 1e-3, (diff > 0).float().mean().item()


@pytest.mark.gpu
@pytest.mark.parametrize("layout,shape", [
    ("blhd", (28, 640, 77, 5)),    # the SD 2.1 cross-attention's 77 keys (5824 / 1456 queries on the path)
    ("blhd", (2, 640, 300, 2)),    # more keys than a tile: the two-pass walk
    ("blhd", (2, 77, 700, 2)),     # Lq < 512 <= Lk
    ("blhd", (1, 91, 91, 4)),      # one video item: too few folded rows for the tiny-seq kernel
    ("bhld", (1, 16, 257, 80)),    # CLIP ViT-H on the mma.sync kernel
    ("bhld", (2, 1, 100, 64)),     # K3 at D = 64 on K1's kernel
])
def test_normalise_first_route_holds_to_mha_reference(cuda, layout, shape):
    """At the sites JAX's TPU dispatch sends to mha_reference, dot_product_attention
    runs K1 / K3 in the normalise-first mode (their `.normalised_launches` move,
    bf16 on the tensor cores), held to mha_reference on the card; under a
    gradient the same sites run mha_reference_site (JAX differentiates
    mha_reference there) and no kernel."""
    bf = torch.bfloat16
    if layout == "blhd":
        b, lq, lk, h = shape
        q = _randn(cuda, 160, bf, b, lq, h, 64, scale=1.5)
        k, v = (_randn(cuda, 161 + i, bf, b, lk, h, 64, scale=1.5) for i in range(2))
        fn = A.flash_attention_packed
    else:
        b, h, lq, d = shape
        q, k, v = (_randn(cuda, 163 + i, bf, b, h, lq, d, scale=1.5) for i in range(3))
        fn = A.flash_attention
    assert A.site_route(layout, q.shape[0], lq, k.shape[2 if layout == "bhld" else 1]) == "mha_reference"
    before = fn.launches, fn.normalised_launches
    out = A.dot_product_attention(q, k, v, layout=layout)
    torch.cuda.synchronize()
    assert (fn.launches, fn.normalised_launches) == (before[0] + 1, before[1] + 1)
    _held_to_mha_reference(out, A.mha_reference(q, k, v, layout=layout))
    leaves = [x.detach().requires_grad_() for x in (q, k, v)]
    before = fn.launches, fn.normalised_launches, A.mha_reference_site.calls
    A.dot_product_attention(*leaves, layout=layout).float().sum().backward()
    torch.cuda.synchronize()
    assert (fn.launches, fn.normalised_launches, A.mha_reference_site.calls) == (before[0], before[1], before[2] + 1)
    assert all(x.grad is not None and bool(torch.isfinite(x.grad).all()) for x in leaves)


# the resident normalise-first kernels (D = 64 up to 128 keys, D = 80 up to 512): (layout, B, Lq, Lk, H, D)
NF_RESIDENT_CASES = [
    ("blhd", 28, 5824, 77, 5, 64),    # SD 2.1 cross ds1 (the CFG batch)
    ("blhd", 28, 1456, 77, 10, 64),   # SD 2.1 cross ds2
    ("blhd", 2, 4096, 77, 10, 64),    # SDXL cross at 1024x1024
    ("blhd", 2, 1024, 77, 20, 64),
    ("blhd", 28, 5823, 77, 5, 64),    # a ragged query tail
    ("blhd", 2, 640, 128, 2, 64),     # one 128-key product
    ("blhd", 1, 100, 77, 1, 64),      # 2 work items: a persistent grid of 2 blocks
    ("bhld", 1, 257, 257, 16, 80),    # CLIP ViT-H
    ("bhld", 1, 257, 300, 2, 80),     # Lq != Lk, more keys than CLIP's
    ("bhld", 1, 250, 511, 2, 80),     # a ragged query tile, the most keys but one
]
# the kernels that stream the keys from device memory, past the resident kernels' keys
NF_STREAMED_CASES = [
    ("blhd", 2, 640, 129, 2, 64),     # one key over a 128-key product
    ("blhd", 2, 640, 257, 2, 64),
    ("blhd", 2, 640, 511, 2, 64),
    ("bhld", 2, 257, 257, 16, 64),    # CLIP ViT-L/14 (the safety filter) through K3's strides
    ("blhd", 2, 77, 700, 2, 64),      # Lq < 512 <= Lk: site_route's mha_reference, on no path
    ("bhld", 1, 100, 600, 2, 80),
]


def _nf_inputs(cuda, layout, b, lq, lk, h, d, seed=170):
    if layout == "blhd":
        q = _randn(cuda, seed, torch.bfloat16, b, lq, h * d, scale=1.5)
        k, v = (_randn(cuda, seed + 1 + i, torch.bfloat16, b, lk, h * d, scale=1.5) for i in range(2))
        return q, k, v
    q = _randn(cuda, seed, torch.bfloat16, b, h, lq, d, scale=1.5)
    k, v = (_randn(cuda, seed + 1 + i, torch.bfloat16, b, h, lk, d, scale=1.5) for i in range(2))
    return q, k, v


def _nf_call(layout, q, k, v, h, streamed=False):
    """The normalise-first mode of K1 (blhd, packed) or K3 (bhld), and its
    plain version and mha_reference on the same inputs."""
    if layout == "blhd":
        b, lq, hd = q.shape
        heads = lambda x: x.view(x.shape[0], x.shape[1], h, hd // h)
        out = A._flash_attention_packed_forward(q, k, v, h, None, save_lse=False, normalise_first=True,
                                                streamed=streamed)
        plain = A.flash_attention_packed_reference(q, k, v, h, normalise_first=True)
        return out, plain, A.mha_reference(heads(q), heads(k), heads(v), layout="blhd").reshape(q.shape)
    out = A._flash_attention_forward(q, k, v, None, save_lse=False, normalise_first=True, streamed=streamed)
    return out, A.flash_attention_reference(q, k, v, normalise_first=True), A.mha_reference(q, k, v)


@pytest.mark.gpu
@pytest.mark.parametrize("layout,b,lq,lk,h,d", NF_RESIDENT_CASES)
def test_normalised_resident_kernels(cuda, layout, b, lq, lk, h, d):
    """The resident normalise-first kernels (D = 64 on wgmma, its persistent
    grid; D = 80 on mma.sync) at the paths' shapes and their edges: one launch
    on the wrapper's route (`.wgmma_launches` at D = 64, none at 80) in the
    normalise-first mode, reported by the library as the resident kernel
    (`.resident_launches`), its output within one bf16 step of the plain
    version and of mha_reference at max |ref| with at most 0.1 % of the
    elements differing, and so is the kernel that streams the keys (sum mode
    3, reported as not resident), its yardstick."""
    fn = A.flash_attention_packed if layout == "blhd" else A.flash_attention
    counts = lambda: (fn.launches, fn.normalised_launches, fn.wgmma_launches, fn.resident_launches)
    q, k, v = _nf_inputs(cuda, layout, b, lq, lk, h, d)
    before = counts()
    out, plain, ref = _nf_call(layout, q, k, v, h)
    torch.cuda.synchronize()
    assert counts() == (before[0] + 1, before[1] + 1, before[2] + (d == 64), before[3] + 1)
    _held_to_mha_reference(out, plain)
    _held_to_mha_reference(out, ref)
    before = counts()
    streamed = _nf_call(layout, q, k, v, h, streamed=True)[0]
    torch.cuda.synchronize()
    assert counts() == (before[0] + 1, before[1] + 1, before[2] + (d == 64), before[3])
    _held_to_mha_reference(streamed, ref)


NF_DRAWS = 4   # draws pooled for the share of the elements that differ from mha_reference
# site_route sends sites with lengths on both sides of 512 to the normalise-first mode; every site of the
# paths has Lq >= 512 > Lk (or is bhld shorter than 512), where the share is held; Lq < 512 <= Lk is on no path
SHARE_HELD_BELOW = 512


@pytest.mark.gpu
@pytest.mark.parametrize("layout,b,lq,lk,h,d", NF_STREAMED_CASES)
def test_normalised_streams_the_keys_past_the_resident_length(cuda, layout, b, lq, lk, h, d):
    """Past the resident kernels' keys the normalise-first mode streams the keys
    twice from device memory (one launch on the wrapper's route, not reported
    resident), held to the plain version within chip_smoke.py's forward
    bounds and to mha_reference within one bf16 step at max |ref| in each of
    NF_DRAWS draws and, below SHARE_HELD_BELOW keys, at most 0.1 % of the
    elements differing over the draws pooled (one draw does not measure the
    share, as chip_smoke.py's CLIP check pools its draws). The plain
    version's share on the same draws is printed beside the kernel's (`-s`).
    At 700 keys, on no path, the kernel's pooled share read 1.05e-3 and the
    plain version's 2.4e-4 (PERF.md section 7)."""
    fn = A.flash_attention_packed if layout == "blhd" else A.flash_attention
    counts = lambda: (fn.launches, fn.normalised_launches, fn.wgmma_launches, fn.resident_launches)
    differ = {"kernel": [], "plain": []}
    for i in range(NF_DRAWS):
        q, k, v = _nf_inputs(cuda, layout, b, lq, lk, h, d, seed=180 + 10 * i)
        before = counts()
        out, plain, ref = _nf_call(layout, q, k, v, h)
        torch.cuda.synchronize()
        assert counts() == (before[0] + 1, before[1] + 1, before[2] + (d == 64), before[3])
        _close_grads((out,), (plain,), RMS_TOL["K1"])
        step = 2.0 ** (math.floor(math.log2(ref.float().abs().max().item())) - 7)
        for name, x in (("kernel", out), ("plain", plain)):
            diff = (x.float() - ref.float()).abs()
            differ[name].append((diff > 0).float().mean().item())
            if name == "kernel":
                assert diff.max().item() <= step, (i, diff.max().item(), step)
    pooled = {name: sum(xs) / NF_DRAWS for name, xs in differ.items()}
    print(f"normalise-first {layout} [{b},{lq}x{lk},{h}x{d}] vs mha_reference over {NF_DRAWS} draws: kernel "
          f"{pooled['kernel']:.3e} {[f'{x:.2e}' for x in differ['kernel']]}, plain version {pooled['plain']:.3e} "
          f"{[f'{x:.2e}' for x in differ['plain']]}")
    if lk < SHARE_HELD_BELOW:
        assert pooled["kernel"] <= 1e-3, pooled


@pytest.mark.gpu
def test_normalised_kernels_launch_from_a_thread_that_has_launched_nothing(cuda):
    """The resident kernels encode their tensor maps on the launching thread
    (D = 64: q, k, v and the TMA store's o; D = 80: two panels each of q, k and
    v): from a fresh thread each launches and agrees with the main thread's
    launch bit for bit."""
    import threading

    for layout, b, lq, lk, h, d in (("blhd", 2, 640, 77, 2, 64), ("bhld", 1, 257, 257, 16, 80)):
        q, k, v = _nf_inputs(cuda, layout, b, lq, lk, h, d, seed=190)
        want = _nf_call(layout, q, k, v, h)[0]
        got = []
        worker = threading.Thread(target=lambda: got.append(_nf_call(layout, q, k, v, h)[0]))
        worker.start()
        worker.join()
        torch.cuda.synchronize()
        assert len(got) == 1 and torch.equal(got[0], want)


@pytest.mark.gpu
def test_unsupported_head_dims_on_the_card(cuda):
    """ROADMAP section C (a): a bf16 bhld D = 512 attention under 512 tokens (a
    VAE attention of a small frame) runs mha_reference_site on the card, held to
    the CPU's mha_reference; a "flash" blhd site with 40-dim heads raises the
    named ValueError before any launch."""
    bf = torch.bfloat16
    q, k, v = (_randn(cuda, 170 + i, bf, 1, 1, 300, 512, scale=1.5) for i in range(3))
    before = A.flash_attention.launches, A.mha_reference_site.calls
    out = A.dot_product_attention(q, k, v)
    assert (A.flash_attention.launches, A.mha_reference_site.calls) == (before[0], before[1] + 1)
    _held_to_mha_reference(out.cpu(), A.mha_reference(q.cpu(), k.cpu(), v.cpu()))
    q, k, v = (_randn(cuda, 173 + i, bf, 2, 640, 4, 40) for i in range(3))
    before = A.flash_attention_packed.launches
    with pytest.raises(ValueError, match="'flash' attention site: head dim 40"):
        A.dot_product_attention(q, k, v, layout="blhd")
    assert A.flash_attention_packed.launches == before


# D = 512 (wgmma in bf16): Lq off the 64-row tile, Lq != Lk, a key tail off the
# 32-key tile, the main path's 5824 tokens on one batch item; D = 80 and 64
# (mma.sync in bf16): CLIP's 257 tokens, a ragged length, three heads
K3_SHAPES = [(2, 1, 100, 100, 512), (1, 1, 130, 77, 512), (1, 1, 64, 33, 512), (1, 1, 5824, 5824, 512),
             (1, 16, 257, 257, 80), (1, 2, 100, 37, 80), (2, 3, 70, 70, 64)]


@pytest.mark.gpu
@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("b,h,lq,lk,d", K3_SHAPES)
def test_flash_attention_bhld(cuda, dt, b, h, lq, lk, d):
    dtype = DTYPES[dt]
    q = _randn(cuda, 8, dtype, b, h, lq, d)
    k, v = (_randn(cuda, i, dtype, b, h, lk, d) for i in (9, 10))
    _check(A.flash_attention, A.flash_attention_reference, q, k, v)


@pytest.mark.gpu
@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("d", [512, 80, 64])
def test_flash_attention_bhld_strided_views(cuda, dt, d):
    """[B, L, H, D] projections seen as bhld (CLIP's layout) and a batch slice
    of a larger tensor are read in place through their strides; a bf16 view
    that starts off a 16-byte boundary is refused."""
    dtype = DTYPES[dt]
    h = 1 if d == 512 else 3
    q, k, v = (_randn(cuda, i, dtype, 3, 90, h, d).transpose(1, 2)[::2] for i in (14, 15, 16))
    assert not q.is_contiguous()
    _check(A.flash_attention, A.flash_attention_reference, q, k, v)
    if dtype == torch.bfloat16:
        x = _randn(cuda, 17, dtype, 40 * d + 1)[1:].view(1, 1, 40, d)
        with pytest.raises(ValueError, match="aligned"):
            A.flash_attention(x, x, x)


@pytest.mark.gpu
@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("b,t,m,cin,cout", [(2, 5, 33, 40, 24), (1, 7, 50, 3, 3), (1, 1, 40, 64, 64),
                                            (2, 14, 20, 136, 200)])
def test_temporal_conv_1x1(cuda, dt, b, t, m, cin, cout):
    dtype = DTYPES[dt]
    x = _randn(cuda, 11, dtype, b, t, m, cin)
    w = _randn(cuda, 12, dtype, 3, cin, cout, scale=(3 * cin) ** -0.5)
    bias = _randn(cuda, 13, dtype, cout)
    routes = TC.temporal_conv_1x1.wgmma_launches, TC.temporal_conv_1x1.narrow_launches
    _check(TC.temporal_conv_1x1, TC.temporal_conv_1x1_reference, x, w, bias)
    wgmma = dtype == torch.bfloat16 and cin % 8 == 0 and cout % 8 == 0
    narrow = dtype == torch.bfloat16 and not wgmma
    assert (TC.temporal_conv_1x1.wgmma_launches, TC.temporal_conv_1x1.narrow_launches) == (
        routes[0] + wgmma, routes[1] + narrow)


# the wgmma kernel's edges: T = 1, 2, 14; M = 1, 91, 364, 5824 and off the
# 128- and 192-row tiles; kt = 1, 3, 5; Cin != Cout; the UNet widths (160-wide
# column tiles) and the VAE's 128, 256, 512 (128-wide); tiles per frame (M
# 5824) and over the whole video (M 91, 364, 1000)
K4_WGMMA_SHAPES = [(2, 14, 91, 1280, 1280, 3), (1, 14, 364, 320, 320, 3), (1, 2, 5824, 320, 320, 3),
                   (2, 1, 1000, 320, 640, 3), (3, 2, 1, 128, 128, 3), (1, 7, 5824, 128, 128, 3),
                   (1, 3, 700, 256, 256, 3), (1, 2, 91, 512, 512, 3), (2, 5, 91, 320, 320, 1),
                   (1, 14, 300, 64, 200, 5)]


@pytest.mark.gpu
@pytest.mark.parametrize("b,t,m,cin,cout,kt", K4_WGMMA_SHAPES)
def test_temporal_conv_1x1_wgmma_route(cuda, b, t, m, cin, cout, kt):
    """bf16 with Cin and Cout multiples of 8 runs the wgmma kernel (its route
    counter moves with the launch counter), within the forward bounds."""
    bf = torch.bfloat16
    x = _randn(cuda, 14, bf, b, t, m, cin)
    w = _randn(cuda, 15, bf, kt, cin, cout, scale=(kt * cin) ** -0.5)
    bias = _randn(cuda, 16, bf, cout)
    wg = TC.temporal_conv_1x1.wgmma_launches
    y = _check_forward(TC.temporal_conv_1x1, TC.temporal_conv_1x1_reference, RMS_TOL["K4"], x, w, bias)
    assert TC.temporal_conv_1x1.wgmma_launches == wg + 1 and y.shape == (b, t, m, cout)


@pytest.mark.gpu
def test_temporal_conv_1x1_narrow_route(cuda):
    """bf16 that the wgmma kernel does not take (C = 3, as the VAE's
    conv_out_time_mix; Cout or Cin off the 8-element vector; an x that starts
    off a 16-byte boundary) runs the CUDA-core kernel; fp32 runs neither."""
    bf = torch.bfloat16
    cases = [(_randn(cuda, 17, bf, 1, 7, 5000, 3), 3), (_randn(cuda, 18, bf, 2, 3, 50, 3), 16),
             (_randn(cuda, 19, bf, 2, 3, 50, 12), 8), (_randn(cuda, 20, bf, 2 * 3 * 40 * 64 + 1)[1:].view(2, 3, 40, 64), 64)]
    for x, cout in cases:
        cin = x.shape[-1]
        w = _randn(cuda, 21, bf, 3, cin, cout, scale=(3 * cin) ** -0.5)
        bias = _randn(cuda, 22, bf, cout)
        routes = TC.temporal_conv_1x1.wgmma_launches, TC.temporal_conv_1x1.narrow_launches
        _check_forward(TC.temporal_conv_1x1, TC.temporal_conv_1x1_reference, RMS_TOL["K4"], x, w, bias)
        assert (TC.temporal_conv_1x1.wgmma_launches, TC.temporal_conv_1x1.narrow_launches) == (
            routes[0], routes[1] + 1)
    x = _randn(cuda, 23, torch.float32, 2, 5, 40, 64)
    w = _randn(cuda, 24, torch.float32, 3, 64, 64, scale=0.07)
    routes = TC.temporal_conv_1x1.wgmma_launches, TC.temporal_conv_1x1.narrow_launches
    _check_forward(TC.temporal_conv_1x1, TC.temporal_conv_1x1_reference, None, x, w, w[0, 0])
    assert (TC.temporal_conv_1x1.wgmma_launches, TC.temporal_conv_1x1.narrow_launches) == routes


@pytest.mark.gpu
def test_temporal_conv_module_caches_its_k_major_weight_and_takes_the_wgmma_dx(cuda):
    """The TemporalConv module on the card: its Conv3d weight is re-laid K-major
    once per weight version; with grad on, the backward's dx is one more wgmma
    launch, and the gradients of x, weight and bias match autograd through the
    plain forward on the same JAX-layout weight."""
    from vidseg_diffusion_tpu_torch.models.unet import TemporalConv

    bf = torch.bfloat16
    mod = TemporalConv(320, 320).to(cuda, bf)
    with torch.no_grad():
        mod.weight.copy_(_randn(cuda, 25, bf, 320, 320, 3, 1, 1, scale=(3 * 320) ** -0.5))
        mod.bias.copy_(_randn(cuda, 26, bf, 320))
    x = _randn(cuda, 27, bf, 2, 14, 7, 13, 320)
    relays = TC.temporal_conv_1x1.relays
    with torch.no_grad():
        y0, y1 = mod(x), mod(x)
    assert TC.temporal_conv_1x1.relays == relays + 1 and torch.equal(y0, y1)
    with torch.no_grad():
        mod.weight.mul_(0.5)
        mod(x)
    assert TC.temporal_conv_1x1.relays == relays + 2
    xg = x.clone().requires_grad_()
    g = _randn(cuda, 28, bf, 2, 14, 7, 13, 320)
    launches, wg = TC.temporal_conv_1x1.launches, TC.temporal_conv_1x1.wgmma_launches
    mod(xg).backward(g)
    assert (TC.temporal_conv_1x1.launches, TC.temporal_conv_1x1.wgmma_launches) == (launches + 2, wg + 2)
    wj = mod.weight.detach()[:, :, :, 0, 0].permute(2, 1, 0).contiguous().requires_grad_()
    bj = mod.bias.detach().clone().requires_grad_()
    xr = x.clone().requires_grad_()
    TC.temporal_conv_1x1_reference(xr.reshape(2, 14, 91, 320), wj, bj).reshape(g.shape).backward(g)
    _close_grads((xg.grad, mod.weight.grad[:, :, :, 0, 0].permute(2, 1, 0), mod.bias.grad),
                 (xr.grad, wj.grad, bj.grad), RMS_TOL["K4"])


@pytest.mark.gpu
@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("b,lq,lk,h", [(2, 300, 300, 2), (28, 91, 91, 4), (2, 100, 37, 2), (1, 64, 200, 1),
                                       (3, 364, 364, 2), (1, 130, 300, 3), (2, 600, 90, 1)])
def test_flash_attention_packed_backward(cuda, dt, b, lq, lk, h):
    """K5 against its plain version on the LSE that K1 saved (ragged lengths,
    Lq != Lk both ways, more rows than a block); K1's LSE against the plain
    LSE; every bf16 launch on the wgmma kernels (`.wgmma_launches`), no fp32
    one."""
    dtype = DTYPES[dt]
    q = _randn(cuda, 21, dtype, b, lq, h * 64)
    k, v = (_randn(cuda, s, dtype, b, lk, h * 64) for s in (22, 23))
    g = _randn(cuda, 24, dtype, b, lq, h * 64)
    out, lse = A._flash_attention_packed_forward(q, k, v, h, None, save_lse=True)
    _, lse_ref = A.flash_attention_packed_reference(q, k, v, h, save_lse=True)
    assert (lse - lse_ref).abs().max().item() <= LSE_TOL
    wg = A.flash_attention_packed_backward.wgmma_launches
    _check(A.flash_attention_packed_backward, A.flash_attention_packed_backward_reference,
           q, k, v, out, lse, g, h, rms_tol=RMS_TOL["K5"])
    assert A.flash_attention_packed_backward.wgmma_launches == wg + (dtype == torch.bfloat16)


# D = 512: Lq off the 16-row tiles, Lq != Lk both ways, the autoencoder step's
# [2, 1, 5824, 512]; D = 80: CLIP's 257 tokens, a ragged length, three heads
K13_SHAPES = [(2, 1, 100, 100, 512), (1, 1, 130, 77, 512), (1, 1, 72, 200, 512), (2, 1, 5824, 5824, 512),
              (1, 16, 257, 257, 80), (1, 3, 100, 37, 80)]


@pytest.mark.gpu
@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("b,h,lq,lk,d", K13_SHAPES)
def test_flash_attention_bhld_backward(cuda, dt, b, h, lq, lk, d):
    """K13 against its plain version on the LSE that K3 wrote; K3's LSE
    (wgmma at D = 512, mma.sync at 80 in bf16; FMA in fp32) against the
    plain LSE. Every bf16 D = 512 launch runs the wgmma kernels
    (`.wgmma_launches`), no D = 80 or fp32 one."""
    dtype = DTYPES[dt]
    q = _randn(cuda, 51, dtype, b, h, lq, d)
    k, v = (_randn(cuda, i, dtype, b, h, lk, d) for i in (52, 53))
    g = _randn(cuda, 54, dtype, b, h, lq, d)
    out, lse = A._flash_attention_forward(q, k, v, None, save_lse=True)
    _, lse_ref = A.flash_attention_reference(q, k, v, save_lse=True)
    assert lse.shape == (b, lq, h) and (lse - lse_ref).abs().max().item() <= LSE_TOL
    wg = A.flash_attention_backward.wgmma_launches
    _check(A.flash_attention_backward, A.flash_attention_backward_reference, q, k, v, out, lse, g,
           rms_tol=RMS_TOL["K13"])
    assert A.flash_attention_backward.wgmma_launches == wg + (dtype == torch.bfloat16 and d == 512)


# fp32 at D = 512 on split TF32 products (route "tf32x3"): Lq off the 64-row
# tile, Lq != Lk both ways, one key, the main path's 5824 tokens; up to 64 keys
# (the forward) and 64 queries (the dv kernel) the kernels split the head dim
# over their warpgroups: 64 x 64, 50 queries on 300 keys, 200 on 64
X3_SHAPES = [(2, 1, 100, 100), (1, 1, 130, 77), (1, 1, 72, 200), (1, 1, 1, 1), (1, 1, 5824, 5824),
             (2, 1, 64, 64), (1, 1, 50, 300), (3, 1, 200, 64)]


def _fp64_rms(outs, plain, *args):
    """The largest relative RMS error of `outs` against the plain version run
    in float64 on the same inputs (a gradient that is 0 up to rounding is
    measured against GRAD_FLOOR times the call's largest)."""
    refs = plain(*(a.double() if torch.is_tensor(a) and a.is_floating_point() else a for a in args))
    refs = refs if isinstance(refs, tuple) else (refs,)
    floor = GRAD_FLOOR * max(r.norm().item() for r in refs)
    return max((o.double() - r).norm().item() / max(r.norm().item(), floor) for o, r in zip(outs, refs))


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,lq,lk", X3_SHAPES)
def test_fp32_d512_attention_on_split_tf32(cuda, b, h, lq, lk):
    """K3 and its gradient K13 in fp32 at D = 512 run the split-TF32 kernels
    (`.tf32x3_launches` moves with each launch, `.wgmma_launches` does not):
    within FP32_TOL of their plain versions (K3's LSE within LSE_TOL) and
    within FP64_RMS_TOL of the plain versions in float64."""
    f32 = torch.float32
    q, g = (_randn(cuda, 330 + i, f32, b, h, lq, 512) for i in range(2))
    k, v = (_randn(cuda, 332 + i, f32, b, h, lk, 512) for i in range(2))
    before = tuple(getattr(f, r) for f in (A.flash_attention, A.flash_attention_backward)
                   for r in ("tf32x3_launches", "wgmma_launches"))
    out, lse = A._flash_attention_forward(q, k, v, None, save_lse=True)
    ref, lse_ref = A.flash_attention_reference(q, k, v, save_lse=True)
    _close(out, ref)
    assert (lse - lse_ref).abs().max().item() <= LSE_TOL
    assert _fp64_rms((out,), A.flash_attention_reference, q, k, v) <= FP64_RMS_TOL
    grads = A.flash_attention_backward(q, k, v, out, lse, g)
    torch.cuda.synchronize()
    _close_grads(grads, A.flash_attention_backward_reference(q, k, v, out, lse, g), None)
    # with one key p = 1 and ds = g.v - g.o cancels to rounding: dq and dk are 0 in exact arithmetic, and their
    # fp32 noise (held above by FP32_TOL) has no relative error to measure; dv = g there
    held = grads if lk > 1 else grads[2:]
    assert _fp64_rms(held, lambda *a: A.flash_attention_backward_reference(*a)[3 - len(held):],
                     q, k, v, out, lse, g) <= FP64_RMS_TOL
    after = tuple(getattr(f, r) for f in (A.flash_attention, A.flash_attention_backward)
                  for r in ("tf32x3_launches", "wgmma_launches"))
    assert after == (before[0] + 1, before[1], before[2] + 1, before[3])


@pytest.mark.gpu
def test_fp32_d512_split_tf32_reads_strided_views(cuda):
    """[B, L, H, D] projections seen as bhld and a batch slice are read in
    place by the split-TF32 kernels, forward and backward; an fp32 D = 512
    view off a 16-byte boundary is refused (TMA reads the rows)."""
    f32 = torch.float32
    q, k, v, g = (_randn(cuda, 340 + i, f32, 3, 90, 1, 512).transpose(1, 2)[::2] for i in range(4))
    assert not q.is_contiguous()
    x3 = A.flash_attention.tf32x3_launches, A.flash_attention_backward.tf32x3_launches
    _check(A.flash_attention, A.flash_attention_reference, q, k, v)
    out, lse = A._flash_attention_forward(q, k, v, None, save_lse=True)
    _check(A.flash_attention_backward, A.flash_attention_backward_reference, q, k, v, out, lse, g,
           rms_tol=RMS_TOL["K13"])
    assert (A.flash_attention.tf32x3_launches, A.flash_attention_backward.tf32x3_launches) == (x3[0] + 2, x3[1] + 1)
    x = _randn(cuda, 344, f32, 40 * 512 + 1)[1:].view(1, 1, 40, 512)
    with pytest.raises(ValueError, match="aligned"):
        A.flash_attention(x, x, x)


@pytest.mark.gpu
@pytest.mark.parametrize("b,l", [(2, 600), (1, 5824)])
def test_fp32_one_512_head_packed_on_split_tf32(cuda, b, l):
    """K1 and K5 in fp32 at one 512-dim head (packed [B, L, 1 x 512], the
    VideoAttnBlock's attn2) on the split-TF32 kernels through the packed
    strides, q / k / v as slices of one fused projection read in place: the
    plain versions' bounds and FP64_RMS_TOL against float64."""
    f32 = torch.float32
    q, k, v = _randn(cuda, 350, f32, b, l, 3 * 512).split(512, dim=-1)
    g = _randn(cuda, 351, f32, b, l, 512)
    assert not q.is_contiguous()
    x3 = A.flash_attention_packed.tf32x3_launches, A.flash_attention_packed_backward.tf32x3_launches
    out, lse = A._flash_attention_packed_forward(q, k, v, 1, None, save_lse=True)
    ref = A.flash_attention_packed_reference(q, k, v, 1)
    _close(out, ref)
    assert _fp64_rms((out,), A.flash_attention_packed_reference, q, k, v, 1) <= FP64_RMS_TOL
    grads = A.flash_attention_packed_backward(q, k, v, out, lse, g, 1)
    torch.cuda.synchronize()
    _close_grads(grads, A.flash_attention_packed_backward_reference(q, k, v, out, lse, g, 1), None)
    assert _fp64_rms(grads, A.flash_attention_packed_backward_reference, q, k, v, out, lse, g, 1) <= FP64_RMS_TOL
    assert (A.flash_attention_packed.tf32x3_launches,
            A.flash_attention_packed_backward.tf32x3_launches) == (x3[0] + 1, x3[1] + 1)


@pytest.mark.gpu
@pytest.mark.parametrize("dt", list(DTYPES))
def test_flash_attention_bhld_backward_strided_and_d64(cuda, dt):
    """K13 reads [B, L, H, D] projections seen as bhld through their strides
    and writes contiguous bhld gradients; at D = 64 the bhld backward runs
    K5 on the same strides (K13's counter does not move)."""
    dtype = DTYPES[dt]
    q, k, v, g = (_randn(cuda, i, dtype, 2, 90, 3, 80).transpose(1, 2) for i in (55, 56, 57, 58))
    out, lse = A._flash_attention_forward(q, k, v, None, save_lse=True)
    _check(A.flash_attention_backward, A.flash_attention_backward_reference, q, k, v, out, lse,
           g.contiguous(), rms_tol=RMS_TOL["K13"])
    q, k, v, g = (_randn(cuda, i, dtype, 2, 2, 100, 64) for i in (59, 60, 61, 62))
    out, lse = A._flash_attention_forward(q, k, v, None, save_lse=True)
    k13, k5 = A.flash_attention_backward.launches, A.flash_attention_packed_backward.launches
    k5_wg = A.flash_attention_packed_backward.wgmma_launches
    got = A.flash_attention_backward(q, k, v, out, lse, g)
    torch.cuda.synchronize()
    assert A.flash_attention_backward.launches == k13 and A.flash_attention_packed_backward.launches == k5 + 1
    assert A.flash_attention_packed_backward.wgmma_launches == k5_wg + (dtype == torch.bfloat16)
    _close_grads(got, A.flash_attention_backward_reference(q, k, v, out, lse, g), RMS_TOL["K5"])


@pytest.mark.gpu
def test_vae_attn_block_autograd_matches_the_cpu(cuda):
    """The VAE's AttnBlock (GroupNorm, 1x1 q/k/v, one 512-dim head, proj_out)
    under autograd in fp32: on the card through K7/K8, K3 with its LSE, K13
    and K9/K10, on the CPU through the plain versions; the input's and every
    parameter's gradient within GRAD_REL_TOL by norm."""
    import copy

    from vidseg_diffusion_tpu_torch.models.vae import AttnBlock

    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        block = AttnBlock(512).to(cuda)
        gen = torch.Generator(device=cuda).manual_seed(63)
        with torch.no_grad():
            for p in block.parameters():
                p.copy_(torch.randn(p.shape, generator=gen, device=cuda) * (0.5 if p.dim() == 1 else 0.05))
        cpu_block = copy.deepcopy(block).cpu()
        # 32 x 32 = 1024 tokens: a "flash" site (under 512 tokens the site is
        # JAX's mha_reference, which runs mha_reference_site under a gradient)
        x, g = _randn(cuda, 64, torch.float32, 2, 32, 32, 512), _randn(cuda, 65, torch.float32, 2, 32, 32, 512)
        launches = A.flash_attention.launches, A.flash_attention_backward.launches

        def grads(mod, dev):
            xi = x.detach().to(dev).requires_grad_()
            (mod(xi) * g.to(dev)).sum().backward()
            return [xi.grad] + [p.grad for p in mod.parameters()]

        card = grads(block, cuda)
        torch.cuda.synchronize()
        assert (A.flash_attention.launches, A.flash_attention_backward.launches) == (launches[0] + 1,
                                                                                    launches[1] + 1)
        cpu = grads(cpu_block, "cpu")
        floor = GRAD_FLOOR * max(w.norm().item() for w in cpu)  # k's bias: a true gradient of 0
        for a, w in zip(card, cpu):
            assert a is not None and bool(torch.isfinite(a).all())
            assert (a.cpu() - w).norm().item() <= GRAD_REL_TOL * max(w.norm().item(), floor)
    finally:
        torch.backends.cudnn.allow_tf32 = saved


@pytest.mark.gpu
def test_aggre_attn_tiny_pipeline_in_bf16_matches_the_cpu(cuda, tmp_path):
    """run_single_video(is_aggre_attn=True) on svd_tiny.yaml in bf16, on the
    card and on the CPU with the same weights and draws. The config takes
    three output blocks per level (tests/test_torch_pipeline.py's
    configuration) and 64-dim heads everywhere (UNet model_channels 64,
    num_head_channels 64; CLIP one head of 64), the head dim of the tuned
    kernels the full-width paths run (svd_tiny's own 16-dim heads run in
    test_svd_tiny_as_shipped_runs_on_the_card). The block mean of
    bf16 features is bit for bit the CPU's; the run's aggregated cluster
    features come out bf16-valued (rounded once, as jnp.mean rounds) and
    agree with the CPU's (relative RMS 0.1: bf16 through the feature pass,
    the kernels accumulating in another order; a wrong block or a skipped
    rounding step moves them by O(1)); finite latents, labels of the right
    shape."""
    import numpy as np

    from vidseg_diffusion_tpu_torch.engine.build import build_pipeline
    from vidseg_diffusion_tpu_torch.engine.masks import aggregate_blocks
    from vidseg_diffusion_tpu_torch.pipelines.single_video import VidSegArgs, run_single_video

    feats = [_randn(cuda, 70 + i, torch.bfloat16, 6, 64, 128, scale=3.0) for i in range(3)]
    card_mean = aggregate_blocks(feats)
    assert card_mean.dtype == torch.bfloat16
    assert torch.equal(card_mean.cpu(), aggregate_blocks([f.cpu() for f in feats]))

    with open(os.path.join(ROOT, "configs/inference/svd_tiny.yaml")) as f:
        text = f.read()
    for old, new in (("num_res_blocks: 1", "num_res_blocks: 2"), ("model_channels: 32", "model_channels: 64"),
                     ("num_head_channels: 16", "num_head_channels: 64"), ("heads: 4", "heads: 1")):
        assert old in text
        text = text.replace(old, new, 1)   # the first num_res_blocks is the UNet's
    config = tmp_path / "svd_tiny_3_blocks_64.yaml"
    config.write_text(text)
    t, hpx = 3, 64
    frames = np.random.RandomState(0).uniform(-1, 1, (t, hpx, hpx, 3)).astype(np.float32)
    args = VidSegArgs(num_steps=6, num_masks=2, modulate_timestep=(3,), feature_timestep=(5,), decoding_t=3,
                      seed=1, is_aggre_attn=True)
    rs = np.random.RandomState(2)
    draws = dict(cond_aug_noise=rs.randn(1, hpx, hpx, 3).astype(np.float32),
                 noise=rs.randn(t, hpx // 8, hpx // 8, 4).astype(np.float32))
    pipes = {dev: build_pipeline(str(config), num_steps=6, num_frames=t, dtype=torch.bfloat16, device=dev, seed=4)
             for dev in ("cuda", "cpu")}
    for name in ("unet", "clip", "cond_encoder"):   # the same weights on both (the seeded draws are per device)
        getattr(pipes["cuda"], name).load_state_dict(getattr(pipes["cpu"], name).state_dict())
    for name in ("encoder", "decoder"):
        getattr(pipes["cuda"].first_stage, name).load_state_dict(getattr(pipes["cpu"].first_stage, name).state_dict())
    card, cpu = (run_single_video(pipes[dev], frames, [str(i) for i in range(t)], args, write_outputs=False, **draws)
                 for dev in ("cuda", "cpu"))
    feats = torch.from_numpy(card.cluster_features)
    assert torch.equal(feats.bfloat16().float(), feats)
    diff = np.linalg.norm(card.cluster_features - cpu.cluster_features)
    assert diff <= 0.1 * np.linalg.norm(cpu.cluster_features)
    assert np.isfinite(card.final_latents).all() and card.seg_raw.shape == (t, hpx, hpx)
    assert set(np.unique(card.seg_raw)) <= {0, 1}


@pytest.mark.gpu
@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("b,t,s,h", [(2, 14, 20, 2), (2, 1, 16, 1), (1, 32, 9, 2), (3, 5, 91, 3)])
def test_temporal_attention_direct_backward(cuda, dt, b, t, s, h):
    dtype = DTYPES[dt]
    q, k, v, g = (_randn(cuda, i, dtype, b * t, s, h, 64) for i in (25, 26, 27, 28))
    out = A.temporal_attention_direct(q, k, v, t=t)
    _check(A.temporal_attention_direct_backward, A.temporal_attention_direct_backward_reference,
           q, k, v, out, g, t, rms_tol=RMS_TOL["K6"])


@pytest.mark.gpu
@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("b,t,m,cin,cout", [(2, 5, 33, 40, 24), (1, 1, 40, 64, 64), (2, 14, 20, 136, 200)])
def test_temporal_conv_1x1_backward(cuda, dt, b, t, m, cin, cout):
    """dx is a K4 launch on g with the reversed, transposed taps."""
    dtype = DTYPES[dt]
    x = _randn(cuda, 31, dtype, b, t, m, cin)
    w = _randn(cuda, 32, dtype, 3, cin, cout, scale=(3 * cin) ** -0.5)
    g = _randn(cuda, 33, dtype, b, t, m, cout)
    launches, calls = TC.temporal_conv_1x1.launches, TC.temporal_conv_1x1_backward_reference.calls
    got = TC.temporal_conv_1x1_backward(x, w, g)
    torch.cuda.synchronize()
    assert TC.temporal_conv_1x1.launches == launches + 1
    assert TC.temporal_conv_1x1_backward_reference.calls == calls
    _close_grads(got, TC.temporal_conv_1x1_backward_reference(x, w, g), RMS_TOL["K4"])


@pytest.mark.gpu
def test_autograd_through_the_kernels(cuda):
    """On CUDA tensors that require grad the forward wrappers return outputs
    with a grad_fn and the backward launches K5, K6, K4 and K13."""
    b, l, h, t = 2, 70, 2, 5
    q, k, v = (_randn(cuda, i, torch.bfloat16, b, l, h * 64).requires_grad_() for i in (41, 42, 43))
    out = A.flash_attention_packed(q, k, v, heads=h)
    assert out.grad_fn is not None
    before = A.flash_attention_packed_backward.launches
    out.float().square().sum().backward()
    assert A.flash_attention_packed_backward.launches == before + 1
    assert all(x.grad is not None and x.grad.abs().sum() > 0 for x in (q, k, v))

    q4, k4, v4 = (_randn(cuda, i, torch.bfloat16, b * t, 9, h, 64).requires_grad_() for i in (44, 45, 46))
    out = A.temporal_attention_direct(q4, k4, v4, t=t)
    assert out.grad_fn is not None
    before = A.temporal_attention_direct_backward.launches
    out.float().square().sum().backward()
    assert A.temporal_attention_direct_backward.launches == before + 1

    x = _randn(cuda, 47, torch.bfloat16, b, t, 30, 64).requires_grad_()
    w = _randn(cuda, 48, torch.bfloat16, 3, 64, 64, scale=0.1).requires_grad_()
    bias = _randn(cuda, 49, torch.bfloat16, 64).requires_grad_()
    y = TC.temporal_conv_1x1(x, w, bias)
    assert y.grad_fn is not None
    before = TC.temporal_conv_1x1.launches
    y.float().sum().backward()
    assert TC.temporal_conv_1x1.launches == before + 1
    assert all(a.grad is not None for a in (x, w, bias))

    x4 = _randn(cuda, 50, torch.bfloat16, 1, 1, 40, 512).requires_grad_()
    out = A.flash_attention(x4, x4, x4)
    assert out.grad_fn is not None
    before = A.flash_attention_backward.launches
    out.float().square().sum().backward()
    assert A.flash_attention_backward.launches == before + 1 and x4.grad.abs().sum() > 0
    with torch.no_grad():
        assert A.flash_attention(x4, x4, x4).grad_fn is None


GN_SHAPES = [((2, 6, 8, 32), 8), ((3, 7, 13, 64), 16), ((2, 14, 8, 8, 32), 8), ((28, 91, 1280), 32),
             ((2, 33, 2560), 32), ((1, 5000, 128), 32), ((3, 17, 5, 6), 2), ((2, 9, 4, 36), 4)]


def _gn_route(x, groups):
    b, c = x.shape[0], x.shape[-1]
    return N.group_norm_route(b, x.numel() // (b * c), c, groups, x.element_size(), x.data_ptr() % 16 == 0)[0]


def _gn_inputs(cuda, dtype, shape, seed=60):
    c = shape[-1]
    x = _randn(cuda, seed, dtype, *shape) * 1.5 + 0.3
    w = _randn(cuda, seed + 1, dtype, c) * 0.5 + 1.0
    b = _randn(cuda, seed + 2, dtype, c)
    return x, w, b


@pytest.mark.gpu
@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("silu", [False, True])
@pytest.mark.parametrize("eps", [1e-5, 1e-6])
@pytest.mark.parametrize("shape,groups", GN_SHAPES)
def test_group_norm_forward(cuda, dt, silu, eps, shape, groups):
    """The forward (the fused kernel or K7 + K8, as group_norm_route says) vs
    the plain forward; K7's statistics vs fp64."""
    x, w, b = _gn_inputs(cuda, DTYPES[dt], shape)
    launches = N.group_norm_stats.launches, N.group_norm_apply.launches, N.group_norm_fused.launches
    calls = N.group_norm_plain.calls
    y = N.group_norm(x, w, b, groups, eps, silu=silu)
    torch.cuda.synchronize()
    fused = _gn_route(x, groups) == "fused"
    assert (N.group_norm_stats.launches, N.group_norm_apply.launches, N.group_norm_fused.launches) == (
        launches[0] + (not fused), launches[1] + (not fused), launches[2] + fused)
    assert N.group_norm_plain.calls == calls
    _close_grads((y,), (N.group_norm_plain(x, w, b, groups, eps, silu=silu),), RMS_TOL["GN"])
    _, _, mean, inv = N.group_norm_stats(x, w, b, groups, eps)
    xd = x.double().reshape(shape[0], -1, groups, shape[-1] // groups)
    mean64 = xd.mean(dim=(1, 3))
    var64 = xd.var(dim=(1, 3), unbiased=False)
    rms = xd.square().mean(dim=(1, 3)).sqrt()
    assert ((mean.double() - mean64).abs() / rms).max().item() <= STATS_TOL
    assert (inv.double() * (var64 + eps).sqrt() - 1).abs().max().item() <= STATS_TOL


# the main paths' GroupNorm sites and their route in bf16 and in fp32 (fused
# at ds2, ds4, mid, ds8 and, in bf16, the ds8 time_stack, whose fp32 slab is
# 204 KB; K7 + K8 at ds1, its concatenation and the ds1 time_stack) and the
# fused kernel's slab edge: 1536 rows of one group of 128 bytes (64 bf16 or 32
# fp32 channels) fill its 196 608 bytes, one row more goes to K7 + K8
GN_SITES = [((28, 14, 26, 1280), "fused", "fused"), ((28, 7, 13, 1280), "fused", "fused"),
            ((28, 7, 13, 2560), "fused", "fused"), ((28, 28, 52, 640), "fused", "fused"),
            ((2, 14, 7, 13, 1280), "fused", "stream"), ((28, 56, 104, 320), "stream", "stream"),
            ((28, 56, 104, 960), "stream", "stream"), ((2, 14, 56, 104, 320), "stream", "stream"),
            ((2, 1536, 2048), "fused", "fused"), ((2, 1537, 2048), "stream", "stream")]


@pytest.mark.gpu
@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("silu", [False, True])
@pytest.mark.parametrize("shape,bf16_route,fp32_route", GN_SITES)
def test_group_norm_routes_at_the_sites(cuda, dt, silu, shape, bf16_route, fp32_route):
    """Each route where group_norm_route sends it (one launch on the fused one,
    K7 + K8 on the other), y, a, s, mean and inv against the plain versions,
    the statistics against fp64, and two runs bitwise equal."""
    dtype = DTYPES[dt]
    route = bf16_route if dtype == torch.bfloat16 else fp32_route
    if dtype == torch.float32 and shape[-1] == 2048:
        shape = shape[:-1] + (1024,)   # the same slab edge in fp32
    x, w, b = _gn_inputs(cuda, dtype, shape, seed=90)
    assert _gn_route(x, 32) == route
    before = N.group_norm_stats.launches + N.group_norm_apply.launches + N.group_norm_fused.launches
    y, a, s, mean, inv = N._forward(x, w, b, 32, 1e-5, silu)
    torch.cuda.synchronize()
    after = N.group_norm_stats.launches + N.group_norm_apply.launches + N.group_norm_fused.launches
    assert after - before == (1 if route == "fused" else 2)
    a_ref, s_ref, mean_ref, inv_ref = N.group_norm_affine_plain(x, w, b, 32, 1e-5)
    _close_grads((y,), (N.group_norm_apply_plain(x, a_ref, s_ref, silu),), RMS_TOL["GN"])
    _close_grads((a, s, mean, inv), (a_ref, s_ref, mean_ref, inv_ref), RMS_TOL["GN"])
    xd = x.double().reshape(shape[0], -1, 32, shape[-1] // 32)
    rms = xd.square().mean(dim=(1, 3)).sqrt()
    assert ((mean.double() - xd.mean(dim=(1, 3))).abs() / rms).max().item() <= STATS_TOL
    assert (inv.double() * (xd.var(dim=(1, 3), unbiased=False) + 1e-5).sqrt() - 1).abs().max().item() <= STATS_TOL
    again = N._forward(x, w, b, 32, 1e-5, silu)
    assert all(torch.equal(p, q) for p, q in zip((y, a, s, mean, inv), again))


# the backward's routes (ops.norm.group_norm_backward_route) in bf16 and fp32:
# the slab kernel on one block ("fused") or a cluster of 2, 4, 8 and 16 blocks
# ("cluster": [2, 48, 48, 320], [2, 96, 96, 512], the autoencoder's [2, 112,
# 208, 512], the inversion's ds1 concat and, in fp32, the ds8 time_stack), K9 +
# K10 ("stream") where no slab fits (the ds1 time_stack), where a cluster of 8
# or 16 would walk many items (UNet ds1 and its concat at 28 frames), where no
# slab of whole groups has rows of a multiple of 16 bytes, or where its rows
# are narrower than 32 bytes (the first three: 8 and 16 groups of 4 channels)
GN_BWD_CASES = [((2, 6, 8, 32), 8, "stream", "stream"), ((3, 7, 13, 64), 16, "stream", "stream"),
                ((2, 14, 8, 8, 32), 8, "stream", "stream"),
                ((2, 6, 8, 128), 8, "fused", "fused"), ((28, 91, 1280), 32, "fused", "fused"),
                ((2, 33, 2560), 32, "fused", "fused"), ((1, 5000, 128), 32, "stream", "stream"),
                ((2, 48, 48, 320), 32, "cluster", "cluster"), ((2, 96, 96, 512), 32, "cluster", "cluster"),
                ((2, 112, 208, 512), 32, "cluster", "cluster"), ((2, 64, 64, 960), 32, "cluster", "cluster"),
                ((28, 56, 104, 320), 32, "stream", "stream"),
                ((28, 56, 104, 960), 32, "stream", "stream"), ((2, 14, 7, 13, 1280), 32, "fused", "cluster"),
                ((2, 14, 56, 104, 320), 32, "stream", "stream"), ((3, 17, 5, 6), 2, "stream", "stream"),
                ((2, 9, 4, 36), 4, "stream", "fused")]


def _gn_bwd_counts():
    return (N.group_norm_backward_slab.launches, N.group_norm_backward_slab.cluster_launches,
            N.group_norm_backward_stats.launches, N.group_norm_backward_apply.launches)


def _gn_bwd_inputs(cuda, dtype, shape, groups, seed=70):
    x, w, b = _gn_inputs(cuda, dtype, shape, seed=seed)
    dy = _randn(cuda, seed + 5, dtype, *shape)
    return (x, dy, w) + N.group_norm_stats(x, w, b, groups, 1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("silu", [False, True])
@pytest.mark.parametrize("shape,groups,bf16_route,fp32_route", GN_BWD_CASES)
def test_group_norm_backward(cuda, dt, silu, shape, groups, bf16_route, fp32_route):
    """The backward on the route group_norm_backward_route gives (one launch
    of the slab kernel on "fused" and "cluster", K9 + K10 on "stream", no
    plain call) vs the plain coefficient form on the forward's statistics: dx,
    dweight and dbias; two runs bitwise equal."""
    dtype = DTYPES[dt]
    route = bf16_route if dtype == torch.bfloat16 else fp32_route
    args = _gn_bwd_inputs(cuda, dtype, shape, groups)
    x = args[0]
    got, plan = N.group_norm_backward_route(shape[0], x.numel() // (shape[0] * shape[-1]), shape[-1], groups,
                                            x.element_size(), True)
    assert got == route
    before, calls = _gn_bwd_counts(), N.group_norm_backward_plain.calls
    out = N._backward(*args, groups, silu)
    torch.cuda.synchronize()
    slab = route != "stream"
    assert tuple(q - p for p, q in zip(before, _gn_bwd_counts())) == (
        slab, route == "cluster", not slab, not slab)
    assert N.group_norm_backward_plain.calls == calls
    ref = N.group_norm_backward_plain(*args, groups, silu)
    _close_grads(out[:1], ref[:1], RMS_TOL["GN"])
    _close_grads(out[1:], ref[1:], RMS_TOL["GN"])
    again = N._backward(*args, groups, silu)
    assert all(torch.equal(p, q) for p, q in zip(out, again))


# the GroupNorm backward sites chip_smoke.py reckons beyond GN_BWD_CASES: svd.yaml's
# first stage on a 7-frame clip of 448 x 832 (the VideoDecoder's up levels and
# its time_stacks, the mid at 7 items) and the sd_2_1 autoencoder step's 448 x 832
GN_BWD_VIDEO_SITES = [(7, 448, 832, 128), (1, 7, 448, 832, 128), (7, 224, 416, 256), (1, 7, 224, 416, 256),
                      (7, 112, 208, 512), (1, 7, 112, 208, 512), (7, 56, 104, 512), (1, 7, 56, 104, 512),
                      (2, 448, 832, 128), (2, 224, 416, 256)]


@pytest.mark.gpu
@pytest.mark.parametrize("dt", list(DTYPES))
def test_group_norm_backward_route_asks_the_card(cuda, dt):
    """At every site of GN_BWD_CASES and GN_BWD_VIDEO_SITES the route as the
    card places it (ops.norm.slab_placement, the live placement query the
    backward asks) is the route chip_smoke.py reckons from the shape alone,
    and the card answers that it holds at least one block or cluster of every
    slab plan."""
    import functools

    dtype = DTYPES[dt]
    unplaced = N.group_norm_backward_route.unplaced
    placed = functools.partial(N.slab_placement, cuda, dtype)
    for shape, groups in [(c[0], c[1]) for c in GN_BWD_CASES] + [(v, 32) for v in GN_BWD_VIDEO_SITES]:
        b, c = shape[0], shape[-1]
        site = (b, math.prod(shape) // (b * c), c, groups, torch.finfo(dtype).bits // 8, True)
        reckoned = N.group_norm_backward_route(*site)
        assert N.group_norm_backward_route(*site, placed) == reckoned, shape
        if reckoned[0] != "stream":
            assert placed(reckoned[1].n, reckoned[1].smem) >= 1, shape
    assert N.group_norm_backward_route.unplaced == unplaced


@pytest.mark.gpu
@pytest.mark.parametrize("shape,groups", [((2, 6, 8, 128), 8), ((28, 91, 1280), 32), ((2, 48, 48, 320), 32),
                                          ((2, 112, 208, 512), 32), ((2, 64, 64, 960), 32)])
def test_group_norm_backward_takes_k9_k10_where_the_card_places_nothing(cuda, monkeypatch, shape, groups):
    """With a placement query that answers 0 (a card or partition that holds
    no such block or cluster) a slab site's backward takes K9 + K10, chosen
    before any launch and counted (.unplaced), and its dx, dweight and dbias
    hold to the slab route's within the GroupNorm bounds."""
    args = _gn_bwd_inputs(cuda, torch.bfloat16, shape, groups, seed=74)
    slab = N._backward(*args, groups, True)
    monkeypatch.setattr(N, "slab_placement", lambda *a: 0)
    before, unplaced = _gn_bwd_counts(), N.group_norm_backward_route.unplaced
    stream = N._backward(*args, groups, True)
    torch.cuda.synchronize()
    assert tuple(q - p for p, q in zip(before, _gn_bwd_counts())) == (0, 0, 1, 1)
    assert N.group_norm_backward_route.unplaced == unplaced + 1
    _close_grads(stream[:1], slab[:1], RMS_TOL["GN"])
    _close_grads(stream[1:], slab[1:], RMS_TOL["GN"])


@pytest.mark.gpu
def test_group_norm_backward_refuses_a_cluster_the_device_cannot_place(cuda, monkeypatch):
    """A cluster of 32 blocks (the H100 places at most 16) is refused at the
    launch: RuntimeError before any output is returned, no launch counted, no
    other route taken."""
    args = _gn_bwd_inputs(cuda, torch.bfloat16, (2, 48, 48, 320), 32, seed=71)
    route, plan = N.group_norm_backward_route(2, 48 * 48, 320, 32, 2, True)
    assert route == "cluster"
    forced = plan._replace(n=32, rows=72, box_rows=72)   # 32 blocks of 72 rows cover 2304
    monkeypatch.setattr(N, "group_norm_backward_route", lambda *a: ("cluster", forced))
    before, calls = _gn_bwd_counts(), N.group_norm_backward_plain.calls
    with pytest.raises(RuntimeError, match="vs_group_norm_bwd_slab"):
        N._backward(*args, 32, True)
    assert _gn_bwd_counts() == before and N.group_norm_backward_plain.calls == calls


@pytest.mark.gpu
def test_group_norm_backward_unaligned_pointers(cuda):
    """An x off a 16-byte boundary takes the stream route with element loads;
    a dy off one on a slab route is copied (and counted) for the slab kernel,
    which itself refuses it."""
    shape = (28, 7, 13, 1280)
    x, dy, w, a, s, mean, inv = _gn_bwd_inputs(cuda, torch.bfloat16, shape, 32, seed=72)
    odd = lambda t: torch.cat([t.new_zeros(1), t.flatten()])[1:].view(shape)   # contiguous, 2 bytes off
    ref = N.group_norm_backward_plain(x, dy, w, a, s, mean, inv, 32, True)
    before = _gn_bwd_counts()
    out = N._backward(odd(x), dy, w, a, s, mean, inv, 32, True)
    assert tuple(q - p for p, q in zip(before, _gn_bwd_counts())) == (0, 0, 1, 1)
    _close_grads(out[:1], ref[:1], RMS_TOL["GN"])
    _close_grads(out[1:], ref[1:], RMS_TOL["GN"])
    copies, before = N.group_norm.copies, _gn_bwd_counts()
    out = N._backward(x, odd(dy), w, a, s, mean, inv, 32, True)
    assert N.group_norm.copies == copies + 1 and _gn_bwd_counts()[0] == before[0] + 1
    assert all(torch.equal(p, q) for p, q in zip(out, N._backward(x, dy, w, a, s, mean, inv, 32, True)))
    with pytest.raises(ValueError, match="no slab"):
        N.group_norm_backward_slab(x, odd(dy), w, a, s, mean, inv, 32, True)


@pytest.mark.gpu
@pytest.mark.parametrize("c,launches", [(64, (0, 0, 1, 1)), (256, (1, 0, 0, 0))])
def test_group_norm_autograd_and_strided_input(cuda, c, launches):
    """With grad on the CUDA path runs GroupNormFn (in the backward K9 + K10
    at 64 channels, rows of 8 bytes a group; the slab kernel on one block at
    256), agrees with autograd through the plain forward, and is the same from
    run to run; a strided input is copied and counted."""
    x, w, b = _gn_inputs(cuda, torch.float32, (2, 10, 12, c), seed=80)
    leaves = [t.clone().requires_grad_() for t in (x, w, b)]
    y = N.group_norm(*leaves, 32, 1e-5, silu=True)
    assert y.grad_fn is not None
    before = _gn_bwd_counts()
    y.square().sum().backward()
    assert tuple(q - p for p, q in zip(before, _gn_bwd_counts())) == launches
    plain = [t.clone().requires_grad_() for t in (x, w, b)]
    N.group_norm_plain(*plain, 32, 1e-5, silu=True).square().sum().backward()
    _close_grads([t.grad for t in leaves], [t.grad for t in plain], None)
    again = [t.clone().requires_grad_() for t in (x, w, b)]
    N.group_norm(*again, 32, 1e-5, silu=True).square().sum().backward()
    assert all(torch.equal(p.grad, q.grad) for p, q in zip(leaves, again))

    xt = x.permute(0, 2, 1, 3)  # [2, 12, 10, C], strided
    copies = N.group_norm.copies
    with torch.no_grad():
        _close(N.group_norm(xt, w, b, 32), N.group_norm_plain(xt, w, b, 32))
    assert N.group_norm.copies == copies + 1
    with pytest.raises(ValueError, match="contiguous"):
        N.group_norm_apply(xt, *N.group_norm_stats(x, w, b, 32, 1e-5)[:2], False)


def _check_forward(fn, plain, rms_tol, *args):
    """One launch of the wrapper (the plain version's counter does not move),
    then the plain version, held to the forward bounds of the docstring."""
    launches, calls = fn.launches, plain.calls
    out = fn(*args)
    torch.cuda.synchronize()
    assert fn.launches == launches + 1 and plain.calls == calls
    _close_grads((out,), (plain(*args),), rms_tol)
    return out


# ragged M (1, 28, 2156 rows), N (not a multiple of the 64- and 128-wide tiles),
# K (not a multiple of the 32-deep slice, and of the 8-element vector: 20, 5)
MM_SHAPES = [((28,), 1024, 320), ((2, 77, ), 1024, 640), ((3, 130), 320, 320), ((300,), 72, 200),
             ((257,), 20, 50), ((1,), 64, 128), ((5, 7, 9), 5, 3), ((4, 91), 1280, 1280)]


@pytest.mark.gpu
@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("lead,k,n", MM_SHAPES)
def test_matmul_bias(cuda, dt, with_bias, lead, k, n):
    dtype = DTYPES[dt]
    x = _randn(cuda, 90, dtype, *lead, k)
    w = _randn(cuda, 91, dtype, n, k, scale=k ** -0.5)
    bias = _randn(cuda, 92, dtype, n) if with_bias else None
    y = _check_forward(MM.matmul_bias, MM.matmul_bias_plain, RMS_TOL["K11"], x, w, bias)
    assert y.shape == tuple(lead) + (n,) and y.is_contiguous()


# K11's wgmma kernel: M below, around and far above the 128- and 192-row
# tiles, N off the 160-wide tile (168), K off the 64-channel slice (1032)
MM_WGMMA_SHAPES = [(1, 320, 320), (28, 1024, 1280), (193, 1032, 168), (193, 320, 1280), (28, 1032, 320),
                   (2156, 1024, 1280), (163072, 320, 320), (163072, 1024, 168)]


@pytest.mark.gpu
@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("m,k,n", MM_WGMMA_SHAPES)
def test_matmul_bias_wgmma_route(cuda, with_bias, m, k, n):
    """bf16 inputs that TMA can address run the wgmma kernel (the route
    counter moves with the launch counter), within the forward bounds."""
    bf = torch.bfloat16
    x = _randn(cuda, 140, bf, m, k)
    w = _randn(cuda, 141, bf, n, k, scale=k ** -0.5)
    bias = _randn(cuda, 142, bf, n) if with_bias else None
    wg = MM.matmul_bias.wgmma_launches
    y = _check_forward(MM.matmul_bias, MM.matmul_bias_plain, RMS_TOL["K11"], x, w, bias)
    assert MM.matmul_bias.wgmma_launches == wg + 1 and y.shape == (m, n)


@pytest.mark.gpu
def test_matmul_bias_unaddressable_k_takes_the_mma_sync_tile(cuda):
    """K % 8 != 0 (x's rows off a 16-byte stride: TMA cannot address them) and
    fp32 do not run the wgmma kernel; both stay within the bounds."""
    for dtype in (torch.bfloat16, torch.float32):
        x = _randn(cuda, 143, dtype, 50, 65)
        w = _randn(cuda, 144, dtype, 40, 65, scale=65 ** -0.5)
        wg = MM.matmul_bias.wgmma_launches
        _check_forward(MM.matmul_bias, MM.matmul_bias_plain, RMS_TOL["K11"], x, w, None)
        assert MM.matmul_bias.wgmma_launches == wg


@pytest.mark.gpu
def test_matmul_bias_unaligned_operands_and_refusals(cuda):
    """A bias and an x that start off a 16-byte boundary (element loads), a
    strided x (refused), mixed dtypes (refused)."""
    bf = torch.bfloat16
    x = _randn(cuda, 93, bf, 40 * 64 + 1)[1:].view(40, 64)
    w = _randn(cuda, 94, bf, 48, 64, scale=0.125)
    bias = _randn(cuda, 95, bf, 49)[1:]
    _check_forward(MM.matmul_bias, MM.matmul_bias_plain, RMS_TOL["K11"], x, w, bias)
    with pytest.raises(ValueError, match="contiguous"):
        MM.matmul_bias(x[:, ::2], w[:, :32].contiguous())
    with pytest.raises(ValueError, match="dtypes"):
        MM.matmul_bias(x, w.float())


# image-boundary rows: B*H*W not a multiple of the 256-row tile, tiles that span
# two and three images (91- and 10-pixel images); 1- and 2-pixel-wide and
# 1-pixel-high images; Cin off the 64-deep slice (96, 40, 32) and off the vector
# (20, 5: the element-load tile); Cout off the 160-wide tile (72, 168, 50, 3); the
# skip-concatenation widths 960 -> 320 and 2560 -> 1280 at a small image
C3_SHAPES = [(3, 7, 13, 64, 64), (2, 9, 5, 96, 320), (28, 7, 13, 40, 72), (2, 1, 11, 32, 32),
             (2, 6, 1, 32, 48), (1, 1, 1, 64, 64), (2, 5, 6, 20, 50), (3, 4, 4, 5, 3), (1, 16, 16, 320, 128),
             (2, 12, 12, 960, 320), (5, 3, 5, 2560, 1280), (30, 5, 2, 64, 168)]


@pytest.mark.gpu
@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("b,h,w,cin,cout", C3_SHAPES)
def test_conv3x3_same(cuda, dt, with_bias, b, h, w, cin, cout):
    dtype = DTYPES[dt]
    x = _randn(cuda, 96, dtype, b, h, w, cin)
    weight = _randn(cuda, 97, dtype, cout, cin, 3, 3, scale=(9 * cin) ** -0.5)
    bias = _randn(cuda, 98, dtype, cout) if with_bias else None
    y = _check_forward(C3.conv3x3_same, C3.conv3x3_plain, RMS_TOL["K12"], x, weight, bias)
    # the plain version against the library convolution, in fp32 (TF32 off)
    if dtype == torch.float32:
        saved = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = False
        ref = torch.nn.functional.conv2d(x.permute(0, 3, 1, 2), weight, bias, padding=1).permute(0, 2, 3, 1)
        torch.backends.cudnn.allow_tf32 = saved
        _close_grads((y,), (ref,), None)


@pytest.mark.gpu
def test_conv3x3_images_do_not_mix(cuda):
    """Each image of a batch convolves as it does alone: rows of a tile that
    spans the last pixels of image b and the first of b + 1 read only their
    own image's halo."""
    bf = torch.bfloat16
    x = _randn(cuda, 99, bf, 5, 6, 7, 64)
    weight = _randn(cuda, 100, bf, 64, 64, 3, 3, scale=1 / 24)
    bias = _randn(cuda, 101, bf, 64)
    whole = C3.conv3x3_same(x, weight, bias)
    for i in range(x.shape[0]):
        assert torch.equal(whole[i:i + 1], C3.conv3x3_same(x[i:i + 1].contiguous(), weight, bias))


@pytest.mark.gpu
def test_conv3x3_weight_relay_is_cached_per_version(cuda):
    x = _randn(cuda, 102, torch.bfloat16, 1, 4, 4, 32)
    weight = _randn(cuda, 103, torch.bfloat16, 32, 32, 3, 3, scale=0.06)
    before = C3.conv3x3_same.relays
    y0 = C3.conv3x3_same(x, weight)
    y1 = C3.conv3x3_same(x, weight)
    assert C3.conv3x3_same.relays == before + 1 and torch.equal(y0, y1)
    weight.mul_(2.0)
    y2 = C3.conv3x3_same(x, weight)
    assert C3.conv3x3_same.relays == before + 2
    _close_grads((y2,), (C3.conv3x3_plain(x, weight),), RMS_TOL["K12"])


@pytest.mark.gpu
def test_conv3x3_module_with_fp32_weights_relays_once(cuda):
    """A ResBlock conv that keeps fp32 parameters under bf16 activations: the
    cast is part of the cached tap-major copy, so a second forward makes none."""
    from vidseg_diffusion_tpu_torch.models.layers import Conv3x3NHWC

    conv = Conv3x3NHWC(32, 48).to(cuda)
    x = _randn(cuda, 111, torch.bfloat16, 2, 5, 7, 32)
    before = C3.conv3x3_same.relays
    with torch.no_grad():
        y0 = conv(x)
        y1 = conv(x)
        want = C3.conv3x3_same(x, conv.weight.bfloat16(), conv.bias.bfloat16())
    assert C3.conv3x3_same.relays == before + 2  # the module's copy, and the pre-cast weight's
    assert y0.dtype == torch.bfloat16 and torch.equal(y0, y1) and torch.equal(y0, want)
    with torch.no_grad():
        conv(x)
    assert C3.conv3x3_same.relays == before + 2


@pytest.mark.gpu
@pytest.mark.parametrize("dt", list(DTYPES))
def test_autograd_through_matmul_bias_and_conv3x3(cuda, dt):
    """With grad on the wrappers return outputs with a grad_fn, the forward is
    one launch, and the gradients agree with autograd through the plain
    versions; under no_grad nothing is recorded."""
    dtype = DTYPES[dt]
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    x = _randn(cuda, 104, dtype, 3, 50, 72)
    w = _randn(cuda, 105, dtype, 40, 72, scale=72 ** -0.5)
    bias = _randn(cuda, 106, dtype, 40)
    xc = _randn(cuda, 107, dtype, 2, 6, 5, 24)
    wc = _randn(cuda, 108, dtype, 16, 24, 3, 3, scale=216 ** -0.5)
    bc = _randn(cuda, 109, dtype, 16)
    for fn, plain, args in ((MM.matmul_bias, MM.matmul_bias_plain, (x, w, bias)),
                            (C3.conv3x3_same, C3.conv3x3_plain, (xc, wc, bc))):
        leaves = [t.clone().requires_grad_() for t in args]
        launches = fn.launches
        y = fn(*leaves)
        assert y.grad_fn is not None and fn.launches == launches + 1
        g = _randn(cuda, 110, dtype, *y.shape)  # the same output gradient on both sides
        y.backward(g)
        assert fn.launches == launches + 1
        ref = [t.clone().requires_grad_() for t in args]
        plain(*ref).backward(g)
        _close_grads([t.grad for t in leaves], [t.grad for t in ref], 5e-4)
        with torch.no_grad():
            assert fn(*leaves).grad_fn is None
    torch.backends.cudnn.allow_tf32 = saved


# -- the head dims of part A of ROADMAP section C's repair: D = 16 (the tiny
# configs) for K1, K2, K3 and their backwards K5, K6, K13 (K5 on K13's
# strides); one 512-dim head for K1 (K3's D = 512 wgmma kernel on the packed
# rows) and K2 (the wide kernel); D = 512 backwards of K1 / K2 and 512 at two
# blhd heads refused before any launch

D16_PACKED = [(2, 300, 300, 2), (28, 91, 91, 4), (2, 100, 37, 2), (1, 600, 600, 3)]


@pytest.mark.gpu
@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("rounded", [False, True])
@pytest.mark.parametrize("b,lq,lk,h", D16_PACKED)
def test_flash_attention_packed_d16(cuda, dt, rounded, b, lq, lk, h):
    """K1 at 16-dim heads, both sums: bf16 on the mma.sync template
    (`.mma_launches`), fp32 on the FMA kernel, within chip_smoke.py's forward
    bounds of the plain version; its LSE within LSE_TOL."""
    dtype = DTYPES[dt]
    q = _randn(cuda, 200, dtype, b, lq, h * 16, scale=1.5)
    k, v = (_randn(cuda, i, dtype, b, lk, h * 16, scale=1.5) for i in (201, 202))
    mma, launches = A.flash_attention_packed.mma_launches, A.flash_attention_packed.launches
    out = A.flash_attention_packed(q, k, v, h, psum_rounded=rounded)
    torch.cuda.synchronize()
    assert A.flash_attention_packed.launches == launches + 1
    assert A.flash_attention_packed.mma_launches == mma + (dtype == torch.bfloat16)
    ref = A.flash_attention_packed_reference(q, k, v, h, psum_rounded=rounded)
    _close_grads((out,), (ref,), RMS_TOL["K1"])
    _, lse = A._flash_attention_packed_forward(q, k, v, h, None, save_lse=True, psum_rounded=rounded)
    _, lse_ref = A.flash_attention_packed_reference(q, k, v, h, save_lse=True, psum_rounded=rounded)
    assert (lse - lse_ref).abs().max().item() <= LSE_TOL


NF16_DRAWS = 8   # the draws the normalise-first D = 16 test pools (seeds 210 + 3i, 211 + 3i, 212 + 3i)


@pytest.mark.gpu
@pytest.mark.parametrize("layout,qshape,kshape", [
    ("blhd", (1, 91, 2, 16), (1, 91, 2, 16)),     # one video item's mid attention: too few folded rows
    ("bhld", (1, 4, 257, 16), (1, 4, 257, 16)),   # a tiny CLIP tower's 257 tokens
    ("blhd", (2, 640, 4, 16), (2, 77, 4, 16)),    # lengths on both sides of 512
    ("bhld", (4, 4, 257, 16), (4, 4, 257, 16)),
])
def test_normalise_first_d16_holds_to_mha_reference(cuda, layout, qshape, kshape):
    """The "mha_reference" sites at 16-dim heads run the normalise-first
    mma.sync kernel: every element within one bf16 step of mha_reference on
    the same inputs (per draw), at most 0.1 % of the elements differing over
    NF16_DRAWS draws pooled (the first the draw of seeds 210-212). At 2912
    elements a draw the bound is a count of two, and the plain version of the
    kernel's own base-2 arithmetic (_attention_normalised) on the CPU passes
    three on some draws (PERF.md section 7), so one draw is not a measurement
    of the share; the kernel is also held to that plain version under the
    same bounds, the second witness."""
    lq, lk = (qshape[1], kshape[1]) if layout == "blhd" else (qshape[2], kshape[2])
    assert A.site_route(layout, qshape[0], lq, lk) == "mha_reference"
    fn = A.flash_attention_packed if layout == "blhd" else A.flash_attention
    to_blhd = (lambda x: x.transpose(1, 2)) if layout == "bhld" else (lambda x: x)
    diffs = {"mha_reference": [], "_attention_normalised": []}
    for i in range(NF16_DRAWS):
        q = _randn(cuda, 210 + 3 * i, torch.bfloat16, *qshape, scale=1.5)
        k, v = (_randn(cuda, 211 + 3 * i + j, torch.bfloat16, *kshape, scale=1.5) for j in range(2))
        nf, site = fn.normalised_launches, A.mha_reference_site.calls
        out = A.dot_product_attention(q, k, v, layout=layout)
        torch.cuda.synchronize()
        assert fn.normalised_launches == nf + 1 and A.mha_reference_site.calls == site
        qc, kc, vc = q.cpu(), k.cpu(), v.cpu()
        plain = A._attention_normalised(to_blhd(qc), to_blhd(kc), to_blhd(vc), 1.0 / math.sqrt(qshape[-1]))
        for name, ref in (("mha_reference", A.mha_reference(qc, kc, vc, layout=layout)),
                          ("_attention_normalised", to_blhd(plain.to(torch.bfloat16)))):
            assert out.shape == ref.shape and ref.dtype == torch.bfloat16
            diff = (out.cpu().float() - ref.float()).abs()
            step = 2.0 ** (math.floor(math.log2(ref.float().abs().max().item())) - 7)
            assert diff.max().item() <= step, (name, i, diff.max().item(), step)
            diffs[name].append(diff.flatten())
    for name, d in diffs.items():
        frac = (torch.cat(d) > 0).float().mean().item()
        assert frac <= 1e-3, (name, frac, [int((x > 0).sum()) for x in d])


@pytest.mark.gpu
@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("b,h,lq,lk", [(2, 4, 100, 100), (1, 16, 257, 257), (1, 2, 600, 90)])
def test_flash_attention_bhld_d16(cuda, dt, b, h, lq, lk):
    """K3 at 16-dim heads (bf16 on the mma.sync template) against its plain
    version without a gradient (the fp32 sum) and with its LSE (the rounded
    sum); K13 at D = 16 runs K5 on the bhld strides (bf16: its mma.sync
    kernels, counted on K5's `.mma_launches`)."""
    dtype = DTYPES[dt]
    q, g = (_randn(cuda, i, dtype, b, h, lq, 16, scale=1.5) for i in (220, 221))
    k, v = (_randn(cuda, i, dtype, b, h, lk, 16, scale=1.5) for i in (222, 223))
    _check(A.flash_attention, A.flash_attention_reference, q, k, v)
    out, lse = A._flash_attention_forward(q, k, v, None, save_lse=True)
    _, lse_ref = A.flash_attention_reference(q, k, v, save_lse=True)
    assert (lse - lse_ref).abs().max().item() <= LSE_TOL
    k13, k5 = A.flash_attention_backward.launches, A.flash_attention_packed_backward.launches
    mma = A.flash_attention_packed_backward.mma_launches
    got = A.flash_attention_backward(q, k, v, out, lse, g)
    torch.cuda.synchronize()
    assert A.flash_attention_backward.launches == k13 and A.flash_attention_packed_backward.launches == k5 + 1
    assert A.flash_attention_packed_backward.mma_launches == mma + (dtype == torch.bfloat16)
    _close_grads(got, A.flash_attention_backward_reference(q, k, v, out, lse, g), RMS_TOL["K5"])


@pytest.mark.gpu
@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("b,lq,lk,h", D16_PACKED)
def test_flash_attention_packed_backward_d16(cuda, dt, b, lq, lk, h):
    """K5 at 16-dim heads on K1's LSE, within chip_smoke.py's backward bounds:
    bf16 on the mma.sync kernels (`.mma_launches`, no wgmma launch; ragged query
    and key tails), fp32 on the FMA kernels (no route counter moves)."""
    dtype = DTYPES[dt]
    q, g = (_randn(cuda, i, dtype, b, lq, h * 16, scale=1.5) for i in (230, 231))
    k, v = (_randn(cuda, i, dtype, b, lk, h * 16, scale=1.5) for i in (232, 233))
    out, lse = A._flash_attention_packed_forward(q, k, v, h, None, save_lse=True)
    fn = A.flash_attention_packed_backward
    wg, mma = fn.wgmma_launches, fn.mma_launches
    _check(fn, A.flash_attention_packed_backward_reference, q, k, v, out, lse, g, h, rms_tol=RMS_TOL["K5"])
    assert fn.wgmma_launches == wg and fn.mma_launches == mma + (dtype == torch.bfloat16)


@pytest.mark.gpu
@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("t,s,h", [(1, 9, 2), (3, 91, 2), (14, 364, 4), (32, 20, 1)])
def test_temporal_attention_direct_d16_and_backward(cuda, dt, t, s, h):
    """K2 and K6 at 16-dim heads on the CUDA-core kernels (no mma.sync
    launch), bf16 roundings applied, within chip_smoke.py's bounds; and
    autograd through K2 + K6 against autograd of the plain forward."""
    dtype = DTYPES[dt]
    q, k, v, g = (_randn(cuda, i, dtype, 2 * t, s, h, 16, scale=1.5) for i in (240, 241, 242, 243))
    mma = A.temporal_attention_direct.mma_launches, A.temporal_attention_direct_backward.mma_launches
    out = A.temporal_attention_direct(q, k, v, t=t)
    torch.cuda.synchronize()
    _close_grads((out,), (A.temporal_attention_direct_reference(q, k, v, t=t),), RMS_TOL["K2"])
    _check(A.temporal_attention_direct_backward, A.temporal_attention_direct_backward_reference,
           q, k, v, out, g, t, rms_tol=RMS_TOL["K6"])
    assert (A.temporal_attention_direct.mma_launches, A.temporal_attention_direct_backward.mma_launches) == mma


@pytest.mark.gpu
@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("d,h", [(16, 2), (64, 5), (512, 1)])
@pytest.mark.parametrize("t,s", [(33, 91), (40, 7), (47, 1000), (48, 20), (63, 20), (64, 9), (65, 9), (128, 3),
                                 (200, 3)])
def test_temporal_attention_past_32_frames(cuda, dt, d, h, t, s):
    """K2 and K6 past 32 frames at every head dim the configs produce, in
    both dtypes, over two videos, up to 200 frames (no frame cap; key tiles
    ragged on both sides of the 64 frames whose logits stay in registers;
    tokens off every unit): each launch on the long route (`.long_launches`,
    by head dim `.dim_launches`: the tensor-core kernels at D = 64 and 512, the
    frame walk at 16), within chip_smoke.py's bounds of the plain versions;
    fp32 at D = 512 also within FP64_RMS_TOL of the plain versions run in
    float64."""
    dtype = DTYPES[dt]
    q, k, v, g = (_randn(cuda, 340 + i, dtype, 2 * t, s, h, d, scale=1.5) for i in range(4))
    k2, k6 = A.temporal_attention_direct, A.temporal_attention_direct_backward
    long2, long6, dims2, dims6 = k2.long_launches, k6.long_launches, k2.dim_launches[d], k6.dim_launches[d]
    _check(k2, A.temporal_attention_direct_reference, q, k, v, t=t)
    out = k2(q, k, v, t=t)
    _check(k6, A.temporal_attention_direct_backward_reference, q, k, v, out, g, t, rms_tol=RMS_TOL["K6"])
    assert (k2.long_launches, k6.long_launches) == (long2 + 2, long6 + 1)
    assert (k2.dim_launches[d], k6.dim_launches[d]) == (dims2 + 2, dims6 + 1)
    if dtype == torch.float32 and d == 512:
        assert _fp64_rms((out,), A.temporal_attention_direct_reference, q, k, v, t) <= FP64_RMS_TOL
        assert _fp64_rms(k6(q, k, v, out, g, t), A.temporal_attention_direct_backward_reference,
                         q, k, v, out, g, t) <= FP64_RMS_TOL


@pytest.mark.gpu
@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("d,h", [(64, 5), (512, 1)])
@pytest.mark.parametrize("t", [48, 65])
def test_temporal_attention_past_32_frames_repeats_bitwise(cuda, dt, d, h, t):
    """Two launches of K2 and of K6 past 32 frames on the same inputs give the
    same bits (no atomics, no sum across blocks), with the logits held in
    registers (48 frames) and walked twice (65)."""
    dtype = DTYPES[dt]
    q, k, v, g = (_randn(cuda, 360 + i, dtype, 2 * t, 91, h, d, scale=1.5) for i in range(4))
    k2, k6 = A.temporal_attention_direct, A.temporal_attention_direct_backward
    out = k2(q, k, v, t=t)
    assert torch.equal(out, k2(q, k, v, t=t))
    for a, b in zip(k6(q, k, v, out, g, t), k6(q, k, v, out, g, t)):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_temporal_backward_fp32_512_frame_limit(cuda):
    """K6 in fp32 at D = 512 has no frame limit: past the 32-row tiles' 64
    frames the team kernel keeps each query row's max, sum and delta in
    shared memory up to 784 frames and in the wrapper's device scratch past
    them; 784, 785 and 1000 frames each run once, within chip_smoke.py's bound
    of the plain version."""
    k6 = A.temporal_attention_direct_backward
    for t in (784, 785, 1000):
        q, k, v, g = (_randn(cuda, 390 + i, torch.float32, t, 1, 1, 512, scale=1.5) for i in range(4))
        out = A.temporal_attention_direct_reference(q, k, v, t=t).contiguous()
        long6 = k6.long_dim_launches[512]
        _check(k6, A.temporal_attention_direct_backward_reference, q, k, v, out, g, t, rms_tol=RMS_TOL["K6"])
        assert k6.long_dim_launches[512] == long6 + 1


@pytest.mark.gpu
@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("d", [64, 512])
def test_temporal_attention_past_32_frames_refuses_unaligned_bases(cuda, dt, d):
    """Past 32 frames the tensor-core kernels read their rows by TMA: a
    contiguous view whose base is off a 16-byte boundary raises a ValueError
    naming the wrapper before any launch (no fallback)."""
    dtype, t, s = DTYPES[dt], 40, 9
    n = 2 * t * s * d
    k2, k6 = A.temporal_attention_direct, A.temporal_attention_direct_backward
    good = [_randn(cuda, 380 + i, dtype, 2 * t, s, 1, d) for i in range(4)]
    bad = _randn(cuda, 384, dtype, n + 1)[1:].view(2 * t, s, 1, d)
    assert bad.is_contiguous() and bad.data_ptr() % 16
    launches = k2.launches, k6.launches, k2.long_launches, k6.long_launches
    with pytest.raises(ValueError, match="temporal_attention_direct: .*16-byte aligned"):
        k2(bad, good[1], good[2], t=t)
    with pytest.raises(ValueError, match="temporal_attention_direct_backward: .*16-byte aligned"):
        k6(good[0], good[1], good[2], good[3], bad, t)
    torch.cuda.synchronize()
    assert (k2.launches, k6.launches, k2.long_launches, k6.long_launches) == launches


@pytest.mark.gpu
@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("b,l", [(2, 600), (1, 1024), (7, 5824)])
def test_flash_attention_packed_one_512_head(cuda, dt, b, l):
    """K1 at one 512-dim head (the VideoAttnBlock's attn2, [7, 5824, 1 x 512]
    at svd.yaml's decode): a "flash" site, the rounded sum; bf16 on K3's D =
    512 wgmma kernel through the packed strides (`.wgmma_launches`), fp32 on
    the split-TF32 kernel (`.tf32x3_launches`); within chip_smoke.py's forward
    bounds (the plain version on one batch item at 5824 tokens)."""
    dtype = DTYPES[dt]
    q, k, v = (_randn(cuda, 250 + i, dtype, b, l, 512) for i in range(3))
    assert A.site_route("blhd", b, l, l) == "flash"
    wg, k3 = A.flash_attention_packed.wgmma_launches, A.flash_attention.launches
    x3 = A.flash_attention_packed.tf32x3_launches
    out = A.small_batched_attention(*(x.view(b, l, 1, 512) for x in (q, k, v))).view(b, l, 512)
    torch.cuda.synchronize()
    assert A.flash_attention_packed.wgmma_launches == wg + (dtype == torch.bfloat16)
    assert A.flash_attention_packed.tf32x3_launches == x3 + (dtype == torch.float32)
    assert A.flash_attention.launches == k3   # counted as K1's launch
    n = 1 if l > 2048 else b
    ref = A.flash_attention_packed_reference(q[:n], k[:n], v[:n], 1, psum_rounded=True)
    _close_grads((out[:n],), (ref,), RMS_TOL["K1"])


# the frames at which K2 at D = 512 runs the team kernel of temporal_attention_long_tc.cu up to 32 frames
# (csrc/temporal_attention.cu's kTc512FwdMinFrames*; the wide kernel below them)
K2_TC512_FRAMES = {"bf16": range(5, 33), "fp32": range(7, 33)}


@pytest.mark.gpu
@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("t,s", [(7, 5824), (14, 5824), (1, 40), (2, 1024), (32, 17), (33, 300), (64, 40), (3, 300),
                                 (4, 300), (5, 300), (6, 300), (7, 300), (13, 300), (16, 300), (17, 300), (31, 300)])
def test_temporal_attention_direct_512(cuda, dt, t, s):
    """K2 at one 512-dim head (the VideoAttnBlock's time mix: t = 7 or 14 frames
    of 5824 tokens at svd.yaml's decode) up to 32 frames on the team kernel at
    K2_TC512_FRAMES (`.tc_short_launches`) and on the wide kernel below them
    (`.wide_launches`: the crossover's sides at 4 / 5 frames in bf16 and 6 / 7
    in fp32), past them on the long route's tensor-core kernel
    (`.long_launches`), within chip_smoke.py's forward bounds, at ragged t and
    300 tokens (no multiple of any tile); fp32 on the team kernel also within
    FP64_RMS_TOL of the plain version in float64."""
    dtype = DTYPES[dt]
    b = 1 if s > 2048 else 2
    q, k, v = (_randn(cuda, 260 + i, dtype, b * t, s, 1, 512) for i in range(3))
    fn = A.temporal_attention_direct
    wide, short, long_ = fn.wide_launches, fn.tc_short_launches, fn.long_launches
    _check(fn, A.temporal_attention_direct_reference, q, k, v, t=t)
    tiled, tc = t <= A.TILED_FRAMES, t in K2_TC512_FRAMES[dt]
    assert (fn.wide_launches, fn.tc_short_launches, fn.long_launches) == (
        wide + (tiled and not tc), short + (tiled and tc), long_ + (not tiled))
    if tiled and tc and dtype == torch.float32:
        assert _fp64_rms((fn(q, k, v, t=t),), A.temporal_attention_direct_reference, q, k, v, t) <= FP64_RMS_TOL


# ragged frame counts up to 32 on K6's short tensor-core route: one frame (kept on CUDA cores), 3-5, 7, 13, both
# sides of the 16-row tiles and of 32
SHORT_TC_TS = (1, 3, 4, 5, 7, 13, 14, 16, 17, 31, 32)


@pytest.mark.gpu
@pytest.mark.parametrize("t", SHORT_TC_TS)
def test_temporal_backward_fp32_d64_short_route(cuda, t):
    """K6 in fp32 at D = 64 up to 32 frames over two videos of 91 tokens and
    5 heads: from 2 frames one launch on the resident split-TF32 kernel
    (`.tc_short_launches`, none on CUDA cores; at one frame, where dq and dk
    are rounding noise, the CUDA-core kernel, `.fma_launches`), within
    chip_smoke.py's backward bounds of the plain version; on the split-TF32
    kernel also within FP64_RMS_TOL of it in float64 on every gradient."""
    f32 = torch.float32
    q, k, v, g = (_randn(cuda, 420 + i, f32, 2 * t, 91, 5, 64, scale=1.5) for i in range(4))
    out = A.temporal_attention_direct_reference(q, k, v, t=t).contiguous()
    fn = A.temporal_attention_direct_backward
    short, fma = fn.tc_short_launches, fn.fma_launches
    _check(fn, A.temporal_attention_direct_backward_reference, q, k, v, out, g, t, rms_tol=RMS_TOL["K6"])
    tc = t > 1
    assert (fn.tc_short_launches, fn.fma_launches) == (short + tc, fma + (not tc))
    if tc:
        assert _fp64_rms(fn(q, k, v, out, g, t), A.temporal_attention_direct_backward_reference,
                         q, k, v, out, g, t) <= FP64_RMS_TOL


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["k6_fp32", "k2_bf16", "k2_fp32"])
@pytest.mark.parametrize("t", [14, 32])
def test_short_tc_routes_repeat_bitwise(cuda, case, t):
    """Two launches on the short tensor-core routes (K6 in fp32 at D = 64,
    K2 at D = 512) on the same inputs give the same bits."""
    dtype = torch.bfloat16 if case.endswith("bf16") else torch.float32
    d, h = (64, 5) if case.startswith("k6") else (512, 1)
    q, k, v, g = (_randn(cuda, 430 + i, dtype, 2 * t, 91, h, d, scale=1.5) for i in range(4))
    if case.startswith("k2"):
        assert torch.equal(A.temporal_attention_direct(q, k, v, t=t), A.temporal_attention_direct(q, k, v, t=t))
        return
    out = A.temporal_attention_direct_reference(q, k, v, t=t).contiguous()
    fn = A.temporal_attention_direct_backward
    for a, b in zip(fn(q, k, v, out, g, t), fn(q, k, v, out, g, t)):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_short_tc_routes_unaligned_bases(cuda):
    """A contiguous view whose base is off a 16-byte boundary: K6 in fp32 at
    D = 64 routes it to the CUDA-core kernel (`.fma_launches`, the C entry's
    route by alignment; none on `.tc_short_launches`), within chip_smoke.py's
    backward bounds; K2 at D = 512 raises a ValueError naming the wrapper
    before any launch (its wide and team kernels both read 16-byte vectors)."""
    f32, t = torch.float32, 14
    fn = A.temporal_attention_direct_backward
    q, k, v = (_randn(cuda, 440 + i, f32, 2 * t, 91, 5, 64) for i in range(3))
    n = 2 * t * 91 * 5 * 64
    g = _randn(cuda, 443, f32, n + 1)[1:].view(2 * t, 91, 5, 64)
    assert g.is_contiguous() and g.data_ptr() % 16
    out = A.temporal_attention_direct_reference(q, k, v, t=t).contiguous()
    short, fma = fn.tc_short_launches, fn.fma_launches
    _check(fn, A.temporal_attention_direct_backward_reference, q, k, v, out, g, t, rms_tol=RMS_TOL["K6"])
    assert (fn.tc_short_launches, fn.fma_launches) == (short, fma + 1)
    k2 = A.temporal_attention_direct
    good = [_randn(cuda, 444 + i, f32, t, 9, 1, 512) for i in range(2)]
    bad = _randn(cuda, 446, f32, t * 9 * 512 + 1)[1:].view(t, 9, 1, 512)
    launches = k2.launches
    with pytest.raises(ValueError, match="temporal_attention_direct: .*16-byte aligned"):
        k2(bad, *good, t=t)
    torch.cuda.synchronize()
    assert k2.launches == launches


@pytest.mark.gpu
def test_head_dims_off_the_table_are_refused_on_the_card(cuda):
    """512 at two blhd heads (forward, and under a gradient) and 40 at a
    temporal site raise the named ValueError before any launch; the two
    gradients at one 512-dim head run their kernels (K13's D = 512 kernels on
    the packed strides, K6's wide kernel) within chip_smoke.py's backward
    bounds of the plain versions."""
    bf = torch.bfloat16
    before = sum(f.launches for f in A.KERNEL_COUNTERS)
    q = _randn(cuda, 270, bf, 2, 600, 2, 512)
    with pytest.raises(ValueError, match="head dim 512 .*at one head only"):
        A.dot_product_attention(q, q, q, layout="blhd")
    with pytest.raises(ValueError, match="head dim 512 .*backward kernels.*at one head only"):
        A.dot_product_attention(q, q, q.requires_grad_(), layout="blhd")
    q = _randn(cuda, 273, bf, 14, 91, 2, 40)
    with pytest.raises(ValueError, match="temporal attention site: head dim 40"):
        A.temporal_attention_direct(q, q, q, t=14)
    assert sum(f.launches for f in A.KERNEL_COUNTERS) == before
    # autograd through the kernels against autograd through the plain forward
    # (as test_flash_attention_packed_autograd_matches_the_plain_forward): 1e-2 by norm
    packed_plain = lambda a, b_, c: A.flash_attention_packed_reference(
        *(x.reshape(2, 600, 512) for x in (a, b_, c)), 1).view(2, 600, 1, 512)
    for seed, shape, run, plain, counter in (
            (271, (2, 600, 1, 512), lambda a, b_, c: A.dot_product_attention(a, b_, c, layout="blhd"),
             packed_plain, A.flash_attention_packed_backward),
            (272, (14, 91, 1, 512), lambda a, b_, c: A.temporal_attention_direct(a, b_, c, t=14),
             lambda a, b_, c: A.temporal_attention_direct_reference(a, b_, c, t=14),
             A.temporal_attention_direct_backward)):
        x = [_randn(cuda, seed + 10 * i, bf, *shape) for i in range(3)]
        g = _randn(cuda, seed + 40, bf, *shape)
        leaves, ref = ([t.clone().requires_grad_() for t in x] for _ in range(2))
        launches, dims = counter.launches, counter.dim_launches[512]
        run(*leaves).backward(g)
        assert counter.launches == launches + 1 and counter.dim_launches[512] == dims + 1
        plain(*ref).backward(g)
        for got, want in zip(leaves, ref):
            assert bool(torch.isfinite(got.grad).all())
            rel = (got.grad.float() - want.grad.float()).norm().item() / want.grad.float().norm().item()
            assert rel <= 1e-2, rel


@pytest.mark.gpu
@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("b,l", [(1, 300), (2, 1000), (1, 5824)])
def test_packed_backward_at_one_512_head(cuda, dt, b, l):
    """K5 at one 512-dim head (the VideoAttnBlock's attn2 under a gradient:
    [7, 5824, 1 x 512] on the training clip) runs K13's D = 512 kernels on
    the packed strides (`.wgmma_launches` in bf16, `.tf32x3_launches` in fp32), on the LSE
    K1 writes there, within chip_smoke.py's backward bounds of the plain
    version (RMS_TOL["K13"])."""
    dtype = DTYPES[dt]
    q, k, v, g = (_randn(cuda, 280 + i, dtype, b, l, 512) for i in range(4))
    out, lse = A._flash_attention_packed_forward(q, k, v, 1, None, save_lse=True)
    _, lse_ref = A.flash_attention_packed_reference(q, k, v, 1, save_lse=True)
    assert lse.shape == (b, l, 1) and (lse - lse_ref).abs().max().item() <= LSE_TOL
    wg, k13 = A.flash_attention_packed_backward.wgmma_launches, A.flash_attention_backward.launches
    x3 = A.flash_attention_packed_backward.tf32x3_launches
    _check(A.flash_attention_packed_backward, A.flash_attention_packed_backward_reference, q, k, v, out, lse, g, 1,
           rms_tol=RMS_TOL["K13"])
    assert A.flash_attention_packed_backward.wgmma_launches == wg + (dtype == torch.bfloat16)
    assert A.flash_attention_packed_backward.tf32x3_launches == x3 + (dtype == torch.float32)
    assert A.flash_attention_backward.launches == k13   # counted as K5's launch


@pytest.mark.gpu
def test_tma_kernels_launch_from_a_thread_that_has_launched_nothing(cuda):
    """A thread's first CUDA call may be a TMA-fed kernel's tensor-map
    encoding (a driver call, which needs a context current on the thread):
    autograd's device thread runs the packed backward at one 512-dim head as
    the first node of a backward, and a fresh thread calls it directly; both
    launch K13's wgmma kernels and agree with the main thread's launch."""
    import threading

    bf = torch.bfloat16
    q, k, v, g = (_randn(cuda, 300 + i, bf, 2, 600, 512) for i in range(4))
    out, lse = A._flash_attention_packed_forward(q, k, v, 1, None, save_lse=True)
    want = A.flash_attention_packed_backward(q, k, v, out, lse, g, 1)
    got = []
    worker = threading.Thread(target=lambda: got.append(A.flash_attention_packed_backward(q, k, v, out, lse, g, 1)))
    worker.start()
    worker.join()
    torch.cuda.synchronize()
    assert len(got) == 1 and all(torch.equal(a, b) for a, b in zip(got[0], want))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    A.flash_attention_packed(*leaves, 1).backward(g)
    assert all(torch.equal(x.grad, w) for x, w in zip(leaves, want))


# the frames K6's tensor-core kernels take at D = 512 (the C entry's route by t: the wide kernel below them,
# the long route's tensor-core kernel past them)
K6_TC_FRAMES = {"bf16": range(4, 33), "fp32": range(5, 33)}


@pytest.mark.gpu
@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("t,s", [(7, 5824), (14, 5824), (1, 40), (2, 1024), (3, 17), (4, 90), (5, 91), (16, 300),
                                 (17, 64), (17, 5824), (24, 300), (28, 91), (32, 17), (32, 5824), (40, 91),
                                 (64, 17)])
def test_temporal_attention_direct_backward_512(cuda, dt, t, s):
    """K6 at one 512-dim head (the VideoAttnBlock's time mix under a gradient:
    t = 7 on the training clip, 14 on a decode of 14 latents) within
    chip_smoke.py's backward bounds of the plain version (RMS_TOL["K6"]): at
    K6_TC_FRAMES on the tensor-core kernels (16-row tiles up to 16 frames, the
    32-row tile from 17; bf16 `.mma_launches`; fp32 on split TF32 products,
    `.tf32x3_launches`, also held to the plain version in float64 within
    FP64_RMS_TOL), at fewer frames on the wide kernel (`.wide_launches`), past
    32 on the long route's tensor-core kernel (`.long_launches`)."""
    dtype = DTYPES[dt]
    b = 1 if s > 2048 else 2
    q, k, v, g = (_randn(cuda, 290 + i, dtype, b * t, s, 1, 512) for i in range(4))
    out = A.temporal_attention_direct(q, k, v, t=t)
    fn = A.temporal_attention_direct_backward
    before = fn.wide_launches, fn.mma_launches, fn.tf32x3_launches, fn.long_launches
    _check(fn, A.temporal_attention_direct_backward_reference, q, k, v, out, g, t=t, rms_tol=RMS_TOL["K6"])
    tc, tiled = t in K6_TC_FRAMES[dt], t <= A.TILED_FRAMES
    bf16 = dtype == torch.bfloat16
    assert (fn.wide_launches, fn.mma_launches, fn.tf32x3_launches, fn.long_launches) == (
        before[0] + (tiled and not tc), before[1] + (tc and bf16), before[2] + (tc and not bf16),
        before[3] + (not tiled))
    if tc and not bf16:   # against float64 on one video's first 512 tokens
        xs = [x[:t, :512].contiguous() for x in (q, k, v, out, g)]
        got = fn(*xs, t=t)
        ref = A.temporal_attention_direct_backward_reference(*(x.double() for x in xs), t=t)
        floor = GRAD_FLOOR * max(r.norm().item() for r in ref)
        for x, r in zip(got, ref):
            assert (x.double() - r).norm().item() / max(r.norm().item(), floor) <= FP64_RMS_TOL


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["k6_bf16", "k6_fp32", "k5_d16", "k13_d16"])
def test_tensor_core_backwards_are_bitwise_repeatable_and_launch_from_a_fresh_thread(cuda, case):
    """The tensor-core K6 at D = 512 (bf16 and fp32) and K5 / K13 at D = 16:
    two runs on the same inputs give the same bits, and a thread that has
    launched nothing before launches them with the same result."""
    import threading

    if case.startswith("k6"):
        dtype = torch.bfloat16 if case == "k6_bf16" else torch.float32
        q, k, v, g = (_randn(cuda, 310 + i, dtype, 14, 300, 1, 512) for i in range(4))
        out = A.temporal_attention_direct(q, k, v, t=14)
        run = lambda: A.temporal_attention_direct_backward(q, k, v, out, g, t=14)
    elif case == "k5_d16":
        q, k, v, g = (_randn(cuda, 320 + i, torch.bfloat16, 2, 600, 32, scale=1.5) for i in range(4))
        out, lse = A._flash_attention_packed_forward(q, k, v, 2, None, save_lse=True)
        run = lambda: A.flash_attention_packed_backward(q, k, v, out, lse, g, 2)
    else:
        q, k, v, g = (_randn(cuda, 330 + i, torch.bfloat16, 2, 2, 300, 16, scale=1.5) for i in range(4))
        out, lse = A._flash_attention_forward(q, k, v, None, save_lse=True)
        run = lambda: A.flash_attention_backward(q, k, v, out, lse, g)
    first, second = run(), run()
    got = []
    worker = threading.Thread(target=lambda: got.append(run()))
    worker.start()
    worker.join()
    torch.cuda.synchronize()
    assert len(got) == 1
    for a, b_, c in zip(first, second, got[0]):
        assert torch.equal(a, b_) and torch.equal(a, c)


@pytest.mark.gpu
def test_svd_tiny_as_shipped_runs_on_the_card(cuda):
    """configs/inference/svd_tiny.yaml as shipped (16-dim heads: K1, K2 and, at
    the tiny CLIP tower, K3 at D = 16) through run_single_video on the card in
    bf16, add_noise and inversion: no plain version runs, every K1 launch on
    the mma.sync template, K3 normalise-first at the "mha_reference" sites
    (the CLIP tower's, the VAE's 64 tokens); finite
    latents, labels in range; the add_noise run's cluster features agree with
    the CPU's on the same weights and draws (relative RMS 0.1, as the aggre test
    holds them)."""
    import numpy as np

    from vidseg_diffusion_tpu_torch.engine.build import build_pipeline
    from vidseg_diffusion_tpu_torch.pipelines.single_video import VidSegArgs, run_single_video

    config = os.path.join(ROOT, "configs/inference/svd_tiny.yaml")
    t, hpx = 3, 64
    frames = np.random.RandomState(0).uniform(-1, 1, (t, hpx, hpx, 3)).astype(np.float32)
    rs = np.random.RandomState(2)
    draws = dict(cond_aug_noise=rs.randn(1, hpx, hpx, 3).astype(np.float32),
                 noise=rs.randn(t, hpx // 8, hpx // 8, 4).astype(np.float32))
    pipes = {dev: build_pipeline(config, num_steps=6, num_frames=t, dtype=torch.bfloat16, device=dev, seed=4)
             for dev in ("cuda", "cpu")}
    for name in ("unet", "clip", "cond_encoder"):
        getattr(pipes["cuda"], name).load_state_dict(getattr(pipes["cpu"], name).state_dict())
    for name in ("encoder", "decoder"):
        getattr(pipes["cuda"].first_stage, name).load_state_dict(getattr(pipes["cpu"].first_stage, name).state_dict())
    plains = [f.calls for f in A.PLAIN_COUNTERS]
    k1 = A.flash_attention_packed.launches, A.flash_attention_packed.mma_launches
    k3_nf = A.flash_attention.normalised_launches
    for inversion in ("add_noise", "inversion"):
        args = VidSegArgs(num_steps=6, num_masks=2, modulate_timestep=(3,), feature_timestep=(5,), decoding_t=3,
                          seed=1, inversion_type=inversion)
        card = run_single_video(pipes["cuda"], frames, [str(i) for i in range(t)], args, write_outputs=False,
                                **draws)
        assert np.isfinite(card.final_latents).all() and card.seg_raw.shape == (t, hpx, hpx)
        assert set(np.unique(card.seg_raw)) <= {0, 1}
        assert card.cache_t0 == (0 if inversion == "inversion" else 3)
        if inversion == "add_noise":
            cpu = run_single_video(pipes["cpu"], frames, [str(i) for i in range(t)], args, write_outputs=False,
                                   **draws)
            diff = np.linalg.norm(card.cluster_features - cpu.cluster_features)
            assert diff <= 0.1 * np.linalg.norm(cpu.cluster_features)
            plains = [f.calls for f in A.PLAIN_COUNTERS]   # the CPU run's plain versions
    assert [f.calls for f in A.PLAIN_COUNTERS] == plains
    launched = A.flash_attention_packed.launches - k1[0]
    assert launched > 0 and A.flash_attention_packed.mma_launches - k1[1] == launched
    assert A.flash_attention.normalised_launches > k3_nf   # the tiny CLIP tower's D = 16 and the VAE's 64 tokens



# K5 in fp32 at D = 64 on split-TF32 mma.sync kernels: ragged lengths off the
# 128-row block and the 32-row tile, Lq != Lk both ways, one to five heads
K5_X3_SHAPES = [(2, 300, 300, 2), (28, 91, 91, 4), (2, 100, 37, 2), (1, 64, 200, 1), (3, 364, 364, 2),
                (1, 130, 300, 3), (2, 600, 90, 5), (4, 4, 4, 5)]


def _k5_fp32_inputs(cuda, seed, b, lq, lk, h):
    q, g = (_randn(cuda, seed + i, torch.float32, b, lq, h * 64, scale=1.5) for i in range(2))
    k, v = (_randn(cuda, seed + 2 + i, torch.float32, b, lk, h * 64, scale=1.5) for i in range(2))
    out, lse = A._flash_attention_packed_forward(q, k, v, h, None, save_lse=True)
    return q, k, v, out, lse, g, h


@pytest.mark.gpu
@pytest.mark.parametrize("b,lq,lk,h", K5_X3_SHAPES)
def test_k5_fp32_d64_split_tf32(cuda, b, lq, lk, h):
    """Every fp32 D = 64 K5 call on the split-TF32 kernels (`.tf32x3_launches`,
    `.dim_launches[64]`; no other route counter moves), within chip_smoke.py's
    backward bounds of the plain version and within FP64_RMS_TOL of it in
    float64 on every gradient; a second call gives the same bits."""
    args = _k5_fp32_inputs(cuda, 600, b, lq, lk, h)
    fn = A.flash_attention_packed_backward
    before = {k: v for k, v in vars(fn).items() if k.endswith("_launches")}
    d64 = fn.dim_launches[64]
    _check(fn, A.flash_attention_packed_backward_reference, *args, rms_tol=RMS_TOL["K5"])
    moved = {k: v - before[k] for k, v in vars(fn).items() if k.endswith("_launches") and v != before[k]}
    assert moved == {"tf32x3_launches": 1} and fn.dim_launches[64] == d64 + 1, moved
    got = fn(*args)
    assert _fp64_rms(got, A.flash_attention_packed_backward_reference, *args) <= FP64_RMS_TOL
    for x, y in zip(got, fn(*args)):
        assert torch.equal(x, y)


@pytest.mark.gpu
def test_k5_fp32_d64_split_tf32_reads_strided_views(cuda):
    """q, k, v as slices of one fused [B, L, 3 x H x 64] projection and g a
    slice of a wider tensor (strides in whole 16-byte rows): read in place on
    the split-TF32 kernels, within FP64_RMS_TOL of float64."""
    b, l, h = 2, 300, 3
    qkv = _randn(cuda, 620, torch.float32, b, l, 3 * h * 64, scale=1.5)
    q, k, v = qkv.split(h * 64, dim=-1)
    g = _randn(cuda, 621, torch.float32, b, l, 2 * h * 64, scale=1.5)[..., h * 64:]
    out, lse = A._flash_attention_packed_forward(q, k, v, h, None, save_lse=True)
    fn = A.flash_attention_packed_backward
    x3 = fn.tf32x3_launches
    got = fn(q, k, v, out, lse, g, h)
    torch.cuda.synchronize()
    assert fn.tf32x3_launches == x3 + 1
    _close_grads(got, A.flash_attention_packed_backward_reference(q, k, v, out, lse, g, h), RMS_TOL["K5"])
    assert _fp64_rms(got, A.flash_attention_packed_backward_reference, q, k, v, out, lse, g, h) <= FP64_RMS_TOL


@pytest.mark.gpu
def test_k5_fp32_off_the_split_route(cuda):
    """fp32 at D = 16 and fp32 D = 64 with a base off a 16-byte boundary run the
    FMA kernels (`.fma_launches`; `.tf32x3_launches` does not move), within
    chip_smoke.py's backward bounds."""
    fn = A.flash_attention_packed_backward
    q, k, v, g = (_randn(cuda, 630 + i, torch.float32, 2, 100, 2 * 16, scale=1.5) for i in range(4))
    out, lse = A._flash_attention_packed_forward(q, k, v, 2, None, save_lse=True)
    x3, fma = fn.tf32x3_launches, fn.fma_launches
    _check(fn, A.flash_attention_packed_backward_reference, q, k, v, out, lse, g, 2, rms_tol=RMS_TOL["K5"])
    assert (fn.tf32x3_launches, fn.fma_launches) == (x3, fma + 1)
    q, k, v, g = (_randn(cuda, 640 + i, torch.float32, 2 * 100 * 128 + 1)[1:].view(2, 100, 128) for i in range(4))
    out, lse = A._flash_attention_packed_forward(q, k, v, 2, None, save_lse=True)
    _check(fn, A.flash_attention_packed_backward_reference, q, k, v, out, lse, g, 2, rms_tol=RMS_TOL["K5"])
    assert (fn.tf32x3_launches, fn.fma_launches) == (x3, fma + 2)


# K11 in fp32 on the split-TF32 persistent wgmma loop: M from one row to the ds1
# projection, N off the 160-wide tile (168, 200, 50), K off the 32-channel slice
# (1032, 72, 20), with and without a bias
MM_X3_SHAPES = [(1, 320, 320), (28, 1024, 320), (193, 1032, 168), (2156, 1024, 640), (300, 72, 200),
                (257, 20, 50), (40768, 640, 640), (163072, 320, 320)]


@pytest.mark.gpu
@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("m,k,n", MM_X3_SHAPES)
def test_matmul_bias_fp32_split_tf32(cuda, with_bias, m, k, n):
    """fp32 inputs that TMA can address run the split-TF32 kernel (only
    `.tf32x3_launches` moves), within the forward bounds of the plain version
    and within FP64_RMS_TOL of it in float64; a second call gives the same
    bits."""
    f32 = torch.float32
    x = _randn(cuda, 650, f32, m, k)
    w = _randn(cuda, 651, f32, n, k, scale=k ** -0.5)
    bias = _randn(cuda, 652, f32, n) if with_bias else None
    fn = MM.matmul_bias
    before = (fn.wgmma_launches, fn.tf32x3_launches, fn.fma_launches)
    y = _check_forward(fn, MM.matmul_bias_plain, RMS_TOL["K11"], x, w, bias)
    assert (fn.wgmma_launches, fn.tf32x3_launches, fn.fma_launches) == (before[0], before[1] + 1, before[2])
    assert _fp64_rms((y,), MM.matmul_bias_plain, x, w, bias) <= FP64_RMS_TOL
    assert torch.equal(y, fn(x, w, bias))


@pytest.mark.gpu
def test_matmul_bias_fp32_unaddressable_takes_the_fma_tile(cuda):
    """fp32 with K % 4 != 0 (rows off a 16-byte stride), or an x whose base is
    off a 16-byte boundary, runs the FMA tile (`.fma_launches`; no
    `.tf32x3_launches`), within the forward bounds."""
    f32 = torch.float32
    fn = MM.matmul_bias
    cases = [(_randn(cuda, 660, f32, 50, 65), _randn(cuda, 661, f32, 40, 65, scale=65 ** -0.5)),
             (_randn(cuda, 662, f32, 40 * 64 + 1)[1:].view(40, 64), _randn(cuda, 663, f32, 48, 64, scale=0.125))]
    for x, w in cases:
        x3, fma = fn.tf32x3_launches, fn.fma_launches
        _check_forward(fn, MM.matmul_bias_plain, RMS_TOL["K11"], x, w, None)
        assert (fn.tf32x3_launches, fn.fma_launches) == (x3, fma + 1)


@pytest.mark.gpu
def test_matmul_bias_fp32_keeps_no_weight_copy(cuda):
    """The split-TF32 route forms W's lo parts in a scratch for the call: after
    it, device memory has grown by y alone (no copy of W is kept per weight)."""
    f32 = torch.float32
    x = _randn(cuda, 670, f32, 256, 640)
    w = _randn(cuda, 671, f32, 320, 640, scale=640 ** -0.5)
    torch.cuda.synchronize()
    before, x3 = torch.cuda.memory_allocated(), MM.matmul_bias.tf32x3_launches
    y = MM.matmul_bias(x, w)
    torch.cuda.synchronize()
    assert MM.matmul_bias.tf32x3_launches == x3 + 1
    assert torch.cuda.memory_allocated() - before == y.untyped_storage().nbytes()


# K1 / K3 in fp32 at D = 64 on the split-TF32 mma.sync kernel: Lq and Lk of 1, 4,
# 77, 91, 257 and 5824 (off the 128-row block and the 32-key tile), Lq != Lk both
# ways, 2 to 20 heads; the plain version in float64 holds the main path's 5824
# tokens on a B = 2 slice
K1_X3_SHAPES = [(2, 1, 1, 5), (4, 4, 4, 20), (2, 77, 91, 5), (3, 91, 77, 2), (1, 257, 257, 16), (2, 5824, 5824, 5),
                (4, 5824, 77, 5), (1, 300, 1, 3)]


def _x3_moved(fn, before):
    return {k: v - before[k] for k, v in vars(fn).items() if k.endswith("_launches") and v != before[k]}


@pytest.mark.gpu
@pytest.mark.parametrize("b,lq,lk,h", K1_X3_SHAPES)
def test_k1_fp32_d64_split_tf32(cuda, b, lq, lk, h):
    """Every fp32 D = 64 K1 call that TMA can address on the split-TF32 kernel
    (`.tf32x3_launches`, `.dim_launches[64]`; no other route counter moves):
    the output within the forward bounds and FP64_RMS_TOL of the plain version
    in float64, the base-2 LSE within LSE_TOL of the plain LSE; a second call
    gives the same bits."""
    f32 = torch.float32
    q = _randn(cuda, 700, f32, b, lq, h * 64, scale=1.5)
    k, v = (_randn(cuda, 701 + i, f32, b, lk, h * 64, scale=1.5) for i in range(2))
    fn = A.flash_attention_packed
    before, d64 = {k_: v_ for k_, v_ in vars(fn).items() if k_.endswith("_launches")}, fn.dim_launches[64]
    out, lse = A._flash_attention_packed_forward(q, k, v, h, None, save_lse=True)
    torch.cuda.synchronize()
    assert _x3_moved(fn, before) == {"tf32x3_launches": 1} and fn.dim_launches[64] == d64 + 1
    ref, ref_lse = A.flash_attention_packed_reference(q, k, v, h, save_lse=True)
    _close_grads((out,), (ref,), RMS_TOL["K1"])
    assert (lse - ref_lse).abs().max().item() <= LSE_TOL
    assert _fp64_rms((out,), A.flash_attention_packed_reference, q, k, v, h) <= FP64_RMS_TOL
    again, lse2 = A._flash_attention_packed_forward(q, k, v, h, None, save_lse=True)
    assert torch.equal(out, again) and torch.equal(lse, lse2)


@pytest.mark.gpu
def test_k1_k3_fp32_d64_split_tf32_read_strided_views(cuda):
    """q, k, v as slices of one fused [B, L, 3 x H x 64] projection (K1) and as
    the [B, L, H, 64] projections seen as bhld (K3, ViT-L/14's heads), read in
    place on the split-TF32 kernel, within FP64_RMS_TOL of float64."""
    f32 = torch.float32
    b, l, h = 2, 300, 3
    qkv = _randn(cuda, 710, f32, b, l, 3 * h * 64, scale=1.5)
    q, k, v = qkv.split(h * 64, dim=-1)
    x3 = A.flash_attention_packed.tf32x3_launches
    out = A.flash_attention_packed(q, k, v, h)
    torch.cuda.synchronize()
    assert A.flash_attention_packed.tf32x3_launches == x3 + 1
    assert _fp64_rms((out,), A.flash_attention_packed_reference, q, k, v, h) <= FP64_RMS_TOL
    q, k, v = (_randn(cuda, 711 + i, f32, 2, 257, 16, 64, scale=1.5).transpose(1, 2) for i in range(3))
    before = {k_: v_ for k_, v_ in vars(A.flash_attention).items() if k_.endswith("_launches")}
    out = A.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert _x3_moved(A.flash_attention, before) == {"tf32x3_launches": 1}
    _close_grads((out,), (A.flash_attention_reference(q, k, v),), RMS_TOL["K3"])
    assert _fp64_rms((out,), A.flash_attention_reference, q, k, v) <= FP64_RMS_TOL
    assert torch.equal(out, A.flash_attention(q, k, v))


@pytest.mark.gpu
def test_k1_k3_fp32_off_the_split_route(cuda):
    """fp32 that the split-TF32 kernel does not take runs the FMA kernel
    (`.fma_launches`; `.tf32x3_launches` does not move), within the forward
    bounds: K1 at D = 64 with bases 4 bytes off a 16-byte boundary and at D =
    16, K3 at D = 80 (CLIP's heads) and D = 16."""
    f32 = torch.float32
    fn = A.flash_attention_packed
    unaligned = [_randn(cuda, 720 + i, f32, 2 * 100 * 128 + 1)[1:].view(2, 100, 128) for i in range(3)]
    d16 = [_randn(cuda, 723 + i, f32, 2, 100, 32, scale=1.5) for i in range(3)]
    for q, k, v in (unaligned, d16):
        x3, fma = fn.tf32x3_launches, fn.fma_launches
        _check_forward(fn, A.flash_attention_packed_reference, RMS_TOL["K1"], q, k, v, 2)
        assert (fn.tf32x3_launches, fn.fma_launches) == (x3, fma + 1)
    for d in (80, 16):
        q, k, v = (_randn(cuda, 730 + i, f32, 1, 4, 257, d, scale=1.5) for i in range(3))
        x3, fma = A.flash_attention.tf32x3_launches, A.flash_attention.fma_launches
        _check_forward(A.flash_attention, A.flash_attention_reference, RMS_TOL["K3"], q, k, v)
        assert (A.flash_attention.tf32x3_launches, A.flash_attention.fma_launches) == (x3, fma + 1)


@pytest.mark.gpu
@pytest.mark.parametrize("b,l,h", [(2, 777, 5), (4, 64, 10)])
def test_k1_lse_feeds_the_k5_split_backward(cuda, b, l, h):
    """Autograd through K1 and K5 in fp32 at D = 64, both on the split-TF32
    kernels (K5 recomputes p from K1's LSE): dq, dk, dv within GRAD_REL_TOL (by
    norm) of autograd through the plain forward in float64."""
    f32 = torch.float32
    q, k, v = (_randn(cuda, 740 + i, f32, b, l, h * 64, scale=1.5).requires_grad_() for i in range(3))
    g = _randn(cuda, 743, f32, b, l, h * 64)
    x3 = A.flash_attention_packed.tf32x3_launches, A.flash_attention_packed_backward.tf32x3_launches
    got = torch.autograd.grad(A.flash_attention_packed(q, k, v, h), (q, k, v), g)
    assert (A.flash_attention_packed.tf32x3_launches,
            A.flash_attention_packed_backward.tf32x3_launches) == (x3[0] + 1, x3[1] + 1)
    leaves = [x.detach().double().requires_grad_() for x in (q, k, v)]
    want = torch.autograd.grad(A.flash_attention_packed_reference(*leaves, h), leaves, g.double())
    for a, w in zip(got, want):
        assert (a.double() - w).norm().item() <= GRAD_REL_TOL * w.norm().item()


# K4 in fp32 on the split-TF32 persistent loop: the UNet's widths (320, 640, 1280),
# the VAE's 128, T = 1, 2, 7, 14, M off the tiles, kt = 1, 3, 5, Cin != Cout, Cin =
# 1032 (a last 32-channel slice of 8)
K4_X3_SHAPES = [(2, 14, 5824, 320, 320, 3), (2, 14, 1456, 640, 640, 3), (2, 14, 364, 1280, 1280, 3),
                (1, 7, 4096, 128, 128, 3), (2, 1, 300, 320, 320, 3), (2, 2, 77, 1032, 168, 1),
                (1, 5, 91, 64, 96, 5), (3, 2, 1, 128, 256, 3)]


@pytest.mark.gpu
@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("b,t,m,cin,cout,kt", K4_X3_SHAPES)
def test_temporal_conv_fp32_split_tf32(cuda, with_bias, b, t, m, cin, cout, kt):
    """fp32 K4 with Cin % 4 == 0 on aligned bases runs the split-TF32 kernel
    (only `.tf32x3_launches` moves), within the forward bounds and within
    FP64_RMS_TOL of the plain version in float64; a second call gives the same
    bits."""
    f32 = torch.float32
    x = _randn(cuda, 750, f32, b, t, m, cin)
    w = _randn(cuda, 751, f32, kt, cin, cout, scale=(kt * cin) ** -0.5)
    bias = _randn(cuda, 752, f32, cout) if with_bias else torch.zeros(cout, device=cuda)
    fn = TC.temporal_conv_1x1
    before = {k: v for k, v in vars(fn).items() if k.endswith("_launches")}
    y = _check_forward(fn, TC.temporal_conv_1x1_reference, RMS_TOL["K4"], x, w, bias)
    assert _x3_moved(fn, before) == {"tf32x3_launches": 1}
    assert _fp64_rms((y,), TC.temporal_conv_1x1_reference, x, w, bias) <= FP64_RMS_TOL
    assert torch.equal(y, fn(x, w, bias))


@pytest.mark.gpu
@pytest.mark.parametrize("m,c,kt", [(364, 1280, 3), (1456, 640, 2), (91, 320, 3)])
def test_temporal_conv_fp32_dx_split_tf32(cuda, m, c, kt):
    """K4's dx in fp32 (the output gradient through the flipped taps; even kt a
    zero tap in front) on the split-TF32 kernel, within FP64_RMS_TOL of the
    plain backward in float64 on every gradient (dW and db are library
    products)."""
    f32 = torch.float32
    x, g = _randn(cuda, 760, f32, 2, 14, m, c), _randn(cuda, 761, f32, 2, 14, m, c)
    w = _randn(cuda, 762, f32, kt, c, c, scale=(kt * c) ** -0.5)
    x3 = TC.temporal_conv_1x1.tf32x3_launches
    got = TC.temporal_conv_1x1_backward(x, w, g)
    torch.cuda.synchronize()
    assert TC.temporal_conv_1x1.tf32x3_launches == x3 + 1
    _close_grads(got, TC.temporal_conv_1x1_backward_reference(x, w, g), RMS_TOL["K4"])
    assert _fp64_rms(got, TC.temporal_conv_1x1_backward_reference, x, w, g) <= FP64_RMS_TOL
    assert torch.equal(got[0], TC.temporal_conv_1x1_backward(x, w, g)[0])


@pytest.mark.gpu
def test_temporal_conv_fp32_off_the_split_route(cuda):
    """fp32 that TMA cannot address (C = 3, as the VAE's conv_out_time_mix; an
    x 4 bytes off a 16-byte boundary) runs the FMA tile (`.fma_launches`; no
    `.tf32x3_launches`), within the forward bounds."""
    f32 = torch.float32
    fn = TC.temporal_conv_1x1
    cases = [_randn(cuda, 770, f32, 1, 7, 5000, 3), _randn(cuda, 771, f32, 2 * 3 * 40 * 64 + 1)[1:].view(2, 3, 40, 64)]
    for x in cases:
        c = x.shape[-1]
        w = _randn(cuda, 772, f32, 3, c, c, scale=(3 * c) ** -0.5)
        x3, fma = fn.tf32x3_launches, fn.fma_launches
        _check_forward(fn, TC.temporal_conv_1x1_reference, RMS_TOL["K4"], x, w, _randn(cuda, 773, f32, c))
        assert (fn.tf32x3_launches, fn.fma_launches) == (x3, fma + 1)


@pytest.mark.gpu
def test_temporal_conv_fp32_keeps_no_lo_copy(cuda):
    """The split-TF32 route forms W's lo parts in a scratch for the call: once
    the K-major weight is cached, a call grows device memory by y alone."""
    f32 = torch.float32
    x = _randn(cuda, 780, f32, 2, 3, 100, 320)
    w = _randn(cuda, 781, f32, 3, 320, 320, scale=(3 * 320) ** -0.5)
    bias = _randn(cuda, 782, f32, 320)
    TC.temporal_conv_1x1(x, w, bias)   # caches the K-major copy
    torch.cuda.synchronize()
    before, x3 = torch.cuda.memory_allocated(), TC.temporal_conv_1x1.tf32x3_launches
    y = TC.temporal_conv_1x1(x, w, bias)
    torch.cuda.synchronize()
    assert TC.temporal_conv_1x1.tf32x3_launches == x3 + 1
    assert torch.cuda.memory_allocated() - before == y.untyped_storage().nbytes()
