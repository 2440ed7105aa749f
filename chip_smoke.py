#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA H100 (needs CUDA; no JAX).

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:
1. card: print `nvidia-smi --query-gpu=name,power.limit`.
2. build: compile the kernels from vidseg_diffusion_tpu_torch/csrc with nvcc
   (one process per source, in parallel).
3. kernels: each kernel (K1-K13 and the one-launch GroupNorm forward)
   against its plain PyTorch version on the same inputs at the shapes of its
   path (K1-K4, K7, K8, the fused K7+K8, K11, K12 inference; K5, K6, K9, K10
   and K4's dx launch training; bf16, the GroupNorm kernels, K4, K11 and K12
   also fp32; K1 also at the SD cross-attention's 77 keys; K4 also at one and
   two frames, one token a frame, one tap and Cin != Cout);
   errors within the stated bounds; kernel and plain times with CUDA events
   beside the kernel's bound (bytes over the card's memory rate or
   operations over its peak rate, whichever is larger) and the time of the
   one PyTorch call that computes the same function (a yardstick only: no
   path runs it); K1's saved LSE against the plain LSE (also at the 77-key
   cross-attention); K7's and the fused kernel's statistics against fp64
   statistics of the same input; K11 also at N = 168 and K = 1032; K1's headline shape timed at the
   CFG batch of 28 beside SDPA.
4. unet: one full-width SVD UNet forward in fp32 (random weights, a 16x16
   latent, 2 frames) on the card through the kernels vs the same weights on
   the CPU through the plain versions; then the same for the full-width SD
   2.1 image UNet with a 77-token context.
5. train_grad: the same UNet in fp32 with remat, loss.backward() of the
   diffusion loss (explicit sigma and noise) on the card through the
   kernels and their backward kernels vs the CPU through the plain
   versions; every parameter's gradient within a relative bound by norm.
6. main: the run of vidseg_diffusion_tpu_torch/scripts/main_path.py
   (configs/inference/svd.yaml at full width with random bf16 weights,
   run_single_video on 14 synthetic 448x832 frames, 25 steps, modulate step
   17, 2 masks, decoding_t 7) under torch.no_grad; the inference kernels
   must launch exactly as many times as the configuration implies (K1 832,
   K2 832, K3 43, K4 2520; one GroupNorm forward per GroupNorm module per
   UNet, VAE encoder and VAE decoder call, by the route ops.norm.group_norm_route
   gives its input: the fused kernel, or K7 and K8; K11 four times per
   CrossAttention module and K12 twice per ResBlock per UNet call: 13 312 and
   2 288), the backward kernels and the plain versions never, and every K1,
   K4 and K11 launch must have run its wgmma kernel but the 8 K4 launches of
   the VAE's 3-channel conv_out_time_mix, which run the narrow kernel (the
   wrappers' route counters, here and in the inject, sd, train and ae_train
   phases); latents and labels must be finite and shaped; the +lambda and
   -lambda runs must differ, and the outside-mask latents must equal the
   cached trajectory exactly.
7. inject: the same run with is_injected_features (the feature pass caches
   the temporal q/k of the nine attention-bearing output blocks on the device,
   about 1.1 GB per cached step; every modulated run injects them from step
   17 on): the same checks and launch counts, 9 blocks x 8 gated steps x 4
   runs injected sites, final latents that differ from the un-injected run's;
   stage seconds and peak device memory.
8. sd: the run of vidseg_diffusion_tpu_torch/scripts/sd_path.py
   (configs/inference/sd_2_1.yaml at full width with random bf16 weights, the
   same frames, the empty prompt, 25 steps, modulate block 7 at step 22, 4
   masks, the SD blend window, decoding_t 7) under torch.no_grad: K1 at every
   self- and cross-attention site (77 context tokens), K3 in the VAE's mid
   attention, K7, K8, K11 and K12 exactly as often as the configuration
   implies, K2 and K4 never, no backward kernel and no plain version; finite
   latents and labels of the right shape, +lambda != -lambda, outside-mask
   latents equal to the cached trajectory right after the last blended step
   (read where they enter the next sampler step);
   stage seconds and peak device memory.
9. ae_grad: the full-width sd_2_1.yaml first stage (Encoder, quant convs,
   image Decoder) in fp32 on 2 frames of 64x64 (an 8x8 latent, a 64-token
   D = 512 mid attention) with LPIPS and the PatchGAN discriminator:
   backward passes of the reconstruction loss (L1 + LPIPS + KL) and of the
   discriminator loss with the adversarial term, on the card through the
   kernels (K3 with its LSE, K13, K7-K10) vs the CPU through the plain
   versions; every parameter's gradient within GRAD_REL_TOL by norm.
10. ae_train: the full-width autoencoder training step of
   vidseg_diffusion_tpu_torch/scripts/autoencoder_train_path.py (sd_2_1.yaml
   first stage, bf16, LPIPS, discriminator, 2 frames of 448x832, Adam for both
   phases, the adversarial term on from step 0): a warm-up step, then
   TRAIN_STEPS steps; every logged loss finite and p_loss > 0, every gradient
   finite, the mid attentions' q/k/v gradients non-zero, the last Adam step of
   both phases taken by every parameter with a gradient (check_adam_step),
   K3 = K13 = 2 and K7 = K8 = K9 = K10 = the first stage's GroupNorm modules
   per step, every other kernel 0 and no plain version called; step time and
   peak memory.
11. train: the full-width training step of
   vidseg_diffusion_tpu_torch/scripts/train_path.py (svd.yaml UNet, bf16,
   remat, 2 x 14 frames of 56x104 latents, Adam, EMA): a warm-up step, then
   TRAIN_STEPS steps; the loss finite at every step, every gradient finite,
   the self-attention q/k/v projections' gradients non-zero (spatial and
   temporal), the last step taken by every parameter with a gradient and
   by the EMA (check_last_update), K1, K2, K4, K5, K6, K7-K10, K11 and K12
   launched exactly as often as a remat step of these modules implies
   (train_launches) and no plain version called; step time and peak memory.

Before the last line come the kernels JSON (per kernel: launches in the run
of its path and in the other runs (injected, SD, diffusion training,
autoencoder training), for K1, K4 and K11 the launches of each run by the
kernel that ran (`routes`), worst error, kernel, plain, bound and
library-call ms at its headline shape) and the card's name and power limit; the last line
is {"ok": true, "device": ...}.
"""

import gc
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

KERNELS = {
    "flash_attention_packed": dict(
        id="K1", source="vidseg_diffusion_tpu_torch/csrc/flash_attention.cu",
        replaces="vidseg_diffusion_tpu/ops/attention.py:527", rms_tol=4e-3,
    ),
    "temporal_attention_direct": dict(
        id="K2", source="vidseg_diffusion_tpu_torch/csrc/temporal_attention.cu",
        replaces="vidseg_diffusion_tpu/ops/attention.py:1458", rms_tol=1e-3,
    ),
    "flash_attention": dict(
        id="K3", source="vidseg_diffusion_tpu_torch/csrc/flash_attention.cu",
        replaces="vidseg_diffusion_tpu/ops/attention.py:297", rms_tol=4e-3,
    ),
    "temporal_conv_1x1": dict(
        id="K4", source="vidseg_diffusion_tpu_torch/csrc/temporal_conv.cu",
        replaces="vidseg_diffusion_tpu/ops/temporal_conv.py:103", rms_tol=5e-4,
    ),
    "flash_attention_packed_backward": dict(
        id="K5", source="vidseg_diffusion_tpu_torch/csrc/flash_attention_bwd.cu",
        replaces="vidseg_diffusion_tpu/ops/attention.py:993", rms_tol=1e-3,
    ),
    "temporal_attention_direct_backward": dict(
        id="K6", source="vidseg_diffusion_tpu_torch/csrc/temporal_attention_bwd.cu",
        replaces="vidseg_diffusion_tpu/ops/attention.py:1167", rms_tol=2e-4,
    ),
    "group_norm_stats": dict(
        id="K7", source="vidseg_diffusion_tpu_torch/csrc/group_norm.cu",
        replaces="vidseg_diffusion_tpu/ops/norm.py:91", rms_tol=5e-4,
    ),
    "group_norm_apply": dict(
        id="K8", source="vidseg_diffusion_tpu_torch/csrc/group_norm.cu",
        replaces="vidseg_diffusion_tpu/ops/norm.py:183", rms_tol=5e-4,
    ),
    # K7 + K8 in one launch where a slab of whole groups fits in shared memory:
    # JAX's group_norm_silu runs both pallas_calls (_stats_pallas at :91, the apply at :183)
    "group_norm_fused": dict(
        id="K7+K8", source="vidseg_diffusion_tpu_torch/csrc/group_norm.cu",
        replaces="vidseg_diffusion_tpu/ops/norm.py:183", rms_tol=5e-4,
    ),
    "group_norm_backward_stats": dict(
        id="K9", source="vidseg_diffusion_tpu_torch/csrc/group_norm_bwd.cu",
        replaces="vidseg_diffusion_tpu/ops/norm.py:258", rms_tol=5e-4,
    ),
    "group_norm_backward_apply": dict(
        id="K10", source="vidseg_diffusion_tpu_torch/csrc/group_norm_bwd.cu",
        replaces="vidseg_diffusion_tpu/ops/norm.py:294", rms_tol=5e-4,
    ),
    "matmul_bias": dict(
        id="K11", source="vidseg_diffusion_tpu_torch/csrc/matmul_bias.cu",
        replaces="vidseg_diffusion_tpu/ops/matmul.py:94", rms_tol=5e-4,
    ),
    "conv3x3_same": dict(
        id="K12", source="vidseg_diffusion_tpu_torch/csrc/conv3x3.cu",
        replaces="vidseg_diffusion_tpu/ops/conv3x3.py:116", rms_tol=5e-4,
    ),
    # K3's gradient: JAX's _fa_bwd runs _flash_attention_packed_bwd_impl with
    # heads=1, whose pl.pallas_calls are at :993 (dq) and :1025 (dk/dv)
    "flash_attention_backward": dict(
        id="K13", source="vidseg_diffusion_tpu_torch/csrc/flash_attention_bhld_bwd.cu",
        replaces="vidseg_diffusion_tpu/ops/attention.py:1025", rms_tol=1e-3,
    ),
}
INFERENCE_KERNELS = ("flash_attention_packed", "temporal_attention_direct", "flash_attention",
                     "temporal_conv_1x1", "group_norm_stats", "group_norm_apply", "group_norm_fused",
                     "matmul_bias", "conv3x3_same")
TRAIN_KERNELS = ("flash_attention_packed", "temporal_attention_direct", "temporal_conv_1x1",
                 "flash_attention_packed_backward", "temporal_attention_direct_backward",
                 "group_norm_stats", "group_norm_apply", "group_norm_fused", "group_norm_backward_stats",
                 "group_norm_backward_apply", "matmul_bias", "conv3x3_same")
AE_KERNELS = ("flash_attention_backward",)   # the kernels whose path is autoencoder training
# launches of the inference main path, implied by its configuration: 52 UNet
# calls x 16 spatial / 16 temporal self-attention sites and 44 temporal
# convs (+ 29 per decoder chunk x 8), 32 CLIP layers + 11 VAE attentions; the
# UNet's 64 CrossAttention modules x 4 projections and 22 ResBlocks x 2 convs
MAIN_LAUNCHES = {"flash_attention_packed": 832, "temporal_attention_direct": 832,
                 "flash_attention": 43, "temporal_conv_1x1": 2520,
                 "matmul_bias": 52 * 256, "conv3x3_same": 52 * 44}
# calls of the main path per model: 8 feature-pass + 4 runs x 11 UNet steps; the
# first-stage encoder on 2 chunks of 7 frames + the conditioning-frame
# encoder; the decoder on 2 chunks per run. K7 and K8 launch once per
# GroupNorm module per call, K11 four times per CrossAttention module and K12
# twice per ResBlock per UNet call (module_launches).
MAIN_CALLS = {"unet": 52, "encoder": 3, "decoder": 8}
# the SD path (scripts/sd_path.py): 3 feature-pass + 8 runs x 6 UNet steps; the
# encoder on 2 chunks of 7 frames; the decoder on 2 chunks per run. Its 32
# CrossAttention modules (self and 77-key cross) each launch K1 once per call;
# K3 is the VAE's mid attention, once per encoder / decoder chunk.
SD_CALLS = {"unet": 51, "encoder": 2, "decoder": 16}
INJECT_BLOCKS, INJECT_STEPS = 9, 8   # attention-bearing output blocks; steps 17..24
# Published peaks of one H100 SXM (NVIDIA's data sheet), for the bounds:
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "fp32": 67e12}   # dense tensor-core bf16; fp32 outside the tensor cores
# Kernel output vs plain version, both from the same bf16 inputs: the plain
# version computes in fp32 and rounds once to bf16; the kernel accumulates in
# fp32 in another order, so elements may land one bf16 step apart. Bounds:
# - max |kernel - plain| <= MAX_STEPS bf16 steps at max |plain| (a step there
#   is 2**(floor(log2 max|plain|) - 7)); the sound readings are 0-1 step;
# - ||kernel - plain||_2 <= rms_tol * ||plain||_2, per kernel above, from its
#   sound readings at these shapes (PERF.md): K1 and K3 read 1.3e-3 to 2.4e-3
#   (online softmax rounds p to bf16 against a running max), K4 1e-5 to
#   1.4e-4 (its dx launch included), K2 0 (bit for bit), K5 4.8e-5 to 2.2e-4,
#   K6 2.2e-5 to 3.9e-5, K13 2.4e-5 to 3.6e-4 (worst of dq/dk/dv; K5's
#   bound, the same math); K11 and K12 start from K4's
#   bound (fp32 accumulation of bf16 products, one rounding: K12 reads 9e-5
#   to 2.6e-4 at K = 9 * 320 to 9 * 2560). A fault that moves every output
#   by 1% reads 1e-2.
# fp32 outputs (the GroupNorm kernels on fp32 activations, and their fp32
# statistics and coefficients whatever the activation dtype): max |kernel -
# plain| <= FP32_TOL * max |plain| and the same bound on the relative RMS
# error; only the summation order differs. K7's mean (relative to the rms of
# x) and inv-std (relative) vs fp64 statistics of the same input: STATS_TOL.
MAX_STEPS = 2
FP32_TOL = 1e-4
STATS_TOL = 2e-5
UNET_REL_TOL = 1e-4     # fp32 UNet, card (kernels) vs CPU (plain versions), x max |CPU|
LSE_TOL = 5e-3          # K1's and K3's base-2 LSE vs the plain LSE, absolute (log2 units; reads <= 2.2e-3,
                        # the largest at the 77-key cross-attention)
# fp32 UNet gradients, card vs CPU, for every parameter:
# ||g_card - g_cpu|| <= GRAD_REL_TOL * max(||g_cpu||, GRAD_FLOOR * the largest
# parameter gradient norm) (the forward agrees to ~5e-6 of its scale and the
# worst gradient reads 2.6e-6; the floor covers gradients that are 0 up to
# rounding, as the CPU tests found for biases that feed a GroupNorm group)
GRAD_REL_TOL = 1e-4
GRAD_FLOOR = 1e-3
# the PatchGAN discriminator's parameter gradients, card vs CPU (ae_grad): it runs
# library ops only, whose fp32 card numerics read 1.1e-3 on the reconstruction
DISC_GRAD_TOL = 5e-3
TRAIN_STEPS = 3
HEADLINE = {  # the shape of its path each kernel is timed at
    "flash_attention_packed": "ds1 B=2 slice [2,5824,5x64]",
    "temporal_attention_direct": "ds1 [28,5824,5,64] t=14",
    "flash_attention": "VAE mid [7,1,5824,512]",
    "temporal_conv_1x1": "UNet ds1 [2,14,5824,320]",
    "flash_attention_packed_backward": "ds1 B=2 slice [2,5824,5x64]",
    "temporal_attention_direct_backward": "ds1 [28,5824,5,64] t=14",
    "group_norm_stats": "UNet ds1 [28,56,104,320]",
    "group_norm_apply": "UNet ds1 [28,56,104,320]",
    "group_norm_fused": "UNet mid [28,7,13,1280]",
    "group_norm_backward_stats": "UNet ds1 [28,56,104,320]",
    "group_norm_backward_apply": "UNet ds1 [28,56,104,320]",
    "matmul_bias": "ds1 to_q [163072,320->320]",
    "conv3x3_same": "ds1 [28,56,104,320->320]",
    "flash_attention_backward": "VAE mid [2,1,5824,512]",
}
# launches of one training step (remat on: every ResBlock and transformer runs
# its forward twice, in the step's forward and in the backward's recompute):
# 16 spatial and 16 temporal self-attention sites x 2 forwards and 1 backward;
# 44 temporal convs x (2 forwards + the dx launch of the backward). K7-K10,
# K11 and K12 are reckoned from the modules (train_launches).
TRAIN_LAUNCHES = {"flash_attention_packed": 32, "temporal_attention_direct": 32,
                  "flash_attention_packed_backward": 16, "temporal_attention_direct_backward": 16,
                  "temporal_conv_1x1": 132}


def fail(msg):
    raise RuntimeError(f"chip_smoke: {msg}")


def check(cond, msg):
    if not cond:
        fail(msg)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    check(out, "nvidia-smi printed nothing")
    return out[0]


def time_ms(fn, iters, warmup=1):
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def attn_work(b, h, lq, lk, d, backward=False, dtype="bf16"):
    """(bytes, flops, peak) of one attention call: q, k, v read and o
    written once (backward: also o, g and the LSE read, dq, dk, dv written);
    2 matrix products forward (4 * lq * lk * d flops per head), 5 backward
    (S, dP, dV, dQ, dK)."""
    q, kv, item = b * h * lq * d, b * h * lk * d, 2 if dtype == "bf16" else 4
    if backward:
        return item * (4 * q + 4 * kv) + 4 * b * h * lq, 10 * b * h * lq * lk * d, dtype
    return item * (2 * q + 2 * kv), 4 * b * h * lq * lk * d, dtype


def tconv_work(b, t, m, cin, cout, kt=3, dtype="bf16"):
    """x, W, bias read and y written once; one [m, cin] x [cin, cout] product
    per (frame, tap) pair whose source frame exists."""
    pairs = sum(1 for f in range(t) for j in range(kt) if 0 <= f + j - kt // 2 < t)
    item = 2 if dtype == "bf16" else 4
    return item * (b * t * m * (cin + cout) + kt * cin * cout + cout), 2 * b * pairs * m * cin * cout, dtype


def matmul_work(m, k, n, bias, dtype="bf16"):
    """x [m, k], W [n, k] (and the bias) read and y [m, n] written once; one
    m x k x n product."""
    item = 2 if dtype == "bf16" else 4
    return item * (m * k + n * k + m * n + (n if bias else 0)), 2 * m * k * n, dtype


def conv3x3_work(b, h, w, cin, cout, dtype="bf16"):
    """x, the nine [cin, cout] taps, the bias read and y written once; per tap
    one [cin] x [cin, cout] product for every output pixel whose source pixel
    lies inside the image."""
    item = 2 if dtype == "bf16" else 4
    pairs = sum((h - abs(dy)) * (w - abs(dx)) for dy in (-1, 0, 1) for dx in (-1, 0, 1))
    return (item * (b * h * w * (cin + cout) + 9 * cin * cout + cout), 2 * b * pairs * cin * cout, dtype)


def kernel_cases(torch):
    """Cases at the main-path shapes (swan: 14 frames at 448x832, CFG batch
    28): dicts of kernel, label, make (inputs builder), kern, plain, iters,
    work (bytes, flops, peak) and library (inputs -> the one PyTorch call that
    computes the same function, or None)."""
    import torch.nn.functional as F

    from vidseg_diffusion_tpu_torch.ops import attention as A
    from vidseg_diffusion_tpu_torch.ops import temporal_conv as TC

    dev, bf = "cuda", torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(0)
    rn = lambda *s: torch.randn(*s, generator=g, device=dev, dtype=torch.float32)

    def packed(b, l, h, lk=None):
        return lambda: (rn(b, l, h * 64).to(bf),) + tuple(rn(b, lk or l, h * 64).to(bf)
                                                          for _ in range(2)) + (h,)

    def direct(b, s, h):
        return lambda: tuple(rn(b, s, h, 64).to(bf) for _ in range(3))

    def bhld(b, h, l, d):
        return lambda: tuple(rn(b, h, l, d).to(bf) for _ in range(3))

    def tconv(b, t, m, cin, cout, kt=3, dtype=bf):
        return lambda: (rn(b, t, m, cin).to(dtype), (rn(kt, cin, cout) / (kt * cin) ** 0.5).to(dtype),
                        rn(cout).to(dtype))

    def packed_bwd(b, l, h):
        """(q, k, v, out, lse, g, heads) with out and lse from K1's save_lse
        forward; K1's LSE is checked against the plain LSE here."""
        def make():
            q, k, v, g = (rn(b, l, h * 64).to(bf) for _ in range(4))
            out, lse = A._flash_attention_packed_forward(q, k, v, h, None, save_lse=True)
            _, lse_ref = A.flash_attention_packed_reference(q, k, v, h, save_lse=True)
            err = (lse - lse_ref).abs().max().item()
            print(f"[kernels] K1 save_lse [{b},{l},{h}x64]: max |lse - plain| = {err:.3e} "
                  f"(tol {LSE_TOL:.0e})", flush=True)
            check(err <= LSE_TOL, f"K1 LSE disagrees with the plain LSE: {err}")
            return q, k, v, out, lse, g, h
        return make

    def bhld_bwd(b, h, lq, lk, d, dtype=bf):
        """(q, k, v, out, lse, g) with out and lse from K3's forward under a
        gradient; K3's LSE is checked against the plain LSE here."""
        def make():
            q, g = (rn(b, h, lq, d).to(dtype) for _ in range(2))
            k, v = (rn(b, h, lk, d).to(dtype) for _ in range(2))
            out, lse = A._flash_attention_forward(q, k, v, None, save_lse=True)
            _, lse_ref = A.flash_attention_reference(q, k, v, save_lse=True)
            err = (lse - lse_ref).abs().max().item()
            print(f"[kernels] K3 LSE [{b},{h},{lq}x{lk},{d}] {dtype}: max |lse - plain| = {err:.3e} "
                  f"(tol {LSE_TOL:.0e})", flush=True)
            check(err <= LSE_TOL, f"K3 LSE disagrees with the plain LSE: {err}")
            return q, k, v, out, lse, g
        return make

    def temporal_bwd(b, s, h):
        def make():
            q, k, v, g = (rn(b, s, h, 64).to(bf) for _ in range(4))
            return q, k, v, A.temporal_attention_direct(q, k, v, t=14), g
        return make

    def tconv_bwd(b, t, m, c):
        return lambda: (rn(b, t, m, c).to(bf), (rn(3, c, c) / (3 * c) ** 0.5).to(bf),
                        rn(b, t, m, c).to(bf))

    # the library yardsticks: F.scaled_dot_product_attention on views of the
    # same tensors (packed [B, L, H*64] as [B, H, L, 64]; the direct temporal
    # layout [(b t), s, H, 64] as [b, s, H, t, 64]), its backward through
    # autograd.grad, F.conv3d with a (3, 1, 1) kernel on the [B, C, T, M, 1] view
    sdpa = F.scaled_dot_product_attention
    heads_view = lambda x, h: x.view(x.shape[0], x.shape[1], h, 64).transpose(1, 2)
    frames_view = lambda x: x.view(x.shape[0] // 14, 14, *x.shape[1:]).permute(0, 2, 3, 1, 4)

    def sdpa_backward(qkv, g):
        leaves = [x.detach().requires_grad_() for x in qkv]
        out = sdpa(*leaves)
        return lambda: torch.autograd.grad(out, leaves, g, retain_graph=True)

    def conv3d_call(x, w, bias):
        x5 = x.permute(0, 3, 1, 2).unsqueeze(-1)               # [B, Cin, T, M, 1]
        w5 = w.permute(2, 1, 0).contiguous()[..., None, None]  # [Cout, Cin, kt, 1, 1]
        return lambda: F.conv3d(x5, w5, bias, padding=(w.shape[0] // 2, 0, 0))

    def conv3d_backward(x, w, g):
        """dx, dW and db of F.conv3d on the same views, through autograd.grad"""
        x5 = x.permute(0, 3, 1, 2).unsqueeze(-1).detach().requires_grad_()
        w5 = w.permute(2, 1, 0).contiguous()[..., None, None].detach().requires_grad_()
        b5 = torch.zeros(w.shape[2], dtype=x.dtype, device=x.device, requires_grad=True)
        y = F.conv3d(x5, w5, b5, padding=(w.shape[0] // 2, 0, 0))
        g5 = g.permute(0, 3, 1, 2).unsqueeze(-1)
        return lambda: torch.autograd.grad(y, (x5, w5, b5), g5, retain_graph=True)

    def packed_lse(b, l, h, lk):
        """(q, k, v, heads) for K1; K1's LSE from its save_lse forward is checked
        against the plain LSE here (the cross-attention's 77 keys)."""
        def make():
            q = rn(b, l, h * 64).to(bf)
            k, v = (rn(b, lk, h * 64).to(bf) for _ in range(2))
            _, lse = A._flash_attention_packed_forward(q, k, v, h, None, save_lse=True)
            _, lse_ref = A.flash_attention_packed_reference(q, k, v, h, save_lse=True)
            err = (lse - lse_ref).abs().max().item()
            print(f"[kernels] K1 save_lse [{b},{l}x{lk},{h}x64]: max |lse - plain| = {err:.3e} "
                  f"(tol {LSE_TOL:.0e})", flush=True)
            check(err <= LSE_TOL, f"K1 LSE disagrees with the plain LSE: {err}")
            return q, k, v, h
        return make

    cases = []
    add = lambda **kw: cases.append(kw)
    # K1: spatial self-attention; ds1 compared on a B=2 slice of the CFG batch
    # (the plain version would hold ~19 GB of fp32 logits at B=28)
    spatial = (("ds1 B=2 slice [2,5824,5x64]", 2, 5824, 5), ("ds2 [28,1456,10x64]", 28, 1456, 10),
               ("ds4 [28,364,20x64]", 28, 364, 20), ("mid [28,91,20x64]", 28, 91, 20))
    temporal = (("ds1 [28,5824,5,64] t=14", 5824, 5), ("ds2 [28,1456,10,64] t=14", 1456, 10),
                ("ds4 [28,364,20,64] t=14", 364, 20), ("mid [28,91,20,64] t=14", 91, 20))
    for label, b, l, h in spatial:
        add(kernel="flash_attention_packed", label=label, make=packed(b, l, h),
            kern=A.flash_attention_packed, plain=A.flash_attention_packed_reference, iters=3,
            work=attn_work(b, h, l, l, 64),
            library=lambda q, k, v, h: (lambda a=[heads_view(x, h) for x in (q, k, v)]: sdpa(*a)))
    # K1 at the SD 2.1 cross-attention: 77 context tokens, the whole CFG batch
    # (its LSE checked too); the headline shape at the CFG batch of the main
    # path (no plain comparison at B = 28: see above) is timed in phase_kernels
    for label, l, h in (("SD cross ds1 [28,5824x77,5x64]", 5824, 5), ("SD cross mid [28,91x77,20x64]", 91, 20)):
        add(kernel="flash_attention_packed", label=label, make=packed_lse(28, l, h, 77),
            kern=A.flash_attention_packed, plain=A.flash_attention_packed_reference, iters=3,
            work=attn_work(28, h, l, 77, 64),
            library=lambda q, k, v, h: (lambda a=[heads_view(x, h) for x in (q, k, v)]: sdpa(*a)))
    # K2: temporal self-attention, t = 14 frames, two videos (uc, c)
    for label, s, h in temporal:
        add(kernel="temporal_attention_direct", label=label, make=direct(28, s, h),
            kern=lambda q, k, v: A.temporal_attention_direct(q, k, v, t=14),
            plain=lambda q, k, v: A.temporal_attention_direct_reference(q, k, v, t=14), iters=5,
            work=attn_work(2 * s, h, 14, 14, 64),
            library=lambda q, k, v: (lambda a=[frames_view(x) for x in (q, k, v)]: sdpa(*a)))
    # K3: VAE mid attention (one 512-dim head, decoding_t = 7 frames) and CLIP
    for label, shape, iters in (("VAE mid [7,1,5824,512]", (7, 1, 5824, 512), 2),
                                ("CLIP ViT-H [1,16,257,80]", (1, 16, 257, 80), 5)):
        add(kernel="flash_attention", label=label, make=bhld(*shape), kern=A.flash_attention,
            plain=A.flash_attention_reference, iters=iters,
            work=attn_work(shape[0], shape[1], shape[2], shape[2], shape[3]),
            library=lambda q, k, v: (lambda: sdpa(q, k, v)))
    # K4: UNet time_stack per level (two videos of 14 frames), VAE decoder
    # time_stack per level and conv_out_time_mix (decoding_t = 7); then the
    # wgmma kernel's edges (one frame, two frames and tokens off the tiles with
    # Cin != Cout, one token a frame, one tap) and fp32 (the FMA tile)
    for label, b, t, m, ci, co, kt, dtype in (
        ("UNet ds1 [2,14,5824,320]", 2, 14, 5824, 320, 320, 3, bf),
        ("UNet ds2 [2,14,1456,640]", 2, 14, 1456, 640, 640, 3, bf),
        ("UNet ds4 [2,14,364,1280]", 2, 14, 364, 1280, 1280, 3, bf),
        ("UNet ds8 [2,14,91,1280]", 2, 14, 91, 1280, 1280, 3, bf),
        ("VAE 56x104 [1,7,5824,512]", 1, 7, 5824, 512, 512, 3, bf),
        ("VAE 112x208 [1,7,23296,512]", 1, 7, 23296, 512, 512, 3, bf),
        ("VAE 224x416 [1,7,93184,256]", 1, 7, 93184, 256, 256, 3, bf),
        ("VAE 448x832 [1,7,372736,128]", 1, 7, 372736, 128, 128, 3, bf),
        ("VAE conv_out_time_mix [1,7,372736,3]", 1, 7, 372736, 3, 3, 3, bf),
        ("T=1 [2,1,5824,320]", 2, 1, 5824, 320, 320, 3, bf),
        ("T=2 [3,2,1000,320->640]", 3, 2, 1000, 320, 640, 3, bf),
        ("M=1 [28,14,1,1280]", 28, 14, 1, 1280, 1280, 3, bf),
        ("kt=1 [2,14,364,1280]", 2, 14, 364, 1280, 1280, 1, bf),
        ("fp32 [2,14,91,320]", 2, 14, 91, 320, 320, 3, torch.float32),
    ):
        dname = "bf16" if dtype == bf else "fp32"
        add(kernel="temporal_conv_1x1", label=label, make=tconv(b, t, m, ci, co, kt, dtype),
            kern=TC.temporal_conv_1x1, plain=TC.temporal_conv_1x1_reference, iters=3,
            work=tconv_work(b, t, m, ci, co, kt, dname), library=conv3d_call)
    # training path (the train phase's batch of 2 videos x 14 frames):
    # K4's dx launch inside the temporal-conv backward (dW/db are matmuls),
    # K5 at every spatial self-attention width (ds1 on a B=2 slice: the
    # plain backward holds several [B, H, L, L] fp32 tensors), K6 at every
    # temporal one
    for label, m, c in (("dx UNet ds1 [2,14,5824,320]", 5824, 320),
                        ("dx UNet ds4 [2,14,364,1280]", 364, 1280)):
        bts, fl, pk = tconv_work(2, 14, m, c, c)
        add(kernel="temporal_conv_1x1", label=label, make=tconv_bwd(2, 14, m, c),
            kern=TC.temporal_conv_1x1_backward, plain=TC.temporal_conv_1x1_backward_reference,
            iters=3, work=(2 * bts, 2 * fl, pk), library=conv3d_backward)  # dx and dW: two such products
    for label, b, l, h in spatial:
        add(kernel="flash_attention_packed_backward", label=label, make=packed_bwd(b, l, h),
            kern=A.flash_attention_packed_backward, plain=A.flash_attention_packed_backward_reference,
            iters=3, work=attn_work(b, h, l, l, 64, backward=True),
            library=lambda q, k, v, o, lse, g, h: sdpa_backward([heads_view(x, h) for x in (q, k, v)],
                                                                heads_view(g, h)))
    for label, s, h in temporal:
        add(kernel="temporal_attention_direct_backward", label=label, make=temporal_bwd(28, s, h),
            kern=lambda q, k, v, o, g: A.temporal_attention_direct_backward(q, k, v, o, g, t=14),
            plain=lambda q, k, v, o, g: A.temporal_attention_direct_backward_reference(
                q, k, v, o, g, t=14),
            iters=3, work=attn_work(2 * s, h, 14, 14, 64, backward=True),
            library=lambda q, k, v, o, g: sdpa_backward([frames_view(x) for x in (q, k, v)],
                                                        frames_view(g)))
    # K13: K3's gradient at the autoencoder step's VAE mid attention (2 frames
    # of 448x832: 5824 tokens, one 512-dim head), at an Lq off the tiles with
    # Lq != Lk, at CLIP's D = 80, and in fp32 (the ae_grad phase's 64 tokens)
    for label, shape, dtype in (("VAE mid [2,1,5824,512]", (2, 1, 5824, 5824, 512), bf),
                                ("[1,1,130x77,512]", (1, 1, 130, 77, 512), bf),
                                ("CLIP [1,16,257,80]", (1, 16, 257, 257, 80), bf),
                                ("[2,1,64,512] fp32", (2, 1, 64, 64, 512), torch.float32)):
        add(kernel="flash_attention_backward", label=label, make=bhld_bwd(*shape, dtype=dtype),
            kern=A.flash_attention_backward, plain=A.flash_attention_backward_reference, iters=3,
            work=attn_work(*shape, backward=True, dtype="bf16" if dtype == bf else "fp32"),
            library=lambda q, k, v, o, lse, g: sdpa_backward([q, k, v], g))
    return cases + group_norm_cases(torch, rn) + gemm_cases(torch, rn)


def gemm_cases(torch, rn):
    """K11 at the CrossAttention projections and K12 at the ResBlock 3x3
    convolutions of the main paths (CFG batch 28 at 56x104 latents). K11: the
    q/k/v projections (no bias) and to_out (bias) per level, the to_k / to_v
    of a one-token context (M = 28) and of SD 2.1's 77-token context (M =
    2156, K = 1024). K12: per level, and the output blocks' skip
    concatenations. bf16, and fp32 at a small and a ragged shape. Library:
    F.linear, and F.conv2d on the channels-last view (as Conv2dNHWC runs it)."""
    import torch.nn.functional as F

    from vidseg_diffusion_tpu_torch.ops import conv3x3 as C3
    from vidseg_diffusion_tpu_torch.ops import matmul as MM

    bf, f32 = torch.bfloat16, torch.float32
    cases = []
    for label, m, k, n, bias, dtype in (
        ("ds1 to_q [163072,320->320]", 163072, 320, 320, False, bf),
        ("ds1 to_out [163072,320->320] bias", 163072, 320, 320, True, bf),
        ("ds2 [40768,640->640]", 40768, 640, 640, False, bf),
        ("ds4 to_out [10192,1280->1280] bias", 10192, 1280, 1280, True, bf),
        ("mid [2548,1280->1280]", 2548, 1280, 1280, False, bf),
        ("one-token to_k [28,1024->320]", 28, 1024, 320, False, bf),
        ("SD to_k ds1 [2156,1024->320]", 2156, 1024, 320, False, bf),
        ("SD to_v ds2 [2156,1024->640]", 2156, 1024, 640, False, bf),
        ("SD to_k ds4 [2156,1024->1280]", 2156, 1024, 1280, False, bf),
        # the wgmma kernel's edges: an N that 160 does not divide, M around one
        # 192-row tile, a K off the 64-channel slices
        ("[193,320->168] bias", 193, 320, 168, True, bf),
        ("[2156,1032->640] bias", 2156, 1032, 640, True, bf),
        ("ds2 [40768,640->640] bias fp32", 40768, 640, 640, True, f32),
        ("SD to_k [2156,1024->320] fp32", 2156, 1024, 320, False, f32),
    ):
        def make(m=m, k=k, n=n, bias=bias, dtype=dtype):
            return (rn(m, k).to(dtype), (rn(n, k) / k ** 0.5).to(dtype), rn(n).to(dtype) if bias else None)

        cases.append(dict(
            kernel="matmul_bias", label=label, make=make, kern=MM.matmul_bias, plain=MM.matmul_bias_plain,
            iters=5, work=matmul_work(m, k, n, bias, "bf16" if dtype == bf else "fp32"),
            library=lambda x, w, b: (lambda: F.linear(x, w, b))))
    for label, b, h, w, cin, cout, dtype in (
        ("ds1 [28,56,104,320->320]", 28, 56, 104, 320, 320, bf),
        ("ds1 skip concat [28,56,104,960->320]", 28, 56, 104, 960, 320, bf),
        ("ds2 [28,28,52,640->640]", 28, 28, 52, 640, 640, bf),
        ("ds2 skip concat [28,28,52,1920->640]", 28, 28, 52, 1920, 640, bf),
        ("ds4 [28,14,26,1280->1280]", 28, 14, 26, 1280, 1280, bf),
        ("ds8 [28,7,13,1280->1280]", 28, 7, 13, 1280, 1280, bf),
        ("ds8 skip concat [28,7,13,2560->1280]", 28, 7, 13, 2560, 1280, bf),
        ("ds2 [4,28,52,640->640] fp32", 4, 28, 52, 640, 640, f32),
        ("ds8 [28,7,13,1280->1280] fp32", 28, 7, 13, 1280, 1280, f32),
    ):
        def make(b=b, h=h, w=w, cin=cin, cout=cout, dtype=dtype):
            return (rn(b, h, w, cin).to(dtype), (rn(cout, cin, 3, 3) / (9 * cin) ** 0.5).to(dtype),
                    rn(cout).to(dtype))

        def conv2d_call(x, wt, bias):
            xn = x.permute(0, 3, 1, 2)   # the channels-last view of the NHWC data
            return lambda: F.conv2d(xn, wt, bias, padding=1)

        cases.append(dict(
            kernel="conv3x3_same", label=label, make=make, kern=C3.conv3x3_same, plain=C3.conv3x3_plain,
            iters=3, work=conv3x3_work(b, h, w, cin, cout, "bf16" if dtype == bf else "fp32"),
            library=conv2d_call))
    return cases


def group_norm_cases(torch, rn):
    """K7-K10 at the GroupNorm sites of the main paths: the UNet's ResBlock
    norms (SiLU, eps 1e-5; [28, H, W, C] per level, the output blocks' skip
    concatenations, the time_stack's 5-D [2, 14, H, W, C] whose statistics
    span (t, H, W)), its transformer norms (no SiLU, eps 1e-6) and the VAE's
    (SiLU, eps 1e-6; 4 channels per group at C = 128; one decoder chunk of 7
    frames, 4-D per frame and 5-D per chunk). Every GroupNorm width of the
    models is a multiple of 32, so no C = 3 k site exists; the element-load
    path is covered by tests/test_torch_gpu.py. For each site the four
    kernels see the same inputs as their plain versions: K8 the plain a, s;
    K9 the plain statistics; K10 the plain coefficients. The library
    yardstick is F.group_norm (+ F.silu) on the same data, for the whole
    forward (K7 + K8) and, through autograd.grad, the whole backward (K9 +
    K10), once on the channels-last view the port would hand it and once on
    an NCHW-contiguous copy (the layout the library prefers). Where
    ops.norm.group_norm_route sends a site to the one-launch kernel
    (group_norm_fused: ds2, ds4, mid, ds8 and the ds8 time_stack), that kernel
    is held to the plain forward too (y, a, s, mean, inv), and its statistics
    to fp64."""
    import torch.nn.functional as F

    from vidseg_diffusion_tpu_torch.ops import norm as N

    bf, f32 = torch.bfloat16, torch.float32
    sites = [
        ("UNet ds1 [28,56,104,320]", (28, 56, 104, 320), bf, True, 1e-5),
        ("UNet ds1 [28,56,104,320] no SiLU", (28, 56, 104, 320), bf, False, 1e-6),
        ("UNet ds1 concat [28,56,104,960]", (28, 56, 104, 960), bf, True, 1e-5),
        ("UNet ds2 [28,28,52,640]", (28, 28, 52, 640), bf, True, 1e-5),
        ("UNet ds4 [28,14,26,1280]", (28, 14, 26, 1280), bf, True, 1e-5),
        ("UNet ds4 [28,14,26,1280] no SiLU", (28, 14, 26, 1280), bf, False, 1e-6),
        ("UNet mid [28,7,13,1280]", (28, 7, 13, 1280), bf, False, 1e-6),
        ("UNet ds8 concat [28,7,13,2560]", (28, 7, 13, 2560), bf, True, 1e-5),
        ("UNet time_stack [2,14,56,104,320]", (2, 14, 56, 104, 320), bf, True, 1e-5),
        ("UNet time_stack ds8 [2,14,7,13,1280]", (2, 14, 7, 13, 1280), bf, True, 1e-5),
        ("VAE [7,448,832,128]", (7, 448, 832, 128), bf, True, 1e-6),
        ("VAE time_stack [1,7,448,832,128]", (1, 7, 448, 832, 128), bf, True, 1e-6),
        ("UNet ds1 [28,56,104,320] fp32", (28, 56, 104, 320), f32, True, 1e-5),
        ("UNet mid [28,7,13,1280] fp32", (28, 7, 13, 1280), f32, False, 1e-6),
        ("UNet time_stack [2,14,56,104,320] fp32", (2, 14, 56, 104, 320), f32, True, 1e-5),
    ]
    groups = 32
    cases = []
    for label, shape, dtype, silu, eps in sites:
        shared = {}   # one set of inputs per site, built by its first case, freed by the K10 case
        n, c, item = 1, shape[-1], 2 if dtype == bf else 4
        for d in shape:
            n *= d
        fused = N.group_norm_route(shape[0], n // (shape[0] * c), c, groups, item, True)[0] == "fused"

        def inputs(shape=shape, dtype=dtype, silu=silu, eps=eps, shared=shared, label=label, fused=fused):
            if shared:
                return shared
            c = shape[-1]
            x = (rn(*shape) * 1.5 + 0.3).to(dtype)
            w, b = (rn(c) * 0.5 + 1.0).to(dtype), rn(c).to(dtype)
            dy = rn(*shape).to(dtype)
            a, s, mean, inv = N.group_norm_affine_plain(x, w, b, groups, eps)
            coef = N.group_norm_backward_coef_plain(x, dy, w, a, s, mean, inv, groups, silu)[0]
            shared.update(x=x, w=w, b=b, dy=dy, a=a, s=s, mean=mean, inv=inv, coef=coef)
            stats_vs_fp64(torch, "K7", label, x, N.group_norm_stats(x, w, b, groups, eps)[2:], groups, eps)
            if fused:
                stats_vs_fp64(torch, "K7+K8 fused", label, x, N.group_norm_fused(x, w, b, groups, eps, silu)[3:],
                              groups, eps)
            shared["library"] = group_norm_library(torch, F, x, w, b, dy, groups, eps, silu)
            return shared

        small = 4 * shape[0] * c
        pick = lambda *keys: (lambda inputs=inputs: tuple(inputs()[k] for k in keys))

        def free(shared=shared):
            shared.clear()

        common = dict(iters=5, label=label, site=shared)
        if fused:
            cases.append(dict(
                kernel="group_norm_fused", make=pick("x", "w", "b"),
                kern=lambda x, w, b, eps=eps, silu=silu: N.group_norm_fused(x, w, b, groups, eps, silu),
                plain=lambda x, w, b, eps=eps, silu=silu: fused_plain(N, x, w, b, groups, eps, silu),
                work=(2 * n * item + 4 * small, (8 if silu else 5) * n, "fp32"),
                library=lambda *a, shared=shared: shared["library"]["forward"], library_covers="K7+K8", **common))
        cases.append(dict(
            kernel="group_norm_stats", make=pick("x", "w", "b"),
            kern=lambda x, w, b, eps=eps: N.group_norm_stats(x, w, b, groups, eps),
            plain=lambda x, w, b, eps=eps: N.group_norm_affine_plain(x, w, b, groups, eps),
            work=(n * item + 2 * small, 3 * n, "fp32"),
            library=lambda *a, shared=shared: shared["library"]["forward"], library_covers="K7+K8", **common))
        cases.append(dict(
            kernel="group_norm_apply", make=pick("x", "a", "s"),
            kern=lambda x, a, s, silu=silu: N.group_norm_apply(x, a, s, silu),
            plain=lambda x, a, s, silu=silu: N.group_norm_apply_plain(x, a, s, silu),
            work=(2 * n * item + 2 * small, (8 if silu else 2) * n, "fp32"),
            library=lambda *a, shared=shared: shared["library"]["forward"], library_covers="K7+K8", **common))
        cases.append(dict(
            kernel="group_norm_backward_stats", make=pick("x", "dy", "w", "a", "s", "mean", "inv"),
            kern=lambda *a, silu=silu: split_coef(N.group_norm_backward_stats(*a, groups, silu)),
            plain=lambda *a, silu=silu: split_coef(N.group_norm_backward_coef_plain(*a, groups, silu)),
            work=(2 * n * item + 7 * small, (14 if silu else 3) * n, "fp32"),
            library=lambda *a, shared=shared: shared["library"]["backward"], library_covers="K9+K10", **common))
        cases.append(dict(
            kernel="group_norm_backward_apply", make=pick("x", "dy", "a", "s", "coef"),
            kern=lambda *a, silu=silu: N.group_norm_backward_apply(*a, silu),
            plain=lambda *a, silu=silu: N.group_norm_backward_apply_plain(*a, silu),
            work=(3 * n * item + 5 * small, (16 if silu else 4) * n, "fp32"),
            library=lambda *a, shared=shared: shared["library"]["backward"], library_covers="K9+K10",
            after=free, **common))
    return cases


def split_coef(result):
    """(coef [B, 3, C], dweight, dbias) -> (a2, b2, c2, dweight, dbias): each
    coefficient is held to the bounds against its own largest value."""
    coef, dw, db = result
    return coef[:, 0], coef[:, 1], coef[:, 2], dw, db


def fused_plain(N, x, w, b, groups, eps, silu):
    """The plain versions of what group_norm_fused returns: (y, a, s, mean, inv)."""
    a, s, mean, inv = N.group_norm_affine_plain(x, w, b, groups, eps)
    return N.group_norm_apply_plain(x, a, s, silu), a, s, mean, inv


def stats_vs_fp64(torch, kid, label, x, stats, groups, eps):
    """A kernel's mean and inv-std against fp64 statistics of the same input:
    the fp32 partial sums (thread, block, chunk list) must not drift over up to
    2.6 M elements per channel."""
    mean, inv = stats
    xg = x.reshape(x.shape[0], -1, groups, x.shape[-1] // groups)
    mean64 = torch.stack([xg[i].double().mean(dim=(0, 2)) for i in range(x.shape[0])])
    sq64 = torch.stack([xg[i].double().square().mean(dim=(0, 2)) for i in range(x.shape[0])])
    inv64 = (sq64 - mean64 * mean64 + eps).rsqrt()
    e_mean = ((mean.double() - mean64).abs() / sq64.sqrt()).max().item()
    e_inv = (inv.double() / inv64 - 1).abs().max().item()
    print(f"[kernels] {kid} {label}: mean vs fp64 {e_mean:.2e} of rms(x), inv-std vs fp64 {e_inv:.2e} "
          f"relative (tol {STATS_TOL:.0e})", flush=True)
    check(e_mean <= STATS_TOL and e_inv <= STATS_TOL, f"{kid} statistics drift from fp64 at {label}")


def group_norm_library(torch, F, x, w, b, dy, groups, eps, silu):
    """Times of F.group_norm (+ F.silu) forward and of its backward
    (autograd.grad to x, weight, bias) on the same data: as the channels-last
    view of x that the port holds, and on an NCHW-contiguous copy."""
    perm = (0, x.dim() - 1) + tuple(range(1, x.dim() - 1))
    out = {}
    for layout, to in (("channels_last", lambda t: t.permute(perm)),
                       ("nchw", lambda t: t.permute(perm).contiguous())):
        leaves = [to(x).detach().requires_grad_(), w.detach().clone().requires_grad_(),
                  b.detach().clone().requires_grad_()]
        g = to(dy)

        def forward(leaves=leaves):
            y = F.group_norm(leaves[0], groups, leaves[1], leaves[2], eps)
            return F.silu(y) if silu else y

        y = forward()
        with torch.no_grad():
            out[f"forward_{layout}"] = time_ms(forward, 5)
        out[f"backward_{layout}"] = time_ms(
            lambda: torch.autograd.grad(y, leaves, g, retain_graph=True), 5)
        del y, leaves, g
    # the yardstick of record is the call on the port's own layout
    return dict(forward=out["forward_channels_last"], backward=out["backward_channels_last"], **out)


def sdpa_backends(torch, q, k, v):
    """The scaled_dot_product_attention backends that take these inputs, in
    PyTorch's order of preference (the first is the one the library call
    runs)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    ok = []
    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.CUDNN_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
                    SDPBackend.MATH):
        try:
            with sdpa_kernel([backend]):
                torch.nn.functional.scaled_dot_product_attention(q, k, v)
            ok.append(backend.name)
        except RuntimeError:
            pass
    return ok


def compare(torch, out, ref, rms_tol):
    """(ok, max |out - ref|, error in bf16 steps at max |ref| or, for fp32
    outputs, relative to it; relative RMS error; max |ref|)."""
    diff = out.float() - ref.float()
    e = diff.abs().max().item()
    pk = ref.float().abs().max().item()
    rm = diff.norm().item() / max(ref.float().norm().item(), 1e-30)
    finite = bool(torch.isfinite(out).all())
    if out.dtype == torch.bfloat16:
        step = 2.0 ** (math.floor(math.log2(pk)) - 7) if pk > 0 else 0.0
        steps = e / step if step else (0.0 if e == 0 else math.inf)
        return finite and steps <= MAX_STEPS and rm <= rms_tol, e, steps, rm, pk
    rel = e / pk if pk > 0 else (0.0 if e == 0 else math.inf)
    return finite and rel <= FP32_TOL and rm <= FP32_TOL, e, rel, rm, pk


def phase_kernels(torch):
    rows = []
    for case in kernel_cases(torch):
        kname, label, kern, plain, iters = (case[k] for k in ("kernel", "label", "kern", "plain", "iters"))
        args = case["make"]()
        out = kern(*args)
        torch.cuda.synchronize()
        ref = plain(*args)
        torch.cuda.synchronize()
        # a backward returns several gradients: each is held to the bounds
        outs, refs = (out, ref) if isinstance(out, tuple) else ((out,), (ref,))
        rms_tol = KERNELS[kname]["rms_tol"]
        ok, err, rms, steps, rel, peak = True, 0.0, 0.0, 0.0, 0.0, 0.0
        for o, r in zip(outs, refs):
            check(o.shape == r.shape and o.dtype == r.dtype, f"{kname} {label}: shape/dtype")
            good, e, unit, rm, pk = compare(torch, o, r, rms_tol)
            ok = ok and good
            err, rms, peak = max(err, e), max(rms, rm), max(peak, pk)
            if o.dtype == torch.bfloat16:
                steps = max(steps, unit)
            else:
                rel = max(rel, unit)
        ms = time_ms(lambda: kern(*args), iters)
        plain_ms = time_ms(lambda: plain(*args), iters)
        library_ms = None
        if case.get("library") is not None:
            lib = case["library"](*args)
            library_ms = lib if isinstance(lib, float) else time_ms(lib, iters)
            del lib
        if kname == "flash_attention_backward" and label == HEADLINE[kname]:
            print(f"[kernels] SDPA backends that take {label}: {sdpa_backends(torch, *args[:3])} "
                  "(the first is the library call's)", flush=True)
        nbytes, flops, peak_key = case["work"]
        by_bytes, by_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / PEAK_FLOPS[peak_key] * 1e3
        row = dict(kernel=kname, shape=label, max_abs_err=err, bf16_steps=steps, fp32_rel_err=rel,
                   max_abs_plain=peak, rel_rms_err=rms, ok=ok, ms=ms, plain_ms=plain_ms,
                   bound_ms=max(by_bytes, by_ops), bound_by="bytes" if by_bytes >= by_ops else "operations",
                   library_ms=library_ms, library_covers=case.get("library_covers"))
        rows.append(row)
        lib_txt = "none" if library_ms is None else (
            f"{library_ms:.3f} ms" + (f" ({case['library_covers']})" if case.get("library_covers") else ""))
        print(f"[kernels] {KERNELS[kname]['id']} {kname} {label}: max_abs_err={err:.3e} "
              f"({steps:.2f} bf16 steps at max|plain| {peak:.3e}, tol {MAX_STEPS}; fp32 outputs "
              f"{rel:.2e} relative, tol {FP32_TOL:.0e}) rel_rms_err={rms:.3e} (tol {rms_tol:.0e}) "
              f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound {row['bound_ms']:.3f} ms by "
              f"{row['bound_by']}, library {lib_txt}", flush=True)
        if "after" in case:  # the last case of a GroupNorm site: its four library timings
            lib_times = {k: round(v, 3) for k, v in case["site"]["library"].items() if "_" in k}
            print(f"[kernels] F.group_norm(+silu) {label}: ms {json.dumps(lib_times)}", flush=True)
            case["after"]()
        del args, out, ref, outs, refs
        torch.cuda.empty_cache()
    bad = [r for r in rows if not r["ok"]]
    check(not bad, f"kernel disagrees with its plain version: {bad}")
    k1_at_cfg_batch(torch)
    return rows


def k1_at_cfg_batch(torch):
    """K1's headline shape at the main path's CFG batch of 28 (the kernel
    cases compare a B = 2 slice: the plain version would hold ~19 GB of fp32
    logits here): kernel and SDPA times beside the bound, finite output."""
    from vidseg_diffusion_tpu_torch.ops import attention as A

    g = torch.Generator(device="cuda").manual_seed(6)
    q, k, v = (torch.randn(28, 5824, 320, generator=g, device="cuda").to(torch.bfloat16) for _ in range(3))
    out = A.flash_attention_packed(q, k, v, 5)
    check(bool(torch.isfinite(out).all()), "K1 at [28,5824,5x64] is not finite")
    hv = lambda x: x.view(28, 5824, 5, 64).transpose(1, 2)
    ms = time_ms(lambda: A.flash_attention_packed(q, k, v, 5), 3)
    lib = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(hv(q), hv(k), hv(v)), 3)
    nbytes, flops, peak = attn_work(28, 5, 5824, 5824, 64)
    bound = max(nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[peak]) * 1e3
    print(f"[kernels] K1 flash_attention_packed ds1 at the CFG batch [28,5824,5x64] (time only): kernel "
          f"{ms:.3f} ms, library {lib:.3f} ms, bound {bound:.3f} ms by operations", flush=True)
    del q, k, v, out
    torch.cuda.empty_cache()


def phase_unet(torch):
    """Full-width UNet forwards, the SVD video UNet and the SD 2.1 image UNet:
    kernels on the card vs plain versions on the CPU, same fp32 weights and
    inputs (TF32 off on the card)."""
    import copy

    from vidseg_diffusion_tpu_torch.config import load_model_spec
    from vidseg_diffusion_tpu_torch.engine.build import randomize_
    from vidseg_diffusion_tpu_torch.models.unet import UNetModel

    saved_tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t, b = 2, 4  # [uc; c] of one 2-frame video
    for config, video in (("svd.yaml", True), ("sd_2_1.yaml", False)):
        spec = load_model_spec(os.path.join(ROOT, "configs/inference", config), num_frames=t)
        unet = UNetModel(spec.unet_config).cuda()
        randomize_(unet, torch.Generator(device="cuda").manual_seed(1))
        cpu_unet = copy.deepcopy(unet).cpu()
        g = torch.Generator().manual_seed(2)
        x = torch.randn(b, 16, 16, spec.unet_config.in_channels, generator=g)
        if video:
            args = (x, torch.randn(b, generator=g), torch.randn(b, 1, 1024, generator=g),
                    torch.randn(b, 768, generator=g))
            kw = dict(num_video_frames=t, image_only_indicator=torch.zeros(2, t))
        else:  # table indices as timesteps, the 77-token text context
            args = (x, torch.randint(0, 1000, (b,), generator=g).float(), torch.randn(b, 77, 1024, generator=g))
            kw = {}
        with torch.no_grad():
            ref = cpu_unet(*args, **kw)
            out = unet(*(a.cuda() for a in args), **{k: v.cuda() if hasattr(v, "cuda") else v
                                                     for k, v in kw.items()}).cpu()
        err = (out - ref).abs().max().item()
        scale = ref.abs().max().item()
        print(f"[unet] full-width {config} UNet fp32, card vs CPU: max_abs_err={err:.3e} "
              f"(tol {UNET_REL_TOL * scale:.3e})", flush=True)
        check(bool(torch.isfinite(out).all()), f"{config} UNet output not finite")
        check(err <= UNET_REL_TOL * scale, f"{config} UNet on the card disagrees with the CPU plain path")
        del unet, cpu_unet
        torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved_tf32


def phase_train_grad(torch):
    """Full-width UNet gradients: loss.backward() on the card through the
    kernels (K1/K5, K2/K6, K4) vs the CPU through the plain versions, same
    fp32 weights, inputs, sigma and noise (TF32 off on the card)."""
    import copy
    import dataclasses

    from vidseg_diffusion_tpu_torch.engine.build import randomize_
    from vidseg_diffusion_tpu_torch.models.unet import UNetModel
    from vidseg_diffusion_tpu_torch.ops import attention as A
    from vidseg_diffusion_tpu_torch.scripts import train_path

    saved_tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t, b = 2, 4  # two 2-frame videos
    cfg = train_path.unet_config(dtype=torch.float32, num_frames=t)
    with torch.device("cuda"):
        unet = UNetModel(cfg)
    randomize_(unet, torch.Generator(device="cuda").manual_seed(3))
    cpu_unet = copy.deepcopy(unet).cpu()
    cpu_unet.config = dataclasses.replace(cfg, remat=False)  # same math, one forward less
    g = torch.Generator().manual_seed(4)
    latents = torch.randn(b, 16, 16, 4, generator=g)
    cond = {"crossattn": torch.randn(b, 1, 1024, generator=g), "vector": torch.randn(b, 768, generator=g),
            "concat": torch.randn(b, 16, 16, 4, generator=g)}
    sigma = torch.exp(-1.2 + 1.2 * torch.randn(b, generator=g))
    noise = torch.randn(b, 16, 16, 4, generator=g)
    loss_mod, factory = train_path.loss_module(), train_path.network_factory(t)

    def grads(model, dev):
        cd = {k: v.to(dev) for k, v in cond.items()}
        loss = loss_mod(factory(model), latents.to(dev), cd, sigma=sigma.to(dev), noise=noise.to(dev))
        loss.backward()
        return loss.item(), {n: p.grad for n, p in model.named_parameters()}

    launches = A.flash_attention_packed_backward.launches, A.temporal_attention_direct_backward.launches
    t0 = time.perf_counter()
    loss_card, g_card = grads(unet, "cuda")
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    check(A.flash_attention_packed_backward.launches > launches[0]
          and A.temporal_attention_direct_backward.launches > launches[1],
          "the card's backward did not launch K5 and K6")
    t0 = time.perf_counter()
    loss_cpu, g_cpu = grads(cpu_unet, "cpu")
    cpu_s = time.perf_counter() - t0
    worst, worst_name, n_none = 0.0, "", 0
    floor = GRAD_FLOOR * max(gc.norm().item() for gc in g_cpu.values() if gc is not None)
    for name, gc in g_cpu.items():
        gk = g_card[name]
        if gc is None or gk is None:
            check(gc is None and gk is None and feeds_one_key_query(name), f"gradient missing for {name}")
            n_none += 1
            continue
        check(bool(torch.isfinite(gk).all()), f"gradient of {name} not finite on the card")
        rel = (gk.cpu() - gc).norm().item() / max(gc.norm().item(), floor)
        if rel > worst:
            worst, worst_name = rel, name
    print(f"[train_grad] full-width UNet fp32 remat, loss card {loss_card:.6f} vs CPU {loss_cpu:.6f}; "
          f"{len(g_cpu) - n_none} parameter gradients, worst relative error by norm {worst:.3e} "
          f"({worst_name}; tol {GRAD_REL_TOL:.0e}); {n_none} one-key query/key parameters without one; "
          f"card {card_s:.1f} s, CPU {cpu_s:.1f} s", flush=True)
    check(abs(loss_card - loss_cpu) <= UNET_REL_TOL * abs(loss_cpu), "loss on the card disagrees with the CPU")
    check(worst <= GRAD_REL_TOL, f"gradient of {worst_name} on the card disagrees with the CPU: {worst}")
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved_tf32
    del unet, cpu_unet, g_card, g_cpu
    torch.cuda.empty_cache()


def feeds_one_key_query(name):
    """Parameters that only feed the query or key of a one-key cross-attention
    (attn2's q/k projections and the norm2 LayerNorm before them): the V
    shortcut leaves them without a gradient."""
    return any(s in name for s in ("attn2.to_q.", "attn2.to_k.", "norm2."))


def kernel_fns():
    from vidseg_diffusion_tpu_torch.ops import attention as A
    from vidseg_diffusion_tpu_torch.ops import conv3x3 as C3
    from vidseg_diffusion_tpu_torch.ops import matmul as MM
    from vidseg_diffusion_tpu_torch.ops import norm as N
    from vidseg_diffusion_tpu_torch.ops import temporal_conv as TC

    counters = (list(A.KERNEL_COUNTERS) + [TC.temporal_conv_1x1] + list(N.KERNEL_COUNTERS)
                + [MM.matmul_bias, C3.conv3x3_same])
    plains = (list(A.PLAIN_COUNTERS) + [TC.temporal_conv_1x1_reference, TC.temporal_conv_1x1_backward_reference]
              + list(N.PLAIN_COUNTERS) + [MM.matmul_bias_plain, C3.conv3x3_plain])
    return counters, plains


# the kernels whose wrappers count the launches by the kernel that ran
# (`.wgmma_launches`, `.narrow_launches`, reported by the C entry): on every
# path each launch of K1 (D = 64) and K11 (bf16 projections) takes the wgmma
# kernel, and each of K4 too but the narrow_launches the path implies (the VAE's
# 3-channel conv_out_time_mix, once per decoder call)
ROUTED = ("flash_attention_packed", "temporal_conv_1x1", "matmul_bias")
GN_ROUTES = {"fused": 0, "stream": 0}   # GroupNorm32 calls per route since reset_counts()


def count_group_norm_route(module, args):
    """A forward pre-hook on every module: a GroupNorm32 call counts under the
    route ops.norm.group_norm_route gives its input (a strided input is copied,
    and the copy is aligned)."""
    from vidseg_diffusion_tpu_torch.models.layers import GroupNorm32
    from vidseg_diffusion_tpu_torch.ops import norm as N

    if isinstance(module, GroupNorm32):
        x = args[0]
        b, c = x.shape[0], x.shape[-1]
        aligned = not x.is_contiguous() or x.data_ptr() % 16 == 0
        GN_ROUTES[N.group_norm_route(b, x.numel() // (b * c), c, module.groups, x.element_size(), aligned)[0]] += 1


def reset_counts():
    from vidseg_diffusion_tpu_torch.ops import norm as N

    counters, plains = kernel_fns()
    for f in counters:
        f.launches = 0
        for route in ("wgmma_launches", "narrow_launches"):
            if hasattr(f, route):
                setattr(f, route, 0)
    for f in plains:
        f.calls = 0
    N.group_norm.copies = 0
    GN_ROUTES.update(fused=0, stream=0)


def read_routes():
    """{kernel: {route: launches}} for the route-counting wrappers."""
    counters, _ = kernel_fns()
    return {f.__name__: {r: getattr(f, f"{r}_launches") for r in ("wgmma", "narrow") if hasattr(f, f"{r}_launches")}
            for f in counters if hasattr(f, "wgmma_launches")}


ROUTE_COUNTS = {}   # phase -> read_routes() after its run


def check_routes(tag, launches, narrow=0):
    """Every K1 and K11 launch of the run took the wgmma kernel (none the
    mma.sync tile or an FMA kernel), and every K4 launch but `narrow` of them,
    which took the narrow kernel; keeps and returns the route counts."""
    routes = read_routes()
    want = {name: {"wgmma": launches[name]} for name in ROUTED}
    want["temporal_conv_1x1"] = {"wgmma": launches["temporal_conv_1x1"] - narrow, "narrow": narrow}
    got = {name: routes[name] for name in ROUTED}
    check(got == want, f"[{tag}] launches by route {got}, expected {want}")
    ROUTE_COUNTS[tag] = routes
    return routes


def narrow_tconv_sites(model):
    """TemporalConv modules of a model whose widths the wgmma kernel does not
    take (Cin or Cout % 8 != 0: the VAE decoder's conv_out_time_mix)."""
    from vidseg_diffusion_tpu_torch.models.unet import TemporalConv

    return sum(isinstance(m, TemporalConv) and (m.weight.shape[0] % 8 or m.weight.shape[1] % 8) > 0
               for m in model.modules())


def group_norm_expected(tag, n_gn):
    """K7 / K8 (stream) and the fused kernel's launches by route, as the hook
    counted the GroupNorm calls; their sum must be the n_gn the modules imply."""
    check(GN_ROUTES["fused"] + GN_ROUTES["stream"] == n_gn,
          f"[{tag}] GroupNorm calls by route {GN_ROUTES}, expected {n_gn} in all")
    return {"group_norm_stats": GN_ROUTES["stream"], "group_norm_apply": GN_ROUTES["stream"],
            "group_norm_fused": GN_ROUTES["fused"]}


def module_launches(pipe, calls):
    """Launches an inference path implies from its modules and its `calls` per
    model: one GroupNorm forward (K7 + K8 or the fused kernel) per GroupNorm
    module per call of the model that holds it; K11 four per CrossAttention
    module and K12 two per ResBlock per UNet call. Returns ({kernel or
    "group_norm": launches}, modules per call)."""
    from vidseg_diffusion_tpu_torch.models.layers import CrossAttention, GroupNorm32
    from vidseg_diffusion_tpu_torch.models.unet import ResBlock

    count = lambda m, cls: sum(isinstance(x, cls) for x in m.modules())
    models = {"unet": pipe.unet, "encoder": pipe.first_stage.encoder, "decoder": pipe.first_stage.decoder}
    per_call = {k: count(m, GroupNorm32) for k, m in models.items()}
    per_call.update(attention=count(pipe.unet, CrossAttention), resblock=count(pipe.unet, ResBlock))
    n_gn = sum(calls[k] * per_call[k] for k in calls)
    return {"group_norm": n_gn, "matmul_bias": 4 * per_call["attention"] * calls["unet"],
            "conv3x3_same": 2 * per_call["resblock"] * calls["unet"]}, per_call


def train_launches(unet):
    """Launches one training step of the remat UNet implies: TRAIN_LAUNCHES and,
    from the modules, K11 four per CrossAttention and K12 two per ResBlock in
    each of the two forwards; a GroupNorm forward (K7 + K8 or the fused kernel)
    twice per GroupNorm but once for the output norm, which no remat block
    holds; K9 / K10 once per GroupNorm."""
    from vidseg_diffusion_tpu_torch.models.layers import CrossAttention, GroupNorm32
    from vidseg_diffusion_tpu_torch.models.unet import ResBlock

    count = lambda cls: sum(isinstance(x, cls) for x in unet.modules())
    n_gn = count(GroupNorm32)
    return dict(TRAIN_LAUNCHES, flash_attention=0, flash_attention_backward=0, group_norm=2 * n_gn - 1,
                group_norm_backward_stats=n_gn, group_norm_backward_apply=n_gn,
                matmul_bias=2 * 4 * count(CrossAttention), conv3x3_same=2 * 2 * count(ResBlock))


def read_counts():
    counters, plains = kernel_fns()
    return {f.__name__: f.launches for f in counters}, {f.__name__: f.calls for f in plains}


def run_main_path(torch, pipe, tag, injected):
    """One run_single_video of scripts/main_path.py with its checks; returns
    (launches, result)."""
    import numpy as np

    from vidseg_diffusion_tpu_torch.ops import norm as N
    from vidseg_diffusion_tpu_torch.pipelines.single_video import run_single_video
    from vidseg_diffusion_tpu_torch.scripts import main_path

    t, hpx, wpx = main_path.NUM_FRAMES, main_path.HEIGHT, main_path.WIDTH
    frames, names = main_path.frames(), main_path.frame_names()
    args = main_path.vidseg_args(is_injected_features=injected)
    timings = {}
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    res = run_single_video(pipe, frames, names, args, write_outputs=False, timings=timings)
    total = time.perf_counter() - t0
    launches, plain_calls = read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"[{tag}] run_single_video {total:.2f} s, stages_s "
          f"{json.dumps({k: round(v, 3) for k, v in timings.items()})}", flush=True)
    print(f"[{tag}] kernel launches {json.dumps(launches)}; plain calls {json.dumps(plain_calls)}; "
          f"GroupNorm input copies {N.group_norm.copies}; peak device memory {peak_gb:.1f} GB "
          f"({card_line()})", flush=True)

    by_module, per_call = module_launches(pipe, MAIN_CALLS)
    check(all(by_module[k] == MAIN_LAUNCHES[k] for k in ("matmul_bias", "conv3x3_same")),
          f"K11 / K12 launches reckoned from the modules {by_module} differ from {MAIN_LAUNCHES}")
    expected = {name: MAIN_LAUNCHES.get(name, 0) for name in launches}
    expected.update(group_norm_expected(tag, by_module.pop("group_norm")), **by_module)
    check(launches == expected, f"inference launches {launches}, expected {expected} (modules "
                                f"per call {per_call}; no backward)")
    check(all(n == 0 for n in plain_calls.values()), f"plain versions ran on the card: {plain_calls}")
    narrow = MAIN_CALLS["decoder"] * narrow_tconv_sites(pipe.first_stage.decoder)
    print(f"[{tag}] launches by route {json.dumps(check_routes(tag, launches, narrow))}; GroupNorm calls by "
          f"route {json.dumps(GN_ROUTES)}", flush=True)
    k = args.num_masks
    h, w = hpx // 8, wpx // 8
    fin = res.final_latents
    check(fin.shape == (2, k, t, h, w, 4), f"final latents shape {fin.shape}")
    check(np.isfinite(fin).all() and np.isfinite(res.feature_x0).all(), "latents not finite")
    check(res.seg_raw.shape == (t, hpx, wpx) and res.seg_filtered.shape == (t, hpx, wpx),
          f"label map shape {res.seg_raw.shape}")
    check(set(np.unique(res.seg_raw)) <= set(range(k)), "labels out of range")
    check(np.isfinite(res.diff_maps).all(), "difference maps not finite")
    dpm = float(np.abs(fin[0] - fin[1]).max())
    check(dpm > 0, "+lambda and -lambda runs are identical: modulation never reached the output")
    last = res.cached_xt[-1]
    outside = max(float(np.abs((fin[s, m] - last) * (1 - res.masks_latent[m][..., None])).max())
                  for s in range(2) for m in range(k))
    check(outside == 0.0, f"outside-mask latents deviate from the cached trajectory by {outside}")
    print(f"[{tag}] max|+lambda - -lambda| = {dpm:.4f}; outside-mask deviation = {outside}; "
          f"labels used {sorted(int(v) for v in np.unique(res.seg_raw))}", flush=True)
    return launches, res


def phase_main(torch):
    from vidseg_diffusion_tpu_torch.scripts import main_path

    t0 = time.perf_counter()
    pipe = main_path.build()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in pipe.unet.parameters())
    print(f"[main] built svd.yaml (UNet {n_params / 1e9:.3f} B params, bf16) in {build_s:.1f} s", flush=True)
    launches, res = run_main_path(torch, pipe, "main", injected=False)
    check(res.injected_sites == 0 and res.injected_cache_bytes == 0, "the default run injected features")
    return launches, pipe, res


def phase_inject(torch, pipe, plain_res):
    """The main path with is_injected_features, same frames, seed and weights."""
    import numpy as np

    # reckoned before the run: q and k of the 9 attention-bearing output blocks
    # on the [uc; c] batch of 28 frames, bf16: three blocks each at 5824 x 320,
    # 1456 x 640 and 364 x 1280 tokens x channels, per cached step
    per_step = 2 * 28 * 2 * 3 * (5824 * 320 + 1456 * 640 + 364 * 1280)
    print(f"[inject] expected q/k cache: {per_step / 1e9:.2f} GB per cached step, "
          f"{INJECT_STEPS * per_step / 1e9:.2f} GB for {INJECT_STEPS} steps", flush=True)
    launches, res = run_main_path(torch, pipe, "inject", injected=True)
    n_sites = INJECT_BLOCKS * INJECT_STEPS * 2 * plain_res.masks.shape[0]
    check(res.injected_cache_bytes == INJECT_STEPS * per_step,
          f"q/k cache holds {res.injected_cache_bytes} bytes, expected {INJECT_STEPS * per_step}")
    check(res.injected_sites == n_sites, f"{res.injected_sites} injected sites, expected {n_sites}")
    # the feature pass is the same work in both runs; what it may differ by from run to run
    # (vendor GEMM / convolution kernels need not be bitwise repeatable) is the noise floor
    noise = float(np.abs(res.cached_xt - plain_res.cached_xt).max())
    check(np.array_equal(res.masks, plain_res.masks), "the k-means masks changed with injection on")
    moved = float(np.abs(res.final_latents - plain_res.final_latents).max())
    check(moved > 10 * noise and moved > 0,
          f"injected runs equal the un-injected ones up to run-to-run noise ({moved} vs {noise}): "
          "the cached q/k never reached attention")
    print(f"[inject] {res.injected_sites} injected sites ({INJECT_BLOCKS} blocks x {INJECT_STEPS} steps x "
          f"{2 * plain_res.masks.shape[0]} runs), q/k cache {res.injected_cache_bytes / 1e9:.2f} GB; "
          f"max |injected - un-injected final latents| = {moved:.4f} (feature passes differ by {noise})",
          flush=True)
    return launches


def phase_sd(torch):
    """The SD 2.1 path of scripts/sd_path.py with its checks; returns its
    kernel launches."""
    import numpy as np

    from vidseg_diffusion_tpu_torch.diffusion.sampling import EulerEDMSampler
    from vidseg_diffusion_tpu_torch.models.layers import CrossAttention
    from vidseg_diffusion_tpu_torch.ops import conv3x3 as C3
    from vidseg_diffusion_tpu_torch.ops import norm as N
    from vidseg_diffusion_tpu_torch.pipelines.single_video import run_single_video
    from vidseg_diffusion_tpu_torch.scripts import main_path, sd_path

    t0 = time.perf_counter()
    pipe = sd_path.build()
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in pipe.unet.parameters())
    n_text = sum(p.numel() for p in pipe.text.parameters())
    print(f"[sd] built sd_2_1.yaml (image UNet {n_params / 1e9:.3f} B params, text tower "
          f"{n_text / 1e9:.3f} B, bf16) in {time.perf_counter() - t0:.1f} s", flush=True)
    args = sd_path.vidseg_args()
    check(SD_CALLS["unet"] == sd_path.unet_calls(args.num_masks), "SD_CALLS disagrees with scripts/sd_path.py")
    t, hpx, wpx = main_path.NUM_FRAMES, main_path.HEIGHT, main_path.WIDTH
    timings = {}
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    relays = C3.conv3x3_same.relays
    # the latents that enter the step after the blend window (it ends at step
    # 23): the feature pass's first, then those of the 2 * num_masks runs
    blend_end = sd_path.MODULATE_STEP + 1
    after_blend = []
    sampler_step = EulerEDMSampler.step

    def recording_step(self, denoise_fn, x, sigma, next_sigma, i):
        if i == blend_end + 1:
            after_blend.append(x)
        return sampler_step(self, denoise_fn, x, sigma, next_sigma, i)

    EulerEDMSampler.step = recording_step
    t0 = time.perf_counter()
    try:
        res = run_single_video(pipe, sd_path.frames(), sd_path.frame_names(), args, write_outputs=False,
                               timings=timings, text_tokens=sd_path.text_tokens())
    finally:
        EulerEDMSampler.step = sampler_step
    total = time.perf_counter() - t0
    launches, plain_calls = read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"[sd] run_single_video {total:.2f} s, stages_s "
          f"{json.dumps({k: round(v, 3) for k, v in timings.items()})}", flush=True)
    print(f"[sd] kernel launches {json.dumps(launches)}; plain calls {json.dumps(plain_calls)}; "
          f"GroupNorm input copies {N.group_norm.copies}; conv weights re-laid "
          f"{C3.conv3x3_same.relays - relays}; peak device memory {peak_gb:.1f} GB ({card_line()})", flush=True)

    expected = {name: 0 for name in launches}
    by_module, per_call = module_launches(pipe, SD_CALLS)
    expected.update(group_norm_expected("sd", by_module.pop("group_norm")), **by_module)
    n_attn = sum(isinstance(m, CrossAttention) for m in pipe.unet.modules())
    expected["flash_attention_packed"] = n_attn * SD_CALLS["unet"]       # self and 77-key cross sites
    expected["flash_attention"] = SD_CALLS["encoder"] + SD_CALLS["decoder"]  # the VAE's mid attention
    check(launches == expected, f"SD launches {launches}, expected {expected} (modules per call "
                                f"{per_call}; K2, K4 and the backward kernels never)")
    check(all(n == 0 for n in plain_calls.values()), f"plain versions ran on the card: {plain_calls}")
    print(f"[sd] launches by route {json.dumps(check_routes('sd', launches))}; GroupNorm calls by route "
          f"{json.dumps(GN_ROUTES)}", flush=True)
    check(C3.conv3x3_same.relays - relays == 2 * per_call["resblock"],
          "the ResBlock conv weights were not re-laid exactly once each")
    k = args.num_masks
    h, w = hpx // 8, wpx // 8
    fin = res.final_latents
    check(fin.shape == (2, k, t, h, w, 4), f"final latents shape {fin.shape}")
    check(np.isfinite(fin).all() and np.isfinite(res.feature_x0).all(), "latents not finite")
    check(res.seg_raw.shape == (t, hpx, wpx) and res.seg_filtered.shape == (t, hpx, wpx),
          f"label map shape {res.seg_raw.shape}")
    check(set(np.unique(res.seg_raw)) <= set(range(k)), "labels out of range")
    check(np.isfinite(res.diff_maps).all(), "difference maps not finite")
    dpm = float(np.abs(fin[0] - fin[1]).max())
    check(dpm > 0, "+lambda and -lambda runs are identical: modulation never reached the output")
    # the SD blend window ends at step 23: right after it the outside-mask cells
    # equal the cached trajectory, and the last step moves them again
    check(blend_end < args.num_steps - 1 and len(after_blend) == 1 + 2 * k,
          f"{len(after_blend)} passes entered step {blend_end + 1}, expected the feature pass and {2 * k} runs")
    ori = res.cached_xt[blend_end - res.cache_t0]
    pinned = torch.stack(after_blend[1:]).float().cpu().numpy().reshape(fin.shape)
    outside = max(float(np.abs((pinned[s, m] - ori) * (1 - res.masks_latent[m][..., None])).max())
                  for s in range(2) for m in range(k))
    check(outside == 0.0, f"outside-mask latents deviate from the cached trajectory by {outside}")
    inside = float(np.abs((pinned - ori[None, None]) * res.masks_latent[None, ..., None]).max())
    check(inside > 0, "inside-mask latents equal the cached trajectory: the runs were not modulated")
    print(f"[sd] max|+lambda - -lambda| = {dpm:.4f}; outside-mask deviation after step "
          f"{blend_end} = {outside} (inside {inside:.4f}); labels used "
          f"{sorted(int(v) for v in np.unique(res.seg_raw))}", flush=True)
    del pipe, res, after_blend
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def phase_train(torch):
    """TRAIN_STEPS steps of the full-width training setup after a warm-up."""
    from vidseg_diffusion_tpu_torch.scripts import train_path

    t0 = time.perf_counter()
    trainer = train_path.build()
    latents, cond = train_path.batch()
    gens = train_path.generators()
    unet = trainer.model
    n_params = sum(p.numel() for p in unet.parameters())
    print(f"[train] built the svd.yaml UNet ({n_params / 1e9:.3f} B params, bf16, remat "
          f"{unet.config.remat}), Adam, EMA in {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    loss = trainer.step(latents, cond, generators=gens)
    torch.cuda.synchronize()
    print(f"[train] warm-up step {time.perf_counter() - t0:.2f} s, loss {loss.item():.5f}", flush=True)
    check(bool(torch.isfinite(loss)), "warm-up loss not finite")

    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    losses, times = [], []
    for i in range(TRAIN_STEPS):
        if i == TRAIN_STEPS - 1:  # the weights and EMA before the step that check_last_update reads
            params0 = [p.detach().clone() for p in unet.parameters()]
            ema0 = {n: e.clone() for n, e in trainer.ema.params.items()}
        t0 = time.perf_counter()
        loss = trainer.step(latents, cond, generators=gens)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(loss.item())
    launches, plain_calls = read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"[train] {TRAIN_STEPS} steps: step_s {[round(x, 4) for x in times]}, losses "
          f"{[round(x, 6) for x in losses]}, peak device memory {peak_gb:.2f} GB ({card_line()})",
          flush=True)
    from vidseg_diffusion_tpu_torch.ops import norm as N

    print(f"[train] kernel launches {json.dumps(launches)}; plain calls {json.dumps(plain_calls)}; "
          f"GroupNorm input copies {N.group_norm.copies}", flush=True)

    check(all(math.isfinite(x) for x in losses), f"loss not finite: {losses}")
    missing = []
    for name, p in unet.named_parameters():
        if p.grad is None:
            missing.append(name)
            continue
        check(bool(torch.isfinite(p.grad).all()), f"gradient of {name} not finite")
    check(all(feeds_one_key_query(n) for n in missing), f"parameters without a gradient: {missing}")
    proj = [(n, p) for n, p in unet.named_parameters()
            if any(f"attn1.to_{x}." in n for x in "qkv") or "attn2.to_v." in n]
    n_temporal = sum(".time_stack." in n for n, _ in proj)
    check(n_temporal > 0 and len(proj) > n_temporal, "no spatial or temporal projections found")
    zero = [n for n, p in proj if p.grad is None or not bool(p.grad.abs().max() > 0)]
    check(not zero, f"attention projections with a zero gradient (a detached kernel?): {zero}")
    n_grad, n_due, n_moved = check_last_update(torch, trainer, params0, ema0)
    print(f"[train] {len(proj)} attention projections ({n_temporal} temporal) with non-zero gradients; "
          f"last step: {n_grad} parameters with a gradient took it, {n_due} were due to move by more "
          f"than a bf16 step and moved, {n_moved} moved in all; every EMA tensor updated", flush=True)
    check(all(launches[k] > 0 for k in TRAIN_KERNELS), f"a kernel of the training path never launched: {launches}")
    expected = {k: TRAIN_STEPS * n for k, n in train_launches(unet).items()}
    expected.update(group_norm_expected("train", expected.pop("group_norm")))
    check(launches == expected, f"training launches {launches}, expected {expected} "
                                f"({TRAIN_STEPS} steps of a remat UNet)")
    check(all(n == 0 for n in plain_calls.values()), f"plain versions ran on the card: {plain_calls}")
    print(f"[train] launches by route {json.dumps(check_routes('train', launches))}; GroupNorm calls by route "
          f"{json.dumps(GN_ROUTES)}", flush=True)
    del trainer, unet, params0, ema0
    torch.cuda.empty_cache()
    return launches


def phase_ae_grad(torch):
    """The full-width first stage's gradients under the autoencoder losses,
    on the card through the kernels (K3 with its LSE and K13 in the mid
    attentions, K7-K10 at every GroupNorm) vs the CPU through the plain
    versions; same fp32 weights, frames and posterior noise, TF32 off on the
    card. Two backward passes, held by norm:
    - the generator's reconstruction loss (L1 + LPIPS + KL) -> every
      first-stage parameter within GRAD_REL_TOL, the library convolutions
      without cuDNN;
    - the discriminator loss on the frames and the detached reconstruction
      plus the adversarial term -> every discriminator parameter within
      DISC_GRAD_TOL, with cuDNN.
    LPIPS and the discriminator run library ops only (no kernel of the
    port). Measured on the card in fp32 against the CPU: with cuDNN, LPIPS's
    unit normalization of VGG features moved the first stage's gradients by
    1.5e-3 of a norm (fp32 against fp64 on the CPU: 2.4e-5; without cuDNN
    3e-5); the discriminator's parameter gradients read 1.1e-3 with cuDNN and
    2e-3 without on the reconstruction's input (2e-6 on frames in [-1, 1]),
    and the data gradient it hands back to the reconstruction 2e-3, which is
    not compared."""
    import copy

    from vidseg_diffusion_tpu_torch.models.lpips import autoencoder_reconstruction_loss, generator_adv_loss
    from vidseg_diffusion_tpu_torch.models.regularizers import DiagonalGaussian
    from vidseg_diffusion_tpu_torch.ops import attention as A
    from vidseg_diffusion_tpu_torch.scripts import autoencoder_train_path as ae_path

    saved_tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    trainer, fs = ae_path.build(device="cuda", vae=ae_path.vae_config(torch.float32))
    card = (fs, trainer.lpips_fn, trainer.discriminator)
    cpu = tuple(copy.deepcopy(m) for m in card)
    for m in cpu[1:]:
        m.cpu()
    for m in cpu[0].modules().values():
        m.cpu()
    g = torch.Generator().manual_seed(5)
    x = torch.rand(2, 64, 64, 3, generator=g) * 2 - 1
    noise = torch.randn(2, 8, 8, 4, generator=g)
    cfg = trainer.cfg

    def grads(first_stage, lpips, disc, dev):
        xd = x.to(dev)
        torch.backends.cudnn.enabled = dev == "cpu"
        try:
            post = DiagonalGaussian.from_moments(first_stage.moments(xd))
            recon = first_stage.reconstruct(post.sample(noise.to(dev)))
            rec_loss = autoencoder_reconstruction_loss(lpips, xd, recon, post.kl(), cfg)[0]
            rec_loss.backward()
        finally:
            torch.backends.cudnn.enabled = True
        r = recon.detach()
        d_loss = trainer.d_loss_fn(disc(xd), disc(r)) + cfg.disc_weight * generator_adv_loss(disc(r))
        d_loss.backward()
        named = list(first_stage.modules().named_parameters()) + [(f"disc.{n}", p) for n, p in disc.named_parameters()]
        return (rec_loss.item(), d_loss.item()), {n: p.grad for n, p in named}

    launches = A.flash_attention.launches, A.flash_attention_backward.launches
    t0 = time.perf_counter()
    loss_card, g_card = grads(*card, "cuda")
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    check(A.flash_attention.launches - launches[0] == 2 and A.flash_attention_backward.launches - launches[1] == 2,
          "the card's autoencoder backward did not run K3 and K13 once per mid attention")
    t0 = time.perf_counter()
    loss_cpu, g_cpu = grads(*cpu, "cpu")
    cpu_s = time.perf_counter() - t0
    second = lambda n: n.startswith("disc.")
    passes = ({n: v for n, v in g_cpu.items() if not second(n)}, {n: v for n, v in g_cpu.items() if second(n)})
    worst = []
    for mine, tol in zip(passes, (GRAD_REL_TOL, DISC_GRAD_TOL)):   # each against its own largest norm
        floor = GRAD_FLOOR * max(gcpu.norm().item() for gcpu in mine.values())
        for name, gcpu in mine.items():
            gk = g_card[name]
            check(gk is not None and gcpu is not None, f"gradient missing for {name}")
            check(bool(torch.isfinite(gk).all()), f"gradient of {name} not finite on the card")
            rel = (gk.cpu() - gcpu).norm().item() / max(gcpu.norm().item(), floor)
            worst.append((rel / tol, rel, tol, name))
    over, rel, tol, name = max(worst)
    first = max(w for w in worst if w[2] == GRAD_REL_TOL)
    print(f"[ae_grad] full-width sd_2_1.yaml first stage fp32 at 64x64, LPIPS and the discriminator: "
          f"reconstruction / discriminator losses card {loss_card[0]:.6f} / {loss_card[1]:.6f} vs CPU "
          f"{loss_cpu[0]:.6f} / {loss_cpu[1]:.6f}; {len(g_cpu)} gradients, worst relative error by norm: "
          f"first stage {first[1]:.3e} ({first[3]}; tol {GRAD_REL_TOL:.0e}), overall {rel:.3e} ({name}; tol "
          f"{tol:.0e}); card {card_s:.1f} s, CPU {cpu_s:.1f} s", flush=True)
    for lk, lc in zip(loss_card, loss_cpu):
        check(abs(lk - lc) <= UNET_REL_TOL * abs(lc), "a loss on the card disagrees with the CPU")
    check(over <= 1.0, f"gradient of {name} on the card disagrees with the CPU: {rel} (tol {tol})")
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved_tf32
    del trainer, fs, card, cpu, g_card, g_cpu
    gc.collect()
    torch.cuda.empty_cache()


def ae_launches_per_step(fs):
    """Launches one autoencoder step implies: K3 and K13 once per mid
    attention (encoder and decoder, each on the whole batch); K7-K10 once per
    GroupNorm module of the first stage (no remat); nothing else (the VAE's,
    LPIPS's and the discriminator's convolutions are library calls in JAX too)."""
    from vidseg_diffusion_tpu_torch.models.layers import GroupNorm32

    n_gn = sum(isinstance(m, GroupNorm32) for mod in fs.modules().values() for m in mod.modules())
    return dict(flash_attention=2, flash_attention_backward=2, group_norm=n_gn,
                group_norm_backward_stats=n_gn, group_norm_backward_apply=n_gn)


def phase_ae_train(torch):
    """TRAIN_STEPS steps of the full-width autoencoder training setup after a
    warm-up; returns its kernel launches."""
    from vidseg_diffusion_tpu_torch.ops import norm as N
    from vidseg_diffusion_tpu_torch.scripts import autoencoder_train_path as ae_path

    t0 = time.perf_counter()
    trainer, fs = ae_path.build()
    x, noise = ae_path.batch(), ae_path.noise_generator()
    gen_named = lambda: fs.modules().named_parameters()
    disc = trainer.discriminator
    n_gen = sum(p.numel() for _, p in gen_named())
    n_disc = sum(p.numel() for p in disc.parameters())
    print(f"[ae_train] built the sd_2_1.yaml first stage ({n_gen / 1e6:.1f} M params), LPIPS, the discriminator "
          f"({n_disc / 1e6:.2f} M params), bf16, Adam x2 in {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    logs = trainer.step(x, 0, generator=noise)
    torch.cuda.synchronize()
    print(f"[ae_train] warm-up step {time.perf_counter() - t0:.2f} s, g_loss {logs['g_loss'].item():.5f}",
          flush=True)

    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    times, all_logs = [], []
    for i in range(TRAIN_STEPS):
        if i == TRAIN_STEPS - 1:  # the weights before the step that check_adam_step reads
            gen0 = [p.detach().clone() for _, p in gen_named()]
            disc0 = [p.detach().clone() for p in disc.parameters()]
        t0 = time.perf_counter()
        logs = trainer.step(x, i + 1, generator=noise)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        all_logs.append({k: v.item() for k, v in logs.items()})
    launches, plain_calls = read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"[ae_train] {TRAIN_STEPS} steps: step_s {[round(t, 4) for t in times]}, peak device memory "
          f"{peak_gb:.2f} GB ({card_line()})", flush=True)
    print(f"[ae_train] logs {json.dumps([{k: round(v, 6) for k, v in l.items()} for l in all_logs])}", flush=True)
    print(f"[ae_train] kernel launches {json.dumps(launches)}; plain calls {json.dumps(plain_calls)}; "
          f"GroupNorm input copies {N.group_norm.copies}", flush=True)

    check(all(math.isfinite(v) for l in all_logs for v in l.values()), f"a logged loss is not finite: {all_logs}")
    check(all(l["p_loss"] > 0 for l in all_logs), "the perceptual loss carries no signal")
    named = list(gen_named()) + [(f"disc.{n}", p) for n, p in disc.named_parameters()]
    for name, p in named:
        check(p.grad is not None, f"{name} has no gradient")
        check(bool(torch.isfinite(p.grad).all()), f"gradient of {name} not finite")
    attn = [(n, p) for n, p in gen_named() if ".mid.attn_1." in n and n.split(".")[-2] in "qkv"]
    check(len(attn) == 12, f"expected the q/k/v weights and biases of two mid attentions, got {len(attn)}")
    zero = [n for n, p in attn if n.endswith(".weight") and not bool(p.grad.abs().max() > 0)]
    check(not zero, f"mid-attention projections with a zero gradient (a detached kernel?): {zero}")
    gen_counts = check_adam_step(torch, trainer.gen_optimizer, gen_named(), gen0, trainer.step_count)
    disc_counts = check_adam_step(torch, trainer.disc_optimizer, disc.named_parameters(), disc0, trainer.step_count)
    print(f"[ae_train] last step: generator {gen_counts[0]} parameters with a gradient, {gen_counts[1]} due to "
          f"move and moved; discriminator {disc_counts[0]} with a gradient, {disc_counts[1]} due and moved",
          flush=True)
    expected = {k: 0 for k in launches}
    expected.update({k: TRAIN_STEPS * n for k, n in ae_launches_per_step(fs).items()})
    expected.update(group_norm_expected("ae_train", expected.pop("group_norm")))
    check(launches == expected, f"autoencoder launches {launches}, expected {expected} ({TRAIN_STEPS} steps)")
    check(all(n == 0 for n in plain_calls.values()), f"plain versions ran on the card: {plain_calls}")
    check_routes("ae_train", launches)
    del trainer, fs, gen0, disc0, named, attn
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def check_last_update(torch, trainer, params0, ema0):
    """The diffusion trainer's last step: check_adam_step on its model, and
    every EMA tensor is the LitEma update of its old value towards the new
    weights. Returns the counts of parameters with a gradient, due to move,
    and moved."""
    counts = check_adam_step(torch, trainer.optimizer, trainer.model.named_parameters(), params0,
                             trainer.step_count)
    n = trainer.ema.num_updates
    d = min(trainer.ema_decay, (1.0 + n) / (10.0 + n))
    for (name, p) in trainer.model.named_parameters():
        e0 = ema0[name]
        check(torch.equal(trainer.ema.params[name], e0 - (e0 - p.detach()) * (1.0 - d)),
              f"the EMA of {name} did not take the last step's update")
    return counts


def check_adam_step(torch, optimizer, named_params, params0, step_count):
    """An optimizer's last step against its Adam state and the weights from
    before it: every parameter with a gradient took all `step_count` steps,
    each of its elements whose update (recomputed in fp32 from the state)
    exceeds one bf16 step of the element's value changed, and every other
    parameter stayed. (An element's update can be smaller than half a bf16
    step: the q/k projections' gradients at N(0, 0.02) weights are ~1e-15,
    so Adam moves them by ~1e-11.) Returns the counts of parameters with a
    gradient, due to move, and moved."""
    group = optimizer.param_groups[0]
    lr, (b1, b2), eps = group["lr"], group["betas"], group["eps"]
    check(group["weight_decay"] == 0 and not group["amsgrad"], "check_adam_step reads plain Adam")
    n_grad = n_due = n_moved = 0
    for (name, p), p0 in zip(named_params, params0):
        moved = not torch.equal(p, p0)
        n_moved += moved
        if p.grad is None:
            check(not moved, f"{name} has no gradient but moved")
            continue
        n_grad += 1
        state = optimizer.state[p]
        check("step" in state, f"{name} has a gradient and no optimizer state")
        step = int(state["step"])
        check(step == step_count, f"{name} took {step} of {step_count} optimizer steps")
        update = (lr / (1 - b1 ** step) * state["exp_avg"].float()
                  / ((state["exp_avg_sq"].float() / (1 - b2 ** step)).sqrt() + eps))
        bf16_step = torch.exp2(torch.log2(p0.float().abs()).clamp(min=-126) - 7)
        due = update.abs() > bf16_step
        n_due += bool(due.any())
        check(bool((p[due] != p0[due]).all()), f"{name}: elements due to move by more than a bf16 step did not")
    return n_grad, n_due, n_moved


def main():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs an NVIDIA card")
    sys.path.insert(0, ROOT)
    from vidseg_diffusion_tpu_torch.ops import _cuda

    card = card_line()
    print(f"[card] {card}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    _cuda.load_library()
    print(f"[build] kernels built and loaded in {time.perf_counter() - t0:.1f} s", flush=True)
    log = os.path.join(_cuda.BUILD_DIR, "build.log")
    if os.path.isfile(log):  # ptxas's register / spill report of the last build
        with open(log) as f:
            ptxas = [line.strip() for line in f if "registers" in line or "spill" in line]
        regs = [int(s.split("Used ")[1].split()[0]) for s in ptxas if "Used " in s]
        spills = sum(int(s.split(" bytes spill stores")[0].split()[-1]) for s in ptxas if "spill stores" in s)
        print(f"[build] ptxas: {len(regs)} kernel instances, registers {min(regs)}-{max(regs)}, "
              f"spill stores {spills} bytes", flush=True)

    torch.nn.modules.module.register_module_forward_pre_hook(count_group_norm_route)
    phases = {}
    t0 = time.perf_counter()
    rows = phase_kernels(torch)
    phases["kernels"] = time.perf_counter() - t0
    for name, fn in (("unet", phase_unet), ("train_grad", phase_train_grad)):
        t0 = time.perf_counter()
        fn(torch)
        phases[name] = time.perf_counter() - t0
    t0 = time.perf_counter()
    launches, pipe, plain_res = phase_main(torch)
    phases["main"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    inject_launches = phase_inject(torch, pipe, plain_res)
    phases["inject"] = time.perf_counter() - t0
    del pipe, plain_res
    gc.collect()   # free the SVD models before the SD and training phases
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    sd_launches = phase_sd(torch)
    phases["sd"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    train_launches = phase_train(torch)
    phases["train"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    phase_ae_grad(torch)
    phases["ae_grad"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ae_launches = phase_ae_train(torch)
    phases["ae_train"] = time.perf_counter() - t0
    print(f"[phases] seconds {json.dumps({k: round(v, 1) for k, v in phases.items()})}", flush=True)

    kernels = []
    for name, meta in KERNELS.items():
        mine = [r for r in rows if r["kernel"] == name]
        head = next(r for r in mine if r["shape"] == HEADLINE[name])
        path_launches = (launches if name in INFERENCE_KERNELS
                         else ae_launches if name in AE_KERNELS else train_launches)
        # K1, K4 and K11: the launches of each path by the kernel that ran (checked); the
        # GroupNorm forward's routes are kernels of their own (K7 + K8, the fused K7+K8)
        routed = ({tag: ROUTE_COUNTS[tag][name] for tag in ("main", "inject", "sd", "train", "ae_train")}
                  if name in ROUTED else None)
        kernels.append(dict(
            name=name, route="cuda", source=meta["source"], replaces=meta["replaces"],
            # the run of its path: inference for K1-K4, K7, K8, K11, K12, diffusion training for
            # K5, K6, K9, K10, autoencoder training for K13
            launches=path_launches[name],
            inject_launches=inject_launches[name], sd_launches=sd_launches[name],
            train_launches=train_launches[name], ae_launches=ae_launches[name],
            max_abs_err=max(r["max_abs_err"] for r in mine), shape=head["shape"],
            ms=head["ms"], plain_ms=head["plain_ms"], bound_ms=head["bound_ms"],
            bound_by=head["bound_by"], library_ms=head["library_ms"],
            library_covers=head["library_covers"], routes=routed,
        ))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
