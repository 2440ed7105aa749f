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
   CFG batch of 28 beside SDPA, K5's at the training batch of 28 beside SDPA's backward; the
   normalise-first kernels of K1 (SD 2.1's cross-attention at 5824 and 1456 queries, 77 keys) and
   K3 (CLIP, D = 80) also held to mha_reference (one bf16 step, at most 0.1 % of the elements).
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
   the VAE's 3-channel conv_out_time_mix, which run the narrow kernel, and
   every K2 (and, in the train phase, K6) launch its tensor-core kernel (the
   wrappers' route counters, here and in the inject, sd, train and ae_train
   phases: also every K3 launch but CLIP's 32 on the wgmma kernel, CLIP's on
   the normalise-first mode, every K5 and K13 launch on the wgmma kernels);
   latents and labels must be finite and shaped; the +lambda and
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
   implies, K1's normalise-first mode at the 10 cross-attention sites with
   5824 or 1456 queries per UNet call, K2 and K4 never, no backward kernel
   and no plain version; finite
   latents and labels of the right shape, +lambda != -lambda, outside-mask
   latents equal to the cached trajectory right after the last blended step
   (read where they enter the next sampler step);
   stage seconds and peak device memory.
9. ae_grad: the full-width sd_2_1.yaml first stage (Encoder, quant convs,
   image Decoder) in fp32 on 2 frames of 64x64 (an 8x8 latent, a 64-token
   D = 512 mid attention) with LPIPS and the PatchGAN discriminator:
   backward passes of the reconstruction loss (L1 + LPIPS + KL) and of the
   discriminator loss with the adversarial term, on the card through the
   kernels (K7-K10; the 64-token mid attentions are "mha_reference" sites,
   which run mha_reference_site under a gradient, so no K3 or K13: route_probe
   holds K3 + K13 under autograd at a flash site) vs the CPU through the plain
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
12. route_probe (right after the kernels): ROADMAP section C on the card: a
   bf16 bhld D = 512 attention of 300 tokens runs mha_reference_site (no
   normalise-first kernel takes D = 512), within one bf16 step of the CPU
   mha_reference; a 40-dim "flash" site raises the named ValueError and
   launches nothing; a gradient through SD 2.1's 640 x 77 cross-attention
   site runs mha_reference_site, held to the CPU mha_reference's gradients;
   a gradient through a "flash" bhld site (fp32 [2,1,1024,512], the VAE mid
   attention of two 256x256 frames) runs K3 with its LSE and K13 once each,
   dq / dk / dv within GRAD_REL_TOL by norm of the CPU's.
13. sweep (after inject, on its pipeline): run_vspw_sweep through
   scripts/svd_pipeline_vspw.py at its defaults (20 k-means clusters matched
   to the GT, bf16, decoding_t 1) over a synthetic tree in a temp dir: A, 16
   frames of 448x832 -> windows (0,14), (2,16); B, 15 frames -> (0,14),
   (1,15); C, an empty origin/. GT labels 0, 3, 7 in three column blocks the
   frames' texture follows. Each window runs with the counts set to 0 and
   checked after it (check_window: the launches its K masks imply, by kernel
   and route, no plain version); the first window of a video is seeded by
   its GT, every later one by the state the previous one returned; labels
   within the GT's; videos_failed exactly [C]; the confusion matrix a numpy
   recount of the returned maps; mIoU in [0, 1]; a second call on the
   manifest skips A and B and runs nothing; the carried-state window's KNN
   on the card vs the CPU's (identical labels but at near-ties); seconds per
   window and per video, peak memory.
14. refine: one 14-frame window with match_gt_mask and is_refine_mask: the
   launches of a sweep window, the refined masks vs the CPU
   correct_low_res_mask on the same features and masks.
15. sweep_sd (after sd, on its pipeline): scripts/sd_pipeline_vspw.py at its
   defaults over video A: the same checks, K1's normalise-first launches
   among the routes.
16. tiny (after route_probe): configs/inference/svd_tiny.yaml as shipped
   (16-dim heads) through run_single_video on the main path's frames and
   settings in bf16: every K1 and K2 launch at D = 16 (the wrappers'
   .dim_launches), K1 on the mma.sync template, K3 at D = 16 at its CLIP
   tower in the normalise-first mode (.normalised_dim_launches), no plain
   version, finite outputs.
17. inversion (after inject, on its pipeline): the main path with
   inversion_type 'inversion' and is_injected_features: 94 UNet calls (25 to
   invert, 25 in the feature pass, 44 in the runs), the cache window t0 = 0
   with 25 steps and its q/k bytes, 288 injected sites, the launches by kernel
   and route those calls imply, finite outputs, +lambda != -lambda,
   outside-mask latents pinned; the inversion's seconds, stage seconds, peak
   memory.
18. vae_time_mode (last): svd.yaml's VideoDecoder at time_mode 'all' and
   'attn-only' with seeded random weights, 14 latents of 56x104 decoded at
   decoding_t 7 in bf16: K1 and K2 at one 512-dim head (K3's wgmma kernel,
   the wide kernel) and K3 twice a decode, every launch reckoned; then fp32
   card vs CPU at 2 frames of 32x32 latents.
The kernel phase also holds the instances at the head dims the tuned kernels
are not built for (D = 16: K1, K2, K3, K5, K6, K13; one 512-dim head: K1, K2)
against their plain versions in bf16 and fp32, and the normalise-first mode
of K1 and K3 at D = 16 in bf16, also held to mha_reference.

Before the last line come the kernels JSON (per kernel: launches in the run
of its path and in the other runs (injected, SD, diffusion training,
autoencoder training, the SVD and SD sweeps summed over their windows, the
inversion run, the two VideoDecoder decodes summed, the tiny run; a head-dim
instance's at its D, its `path` naming the run of its `launches`), for
K1-K6, K11 and K13 the launches of each run by the kernel that ran
(`routes`), worst error, kernel, plain, bound and library-call ms at its
headline shape; the normalise-first kernels of K1 and K3 as entries of their
own at each D (D = 64 and 80: their path the SD run and the main run; D =
16: K3's the tiny run), counted apart from the other launches at that D; K5 also
at the training batch) and the card's name and power limit; the last line
is {"ok": true, "device": ...}.
"""

import dataclasses
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
    # the normalise-first kernels of K1 (D = 64) and K3 (D = 80): the sites that
    # JAX's TPU dispatch sends to no Pallas kernel but to mha_reference (:75,
    # dispatched at :1644); the wrappers' .normalised_dim_launches count them at
    # their head dim in the run of their `path`
    "flash_attention_packed_normalised": dict(
        id="K1 normalise-first", source="vidseg_diffusion_tpu_torch/csrc/flash_attention.cu",
        replaces="vidseg_diffusion_tpu/ops/attention.py:75", rms_tol=4e-3, wrapper="flash_attention_packed",
        dim=64, path="sd", normalised=True,
    ),
    "flash_attention_normalised": dict(
        id="K3 normalise-first", source="vidseg_diffusion_tpu_torch/csrc/flash_attention.cu",
        replaces="vidseg_diffusion_tpu/ops/attention.py:75", rms_tol=4e-3, wrapper="flash_attention",
        dim=80, path="main", normalised=True,
    ),
}
# the instances at the head dims the tuned kernels are not built for (ROADMAP
# section C): entries of their own, on the wrapper of the kernel they instance,
# their launches counted by head dim (the wrappers' .dim_launches) in the run of
# their `path`: the tiny phase (svd_tiny.yaml as shipped, 16-dim heads), the
# vae_time_mode phase (the VideoAttnBlock's one 512-dim head); no path runs the
# D = 16 backwards (K13 at D = 16 is K5's D = 16 instance on K3's strides). The
# normalise-first D = 16 instances (`normalised`) count their wrapper's
# .normalised_dim_launches, the others the rest of its launches at that D: the
# tiny config's K3 launches at D = 16 are its CLIP tower's, all normalise-first
_CSRC, _JAX = "vidseg_diffusion_tpu_torch/csrc/", "vidseg_diffusion_tpu/ops/attention.py:"
for _name, _id, _src, _line, _tol, _wrapper, _dim, _path in (
    ("flash_attention_packed_d16", "K1 D=16", "flash_attention.cu", 527, 4e-3, "flash_attention_packed", 16, "tiny"),
    ("temporal_attention_direct_d16", "K2 D=16", "temporal_attention.cu", 1458, 1e-3, "temporal_attention_direct", 16,
     "tiny"),
    ("flash_attention_d16", "K3 D=16", "flash_attention.cu", 297, 4e-3, "flash_attention", 16, None),
    ("flash_attention_normalised_d16", "K3 normalise-first D=16", "flash_attention.cu", 75, 4e-3, "flash_attention",
     16, "tiny"),
    ("flash_attention_packed_normalised_d16", "K1 normalise-first D=16", "flash_attention.cu", 75, 4e-3,
     "flash_attention_packed", 16, None),
    ("flash_attention_packed_backward_d16", "K5 D=16", "flash_attention_bwd.cu", 993, 1e-3,
     "flash_attention_packed_backward", 16, None),
    ("temporal_attention_direct_backward_d16", "K6 D=16", "temporal_attention_bwd.cu", 1167, 2e-4,
     "temporal_attention_direct_backward", 16, None),
    ("flash_attention_backward_d16", "K13 D=16", "flash_attention_bwd.cu", 1025, 1e-3,
     "flash_attention_packed_backward", 16, None),
    ("flash_attention_packed_d512", "K1 D=512 one head", "flash_attention.cu", 527, 4e-3, "flash_attention_packed",
     512, "vae_time_mode"),
    ("temporal_attention_direct_d512", "K2 D=512", "temporal_attention.cu", 1458, 1e-3, "temporal_attention_direct",
     512, "vae_time_mode"),
):
    KERNELS[_name] = dict(id=_id, source=_CSRC + _src, replaces=_JAX + str(_line), rms_tol=_tol, wrapper=_wrapper,
                          dim=_dim, path=_path, normalised="normalised" in _name)
INFERENCE_KERNELS = ("flash_attention_packed", "temporal_attention_direct", "flash_attention",
                     "temporal_conv_1x1", "group_norm_stats", "group_norm_apply", "group_norm_fused",
                     "matmul_bias", "conv3x3_same")
TRAIN_KERNELS = ("flash_attention_packed", "temporal_attention_direct", "temporal_conv_1x1",
                 "flash_attention_packed_backward", "temporal_attention_direct_backward",
                 "group_norm_stats", "group_norm_apply", "group_norm_fused", "group_norm_backward_stats",
                 "group_norm_backward_apply", "matmul_bias", "conv3x3_same")
AE_KERNELS = ("flash_attention_backward",)   # the kernels whose path is autoencoder training
# the normalise-first launches of a path: CLIP's 32 layers once a video (K3 at D
# = 80); the SD 2.1 UNet's 10 cross-attention sites with 5824 or 1456 queries
# and 77 keys (two input and three output blocks at ds1 and at ds2) per UNet call
MAIN_NORMALISED = {"flash_attention": 32}
SD_NORMALISED_PER_UNET = {"flash_attention_packed": 10}
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
# q and k of the 9 attention-bearing output blocks on the [uc; c] batch of 28
# frames, bf16: three blocks each at 5824 x 320, 1456 x 640 and 364 x 1280
# tokens x channels, per cached step
INJECT_BYTES_PER_STEP = 2 * 28 * 2 * 3 * (5824 * 320 + 1456 * 640 + 364 * 1280)
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
#   1.4e-4 (its dx launch included), K2 3.4e-5 to 3.9e-5 (0 on CUDA cores
#   before its tensor-core kernel summed in another order), K5 4.8e-5 to
#   2.2e-4, K6 2.4e-5 to 5.3e-5, K13 2.4e-5 to 3.6e-4 (worst of dq/dk/dv; K5's
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
MHA_DIFFERING = 1e-3    # share of the elements a normalise-first output may differ from mha_reference's
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
    "flash_attention_packed_normalised": "SD cross ds1 [28,5824x77,5x64]",
    "flash_attention_normalised": "CLIP ViT-H [1,16,257,80]",
    "flash_attention_packed_d16": "tiny ds1 B=2 slice [2,5824,2x16] bf16",
    "temporal_attention_direct_d16": "tiny ds1 [28,5824,2,16] t=14 bf16",
    "flash_attention_d16": "tiny CLIP [1,4,257,16] bf16",
    "flash_attention_normalised_d16": "tiny CLIP [1,4,257,16]",
    "flash_attention_packed_normalised_d16": "[2,640x77,4x16]",
    "flash_attention_packed_backward_d16": "tiny ds1 B=2 slice [2,5824,2x16] bf16",
    "temporal_attention_direct_backward_d16": "tiny ds1 [28,5824,2,16] t=14 bf16",
    "flash_attention_backward_d16": "[2,2,1024,16] bf16",
    "flash_attention_packed_d512": "VideoAttnBlock attn2 [7,5824,1x512] bf16",
    "temporal_attention_direct_d512": "VideoAttnBlock time mix [7,5824,1,512] t=7 bf16",
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

    # K1's denominator at a site, as small_batched_attention picks it: the fp32
    # sum of the p where max(Lq, Lk) < SHORT_SEQ, the rounded p's sum elsewhere
    rounded = lambda lq, lk: max(lq, lk) >= A.SHORT_SEQ

    def k1(lq, lk):
        return (lambda q, k, v, h: A.flash_attention_packed(q, k, v, h, psum_rounded=rounded(lq, lk)),
                lambda q, k, v, h: A.flash_attention_packed_reference(q, k, v, h, psum_rounded=rounded(lq, lk)))

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
            out, lse = A._flash_attention_packed_forward(q, k, v, h, None, save_lse=True,
                                                         psum_rounded=rounded(l, l))
            _, lse_ref = A.flash_attention_packed_reference(q, k, v, h, save_lse=True, psum_rounded=rounded(l, l))
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
            _, lse = A._flash_attention_packed_forward(q, k, v, h, None, save_lse=True,
                                                       psum_rounded=rounded(l, lk))
            _, lse_ref = A.flash_attention_packed_reference(q, k, v, h, save_lse=True,
                                                            psum_rounded=rounded(l, lk))
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
        kern, plain = k1(l, l)
        add(kernel="flash_attention_packed", label=label, make=packed(b, l, h), kern=kern, plain=plain, iters=3,
            work=attn_work(b, h, l, l, 64),
            library=lambda q, k, v, h: (lambda a=[heads_view(x, h) for x in (q, k, v)]: sdpa(*a)))
    # K1 at the SD 2.1 cross-attention's mid site: 77 context tokens at 91
    # queries, the whole CFG batch, on the tiny-seq kernel's fp32 sum (its LSE
    # checked too); the headline shape at the CFG batch of the main path (no
    # plain comparison at B = 28: see above) is timed in phase_kernels
    for label, l, h in (("SD cross mid [28,91x77,20x64]", 91, 20),):
        kern, plain = k1(l, 77)
        add(kernel="flash_attention_packed", label=label, make=packed_lse(28, l, h, 77), kern=kern, plain=plain,
            iters=3, work=attn_work(28, h, l, 77, 64),
            library=lambda q, k, v, h: (lambda a=[heads_view(x, h) for x in (q, k, v)]: sdpa(*a)))
    # the normalise-first kernels at the sites JAX's TPU dispatch sends to
    # mha_reference: the SD 2.1 cross-attention at 5824 and 1456 queries (K1, 77
    # keys, one key tile), CLIP ViT-H (K3 at D = 80, 257 keys: two walks over the
    # keys); each also held to mha_reference on the same inputs (`reference`)
    packed_mha = lambda q, k, v, h: A.mha_reference(
        *(x.view(x.shape[0], x.shape[1], h, 64) for x in (q, k, v)), layout="blhd").reshape(q.shape)
    for label, l, h in (("SD cross ds1 [28,5824x77,5x64]", 5824, 5), ("SD cross ds2 [28,1456x77,10x64]", 1456, 10)):
        add(kernel="flash_attention_packed_normalised", label=label, make=packed(28, l, h, 77),
            kern=lambda q, k, v, h: A.flash_attention_packed(q, k, v, h, normalise_first=True),
            plain=lambda q, k, v, h: A.flash_attention_packed_reference(q, k, v, h, normalise_first=True),
            reference=packed_mha, iters=3, work=attn_work(28, h, l, 77, 64),
            library=lambda q, k, v, h: (lambda a=[heads_view(x, h) for x in (q, k, v)]: sdpa(*a)))
    add(kernel="flash_attention_normalised", label="CLIP ViT-H [1,16,257,80]", make=bhld(1, 16, 257, 80),
        kern=lambda q, k, v: A.flash_attention(q, k, v, normalise_first=True),
        plain=lambda q, k, v: A.flash_attention_reference(q, k, v, normalise_first=True),
        reference=A.mha_reference, iters=5, work=attn_work(1, 16, 257, 257, 80),
        library=lambda q, k, v: (lambda: sdpa(q, k, v)))
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
    return cases + head_dim_cases(torch, rn) + group_norm_cases(torch, rn) + gemm_cases(torch, rn)


def head_dim_cases(torch, rn):
    """The instances at the head dims the tuned kernels are not built for, in
    bf16 and fp32 (ROADMAP section C): D = 16 at svd_tiny.yaml's sites at the
    main path's 448x832 (CFG batch 28: ds1 5824 tokens x 2 heads, ds2 1456 x 4,
    the tiny CLIP tower's 257 tokens x 4 heads; K1 and K5 at ds1 on a B = 2
    slice, as the D = 64 cases), their backwards, K13 at D = 16 (K5's instance
    on K3's strides); D = 512 at the VideoDecoder VideoAttnBlock's sites of
    svd.yaml's decode (decoding_t 7 and 14: attn2 [bt, 5824, 1 x 512] through
    K1, the time mix [bt, 5824, 1, 512] through K2). Library: SDPA on the
    [B, H, L, D] views (K2: the [b, s, H, t, D] view)."""
    import torch.nn.functional as F

    from vidseg_diffusion_tpu_torch.ops import attention as A

    sdpa = F.scaled_dot_product_attention
    heads = lambda x, h: x.view(x.shape[0], x.shape[1], h, x.shape[2] // h).transpose(1, 2)
    frames = lambda x, t: x.view(x.shape[0] // t, t, *x.shape[1:]).permute(0, 2, 3, 1, 4)

    def sdpa_backward(qkv, g):
        leaves = [x.detach().requires_grad_() for x in qkv]
        out = sdpa(*leaves)
        return lambda: torch.autograd.grad(out, leaves, g, retain_graph=True)

    cases = []
    for dtype, dname in ((torch.bfloat16, "bf16"), (torch.float32, "fp32")):
        # the input makers bind this loop's dtype (and are bound as defaults where they run later)
        mk = lambda *shapes, dtype=dtype: (lambda: tuple((rn(*s) * 1.5).to(dtype) for s in shapes))
        for label, b, l, h in (("tiny ds1 B=2 slice [2,5824,2x16]", 2, 5824, 2), ("tiny ds2 [28,1456,4x16]", 28, 1456, 4)):
            add = dict(iters=3, work=attn_work(b, h, l, l, 16, dtype=dname))
            cases.append(dict(kernel="flash_attention_packed_d16", label=f"{label} {dname}",
                              make=lambda b=b, l=l, h=h, mk=mk: mk(*[(b, l, h * 16)] * 3)() + (h,),
                              kern=lambda q, k, v, h: A.flash_attention_packed(q, k, v, h),
                              plain=lambda q, k, v, h: A.flash_attention_packed_reference(q, k, v, h),
                              library=lambda q, k, v, h: (lambda a=[heads(x, h) for x in (q, k, v)]: sdpa(*a)), **add))

            def k5_make(b=b, l=l, h=h, mk=mk):
                q, k, v, g = mk(*[(b, l, h * 16)] * 4)()
                out, lse = A._flash_attention_packed_forward(q, k, v, h, None, save_lse=True)
                return q, k, v, out, lse, g, h

            cases.append(dict(kernel="flash_attention_packed_backward_d16", label=f"{label} {dname}", make=k5_make,
                              kern=A.flash_attention_packed_backward,
                              plain=A.flash_attention_packed_backward_reference, iters=3,
                              work=attn_work(b, h, l, l, 16, backward=True, dtype=dname),
                              library=lambda q, k, v, o, lse, g, h: sdpa_backward([heads(x, h) for x in (q, k, v)],
                                                                                  heads(g, h))))
        for label, s, h in (("tiny ds1 [28,5824,2,16] t=14", 5824, 2), ("tiny ds2 [28,1456,4,16] t=14", 1456, 4)):
            cases.append(dict(kernel="temporal_attention_direct_d16", label=f"{label} {dname}",
                              make=mk(*[(28, s, h, 16)] * 3),
                              kern=lambda q, k, v: A.temporal_attention_direct(q, k, v, t=14),
                              plain=lambda q, k, v: A.temporal_attention_direct_reference(q, k, v, t=14), iters=3,
                              work=attn_work(2 * s, h, 14, 14, 16, dtype=dname),
                              library=lambda q, k, v: (lambda a=[frames(x, 14) for x in (q, k, v)]: sdpa(*a))))

            def k6_make(s=s, h=h, mk=mk):
                q, k, v, g = mk(*[(28, s, h, 16)] * 4)()
                return q, k, v, A.temporal_attention_direct(q, k, v, t=14), g

            cases.append(dict(kernel="temporal_attention_direct_backward_d16", label=f"{label} {dname}", make=k6_make,
                              kern=lambda q, k, v, o, g: A.temporal_attention_direct_backward(q, k, v, o, g, t=14),
                              plain=lambda q, k, v, o, g: A.temporal_attention_direct_backward_reference(
                                  q, k, v, o, g, t=14), iters=3,
                              work=attn_work(2 * s, h, 14, 14, 16, backward=True, dtype=dname),
                              library=lambda q, k, v, o, g: sdpa_backward([frames(x, 14) for x in (q, k, v)],
                                                                          frames(g, 14))))
        if dtype == torch.bfloat16:
            # the normalise-first mode at D = 16 (bf16 only, as at D = 64 and 80): the tiny CLIP tower's
            # 257 tokens (K3) and a 77-key cross-attention (K1), each also held to mha_reference
            packed_mha = lambda q, k, v, h: A.mha_reference(
                *(x.view(x.shape[0], x.shape[1], h, 16) for x in (q, k, v)), layout="blhd").reshape(q.shape)
            cases.append(dict(kernel="flash_attention_normalised_d16", label="tiny CLIP [1,4,257,16]",
                              make=mk(*[(1, 4, 257, 16)] * 3),
                              kern=lambda q, k, v: A.flash_attention(q, k, v, normalise_first=True),
                              plain=lambda q, k, v: A.flash_attention_reference(q, k, v, normalise_first=True),
                              reference=A.mha_reference, iters=5, work=attn_work(1, 4, 257, 257, 16),
                              library=lambda q, k, v: (lambda: sdpa(q, k, v))))
            cases.append(dict(kernel="flash_attention_packed_normalised_d16", label="[2,640x77,4x16]",
                              make=lambda mk=mk: mk((2, 640, 64), (2, 77, 64), (2, 77, 64))() + (4,),
                              kern=lambda q, k, v, h: A.flash_attention_packed(q, k, v, h, normalise_first=True),
                              plain=lambda q, k, v, h: A.flash_attention_packed_reference(q, k, v, h,
                                                                                          normalise_first=True),
                              reference=packed_mha, iters=5, work=attn_work(2, 4, 640, 77, 16),
                              library=lambda q, k, v, h: (lambda a=[heads(x, h) for x in (q, k, v)]: sdpa(*a))))
        for label, shape in (("tiny CLIP [1,4,257,16]", (1, 4, 257, 16)), ("[2,2,1024,16]", (2, 2, 1024, 16))):
            b, h, l, d = shape
            cases.append(dict(kernel="flash_attention_d16", label=f"{label} {dname}", make=mk(shape, shape, shape),
                              kern=A.flash_attention, plain=A.flash_attention_reference, iters=5,
                              work=attn_work(b, h, l, l, d, dtype=dname), library=lambda q, k, v: (lambda: sdpa(q, k, v))))

        def k13_make(shape=(2, 2, 1024, 16), mk=mk):
            q, k, v, g = mk(*[shape] * 4)()
            out, lse = A._flash_attention_forward(q, k, v, None, save_lse=True)
            return q, k, v, out, lse, g

        cases.append(dict(kernel="flash_attention_backward_d16", label=f"[2,2,1024,16] {dname}", make=k13_make,
                          kern=A.flash_attention_backward, plain=A.flash_attention_backward_reference, iters=3,
                          work=attn_work(2, 2, 1024, 1024, 16, backward=True, dtype=dname),
                          library=lambda q, k, v, o, lse, g: sdpa_backward([q, k, v], g)))
        for label, b in (("VideoAttnBlock attn2 [7,5824,1x512]", 7), ("VideoAttnBlock attn2 [14,5824,1x512]", 14)):
            cases.append(dict(kernel="flash_attention_packed_d512", label=f"{label} {dname}",
                              make=lambda b=b, mk=mk: mk(*[(b, 5824, 512)] * 3)() + (1,),
                              kern=lambda q, k, v, h: A.flash_attention_packed(q, k, v, h),
                              plain=lambda q, k, v, h: A.flash_attention_packed_reference(q, k, v, h),
                              iters=2, work=attn_work(b, 1, 5824, 5824, 512, dtype=dname),
                              library=lambda q, k, v, h: (lambda a=[heads(x, 1) for x in (q, k, v)]: sdpa(*a))))
        for label, t in (("VideoAttnBlock time mix [7,5824,1,512] t=7", 7),
                         ("VideoAttnBlock time mix [14,5824,1,512] t=14", 14)):
            cases.append(dict(kernel="temporal_attention_direct_d512", label=f"{label} {dname}",
                              make=mk(*[(t, 5824, 1, 512)] * 3),
                              kern=lambda q, k, v, t=t: A.temporal_attention_direct(q, k, v, t=t),
                              plain=lambda q, k, v, t=t: A.temporal_attention_direct_reference(q, k, v, t=t), iters=5,
                              work=attn_work(5824, 1, t, t, 512, dtype=dname),
                              library=lambda q, k, v, t=t: (lambda a=[frames(x, t) for x in (q, k, v)]: sdpa(*a))))
    return cases


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
        if "reference" in case:
            held_to_mha_reference(torch, KERNELS[kname]["id"], label, out, case["reference"](*args))
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
    return rows, k5_at_train_batch(torch)


def held_to_mha_reference(torch, kid, label, out, ref):
    """The normalise-first route against mha_reference on the same inputs: every
    element within one bf16 step at max |ref|, at most MHA_DIFFERING of the
    elements differing (the CPU tests' bound; the flash sums put 56-61 % a step
    off)."""
    diff = (out.float() - ref.float()).abs()
    step = 2.0 ** (math.floor(math.log2(ref.float().abs().max().item())) - 7)
    frac = (diff > 0).float().mean().item()
    print(f"[kernels] {kid} {label} vs mha_reference: max {diff.max().item() / step:.2f} bf16 steps (tol 1), "
          f"{frac:.2e} of the elements differ (tol {MHA_DIFFERING:.0e})", flush=True)
    check(diff.max().item() <= step and frac <= MHA_DIFFERING, f"{kid} {label} departs from mha_reference")


def k5_at_train_batch(torch):
    """K5 at the training path's ds1 batch [28,5824,5x64] (the kernel cases
    compare a B = 2 slice: the plain backward holds several [B, H, L, L] fp32
    tensors): kernel and SDPA-backward times beside the bound, finite
    gradients. Returns the row."""
    from vidseg_diffusion_tpu_torch.ops import attention as A

    g = torch.Generator(device="cuda").manual_seed(7)
    q, k, v, go = (torch.randn(28, 5824, 320, generator=g, device="cuda").to(torch.bfloat16) for _ in range(4))
    out, lse = A._flash_attention_packed_forward(q, k, v, 5, None, save_lse=True)
    grads = A.flash_attention_packed_backward(q, k, v, out, lse, go, 5)
    check(all(bool(torch.isfinite(x).all()) for x in grads), "K5 at [28,5824,5x64] is not finite")
    ms = time_ms(lambda: A.flash_attention_packed_backward(q, k, v, out, lse, go, 5), 3)
    hv = lambda x: x.view(28, 5824, 5, 64).transpose(1, 2)
    leaves = [hv(x).detach().requires_grad_() for x in (q, k, v)]
    y = torch.nn.functional.scaled_dot_product_attention(*leaves)
    lib = time_ms(lambda: torch.autograd.grad(y, leaves, hv(go), retain_graph=True), 3)
    nbytes, flops, peak = attn_work(28, 5, 5824, 5824, 64, backward=True)
    bound = max(nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[peak]) * 1e3
    print(f"[kernels] K5 flash_attention_packed_backward ds1 at the training batch [28,5824,5x64] (time only): "
          f"kernel {ms:.3f} ms, library {lib:.3f} ms, bound {bound:.3f} ms by operations", flush=True)
    del q, k, v, go, out, lse, grads, leaves, y
    torch.cuda.empty_cache()
    return dict(shape="ds1 training batch [28,5824,5x64]", ms=ms, library_ms=lib, bound_ms=bound)


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
# (`.wgmma_launches`, `.narrow_launches`, `.mma_launches`, reported by the C
# entry, and `.normalised_launches`, the normalise-first mode): on every path
# each launch of K1 (D = 64), K11 (bf16 projections), K5 and K13 (bf16 D = 512)
# takes the wgmma kernel, each of K4 too but the narrow_launches the path
# implies (the VAE's 3-channel conv_out_time_mix, once per decoder call), each
# of K3 but CLIP's (the normalise-first mma.sync kernel at D = 80), and each of
# K2 and K6 (bf16 everywhere) the tensor-core (mma.sync) kernel; K1 and K3 run
# the normalise-first mode exactly at the sites MAIN_NORMALISED and
# SD_NORMALISED_PER_UNET count
ROUTED = ("flash_attention_packed", "flash_attention", "temporal_conv_1x1", "matmul_bias",
          "temporal_attention_direct", "temporal_attention_direct_backward", "flash_attention_packed_backward",
          "flash_attention_backward")
ROUTE_NAMES = ("wgmma", "narrow", "mma", "normalised", "wide")
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
    from vidseg_diffusion_tpu_torch.ops import attention as A
    from vidseg_diffusion_tpu_torch.ops import norm as N

    counters, plains = kernel_fns()
    for f in counters:
        f.launches = 0
        for route in ROUTE_NAMES:
            if hasattr(f, f"{route}_launches"):
                setattr(f, f"{route}_launches", 0)
        for attr in ("dim_launches", "normalised_dim_launches"):
            if hasattr(f, attr):
                getattr(f, attr).clear()
    for f in plains:
        f.calls = 0
    A.mha_reference_site.calls = 0
    N.group_norm.copies = 0
    GN_ROUTES.update(fused=0, stream=0)


def read_routes():
    """{kernel: {route: launches}} for the route-counting wrappers."""
    counters, _ = kernel_fns()
    return {f.__name__: {r: getattr(f, f"{r}_launches") for r in ROUTE_NAMES if hasattr(f, f"{r}_launches")}
            for f in counters if f.__name__ in ROUTED}


ROUTE_COUNTS = {}   # phase -> read_routes() after its run
DIM_COUNTS = {}     # phase -> {attention wrapper (".normalised": its normalise-first launches): {head dim: launches}}


def read_dims():
    from vidseg_diffusion_tpu_torch.ops import attention as A

    dims = {f.__name__: dict(f.dim_launches) for f in A.KERNEL_COUNTERS}
    dims.update({f"{f.__name__}.normalised": dict(f.normalised_dim_launches)
                 for f in A.KERNEL_COUNTERS if hasattr(f, "normalised_dim_launches")})
    return dims


def check_routes(tag, launches, narrow=0, normalised=None):
    """Every K1, K11, K5 and K13 launch of the run took the wgmma kernel (none
    the mma.sync tile or an FMA kernel), every K3 launch but the `normalised`
    ones (CLIP's, on the mma.sync kernel), every K4 launch but `narrow` of
    them, which took the narrow kernel, and every K2 and K6 launch the
    tensor-core kernel (none the fp32 CUDA-core one); K1 and K3 ran the
    normalise-first mode `normalised[name]` times ({kernel: launches}); keeps
    and returns the route counts."""
    routes = read_routes()
    normalised = normalised or {}
    want = {name: {"wgmma": launches[name]} for name in ("matmul_bias", "flash_attention_packed_backward",
                                                          "flash_attention_backward")}
    want["flash_attention_packed"] = {"wgmma": launches["flash_attention_packed"], "mma": 0,
                                      "normalised": normalised.get("flash_attention_packed", 0)}
    nf3 = normalised.get("flash_attention", 0)
    want["flash_attention"] = {"wgmma": launches["flash_attention"] - nf3, "normalised": nf3}
    want["temporal_conv_1x1"] = {"wgmma": launches["temporal_conv_1x1"] - narrow, "narrow": narrow}
    want["temporal_attention_direct"] = {"mma": launches["temporal_attention_direct"], "wide": 0}
    want["temporal_attention_direct_backward"] = {"mma": launches["temporal_attention_direct_backward"]}
    got = {name: routes[name] for name in ROUTED}
    check(got == want, f"[{tag}] launches by route {got}, expected {want}")
    ROUTE_COUNTS[tag] = routes
    DIM_COUNTS[tag] = read_dims()
    for name in ("flash_attention_packed", "flash_attention"):
        check(sum(DIM_COUNTS[tag][f"{name}.normalised"].values()) == routes[name]["normalised"],
              f"[{tag}] {name}: normalise-first launches by head dim {DIM_COUNTS[tag][f'{name}.normalised']}, "
              f"{routes[name]['normalised']} in all")
    return routes


def sum_dims(runs):
    """read_dims() of several runs, summed."""
    out = {}
    for dims in runs:
        for w, by_dim in dims.items():
            mine = out.setdefault(w, {})
            for d, n in by_dim.items():
                mine[d] = mine.get(d, 0) + n
    return out


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
    reckoned = window_launches(pipe, True, MAIN_CALLS)[0]   # the sweep's per-window reckoning, at these calls
    check(all(reckoned[k] == n for k, n in MAIN_LAUNCHES.items()),
          f"window_launches {reckoned} disagrees with MAIN_LAUNCHES {MAIN_LAUNCHES}")
    expected = {name: MAIN_LAUNCHES.get(name, 0) for name in launches}
    expected.update(group_norm_expected(tag, by_module.pop("group_norm")), **by_module)
    check(launches == expected, f"inference launches {launches}, expected {expected} (modules "
                                f"per call {per_call}; no backward)")
    check(all(n == 0 for n in plain_calls.values()), f"plain versions ran on the card: {plain_calls}")
    narrow = MAIN_CALLS["decoder"] * narrow_tconv_sites(pipe.first_stage.decoder)
    print(f"[{tag}] launches by route {json.dumps(check_routes(tag, launches, narrow, MAIN_NORMALISED))}; "
          f"GroupNorm calls by route {json.dumps(GN_ROUTES)}", flush=True)
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

    per_step = INJECT_BYTES_PER_STEP   # reckoned before the run
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


INVERSION_CALLS = {"unet": 25 + 25 + 4 * 11, "encoder": 3, "decoder": 8}   # invert, feature pass, 4 runs of 11


def phase_inversion(torch, pipe):
    """The main path with inversion_type 'inversion' and is_injected_features
    (scripts/main_path.py's third configuration): the latents inverted over all
    25 steps, the feature pass from step 0, so its q/k cache holds 25 steps; the
    UNet calls (a pre-hook counts them: 25 + 25 + 44), the cache window t0 = 0
    and its bytes, the injected sites, the launches by kernel and route those
    calls imply, finite outputs, +lambda != -lambda, outside-mask latents
    pinned; the inversion's own seconds, the stage seconds and peak memory."""
    import numpy as np

    from vidseg_diffusion_tpu_torch.engine import vidseg as V
    from vidseg_diffusion_tpu_torch.ops import attention as A
    from vidseg_diffusion_tpu_torch.pipelines.single_video import run_single_video
    from vidseg_diffusion_tpu_torch.scripts import main_path

    calls = {"unet": 0}
    hook = pipe.unet.register_forward_pre_hook(lambda *a: calls.update(unet=calls["unet"] + 1))
    invert, invert_s = V.VidSegEngine.invert, {}

    def timed_invert(self, *a):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = invert(self, *a)
        torch.cuda.synchronize()
        invert_s.update(s=time.perf_counter() - t0, unet_calls=calls["unet"])
        return out

    V.VidSegEngine.invert = timed_invert
    args = main_path.vidseg_args(is_injected_features=True, inversion_type="inversion")
    timings = {}
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    try:
        t0 = time.perf_counter()
        res = run_single_video(pipe, main_path.frames(), main_path.frame_names(), args, write_outputs=False,
                               timings=timings)
        total = time.perf_counter() - t0
    finally:
        V.VidSegEngine.invert = invert
        hook.remove()
    launches, plain_calls = read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"[inversion] run_single_video {total:.2f} s (invert {invert_s['s']:.2f} s of the feature_pass stage), "
          f"stages_s {json.dumps({k: round(v, 3) for k, v in timings.items()})}; peak device memory {peak_gb:.1f} GB "
          f"({card_line()})", flush=True)
    check(calls["unet"] == INVERSION_CALLS["unet"] and invert_s["unet_calls"] == 25,
          f"[inversion] {calls['unet']} UNet calls ({invert_s['unet_calls']} in invert), expected "
          f"{INVERSION_CALLS['unet']} (25 of them in invert)")
    implied, normalised = window_launches(pipe, True, INVERSION_CALLS)
    expected = {name: implied.get(name, 0) for name in launches}
    expected.update(group_norm_expected("inversion", implied["group_norm"]))
    check(launches == expected, f"[inversion] launches {launches}, expected {expected} ({INVERSION_CALLS})")
    check(all(n == 0 for n in plain_calls.values()) and A.mha_reference_site.calls == 0,
          f"[inversion] plain versions ran on the card: {plain_calls}, site {A.mha_reference_site.calls}")
    narrow = INVERSION_CALLS["decoder"] * narrow_tconv_sites(pipe.first_stage.decoder)
    print(f"[inversion] kernel launches {json.dumps(launches)}; by route "
          f"{json.dumps(check_routes('inversion', launches, narrow, normalised))}", flush=True)
    k, steps = args.num_masks, main_path.NUM_STEPS
    check(res.cache_t0 == 0 and res.cached_xt.shape[0] == steps,
          f"[inversion] cache window t0 {res.cache_t0}, {res.cached_xt.shape[0]} cached steps, expected 0 and {steps}")
    check(res.injected_cache_bytes == steps * INJECT_BYTES_PER_STEP,
          f"[inversion] q/k cache holds {res.injected_cache_bytes} bytes, expected {steps * INJECT_BYTES_PER_STEP}")
    n_sites = INJECT_BLOCKS * INJECT_STEPS * 2 * k
    check(res.injected_sites == n_sites, f"[inversion] {res.injected_sites} injected sites, expected {n_sites}")
    fin = res.final_latents
    check(np.isfinite(fin).all() and np.isfinite(res.feature_x0).all() and np.isfinite(res.diff_maps).all(),
          "[inversion] outputs not finite")
    check(set(np.unique(res.seg_raw)) <= set(range(k)), "[inversion] labels out of range")
    dpm = float(np.abs(fin[0] - fin[1]).max())
    check(dpm > 0, "[inversion] +lambda and -lambda runs are identical")
    outside = max(float(np.abs((fin[s_, m] - res.cached_xt[-1]) * (1 - res.masks_latent[m][..., None])).max())
                  for s_ in range(2) for m in range(k))
    check(outside == 0.0, f"[inversion] outside-mask latents deviate from the cached trajectory by {outside}")
    print(f"[inversion] {calls['unet']} UNet calls, cache t0 0 x {steps} steps, q/k cache "
          f"{res.injected_cache_bytes / 1e9:.2f} GB, {res.injected_sites} injected sites; max|+lambda - -lambda| = "
          f"{dpm:.4f}; outside-mask deviation {outside}", flush=True)
    return launches


TINY_CONFIG = "configs/inference/svd_tiny.yaml"


def phase_tiny(torch):
    """svd_tiny.yaml as shipped (16-dim heads at every UNet site and at its tiny
    CLIP tower) through run_single_video on the card in bf16, on the main
    path's frames and settings (14 x 448x832, 25 steps, 2 masks, decoding_t 7):
    the D = 16 instances of K1 (the mma.sync template) and K2 (CUDA cores), K3
    at D = 16 on CLIP's "mha_reference" site (normalise-first); every K1 and
    K2 launch at D = 16, no plain version, finite outputs. Returns the launches
    and keeps the head-dim counts (DIM_COUNTS["tiny"])."""
    import numpy as np

    from vidseg_diffusion_tpu_torch.engine.build import build_pipeline
    from vidseg_diffusion_tpu_torch.ops import attention as A
    from vidseg_diffusion_tpu_torch.pipelines.single_video import run_single_video
    from vidseg_diffusion_tpu_torch.scripts import main_path

    pipe = build_pipeline(os.path.join(ROOT, TINY_CONFIG), num_steps=main_path.NUM_STEPS,
                          num_frames=main_path.NUM_FRAMES, dtype=torch.bfloat16, device="cuda", seed=0)
    reset_counts()
    t0 = time.perf_counter()
    res = run_single_video(pipe, main_path.frames(), main_path.frame_names(), main_path.vidseg_args(),
                           write_outputs=False)
    total = time.perf_counter() - t0
    launches, plain_calls = read_counts()
    dims = read_dims()
    DIM_COUNTS["tiny"], ROUTE_COUNTS["tiny"] = dims, read_routes()
    print(f"[tiny] {TINY_CONFIG} run_single_video {total:.2f} s; launches {json.dumps(launches)}; by head dim "
          f"{json.dumps(dims)}", flush=True)
    check(all(n == 0 for n in plain_calls.values()) and A.mha_reference_site.calls == 0,
          f"[tiny] plain versions ran on the card: {plain_calls}")
    for name in ("flash_attention_packed", "temporal_attention_direct"):
        check(launches[name] > 0 and dims[name] == {16: launches[name]},
              f"[tiny] {name}: {launches[name]} launches, by head dim {dims[name]} (all at D = 16 expected)")
    check(A.flash_attention_packed.mma_launches == launches["flash_attention_packed"],
          "[tiny] a D = 16 K1 launch did not run the mma.sync template")
    check(A.temporal_attention_direct.mma_launches == 0 and A.temporal_attention_direct.wide_launches == 0,
          "[tiny] a D = 16 K2 launch ran the D = 64 or the D = 512 kernel")
    nf16 = dims["flash_attention.normalised"].get(16, 0)
    check(nf16 > 0 and dims["flash_attention"].get(16, 0) == nf16,
          f"[tiny] K3 at D = 16: {dims['flash_attention']} launches, {nf16} of them normalise-first (CLIP's, all "
          "expected)")
    check(np.isfinite(res.final_latents).all() and np.isfinite(res.diff_maps).all(), "[tiny] outputs not finite")
    check(float(np.abs(res.final_latents[0] - res.final_latents[1]).max()) > 0, "[tiny] +lambda == -lambda")
    del pipe
    return launches


VAE_TIME_MODES = ("all", "attn-only")


def vae_time_mode_decoder(torch, mode, dtype, seed=7):
    """svd.yaml's first-stage decoder in `mode`, every parameter drawn from a
    seed as a random build draws them (engine.build.randomize_)."""
    from vidseg_diffusion_tpu_torch.config import load_model_spec
    from vidseg_diffusion_tpu_torch.engine.build import randomize_
    from vidseg_diffusion_tpu_torch.models.vae import Decoder

    spec = load_model_spec(os.path.join(ROOT, "configs/inference/svd.yaml"), num_frames=14)
    dec = Decoder(dataclasses.replace(spec.vae_config, time_mode=mode, dtype=dtype)).cuda()
    with torch.no_grad():
        randomize_(dec, torch.Generator(device="cuda").manual_seed(seed))
    return dec.to(dtype).eval().requires_grad_(False), spec.scale_factor


def phase_vae_time_mode(torch):
    """The VideoDecoder at time_mode 'all' and 'attn-only' (svd.yaml's first
    stage, seeded random weights; 'conv-only', svd.yaml's own, beside them for
    the time): 14 latents of 56x104 decoded at decoding_t 7
    in bf16, the counts set to 0 before each decode: the VideoAttnBlock's K3
    (spatial, [7,1,5824,512]), K2 at D = 512 on the wide kernel (the time mix,
    t = 7) and K1 at one 512-dim head on K3's wgmma kernel (attn2, a "flash"
    site over the 5824 tokens) twice a decode (two calls), K11 at its eight
    projections, K4 at the video ResnetBlocks ('all' only), every launch reckoned
    and no plain version; finite frames. Then each mode in fp32 at 2 frames of
    32x32 latents (1024 tokens: every attention site a kernel site) on the card
    vs the CPU's plain versions, the library convolutions off cuDNN and TF32 off,
    within UNET_REL_TOL of max |CPU|. Returns {mode: launches}."""
    import copy

    from vidseg_diffusion_tpu_torch.engine.diffusion_engine import FirstStage
    from vidseg_diffusion_tpu_torch.models.layers import CrossAttention, GroupNorm32
    from vidseg_diffusion_tpu_torch.ops import attention as A

    out = {}
    g = torch.Generator(device="cuda").manual_seed(8)
    z = torch.randn(14, 56, 104, 4, generator=g, device="cuda").to(torch.bfloat16)
    for mode in ("conv-only",) + VAE_TIME_MODES:   # svd.yaml's own mode: the time it is compared with
        dec, scale = vae_time_mode_decoder(torch, mode, torch.bfloat16)
        fs = FirstStage(None, dec, scale)
        fs.decode(z[:7], chunk=7)   # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        frames = fs.decode(z, chunk=7)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches, plain_calls = read_counts()
        dims, calls = read_dims(), 2
        mixed = calls if mode in VAE_TIME_MODES else 0   # the VideoAttnBlock's K1 and K2 launches
        n_gn = sum(isinstance(m, GroupNorm32) for m in dec.modules())
        n_attn = sum(isinstance(m, CrossAttention) for m in dec.modules())
        want = {name: 0 for name in launches}
        want.update(flash_attention_packed=mixed, temporal_attention_direct=mixed, flash_attention=calls,
                    matmul_bias=4 * n_attn * calls,
                    temporal_conv_1x1=TCONV_PER_DECODER * calls if mode != "attn-only" else 0)
        want.update(group_norm_expected(f"vae {mode}", n_gn * calls))
        check(launches == want, f"[vae_time_mode {mode}] launches {launches}, expected {want}")
        check(all(n == 0 for n in plain_calls.values()) and A.mha_reference_site.calls == 0,
              f"[vae_time_mode {mode}] plain versions ran on the card: {plain_calls}")
        at512 = lambda n: {512: n} if n else {}
        check(dims["flash_attention_packed"] == at512(mixed) and dims["temporal_attention_direct"] == at512(mixed)
              and dims["flash_attention"] == {512: calls}, f"[vae_time_mode {mode}] launches by head dim {dims}")
        check(A.flash_attention_packed.wgmma_launches == mixed and A.temporal_attention_direct.wide_launches == mixed
              and A.flash_attention.wgmma_launches == calls,
              f"[vae_time_mode {mode}] K1 / K2 / K3 off their D = 512 kernels: {read_routes()}")
        check(frames.shape == (14, 448, 832, 3) and bool(torch.isfinite(frames).all()),
              f"[vae_time_mode {mode}] frames {tuple(frames.shape)} not finite or misshaped")
        ROUTE_COUNTS[f"vae_{mode}"], DIM_COUNTS[f"vae_{mode}"] = read_routes(), dims
        print(f"[vae_time_mode {mode}] decode of 14 x 56x104 latents at decoding_t 7 (bf16): {secs:.3f} s, peak "
              f"{torch.cuda.max_memory_allocated() / 1e9:.1f} GB; launches {json.dumps(launches)}; by route "
              f"{json.dumps(ROUTE_COUNTS[f'vae_{mode}'])} ({card_line()})", flush=True)
        if mode in VAE_TIME_MODES:
            out[mode] = launches
        del dec, fs, frames
        torch.cuda.empty_cache()

    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32, torch.backends.cudnn.enabled
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = torch.backends.cudnn.enabled = False
    try:
        zs = torch.randn(2, 32, 32, 4, generator=torch.Generator().manual_seed(9))
        for mode in VAE_TIME_MODES:
            dec, _ = vae_time_mode_decoder(torch, mode, torch.float32)
            cpu = copy.deepcopy(dec).cpu()
            reset_counts()
            with torch.no_grad():
                card = dec(zs.cuda(), 2).cpu()
                launches, plain_calls = read_counts()
                ref = cpu(zs, 2)
            check(launches["flash_attention_packed"] == 1 and launches["temporal_attention_direct"] == 1
                  and launches["flash_attention"] == 1, f"[vae_time_mode {mode} fp32] launches {launches}")
            err = (card - ref).abs().max().item() / ref.abs().max().item()
            print(f"[vae_time_mode {mode} fp32] 2 x 32x32 latents, card vs CPU: max |diff| {err:.3e} of max |CPU| "
                  f"(tol {UNET_REL_TOL:.0e})", flush=True)
            check(err <= UNET_REL_TOL and bool(torch.isfinite(card).all()),
                  f"[vae_time_mode {mode} fp32] card vs CPU {err}")
            del dec, cpu
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32, torch.backends.cudnn.enabled = saved
    return out


def phase_sd(torch):
    """The SD 2.1 path of scripts/sd_path.py with its checks; returns its
    kernel launches and its pipeline (for sweep_sd)."""
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
    normalised = {k: n * SD_CALLS["unet"] for k, n in SD_NORMALISED_PER_UNET.items()}
    print(f"[sd] launches by route {json.dumps(check_routes('sd', launches, normalised=normalised))}; GroupNorm "
          f"calls by route {json.dumps(GN_ROUTES)}", flush=True)
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
    del res, after_blend
    return launches, pipe


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
    on the card through the kernels (K7-K10 at every GroupNorm; the 64-token
    mid attentions run mha_reference_site, as JAX differentiates mha_reference
    there) vs the CPU through the plain versions; same fp32 weights, frames
    and posterior noise, TF32 off on the card. Two backward passes, held by norm:
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

    launches = A.flash_attention.launches, A.flash_attention_backward.launches, A.mha_reference_site.calls
    t0 = time.perf_counter()
    loss_card, g_card = grads(*card, "cuda")
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    # an 8x8 latent's 64-token mid attention is a site JAX's TPU dispatch sends to
    # mha_reference, which JAX differentiates: mha_reference_site, no K3 / K13
    check(A.flash_attention.launches - launches[0] == 0 and A.flash_attention_backward.launches - launches[1] == 0
          and A.mha_reference_site.calls - launches[2] == 2,
          "the card's autoencoder backward did not run mha_reference_site once per mid attention")
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


# the VSPW sweep CLIs' windows at their defaults: 14 frames, decoding_t 1 (one
# frame a VAE call), K masks = the GT labels match_gt_mask kept. Per SVD UNet
# call 16 spatial and 16 temporal self-attention sites (K1, K2) and 44
# temporal convs (K4); 29 temporal convs per decoder call; CLIP's 32 layers
# once a window (K3's normalise-first mode). The SD 2.1 UNet launches K1 once
# per CrossAttention module, the normalise-first mode at SD_NORMALISED_PER_UNET.
SVD_PER_UNET = {"flash_attention_packed": 16, "temporal_attention_direct": 16, "temporal_conv_1x1": 44}
TCONV_PER_DECODER, CLIP_LAYERS = 29, 32
SWEEP_GT = (0, 3, 7)             # the synthetic GT's labels, in three column blocks
SWEEP_VIDEOS = (("A", 16, True), ("B", 15, True), ("C", 0, True))   # (name, frames, masks); C's origin/ is empty
SWEEP_WINDOWS = {"A": [(0, 14), (2, 16)], "B": [(0, 14), (1, 15)]}
# a token's KNN label may differ card vs CPU only where its 4th and 5th nearest
# distances tie within KNN_TIE_REL of the terms the fp32 formula x2 - 2 x.r + r2
# cancels (|x|^2 + |r|^2: its rounding error scales with them, not with the
# distance; relative to the distance itself near neighbours read ~1e-3)
KNN_TIE_REL = 1e-5
# refined masks may differ card vs CPU only where the dense tracks part at a near-tie:
# both candidates scoring within TRACK_TIE_ULPS fp32 ulps (identical masks pass as they are)
TRACK_TIE_ULPS = 2
SWEEP = {}                       # tag -> {kernel: launches summed over the windows}


def window_calls(video, k, frames=14, steps=25):
    """Calls per model of one sweep window with k masks at the CLIs' defaults:
    the feature pass from the modulated step (SVD 17, SD 22), 2k runs from
    three steps before it, the first-stage encoder on one frame a call
    (decoding_t 1; + the conditioning frame's for SVD), the decoder on as many
    calls per run."""
    mod_step = 17 if video else 22
    return {"unet": (steps - mod_step) + 2 * k * (steps - (mod_step - 3)),
            "encoder": frames + (1 if video else 0), "decoder": 2 * k * frames}


def window_launches(pipe, video, calls):
    """({kernel or "group_norm": launches}, {kernel: normalise-first launches})
    that `calls` imply (module_launches for GroupNorm, K11 and K12)."""
    from vidseg_diffusion_tpu_torch.models.layers import CrossAttention

    out, _ = module_launches(pipe, calls)
    u, e, d = calls["unet"], calls["encoder"], calls["decoder"]
    if video:
        out.update({k: n * u for k, n in SVD_PER_UNET.items()})
        out["temporal_conv_1x1"] += TCONV_PER_DECODER * d
        out["flash_attention"] = CLIP_LAYERS + e + d
        return out, dict(MAIN_NORMALISED)
    out["flash_attention_packed"] = sum(isinstance(m, CrossAttention) for m in pipe.unet.modules()) * u
    out["flash_attention"] = e + d
    return out, {k: n * u for k, n in SD_NORMALISED_PER_UNET.items()}


def check_window(tag, pipe, video, k):
    """One window's launches (counted since reset_counts()) against what its
    k masks imply, by kernel and by route; no plain version, no
    mha_reference_site. Returns (launches, routes)."""
    from vidseg_diffusion_tpu_torch.ops import attention as A

    launches, plain_calls = read_counts()
    calls = window_calls(video, k)
    implied, normalised = window_launches(pipe, video, calls)
    expected = {name: implied.get(name, 0) for name in launches}
    expected.update(group_norm_expected(tag, implied["group_norm"]))
    check(launches == expected, f"[{tag}] launches {launches}, expected {expected} for {k} masks ({calls})")
    check(all(n == 0 for n in plain_calls.values()), f"[{tag}] plain versions ran on the card: {plain_calls}")
    check(A.mha_reference_site.calls == 0, f"[{tag}] {A.mha_reference_site.calls} attention sites ran mha_reference")
    narrow = calls["decoder"] * narrow_tconv_sites(pipe.first_stage.decoder) if video else 0
    return launches, check_routes(tag, launches, narrow, normalised)


def sweep_frames(n):
    """[n, 448, 832, 3] uint8 frames whose colour and texture follow the GT's
    three column blocks, drifting a little from frame to frame, plus noise."""
    import numpy as np

    from vidseg_diffusion_tpu_torch.scripts import main_path

    h, w = main_path.HEIGHT, main_path.WIDTH
    rng = np.random.RandomState(11)
    block = np.arange(w) * 3 // w
    yy, xx = np.meshgrid(np.linspace(0, 1, h), np.linspace(0, 1, w), indexing="ij")
    colour = np.array([[200, 60, 50], [40, 170, 70], [60, 80, 210]], np.float32)[block]
    out = []
    for i in range(n):
        tex = 40 * np.sin(18 * (xx + 0.01 * i) + (3 + block) * 7 * yy)[..., None]
        out.append(np.clip(colour[None] + tex + 12 * rng.randn(h, w, 3), 0, 255).astype(np.uint8))
    return out


def sweep_gt():
    import numpy as np

    from vidseg_diffusion_tpu_torch.scripts import main_path

    w = main_path.WIDTH
    row = np.array(SWEEP_GT, np.uint8)[np.arange(w) * 3 // w]
    return np.broadcast_to(row, (main_path.HEIGHT, w)).copy()


def make_sweep_tree(root, videos):
    """<root>/<name>/origin/<i>.png (+ mask/<i>.png) for (name, frames, masks)."""
    from PIL import Image

    frames = sweep_frames(max(n for _, n, _ in videos))
    gt = Image.fromarray(sweep_gt())
    for name, n, masks in videos:
        os.makedirs(os.path.join(root, name, "origin"))
        if masks:
            os.makedirs(os.path.join(root, name, "mask"))
        for i in range(n):
            Image.fromarray(frames[i]).save(os.path.join(root, name, "origin", f"{i}.png"))
            if masks:
                gt.save(os.path.join(root, name, "mask", f"{i}.png"))


class WindowRecorder:
    """Stands in for run_single_video inside pipelines/vspw.py: each window
    runs with the counts set to 0 just before it and checked just after
    (check_window), and is kept with its seconds."""

    def __init__(self, torch, pipe, video, tag):
        self.torch, self.pipe, self.video, self.tag = torch, pipe, video, tag
        self.windows = []

    def __call__(self, pipeline, frames, names, args, **kw):
        from vidseg_diffusion_tpu_torch.pipelines.single_video import run_single_video

        torch = self.torch
        stages = {}
        if kw.get("timings") is None:
            kw["timings"] = stages
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        res = run_single_video(pipeline, frames, names, args, **kw)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        k = len(res.unique_labels)
        launches, routes = check_window(f"{self.tag} window {len(self.windows)}", self.pipe, self.video, k)
        self.windows.append(dict(names=list(names), gt_state=kw.get("gt_state"), gt_mask=kw.get("gt_mask"),
                                 result=res, seconds=seconds, launches=launches, routes=routes, dims=read_dims(),
                                 stages=stages))
        return res


def numpy_confusion(results, root, num_classes):
    """The sweep's confusion matrix recounted in numpy from the label maps it
    returned and the GT on disk."""
    import numpy as np

    from vidseg_diffusion_tpu_torch.pipelines import vspw

    cm = np.zeros((num_classes, num_classes), np.int64)
    for name, res in results.items():
        pred, gt = vspw._load_gt_for_eval(os.path.join(root, name, "origin"), res)
        pred, gt = pred.astype(np.int64), gt.astype(np.int64)
        keep = (gt != 255) & (gt >= 0) & (gt < num_classes) & (pred >= 0) & (pred < num_classes)
        np.add.at(cm, (gt[keep], pred[keep]), 1)
    return cm


def run_sweep(torch, tag, cli, pipe, video, root, expected_windows, failed):
    """One sweep through the CLI module's code path at its defaults on the tree
    at `root`, every window checked; then the checks that hold for the whole
    sweep. Returns the recorder."""
    import numpy as np
    from unittest import mock

    from vidseg_diffusion_tpu_torch.pipelines import vspw

    manifest = os.path.join(root, "manifest.jsonl")
    args = cli.parse_args(["--data_root", root, "--manifest", manifest])
    check(args.num_masks == 20 and args.feature_extraction_mode == "match_gt_mask" and args.device == "cuda",
          f"[{tag}] the CLI defaults moved: {args}")
    recorder = WindowRecorder(torch, pipe, video, tag)
    results, evaluators = {}, []
    run_video, make_evaluator = vspw.run_vspw_video, vspw.SegmentationEvaluator

    def video_recorder(*a, **kw):   # each finished video's result, by name
        res = run_video(*a, **kw)
        results[os.path.basename(os.path.dirname(a[1]))] = res
        return res

    def evaluator_recorder(*a, **kw):   # the sweep's evaluator, for its confusion matrix
        evaluators.append(make_evaluator(*a, **kw))
        return evaluators[-1]

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with mock.patch.object(vspw, "run_single_video", recorder), \
            mock.patch.object(vspw, "run_vspw_video", video_recorder), \
            mock.patch.object(vspw, "SegmentationEvaluator", evaluator_recorder):
        out = cli.sweep(args, pipe)
    total = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"[{tag}] sweep {json.dumps(out, default=str)}", flush=True)
    check([v for v, _ in out["videos_failed"]] == failed,
          f"[{tag}] failed videos {out['videos_failed']}, expected exactly {failed}")
    check(out["videos_done"] == len(expected_windows) and out.get("videos_evaluated") == len(expected_windows),
          f"[{tag}] {out['videos_done']} videos done / {out.get('videos_evaluated')} scored")
    check(0.0 <= out["mIoU"] <= 1.0, f"[{tag}] mIoU {out['mIoU']}")
    cm = numpy_confusion(results, root, args.num_classes)
    check(len(evaluators) == 1 and np.array_equal(evaluators[0].confusion.numpy(), cm), f"[{tag}] the sweep's confusion matrix is not a recount of its maps")
    per_video, windows = {}, iter(recorder.windows)
    for name, spans in expected_windows.items():
        mine = [next(windows) for _ in spans]
        per_video[name] = mine
        check([(int(w["names"][0]), int(w["names"][-1]) + 1) for w in mine] == spans,
              f"[{tag}] video {name}: windows {[w['names'] for w in mine]}, expected {spans}")
        check(mine[0]["gt_state"] is None and mine[0]["gt_mask"] is not None, f"[{tag}] {name}: first window unseeded")
        for prev, cur in zip(mine, mine[1:]):
            check(cur["gt_state"] is prev["result"].gt_state and cur["gt_mask"] is None,
                  f"[{tag}] {name}: window {cur['names'][0]} did not start from the previous window's state")
        for w in mine:
            check(set(w["result"].unique_labels.tolist()) <= set(SWEEP_GT),
                  f"[{tag}] {name}: labels {w['result'].unique_labels} outside the GT's {SWEEP_GT}")
        check(len(results[name].seg) == spans[-1][1], f"[{tag}] {name}: {len(results[name].seg)} label maps")
    check(next(windows, None) is None, f"[{tag}] {len(recorder.windows)} windows ran")
    for name, mine in per_video.items():
        print(f"[{tag}] video {name}: windows {[(w['names'][0], w['names'][-1]) for w in mine]}, masks "
              f"{[len(w['result'].unique_labels) for w in mine]} (labels "
              f"{[w['result'].unique_labels.tolist() for w in mine]}), seconds per window "
              f"{[round(w['seconds'], 3) for w in mine]}, per video {sum(w['seconds'] for w in mine):.3f}; stage "
              f"seconds {[{k: round(v, 3) for k, v in w['stages'].items()} for w in mine]}", flush=True)
    print(f"[{tag}] {len(recorder.windows)} windows in {total:.2f} s (loading and scoring included); mIoU "
          f"{out['mIoU']:.4f}, mVC_8 {out.get('mVC_8')}, mVC_16 {out.get('mVC_16')}; peak device memory "
          f"{peak_gb:.2f} GB ({card_line()})", flush=True)
    # a second call on the same manifest: the finished videos are skipped and nothing runs
    n = len(recorder.windows)
    with mock.patch.object(vspw, "run_single_video", recorder):
        again = cli.sweep(args, pipe)
    check(len(recorder.windows) == n and again["videos_skipped"] == len(expected_windows)
          and again["videos_done"] == 0, f"[{tag}] the resumed sweep ran windows: {again}")
    SWEEP[tag] = {k: sum(w["launches"][k] for w in recorder.windows) for k in recorder.windows[0]["launches"]}
    ROUTE_COUNTS[tag] = {k: {r: sum(w["routes"][k][r] for w in recorder.windows) for r in v}
                         for k, v in recorder.windows[0]["routes"].items()}
    DIM_COUNTS[tag] = sum_dims(w["dims"] for w in recorder.windows)
    return recorder


def knn_card_vs_cpu(torch, tag, window):
    """The carried-state window's KNN vote on the card against the port's CPU
    knn_predict on the same features and state: labels identical but where a
    token's 4th and 5th nearest distances tie within KNN_TIE_REL."""
    from vidseg_diffusion_tpu_torch.engine.masks import _normalize
    from vidseg_diffusion_tpu_torch.ops.knn import knn_distances, knn_predict

    state, res = window["gt_state"], window["result"]
    t = len(window["names"])
    x = _normalize(torch.from_numpy(res.cluster_features).float())[t:].reshape(-1, res.cluster_features.shape[-1])
    k_classes = len(state.unique_labels)
    card = knn_predict(state.ref_features, state.ref_labels, x.cuda(), num_classes=k_classes).cpu()
    ref_x, ref_y = state.ref_features.cpu(), state.ref_labels.cpu()
    cpu = knn_predict(ref_x, ref_y, x, num_classes=k_classes)
    differ = (card != cpu).nonzero().flatten()
    worst = worst_d = 0.0
    r2 = (ref_x * ref_x).sum(dim=1)
    for i in differ.tolist():
        d, j = torch.sort(knn_distances(ref_x, x[i:i + 1])[0])
        gap = abs(d[4] - d[3]).item()
        worst = max(worst, gap / ((x[i] * x[i]).sum() + r2[j[3]]).item())
        worst_d = max(worst_d, gap / max(abs(d[4]).item(), 1e-30))
    print(f"[{tag}] carried-state KNN [{x.shape[0]} x {ref_x.shape[0]}] card vs CPU: {len(differ)} of {x.shape[0]} "
          f"labels differ, worst 4th/5th distance gap there {worst:.2e} of |x|^2 + |r|^2 (tol {KNN_TIE_REL:.0e}), "
          f"{worst_d:.2e} of the distance", flush=True)
    check(worst <= KNN_TIE_REL, f"[{tag}] KNN labels differ card vs CPU beyond a near-tie")


def phase_sweep(torch, pipe):
    """The VSPW sweep of scripts/svd_pipeline_vspw.py at its defaults on the
    main path's pipeline over a synthetic tree: A (16 frames), B (15), C (an
    empty origin/)."""
    import tempfile

    from vidseg_diffusion_tpu_torch.scripts import svd_pipeline_vspw as svd_cli

    with tempfile.TemporaryDirectory() as root:
        make_sweep_tree(root, SWEEP_VIDEOS)
        recorder = run_sweep(torch, "sweep", svd_cli, pipe, True, root, SWEEP_WINDOWS, ["C"])
    carried = [w for w in recorder.windows if w["gt_state"] is not None]
    knn_card_vs_cpu(torch, "sweep", carried[-1])
    del recorder, carried
    gc.collect()
    torch.cuda.empty_cache()


def phase_sweep_sd(torch, pipe):
    """The SD 2.1 sweep of scripts/sd_pipeline_vspw.py at its defaults on the
    SD path's pipeline: one 16-frame video, two windows."""
    import tempfile

    from vidseg_diffusion_tpu_torch.scripts import sd_pipeline_vspw as sd_cli

    with tempfile.TemporaryDirectory() as root:
        make_sweep_tree(root, SWEEP_VIDEOS[:1])
        recorder = run_sweep(torch, "sweep_sd", sd_cli, pipe, False, root, {"A": SWEEP_WINDOWS["A"]}, [])
    knn_card_vs_cpu(torch, "sweep_sd", recorder.windows[-1])
    del recorder
    gc.collect()
    torch.cuda.empty_cache()


def tracks_tie(torch, cond_cpu, traj_card, traj_cpu):
    """Where the card's dense tracks leave the CPU's: the largest gap, in fp32
    ulps of the CPU's scores, between the two candidates at the first step
    that differs (later steps start from other points)."""
    import numpy as np

    from vidseg_diffusion_tpu_torch.ops.matching import _l2norm, tracking_scores

    f = _l2norm(cond_cpu.float())
    for step in range(1, traj_cpu.shape[0]):
        differ = (traj_card[step] != traj_cpu[step]).nonzero().flatten()
        if len(differ):
            scores = tracking_scores(f, traj_cpu[step - 1], step - 1).numpy()
            gaps = [abs(scores[p, traj_card[step, p]] - scores[p, traj_cpu[step, p]])
                    / np.spacing(np.float32(max(abs(scores[p, traj_card[step, p]]),
                                                abs(scores[p, traj_cpu[step, p]]))))
                    for p in differ.tolist()]
            return step, len(differ), float(max(gaps))
    return None, 0, 0.0


def phase_refine(torch, pipe):
    """One 14-frame SVD window with match_gt_mask and is_refine_mask through the
    sweep CLI's arguments: its launches as a sweep window's, and the refined
    masks against the port's CPU correct_low_res_mask on the same harvested
    features and masks (identical, or apart only where the card's and the CPU's
    dense tracks part at a near-tie of TRACK_TIE_ULPS)."""
    import tempfile
    from unittest import mock

    import numpy as np

    from vidseg_diffusion_tpu_torch.engine.masks import _normalize, correct_low_res_mask
    from vidseg_diffusion_tpu_torch.io.video import list_video_frames, load_frames
    from vidseg_diffusion_tpu_torch.ops.matching import dense_tracking
    from vidseg_diffusion_tpu_torch.pipelines import single_video as SV
    from vidseg_diffusion_tpu_torch.pipelines import vspw
    from vidseg_diffusion_tpu_torch.scripts import svd_pipeline_vspw as svd_cli

    seen = []

    def recording(features, masks, num_frames, width):
        out = correct_low_res_mask(features, masks, num_frames, width)
        seen.append((features.detach().cpu(), masks.detach().cpu(), num_frames, width, out.cpu()))
        return out

    with tempfile.TemporaryDirectory() as root:
        make_sweep_tree(root, [("A", 14, True)])
        args = svd_cli.parse_args(["--data_root", root, "--is_refine_mask"])
        vargs = svd_cli.vidseg_args(args)
        video_dir = os.path.join(root, "A", "origin")
        frames, names, ori_hw = load_frames(list_video_frames(video_dir))
        fh, fw = SV.cluster_feature_hw(pipe, vargs, frames.shape[1], frames.shape[2], len(names))
        gt = vspw.load_gt_mask(video_dir, names[0], fh, fw)
    recorder = WindowRecorder(torch, pipe, True, "refine")
    with mock.patch.object(SV, "correct_low_res_mask", recording):
        res = recorder(pipe, frames, names, vargs, ori_hw=ori_hw, gt_mask=gt, write_outputs=False)
    check(len(seen) == 1, f"[refine] correct_low_res_mask ran {len(seen)} times")
    feats, masks, t, width, card = seen[0]
    cpu = correct_low_res_mask(feats, masks, t, width)
    cond = _normalize(feats.float())[t:]
    traj_card, traj_cpu = dense_tracking(cond.cuda()).cpu(), dense_tracking(cond)
    step, n_differ, gap = tracks_tie(torch, cond, traj_card, traj_cpu)
    same = torch.equal(card, cpu)
    changed = int((masks.argmax(0) != cpu.argmax(0)).sum())
    print(f"[refine] {recorder.windows[0]['seconds']:.3f} s; {len(res.unique_labels)} masks (labels "
          f"{res.unique_labels.tolist()}); tracking block features {tuple(feats.shape)}, width {width}; refinement "
          f"relabelled {changed} of {masks.shape[1] * masks.shape[2]} tokens; card vs CPU refined masks "
          f"{'identical' if same else 'differ'}; tracks part at step {step} ({n_differ} points, largest candidate "
          f"gap {gap:.2f} ulps, tol {TRACK_TIE_ULPS})", flush=True)
    check(same or step is not None, "[refine] refined masks differ card vs CPU on identical tracks")
    check(same or gap <= TRACK_TIE_ULPS,
          f"[refine] refined masks differ where the card's tracks leave the CPU's beyond a near-tie ({gap:.2f} ulps)")
    check(np.isfinite(res.final_latents).all() and set(res.unique_labels.tolist()) <= set(SWEEP_GT),
          "[refine] latents not finite or labels outside the GT's")


def phase_route_probe(torch):
    """ROADMAP section C on the card: a bf16 bhld D = 512 attention of 300 tokens
    (a VAE attention of a frame under 181 x 181 px) runs mha_reference_site,
    within one bf16 step of the CPU mha_reference; a "flash" site with 40-dim
    heads raises the named ValueError before any launch; a gradient through an
    "mha_reference" site (SD 2.1's 77-key cross-attention) runs
    mha_reference_site, its gradients held to the CPU's mha_reference gradients
    at the CPU tests' bound (one bf16 step, at most MHA_DIFFERING differing);
    a gradient through a "flash" bhld site (fp32, 1024 tokens, D = 512) runs
    K3 with its LSE and K13 once each, held to the CPU's gradients by norm."""
    from vidseg_diffusion_tpu_torch.ops import attention as A

    g = torch.Generator(device="cuda").manual_seed(31)
    rn = lambda *s: (torch.randn(*s, generator=g, device="cuda") * 1.5).to(torch.bfloat16)
    reset_counts()
    q, k, v = rn(1, 1, 300, 512), rn(1, 1, 300, 512), rn(1, 1, 300, 512)
    out = A.dot_product_attention(q, k, v)
    launches, _ = read_counts()
    check(A.mha_reference_site.calls == 1 and sum(launches.values()) == 0,
          f"[route_probe] D = 512 x 300: site calls {A.mha_reference_site.calls}, launches {launches}")
    held_to_mha_reference(torch, "route_probe", "bf16 bhld D = 512 x 300 tokens (mha_reference_site)",
                          out.cpu(), A.mha_reference(q.cpu(), k.cpu(), v.cpu()))
    q, k, v = rn(2, 640, 4, 40), rn(2, 640, 4, 40), rn(2, 640, 4, 40)
    try:
        A.dot_product_attention(q, k, v, layout="blhd")
        fail("[route_probe] a 40-dim 'flash' site ran")
    except ValueError as e:
        check("'flash' attention site: head dim 40" in str(e) and "ROADMAP section C" in str(e),
              f"[route_probe] unexpected refusal: {e}")
        print(f"[route_probe] D = 40 'flash' site refused: {e}", flush=True)
    check(sum(read_counts()[0].values()) == 0, "[route_probe] the refused site launched a kernel")
    b, lq, lk, h = 2, 640, 77, 5
    q, k, v, go = rn(b, lq, h, 64), rn(b, lk, h, 64), rn(b, lk, h, 64), rn(b, lq, h, 64)
    check(A.site_route("blhd", b, lq, lk) == "mha_reference", "[route_probe] 640 x 77 is no mha_reference site")

    def grads(fn, dev):
        xs = [x.detach().to(dev).requires_grad_() for x in (q, k, v)]
        fn(*xs).backward(go.to(dev))
        return [x.grad for x in xs]

    calls = A.mha_reference_site.calls
    card = grads(lambda *x: A.dot_product_attention(*x, layout="blhd"), "cuda")
    check(A.mha_reference_site.calls == calls + 1 and sum(read_counts()[0].values()) == 0,
          "[route_probe] the gradient did not run mha_reference_site alone")
    cpu = grads(lambda *x: A.mha_reference(*x, layout="blhd"), "cpu")
    for name, a, w in zip("qkv", card, cpu):
        held_to_mha_reference(torch, "route_probe", f"d{name} at 640 x 77 (mha_reference_site under a gradient)",
                              a.cpu(), w)
    # a "flash" bhld site under a gradient keeps K3 with its LSE and K13, through
    # the autograd Function the VAE's mid attention runs (the mid attention of
    # two 256x256 frames: 1024 tokens, one 512-dim head), fp32 as in ae_grad
    b, l, d = 2, 1024, 512
    check(A.site_route("bhld", b, l, l) == "flash", "[route_probe] 1024 tokens is no flash site")
    g32 = torch.Generator().manual_seed(37)
    q, k, v, go = (torch.randn(b, 1, l, d, generator=g32) for _ in range(4))
    reset_counts()
    calls = A.mha_reference_site.calls
    card = grads(A.dot_product_attention, "cuda")
    launches, plains = read_counts()
    check(launches["flash_attention"] == 1 and launches["flash_attention_backward"] == 1
          and sum(launches.values()) == 2 and A.mha_reference_site.calls == calls and sum(plains.values()) == 0,
          f"[route_probe] the flash site's gradient did not run K3 and K13 once each: {launches}")
    cpu = grads(A.dot_product_attention, "cpu")
    worst = max((a.cpu() - w).norm().item() / w.norm().item() for a, w in zip(card, cpu))
    print(f"[route_probe] fp32 bhld [2,1,1024,512] 'flash' site under a gradient: K3 + K13, dq/dk/dv vs the CPU's "
          f"gradients worst relative error by norm {worst:.3e} (tol {GRAD_REL_TOL:.0e})", flush=True)
    check(worst <= GRAD_REL_TOL, f"[route_probe] the flash site's gradients disagree with the CPU's: {worst}")


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
        with open(log) as f:   # the instances that spill: a "Function properties" line, then its spill line
            lines = f.read().splitlines()
        spilling = [a.split("Function properties for ")[1] + ": " + b.strip() for a, b in zip(lines, lines[1:])
                    if "Function properties for " in a and "spill stores" in b and " 0 bytes spill stores" not in b]
        for entry in spilling:
            print(f"[build] spills: {entry}", flush=True)

    torch.nn.modules.module.register_module_forward_pre_hook(count_group_norm_route)
    phases = {}
    t0 = time.perf_counter()
    rows, k5_train = phase_kernels(torch)
    phases["kernels"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    phase_route_probe(torch)
    phases["route_probe"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    tiny_launches = phase_tiny(torch)
    phases["tiny"] = time.perf_counter() - t0
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
    del plain_res
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    inversion_launches = phase_inversion(torch, pipe)
    phases["inversion"] = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    for name, fn in (("sweep", phase_sweep), ("refine", phase_refine)):
        t0 = time.perf_counter()
        fn(torch, pipe)
        phases[name] = time.perf_counter() - t0
    del pipe
    gc.collect()   # free the SVD models before the SD and training phases
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    sd_launches, pipe = phase_sd(torch)
    phases["sd"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    phase_sweep_sd(torch, pipe)
    phases["sweep_sd"] = time.perf_counter() - t0
    del pipe
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    train_launches = phase_train(torch)
    phases["train"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    phase_ae_grad(torch)
    phases["ae_grad"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ae_launches = phase_ae_train(torch)
    phases["ae_train"] = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    vae_launches = phase_vae_time_mode(torch)
    phases["vae_time_mode"] = time.perf_counter() - t0
    print(f"[phases] seconds {json.dumps({k: round(v, 1) for k, v in phases.items()})}", flush=True)

    kernels = []
    tags = ("main", "inject", "sd", "train", "ae_train", "sweep", "sweep_sd")
    # this slice's paths: the inversion run, the VideoDecoder's two time modes
    # (their decodes summed), and the tiny config's run for the D = 16 instances
    slice_runs = {"inversion": inversion_launches, "tiny": tiny_launches,
                  "vae_time_mode": {k: sum(r[k] for r in vae_launches.values()) for k in inversion_launches}}
    DIM_COUNTS["vae_time_mode"] = sum_dims(DIM_COUNTS[f"vae_{m}"] for m in VAE_TIME_MODES)
    for name, meta in KERNELS.items():
        mine = [r for r in rows if r["kernel"] == name]
        head = next(r for r in mine if r["shape"] == HEADLINE[name])
        extra = {}
        if "dim" in meta:  # an instance at one head dim: its wrapper's launches at that D in each run,
            # the normalise-first ones or the rest
            def at_dim(tag, meta=meta):
                by_dim = DIM_COUNTS[tag]
                nf = by_dim.get(f"{meta['wrapper']}.normalised", {}).get(meta["dim"], 0)
                return nf if meta["normalised"] else by_dim[meta["wrapper"]].get(meta["dim"], 0) - nf

            runs = {tag: at_dim(tag) for tag in tags + tuple(slice_runs)}
            runs["main"] = runs[meta["path"]] if meta["path"] else 0   # its path's run
            check(not meta["path"] or runs["main"] > 0, f"{name} never launched in the {meta['path']} run")
            extra = {"path": meta["path"] or "none (no path runs it)", "dim": meta["dim"]}
            routed = None
        else:
            # the run of its path: inference for K1-K4, K7, K8, K11, K12, diffusion training for
            # K5, K6, K9, K10, autoencoder training for K13
            path_launches = (launches if name in INFERENCE_KERNELS
                             else ae_launches if name in AE_KERNELS else train_launches)
            runs = dict(main=path_launches[name], inject=inject_launches[name], sd=sd_launches[name],
                        train=train_launches[name], ae_train=ae_launches[name], sweep=SWEEP["sweep"][name],
                        sweep_sd=SWEEP["sweep_sd"][name],
                        **{tag: r[name] for tag, r in slice_runs.items()})
            # K1, K2, K3, K4, K5, K6, K11 and K13: the launches of each path by the kernel that ran
            # (checked); the GroupNorm forward's routes are kernels of their own (K7 + K8, the fused K7+K8)
            routed = ({tag: ROUTE_COUNTS[tag][name] for tag in tags + ("inversion",)} if name in ROUTED else None)
        kernels.append(dict(
            name=name, route="cuda", source=meta["source"], replaces=meta["replaces"],
            launches=runs["main"], inject_launches=runs["inject"], sd_launches=runs["sd"],
            train_launches=runs["train"], ae_launches=runs["ae_train"], sweep_launches=runs["sweep"],
            sweep_sd_launches=runs["sweep_sd"], inversion_launches=runs["inversion"],
            vae_time_mode_launches=runs["vae_time_mode"], tiny_launches=runs["tiny"],
            max_abs_err=max(r["max_abs_err"] for r in mine), shape=head["shape"],
            ms=head["ms"], plain_ms=head["plain_ms"], bound_ms=head["bound_ms"],
            bound_by=head["bound_by"], library_ms=head["library_ms"],
            library_covers=head["library_covers"], routes=routed, **extra,
            **({"train_batch": k5_train} if name == "flash_attention_packed_backward" else {}),
        ))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
