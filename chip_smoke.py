#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA H100 (needs CUDA; no JAX).

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:
1. card: print `nvidia-smi --query-gpu=name,power.limit`.
2. build: compile the kernels from vidseg_diffusion_tpu_torch/csrc with nvcc
   (one process per source, in parallel).
3. kernels: each kernel (K1-K13, the one-launch GroupNorm forward and the
   GroupNorm backward's slab kernel) against its plain PyTorch version on the
   same inputs at the shapes of its path (K1-K4, K7, K8, the fused K7+K8, K11,
   K12 inference; K5, K6, the slab kernel, K9, K10 and K4's dx launch training,
   each backward case labelled with its site's backward route; bf16, the GroupNorm kernels, K4, K11 and K12
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
   K3 (CLIP, D = 80, over 8 draws pooled) also held to mha_reference (one bf16 step, at most 0.1 % of
   the elements), and each timed beside the kernel that streams the keys from device memory (which
   the resident ones replaced there); the sampling API's shapes: SDXL base K1 [2,4096,10x64] and [2,1024,20x64], the
   normalise-first K1 at their 77 keys, K3 [1,1,16384,512]; the refiner's K1 at 12 and 24 heads (its
   256-token mid block on the fp32-sum kernel) and normalise-first K1; img2vid's K1 [28,9216,5x64], K2
   [28,9216,5,64], K4 [2,14,9216,320], K3 [1,1,9216,512]; NTI's K5 [2,4096,5x64] and [2,1024,10x64]
   and normalise-first K1 [2,4096x77,5x64]. The fp32 attention at D = 512 on split TF32 products
   (route tf32x3: K3 / K1 forward, K13 / K5 backward; entries flash_attention_tf32x3 and
   flash_attention_backward_tf32x3 at the VAE mid attention [7,1,5824,512] and at [2,1,64,512])
   is also held to its plain version run in float64 (relative RMS within FP64_RMS_TOL), and every
   fp32 attention row prints that reading; every fp32 library call is timed in full fp32 (TF32 off
   for matmuls and cuDNN), K12's fp32 rows also with TF32 on, for the record; an fp32 bound by
   operations is flops over 165 TFLOP/s (three TF32 products at 495).
4. unet: one full-width SVD UNet forward in fp32 (random weights, a 16x16
   latent, 2 frames) on the card through the kernels vs the same weights on
   the CPU through the plain versions; then the same for the full-width SD
   2.1 image UNet with a 77-token context; every K11 launch of the two on the
   split-TF32 kernel (route tf32x3).
5. train_grad: the same UNet in fp32 with remat, loss.backward() of the
   diffusion loss (explicit sigma and noise) on the card through the
   kernels and their backward kernels vs the CPU through the plain
   versions; every parameter's gradient within a relative bound by norm;
   every K5 launch (D = 64) and every K11 launch on the split-TF32 kernels
   (route tf32x3), every K6 launch on the resident split-TF32 kernel.
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
   K3 = K13 = 2, one GroupNorm forward and one backward per first-stage
   GroupNorm module per step (52: the backward on the slab kernel or on K9 +
   K10 by the route ops.norm.group_norm_backward_route gives the module's
   input; the slab kernel's .cluster_launches those on a cluster), every
   other kernel 0 and no plain version called; step time and peak memory.
11. train: the full-width training step of
   vidseg_diffusion_tpu_torch/scripts/train_path.py (svd.yaml UNet, bf16,
   remat, 2 x 14 frames of 56x104 latents, Adam, EMA): a warm-up step, then
   TRAIN_STEPS steps; the loss finite at every step, every gradient finite,
   the self-attention q/k/v projections' gradients non-zero (spatial and
   temporal), the last step taken by every parameter with a gradient and
   by the EMA (check_last_update), K1, K2, K4, K5, K6, K7, K8, K11, K12 and
   the GroupNorm backward (105 a step, on the slab kernel or K9 + K10 by
   route, as in ae_train) launched exactly as often as a remat step of these
   modules implies (train_launches) and no plain version called; step time
   and peak memory.
12. route_probe (right after the kernels): ROADMAP section C on the card: a
   bf16 bhld D = 512 attention of 300 tokens runs mha_reference_site (no
   normalise-first kernel takes D = 512), within one bf16 step of the CPU
   mha_reference; a 40-dim "flash" site raises the named ValueError and
   launches nothing; a gradient through SD 2.1's 640 x 77 cross-attention
   site runs mha_reference_site, held to the CPU mha_reference's gradients;
   a gradient through a "flash" bhld site (fp32 [2,1,1024,512], the VAE mid
   attention of two 256x256 frames) runs K3 with its LSE and K13 once each,
   both on the split-TF32 kernels (route tf32x3), dq / dk / dv within
   GRAD_REL_TOL by norm of the CPU's.
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
   decoding_t 7 in bf16: K1 and K2 at one 512-dim head (K3's wgmma kernel;
   the team kernel of temporal_attention_long_tc.cu, route tc_short: the run
   whose launches the temporal_attention_direct_d512_tc entry reports) and K3
   twice a decode, every launch reckoned; 'all' over
   40 latents at decoding_t 40 (K2 at D = 512 over 40 frames, once, on the
   tensor-core kernel past 32 frames); then fp32 card vs CPU at 2 frames of 32x32 latents
   (K2 over the 2 frames on the wide kernel, below the crossover),
   and 'all' over 34 latents of 4x4 under a gradient (K2 and K6 at D = 512
   over 34 frames on the tensor-core kernels past 32 frames: the run of the
   temporal_attention_direct_backward_long entry), output and latent gradient
   card vs CPU.
19. api_img2vid (after refine, on the main path's pipeline): the sampling API's
   image_to_video (vidseg_diffusion_tpu_torch/inference/api.py) on svd.yaml at
   VideoSamplingParams' defaults (1024x576, 14 frames, 25 steps, decoding_t 1):
   25 UNet calls, the launches by kernel and route that they, one conditioning-frame
   encode and 14 decodes imply (K1 at 9216-token ds1 sites, K2, K4), no plain
   version, the 14 decodes finite before the clamp to [0, 1]; seconds per video
   and per UNet call (CUDA events), peak memory.
20. api_nti (after sweep_sd, on the SD phase's pipeline): sd_2_1.yaml at
   512x512 through scripts/api_path.py: the inversion of an encoded image over
   a 4-step schedule (its first sigma raised to the denoiser table's smallest),
   null_text_optimization with 3 inner steps under autograd (K1 with its LSE
   and K5, mha_reference_site at the 77-key sites of 4096 and 1024 queries, the
   GroupNorm backward: 696 backwards, by route on the slab kernel or K9 + K10),
   edit with its window at steps 1-2: the summed loss falls, the uc
   finite, both decodes finite before the clamp, the edit apart from the base
   run; 30 UNet calls; launches by kernel and route as the module calls imply
   (hooked_launches, from calls counted only inside these API runs).
21. api_sdxl: sd_xl_base.yaml and sd_xl_refiner.yaml at full width (bf16,
   random weights) through the sampling API at 1024x1024: text_to_image with
   40 Euler steps and CFG 5 (seconds per image and per UNet call, peak memory,
   timed without the call-counting hook, then run again with it), each other sampler for 6 steps (Heun, Euler ancestral, DPM++ 2S ancestral,
   DPM++ 2M, LMS, Euler with s_churn 1), image_to_image at strength 0.5, the base
   -> refiner handoff at strength 0.2; every run's UNet calls as its sampler
   reckons them (denoiser_calls), launches by kernel and route as its module
   calls imply (K1 at [2,4096,10x64] and [2,1024,20x64], the normalise-first K1
   at every 77-key cross-attention, K3 at the VAE's 16384-token mid attention,
   K11, K12, the GroupNorm forward), every decode finite before the clamp.
22. api_fp32: sd_xl_tiny.yaml and sd_xl_refiner_tiny.yaml in fp32 at 256x256,
   each of the six samplers for 3 steps through text_to_image and the refiner,
   card (kernels, all on their fp32 routes) vs CPU (plain versions) on the same
   weights and noise: latents and images within API_FP32_TOL of max |CPU|.
23. api_t5 (after api_fp32): sd_2_1.yaml's UNet (context_dim 4096) under a
   T5 v1.1-XXL encoder at full width (scripts/t5_path.py; random bf16 weights,
   the YAML written to a temp dir): text_to_image at 512x512, 25 Euler steps,
   CFG 5, on 77 seeded ids; seconds per image, of the two T5 passes and per
   UNet call (CUDA events), peak memory, without the call-counting hook; one
   T5 pass's device time as a CUDA graph's replay (its idle share); then with
   the hook: the decode finite before the clamp, launches by kernel and route
   as the module calls imply, the normalise-first K1 at the 10 77-key sites
   of 4096 and 1024 queries per UNet call, the short walk at 256 and 64. Then
   a tiny T5 in fp32 card vs CPU (T5_FP32_TOL) and the class-conditioned tiny
   config's conditioner card vs CPU.
24. demo: scripts/demo/serve.py's DemoApp on sd_2_1.yaml at 512x512 served on
   127.0.0.1 in a thread: GET / and /health, a txt2img and an img2img POST
   (25 steps; strength 0.75 on a PNG under --init-root), each timed without
   the call-counting hook and sent again under it for its launches, each PNG
   within DEMO_PNG_LEVELS of the SamplingPipeline's image for the same seed, an init
   path escaping the root answered by JSON 500 (PermissionError); then a
   DemoApp on svd.yaml, one img2vid POST at 1024x576 x 14 frames returning a
   14-frame GIF; each request's launches; seconds per request.
25. safety: SafetyFilter with a CLIP ViT-L/14 tower (random bf16) on the demo's
   two images, synthetic heads (one flags every frame): K3's normalise-first
   mode at D = 64 only, features / logits / flags / blurred frames held to the
   same tower in fp32 on the CPU; embed_watermark on a 512x512 image, 48 of 48
   bits decoded; frechet_distance in float64 on the card for two seeded 2048 x
   1024 populations vs scipy's sqrtm (FID_RTOL); prefetch_to_device onto the
   card in order; utils/profiling.trace naming a K1 kernel.
26. model_options (after tiny): svd_tiny.yaml's UNet with the AlphaBlender
   merge 'fixed' and 'learned' and video_kernel_size (2, 1, 1), (3, 3, 3) and
   (1, 3, 3), the VideoDecoder with the three kernels: fp32 card vs CPU,
   forward and one backward (outputs within UNET_REL_TOL x max |CPU|,
   gradients within GRAD_REL_TOL by norm); K4 launched twice (forward, dx) per
   (kt, 1, 1) TemporalConv, kt = 2 included, none where kh or kw is above 1,
   which runs kt F.conv2d taps forward instead. The kernel phase holds K4 and
   its dx at kt = 2 and 4 in bf16 at UNet ds2.
27. fsdp_runs (after main, on its pipeline): a one-rank NCCL process group
   (parallel/mesh.py) and the main path's run_single_video with its runs over
   it (parallel/runs.py): the main run's launches, and its latents, maps,
   masks and labels bit-equal to the main run's.
28. fsdp (after train): the train phase's step wrapped by parallel/fsdp.py's
   fsdp_wrap on that group (FSDPTrainStep), FSDP_STEPS steps, cuDNN's
   deterministic algorithms on: the launches of as many remat steps; no
   K4 / K12 weight copy read in the last step older than its weight; every
   step-1 gradient, parameter and EMA element equal, leaf by leaf, to an
   unwrapped run given FSDP's input nodes (a planted fault, one leaf's update
   undone, must be reported); against the plain unwrapped run the step-1
   gradients and what the steps changed within FSDP_GRAD_TOL /
   FSDP_UPDATE_TOL by norm (FSDP's input nodes re-associate the bf16 sums of
   multi-consumer gradients); step seconds of both; then trap (b) forced
   (copies never retired, the storage pointer unread): the stale-copy count
   and the leaf check must both report it.
29. ae_video_train (last): svd.yaml's own first stage (Encoder + the temporal
   VideoDecoder, no quant convs) through scripts/autoencoder_train_path.py's
   AutoencoderTrainStep (bf16, LPIPS, the discriminator, Adam x2, the
   adversarial term from step 0) on one clip of 7 frames of 448x832, at
   time_mode 'conv-only' (svd.yaml's), 'all' and 'attn-only': a warm-up step,
   then AE_VIDEO_STEPS steps with the counts set to 0; every launch reckoned
   from the modules (ae_video_launches_per_step): K3 and K13 at the mid
   attentions [7,1,5824,512]; in a VideoAttnBlock K1 + K5 at one 512-dim head
   ([7,5824,1x512]: K5 on K13's wgmma kernels through the packed strides) and
   K2 + K6 at D = 512 (the time mix at t = 7: K2 on the team kernel, route
   tc_short, K6 on its tensor-core kernel, route mma), K11 at its
   eight projections; K4 forward and dx at every TemporalConv ([1,7,372736,128]
   and up), the narrow kernel at conv_out's 3-channel time mix; the GroupNorm
   forward and backward by route, the backward's route as the card places it
   (the live placement query agrees with the shape's, in every phase); no
   plain version; finite logs, p_loss > 0, every gradient finite, the last
   Adam step of both phases taken (check_adam_step); seconds per step, peak
   memory. Then 'all' in fp32 at 2 frames of 128x256 (a 512-token latent: the
   mid attentions, attn2 and the time mix on their kernels as at full width;
   K3 / K13 and K1 / K5 at D = 512 on the split-TF32 kernels, the run whose
   launches the tf32x3 entries report; K2 and K6 over the 2 frames on the
   wide kernels, their route at so few frames: the run whose launches the
   temporal_attention_direct_d512 entry reports), card vs CPU gradients of every
   first-stage parameter within GRAD_REL_TOL.
30. long_video (after api_img2vid, on a pipeline of its own): the main path
   of phase 6 at full width over 40 synthetic 448x832 frames, the pipeline
   built for 40 frames: every temporal self-attention site runs K2 over 40
   frames, past the 32 of its tiled kernels. The main path's checks at 40
   frames (launches by kernel and route as the calls imply, the first stage at
   6 chunks a pass), every K2 launch at t = 40 and D = 64 on the tensor-core
   kernel past 32 frames (the run of the temporal_attention_direct_long entry); its seconds and
   peak memory.
With `--ranks` under `torchrun --nproc_per_node W` on W cards (main_ranks):
the main path's runs over the W ranks bit-equal to one rank's run, and the
training step FSDP-wrapped over the W ranks, a video each, against the
unwrapped step on one card's batch of W videos;
one JSON line of those readings (no kernels line).
The kernel phase also holds the instances at the head dims the tuned kernels
are not built for (D = 16: K1, K2, K3, K5, K6, K13; one 512-dim head: K1, K2
(the team kernel at 7, 14 and 32 frames, fp32 also held to the plain version in
float64; the wide kernel at 2 frames and at the frame below the crossover),
and their backwards K5 (K13's kernels on the packed strides) and K6 (its
tensor-core kernels at 7 and 14 frames and the 32-row tile at 17 and 32, split
TF32 in fp32, also held to the plain version in float64; the wide kernel at 3
frames)), and K2 and K6 past 32 frames (33, 48 and 64; 65 at D = 64) at D = 64 ([t,5824,5,64])
and 512 on the tensor-core kernels and 16 on the frame walk (fp32 at D = 512 also held to the
plain version in float64), against their plain versions in bf16 and fp32 (K5 and K13
at bf16 D = 16 on their mma.sync kernels), and the normalise-first mode
of K1 and K3 at D = 16 in bf16, also held to mha_reference. The fp32 routes at
D = 64 are timed at their ds1 shapes beside the library call in full fp32: K2
and K6 at [28,5824,5,64]
(t = 14; K6 on the resident split-TF32 kernel, also at t = 2 and 32, held to
the plain version in float64: the temporal_attention_direct_backward_fp32_tc
entry, whose launches train_grad's run reports). K1 / K3 in fp32 at D = 64 and
K4 in fp32 run split-TF32 tensor-core kernels (route tf32x3; entries
flash_attention_packed_tf32x3_d64, whose launches train_grad's run reports (also
the unet and api_fp32 runs'), and temporal_conv_1x1_tf32x3, whose launches the
unet run reports (also train_grad's and model_options')): K1 at ds1 on a B = 2
slice and the CFG batch (the plain version two batch items at a time), ds2, ds4,
mid, SD 2.1's 77-key cross-attention and train_grad's four spatial sites, K3 at
ViT-L/14's [2,16,257,64]; K4 at the UNet's ds1, ds2 and ds4 time_stacks, the
VAE's 448x832 frames, [2,14,91,320], one frame, Cin = 1032 and dx at ds4; each
also held to the plain version in float64 (FP64_RMS_TOL). check_fp32_routes
asserts, in unet, train_grad, each api_fp32 run and model_options, that every
fp32 K1 / K3 launch at D = 64 (and 512) and every fp32 K4 launch TMA can address
ran on tf32x3 and the rest on the FMA kernels. K5 in fp32 at D = 64 and K11 in fp32 run split-TF32
tensor-core kernels (route tf32x3; entries flash_attention_packed_backward_tf32x3_d64,
whose launches train_grad's run reports, and matmul_bias_tf32x3, whose launches the
unet, api_fp32 and train_grad runs report): K5 at ds1 [2,5824,5x64] and at
train_grad's four spatial sites ([4,256,5x64], [4,64,10x64], [4,16,20x64],
[4,4,20x64]), K11 at ds2 [40768,640->640] with a bias and the SD context product
[2156,1024->320], each also held to the plain version in float64 (FP64_RMS_TOL).
The FMA kernels that fp32 inputs TMA cannot address still take are held too,
each counted on its wrapper's .fma_launches: K5's and K1's at ds1 [2,5824,5x64] with
bases 4 bytes off a 16-byte boundary, K1's at D = 16, K11's tile at [40768,638->640]
(K % 4 != 0), K4's at the VAE's 3-channel conv_out_time_mix and at the ds1
time_stack with x 4 bytes off.

Before the last line come the kernels JSON (per kernel: launches in the run
of its path and in the other runs (injected, SD, diffusion training,
autoencoder training, the SVD and SD sweeps summed over their windows, the
inversion run, the two VideoDecoder decodes summed, the tiny run, the
40-frame main path (long_video_launches), the
three modes' steps of svd.yaml's first stage summed (ae_video_train_launches), and the
sampling API's runs: api_launches (api_sdxl's runs summed), img2vid_launches,
nti_launches; t5_launches,
demo_launches (its three requests summed), safety_launches; the model options'
card runs, the runs over the group and the FSDP steps: model_options_launches,
fsdp_runs_launches, fsdp_launches; a head-dim
instance's at its D, its `path` naming the run of its `launches`), for
K1-K6, K11 and K13 the launches of each run by the kernel that ran
(`routes`), worst error, kernel, plain, bound and library-call ms at its
headline shape; the normalise-first kernels of K1 and K3 as entries of their
own at each D (D = 64 and 80: their path the SD run and the main run; D =
16: K3's the tiny run; K3 at D = 64: the safety run), counted apart from the other launches at that D; K5 also
at the training batch) and the card's name and power limit; the last line
is {"ok": true, "device": ...}.
"""

import contextlib
import dataclasses
import functools
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
    # K9 + K10 in one launch where one sample's slab of x and dy fits in the shared memory of a
    # block or a cluster: JAX's _gn_bwd_pallas runs both pallas_calls (the stats at :258, the apply at :294)
    "group_norm_backward_slab": dict(
        id="K9+K10 slab", source="vidseg_diffusion_tpu_torch/csrc/group_norm_bwd.cu",
        replaces="vidseg_diffusion_tpu/ops/norm.py:258", rms_tol=5e-4,
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
    # the fp32 attention at D = 512 on split TF32 products (route 7, "tf32x3"): the forward of K3 at the
    # VAE's mid attention and of K1 at one 512-dim head, and their gradients (K13, and K5 on K13's kernels);
    # launched from flash_attention.cu / flash_attention_bhld_bwd.cu. Their launches are the `route_of`
    # wrappers' .tf32x3_launches in the run of their path (ae_video_grad: svd.yaml's first stage at 'all'
    # in fp32 under a gradient)
    "flash_attention_tf32x3": dict(
        id="K3/K1 fp32 D=512 split TF32", source="vidseg_diffusion_tpu_torch/csrc/tf32x3_attention.cuh",
        replaces="vidseg_diffusion_tpu/ops/attention.py:297", rms_tol=4e-3,
        route_of=("flash_attention", "flash_attention_packed"), path="ae_video_grad",
    ),
    "flash_attention_backward_tf32x3": dict(
        id="K13/K5 fp32 D=512 split TF32", source="vidseg_diffusion_tpu_torch/csrc/tf32x3_attention.cuh",
        replaces="vidseg_diffusion_tpu/ops/attention.py:1025", rms_tol=1e-3,
        route_of=("flash_attention_backward", "flash_attention_packed_backward"), path="ae_video_grad",
    ),
    # K2 and K6 past 32 frames (route 8, "long"): at D = 64 and 512 the tensor-core kernels of
    # temporal_attention_long_tc.cu, at D = 16 the frame-walking kernels of temporal_attention_long.cu. Their
    # launches are the wrapper's long-route launches at those head dims (.long_dim_launches) in the run of
    # their path (long_video: svd.yaml's main path over 40 frames; vae_long_grad: the VideoDecoder at 'all'
    # in fp32 under a gradient over 34 latents); no path runs the D = 16 instance past 32 frames
    "temporal_attention_direct_long": dict(
        id="K2 past 32 frames D=64/512", source="vidseg_diffusion_tpu_torch/csrc/temporal_attention_long_tc.cu",
        replaces="vidseg_diffusion_tpu/ops/attention.py:1458", rms_tol=1e-3,
        wrapper="temporal_attention_direct", long_dims=(64, 512), path="long_video",
    ),
    "temporal_attention_direct_backward_long": dict(
        id="K6 past 32 frames D=64/512", source="vidseg_diffusion_tpu_torch/csrc/temporal_attention_long_tc.cu",
        replaces="vidseg_diffusion_tpu/ops/attention.py:1167", rms_tol=2e-4,
        wrapper="temporal_attention_direct_backward", long_dims=(64, 512), path="vae_long_grad",
    ),
    "temporal_attention_direct_long_d16": dict(
        id="K2 past 32 frames D=16", source="vidseg_diffusion_tpu_torch/csrc/temporal_attention_long.cu",
        replaces="vidseg_diffusion_tpu/ops/attention.py:1458", rms_tol=1e-3,
        wrapper="temporal_attention_direct", long_dims=(16,), path=None,
    ),
    "temporal_attention_direct_backward_long_d16": dict(
        id="K6 past 32 frames D=16", source="vidseg_diffusion_tpu_torch/csrc/temporal_attention_long.cu",
        replaces="vidseg_diffusion_tpu/ops/attention.py:1167", rms_tol=2e-4,
        wrapper="temporal_attention_direct_backward", long_dims=(16,), path=None,
    ),
    # up to 32 frames on the tensor-core kernels of temporal_attention_long_tc.cu (route 9, "tc_short"): K2 at
    # one 512-dim head from csrc/temporal_attention.cu's crossover (kTc512FwdMinFrames*: 5 frames in bf16, 7 in
    # fp32; the team kernel) and K6 in fp32 at D = 64 from 2 frames (the resident kernel); below the crossover K2
    # at D = 512 keeps the wide kernel of temporal_attention.cu (route "wide"). Their launches are the wrapper's
    # launches on that `route` in the run of their path (vae_time_mode: the VideoDecoder's two time modes in
    # bf16, t = 7; train_grad: the full-width UNet's fp32 gradients, t = 2; ae_video_grad: svd.yaml's first
    # stage at 'all' in fp32 over 2 frames)
    "temporal_attention_direct_d512_tc": dict(
        id="K2 D=512 up to 32 frames", source="vidseg_diffusion_tpu_torch/csrc/temporal_attention_long_tc.cu",
        replaces="vidseg_diffusion_tpu/ops/attention.py:1458", rms_tol=1e-3,
        route_of=("temporal_attention_direct",), route="tc_short", path="vae_time_mode",
    ),
    "temporal_attention_direct_d512": dict(
        id="K2 D=512 below the crossover", source="vidseg_diffusion_tpu_torch/csrc/temporal_attention.cu",
        replaces="vidseg_diffusion_tpu/ops/attention.py:1458", rms_tol=1e-3,
        route_of=("temporal_attention_direct",), route="wide", path="ae_video_grad",
    ),
    "temporal_attention_direct_backward_fp32_tc": dict(
        id="K6 fp32 D=64 2-32 frames", source="vidseg_diffusion_tpu_torch/csrc/temporal_attention_long_tc.cu",
        replaces="vidseg_diffusion_tpu/ops/attention.py:1167", rms_tol=2e-4,
        route_of=("temporal_attention_direct_backward",), route="tc_short", path="train_grad",
    ),
    # K5 in fp32 at D = 64 and K11 in fp32 on split-TF32 products (route 7, "tf32x3"): K5's mma.sync kernels
    # (flash_attention_bwd_x3.cu; JAX's dq and dk/dv pallas_calls at :993 and :1025) and the split-TF32 consumer
    # of the persistent wgmma loop (wgmma_tile.cuh, launched from matmul_bias.cu). Their launches are the
    # wrapper's tf32x3 launches in the run of their path (train_grad: the full-width UNet's fp32 gradients, every
    # K5 launch at D = 64; unet and api_fp32: fp32 forwards, K11's launches there too, in `paths`)
    "flash_attention_packed_backward_tf32x3_d64": dict(
        id="K5 fp32 D=64 split TF32", source="vidseg_diffusion_tpu_torch/csrc/flash_attention_bwd_x3.cu",
        replaces="vidseg_diffusion_tpu/ops/attention.py:993", rms_tol=1e-3,
        route_of=("flash_attention_packed_backward",), route="tf32x3", path="train_grad",
    ),
    "matmul_bias_tf32x3": dict(
        id="K11 fp32 split TF32", source="vidseg_diffusion_tpu_torch/csrc/matmul_bias.cu",
        replaces="vidseg_diffusion_tpu/ops/matmul.py:94", rms_tol=5e-4,
        route_of=("matmul_bias",), route="tf32x3", path="unet", paths=("unet", "api_fp32", "train_grad"),
    ),
    # K1 and K3 in fp32 at D = 64 and K4 in fp32 on split-TF32 products (route 7, "tf32x3"): K1's mma.sync kernel
    # (flash_attention_x3.cu; JAX's packed forward at :527, also _small_seq_kernel at :687 and K3's _flash_kernel at
    # :297) and K4 on the split-TF32 consumer of the persistent wgmma loop (launched from temporal_conv.cu). Their
    # launches are the wrappers' tf32x3 launches in the run of their path (train_grad: the full-width UNet's fp32
    # forward under a gradient, every K1 launch at D = 64; unet: fp32 forwards; api_fp32: the tiny SDXL VAEs'
    # 64-dim mid attention (K3); model_options: svd_tiny's TemporalConv variants, in `paths`)
    "flash_attention_packed_tf32x3_d64": dict(
        id="K1/K3 fp32 D=64 split TF32", source="vidseg_diffusion_tpu_torch/csrc/flash_attention_x3.cu",
        replaces="vidseg_diffusion_tpu/ops/attention.py:527", rms_tol=1e-3,
        route_of=("flash_attention_packed", "flash_attention"), route="tf32x3", path="train_grad",
        paths=("unet", "api_fp32", "train_grad"),
    ),
    "temporal_conv_1x1_tf32x3": dict(
        id="K4 fp32 split TF32", source="vidseg_diffusion_tpu_torch/csrc/temporal_conv.cu",
        replaces="vidseg_diffusion_tpu/ops/temporal_conv.py:103", rms_tol=5e-4,
        route_of=("temporal_conv_1x1",), route="tf32x3", path="unet", paths=("unet", "train_grad", "model_options"),
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
    # the safety filter's CLIP ViT-L/14 (64-dim heads, 257 tokens), K3's normalise-first mode at D = 64
    ("flash_attention_normalised_d64", "K3 normalise-first D=64", "flash_attention.cu", 75, 4e-3, "flash_attention",
     64, "safety"),
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
    # their gradients, when svd.yaml's first stage trains: K5 at one 512-dim head runs K13's
    # D = 512 kernels on the packed strides (JAX reaches :993 / :1025 there), K6 its tensor-core
    # kernels (4 (bf16) / 5 (fp32) to 32 frames; below them the wide kernel of temporal_attention_bwd.cu)
    ("flash_attention_packed_backward_d512", "K5 D=512 one head", "flash_attention_bhld_bwd.cu", 993, 1e-3,
     "flash_attention_packed_backward", 512, "ae_video_train"),
    ("temporal_attention_direct_backward_d512", "K6 D=512", "temporal_attention_bwd_512.cu", 1167, 2e-4,
     "temporal_attention_direct_backward", 512, "ae_video_train"),
):
    KERNELS[_name] = dict(id=_id, source=_CSRC + _src, replaces=_JAX + str(_line), rms_tol=_tol, wrapper=_wrapper,
                          dim=_dim, path=_path, normalised="normalised" in _name)
INFERENCE_KERNELS = ("flash_attention_packed", "temporal_attention_direct", "flash_attention",
                     "temporal_conv_1x1", "group_norm_stats", "group_norm_apply", "group_norm_fused",
                     "matmul_bias", "conv3x3_same")
TRAIN_KERNELS = ("flash_attention_packed", "temporal_attention_direct", "temporal_conv_1x1",
                 "flash_attention_packed_backward", "temporal_attention_direct_backward",
                 "group_norm_stats", "group_norm_apply", "group_norm_fused", "group_norm_backward_slab",
                 "group_norm_backward_stats", "group_norm_backward_apply", "matmul_bias", "conv3x3_same")
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
LONG_VIDEO_FRAMES = 40   # long_video: the main path over 40 frames


def main_calls(t, decoding_t):
    """MAIN_CALLS at t frames decoded decoding_t at a time: the UNet's calls
    do not depend on t; the encoder runs one call a chunk of the video and one
    for the conditioning frame, the decoder one a chunk for each of the 4 runs."""
    chunks = -(-t // decoding_t)
    return {"unet": MAIN_CALLS["unet"], "encoder": chunks + 1, "decoder": 4 * chunks}
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
# fp32: the least time this card needs for fp32-class products is on the tensor
# cores, as three TF32 products of split operands at 495 TFLOP/s or six bf16
# ones at 989 (the fp32 FMA units' 67 TFLOP/s are slower still), so an fp32
# bound by operations is flops / 165 TFLOP/s; the fp32 library calls beside a
# kernel run with TF32 off (full fp32), as the kernels compute
PEAK_FLOPS = {"bf16": 989e12, "fp32": 495e12 / 3}
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
# the fp32 D = 512 attention kernels on split TF32 products (route "tf32x3"): relative RMS error against the
# plain version run in float64 (their card readings: 1.2e-6 forward, 1.3e-6 to 1.5e-6 backward at 5824 tokens;
# one TF32 pass reads ~4e-4)
FP64_RMS_TOL = 1e-5
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
OPTION_GRAD_FACTOR = 4.0   # model_options: a card gradient's distance to the float64 run, x the CPU fp32 one's
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
    "group_norm_backward_slab": "UNet ds2 [28,28,52,640] (backward: cluster 2)",
    "group_norm_backward_stats": "UNet time_stack [2,14,56,104,320] (backward: stream)",
    "group_norm_backward_apply": "UNet time_stack [2,14,56,104,320] (backward: stream)",
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
    "temporal_attention_direct_d512": "time mix [2,5824,1,512] t=2 fp32",
    "temporal_attention_direct_d512_tc": "VideoAttnBlock time mix [7,5824,1,512] t=7 bf16",
    "temporal_attention_direct_backward_fp32_tc": "ds1 [28,5824,5,64] t=14 fp32",
    "flash_attention_packed_backward_tf32x3_d64": "ds1 B=2 slice [2,5824,5x64] fp32",
    "matmul_bias_tf32x3": "ds2 [40768,640->640] bias fp32",
    "flash_attention_packed_tf32x3_d64": "ds1 B=2 slice [2,5824,5x64] fp32",
    "temporal_conv_1x1_tf32x3": "UNet ds1 [2,14,5824,320] fp32",
    "flash_attention_normalised_d64": "ViT-L/14 [2,16,257,64]",
    "flash_attention_packed_backward_d512": "VideoAttnBlock attn2 [7,5824,1x512] bf16",
    "temporal_attention_direct_backward_d512": "VideoAttnBlock time mix [7,5824,1,512] t=7 bf16",
    "flash_attention_tf32x3": "VAE mid [7,1,5824,512] fp32",
    "flash_attention_backward_tf32x3": "VAE mid [7,1,5824,512] fp32",
    "temporal_attention_direct_long": "ds1 [48,5824,5,64] t=48 bf16",
    "temporal_attention_direct_backward_long": "ds1 [48,5824,5,64] t=48 bf16",
    "temporal_attention_direct_long_d16": "tiny ds1 [48,5824,2,16] t=48 bf16",
    "temporal_attention_direct_backward_long_d16": "tiny ds1 [48,5824,2,16] t=48 bf16",
}
# launches of one training step (remat on: every ResBlock and transformer runs
# its forward twice, in the step's forward and in the backward's recompute):
# 16 spatial and 16 temporal self-attention sites x 2 forwards and 1 backward;
# 44 temporal convs x (2 forwards + the dx launch of the backward). The
# GroupNorm kernels, K11 and K12 are reckoned from the modules (train_launches).
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


EVEN_KT_LIBRARY = "F.conv3d pads kt // 2 frames on both sides: T + 1 output frames"


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
    computes the same function, or None); the normalise-first cases also
    reference (mha_reference) and previous (the kernel that streams the keys
    from device memory, timed beside the resident one)."""
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

    def direct(b, s, h, dtype=bf):
        return lambda: tuple(rn(b, s, h, 64).to(dtype) for _ in range(3))

    def bhld(b, h, l, d, dtype=bf):
        return lambda: tuple(rn(b, h, l, d).to(dtype) for _ in range(3))

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

    def temporal_bwd(b, s, h, dtype=bf):
        def make():
            q, k, v, g = (rn(b, s, h, 64).to(dtype) for _ in range(4))
            return q, k, v, A.temporal_attention_direct(q, k, v, t=14), g
        return make

    def tconv_bwd(b, t, m, c, kt=3):
        return lambda: (rn(b, t, m, c).to(bf), (rn(kt, c, c) / (kt * c) ** 0.5).to(bf),
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
        # an even kt gives one frame more (symmetric padding): its gradient is zero
        g5 = F.pad(g.permute(0, 3, 1, 2).unsqueeze(-1), (0, 0, 0, 0, 0, y.shape[2] - g.shape[1]))
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
    # the kernels that stream the keys from device memory, timed beside the resident ones (`previous`)
    packed_streamed = lambda q, k, v, h: A._flash_attention_packed_forward(q, k, v, h, None, save_lse=False,
                                                                           normalise_first=True, streamed=True)
    for label, l, h in (("SD cross ds1 [28,5824x77,5x64]", 5824, 5), ("SD cross ds2 [28,1456x77,10x64]", 1456, 10)):
        add(kernel="flash_attention_packed_normalised", label=label, make=packed(28, l, h, 77),
            kern=lambda q, k, v, h: A.flash_attention_packed(q, k, v, h, normalise_first=True),
            plain=lambda q, k, v, h: A.flash_attention_packed_reference(q, k, v, h, normalise_first=True),
            reference=packed_mha, previous=packed_streamed, iters=3, work=attn_work(28, h, l, 77, 64),
            library=lambda q, k, v, h: (lambda a=[heads_view(x, h) for x in (q, k, v)]: sdpa(*a)))
    # (CLIP's is held to mha_reference over several draws: clip_normalised_pooled)
    bhld_streamed = lambda q, k, v: A._flash_attention_forward(q, k, v, None, save_lse=False, normalise_first=True,
                                                               streamed=True)
    add(kernel="flash_attention_normalised", label="CLIP ViT-H [1,16,257,80]", make=bhld(1, 16, 257, 80),
        kern=lambda q, k, v: A.flash_attention(q, k, v, normalise_first=True),
        plain=lambda q, k, v: A.flash_attention_reference(q, k, v, normalise_first=True),
        previous=bhld_streamed, iters=5, work=attn_work(1, 16, 257, 257, 80),
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
    # K3 in fp32 at D = 512 on split TF32 products: the VAE mid attention's shape and the 64 tokens of
    # ae_grad's 64x64 frames
    for label, shape, iters in (("VAE mid [7,1,5824,512] fp32", (7, 1, 5824, 512), 2),
                                ("[2,1,64,512] fp32", (2, 1, 64, 512), 5)):
        add(kernel="flash_attention_tf32x3", label=label, make=bhld(*shape, dtype=torch.float32),
            kern=A.flash_attention, plain=A.flash_attention_reference, iters=iters,
            work=attn_work(shape[0], shape[1], shape[2], shape[2], shape[3], dtype="fp32"),
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
        ("kt=2 UNet ds2 [2,14,1456,640]", 2, 14, 1456, 640, 640, 2, bf),
        ("kt=4 UNet ds2 [2,14,1456,640]", 2, 14, 1456, 640, 640, 4, bf),
    ):
        dname = "bf16" if dtype == bf else "fp32"
        add(kernel="temporal_conv_1x1", label=label, make=tconv(b, t, m, ci, co, kt, dtype),
            kern=TC.temporal_conv_1x1, plain=TC.temporal_conv_1x1_reference, iters=3,
            work=tconv_work(b, t, m, ci, co, kt, dname), library=conv3d_call,
            library_covers=EVEN_KT_LIBRARY if kt % 2 == 0 else None)
    # training path (the train phase's batch of 2 videos x 14 frames):
    # K4's dx launch inside the temporal-conv backward (dW/db are matmuls),
    # K5 at every spatial self-attention width (ds1 on a B=2 slice: the
    # plain backward holds several [B, H, L, L] fp32 tensors), K6 at every
    # temporal one
    # (kt = 2 and 4: dx's taps one frame off K4's own offset, read as kt + 1
    # taps with a zero tap in front)
    for label, m, c, kt in (("dx UNet ds1 [2,14,5824,320]", 5824, 320, 3),
                            ("dx UNet ds4 [2,14,364,1280]", 364, 1280, 3),
                            ("dx kt=2 UNet ds2 [2,14,1456,640]", 1456, 640, 2),
                            ("dx kt=4 UNet ds2 [2,14,1456,640]", 1456, 640, 4)):
        bts, fl, pk = tconv_work(2, 14, m, c, c, kt)
        add(kernel="temporal_conv_1x1", label=label, make=tconv_bwd(2, 14, m, c, kt),
            kern=TC.temporal_conv_1x1_backward, plain=TC.temporal_conv_1x1_backward_reference,
            iters=3, work=(2 * bts, 2 * fl, pk), library=conv3d_backward,  # dx and dW: two such products
            library_covers=EVEN_KT_LIBRARY if kt % 2 == 0 else None)
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
    # K13 in fp32 at D = 512 on split TF32 products at the VAE mid attention's shape
    add(kernel="flash_attention_backward_tf32x3", label="VAE mid [7,1,5824,512] fp32",
        make=bhld_bwd(7, 1, 5824, 5824, 512, dtype=torch.float32), kern=A.flash_attention_backward,
        plain=A.flash_attention_backward_reference, iters=2,
        work=attn_work(7, 1, 5824, 5824, 512, backward=True, dtype="fp32"),
        library=lambda q, k, v, o, lse, g: sdpa_backward([q, k, v], g))
    # the sampling API's paths, drawn after every other case, so the earlier
    # cases keep their inputs: the SDXL base at 1024x1024 (K1 at ds2 and at
    # ds4 = the mid block, the normalise-first K1 at their 77-key
    # cross-attention, K3 at the VAE's mid attention over 128x128 latents), the
    # refiner (12 and 24 heads; its ds8 mid block on the fp32-sum kernel, its
    # 77-key cross-attention there too), img2vid at 1024x576 (K1 and K2 at ds1's
    # 9216 tokens of the CFG batch of 28, K1's plain version two videos' frames
    # at a time; K4 at the ds1 time stack; K3 at the decoder's mid attention, one
    # frame a call), null-text inversion on SD 2.1 at 512x512 (K5 at its two
    # flash sites, with K1's LSE; the normalise-first K1 at its 4096x77 site)
    late = []
    add = lambda **kw: late.append(kw)
    sdpa_packed = lambda q, k, v, h: (lambda a=[heads_view(x, h) for x in (q, k, v)]: sdpa(*a))

    def by_pairs(plain):
        """plain on two batch items at a time, concatenated (the plain version
        of [28, 9216] would hold 48 GB of fp32 logits)"""
        return lambda q, k, v, h: torch.cat([plain(q[i:i + 2], k[i:i + 2], v[i:i + 2], h)
                                             for i in range(0, q.shape[0], 2)])

    for label, b, l, lk, h in (("SDXL ds2 [2,4096,10x64]", 2, 4096, 4096, 10),
                               ("SDXL ds4 [2,1024,20x64]", 2, 1024, 1024, 20),
                               ("refiner ds2 [2,4096,12x64]", 2, 4096, 4096, 12),
                               ("refiner ds4 [2,1024,24x64]", 2, 1024, 1024, 24),
                               ("refiner mid [2,256,24x64]", 2, 256, 256, 24),
                               ("refiner cross mid [2,256x77,24x64]", 2, 256, 77, 24),
                               ("img2vid ds1 [28,9216,5x64]", 28, 9216, 9216, 5)):
        kern, plain = k1(l, lk)
        add(kernel="flash_attention_packed", label=label, make=packed(b, l, h, lk), kern=kern,
            plain=plain if b == 2 else by_pairs(plain), iters=3, work=attn_work(b, h, l, lk, 64),
            library=sdpa_packed)
    for label, l, h in (("SDXL cross ds2 [2,4096x77,10x64]", 4096, 10), ("SDXL cross ds4 [2,1024x77,20x64]", 1024, 20),
                        ("refiner cross ds2 [2,4096x77,12x64]", 4096, 12),
                        ("refiner cross ds4 [2,1024x77,24x64]", 1024, 24), ("NTI cross ds1 [2,4096x77,5x64]", 4096, 5)):
        add(kernel="flash_attention_packed_normalised", label=label, make=packed(2, l, h, 77),
            kern=lambda q, k, v, h: A.flash_attention_packed(q, k, v, h, normalise_first=True),
            plain=lambda q, k, v, h: A.flash_attention_packed_reference(q, k, v, h, normalise_first=True),
            reference=packed_mha, previous=packed_streamed, iters=3, work=attn_work(2, h, l, 77, 64),
            library=sdpa_packed)
    for label, shape in (("SDXL VAE mid [1,1,16384,512]", (1, 1, 16384, 512)),
                         ("img2vid VAE mid [1,1,9216,512]", (1, 1, 9216, 512))):
        add(kernel="flash_attention", label=label, make=bhld(*shape), kern=A.flash_attention,
            plain=A.flash_attention_reference, iters=2, work=attn_work(*shape[:3], shape[2], shape[3]),
            library=lambda q, k, v: (lambda: sdpa(q, k, v)))
    add(kernel="temporal_attention_direct", label="img2vid ds1 [28,9216,5,64] t=14", make=direct(28, 9216, 5),
        kern=lambda q, k, v: A.temporal_attention_direct(q, k, v, t=14),
        plain=lambda q, k, v: A.temporal_attention_direct_reference(q, k, v, t=14), iters=3,
        work=attn_work(2 * 9216, 5, 14, 14, 64),
        library=lambda q, k, v: (lambda a=[frames_view(x) for x in (q, k, v)]: sdpa(*a)))
    add(kernel="temporal_conv_1x1", label="img2vid UNet ds1 [2,14,9216,320]", make=tconv(2, 14, 9216, 320, 320),
        kern=TC.temporal_conv_1x1, plain=TC.temporal_conv_1x1_reference, iters=3,
        work=tconv_work(2, 14, 9216, 320, 320), library=conv3d_call)
    for label, l, h in (("NTI ds1 [2,4096,5x64]", 4096, 5), ("NTI ds2 [2,1024,10x64]", 1024, 10)):
        add(kernel="flash_attention_packed_backward", label=label, make=packed_bwd(2, l, h),
            kern=A.flash_attention_packed_backward, plain=A.flash_attention_packed_backward_reference,
            iters=3, work=attn_work(2, h, l, l, 64, backward=True),
            library=lambda q, k, v, o, lse, g, h: sdpa_backward([heads_view(x, h) for x in (q, k, v)],
                                                                heads_view(g, h)))
    # the fp32 routes at D = 64 and K4 in fp32, drawn after every other case: K1 / K3 and K5's split-TF32
    # kernels, K2's CUDA-core kernel at t = 14, K6's resident split-TF32 kernel at t = 14, 2 and 32, K4's
    # split-TF32 kernel; and the FMA kernels the fp32 inputs TMA cannot address keep
    fp32_d64 = []
    add = lambda **kw: fp32_d64.append(kw)
    f32 = torch.float32
    # K1 in fp32 at D = 64 on the split-TF32 mma.sync kernel (route tf32x3), each also held to the plain version
    # in float64: ds1 on a B = 2 slice and at the CFG batch of 28 (its plain version two batch items at a time),
    # ds2, ds4, mid, SD 2.1's 77-key cross-attention at ds1 and train_grad's four spatial sites; K3 on its bhld
    # strides at ViT-L/14's heads
    k1f = A.flash_attention_packed
    for label, b, lq, lk, h in (("ds1 B=2 slice [2,5824,5x64] fp32", 2, 5824, 5824, 5),
                                ("ds1 CFG batch [28,5824,5x64] fp32", 28, 5824, 5824, 5),
                                ("ds2 [28,1456,10x64] fp32", 28, 1456, 1456, 10),
                                ("ds4 [28,364,20x64] fp32", 28, 364, 364, 20), ("mid [28,91,20x64] fp32", 28, 91, 91, 20),
                                ("SD cross ds1 [28,5824x77,5x64] fp32", 28, 5824, 77, 5),
                                ("train_grad ds1 [4,256,5x64] fp32", 4, 256, 256, 5),
                                ("train_grad ds2 [4,64,10x64] fp32", 4, 64, 64, 10),
                                ("train_grad ds4 [4,16,20x64] fp32", 4, 16, 16, 20),
                                ("train_grad mid [4,4,20x64] fp32", 4, 4, 4, 20)):
        kern, plain = k1(lq, lk)
        add(kernel="flash_attention_packed_tf32x3_d64", label=label,
            make=lambda b=b, lq=lq, lk=lk, h=h: (rn(b, lq, h * 64), rn(b, lk, h * 64), rn(b, lk, h * 64), h),
            counted=lambda: k1f.tf32x3_launches, kern=kern,
            plain=plain if b * h * lq * lk <= 10 * 5824 * 5824 else by_pairs(plain),
            iters=2 if lq * lk > 1e7 else 5, work=attn_work(b, h, lq, lk, 64, dtype="fp32"), library=sdpa_packed)
    add(kernel="flash_attention_packed_tf32x3_d64", label="K3 ViT-L/14 [2,16,257,64] fp32",
        make=bhld(2, 16, 257, 64, dtype=f32), counted=lambda: A.flash_attention.tf32x3_launches, kern=A.flash_attention,
        plain=A.flash_attention_reference, iters=5, work=attn_work(2, 16, 257, 257, 64, dtype="fp32"),
        library=lambda q, k, v: (lambda: sdpa(q, k, v)))
    # K1's FMA kernel, which fp32 D = 64 inputs that TMA cannot address keep (and D = 16): q, k and v at ds1
    # with their bases 4 bytes off a 16-byte boundary; SDPA on aligned copies of the same values
    kern, plain = k1(5824, 5824)
    add(kernel="flash_attention_packed", label="ds1 B=2 slice [2,5824,5x64] fp32 unaligned (FMA)",
        make=lambda: tuple(rn(2 * 5824 * 320 + 1)[1:].view(2, 5824, 320) for _ in range(3)) + (5,),
        counted=lambda: k1f.fma_launches, kern=kern, plain=plain, iters=2,
        work=attn_work(2, 5, 5824, 5824, 64, dtype="fp32"),
        library=lambda q, k, v, h: sdpa_packed(q.clone(), k.clone(), v.clone(), h))

    # K5 in fp32 on the split-TF32 mma.sync kernels (route tf32x3) at ds1 and at train_grad's four spatial
    # sites (two 2-frame videos of 16 x 16 latents), also held to the plain version in float64
    k5 = A.flash_attention_packed_backward
    for label, b, l, h in (("ds1 B=2 slice [2,5824,5x64] fp32", 2, 5824, 5), ("train_grad ds1 [4,256,5x64] fp32", 4, 256, 5),
                           ("train_grad ds2 [4,64,10x64] fp32", 4, 64, 10),
                           ("train_grad ds4 [4,16,20x64] fp32", 4, 16, 20),
                           ("train_grad mid [4,4,20x64] fp32", 4, 4, 20)):
        def k5_fp32(b=b, l=l, h=h):
            q, k, v, g = (rn(b, l, h * 64) for _ in range(4))
            return (q, k, v) + A._flash_attention_packed_forward(q, k, v, h, None, save_lse=True) + (g, h)

        add(kernel="flash_attention_packed_backward_tf32x3_d64", label=label, make=k5_fp32,
            counted=lambda: k5.tf32x3_launches, kern=A.flash_attention_packed_backward,
            plain=A.flash_attention_packed_backward_reference, iters=2 if l > 1000 else 5,
            work=attn_work(b, h, l, l, 64, backward=True, dtype="fp32"),
            library=lambda q, k, v, o, lse, g, h: sdpa_backward([heads_view(x, h) for x in (q, k, v)],
                                                                heads_view(g, h)))

    # K5's FMA kernels, which fp32 D = 64 inputs that TMA cannot address still take (and fp32 D = 16): q, k, v
    # and g at ds1 with their bases 4 bytes off a 16-byte boundary; SDPA's backward (whose kernels fault on
    # such bases) on aligned copies of the same values
    def k5_fp32_unaligned():
        q, k, v, g = (rn(2 * 5824 * 320 + 1)[1:].view(2, 5824, 320) for _ in range(4))
        return (q, k, v) + A._flash_attention_packed_forward(q, k, v, 5, None, save_lse=True) + (g, 5)

    add(kernel="flash_attention_packed_backward", label="ds1 B=2 slice [2,5824,5x64] fp32 unaligned (FMA)",
        make=k5_fp32_unaligned, counted=lambda: k5.fma_launches, kern=A.flash_attention_packed_backward,
        plain=A.flash_attention_packed_backward_reference, iters=2,
        work=attn_work(2, 5, 5824, 5824, 64, backward=True, dtype="fp32"),
        library=lambda q, k, v, o, lse, g, h: sdpa_backward([heads_view(x.clone(), h) for x in (q, k, v)],
                                                            heads_view(g.clone(), h)))
    add(kernel="temporal_attention_direct", label="ds1 [28,5824,5,64] t=14 fp32", make=direct(28, 5824, 5, f32),
        kern=lambda q, k, v: A.temporal_attention_direct(q, k, v, t=14),
        plain=lambda q, k, v: A.temporal_attention_direct_reference(q, k, v, t=14), iters=3,
        work=attn_work(2 * 5824, 5, 14, 14, 64, dtype="fp32"),
        library=lambda q, k, v: (lambda a=[frames_view(x) for x in (q, k, v)]: sdpa(*a)))
    # K6 in fp32 at two videos of the ds1 site on the resident split-TF32 kernel (route tc_short): t = 2
    # (train_grad's), 14 and 32 (two warps a problem), also held to the plain version in float64
    k6 = A.temporal_attention_direct_backward
    for t in (14, 2, 32):
        def k6_make(t=t):
            q, k, v, g = (rn(2 * t, 5824, 5, 64) for _ in range(4))
            return q, k, v, A.temporal_attention_direct(q, k, v, t=t), g

        frames_t = lambda x, t=t: x.view(2, t, *x.shape[1:]).permute(0, 2, 3, 1, 4)
        add(kernel="temporal_attention_direct_backward_fp32_tc", label=f"ds1 [{2 * t},5824,5,64] t={t} fp32",
            make=k6_make, counted=lambda: k6.tc_short_launches, fp64_held=True,
            kern=lambda q, k, v, o, g, t=t: A.temporal_attention_direct_backward(q, k, v, o, g, t=t),
            plain=lambda q, k, v, o, g, t=t: A.temporal_attention_direct_backward_reference(q, k, v, o, g, t=t),
            iters=3, work=attn_work(2 * 5824, 5, t, t, 64, backward=True, dtype="fp32"),
            library=lambda q, k, v, o, g, f=frames_t: sdpa_backward([f(x) for x in (q, k, v)], f(g)))
    # K4 in fp32 on the split-TF32 wgmma kernel (route tf32x3), each also held to the plain version in float64:
    # the UNet's time_stacks at ds1, ds2 and ds4, the VAE decoder's at 448x832, the edges (91 tokens, one frame,
    # Cin = 1032: a last slice of 8 channels) and dx (+ dW and db, library products) at ds4
    tc = TC.temporal_conv_1x1
    for label, b, t, m, ci, co in (("UNet ds1 [2,14,5824,320] fp32", 2, 14, 5824, 320, 320),
                                   ("UNet ds2 [2,14,1456,640] fp32", 2, 14, 1456, 640, 640),
                                   ("UNet ds4 [2,14,364,1280] fp32", 2, 14, 364, 1280, 1280),
                                   ("VAE 448x832 [1,7,372736,128] fp32", 1, 7, 372736, 128, 128),
                                   ("fp32 [2,14,91,320]", 2, 14, 91, 320, 320), ("T=1 [2,1,5824,320] fp32", 2, 1, 5824, 320, 320),
                                   ("Cin=1032 [2,2,1456,1032->640] fp32", 2, 2, 1456, 1032, 640)):
        add(kernel="temporal_conv_1x1_tf32x3", label=label, make=tconv(b, t, m, ci, co, dtype=f32),
            counted=lambda: tc.tf32x3_launches, kern=tc, plain=TC.temporal_conv_1x1_reference, iters=3,
            work=tconv_work(b, t, m, ci, co, dtype="fp32"), library=conv3d_call)
    bts, fl, pk = tconv_work(2, 14, 364, 1280, 1280, dtype="fp32")
    add(kernel="temporal_conv_1x1_tf32x3", label="dx UNet ds4 [2,14,364,1280] fp32",
        make=lambda: (rn(2, 14, 364, 1280), rn(3, 1280, 1280) / (3 * 1280) ** 0.5, rn(2, 14, 364, 1280)),
        counted=lambda: tc.tf32x3_launches, kern=TC.temporal_conv_1x1_backward,
        plain=TC.temporal_conv_1x1_backward_reference, iters=3, work=(2 * bts, 2 * fl, pk), library=conv3d_backward)
    # K4's FMA tile, which fp32 inputs TMA cannot address keep: the VAE's 3-channel conv_out_time_mix and the
    # UNet's ds1 time_stack with x 4 bytes off a 16-byte boundary (F.conv3d on an aligned copy)
    add(kernel="temporal_conv_1x1", label="VAE conv_out_time_mix [1,7,372736,3] fp32 (FMA)",
        make=tconv(1, 7, 372736, 3, 3, dtype=f32), counted=lambda: tc.fma_launches, kern=tc,
        plain=TC.temporal_conv_1x1_reference, iters=3, work=tconv_work(1, 7, 372736, 3, 3, dtype="fp32"),
        library=conv3d_call)
    add(kernel="temporal_conv_1x1", label="UNet ds1 [2,14,5824,320] fp32 unaligned (FMA)",
        make=lambda: (rn(2 * 14 * 5824 * 320 + 1)[1:].view(2, 14, 5824, 320), rn(3, 320, 320) / (3 * 320) ** 0.5,
                      rn(320)),
        counted=lambda: tc.fma_launches, kern=tc, plain=TC.temporal_conv_1x1_reference, iters=3,
        work=tconv_work(2, 14, 5824, 320, 320, dtype="fp32"),
        library=lambda x, w, bias: conv3d_call(x.clone(), w, bias))
    return (cases + head_dim_cases(torch, rn) + group_norm_cases(torch, rn) + gemm_cases(torch, rn) + late
            + t5_demo_safety_cases(torch, rn, k1, packed, packed_mha, packed_streamed, bhld, bhld_streamed,
                                   sdpa_packed)
            + fp32_d64)


def t5_demo_safety_cases(torch, rn, k1, packed, packed_mha, packed_streamed, bhld, bhld_streamed, sdpa_packed):
    """The shapes the T5, demo and safety paths give the kernels, drawn after every other case:
    SD 2.1's UNet and VAE at 512x512 under the T5-XXL context (api_t5) and the
    demo's OpenCLIP one (demo): K1 at the four levels' self-attention and at the
    short 77-key sites (ds4, mid; the ds1 / ds2 ones run the normalise-first
    mode: ds2 here, ds1 is NTI's case), K3 at the VAE's mid attention over
    64x64 latents, K11 at to_q (ds1) and the to_k / to_v of the 4096-wide T5
    context and the 1024-wide OpenCLIP one (M = 2 x 77), K12 per level and the
    ds1 skip concatenation, the GroupNorm at the UNet's ds1 / ds2 and the VAE's
    512x512 sites; the normalise-first K3 at the safety filter's CLIP ViT-L/14
    (D = 64, two frames), also held to mha_reference."""
    import torch.nn.functional as F

    from vidseg_diffusion_tpu_torch.ops import attention as A

    bf = torch.bfloat16
    sdpa = F.scaled_dot_product_attention
    cases = []
    add = lambda **kw: cases.append(kw)
    for label, l, lk, h in (("SD 512 ds1 [2,4096,5x64]", 4096, 4096, 5), ("SD 512 ds2 [2,1024,10x64]", 1024, 1024, 10),
                            ("SD 512 ds4 [2,256,20x64]", 256, 256, 20), ("SD 512 mid [2,64,20x64]", 64, 64, 20),
                            ("SD 512 cross ds4 [2,256x77,20x64]", 256, 77, 20),
                            ("SD 512 cross mid [2,64x77,20x64]", 64, 77, 20)):
        kern, plain = k1(l, lk)
        add(kernel="flash_attention_packed", label=label, make=packed(2, l, h, lk), kern=kern, plain=plain, iters=3,
            work=attn_work(2, h, l, lk, 64), library=sdpa_packed)
    add(kernel="flash_attention_packed_normalised", label="SD 512 cross ds2 [2,1024x77,10x64]",
        make=packed(2, 1024, 10, 77), kern=lambda q, k, v, h: A.flash_attention_packed(q, k, v, h, normalise_first=True),
        plain=lambda q, k, v, h: A.flash_attention_packed_reference(q, k, v, h, normalise_first=True),
        reference=packed_mha, previous=packed_streamed, iters=3, work=attn_work(2, 10, 1024, 77, 64),
        library=sdpa_packed)
    add(kernel="flash_attention", label="SD 512 VAE mid [1,1,4096,512]", make=bhld(1, 1, 4096, 512),
        kern=A.flash_attention, plain=A.flash_attention_reference, iters=2, work=attn_work(1, 1, 4096, 4096, 512),
        library=lambda q, k, v: (lambda: sdpa(q, k, v)))
    add(kernel="flash_attention_normalised_d64", label=HEADLINE["flash_attention_normalised_d64"],
        make=bhld(2, 16, 257, 64), kern=lambda q, k, v: A.flash_attention(q, k, v, normalise_first=True),
        plain=lambda q, k, v: A.flash_attention_reference(q, k, v, normalise_first=True),
        reference=lambda q, k, v: A.mha_reference(q, k, v), previous=bhld_streamed, iters=5,
        work=attn_work(2, 16, 257, 257, 64),
        library=lambda q, k, v: (lambda: sdpa(q, k, v)))
    projections = (("SD 512 ds1 to_q [8192,320->320]", 8192, 320, 320, False, bf),
                   ("T5 to_k ds1 [154,4096->320]", 154, 4096, 320, False, bf),
                   ("T5 to_v ds2 [154,4096->640]", 154, 4096, 640, False, bf),
                   ("T5 to_k ds4 [154,4096->1280]", 154, 4096, 1280, False, bf),
                   ("demo to_k ds1 [154,1024->320]", 154, 1024, 320, False, bf))
    convs = (("SD 512 ds1 [2,64,64,320->320]", 2, 64, 64, 320, 320, bf),
             ("SD 512 ds1 skip concat [2,64,64,960->320]", 2, 64, 64, 960, 320, bf),
             ("SD 512 ds2 [2,32,32,640->640]", 2, 32, 32, 640, 640, bf),
             ("SD 512 ds4 [2,16,16,1280->1280]", 2, 16, 16, 1280, 1280, bf),
             ("SD 512 ds8 [2,8,8,1280->1280]", 2, 8, 8, 1280, 1280, bf))
    sites = [("SD 512 UNet ds1 [2,64,64,320]", (2, 64, 64, 320), bf, True, 1e-5),
             ("SD 512 UNet ds2 [2,32,32,640]", (2, 32, 32, 640), bf, True, 1e-5),
             ("SD 512 VAE [1,512,512,128]", (1, 512, 512, 128), bf, True, 1e-6)]
    return cases + gemm_cases(torch, rn, projections, convs) + group_norm_cases(torch, rn, sites)


def head_dim_cases(torch, rn):
    """The instances at the head dims the tuned kernels are not built for, in
    bf16 and fp32 (ROADMAP section C): D = 16 at svd_tiny.yaml's sites at the
    main path's 448x832 (CFG batch 28: ds1 5824 tokens x 2 heads, ds2 1456 x 4,
    the tiny CLIP tower's 257 tokens x 4 heads; K1 and K5 at ds1 on a B = 2
    slice, as the D = 64 cases), their backwards, K13 at D = 16 (K5's instance
    on K3's strides); D = 512 at the VideoDecoder VideoAttnBlock's sites of
    svd.yaml's decode (decoding_t 7 and 14: attn2 [bt, 5824, 1 x 512] through
    K1, the time mix [bt, 5824, 1, 512] through K2: the team kernel at 7, 14 and
    32 frames, the wide kernel at 2 and below the crossover) and their backwards on the
    7-frame training clip (K5 at one 512-dim head on K13's kernels, t = 7; K6
    on its tensor-core kernels at t = 7, 14, 17 and 32, on the wide kernel at
    t = 3, each launch on its route counter); K2 and K6 past 32 frames (33, 48
    and 64; 65 at D = 64, past the block that holds a problem whole) at D = 64 and 512 on the tensor-core
    kernels and 16 on the frame walk. Library: SDPA on the [B, H, L, D]
    views (K2: the [b, s, H, t, D] view), its backward through autograd.grad
    (the backend that takes the headline printed)."""
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
            fma = {} if dtype == torch.bfloat16 else {"counted": lambda: A.flash_attention_packed.fma_launches}
            cases.append(dict(kernel="flash_attention_packed_d16", label=f"{label} {dname}", **fma,
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
        # K2 at D = 512 up to 32 frames: the team kernel (route tc_short) from the C entry's crossover (5 frames in
        # bf16, 7 in fp32; fp32 also held to the plain version in float64), the wide kernel below it (2 frames,
        # ae_video_grad's and the fp32 decodes'; the frame below the crossover)
        k2 = A.temporal_attention_direct
        below = 4 if dtype == torch.bfloat16 else 6
        on_tc, on_wide = (lambda: k2.tc_short_launches), (lambda: k2.wide_launches)
        for label, t, entry, counted in (
                ("VideoAttnBlock time mix [7,5824,1,512] t=7", 7, "temporal_attention_direct_d512_tc", on_tc),
                ("VideoAttnBlock time mix [14,5824,1,512] t=14", 14, "temporal_attention_direct_d512_tc", on_tc),
                ("time mix [32,5824,1,512] t=32", 32, "temporal_attention_direct_d512_tc", on_tc),
                ("time mix [2,5824,1,512] t=2", 2, "temporal_attention_direct_d512", on_wide),
                (f"time mix [{below},5824,1,512] t={below}", below, "temporal_attention_direct_d512", on_wide)):
            cases.append(dict(kernel=entry, label=f"{label} {dname}", make=mk(*[(t, 5824, 1, 512)] * 3),
                              counted=counted, fp64_held=dtype == torch.float32 and counted is on_tc,
                              kern=lambda q, k, v, t=t: A.temporal_attention_direct(q, k, v, t=t),
                              plain=lambda q, k, v, t=t: A.temporal_attention_direct_reference(q, k, v, t=t), iters=5,
                              work=attn_work(5824, 1, t, t, 512, dtype=dname),
                              library=lambda q, k, v, t=t: (lambda a=[frames(x, t) for x in (q, k, v)]: sdpa(*a))))

        def k5_512_make(mk=mk):
            q, k, v, g = mk(*[(7, 5824, 512)] * 4)()
            out, lse = A._flash_attention_packed_forward(q, k, v, 1, None, save_lse=True)
            return q, k, v, out, lse, g, 1

        cases.append(dict(kernel="flash_attention_packed_backward_d512",
                          label=f"VideoAttnBlock attn2 [7,5824,1x512] {dname}", make=k5_512_make,
                          kern=A.flash_attention_packed_backward, plain=A.flash_attention_packed_backward_reference,
                          iters=2, work=attn_work(7, 1, 5824, 5824, 512, backward=True, dtype=dname),
                          library=lambda q, k, v, o, lse, g, h: sdpa_backward([heads(x, 1) for x in (q, k, v)],
                                                                              heads(g, 1))))
        # K6 at t = 7 and 14 on its tensor-core kernel (bf16 mma.sync, fp32 split TF32), at 17 and 32 on its
        # 32-row tile; at 3 frames on the wide kernel, which the C entry keeps below 4 (bf16) / 5 (fp32) frames
        k2, k6 = A.temporal_attention_direct, A.temporal_attention_direct_backward
        tc_route = ((lambda: k6.mma_launches) if dtype == torch.bfloat16 else (lambda: k6.tf32x3_launches))
        for label, t, counted in (("VideoAttnBlock time mix [7,5824,1,512] t=7", 7, tc_route),
                                  ("VideoAttnBlock time mix [14,5824,1,512] t=14", 14, tc_route),
                                  ("time mix [3,5824,1,512] t=3 wide kernel", 3, lambda: k6.wide_launches),
                                  ("time mix [17,5824,1,512] t=17 32-row tile", 17, tc_route),
                                  ("time mix [32,5824,1,512] t=32 32-row tile", 32, tc_route)):
            def k6_512_make(t=t, mk=mk):
                q, k, v, g = mk(*[(t, 5824, 1, 512)] * 4)()
                return q, k, v, A.temporal_attention_direct(q, k, v, t=t), g

            cases.append(dict(kernel="temporal_attention_direct_backward_d512", label=f"{label} {dname}",
                              make=k6_512_make, counted=counted,
                              kern=lambda q, k, v, o, g, t=t: A.temporal_attention_direct_backward(q, k, v, o, g, t=t),
                              plain=lambda q, k, v, o, g, t=t: A.temporal_attention_direct_backward_reference(
                                  q, k, v, o, g, t=t), iters=3,
                              work=attn_work(5824, 1, t, t, 512, backward=True, dtype=dname),
                              library=lambda q, k, v, o, g, t=t: sdpa_backward([frames(x, t) for x in (q, k, v)],
                                                                               frames(g, t))))
        # K2 and K6 past 32 frames (`.long_dim_launches` at the case's head dim): one video of 33, 48 and 64
        # frames at the UNet's ds1 site and the time mix's one 512-dim head (the tensor-core kernels: 64 frames
        # the last whose logits stay in registers, at D = 64 the last a block holds whole) and svd_tiny.yaml's
        # ds1 16-dim heads (the frame walk), and of 65 at ds1 (D = 64 on the kernels that walk the key tiles);
        # fp32 at D = 512 also held to the plain version in float64 (FP64_RMS_TOL)
        for t in (33, 48, 64, 65):
            for label, h, d in ((f"ds1 [{t},5824,5,64] t={t}", 5, 64), (f"time mix [{t},5824,1,512] t={t}", 1, 512),
                                (f"tiny ds1 [{t},5824,2,16] t={t}", 2, 16)):
                if t == 65 and d != 64:
                    continue
                add = dict(iters=2, fp64_held=dtype == torch.float32 and d == 512)
                k2_entry, k6_entry = (f"temporal_attention_direct{x}_long{'_d16' if d == 16 else ''}"
                                      for x in ("", "_backward"))
                cases.append(dict(kernel=k2_entry, label=f"{label} {dname}",
                                  make=mk(*[(t, 5824, h, d)] * 3), counted=lambda d=d: k2.long_dim_launches[d],
                                  kern=lambda q, k, v, t=t: k2(q, k, v, t=t),
                                  plain=lambda q, k, v, t=t: A.temporal_attention_direct_reference(q, k, v, t=t),
                                  work=attn_work(5824, h, t, t, d, dtype=dname),
                                  library=lambda q, k, v, t=t: (lambda a=[frames(x, t) for x in (q, k, v)]: sdpa(*a)),
                                  **add))

                def k6_long_make(t=t, h=h, d=d, mk=mk):
                    q, k, v, g = mk(*[(t, 5824, h, d)] * 4)()
                    return q, k, v, A.temporal_attention_direct(q, k, v, t=t), g

                cases.append(dict(kernel=k6_entry, label=f"{label} {dname}",
                                  make=k6_long_make, counted=lambda d=d: k6.long_dim_launches[d],
                                  kern=lambda q, k, v, o, g, t=t: k6(q, k, v, o, g, t=t),
                                  plain=lambda q, k, v, o, g, t=t: A.temporal_attention_direct_backward_reference(
                                      q, k, v, o, g, t=t),
                                  work=attn_work(5824, h, t, t, d, backward=True, dtype=dname),
                                  library=lambda q, k, v, o, g, t=t: sdpa_backward([frames(x, t) for x in (q, k, v)],
                                                                                   frames(g, t)), **add))
    return cases


def gemm_cases(torch, rn, projections=None, convs=None):
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
    for label, m, k, n, bias, dtype in projections or (
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
        # fp32 that TMA cannot address (K % 4 != 0) keeps the FMA tile
        ("ds2 [40768,638->640] bias fp32 (FMA)", 40768, 638, 640, True, f32),
    ):
        def make(m=m, k=k, n=n, bias=bias, dtype=dtype):
            return (rn(m, k).to(dtype), (rn(n, k) / k ** 0.5).to(dtype), rn(n).to(dtype) if bias else None)

        # fp32 on the split-TF32 kernel (route tf32x3), also held to the plain version in float64; else the FMA tile
        x3 = {} if dtype != f32 else (
            dict(kernel="matmul_bias_tf32x3", counted=lambda: MM.matmul_bias.tf32x3_launches) if k % 4 == 0
            else dict(counted=lambda: MM.matmul_bias.fma_launches))
        cases.append(dict(
            dict(kernel="matmul_bias", label=label, make=make, kern=MM.matmul_bias, plain=MM.matmul_bias_plain,
                 iters=5, work=matmul_work(m, k, n, bias, "bf16" if dtype == bf else "fp32"),
                 library=lambda x, w, b: (lambda: F.linear(x, w, b))), **x3))
    for label, b, h, w, cin, cout, dtype in convs or (
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


def group_norm_cases(torch, rn, sites=None):
    """K7-K10 and the backward's slab kernel at the GroupNorm sites of the main paths: the UNet's ResBlock
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
    to fp64. Where ops.norm.group_norm_backward_route sends a site's backward
    to the slab kernel (one launch on a block or a cluster of n: the UNet
    from ds2 down, the ds4 time_stack, the inversion's ds1 concat at 512 x
    512 and the autoencoder step's 112 x 208 x 512, the last three on clusters
    of 4, 16 and 8), it is held to the plain backward (dx, dweight, dbias); K9
    and K10, the stream route, run at every site (at a slab site, what that
    route would cost there). The backward
    cases' labels carry the site's backward route; their bound is x and dy
    read once and dx written once."""
    import torch.nn.functional as F

    from vidseg_diffusion_tpu_torch.ops import norm as N

    bf, f32 = torch.bfloat16, torch.float32
    sites = sites or [
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
        ("UNet time_stack ds4 [2,14,14,26,1280]", (2, 14, 14, 26, 1280), bf, True, 1e-5),
        ("SD 2.1 NTI ds1 concat [2,64,64,960]", (2, 64, 64, 960), bf, True, 1e-5),
        ("autoencoder [2,112,208,512]", (2, 112, 208, 512), bf, True, 1e-6),
    ]
    groups = 32
    cases = []
    for label, shape, dtype, silu, eps in sites:
        shared = {}   # one set of inputs per site, built by its first case, freed by the K10 case
        n, c, item = 1, shape[-1], 2 if dtype == bf else 4
        for d in shape:
            n *= d
        fused = N.group_norm_route(shape[0], n // (shape[0] * c), c, groups, item, True)[0] == "fused"
        bwd_route, plan = N.group_norm_backward_route(shape[0], n // (shape[0] * c), c, groups, item, True)
        bwd_label = f"{label} (backward: {bwd_route}{f' {plan.n}' if bwd_route == 'cluster' else ''})"

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
        backward = dict(common, label=bwd_label, library_covers="K9+K10",
                        library=lambda *a, shared=shared: shared["library"]["backward"])
        if bwd_route != "stream":
            cases.append(dict(
                kernel="group_norm_backward_slab", make=pick("x", "dy", "w", "a", "s", "mean", "inv"),
                kern=lambda *a, silu=silu: N.group_norm_backward_slab(*a, groups, silu),
                plain=lambda *a, silu=silu: N.group_norm_backward_plain(*a, groups, silu),
                work=(3 * n * item + 7 * small, (30 if silu else 7) * n, "fp32"), **backward))
        cases.append(dict(
            kernel="group_norm_backward_stats", make=pick("x", "dy", "w", "a", "s", "mean", "inv"),
            kern=lambda *a, silu=silu: split_coef(N.group_norm_backward_stats(*a, groups, silu)),
            plain=lambda *a, silu=silu: split_coef(N.group_norm_backward_coef_plain(*a, groups, silu)),
            work=(2 * n * item + 7 * small, (14 if silu else 3) * n, "fp32"), **backward))
        cases.append(dict(
            kernel="group_norm_backward_apply", make=pick("x", "dy", "a", "s", "coef"),
            kern=lambda *a, silu=silu: N.group_norm_backward_apply(*a, silu),
            plain=lambda *a, silu=silu: N.group_norm_backward_apply_plain(*a, silu),
            work=(3 * n * item + 5 * small, (16 if silu else 4) * n, "fp32"), after=free, **backward))
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


def library_time(torch, case, args, iters, tf32=None):
    """The case's library call on its inputs, in ms: with tf32 False in full
    fp32 (TF32 off for matmuls and cuDNN), True with TF32 on, None as set;
    the flags are restored afterwards."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    if tf32 is not None:
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        lib = case["library"](*args)
        return lib if isinstance(lib, float) else time_ms(lib, iters)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def fp64_rel_rms(torch, plain, args, outs):
    """The largest relative RMS error of the kernel's outputs against the plain
    version run in float64 on the same inputs."""
    ref = plain(*[a.double() if torch.is_tensor(a) and a.is_floating_point() else a for a in args])
    refs = ref if isinstance(ref, tuple) else (ref,)
    return max(((o.double() - r).norm() / r.norm()).item() for o, r in zip(outs, refs))


def phase_kernels(torch):
    rows = []
    for case in kernel_cases(torch):
        kname, label, kern, plain, iters = (case[k] for k in ("kernel", "label", "kern", "plain", "iters"))
        args = case["make"]()
        counted = case.get("counted")   # the route counter this call must move by one launch
        resident, x3, on_route = resident_launches(), tf32x3_launches(), counted() if counted else 0
        out = kern(*args)
        torch.cuda.synchronize()
        resident, x3 = resident_launches() - resident, tf32x3_launches() - x3
        if counted:
            check(counted() == on_route + 1, f"{kname} {label}: not launched on its route")
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
        # the fp32 attention rows: the relative RMS error against the plain version in float64, held to
        # FP64_RMS_TOL where the split-TF32 kernels ran
        fp32 = args[0].dtype == torch.float32
        fp64_rms = (fp64_rel_rms(torch, plain, args, outs)
                    if fp32 and kname.startswith(("flash_attention", "temporal_attention", "matmul_bias",
                                                  "temporal_conv")) else None)
        if x3 or case.get("fp64_held"):
            check(fp64_rms <= FP64_RMS_TOL, f"{kname} {label}: relative RMS error {fp64_rms} against float64 "
                                            f"(tol {FP64_RMS_TOL})")
        ms = time_ms(lambda: kern(*args), iters)
        plain_ms = time_ms(lambda: plain(*args), iters)
        # fp32 library calls in full fp32; K12's fp32 rows also give cuDNN's TF32 reading, for the record
        library_ms = library_tf32_ms = None
        if case.get("library") is not None:
            library_ms = library_time(torch, case, args, iters, tf32=False if fp32 else None)
            if fp32 and kname == "conv3x3_same":
                library_tf32_ms = library_time(torch, case, args, iters, tf32=True)
        if "reference" in case:
            held_to_mha_reference(torch, KERNELS[kname]["id"], label, out, case["reference"](*args))
        previous_ms = None
        if "previous" in case:   # the normalise-first kernels: the streaming kernel beside the resident one
            apart = (case["previous"](*args) != out).float().mean().item()
            previous_ms = time_ms(lambda: case["previous"](*args), iters)
        if kname == "flash_attention_backward" and label == HEADLINE[kname]:
            print(f"[kernels] SDPA backends that take {label}: {sdpa_backends(torch, *args[:3])} "
                  "(the first is the library call's)", flush=True)
        if kname.endswith("backward_d512") and label == HEADLINE[kname]:
            view = ((lambda x: x.view(7, 5824, 1, 512).transpose(1, 2)) if kname.startswith("flash")
                    else (lambda x: x.view(1, 7, 5824, 1, 512).permute(0, 2, 3, 1, 4)))
            print(f"[kernels] SDPA backends that take {label}: "
                  f"{sdpa_backends(torch, *(view(x) for x in args[:3]))} (the first is the library call's)",
                  flush=True)
        nbytes, flops, peak_key = case["work"]
        by_bytes, by_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / PEAK_FLOPS[peak_key] * 1e3
        row = dict(kernel=kname, shape=label, max_abs_err=err, bf16_steps=steps, fp32_rel_err=rel,
                   max_abs_plain=peak, rel_rms_err=rms, ok=ok, ms=ms, plain_ms=plain_ms,
                   bound_ms=max(by_bytes, by_ops), bound_by="bytes" if by_bytes >= by_ops else "operations",
                   library_ms=library_ms, library_covers=case.get("library_covers"), library_tf32_ms=library_tf32_ms,
                   rel_rms_fp64=fp64_rms, tf32x3=bool(x3))
        rows.append(row)
        lib_txt = "none" if library_ms is None else (
            f"{library_ms:.3f} ms" + (f" ({case['library_covers']})" if case.get("library_covers") else "")
            + (" (full fp32: TF32 off)" if fp32 else "")
            + (f", {library_tf32_ms:.3f} ms with TF32 on (for the record)" if library_tf32_ms is not None else ""))
        print(f"[kernels] {KERNELS[kname]['id']} {kname} {label}: max_abs_err={err:.3e} "
              f"({steps:.2f} bf16 steps at max|plain| {peak:.3e}, tol {MAX_STEPS}; fp32 outputs "
              f"{rel:.2e} relative, tol {FP32_TOL:.0e}) rel_rms_err={rms:.3e} (tol {rms_tol:.0e}) "
              f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound {row['bound_ms']:.3f} ms by "
              f"{row['bound_by']}, library {lib_txt}"
              + (f"; vs float64 rel_rms {fp64_rms:.3e}" + (f" (tol {FP64_RMS_TOL:.0e})" if x3 or case.get("fp64_held")
                                                              else "")
                 if fp64_rms is not None else ""), flush=True)
        if previous_ms is not None:
            print(f"[kernels] {KERNELS[kname]['id']} {label}: {'resident' if resident else 'streaming'} kernel "
                  f"{ms:.3f} ms "
                  f"beside SDPA {lib_txt}, bound {row['bound_ms']:.3f} ms, the kernel streaming the keys "
                  f"{previous_ms:.3f} ms (outputs {apart:.2e} of the elements apart)", flush=True)
        if "after" in case:  # the last case of a GroupNorm site: its four library timings
            lib_times = {k: round(v, 3) for k, v in case["site"]["library"].items() if "_" in k}
            print(f"[kernels] F.group_norm(+silu) {label}: ms {json.dumps(lib_times)}", flush=True)
            case["after"]()
        del args, out, ref, outs, refs
        torch.cuda.empty_cache()
    bad = [r for r in rows if not r["ok"]]
    check(not bad, f"kernel disagrees with its plain version: {bad}")
    clip_normalised_pooled(torch)
    k1_at_cfg_batch(torch)
    return rows, k5_at_train_batch(torch)


def tf32x3_launches():
    """Launches of the split-TF32 kernels (the fp32 attention at D = 512 both
    ways, K1 / K3 and K5 in fp32 at D = 64, K11 and K4 in fp32, K6 in fp32 at D
    = 512), as the launches reported them."""
    from vidseg_diffusion_tpu_torch.ops import attention as A
    from vidseg_diffusion_tpu_torch.ops import matmul as MM
    from vidseg_diffusion_tpu_torch.ops import temporal_conv as TC

    return sum(f.tf32x3_launches for f in (A.flash_attention_packed, A.flash_attention,
                                           A.flash_attention_packed_backward, A.flash_attention_backward,
                                           A.temporal_attention_direct_backward, MM.matmul_bias,
                                           TC.temporal_conv_1x1))


def resident_launches():
    """K1's and K3's launches of the kernels that hold a head's K and V in
    shared memory, as the launches reported them."""
    from vidseg_diffusion_tpu_torch.ops import attention as A

    return A.flash_attention_packed.resident_launches + A.flash_attention.resident_launches


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


# the draws the CLIP normalise-first gate pools: first the one that failed a
# single-draw gate at 1.14e-3 of the elements differing (on an NVIDIA H100 80GB
# HBM3: the kernel cases' generator, seed 0, at this Philox offset), then seeds
# 1 .. CLIP_NF_DRAWS - 1 of a generator of its own
CLIP_NF_DRAWS, CLIP_NF_FAILED_OFFSET = 8, 1096


def clip_normalised_pooled(torch):
    """K3's normalise-first kernel at CLIP ViT-H [1,16,257,80] held to
    mha_reference over CLIP_NF_DRAWS draws: every element within one bf16
    step at max |ref| in each draw, at most MHA_DIFFERING of the elements
    differing over the draws pooled. One draw does not measure the share: over
    20 draws it averaged 5.66e-4, and one draw read 1.14e-3 (PERF.md section
    7); that draw stays in the sample. The kernel that streams the keys (sum
    mode 3, which the resident one replaced here) is read on the same draws
    beside it (printed, not held)."""
    from vidseg_diffusion_tpu_torch.ops import attention as A

    pooled = {"resident": [0, 0], "streaming": [0, 0]}
    shares = []
    for i in range(CLIP_NF_DRAWS):
        g = torch.Generator(device="cuda").manual_seed(i)
        if i == 0:
            g.set_offset(CLIP_NF_FAILED_OFFSET)
        q, k, v = (torch.randn(1, 16, 257, 80, generator=g, device="cuda").to(torch.bfloat16) for _ in range(3))
        ref = A.mha_reference(q, k, v).float()
        step = 2.0 ** (math.floor(math.log2(ref.abs().max().item())) - 7)
        for name, streamed in (("resident", False), ("streaming", True)):
            out = A._flash_attention_forward(q, k, v, None, save_lse=False, normalise_first=True, streamed=streamed)
            diff = (out.float() - ref).abs()
            check(diff.max().item() <= step, f"K3 normalise-first ({name}) CLIP draw {i}: "
                                             f"{diff.max().item() / step:.2f} bf16 steps from mha_reference")
            n = int((diff > 0).sum())
            pooled[name][0] += n
            pooled[name][1] += diff.numel()
            if not streamed:
                shares.append(n / diff.numel())
    share = {name: n / total for name, (n, total) in pooled.items()}
    print(f"[kernels] K3 normalise-first CLIP ViT-H [1,16,257,80] vs mha_reference over {CLIP_NF_DRAWS} draws: "
          f"{share['resident']:.2e} of the elements differ (tol {MHA_DIFFERING:.0e}), the kernel streaming the "
          f"keys {share['streaming']:.2e} on the same draws; each draw "
          f"{json.dumps([float(f'{x:.3e}') for x in shares])}, each within one bf16 step", flush=True)
    check(share["resident"] <= MHA_DIFFERING, "K3 normalise-first CLIP departs from mha_reference")


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
    inputs (TF32 off on the card); every K11 launch of the two, every K1 / K3
    launch at D = 64 and every K4 launch on the split-TF32 kernels (route
    tf32x3): the run whose launches the matmul_bias_tf32x3 and
    temporal_conv_1x1_tf32x3 entries report."""
    import copy

    from vidseg_diffusion_tpu_torch.config import load_model_spec
    from vidseg_diffusion_tpu_torch.engine.build import randomize_
    from vidseg_diffusion_tpu_torch.models.unet import UNetModel

    saved_tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t, b = 2, 4  # [uc; c] of one 2-frame video
    reset_counts()
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
    check_k11_tf32x3("unet")
    ROUTE_COUNTS["unet"] = check_fp32_routes("unet")
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved_tf32


def check_k11_tf32x3(tag):
    """An fp32 run: every K11 launch since reset_counts() on the split-TF32
    kernel (route tf32x3), none on the FMA tile or a bf16 route; returns the
    routes."""
    from vidseg_diffusion_tpu_torch.ops import matmul as MM

    routes = read_routes()
    got, n = routes["matmul_bias"], MM.matmul_bias.launches
    check(n > 0 and got == {"wgmma": 0, "tf32x3": n, "fma": 0},
          f"[{tag}] K11 fp32 launches by route {got}, expected all {n} on tf32x3")
    print(f"[{tag}] K11 in fp32: {n} launches, by route {json.dumps(got)}", flush=True)
    return routes


def check_fp32_routes(tag, narrow=0):
    """An fp32 run: every K1 / K3 launch at D = 64 and 512 since reset_counts()
    on the split-TF32 kernels (route tf32x3), the others (D = 16 and 80) on
    the FMA kernel, none on a bf16 route; every K4 launch on the split-TF32
    kernel but `narrow` of them (Cin % 4 != 0: the VAE decoder's 3-channel
    conv_out_time_mix, forward and dx), which took the FMA tile; returns the
    routes."""
    from vidseg_diffusion_tpu_torch.ops import temporal_conv as TC

    routes, dims = read_routes(), read_dims()
    got = {n: routes[n] for n in ("flash_attention_packed", "flash_attention", "temporal_conv_1x1")}
    want = {n: {r: 0 for r in by_route} for n, by_route in got.items()}
    for n in ("flash_attention_packed", "flash_attention"):
        x3 = x3_dim_launches(dims, n)
        want[n].update(tf32x3=x3, fma=sum(dims[n].values()) - x3)
    want["temporal_conv_1x1"].update(tf32x3=TC.temporal_conv_1x1.launches - narrow, fma=narrow)
    check(got == want, f"[{tag}] fp32 K1 / K3 / K4 launches by route {got}, expected {want} (head dims "
                       f"{ {n: dims[n] for n in ('flash_attention_packed', 'flash_attention')} })")
    print(f"[{tag}] fp32 K1 / K3 / K4 launches by route {json.dumps(got)}", flush=True)
    return routes


def phase_train_grad(torch):
    """Full-width UNet gradients: loss.backward() on the card through the
    kernels (K1/K5, K2/K6, K4) vs the CPU through the plain versions, same
    fp32 weights, inputs, sigma and noise (TF32 off on the card). Every K6
    launch (fp32, D = 64, 2 frames) on the resident split-TF32 kernel (route
    tc_short), every K5 launch (fp32, D = 64) and every K11 launch on the
    split-TF32 kernels (route tf32x3): the run whose launches the
    temporal_attention_direct_backward_fp32_tc,
    flash_attention_packed_backward_tf32x3_d64 and matmul_bias_tf32x3 entries
    report."""
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

    reset_counts()
    t0 = time.perf_counter()
    loss_card, g_card = grads(unet, "cuda")
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    k6 = A.temporal_attention_direct_backward
    check(A.flash_attention_packed_backward.launches > 0 and k6.launches > 0,
          "the card's backward did not launch K5 and K6")
    # K6 in fp32 at D = 64 over the videos' 2 frames: every launch on the resident split-TF32 kernel (route
    # tc_short), none on the CUDA-core kernel it replaced
    ROUTE_COUNTS["train_grad"] = read_routes()
    k6_routes = ROUTE_COUNTS["train_grad"]["temporal_attention_direct_backward"]
    want = {r: 0 for r in k6_routes}
    want["tc_short"] = k6.launches
    check(k6_routes == want and dict(k6.dim_launches) == {64: k6.launches},
          f"[train_grad] K6 launches by route {k6_routes} and head dim {dict(k6.dim_launches)}, expected {want}")
    print(f"[train_grad] K6 in fp32 at D = 64, t = {t}: {k6.launches} launches, by route {json.dumps(k6_routes)}",
          flush=True)
    # K5 in fp32 at D = 64: every launch on the split-TF32 kernels (route tf32x3), none on the FMA kernels
    k5 = A.flash_attention_packed_backward
    k5_routes = ROUTE_COUNTS["train_grad"]["flash_attention_packed_backward"]
    want = {r: 0 for r in k5_routes}
    want["tf32x3"] = k5.launches
    check(k5_routes == want and dict(k5.dim_launches) == {64: k5.launches},
          f"[train_grad] K5 launches by route {k5_routes} and head dim {dict(k5.dim_launches)}, expected {want}")
    print(f"[train_grad] K5 in fp32 at D = 64: {k5.launches} launches, by route {json.dumps(k5_routes)}", flush=True)
    check_k11_tf32x3("train_grad")
    # K1 in fp32 at D = 64 and K4 in fp32 (forward and dx): every launch on the split-TF32 kernels
    check_fp32_routes("train_grad")
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
# K2 and K6 (bf16 everywhere) the tensor-core (mma.sync) kernel, but K2 at D =
# 512 (the team kernel, `.tc_short_launches`, or the wide kernel); K1 and K3 run
# the normalise-first mode exactly at the sites MAIN_NORMALISED and
# SD_NORMALISED_PER_UNET count
ROUTED = ("flash_attention_packed", "flash_attention", "temporal_conv_1x1", "matmul_bias",
          "temporal_attention_direct", "temporal_attention_direct_backward", "flash_attention_packed_backward",
          "flash_attention_backward")
ROUTE_NAMES = ("wgmma", "narrow", "mma", "normalised", "resident", "wide", "cluster", "tf32x3", "long", "tc_short",
               "fma")
# the wrappers whose fp32 launches run the split-TF32 kernels (route "tf32x3"), by the head dims they do so at
X3_DIMS = {"flash_attention_packed": (64, 512), "flash_attention": (64, 512), "flash_attention_packed_backward": (64, 512),
           "flash_attention_backward": (512,), "temporal_attention_direct_backward": (512,)}
X3_WRAPPERS = tuple(X3_DIMS)


def x3_dim_launches(dims, name):
    """The launches of wrapper `name` (read_dims) at the head dims of its split-TF32 route."""
    return sum(dims[name].get(d, 0) for d in X3_DIMS[name])
GN_ROUTES = {"fused": 0, "stream": 0}   # GroupNorm32 calls per route since reset_counts()
# the backward's route (ops.norm.group_norm_backward_route) of each GroupNorm32 module that
# ran under a gradient since reset_counts(), by id (a remat step runs a module's forward
# twice and its backward once, so training reckons the backwards from the modules)
GN_BWD_OF = {}
GN_BWD_RUNS = {}   # tag -> the backwards of its run by route
# module calls since reset_counts() inside counting_calls, for the launches the
# sampling-API runs imply (api_launches): spatial CrossAttention calls by (site_route, under a gradient),
# GroupNorm32 calls under a gradient (and by the backward's route), CrossAttention (K11)
# and UNet ResBlock (K12) calls, VAE Encoder / Decoder calls (each one K3 at its mid attention)
CALLS = {"attn": {}, "gn_grad": 0, "gn_bwd": {}, "xattn": 0, "res": 0, "vae": 0}


HOOKS = {}   # the forward pre-hooks module_hooks() binds in main, by name


def module_hooks():
    """Forward pre-hooks on every module, the port's classes bound once (the
    port is imported only after a card is found): "group_norm_route",
    registered for the whole run, counts a GroupNorm32 call under the route
    ops.norm.group_norm_route gives its input (a strided input is copied, and
    the copy is aligned) and, under a gradient, keeps the route
    ops.norm.group_norm_backward_route gives it (GN_BWD_OF), and on the card
    checks that the route as the card places it (ops.norm.slab_placement, the
    backward's own query) is that one; "api_calls", registered only around the sampling-API
    runs that reckon their launches from it (`counting_calls`), counts CALLS."""
    import torch

    from vidseg_diffusion_tpu_torch.models.layers import CrossAttention, GroupNorm32
    from vidseg_diffusion_tpu_torch.models.unet import ResBlock
    from vidseg_diffusion_tpu_torch.models.vae import Decoder, Encoder
    from vidseg_diffusion_tpu_torch.ops import attention as A
    from vidseg_diffusion_tpu_torch.ops import norm as N

    vae = (Encoder, Decoder)

    def routes(module, x):
        """(forward route, backward route) of a GroupNorm32 call."""
        b, c = x.shape[0], x.shape[-1]
        aligned = not x.is_contiguous() or x.data_ptr() % 16 == 0
        shape = (b, x.numel() // (b * c), c, module.groups, x.element_size(), aligned)
        return N.group_norm_route(*shape)[0], N.group_norm_backward_route(*shape)[0]

    def group_norm_route(module, args):
        if isinstance(module, GroupNorm32):
            forward, backward = routes(module, args[0])
            GN_ROUTES[forward] += 1
            if grad(args[0], module.weight, module.bias):
                GN_BWD_OF[id(module)] = backward
            x = args[0]   # on the card, the route as it places it (the backward's own query) is the shape's
            if x.is_cuda and grad(x, module.weight, module.bias):
                b, c = x.shape[0], x.shape[-1]
                aligned = not x.is_contiguous() or x.data_ptr() % 16 == 0
                live = N.group_norm_backward_route(b, x.numel() // (b * c), c, module.groups, x.element_size(),
                                                   aligned, functools.partial(N.slab_placement, x.device, x.dtype))
                check(live[0] == backward, f"GroupNorm backward {tuple(x.shape)}: the card places the "
                      f"{live[0]} route, the shape reckons {backward}")

    def grad(*xs):
        return torch.is_grad_enabled() and any(x is not None and x.requires_grad for x in xs)

    def api_calls(module, args):
        if isinstance(module, GroupNorm32):
            if grad(args[0]):
                CALLS["gn_grad"] += 1
                route = routes(module, args[0])[1]
                CALLS["gn_bwd"][route] = CALLS["gn_bwd"].get(route, 0) + 1
        elif isinstance(module, CrossAttention):
            CALLS["xattn"] += 1
            if not module.temporal:
                x, ctx = args[0], args[1] if len(args) > 1 else None
                key = (A.site_route("blhd", x.shape[0], x.shape[1], (ctx if ctx is not None else x).shape[1]),
                       grad(x, ctx))
                CALLS["attn"][key] = CALLS["attn"].get(key, 0) + 1
        elif isinstance(module, ResBlock):
            CALLS["res"] += 1
        elif isinstance(module, vae):
            CALLS["vae"] += 1

    HOOKS.update(group_norm_route=group_norm_route, api_calls=api_calls)


@contextlib.contextmanager
def counting_calls(torch):
    """CALLS counts the module calls made inside the block (HOOKS["api_calls"])."""
    handle = torch.nn.modules.module.register_module_forward_pre_hook(HOOKS["api_calls"])
    try:
        yield
    finally:
        handle.remove()


def reset_counts():
    from vidseg_diffusion_tpu_torch.ops import attention as A
    from vidseg_diffusion_tpu_torch.ops import norm as N

    counters, plains = kernel_fns()
    for f in counters:
        f.launches = 0
        for route in ROUTE_NAMES:
            if hasattr(f, f"{route}_launches"):
                setattr(f, f"{route}_launches", 0)
        for attr in ("dim_launches", "normalised_dim_launches", "frame_launches", "long_dim_launches"):
            if hasattr(f, attr):
                getattr(f, attr).clear()
    for f in plains:
        f.calls = 0
    A.mha_reference_site.calls = 0
    N.group_norm.copies = 0
    GN_ROUTES.update(fused=0, stream=0)
    GN_BWD_OF.clear()
    CALLS.update(attn={}, gn_grad=0, gn_bwd={}, xattn=0, res=0, vae=0)


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
    dims.update({f"{f.__name__}.frames": dict(f.frame_launches)   # K2 / K6: launches by the frames t
                 for f in A.KERNEL_COUNTERS if hasattr(f, "frame_launches")})
    dims.update({f"{f.__name__}.long": dict(f.long_dim_launches)   # K2 / K6 past 32 frames by head dim
                 for f in A.KERNEL_COUNTERS if hasattr(f, "long_dim_launches")})
    return dims


K3_NORMALISED_WGMMA_DIMS = (64,)   # K3's normalise-first mode on K1's wgmma kernel; at D = 80 and 16 on mma.sync
# the head dim at which each wrapper's normalise-first launches of the paths take the kernels that hold a
# head's K and V in shared memory (`.resident_launches`): K1's D = 64 sites have 77 keys (one S product),
# K3's D = 80 site CLIP ViT-H's 257; K3's D = 64 site (ViT-L/14, 257 keys) and D = 16 stream the keys
RESIDENT_NF_DIM = {"flash_attention_packed": 64, "flash_attention": 80}


def check_routes(tag, launches, narrow=0, normalised=None, wide=0, long_frames=0, tc_short=0):
    """Every K1, K11, K5 and K13 launch of the run took the wgmma kernel (none
    the mma.sync tile or an FMA kernel), every K3 launch but the `normalised`
    ones at D = 80 and 16 (CLIP ViT-H's and the tiny towers', on the mma.sync
    kernel; at D = 64 they run K1's wgmma kernel and count on both), every K4
    launch but `narrow` of them, which took the narrow kernel, every K2
    launch but `wide` of them (D = 512 below the crossover, the wide kernel),
    `tc_short` of them (D = 512 from the crossover, the team kernel) and
    `long_frames` of them (past 32 frames, the long route) and every K6 launch
    (D = 512 up to 32 frames too) the tensor-core kernel (none a CUDA-core
    one); K1 and
    K3 ran the normalise-first mode `normalised[name]` times ({kernel:
    launches}), and each of those at RESIDENT_NF_DIM, none other, on the
    kernel that holds a head's K and V in shared memory, as the launch
    reported it; keeps and returns the route counts."""
    routes = read_routes()
    normalised = normalised or {}
    DIM_COUNTS[tag] = read_dims()
    want = {name: {"wgmma": launches[name]} for name in ("matmul_bias", "flash_attention_packed_backward",
                                                          "flash_attention_backward")}
    want["flash_attention_packed_backward"].update(mma=0, fma=0)   # bf16 D = 16; fp32 off the split-TF32 route
    want["matmul_bias"].update(tf32x3=0, fma=0)   # fp32
    want["flash_attention_packed"] = {"wgmma": launches["flash_attention_packed"], "mma": 0, "fma": 0,
                                      "normalised": normalised.get("flash_attention_packed", 0)}
    nf3 = normalised.get("flash_attention", 0)
    nf3_wgmma = sum(n for d, n in DIM_COUNTS[tag]["flash_attention.normalised"].items()
                    if d in K3_NORMALISED_WGMMA_DIMS)
    want["flash_attention"] = {"wgmma": launches["flash_attention"] - nf3 + nf3_wgmma, "normalised": nf3, "fma": 0}
    for name, d in RESIDENT_NF_DIM.items():
        want[name]["resident"] = DIM_COUNTS[tag][f"{name}.normalised"].get(d, 0)
    want["temporal_conv_1x1"] = {"wgmma": launches["temporal_conv_1x1"] - narrow, "narrow": narrow, "tf32x3": 0,
                                 "fma": 0}
    want["temporal_attention_direct"] = {"mma": launches["temporal_attention_direct"] - wide - long_frames
                                         - tc_short, "wide": wide, "long": long_frames, "tc_short": tc_short}
    want["temporal_attention_direct_backward"] = {"mma": launches["temporal_attention_direct_backward"], "wide": 0,
                                                  "long": 0, "tc_short": 0, "fma": 0}
    for name in X3_WRAPPERS:   # bf16 runs: no fp32 launch
        want[name]["tf32x3"] = 0
    got = {name: routes[name] for name in ROUTED}
    check(got == want, f"[{tag}] launches by route {got}, expected {want}")
    ROUTE_COUNTS[tag] = routes
    for name in ("flash_attention_packed", "flash_attention"):
        check(sum(DIM_COUNTS[tag][f"{name}.normalised"].values()) == routes[name]["normalised"],
              f"[{tag}] {name}: normalise-first launches by head dim {DIM_COUNTS[tag][f'{name}.normalised']}, "
              f"{routes[name]['normalised']} in all")
    return routes


def check_tf32x3(tag, expected, wide=None):
    """An fp32 run: each X3_WRAPPERS wrapper's launches at the head dims of
    its split-TF32 route (X3_DIMS, by read_dims) all took the split-TF32
    kernels (route "tf32x3"), `expected` of them ({wrapper: launches}, the
    others none), but K6's `wide` ones ({wrapper: launches}: K6 below 5
    frames), which took the wide kernel; keeps and returns the routes."""
    routes, dims = read_routes(), read_dims()
    wide = wide or {}
    got = {n: routes[n]["tf32x3"] for n in X3_WRAPPERS}
    on_dims = {n: x3_dim_launches(dims, n) - wide.get(n, 0) for n in X3_WRAPPERS}
    want = {n: expected.get(n, 0) for n in X3_WRAPPERS}
    on_wide = {n: routes[n].get("wide", 0) for n in wide}
    check(got == on_dims == want and on_wide == wide, f"[{tag}] fp32 launches on the split-TF32 kernels {got}, "
                                                      f"at their head dims {on_dims} less {wide} on the wide "
                                                      f"kernel ({on_wide}), expected {want}")
    ROUTE_COUNTS[tag] = routes
    return got


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


def group_norm_backward_expected(tag, by_route, n_bwd):
    """The backward's launches by route ({"fused" / "cluster" / "stream":
    backwards}, which must sum to the n_bwd the modules imply): the slab kernel
    once per backward on "fused" and "cluster" (the latter also on its
    .cluster_launches), K9 and K10 once each per backward on "stream"."""
    from vidseg_diffusion_tpu_torch.ops import norm as N

    by_route = {r: by_route.get(r, 0) for r in ("fused", "cluster", "stream")}
    check(sum(by_route.values()) == n_bwd, f"[{tag}] GroupNorm backwards by route {by_route}, expected {n_bwd} in all")
    check(N.group_norm_backward_slab.cluster_launches == by_route["cluster"],
          f"[{tag}] slab kernel launches on a cluster {N.group_norm_backward_slab.cluster_launches}, "
          f"expected {by_route['cluster']}")
    GN_BWD_RUNS[tag] = by_route
    return {"group_norm_backward_slab": by_route["fused"] + by_route["cluster"],
            "group_norm_backward_stats": by_route["stream"], "group_norm_backward_apply": by_route["stream"]}


def modules_backward_routes(model, steps):
    """{route: backwards} of `steps` steps that run each GroupNorm32 module of
    `model` backward once, from the routes the hook kept (GN_BWD_OF)."""
    from vidseg_diffusion_tpu_torch.models.layers import GroupNorm32

    mods = [m for m in model.modules() if isinstance(m, GroupNorm32)]
    check(all(id(m) in GN_BWD_OF for m in mods), "a GroupNorm32 module never ran under a gradient")
    out = {}
    for m in mods:
        out[GN_BWD_OF[id(m)]] = out.get(GN_BWD_OF[id(m)], 0) + steps
    return out


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
    holds; its backward once per GroupNorm (by route: train_backward)."""
    from vidseg_diffusion_tpu_torch.models.layers import CrossAttention, GroupNorm32
    from vidseg_diffusion_tpu_torch.models.unet import ResBlock

    count = lambda cls: sum(isinstance(x, cls) for x in unet.modules())
    n_gn = count(GroupNorm32)
    return dict(TRAIN_LAUNCHES, flash_attention=0, flash_attention_backward=0, group_norm=2 * n_gn - 1,
                group_norm_backward=n_gn, matmul_bias=2 * 4 * count(CrossAttention),
                conv3x3_same=2 * 2 * count(ResBlock))


def read_counts():
    counters, plains = kernel_fns()
    return {f.__name__: f.launches for f in counters}, {f.__name__: f.calls for f in plains}


def run_main_path(torch, pipe, tag, injected, process_group=None, n_frames=None):
    """One run_single_video of scripts/main_path.py (its runs over
    `process_group`'s ranks when given; over `n_frames` frames when given, on
    a pipeline built for them) with its checks; returns (launches, result)."""
    import numpy as np

    from vidseg_diffusion_tpu_torch.ops import attention as A
    from vidseg_diffusion_tpu_torch.ops import norm as N
    from vidseg_diffusion_tpu_torch.pipelines.single_video import run_single_video
    from vidseg_diffusion_tpu_torch.scripts import main_path

    t, hpx, wpx = n_frames or main_path.NUM_FRAMES, main_path.HEIGHT, main_path.WIDTH
    frames, names = main_path.frames(t), main_path.frame_names(t)
    args = main_path.vidseg_args(is_injected_features=injected)
    timings = {}
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    res = run_single_video(pipe, frames, names, args, write_outputs=False, timings=timings,
                           process_group=process_group)
    total = time.perf_counter() - t0
    launches, plain_calls = read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"[{tag}] run_single_video {total:.2f} s, stages_s "
          f"{json.dumps({k: round(v, 3) for k, v in timings.items()})}", flush=True)
    print(f"[{tag}] kernel launches {json.dumps(launches)}; plain calls {json.dumps(plain_calls)}; "
          f"GroupNorm input copies {N.group_norm.copies}; peak device memory {peak_gb:.1f} GB "
          f"({card_line()})", flush=True)

    calls = main_calls(t, args.decoding_t)
    by_module, per_call = module_launches(pipe, calls)
    reckoned = window_launches(pipe, True, calls)[0]   # the sweep's per-window reckoning, at these calls
    if t == main_path.NUM_FRAMES:
        check(all(by_module[k] == MAIN_LAUNCHES[k] for k in ("matmul_bias", "conv3x3_same")),
              f"K11 / K12 launches reckoned from the modules {by_module} differ from {MAIN_LAUNCHES}")
        check(all(reckoned[k] == n for k, n in MAIN_LAUNCHES.items()),
              f"window_launches {reckoned} disagrees with MAIN_LAUNCHES {MAIN_LAUNCHES}")
    expected = {name: reckoned.get(name, 0) for name in launches}
    expected.update(group_norm_expected(tag, by_module.pop("group_norm")), **by_module)
    check(launches == expected, f"inference launches {launches}, expected {expected} (modules "
                                f"per call {per_call}; no backward)")
    check(all(n == 0 for n in plain_calls.values()), f"plain versions ran on the card: {plain_calls}")
    narrow = calls["decoder"] * narrow_tconv_sites(pipe.first_stage.decoder)
    k2 = "temporal_attention_direct"
    long_frames = launches[k2] if t > A.TILED_FRAMES else 0   # past 32 frames: the long route
    routes = check_routes(tag, launches, narrow, MAIN_NORMALISED, long_frames=long_frames)
    print(f"[{tag}] launches by route {json.dumps(routes)}; GroupNorm calls by route {json.dumps(GN_ROUTES)}",
          flush=True)
    k2_frames = dict(DIM_COUNTS[tag].get(f"{k2}.frames", {}))
    check(k2_frames == {t: launches[k2]}, f"[{tag}] K2 launches by frames {k2_frames}, expected all at t = {t}")
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


def phase_long_video(torch):
    """svd.yaml's main path over LONG_VIDEO_FRAMES = 40 synthetic 448x832
    frames at full width (scripts/main_path.py's run: 25 steps, modulate step
    17, 2 masks, decoding_t 7, seed 1; the pipeline built for 40 frames from
    seed 0): every temporal self-attention site runs K2 over 40 frames, past
    the 32 of its tiled kernels. run_main_path's checks at 40 frames: the
    launches by kernel that the calls imply (the first stage at 6 chunks a
    pass), every K2 launch at t = 40 (`.frame_launches`) and D = 64 on the
    tensor-core kernel past 32 frames (`.long_launches`, `.long_dim_launches`),
    the other kernels on their routes, no plain
    version; finite latents, +lambda != -lambda, outside-mask latents pinned, a
    label map over the 40 frames; its seconds and peak memory. Returns the
    launches."""
    from vidseg_diffusion_tpu_torch.scripts import main_path

    t0 = time.perf_counter()
    pipe = main_path.build(n=LONG_VIDEO_FRAMES)
    torch.cuda.synchronize()
    print(f"[long_video] built svd.yaml for {LONG_VIDEO_FRAMES} frames in {time.perf_counter() - t0:.1f} s",
          flush=True)
    launches, _ = run_main_path(torch, pipe, "long_video", injected=False, n_frames=LONG_VIDEO_FRAMES)
    long_dims = DIM_COUNTS["long_video"]["temporal_attention_direct.long"]
    check(long_dims == {64: launches["temporal_attention_direct"]},
          f"[long_video] K2 past 32 frames by head dim {long_dims}: not every launch at D = 64 on the tensor-core "
          f"kernel of temporal_attention_long_tc.cu ({launches['temporal_attention_direct']} launches)")
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


MODEL_OPTIONS = {   # the model options no shipped config sets, on svd_tiny.yaml's UNet and VideoDecoder
    "fixed": dict(merge_strategy="fixed", merge_factor=0.3),
    "learned": dict(merge_strategy="learned", merge_factor=0.3),
    "k211": dict(video_kernel_size=(2, 1, 1)),
    "k333": dict(video_kernel_size=(3, 3, 3)),
    "k133": dict(video_kernel_size=(1, 3, 3)),
}


def grads_card_vs_cpu(torch, tag, model, cpu_model, run, inputs):
    """run(model, *inputs) -> output on the card (fp32), on the CPU (fp32) and
    on the CPU in float64 (a copy of the model and its config), then the
    gradients of sum(output * g) for a seeded g. The card's output within
    UNET_REL_TOL x max |CPU| of the CPU's; each parameter's and the first
    input's gradient no farther (by norm, floor GRAD_FLOOR x the largest)
    from the float64 run's than OPTION_GRAD_FACTOR x the CPU fp32 run's
    distance, or GRAD_REL_TOL. (The tiny UNet's time-embedding projections
    sum the whole map's gradient: there the CPU's own fp32 gradient reads
    5e-4 to 1.1e-3 from the float64 run's, the default config's too.)
    Returns (card forward + backward seconds, output error x max, worst
    card error, its CPU error, gradients compared)."""
    import copy
    import dataclasses

    wide = copy.deepcopy(cpu_model).double()
    wide.config = dataclasses.replace(wide.config, dtype=torch.float64)
    outs, grads = {}, {}
    for dev, m in (("cuda", model), ("cpu", cpu_model), ("float64", wide)):
        dt = torch.float64 if dev == "float64" else torch.float32
        on = "cpu" if dev == "float64" else dev
        xs = [x.detach().clone().to(on, dt if x.is_floating_point() else x.dtype).requires_grad_(i == 0)
              for i, x in enumerate(inputs)]
        t0 = time.perf_counter()
        out = run(m, *xs)
        g = torch.randn(out.shape, generator=torch.Generator().manual_seed(5)).to(on, dt)
        (out * g).sum().backward()
        if dev == "cuda":
            torch.cuda.synchronize()
            card_s = time.perf_counter() - t0
        outs[dev] = out.detach().cpu().double()
        grads[dev] = {n: p.grad.cpu().double() for n, p in m.named_parameters() if p.grad is not None}
        grads[dev]["input0"] = xs[0].grad.cpu().double()
    err = (outs["cuda"] - outs["cpu"]).abs().max().item()
    scale = outs["cpu"].abs().max().item()
    check(bool(torch.isfinite(outs["cuda"]).all()) and err <= UNET_REL_TOL * scale,
          f"[{tag}] output on the card disagrees with the CPU: {err} (tol {UNET_REL_TOL * scale})")
    check(grads["cuda"].keys() == grads["cpu"].keys() == grads["float64"].keys(),
          f"[{tag}] gradients missing on one side")
    floor = GRAD_FLOOR * max(g.norm().item() for g in grads["float64"].values())
    worst, worst_cpu, worst_name = 0.0, 0.0, ""
    for name, ref in grads["float64"].items():
        denom = max(ref.norm().item(), floor)
        card, cpu = ((grads[d][name] - ref).norm().item() / denom for d in ("cuda", "cpu"))
        check(card <= max(GRAD_REL_TOL, OPTION_GRAD_FACTOR * cpu),
              f"[{tag}] gradient of {name}: the card's {card:.2e} from the float64 run's, the CPU's {cpu:.2e}")
        if card > worst:
            worst, worst_cpu, worst_name = card, cpu, name
    return card_s, err / max(scale, 1e-30), (worst, worst_cpu, worst_name), len(grads["cpu"])


def phase_model_options(torch):
    """The AlphaBlender's 'fixed' and 'learned' merges and video_kernel_size
    (2, 1, 1), (3, 3, 3) and (1, 3, 3) on svd_tiny.yaml's UNet (and, for the
    kernels, its VideoDecoder): fp32 on the card against the CPU, forward and
    one backward (TF32 off). Every (kt, 1, 1) TemporalConv launches K4 once
    forward and once backward (dx), kt = 2 included; where kh or kw is above
    1 it launches no K4 and runs kt F.conv2d taps forward. Returns the
    launches of all the variants' card runs."""
    import copy
    import dataclasses

    from vidseg_diffusion_tpu_torch.config import load_model_spec
    from vidseg_diffusion_tpu_torch.engine.build import randomize_
    from vidseg_diffusion_tpu_torch.models.unet import TemporalConv, UNetModel
    from vidseg_diffusion_tpu_torch.models.vae import Decoder

    saved_tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t, b = 3, 6   # two 3-frame videos
    spec = load_model_spec(os.path.join(ROOT, TINY_CONFIG), num_frames=t)
    g = torch.Generator().manual_seed(6)
    unet_in = (torch.randn(b, 16, 16, 8, generator=g), torch.randn(b, generator=g),
               torch.randn(b, 1, 1024, generator=g), torch.randn(b, 768, generator=g))
    z = torch.randn(t, 8, 8, 4, generator=g)
    total, narrow = {}, 0
    reset_counts()
    for name, opts in MODEL_OPTIONS.items():
        models = [("UNet", UNetModel(dataclasses.replace(spec.unet_config, **opts)),
                   lambda m, x, ts, ctx, y: m(x, ts, ctx, y, num_video_frames=t, image_only_indicator=None
                                              if "merge_strategy" in opts else torch.zeros(2, t, device=x.device)),
                   unet_in)]
        if "video_kernel_size" in opts:
            models.append(("VideoDecoder", Decoder(dataclasses.replace(spec.vae_config, **opts)),
                           lambda m, zz: m(zz, t), (z,)))
        for part, model, run, inputs in models:
            randomize_(model, torch.Generator().manual_seed(7))
            cpu_model, model = copy.deepcopy(model), model.cuda()
            convs = [m for m in model.modules() if isinstance(m, TemporalConv)]
            kt, kh, kw = convs[0].kernel
            check(all(m.kernel == (kt, kh, kw) for m in convs), f"[model_options] {name}: mixed kernels")
            before, taps = read_counts()[0], TemporalConv.conv2d_taps
            card_s, out_err, grad_err, n_grads = grads_card_vs_cpu(torch, f"model_options {name} {part}", model,
                                                                  cpu_model, run, inputs)
            after = read_counts()[0]
            card_taps = (TemporalConv.conv2d_taps - taps) // 3   # the CPU runs (fp32, float64) take as many
            k4 = after["temporal_conv_1x1"] - before["temporal_conv_1x1"]
            want_k4, want_taps = (2 * len(convs), 0) if (kh, kw) == (1, 1) else (0, kt * len(convs))
            print(f"[model_options] {name} {part} ({opts}): fp32 card vs CPU, output {out_err:.2e} x max, "
                  f"{n_grads} gradients, the worst against the float64 run {grad_err[0]:.2e} (the CPU's "
                  f"{grad_err[1]:.2e}, {grad_err[2]}); {len(convs)} TemporalConv {kt, kh, kw}: "
                  f"K4 launches {k4} (expected {want_k4}), F.conv2d taps {card_taps} (expected {want_taps}); "
                  f"card forward + backward {card_s:.2f} s", flush=True)
            check(k4 == want_k4 and card_taps == want_taps,
                  f"[model_options] {name} {part}: K4 launches {k4}, taps {card_taps}")
            if (kh, kw) == (1, 1):   # K4's launches on the FMA tile: forward (Cin) and dx (Cout) off 4 channels
                narrow += sum((m.weight.shape[1] % 4 > 0) + (m.weight.shape[0] % 4 > 0) for m in convs)
            del model, cpu_model
    launches, plain_calls = read_counts()
    check(launches["temporal_conv_1x1"] > 0, "[model_options] K4 never launched")
    DIM_COUNTS["model_options"], ROUTE_COUNTS["model_options"] = read_dims(), check_fp32_routes("model_options",
                                                                                                narrow)
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved_tf32
    torch.cuda.empty_cache()
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
    (spatial, [7,1,5824,512]), K2 at D = 512 on the team kernel of
    temporal_attention_long_tc.cu (the time mix, t = 7, route tc_short; none on
    the wide kernel) and K1 at one 512-dim head on K3's wgmma kernel (attn2, a "flash"
    site over the 5824 tokens) twice a decode (two calls), K11 at its eight
    projections, K4 at the video ResnetBlocks ('all' only), every launch reckoned
    and no plain version; finite frames. Then 'all' over LONG_VIDEO_FRAMES = 40
    latents at decoding_t 40 in bf16: one K2 launch at D = 512 over 40 frames,
    on the tensor-core kernel past 32 frames. Then each mode in fp32 at 2 frames of
    32x32 latents (1024 tokens: every attention site a kernel site) on the card
    vs the CPU's plain versions, the library convolutions off cuDNN and TF32 off,
    within UNET_REL_TOL of max |CPU|, and 'all' over 34 latents under a gradient
    (vae_long_grad: K6 at D = 512 over 34 frames). Returns {mode: launches}."""
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
        k2 = A.temporal_attention_direct
        check(A.flash_attention_packed.wgmma_launches == mixed and k2.tc_short_launches == mixed
              and k2.wide_launches == 0 and A.flash_attention.wgmma_launches == calls,
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

    # 'all' over 40 latents at decoding_t 40: the time mix's K2 at D = 512 over 40 frames, one launch on the
    # tensor-core kernel past 32 frames
    dec, scale = vae_time_mode_decoder(torch, "all", torch.bfloat16)
    fs = FirstStage(None, dec, scale)
    z40 = torch.randn(LONG_VIDEO_FRAMES, 56, 104, 4, generator=g, device="cuda").to(torch.bfloat16)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    frames = fs.decode(z40, chunk=LONG_VIDEO_FRAMES)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches, plain_calls = read_counts()
    dims, k2 = read_dims(), A.temporal_attention_direct
    check(launches["temporal_attention_direct"] == 1 and k2.long_launches == 1
          and dims["temporal_attention_direct"] == {512: 1} and dims["temporal_attention_direct.long"] == {512: 1}
          and dims["temporal_attention_direct.frames"] == {LONG_VIDEO_FRAMES: 1},
          f"[vae_time_mode all, {LONG_VIDEO_FRAMES} latents] K2 launches {launches['temporal_attention_direct']}, by "
          f"route {read_routes()['temporal_attention_direct']}, by head dim and frames {dims}")
    check(all(n == 0 for n in plain_calls.values()) and A.mha_reference_site.calls == 0,
          f"[vae_time_mode all, {LONG_VIDEO_FRAMES} latents] plain versions ran on the card: {plain_calls}")
    check(frames.shape == (LONG_VIDEO_FRAMES, 448, 832, 3) and bool(torch.isfinite(frames).all()),
          f"[vae_time_mode all, {LONG_VIDEO_FRAMES} latents] frames {tuple(frames.shape)} not finite or misshaped")
    print(f"[vae_time_mode all] decode of {LONG_VIDEO_FRAMES} x 56x104 latents at decoding_t {LONG_VIDEO_FRAMES} "
          f"(bf16): {secs:.3f} s, peak {torch.cuda.max_memory_allocated() / 1e9:.1f} GB; launches "
          f"{json.dumps(launches)}; K2 by route {json.dumps(read_routes()['temporal_attention_direct'])} "
          f"({card_line()})", flush=True)
    del dec, fs, frames, z40
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
            check_tf32x3(f"vae_time_mode {mode} fp32", {"flash_attention_packed": 1, "flash_attention": 1})
            k2_routes = read_routes()["temporal_attention_direct"]   # 2 frames: below the fp32 crossover
            check(k2_routes["wide"] == 1 and k2_routes["tc_short"] == 0,
                  f"[vae_time_mode {mode} fp32] K2 over 2 frames off the wide kernel: {k2_routes}")
            err = (card - ref).abs().max().item() / ref.abs().max().item()
            print(f"[vae_time_mode {mode} fp32] 2 x 32x32 latents, card vs CPU: max |diff| {err:.3e} of max |CPU| "
                  f"(tol {UNET_REL_TOL:.0e})", flush=True)
            check(err <= UNET_REL_TOL and bool(torch.isfinite(card).all()),
                  f"[vae_time_mode {mode} fp32] card vs CPU {err}")
            del dec, cpu
        vae_long_grad(torch)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32, torch.backends.cudnn.enabled = saved
    return out


VAE_LONG_LATENTS = 34   # vae_long_grad: past the 32 frames of K6's tiled kernels


def vae_long_grad(torch):
    """The VideoDecoder at 'all' in fp32 (svd.yaml's, seeded random weights)
    over VAE_LONG_LATENTS = 34 latents of 4x4 under a gradient: the time mix's
    K2 and, in the backward, K6 at D = 512 over 34 frames, each once on the
    tensor-core kernels past 32 frames (the run whose launches the temporal_attention_direct_backward_long entry
    reports); the output and the latents' gradient (of the output against a
    seeded cotangent) card vs CPU within UNET_REL_TOL of max |CPU| and
    GRAD_REL_TOL by norm. The caller has turned TF32 and cuDNN off."""
    import copy

    t = VAE_LONG_LATENTS
    dec, _ = vae_time_mode_decoder(torch, "all", torch.float32)
    cpu = copy.deepcopy(dec).cpu()
    gen = torch.Generator().manual_seed(10)
    z = torch.randn(t, 4, 4, 4, generator=gen)
    reset_counts()
    zc = z.cuda().requires_grad_()
    out = dec(zc, t)
    cot = torch.randn(out.shape, generator=gen)
    (out * cot.cuda()).sum().backward()
    torch.cuda.synchronize()
    routes, dims = read_routes(), read_dims()
    ROUTE_COUNTS["vae_long_grad"], DIM_COUNTS["vae_long_grad"] = routes, dims
    k2, k6 = "temporal_attention_direct", "temporal_attention_direct_backward"
    # each past 32 frames at D = 512: the tensor-core kernels of temporal_attention_long_tc.cu
    check(routes[k2]["long"] == 1 and routes[k6]["long"] == 1 and dims[f"{k2}.frames"] == {t: 1}
          and dims[f"{k6}.frames"] == {t: 1} and dims[k6] == {512: 1}
          and dims[f"{k2}.long"] == {512: 1} and dims[f"{k6}.long"] == {512: 1},
          f"[vae_time_mode all fp32, {t} latents] K2 / K6 by route {routes[k2]} / {routes[k6]}, by frames "
          f"{dims[f'{k2}.frames']} / {dims[f'{k6}.frames']}, past 32 frames by head dim {dims[f'{k2}.long']} / "
          f"{dims[f'{k6}.long']}")
    zr = z.clone().requires_grad_()
    ref = cpu(zr, t)
    (ref * cot).sum().backward()
    err = (out.detach().cpu() - ref.detach()).abs().max().item() / ref.abs().max().item()
    gerr = (zc.grad.cpu() - zr.grad).norm().item() / zr.grad.norm().item()
    print(f"[vae_time_mode all fp32] {t} x 4x4 latents under a gradient, card vs CPU: output max |diff| {err:.3e} of "
          f"max |CPU| (tol {UNET_REL_TOL:.0e}), latent gradient {gerr:.3e} by norm (tol {GRAD_REL_TOL:.0e}); K6 by "
          f"route {json.dumps(routes[k6])}", flush=True)
    check(err <= UNET_REL_TOL and gerr <= GRAD_REL_TOL and bool(torch.isfinite(zc.grad).all()),
          f"[vae_time_mode all fp32, {t} latents] card vs CPU: output {err}, gradient {gerr}")


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
    expected.update(group_norm_backward_expected("train", modules_backward_routes(unet, TRAIN_STEPS),
                                                 expected.pop("group_norm_backward")))
    check(launches == expected, f"training launches {launches}, expected {expected} "
                                f"({TRAIN_STEPS} steps of a remat UNet)")
    check(all(n == 0 for n in plain_calls.values()), f"plain versions ran on the card: {plain_calls}")
    print(f"[train] launches by route {json.dumps(check_routes('train', launches))}; GroupNorm calls by route "
          f"{json.dumps(GN_ROUTES)}, backwards by route {json.dumps(GN_BWD_RUNS['train'])}", flush=True)
    del trainer, unet, params0, ema0
    torch.cuda.empty_cache()
    return launches


FSDP_STEPS = 2   # step 2 is the first to run on weights an optimizer step wrote
FSDP_GRAD_TOL = 5e-2     # step-1 gradient tensors by norm, FSDP vs unwrapped (bf16 sums re-associated)
FSDP_UPDATE_TOL = 5e-2   # the two steps' change of params and EMA by norm, FSDP vs unwrapped


def join_group():
    """A one-rank NCCL process group on this card (parallel/mesh.py), at a
    free localhost port: NCCL places one rank on a card."""
    import socket

    from vidseg_diffusion_tpu_torch.parallel.mesh import initialize_distributed

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    return initialize_distributed(f"localhost:{port}", num_processes=1, process_id=0)


def phase_fsdp_runs(torch, pipe, plain_res, main_launches, group):
    """The main path's run_single_video with its runs over the one-rank
    group (parallel/runs.py's split, gather and broadcast): the same launches
    as the plain run, and its latents, maps and labels bit-equal to it."""
    import numpy as np

    launches, res = run_main_path(torch, pipe, "fsdp_runs", injected=False, process_group=group)
    check(launches == main_launches, f"[fsdp_runs] launches {launches} differ from the main run's {main_launches}")
    for key in ("final_latents", "diff_maps", "seg_raw", "seg_filtered", "masks", "unique_labels"):
        a, b = getattr(res, key), getattr(plain_res, key)
        check(a.shape == b.shape and np.array_equal(a, b),
              f"[fsdp_runs] {key} differs from the plain run's (max {np.abs(a - b).max() if a.shape == b.shape else a.shape})")
    print("[fsdp_runs] final latents, difference maps, masks and both label maps bit-equal to the main run's",
          flush=True)
    DIM_COUNTS["fsdp_runs"], ROUTE_COUNTS["fsdp_runs"] = read_dims(), read_routes()
    return launches


def stale_copy_counter(torch, model):
    """Forward pre-hooks on every TemporalConv and Conv3x3NHWC of `model`
    that compare the K4 / K12 weight copy the kernel is about to read with a
    fresh re-layout of the module's weight; returns (the list of stale
    module calls, a remover)."""
    from vidseg_diffusion_tpu_torch.models.layers import Conv3x3NHWC
    from vidseg_diffusion_tpu_torch.models.unet import TemporalConv
    from vidseg_diffusion_tpu_torch.ops import conv3x3 as C3
    from vidseg_diffusion_tpu_torch.ops import temporal_conv as TC

    stale, handles = [], []

    def hook(module, args):
        w, dt = module.weight, args[0].dtype
        with torch.no_grad():
            if isinstance(module, TemporalConv):
                cached, fresh = TC.k_major(w, dt), TC._relayout_k_major(w.detach(), dt)
            else:
                cached, fresh = C3.tap_major(w, dt), C3._relayout_tap_major(w.detach(), dt)
        if not torch.equal(cached, fresh):
            stale.append(type(module).__name__)

    for m in model.modules():
        if isinstance(m, Conv3x3NHWC) or (isinstance(m, TemporalConv) and m.kernel[1:] == (1, 1)):
            handles.append(m.register_forward_pre_hook(hook))
    return stale, lambda: [h.remove() for h in handles]


def fsdp_input_nodes(torch, model):
    """Give an unwrapped UNet the autograd nodes fsdp_wrap's FSDP puts on the
    inputs of each wrapped module (parallel/fsdp.py::wrapped_modules): one
    identity over the inputs that need a gradient, in each forward but not in
    a remat recompute, where FSDP registers none. A tensor read by several
    modules then sums its gradients in the wrapped model's association
    (tests/test_torch_parallel.py holds this bit-equal on the CPU)."""
    from vidseg_diffusion_tpu_torch.parallel.fsdp import wrapped_modules

    class InputNode(torch.autograd.Function):   # as FSDP2's RegisterPostBackwardFunction
        @staticmethod
        def forward(ctx, *inputs):
            return inputs

        @staticmethod
        def backward(ctx, *grads):
            return grads

    def hook(module, args):
        if not torch.is_grad_enabled() or torch._C._current_graph_task_id() != -1:
            return None
        at = [i for i, a in enumerate(args) if torch.is_tensor(a) and a.requires_grad]
        if not at:
            return None
        args = list(args)
        for i, out in zip(at, InputNode.apply(*[args[i] for i in at])):
            args[i] = out
        return tuple(args)

    for module in wrapped_modules(model):
        module.register_forward_pre_hook(hook)


def two_train_steps(torch, trainer, n_videos=None):
    """FSDP_STEPS steps of scripts/train_path.py's batch (`n_videos` videos,
    its own count when None) with fresh seeded generators; the last step's
    weight copies checked (stale_copy_counter). Returns (the first step's
    gradients, the params and EMA after the last step, all whole copies on
    the card), step seconds, losses, stale copies."""
    from vidseg_diffusion_tpu_torch.parallel.fsdp import full_tensor, replicated_state
    from vidseg_diffusion_tpu_torch.scripts import train_path

    latents, cond = train_path.batch(n_videos or train_path.N_VIDEOS)
    gens = train_path.generators()
    times, losses, grads, stale = [], [], None, []
    for i in range(FSDP_STEPS):
        remove = None
        if i == FSDP_STEPS - 1:
            stale, remove = stale_copy_counter(torch, trainer.model)
        t0 = time.perf_counter()
        loss = trainer.step(latents, cond, generators=gens)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(loss.item())
        if remove is not None:
            remove()
        if i == 0:
            grads = {n: full_tensor(p.grad).clone() for n, p in trainer.model.named_parameters() if p.grad is not None}
    params, ema = replicated_state(trainer.model, trainer.ema)
    return (grads, {n: p.clone() for n, p in params.items()}, {n: e.clone() for n, e in ema.items()}), times, losses, stale


def state_gap(torch, got, want, init):
    """How far a run's (step-1 gradients, params, EMA) lie from another's:
    the worst relative error by norm of a step-1 gradient tensor (floor
    GRAD_FLOOR x the largest norm); over all params and EMA tensors together
    the relative error by norm of what the steps changed, ||d_got - d_want||
    / ||d_want|| with d the change from the initial weights `init`; and the
    elements more than one bf16 step apart."""
    g_got, g_want = got[0], want[0]
    floor = GRAD_FLOOR * max(g.float().norm().item() for g in g_want.values())
    grad_err = max((g_got[n].float() - g.float()).norm().item() / max(g.float().norm().item(), floor)
                   for n, g in g_want.items())
    num = den = 0.0
    far = 0
    for part in (1, 2):
        for name, w in want[part].items():
            a, b = got[part][name].float(), w.float()
            num += (a - b).norm().item() ** 2
            den += (b - init[name].float()).norm().item() ** 2
            step = torch.exp2(torch.log2(b.abs()).clamp(min=-126) - 7)
            far += int(((a - b).abs() > step).sum())
    return grad_err, (num / den) ** 0.5, far


def leaf_diffs(torch, got, want):
    """{(part, name): elements that differ} over the step-1 gradients, the
    params and the EMA of two runs (part 0, 1, 2), leaf by leaf; a leaf one
    run lacks counts whole."""
    out = {}
    for part in range(3):
        for name in set(got[part]) | set(want[part]):
            a, b = got[part].get(name), want[part].get(name)
            n = (a.numel() if a is not None else b.numel()) if a is None or b is None or a.shape != b.shape \
                else int((a != b).sum())
            if n:
                out[(part, name)] = n
    return out


def phase_fsdp(torch):
    """scripts/train_path.py's full-width SVD training step (bf16, remat,
    Adam, EMA) wrapped by parallel/fsdp.py::fsdp_wrap on the one-rank NCCL
    group (FSDPTrainStep), FSDP_STEPS steps, cuDNN's deterministic
    algorithms on, against two unwrapped runs of the same steps:
    - the unwrapped UNet given FSDP's input nodes (fsdp_input_nodes): every
      element of every step-1 gradient, parameter and EMA tensor equal, leaf
      by leaf (leaf_diffs). A planted fault, one leaf's update undone in the
      wrapped state, must be reported by that check;
    - the plain unwrapped UNet: the step-1 gradients within FSDP_GRAD_TOL and
      what the steps changed within FSDP_UPDATE_TOL by norm. FSDP's input
      nodes sum a multi-consumer tensor's gradient (the UNet's emb, a block
      input its skip also reads) in another association, bf16 roundings
      apart, and Adam's first steps, about lr x sign(g), turn a changed
      rounding of a near-zero gradient into a changed step.
    Also the launches of as many steps as phase_train's, and no K4 / K12
    weight copy older than its weight read in the last step
    (stale_copy_counter). Then trap (b) forced: a wrapped run whose copies
    are never retired and whose cache ignores the storage pointer (the
    allocator's reuse made always) must read stale copies in step 2, and the
    leaf check against the input-node run must report them. Returns the
    wrapped run's launches."""
    from vidseg_diffusion_tpu_torch.ops import conv3x3 as C3
    from vidseg_diffusion_tpu_torch.ops import relayout
    from vidseg_diffusion_tpu_torch.ops import temporal_conv as TC
    from vidseg_diffusion_tpu_torch.scripts import train_path

    def run(kind, tag):
        trainer = train_path.build(fsdp=kind == "fsdp")
        if kind == "nodes":
            fsdp_input_nodes(torch, trainer.model)
        init = None if kind == "fsdp" else {n: p.detach().clone() for n, p in trainer.model.named_parameters()}
        relays = TC.temporal_conv_1x1.relays, C3.conv3x3_same.relays
        reset_counts()
        state, times, losses, stale = two_train_steps(torch, trainer)
        launches = read_counts()[0]
        relays = TC.temporal_conv_1x1.relays - relays[0], C3.conv3x3_same.relays - relays[1]
        print(f"[fsdp] {tag}: {FSDP_STEPS} steps, step_s {[round(x, 4) for x in times]}, losses {losses}, "
              f"weight copies made (K4, K12) {relays}, stale copies read in the last step {len(stale)} "
              f"({card_line()})", flush=True)
        return trainer, state, launches, times, stale, init

    def flush():
        gc.collect()
        torch.cuda.empty_cache()

    saved_det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    trainer, plain, _, plain_times, plain_stale, init = run("plain", "unwrapped")
    del trainer
    flush()
    trainer, nodes, _, _, nodes_stale, _ = run("nodes", "unwrapped with FSDP's input nodes")
    del trainer
    flush()
    check(not plain_stale and not nodes_stale, "[fsdp] an unwrapped run read a stale weight copy")
    trainer, state, launches, times, stale, _ = run("fsdp", "fsdp_wrap, world 1")
    unet = trainer.model
    kinds = {type(p).__name__ for p in unet.parameters()}
    check(kinds == {"DTensor"}, f"[fsdp] wrapped parameters are {kinds}")
    expected = {k: FSDP_STEPS * n for k, n in train_launches(unet).items()}
    expected.update(group_norm_expected("fsdp", expected.pop("group_norm")))
    expected.update(group_norm_backward_expected("fsdp", modules_backward_routes(unet, FSDP_STEPS),
                                                 expected.pop("group_norm_backward")))
    check(launches == expected, f"[fsdp] launches {launches}, expected {expected}")
    check(all(launches[k] > 0 for k in TRAIN_KERNELS), "[fsdp] a kernel of the training path never launched")
    DIM_COUNTS["fsdp"], ROUTE_COUNTS["fsdp"] = read_dims(), read_routes()
    del trainer, unet
    flush()

    diffs = leaf_diffs(torch, state, nodes)
    n_leaves = sum(len(part) for part in nodes)
    print(f"[fsdp] against the input-node run: {len(diffs)} of {n_leaves} leaves differ "
          f"({sum(diffs.values())} elements){'' if not diffs else ': ' + str(sorted(diffs.items())[:6])}", flush=True)
    moved = max(state[1], key=lambda n: int((nodes[1][n] != init[n]).sum()))
    planted = (state[0], dict(state[1], **{moved: init[moved]}), state[2])
    caught = leaf_diffs(torch, planted, nodes)
    print(f"[fsdp] planted fault, the update of {moved} undone: the leaf check reports "
          f"{sorted(caught.items())[:4]}", flush=True)
    check((1, moved) in caught, f"[fsdp] the leaf check missed a skipped update of {moved}")
    gap = state_gap(torch, state, plain, init)
    print(f"[fsdp] against the plain unwrapped steps: step-1 gradients {gap[0]:.2e} by norm (tol {FSDP_GRAD_TOL:.0e}), "
          f"updates {gap[1]:.2e} (tol {FSDP_UPDATE_TOL:.0e}), {gap[2]} elements more than one bf16 step apart; "
          f"step 2 {times[-1]:.4f} s wrapped vs {plain_times[-1]:.4f} s unwrapped ({card_line()})", flush=True)
    check(not stale, f"[fsdp] the wrapped run read {len(stale)} stale weight copies")
    check(not diffs, f"[fsdp] the wrapped steps differ from the input-node run in {len(diffs)} leaves")
    check(gap[0] <= FSDP_GRAD_TOL and gap[1] <= FSDP_UPDATE_TOL, f"[fsdp] the wrapped steps differ: {gap}")

    saved = relayout.invalidate, relayout._state
    relayout.invalidate = lambda params: None
    relayout._state = lambda weight, dtype: (weight._version, dtype)
    try:
        trainer, control, _, _, control_stale, _ = run("fsdp", "trap (b) forced: copies never retired, pointer unread")
    finally:
        relayout.invalidate, relayout._state = saved
    del trainer
    flush()
    cdiffs = leaf_diffs(torch, control, nodes)
    print(f"[fsdp] trap (b) forced: {len(control_stale)} stale copies read in step 2; the leaf check against the "
          f"input-node run reports {len(cdiffs)} leaves ({sum(cdiffs.values())} elements)", flush=True)
    check(bool(control_stale) and bool(cdiffs), "[fsdp] trap (b) forced went unseen by the stale-copy count or the leaf check")
    torch.backends.cudnn.deterministic = saved_det
    del control, plain, nodes, state, init, planted
    flush()
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
    attention (encoder and decoder, each on the whole batch); a GroupNorm
    forward and backward once per GroupNorm module of the first stage (no
    remat); nothing else (the VAE's, LPIPS's and the discriminator's
    convolutions are library calls in JAX too)."""
    from vidseg_diffusion_tpu_torch.models.layers import GroupNorm32

    n_gn = sum(isinstance(m, GroupNorm32) for mod in fs.modules().values() for m in mod.modules())
    return dict(flash_attention=2, flash_attention_backward=2, group_norm=n_gn, group_norm_backward=n_gn)


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
    by_route = {}
    for mod in fs.modules().values():
        for r, k in modules_backward_routes(mod, TRAIN_STEPS).items():
            by_route[r] = by_route.get(r, 0) + k
    expected.update(group_norm_backward_expected("ae_train", by_route, expected.pop("group_norm_backward")))
    check(launches == expected, f"autoencoder launches {launches}, expected {expected} ({TRAIN_STEPS} steps)")
    check(all(n == 0 for n in plain_calls.values()), f"plain versions ran on the card: {plain_calls}")
    check_routes("ae_train", launches)
    print(f"[ae_train] GroupNorm backwards by route {json.dumps(GN_BWD_RUNS['ae_train'])}", flush=True)
    del trainer, fs, gen0, disc0, named, attn
    gc.collect()
    torch.cuda.empty_cache()
    return launches


AE_VIDEO_MODES = ("conv-only", "all", "attn-only")   # svd.yaml ships conv-only
AE_VIDEO_STEPS = 2   # timed steps a mode, after a warm-up


def ae_video_launches_per_step(fs):
    """(launches, narrow K4 launches) one step of a first stage with the
    temporal VideoDecoder implies (no remat, the batch one clip): K3 and K13
    once per mid attention (encoder, decoder); per VideoAttnBlock K1 + K5 at
    one 512-dim head (attn2), K2 + K6 at D = 512 (the time mix) and K11 at
    its time_mix_block's eight projections (forward only: their backward is
    library products, as in JAX); K4 twice per (kt,1,1) TemporalConv
    (forward, dx), both on the narrow kernel at conv_out's 3-channel time mix;
    a GroupNorm forward and backward once per GroupNorm module."""
    from vidseg_diffusion_tpu_torch.models.layers import CrossAttention, GroupNorm32
    from vidseg_diffusion_tpu_torch.models.unet import TemporalConv
    from vidseg_diffusion_tpu_torch.models.vae import VideoAttnBlock

    mods = list(fs.modules().values())
    count = lambda cls: sum(isinstance(m, cls) for mod in mods for m in mod.modules())
    n_va = count(VideoAttnBlock)
    return (dict(flash_attention=2, flash_attention_backward=2, flash_attention_packed=n_va,
                 flash_attention_packed_backward=n_va, temporal_attention_direct=n_va,
                 temporal_attention_direct_backward=n_va, matmul_bias=4 * count(CrossAttention),
                 temporal_conv_1x1=2 * count(TemporalConv), group_norm=count(GroupNorm32),
                 group_norm_backward=count(GroupNorm32)),
            2 * sum(narrow_tconv_sites(mod) for mod in mods))


def phase_ae_video_train(torch):
    """svd.yaml's own first stage trained on one 7-frame clip of 448x832 at
    each decoder time mode (docstring, phase 29); then ae_video_grad.
    Returns {mode: launches of its AE_VIDEO_STEPS steps}."""
    from vidseg_diffusion_tpu_torch.ops import attention as A
    from vidseg_diffusion_tpu_torch.ops import norm as N
    from vidseg_diffusion_tpu_torch.scripts import autoencoder_train_path as ae_path

    out = {}
    for mode in AE_VIDEO_MODES:
        tag = f"ae_video {mode}"
        t0 = time.perf_counter()
        trainer, fs = ae_path.build(vae=ae_path.svd_vae_config(mode))
        x, noise = ae_path.batch(frames=ae_path.SVD_FRAMES), ae_path.noise_generator()
        gen_named = lambda: fs.modules().named_parameters()
        disc = trainer.discriminator
        n_gen = sum(p.numel() for _, p in gen_named())
        check(fs.quant_conv is None and fs.decoder.config.video_decoder and fs.decoder.config.time_mode == mode,
              f"[{tag}] not svd.yaml's first stage")
        build_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        logs = trainer.step(x, 0, generator=noise)
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        print(f"[{tag}] built svd.yaml's first stage ({n_gen / 1e6:.1f} M params; Encoder + VideoDecoder at "
              f"'{mode}'), LPIPS, the discriminator, bf16, in {build_s:.1f} s; warm-up step on "
              f"{tuple(x.shape)} {warm_s:.2f} s, g_loss {logs['g_loss'].item():.5f}", flush=True)
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        unplaced = N.group_norm_backward_route.unplaced
        times, all_logs = [], []
        for i in range(AE_VIDEO_STEPS):
            if i == AE_VIDEO_STEPS - 1:  # the weights before the step that check_adam_step reads
                gen0 = [p.detach().clone() for _, p in gen_named()]
                disc0 = [p.detach().clone() for p in disc.parameters()]
            t0 = time.perf_counter()
            logs = trainer.step(x, i + 1, generator=noise)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            all_logs.append({k: v.item() for k, v in logs.items()})
        launches, plain_calls = read_counts()
        dims = read_dims()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        print(f"[{tag}] {AE_VIDEO_STEPS} steps of 7 x 448x832: step_s {[round(t, 4) for t in times]}, peak device "
              f"memory {peak_gb:.2f} GB ({card_line()})", flush=True)
        print(f"[{tag}] logs {json.dumps([{k: round(v, 6) for k, v in l.items()} for l in all_logs])}", flush=True)
        check(all(math.isfinite(v) for l in all_logs for v in l.values()), f"[{tag}] a logged loss is not finite")
        check(all(l["p_loss"] > 0 for l in all_logs), f"[{tag}] the perceptual loss carries no signal")
        for name, p in list(gen_named()) + [(f"disc.{n}", p) for n, p in disc.named_parameters()]:
            check(p.grad is not None and bool(torch.isfinite(p.grad).all()), f"[{tag}] gradient of {name}")
        gen_counts = check_adam_step(torch, trainer.gen_optimizer, gen_named(), gen0, trainer.step_count)
        disc_counts = check_adam_step(torch, trainer.disc_optimizer, disc.named_parameters(), disc0,
                                      trainer.step_count)
        per_step, narrow = ae_video_launches_per_step(fs)
        expected = {k: 0 for k in launches}
        expected.update({k: AE_VIDEO_STEPS * n for k, n in per_step.items()})
        expected.update(group_norm_expected(tag, expected.pop("group_norm")))
        by_route = {}
        for mod in fs.modules().values():
            for r, k in modules_backward_routes(mod, AE_VIDEO_STEPS).items():
                by_route[r] = by_route.get(r, 0) + k
        expected.update(group_norm_backward_expected(tag, by_route, expected.pop("group_norm_backward")))
        check(launches == expected, f"[{tag}] launches {launches}, expected {expected} ({AE_VIDEO_STEPS} steps)")
        check(all(n == 0 for n in plain_calls.values()) and A.mha_reference_site.calls == 0,
              f"[{tag}] plain versions ran on the card: {plain_calls}")
        mixed = AE_VIDEO_STEPS * per_step["flash_attention_packed"]
        at512 = lambda n: {512: n} if n else {}
        want_dims = {w: at512(mixed) for w in ("flash_attention_packed", "flash_attention_packed_backward",
                                               "temporal_attention_direct", "temporal_attention_direct_backward")}
        want_dims.update(flash_attention=at512(2 * AE_VIDEO_STEPS), flash_attention_backward=at512(2 * AE_VIDEO_STEPS))
        check(all(dims[w] == d for w, d in want_dims.items()), f"[{tag}] launches by head dim {dims}")
        routes = check_routes(tag, launches, narrow=AE_VIDEO_STEPS * narrow, tc_short=mixed)
        check(N.group_norm_backward_route.unplaced == unplaced, f"[{tag}] a slab plan the card could not place")
        add_run("ae_video_train", launches, routes)
        print(f"[{tag}] launches {json.dumps(launches)}; by route {json.dumps(routes)}; GroupNorm backwards by "
              f"route {json.dumps(GN_BWD_RUNS[tag])}; last step: generator {gen_counts[0]} parameters with a "
              f"gradient, {gen_counts[1]} due to move and moved; discriminator {disc_counts[0]}, {disc_counts[1]}",
              flush=True)
        out[mode] = launches
        del trainer, fs, x, gen0, disc0, logs
        gc.collect()
        torch.cuda.empty_cache()
    ae_video_grad(torch)
    return out


def ae_video_grad(torch):
    """svd.yaml's first stage at 'all' in fp32 on 2 frames of 128x256 (a
    16x32 latent: the mid attentions' 512 tokens, the VideoAttnBlock's attn2
    over them and its time mix over the 2 frames are the kernel sites they are
    at full width: K3 + K13, K1 + K5 at one 512-dim head, K2 + K6 wide: at 2
    frames both keep the wide kernels), the
    gradients of sum(reconstruct(sample(moments(x))) * g) on the card through
    the kernels vs the CPU through the plain versions, same weights, frames
    and posterior noise, TF32 off, the library convolutions off cuDNN: every
    first-stage parameter's gradient within GRAD_REL_TOL by norm (floor
    GRAD_FLOOR x the largest)."""
    import copy

    from vidseg_diffusion_tpu_torch.models.regularizers import DiagonalGaussian
    from vidseg_diffusion_tpu_torch.ops import attention as A
    from vidseg_diffusion_tpu_torch.scripts import autoencoder_train_path as ae_path

    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32, torch.backends.cudnn.enabled
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        fs = ae_path.build(device="cuda", vae=ae_path.svd_vae_config("all", torch.float32))[1]
        cpu = copy.deepcopy(fs)
        for m in cpu.modules().values():
            m.cpu()
        g = torch.Generator().manual_seed(12)
        x = torch.rand(2, 128, 256, 3, generator=g) * 2 - 1
        noise, weight = torch.randn(2, 16, 32, 4, generator=g), torch.randn(2, 128, 256, 3, generator=g)

        def grads(first_stage, dev):
            torch.backends.cudnn.enabled = dev == "cpu"
            post = DiagonalGaussian.from_moments(first_stage.moments(x.to(dev)))
            recon = first_stage.reconstruct(post.sample(noise.to(dev)))
            (recon * weight.to(dev)).sum().backward()
            return {n: p.grad for n, p in first_stage.modules().named_parameters()}

        reset_counts()
        t0 = time.perf_counter()
        g_card = grads(fs, "cuda")
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        launches, plain_calls = read_counts()
        dims = read_dims()
        check(all(n == 0 for n in plain_calls.values()) and A.mha_reference_site.calls == 0,
              f"[ae_video fp32] plain versions ran on the card: {plain_calls}")
        check(all(dims[w] == {512: n} for w, n in (("flash_attention", 2), ("flash_attention_backward", 2),
                                                    ("flash_attention_packed", 1), ("flash_attention_packed_backward", 1),
                                                    ("temporal_attention_direct", 1),
                                                    ("temporal_attention_direct_backward", 1))),
              f"[ae_video fp32] the attention sites off their kernels: {dims}")
        x3 = check_tf32x3("ae_video_grad", {"flash_attention": 2, "flash_attention_backward": 2,
                                            "flash_attention_packed": 1, "flash_attention_packed_backward": 1},
                          wide={"temporal_attention_direct_backward": 1})
        k2_routes = ROUTE_COUNTS["ae_video_grad"]["temporal_attention_direct"]   # below the fp32 crossover
        check(k2_routes["wide"] == 1 and k2_routes["tc_short"] == 0,
              f"[ae_video fp32] K2 over 2 frames off the wide kernel: {k2_routes}")
        t0 = time.perf_counter()
        g_cpu = grads(cpu, "cpu")
        cpu_s = time.perf_counter() - t0
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32, torch.backends.cudnn.enabled = saved
    check(g_card.keys() == g_cpu.keys() and all(v is not None for v in g_cpu.values()), "[ae_video fp32] gradients")
    floor = GRAD_FLOOR * max(v.norm().item() for v in g_cpu.values())
    worst = max(((g_card[n].cpu() - v).norm().item() / max(v.norm().item(), floor), n) for n, v in g_cpu.items())
    print(f"[ae_video fp32] svd.yaml's first stage at 'all', 2 x 128x256 in fp32: {len(g_cpu)} first-stage "
          f"gradients, card vs CPU worst {worst[0]:.3e} by norm ({worst[1]}; tol {GRAD_REL_TOL:.0e}); launches "
          f"{json.dumps({k: v for k, v in launches.items() if v})}, on split TF32 products {json.dumps(x3)}; "
          f"card {card_s:.1f} s, CPU {cpu_s:.1f} s", flush=True)
    check(all(bool(torch.isfinite(v).all()) for v in g_card.values()), "[ae_video fp32] a card gradient not finite")
    check(worst[0] <= GRAD_REL_TOL, f"[ae_video fp32] gradient of {worst[1]} on the card disagrees with the CPU")
    del fs, cpu, g_card, g_cpu
    gc.collect()
    torch.cuda.empty_cache()


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
    check_tf32x3("route_probe", {"flash_attention": 1, "flash_attention_backward": 1})
    cpu = grads(A.dot_product_attention, "cpu")
    worst = max((a.cpu() - w).norm().item() / w.norm().item() for a, w in zip(card, cpu))
    print(f"[route_probe] fp32 bhld [2,1,1024,512] 'flash' site under a gradient: K3 + K13, dq/dk/dv vs the CPU's "
          f"gradients worst relative error by norm {worst:.3e} (tol {GRAD_REL_TOL:.0e})", flush=True)
    check(worst <= GRAD_REL_TOL, f"[route_probe] the flash site's gradients disagree with the CPU's: {worst}")

# the sampling-API phases: {tag: launches summed over the tag's runs}, their
# routes and head-dim counts summed the same way
API_RUNS, API_ROUTES, API_DIMS = {}, {}, {}
API_FP32_TOL = UNET_REL_TOL   # fp32 tiny SDXL samplers, card (kernels) vs CPU (plain versions), x max |CPU|


def add_run(tag, launches, routes=None):
    """Adds one run's launches (and routes, head dims) to its API tag's sums."""
    mine = API_RUNS.setdefault(tag, {})
    for k, n in launches.items():
        mine[k] = mine.get(k, 0) + n
    if routes is not None:
        for name, by_route in routes.items():
            r = API_ROUTES.setdefault(tag, {}).setdefault(name, {})
            for route, n in by_route.items():
                r[route] = r.get(route, 0) + n
    API_DIMS[tag] = sum_dims([API_DIMS.get(tag, {}), read_dims()])


class UNetTimer:
    """Counts a UNet's calls and times each with CUDA events (pre- and post-
    forward hooks; no synchronisation inside the run)."""

    def __init__(self, torch, unet):
        self.torch, self.events = torch, []
        self.hooks = [unet.register_forward_pre_hook(self._start), unet.register_forward_hook(self._end)]

    def _start(self, *_):
        ev = self.torch.cuda.Event(enable_timing=True)
        ev.record()
        self.events.append([ev, None])

    def _end(self, *_):
        ev = self.torch.cuda.Event(enable_timing=True)
        ev.record()
        self.events[-1][1] = ev

    def reset(self):
        self.events = []

    @property
    def calls(self):
        return len(self.events)

    def mean_s(self):
        self.torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in self.events) / max(len(self.events), 1) / 1e3

    def remove(self):
        for h in self.hooks:
            h.remove()


def hooked_launches(tag):
    """({kernel: launches}, {kernel: normalise-first launches}, mha_reference_site
    calls) that the image-UNet and VAE calls counted since reset_counts() imply
    (CALLS): K1 at every spatial attention call of a "small_batched" or "flash"
    site, and at an "mha_reference" site without a gradient (the normalise-first
    mode), K5 once more at the former under a gradient, mha_reference_site at
    the latter under a gradient; K11 four per CrossAttention, K12 two per
    ResBlock call; one GroupNorm forward per GroupNorm32 call (by route) and
    one backward per call under a gradient (the slab kernel, or K9 + K10, by
    route); K3 once per VAE encoder / decoder call."""
    kernel = lambda route: route in ("small_batched", "flash")
    attn = CALLS["attn"]
    fwd = sum(n for (route, grad), n in attn.items() if kernel(route) or not grad)
    nf = sum(n for (route, grad), n in attn.items() if route == "mha_reference" and not grad)
    bwd = sum(n for (route, grad), n in attn.items() if kernel(route) and grad)
    site = sum(n for (route, grad), n in attn.items() if route == "mha_reference" and grad)
    check(all(route != "one_key" for route, _ in attn), f"[{tag}] a one-key site in an image UNet: {attn}")
    out = dict(flash_attention_packed=fwd, flash_attention_packed_backward=bwd, flash_attention=CALLS["vae"],
               matmul_bias=4 * CALLS["xattn"], conv3x3_same=2 * CALLS["res"])
    out.update(group_norm_expected(tag, GN_ROUTES["fused"] + GN_ROUTES["stream"]))
    out.update(group_norm_backward_expected(tag, CALLS["gn_bwd"], CALLS["gn_grad"]))
    return out, {"flash_attention_packed": nf}, site


def check_api_run(tag, label, fp32=False):
    """One API run's launches (counted since reset_counts()) against
    hooked_launches, no plain version, and (bf16) the routes; returns
    (launches, routes) and adds them to the tag's sums."""
    from vidseg_diffusion_tpu_torch.ops import attention as A

    launches, plain_calls = read_counts()
    implied, normalised, site = hooked_launches(f"{tag} {label}")
    expected = {name: implied.get(name, 0) for name in launches}
    check(launches == expected, f"[{tag} {label}] launches {launches}, expected {expected} (module calls "
                                f"{CALLS}, GroupNorm by route {GN_ROUTES})")
    check(all(n == 0 for n in plain_calls.values()), f"[{tag} {label}] plain versions ran on the card: {plain_calls}")
    check(A.mha_reference_site.calls == site, f"[{tag} {label}] mha_reference_site ran "
                                              f"{A.mha_reference_site.calls} times, expected {site}")
    if fp32:   # fp32 runs the FMA kernels, the split-TF32 ones at D = 512, K5 at 64 and K11 (and K6 at 64): no launch
        # on a bf16 route
        routes = read_routes()
        dims = read_dims()
        check_tf32x3(f"{tag} {label}", {n: x3_dim_launches(dims, n) for n in X3_WRAPPERS})
        check_k11_tf32x3(f"{tag} {label}")
        check_fp32_routes(f"{tag} {label}")
        off = {k: {r: n for r, n in v.items() if r not in ("normalised", "tf32x3", "tc_short", "fma") and n}
               for k, v in routes.items()}
        check(all(not v for v in off.values()) and routes["flash_attention_packed"]["normalised"] ==
              normalised["flash_attention_packed"], f"[{tag} {label}] fp32 launches by route {routes}")
    else:
        routes = check_routes(f"{tag} {label}", launches, normalised=normalised)
    add_run(tag, launches, routes)
    return launches, routes


class DecoderWatch:
    """A forward hook on a VAE decoder: whether each of its outputs is finite,
    read after the run (SamplingPipeline.decode clamps to [0, 1] afterwards,
    which would carry an inf into range)."""

    def __init__(self, torch, decoder):
        self.torch, self.flags = torch, []
        self.hook = decoder.register_forward_hook(lambda m, a, out: self.flags.append(torch.isfinite(out).all()))

    def check(self, tag, calls):
        check(len(self.flags) == calls and all(bool(f) for f in self.flags),
              f"[{tag}] {len(self.flags)} decoder calls (expected {calls}), finite {[bool(f) for f in self.flags]}")
        self.flags = []

    def remove(self):
        self.hook.remove()


def phase_api_sdxl(torch):
    """The sampling API on the SDXL base and refiner at full width
    (scripts/api_path.py): text_to_image at 1024x1024, 40 Euler steps, CFG 5
    (seconds per image, per UNet call, peak memory), after a 2-step warm-up,
    timed without the call-counting hook, then again with it for its launches
    (the difference is the hook's cost); each other sampler (Heun, Euler
    ancestral, DPM++ 2S ancestral, DPM++ 2M, LMS, Euler with s_churn 1) for 6
    steps; image_to_image at strength 0.5; the base -> refiner handoff
    (text_to_image with txt2noisy_strength 0.2 and return_latents, then
    refiner(add_noise=False, img2img_strength=0.2)). Every run: the UNet calls
    its sampler implies (denoiser_calls), the launches by kernel and route its
    module calls imply (hooked_launches), no plain version, the decoder's
    output finite before the clamp, the image of its shape."""
    from vidseg_diffusion_tpu_torch.diffusion.sampling import denoiser_calls
    from vidseg_diffusion_tpu_torch.inference.api import Sampler, Txt2NoisyDiscretizationWrapper, img2img_t_start
    from vidseg_diffusion_tpu_torch.scripts import api_path as AP

    size = AP.SDXL_SIZE
    t0 = time.perf_counter()
    base = AP.build("configs/inference/sd_xl_base.yaml", seed=0)
    torch.cuda.synchronize()
    n_unet = sum(p.numel() for p in base.pipeline.unet.parameters())
    n_text = sum(p.numel() for m in (base.pipeline.text_l, base.pipeline.text_g) for p in m.parameters())
    print(f"[api_sdxl] built sd_xl_base.yaml (UNet {n_unet / 1e9:.3f} B, text towers {n_text / 1e9:.3f} B, bf16) "
          f"in {time.perf_counter() - t0:.1f} s", flush=True)
    tok = AP.tokens()
    gen = lambda: torch.Generator(device="cuda").manual_seed(3)

    def timed(timer, fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        timer.reset()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def run(watch, label, fn, want_calls, shape=(1, size, size, 3)):
        timer, decoder = watch
        with counting_calls(torch):
            out, secs = timed(timer, fn)
        img = out[0] if isinstance(out, tuple) else out
        check(timer.calls == want_calls, f"[api_sdxl {label}] {timer.calls} UNet calls, expected {want_calls}")
        decoder.check(f"api_sdxl {label}", 1)
        check(tuple(img.shape) == shape and bool(torch.isfinite(img).all()),
              f"[api_sdxl {label}] image {tuple(img.shape)} not finite or not of shape {shape}")
        launches, routes = check_api_run("api", label)
        print(f"[api_sdxl {label}] {secs:.3f} s with the call-counting hook, {timer.calls} UNet calls "
              f"({timer.mean_s():.4f} s a UNet call, CUDA events), peak {torch.cuda.max_memory_allocated() / 1e9:.2f} "
              f"GB; launches {json.dumps(launches)}; by route {json.dumps(routes)}", flush=True)
        return out, secs

    watch = (UNetTimer(torch, base.pipeline.unet), DecoderWatch(torch, base.pipeline.first_stage.decoder))
    base.text_to_image(AP.sdxl_params(steps=2), tok, generator=gen())   # warm-up (weight re-lays, library handles)
    watch[1].flags = []
    p40 = AP.sdxl_params()
    txt2img = lambda: base.text_to_image(p40, tok, generator=gen(), return_latents=True)
    _, secs = timed(watch[0], txt2img)
    per_call, peak = watch[0].mean_s(), torch.cuda.max_memory_allocated() / 1e9
    check(watch[0].calls == AP.SDXL_STEPS, f"[api_sdxl] {watch[0].calls} UNet calls, expected {AP.SDXL_STEPS}")
    watch[1].check("api_sdxl txt2img 40 steps, timed", 1)
    print(f"[api_sdxl] seconds per 1024x1024 image at 40 steps {secs:.3f}, per UNet call {per_call:.4f} (CUDA "
          f"events), peak {peak:.2f} GB, without the call-counting hook ({card_line()})", flush=True)
    (frames, z_full), _ = run(watch, "txt2img 40 steps", txt2img, AP.SDXL_STEPS)
    check(bool(torch.isfinite(z_full).all()) and z_full.abs().max() > 0, "[api_sdxl] final latents")
    for sampler in (Sampler.HEUN_EDM, Sampler.EULER_ANCESTRAL, Sampler.DPMPP2S_ANCESTRAL, Sampler.DPMPP2M,
                    Sampler.LINEAR_MULTISTEP, Sampler.EULER_EDM):
        churn = 1.0 if sampler == Sampler.EULER_EDM else 0.0
        params = AP.sdxl_params(steps=AP.OTHER_STEPS, sampler=sampler, s_churn=churn)
        label = sampler.value + (" s_churn 1" if churn else "")
        run(watch, label, lambda: base.text_to_image(params, tok, generator=gen()),
            denoiser_calls(base.make_sampler(params)))
    p_i2i = dataclasses.replace(p40, img2img_strength=AP.IMG2IMG_STRENGTH)
    img = AP.image(size, size)
    run(watch, "img2img 0.5", lambda: base.image_to_image(p_i2i, img, tok, generator=gen()),
        AP.SDXL_STEPS - img2img_t_start(AP.SDXL_STEPS, AP.IMG2IMG_STRENGTH))
    t_end = Txt2NoisyDiscretizationWrapper(None, AP.HANDOFF_STRENGTH, AP.SDXL_STEPS).t_end(AP.SDXL_STEPS)
    (_, z_noisy), base_s = run(watch, "handoff base", lambda: base.text_to_image(
        p40, tok, generator=gen(), txt2noisy_strength=AP.HANDOFF_STRENGTH, return_latents=True), t_end)
    check(float((z_noisy - z_full).abs().max()) > 1e-3, "[api_sdxl] the txt2noisy latents equal the full run's")
    for w in watch:
        w.remove()
    t0 = time.perf_counter()
    refiner = AP.build("configs/inference/sd_xl_refiner.yaml", seed=1)
    torch.cuda.synchronize()
    n_ref = sum(p.numel() for p in refiner.pipeline.unet.parameters())
    print(f"[api_sdxl] built sd_xl_refiner.yaml (UNet {n_ref / 1e9:.3f} B, bf16) in {time.perf_counter() - t0:.1f} s",
          flush=True)
    watch = (UNetTimer(torch, refiner.pipeline.unet), DecoderWatch(torch, refiner.pipeline.first_stage.decoder))
    p_ref = dataclasses.replace(p40, img2img_strength=AP.HANDOFF_STRENGTH)
    ref_steps = AP.SDXL_STEPS - img2img_t_start(AP.SDXL_STEPS, AP.HANDOFF_STRENGTH)
    _, ref_s = run(watch, "handoff refiner", lambda: refiner.refiner(p_ref, z_noisy, tok, generator=gen(),
                                                                     add_noise=False), ref_steps)
    for w in watch:
        w.remove()
    print(f"[api_sdxl] base -> refiner handoff (with the call-counting hook): base {t_end} steps {base_s:.3f} s, "
          f"refiner {ref_steps} steps {ref_s:.3f} s, peak {torch.cuda.max_memory_allocated() / 1e9:.2f} GB with both "
          "stacks resident", flush=True)
    del base, refiner
    gc.collect()
    torch.cuda.empty_cache()


def phase_api_img2vid(torch, pipe):
    """image_to_video on svd.yaml (the main path's pipeline) at
    VideoSamplingParams' defaults (1024x576, 14 frames, 25 Euler steps,
    decoding_t 1): 25 UNet calls, the launches by kernel and route that 25
    UNet calls, 1 conditioning-frame encoder call and 14 decoder calls imply
    (window_launches), no plain version; the 14 decoder outputs finite before
    the clamp, a finite [14, 576, 1024, 3] video; seconds per video, per UNet
    call, peak memory."""
    from vidseg_diffusion_tpu_torch.inference.api import SamplingPipeline, VideoSamplingParams
    from vidseg_diffusion_tpu_torch.ops import attention as A
    from vidseg_diffusion_tpu_torch.scripts import api_path as AP

    params = VideoSamplingParams()
    api = SamplingPipeline(pipe)
    img = AP.image(params.height, params.width)
    timer, decoder = UNetTimer(torch, pipe.unet), DecoderWatch(torch, pipe.first_stage.decoder)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    video = api.image_to_video(params, img, generator=torch.Generator(device="cuda").manual_seed(4))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    per_call = timer.mean_s()
    calls = {"unet": timer.calls, "encoder": 1, "decoder": params.num_frames // params.decoding_t}
    timer.remove()
    decoder.remove()
    decoder.check("api_img2vid", calls["decoder"])
    check(calls["unet"] == params.steps, f"[api_img2vid] {calls['unet']} UNet calls, expected {params.steps}")
    launches, plain_calls = read_counts()
    implied, normalised = window_launches(pipe, True, calls)
    expected = {name: implied.get(name, 0) for name in launches}
    expected.update(group_norm_expected("api_img2vid", implied["group_norm"]))
    check(launches == expected, f"[api_img2vid] launches {launches}, expected {expected} ({calls})")
    check(all(n == 0 for n in plain_calls.values()) and A.mha_reference_site.calls == 0,
          f"[api_img2vid] plain versions ran on the card: {plain_calls}, site {A.mha_reference_site.calls}")
    narrow = calls["decoder"] * narrow_tconv_sites(pipe.first_stage.decoder)
    routes = check_routes("api_img2vid", launches, narrow, normalised)
    add_run("img2vid", launches, routes)
    shape = (params.num_frames, params.height, params.width, 3)
    check(tuple(video.shape) == shape and bool(torch.isfinite(video).all()),
          f"[api_img2vid] video {tuple(video.shape)} not finite or not of shape {shape}")
    print(f"[api_img2vid] image_to_video svd.yaml 14 x 1024x576, 25 steps, decoding_t 1: {secs:.3f} s a video, "
          f"{per_call:.4f} s a UNet call (CUDA events), peak {torch.cuda.max_memory_allocated() / 1e9:.2f} GB "
          f"({card_line()}); launches {json.dumps(launches)}; by route {json.dumps(routes)}", flush=True)
    del video


def phase_api_nti(torch, pipe):
    """Null-text inversion and edit on sd_2_1.yaml (the SD phase's pipeline)
    at 512x512 (scripts/api_path.py nti_and_edit): the inversion of an encoded
    image over a 4-step schedule, null_text_optimization with 3 inner steps
    under autograd (K1 with its LSE and K5 at the kernel sites, mha_reference_site
    at the 77-key cross-attention sites of 4096 and 1024 queries, the GroupNorm
    backward by route),
    then edit with its window at steps 1-2 and the base-only run: the loss
    summed over the outer steps falls from the first inner step to the last,
    every optimized uc finite, both decodes finite before the clamp, the
    edited image apart from the base-only one; 4 + 4 x (3 + 1) + 6 + 4 UNet calls; launches by kernel and
    route as the module calls imply, no plain version."""
    from vidseg_diffusion_tpu_torch.inference.api import SamplingPipeline
    from vidseg_diffusion_tpu_torch.scripts import api_path as AP

    api = SamplingPipeline(pipe)
    losses = {}
    timer, decoder = UNetTimer(torch, pipe.unet), DecoderWatch(torch, pipe.first_stage.decoder)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    with counting_calls(torch):
        latents_inv, ucs, edited, base_only = AP.nti_and_edit(
            api, on_loss=lambda i, k, loss: losses.setdefault(i, []).append(loss.item()))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    steps, inner = AP.NTI_STEPS, AP.NTI_INNER
    lo, hi = AP.EDIT_WINDOW   # edit: the base denoiser at every step, the edit one inside the window
    want = steps + steps * (inner + 1) + steps + sum(lo <= i <= hi for i in range(steps)) + steps
    check(timer.calls == want, f"[api_nti] {timer.calls} UNet calls, expected {want}")
    timer.remove()
    decoder.remove()
    decoder.check("api_nti", 2)   # the edited and the base-only image, before the clamp
    launches, routes = check_api_run("nti", "inversion + NTI + edit")
    first, last = sum(v[0] for v in losses.values()), sum(v[-1] for v in losses.values())
    check(len(losses) == steps and all(len(v) == inner for v in losses.values()) and last < first,
          f"[api_nti] NTI losses {losses}: the sum over the outer steps did not fall ({first} -> {last})")
    check(len(ucs) == steps and all(bool(torch.isfinite(u).all()) for u in ucs), "[api_nti] uc not finite")
    moved = float((edited - base_only).abs().max())
    check(bool(torch.isfinite(edited).all()) and moved > 0, f"[api_nti] edit finite and apart from base ({moved})")
    print(f"[api_nti] sd_2_1.yaml 512x512: {secs:.3f} s, {want} UNet calls; NTI losses "
          f"{json.dumps({i: [round(x, 6) for x in v] for i, v in losses.items()})}; max |edit - base| {moved:.4f}; "
          f"peak {torch.cuda.max_memory_allocated() / 1e9:.2f} GB; launches {json.dumps(launches)}; by route "
          f"{json.dumps(routes)}", flush=True)


API_FP32_SIZE, API_FP32_STEPS = 256, 3


def phase_api_fp32(torch):
    """sd_xl_tiny.yaml (text_to_image) and sd_xl_refiner_tiny.yaml (refiner on
    the base's latents) in fp32 at 256x256, each of the six samplers for 3
    steps, on the card through the kernels and on the CPU through the plain
    versions, same weights, same noise (handed over), TF32 and cuDNN off: the
    latents and images within API_FP32_TOL of max |CPU|; launches as the
    module calls imply, every one on an fp32 kernel (FMAs; split TF32 at D = 512
    and K11: every K11 launch on the split-TF32 kernel)."""
    from vidseg_diffusion_tpu_torch.inference.api import Sampler
    from vidseg_diffusion_tpu_torch.scripts import api_path as AP

    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32, torch.backends.cudnn.enabled
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = torch.backends.cudnn.enabled = False
    try:
        card = {n: AP.build(f"configs/inference/{n}.yaml", "cuda", torch.float32, seed=2)
                for n in ("sd_xl_tiny", "sd_xl_refiner_tiny")}
        cpu = {n: AP.build(f"configs/inference/{n}.yaml", "cpu", torch.float32, seed=2) for n in card}
        for n in card:   # the card's random weights on the CPU
            for field in ("unet", "text_l", "text_g"):
                if getattr(card[n].pipeline, field) is not None:
                    getattr(cpu[n].pipeline, field).load_state_dict(getattr(card[n].pipeline, field).state_dict())
            for field in ("encoder", "decoder"):
                getattr(cpu[n].pipeline.first_stage, field).load_state_dict(
                    getattr(card[n].pipeline.first_stage, field).state_dict())
        tok, size, h = AP.tokens(), API_FP32_SIZE, API_FP32_SIZE // 8
        g = torch.Generator().manual_seed(5)
        worst = 0.0
        with counting_calls(torch):   # the CPU runs count too, but each card run starts from reset_counts()
            for sampler in Sampler:
                params = AP.sdxl_params(size, API_FP32_STEPS, sampler=sampler,
                                        s_churn=1.0 if sampler == Sampler.EULER_EDM else 0.0)
                x0, steps_noise = torch.randn(1, h, h, 4, generator=g), torch.randn(API_FP32_STEPS, 1, h, h, 4, generator=g)
                z_noise = torch.randn(1, h, h, 4, generator=g)
                out = {}
                for where, apis in (("card", card), ("cpu", cpu)):
                    reset_counts()
                    frames, z = apis["sd_xl_tiny"].text_to_image(params, tok, noise=x0, step_noise=steps_noise,
                                                                  return_latents=True)
                    if where == "card":
                        check_api_run("api_fp32", f"{sampler.value} base", fp32=True)
                    reset_counts()
                    refined = apis["sd_xl_refiner_tiny"].refiner(dataclasses.replace(params, img2img_strength=0.7), z, tok,
                                                                 noise=z_noise, step_noise=steps_noise)
                    if where == "card":
                        check_api_run("api_fp32", f"{sampler.value} refiner", fp32=True)
                    out[where] = [t.float().cpu() for t in (z, frames, refined)]
                errs = [(a - b).abs().max().item() / max(b.abs().max().item(), 1e-12) for a, b in zip(*out.values())]
                worst = max(worst, *errs)
                print(f"[api_fp32] {sampler.value}: card vs CPU latents {errs[0]:.3e}, image {errs[1]:.3e}, refined "
                      f"{errs[2]:.3e} of max |CPU| (tol {API_FP32_TOL:.0e})", flush=True)
                check(max(errs) <= API_FP32_TOL and all(bool(torch.isfinite(t).all()) for t in out["card"]),
                      f"[api_fp32] {sampler.value}: card vs CPU {errs}")
        print(f"[api_fp32] worst card vs CPU over the six samplers {worst:.3e} of max |CPU|", flush=True)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32, torch.backends.cudnn.enabled = saved


# ---- T5-XXL-conditioned txt2img, the demo server, the safety / watermark / FID utilities ----

T5_FP32_TOL = 1e-5            # tiny T5 in fp32, card vs CPU, x max |CPU| (TF32 off)
T5_NORMALISED_PER_UNET = 10   # the 77-key cross-attention sites with 4096 or 1024 queries, per UNet call
DEMO_PNG_LEVELS = 1           # a demo PNG vs the sampling API's image for the same seed, uint8 levels
# the safety filter's CLIP ViT-L/14 image tower (DeepFloydDataFiltering's), random bf16 weights
VIT_L14 = dict(image_size=224, patch_size=14, width=1024, heads=16, layers=24, output_dim=768)
SAFETY_FEAT_TOL = 5e-2        # ViT-L/14 features, bf16 on the card vs fp32 on the CPU, relative by norm
SAFETY_BLUR_TOL = 2.0 ** -8   # a blurred frame vs the CPU's blur of the same frame, x max |CPU|: half a
#                               bf16 step at 1.0 (cuDNN's fp32 convolutions may take TF32 products)
FID_FEATURES, FID_RTOL = (2048, 1024), 1e-7   # two populations of N x D (ViT-H width); vs scipy's sqrtm


def t5_fp32_card_vs_cpu(torch):
    """A 2-layer T5 of width 64 (T5-XXL's vocabulary), both FFN kinds, in fp32:
    the card against the CPU on the same weights and ids (TF32 off), within
    T5_FP32_TOL of max |CPU|."""
    from vidseg_diffusion_tpu_torch.engine.build import randomize_
    from vidseg_diffusion_tpu_torch.models.t5 import T5Config, T5Encoder
    from vidseg_diffusion_tpu_torch.scripts import t5_path as T5P

    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        ids = torch.from_numpy(T5P.tokens(seed=15))
        for ff in ("gated-gelu", "relu"):
            cfg = T5Config(**dict(T5P.T5_TINY, feed_forward_proj=ff))
            cpu = T5Encoder(cfg)
            randomize_(cpu, torch.Generator().manual_seed(3))
            card = T5Encoder(cfg).to("cuda")
            card.load_state_dict(cpu.state_dict())
            with torch.no_grad():
                got, want = card(ids.cuda()).cpu(), cpu(ids)
            err = ((got - want).abs().max() / want.abs().max()).item()
            print(f"[api_t5] tiny T5 ({ff}) fp32 card vs CPU: {err:.3e} of max |CPU| (tol {T5_FP32_TOL:.0e})",
                  flush=True)
            check(err <= T5_FP32_TOL and bool(torch.isfinite(got).all()), f"[api_t5] tiny T5 {ff}: {err}")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def class_card_vs_cpu(torch, tmp):
    """The tiny class-conditioned config (t5_path.write_class_config): built
    by build_pipeline on the card and on the CPU in fp32, the card's weights
    on the CPU; the conditioner's output and clip_apply card vs CPU."""
    from vidseg_diffusion_tpu_torch.engine.build import build_pipeline
    from vidseg_diffusion_tpu_torch.scripts import t5_path as T5P

    path = T5P.write_class_config(tmp)
    card = build_pipeline(path, dtype=torch.float32, device="cuda", seed=4)
    cpu = build_pipeline(path, dtype=torch.float32, device="cpu", seed=4)
    cpu.class_embedder.load_state_dict(card.class_embedder.state_dict())
    check(card.kind == cpu.kind == "class", f"[api_t5] class config built as {card.kind}")
    labels = torch.tensor([0, 6, 3])
    got = card.conditioner({"cls": labels.cuda()})
    want = cpu.conditioner({"cls": labels})
    check(got.keys() == want.keys() == {"crossattn"} and torch.equal(got["crossattn"].cpu(), want["crossattn"])
          and tuple(want["crossattn"].shape) == (3, 1, card.spec.unet_config.context_dim)
          and torch.equal(card.clip_apply(labels).cpu(), cpu.clip_apply(labels)),
          "[api_t5] class conditioner card vs CPU")
    uc = card.class_embedder.get_unconditional_class(3)
    check(uc.tolist() == [6, 6, 6], f"[api_t5] unconditional class {uc.tolist()}")
    print(f"[api_t5] class conditioner (tiny config, fp32): card equals CPU, crossattn "
          f"{tuple(want['crossattn'].shape)}, unconditional class {uc.tolist()[0]}", flush=True)


T5_GRAPH_REPLAYS = 5   # replays of the captured T5 pass timed together


def t5_pass_graph_ms(torch, t5, ids):
    """One T5 pass (no gradient) captured as a CUDA graph: ms of a replay,
    the mean of T5_GRAPH_REPLAYS after a warm one (the pass's kernels back to
    back, no host between them: its device time)."""
    x = torch.as_tensor(ids, device="cuda")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.no_grad():
        with torch.cuda.stream(side):
            t5(x)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = t5(x)
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(T5_GRAPH_REPLAYS):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    check(bool(torch.isfinite(out).all()), "[api_t5] the T5 graph's output is not finite")
    del graph, out
    return start.elapsed_time(end) / T5_GRAPH_REPLAYS


def phase_api_t5(torch):
    """T5 v1.1-XXL widths conditioning sd_2_1.yaml's UNet (context_dim 4096)
    through build_pipeline (scripts/t5_path.py; the YAML written to a temp
    dir), random bf16 weights: text_to_image at 512x512, 25 Euler steps, CFG 5,
    on 77 seeded ids, after a 2-step warm-up, timed without the call-counting
    hook (seconds per image, the two T5 passes and each UNet call with CUDA
    events, peak memory), one T5 pass's device time as a CUDA graph's replay
    (against the timed pass: its idle share), then again with the hook: 25 UNet calls, 2 T5 passes, the
    decode finite before the clamp, the launches by kernel and route the
    module calls imply (hooked_launches), the normalise-first K1 at the 10
    77-key sites with 4096 or 1024 queries per UNet call and the short walk at
    the 256- and 64-query ones (site_route). Then the tiny T5 in fp32 card vs
    CPU and the class-conditioned tiny config."""
    import tempfile

    from vidseg_diffusion_tpu_torch.ops import attention as A
    from vidseg_diffusion_tpu_torch.scripts import t5_path as T5P

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        api = T5P.build(tmp, seed=0)
    torch.cuda.synchronize()
    pipe = api.pipeline
    n_t5 = sum(p.numel() for p in pipe.t5.parameters())
    n_unet = sum(p.numel() for p in pipe.unet.parameters())
    check(pipe.kind == "t5_text" and pipe.spec.unet_config.context_dim == 4096 and 4.75e9 < n_t5 < 4.77e9,
          f"[api_t5] built {pipe.kind}, context {pipe.spec.unet_config.context_dim}, T5 {n_t5}")
    print(f"[api_t5] built sd_2_1.yaml with T5 v1.1-XXL (T5 {n_t5 / 1e9:.3f} B, UNet {n_unet / 1e9:.3f} B, bf16) in "
          f"{time.perf_counter() - t0:.1f} s, {torch.cuda.memory_allocated() / 1e9:.2f} GB resident", flush=True)
    ids, p25 = T5P.tokens(), T5P.params()
    gen = lambda: torch.Generator(device="cuda").manual_seed(5)
    api.text_to_image(T5P.params(steps=2), ids, generator=gen())   # warm-up
    unet_t, t5_t = UNetTimer(torch, pipe.unet), UNetTimer(torch, pipe.t5)
    watch = DecoderWatch(torch, pipe.first_stage.decoder)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    image = api.text_to_image(p25, ids, generator=gen())
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    per_call, t5_s, peak = unet_t.mean_s(), t5_t.mean_s() * t5_t.calls, torch.cuda.max_memory_allocated() / 1e9
    check(unet_t.calls == T5P.STEPS and t5_t.calls == 2, f"[api_t5] {unet_t.calls} UNet calls, {t5_t.calls} T5")
    watch.check("api_t5 timed", 1)
    check(tuple(image.shape) == (1, T5P.SIZE, T5P.SIZE, 3) and bool(torch.isfinite(image).all()),
          f"[api_t5] image {tuple(image.shape)}")
    print(f"[api_t5] seconds per 512x512 image at 25 steps {secs:.3f}, of which the two T5-XXL passes {t5_s:.4f} "
          f"(CUDA events), per UNet call {per_call:.4f}, peak {peak:.2f} GB, without the call-counting hook "
          f"({card_line()})", flush=True)
    graph_ms, pass_ms = t5_pass_graph_ms(torch, pipe.t5, ids), t5_s / 2 * 1e3
    print(f"[api_t5] one T5-XXL pass as a CUDA graph: {graph_ms:.3f} ms a replay (its device time); the timed "
          f"image's passes {pass_ms:.3f} ms each (device idle {1 - graph_ms / pass_ms:.1%} of a pass)", flush=True)
    unet_t.reset()
    t5_t.reset()
    reset_counts()
    with counting_calls(torch):
        again = api.text_to_image(p25, ids, generator=gen())
    torch.cuda.synchronize()
    watch.check("api_t5 counted", 1)
    check(unet_t.calls == T5P.STEPS and t5_t.calls == 2, f"[api_t5] counted run: {unet_t.calls} UNet calls")
    launches, routes = check_api_run("t5", "txt2img 25 steps")
    sites = {lq: A.site_route("blhd", 2, lq, 77) for lq in (4096, 1024, 256, 64)}
    check(sites == {4096: "mha_reference", 1024: "mha_reference", 256: "small_batched", 64: "small_batched"}
          and routes["flash_attention_packed"]["normalised"] == T5_NORMALISED_PER_UNET * T5P.STEPS,
          f"[api_t5] 77-key sites {sites}, normalise-first K1 {routes['flash_attention_packed']['normalised']}")
    drift = (again - image).abs().max().item()
    print(f"[api_t5] counted run: launches {json.dumps(launches)}; by route {json.dumps(routes)}; 77-key sites "
          f"{json.dumps(sites)}; max |image - timed run's| {drift:.3e}", flush=True)
    for w in (unet_t, t5_t, watch):
        w.remove()
    del api, pipe, image, again
    gc.collect()
    torch.cuda.empty_cache()
    t5_fp32_card_vs_cpu(torch)
    with tempfile.TemporaryDirectory() as tmp:
        class_card_vs_cpu(torch, tmp)


def _http(url, form=None, timeout=600):
    """(status, content type, body) of a GET (form None) or a POST of `form`."""
    import urllib.error
    import urllib.parse
    import urllib.request

    data = None if form is None else urllib.parse.urlencode(form).encode()
    try:
        with urllib.request.urlopen(url, data=data, timeout=timeout) as resp:
            return resp.status, resp.headers["Content-Type"], resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers["Content-Type"], e.read()


@contextlib.contextmanager
def serving(app):
    """The app's handler on a ThreadingHTTPServer at 127.0.0.1 (a free port)
    in a thread; yields its URL; shut down and closed on exit."""
    import threading
    from http.server import ThreadingHTTPServer

    from vidseg_diffusion_tpu_torch.scripts.demo.serve import make_handler

    srv = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(app))
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        yield f"http://127.0.0.1:{srv.server_address[1]}"
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=60)


def phase_demo(torch):
    """The demo server (scripts/demo/serve.py) on sd_2_1.yaml at 512x512, bf16,
    random weights, served on 127.0.0.1 in a thread: GET / and /health; a
    2-step warm-up request (the first call's weight re-lays); a txt2img POST
    (25 steps, a prompt in the tiny BPE vocabulary) and an img2img POST on a
    PNG under --init-root (strength 0.75), each timed without the
    call-counting hook, then sent again under it for its launches (as its
    module calls imply); each PNG 512x512x3 within DEMO_PNG_LEVELS of the
    SamplingPipeline's image for the same seed and parameters; an init path that
    escapes the root answers JSON 500 with PermissionError. Then a second app on
    svd.yaml: one img2vid POST at 1024x576 x 14 frames, 25 steps, a GIF of 14
    frames, its launches as window_launches reckons them. Seconds per request.
    Returns the two PNGs' images [2, 512, 512, 3] in [0, 1] on the card."""
    import io
    import tempfile

    import numpy as np
    from PIL import Image

    from vidseg_diffusion_tpu_torch.io.tokenizer import TINY_VOCAB
    from vidseg_diffusion_tpu_torch.ops import attention as A
    from vidseg_diffusion_tpu_torch.scripts import api_path as AP
    from vidseg_diffusion_tpu_torch.scripts.demo.serve import DemoApp, load_init, to_uint8

    seconds, images = {}, []
    with tempfile.TemporaryDirectory() as root:
        to_png = lambda a, name: Image.fromarray(((a[0] + 1.0) * 127.5).astype(np.uint8)).save(
            os.path.join(root, name))
        to_png(AP.image(512, 512), "init.png")
        to_png(AP.image(576, 1024), "cond.png")
        t0 = time.perf_counter()
        app = DemoApp(os.path.join(ROOT, "configs/inference/sd_2_1.yaml"), default_size=512, init_root=root,
                      bpe_path=TINY_VOCAB)
        torch.cuda.synchronize()
        print(f"[demo] DemoApp on sd_2_1.yaml (bf16) up in {time.perf_counter() - t0:.1f} s", flush=True)
        unet_t, watch = UNetTimer(torch, app.pipeline.unet), DecoderWatch(torch, app.pipeline.first_stage.decoder)
        with serving(app) as url:
            status, ctype, body = _http(url + "/")
            check(status == 200 and ctype.startswith("text/html") and b"<form" in body, f"[demo] GET / {status}")
            status, _, body = _http(url + "/health")
            check(status == 200 and json.loads(body) == {"ok": True}, f"[demo] GET /health {status} {body[:80]}")
            status, ctype, _ = _http(url + "/generate", dict(mode="txt2img", steps=2, width=512, height=512))
            check(status == 200 and ctype == "image/png", f"[demo] warm-up request: {status}")   # weight re-lays
            watch.check("demo warm-up", 1)
            forms = {"txt2img": dict(mode="txt2img", prompt=AP.PROMPT, steps=25, scale=5.0, width=512, height=512,
                                     seed=7),
                     "img2img": dict(mode="img2img", prompt=AP.PROMPT, steps=25, scale=5.0, width=512, height=512,
                                     seed=8, init_path="init.png", strength=0.75)}
            for label, form in forms.items():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                status, ctype, body = _http(url + "/generate", form)
                seconds[label] = time.perf_counter() - t0
                check(status == 200 and ctype == "image/png", f"[demo] {label}: {status} {body[:200]}")
                watch.check(f"demo {label} timed", 1)
                unet_t.reset()
                reset_counts()
                t0 = time.perf_counter()
                with counting_calls(torch):
                    status, ctype, counted = _http(url + "/generate", form)
                hooked_s = time.perf_counter() - t0
                unet_calls = unet_t.calls
                check(status == 200 and ctype == "image/png", f"[demo] {label} counted: {status} {counted[:200]}")
                watch.check(f"demo {label} counted", 1)
                launches, routes = check_api_run("demo", label)
                got, again = (np.asarray(Image.open(io.BytesIO(b))) for b in (body, counted))
                params = app.sampling_params(form)
                tok, neg = app._tokens(form["prompt"]), app._tokens("")
                if label == "txt2img":
                    want = app.api.text_to_image(params, tok, neg, generator=app.generator(form))
                else:
                    init = load_init(os.path.join(root, "init.png"), 512, 512)
                    want = app.api.image_to_image(params, init, tok, neg, generator=app.generator(form))
                watch.flags = []
                levels = [int(np.abs(a.astype(np.int16) - to_uint8(want[0]).astype(np.int16)).max())
                          for a in (got, again)]
                check(got.shape == again.shape == (512, 512, 3) and max(levels) <= DEMO_PNG_LEVELS,
                      f"[demo] {label}: PNGs {got.shape} {again.shape}, {levels} uint8 levels from the API's image")
                images.append(torch.from_numpy(got.astype(np.float32) / 255.0).cuda())
                print(f"[demo] {label}: {seconds[label]:.3f} s a request (without the call-counting hook); "
                      f"counted request, with it: {hooked_s:.3f} s, {unet_calls} UNet calls; PNGs {got.shape}, {levels} uint8 levels from the "
                      f"API's image (timed, counted); launches {json.dumps(launches)}; by route "
                      f"{json.dumps(routes)}", flush=True)
            status, ctype, body = _http(url + "/generate", dict(steps=2, init_path=os.path.join(root, "..", "x.png")))
            err = json.loads(body).get("error", "") if ctype == "application/json" else ""
            check(status == 500 and err.startswith("PermissionError"), f"[demo] escaping path: {status} {err}")
            print(f"[demo] an init path outside --init-root: {status} {err}", flush=True)
        for w in (unet_t, watch):
            w.remove()
        del app
        gc.collect()
        torch.cuda.empty_cache()
        app = DemoApp(os.path.join(ROOT, "configs/inference/svd.yaml"), default_size=512, init_root=root)
        unet_t, watch = UNetTimer(torch, app.pipeline.unet), DecoderWatch(torch, app.pipeline.first_stage.decoder)
        with serving(app) as url:
            form = dict(mode="img2vid", steps=25, width=1024, height=576, num_frames=14, init_path="cond.png", seed=9)
            reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            status, ctype, body = _http(url + "/generate", form)
            seconds["img2vid"] = time.perf_counter() - t0
        check(status == 200 and ctype == "image/gif", f"[demo] img2vid: {status} {body[:200]}")
        gif = Image.open(io.BytesIO(body))
        check(gif.n_frames == 14 and gif.size == (1024, 576), f"[demo] GIF {gif.n_frames} frames of {gif.size}")
        vp = app.video_params(form)
        calls = {"unet": unet_t.calls, "encoder": 1, "decoder": vp.num_frames // vp.decoding_t}
        watch.check("demo img2vid", calls["decoder"])
        check(calls["unet"] == vp.steps, f"[demo] img2vid {calls['unet']} UNet calls")
        launches, plain_calls = read_counts()
        implied, normalised = window_launches(app.pipeline, True, calls)
        expected = {name: implied.get(name, 0) for name in launches}
        expected.update(group_norm_expected("demo img2vid", implied["group_norm"]))
        check(launches == expected and all(n == 0 for n in plain_calls.values())
              and A.mha_reference_site.calls == 0, f"[demo] img2vid launches {launches}, expected {expected}")
        routes = check_routes("demo img2vid", launches,
                              calls["decoder"] * narrow_tconv_sites(app.pipeline.first_stage.decoder), normalised)
        add_run("demo", launches, routes)
        print(f"[demo] img2vid svd.yaml 14 x 1024x576, 25 steps: {seconds['img2vid']:.3f} s a request, GIF of "
              f"{gif.n_frames} frames ({len(body) / 1e6:.1f} MB); launches {json.dumps(launches)}", flush=True)
        for w in (unet_t, watch):
            w.remove()
        del app
        gc.collect()
        torch.cuda.empty_cache()
    print(f"[demo] seconds per request {json.dumps({k: round(v, 3) for k, v in seconds.items()})} "
          f"({card_line()})", flush=True)
    return torch.stack(images)


def phase_safety(torch, images):
    """SafetyFilter with a CLIP ViT-L/14 image tower (width 1024, 24 layers, 16
    heads, patch 14, 224, output 768; random bf16) on the demo's two images,
    synthetic heads: p (bias -10) flags none, w (bias +10) every frame. Its
    launches: K3 in the normalise-first mode at the 24 [2,16,257,64] sites,
    nothing else. Held to the same tower in fp32 on the CPU: the features
    within SAFETY_FEAT_TOL by norm, the flags equal, each head's logits within
    the bound the feature error gives, each output frame the CPU's blur of the
    input within SAFETY_BLUR_TOL. Then embed_watermark on a 512x512 image and
    its decode: 48 of 48 bits, the top bucket; frechet_distance in float64 on
    the card for two seeded 2048 x 1024 populations vs scipy's sqrtm formula on
    the CPU (FID_RTOL); prefetch_to_device landing on the card in order;
    utils/profiling.trace writing a trace that names a K1 kernel. Returns the
    filter's launches."""
    import tempfile

    import numpy as np
    import scipy.linalg

    from vidseg_diffusion_tpu_torch.engine.build import randomize_
    from vidseg_diffusion_tpu_torch.eval.fid import feature_stats, frechet_distance
    from vidseg_diffusion_tpu_torch.io.data import prefetch_to_device
    from vidseg_diffusion_tpu_torch.models.clip import CLIPVisionConfig, CLIPVisionTransformer, clip_preprocess
    from vidseg_diffusion_tpu_torch.ops import attention as A
    from vidseg_diffusion_tpu_torch.utils import profiling
    from vidseg_diffusion_tpu_torch.utils.safety import SafetyFilter, blur_frames, embed_watermark
    from vidseg_diffusion_tpu_torch.utils.watermark import MATCH_VALUES, classify_match, watermark_match_bits

    with torch.device("meta"):
        tower = CLIPVisionTransformer(CLIPVisionConfig(dtype=torch.bfloat16, **VIT_L14))
    tower.to(torch.bfloat16).to_empty(device="cuda")
    randomize_(tower, torch.Generator(device="cuda").manual_seed(11))
    tower.eval().requires_grad_(False)
    cpu_tower = CLIPVisionTransformer(CLIPVisionConfig(dtype=torch.float32, **VIT_L14)).eval().requires_grad_(False)
    cpu_tower.load_state_dict({k: v.float().cpu() for k, v in tower.state_dict().items()})
    clip_fn = lambda t: (lambda f: t(clip_preprocess(f * 2.0 - 1.0)))
    rs = np.random.RandomState(12)
    d = VIT_L14["output_dim"]
    heads = dict(p_head=(rs.randn(1, d).astype(np.float32) / d ** 0.5, np.array([-10.0], np.float32)),
                 w_head=(rs.randn(1, d).astype(np.float32) / d ** 0.5, np.array([10.0], np.float32)))
    card_f, cpu_f = SafetyFilter(clip_fn(tower), **heads), SafetyFilter(clip_fn(cpu_tower), **heads)
    frames = images.float()
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    out = card_f(frames)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches, plain_calls = read_counts()
    layers = VIT_L14["layers"]
    expected = {name: (layers if name == "flash_attention" else 0) for name in launches}
    check(launches == expected and all(n == 0 for n in plain_calls.values()),
          f"[safety] launches {launches}, expected {expected}; plain {plain_calls}")
    routes = check_routes("safety", launches, normalised={"flash_attention": layers})
    check(DIM_COUNTS["safety"]["flash_attention.normalised"] == {64: layers},
          f"[safety] K3 normalise-first by head dim {DIM_COUNTS['safety']['flash_attention.normalised']}")
    with torch.no_grad():
        f_card, f_cpu = tower(clip_preprocess(frames * 2.0 - 1.0)).float().cpu(), cpu_tower(
            clip_preprocess(frames.cpu() * 2.0 - 1.0))
    feat_err = ((f_card - f_cpu).norm() / f_cpu.norm()).item()
    s_card, s_cpu = card_f.scores(frames), cpu_f.scores(frames.cpu())
    # the heads' logits as they see the features (cast to fp16); |w . (f16(a) - f16(b))| <= ||w|| (||a - b||
    # + the two fp16 roundings, 2^-11 of ||b|| each)
    logits = lambda f: np.stack([f.numpy().astype(np.float16) @ w.T + b for w, b in heads.values()])
    logit_err = float(np.abs(logits(f_card) - logits(f_cpu)).max())
    bound = max(float(np.linalg.norm(h[0])) for h in heads.values()) * (
        (f_card - f_cpu).norm(dim=1).max().item() + 2.0 ** -10 * f_cpu.norm(dim=1).max().item())
    cpu_out = cpu_f(frames.cpu())
    want = blur_frames(frames.cpu())
    blur_err = ((out.cpu() - want).abs().max() / want.abs().max()).item()
    flags = [(s > 0.5).tolist() for s in s_card]
    check(feat_err <= SAFETY_FEAT_TOL and logit_err <= bound and flags == [(s > 0.5).tolist() for s in s_cpu]
          and flags == [[False] * len(frames), [True] * len(frames)] and blur_err <= SAFETY_BLUR_TOL
          and torch.equal(cpu_out, want),
          f"[safety] features {feat_err}, logits {logit_err} (bound {bound}), flags {flags}, blur {blur_err}")
    print(f"[safety] SafetyFilter ViT-L/14 bf16 on {len(frames)} frames of 512x512: {secs:.3f} s; features vs fp32 "
          f"CPU {feat_err:.3e} by norm (tol {SAFETY_FEAT_TOL:.0e}); logits within {logit_err:.3e} (bound "
          f"{bound:.3e}); flags p {flags[0]} w {flags[1]}; blurred frames vs the CPU's blur {blur_err:.3e} of max "
          f"(tol {SAFETY_BLUR_TOL:.2e}); launches {json.dumps(launches)}; by route {json.dumps(routes)}", flush=True)

    marked = embed_watermark(frames[:1], 1.0)
    bits = int(watermark_match_bits(marked.cpu().numpy().astype(np.float64))[0])
    plain_bits = int(watermark_match_bits(frames[:1].cpu().numpy().astype(np.float64))[0])
    moved = (marked - frames[:1]).abs().max().item()
    check(bits == 48 and classify_match(bits) == MATCH_VALUES[-1][1] and marked.device == frames.device,
          f"[safety] watermark: {bits} of 48 bits, {classify_match(bits)}")
    print(f"[safety] embed_watermark 512x512: {bits} of 48 bits decoded ({classify_match(bits)!r}); the unmarked "
          f"image matches {plain_bits}; max pixel change {moved:.4f}", flush=True)

    g = torch.Generator().manual_seed(13)
    n, dim = FID_FEATURES
    mix = torch.randn(dim, dim, generator=g, dtype=torch.float64) / dim ** 0.5
    pops = [torch.randn(n, dim, generator=g, dtype=torch.float64) @ (mix + s * torch.eye(dim, dtype=torch.float64))
            + s for s in (0.0, 0.1)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stats = [feature_stats(p.cuda()) for p in pops]
    fid = frechet_distance(*stats[0], *stats[1])
    torch.cuda.synchronize()
    fid_s = time.perf_counter() - t0
    mu1, s1 = pops[0].mean(0).numpy(), np.cov(pops[0].numpy(), rowvar=False)
    mu2, s2 = pops[1].mean(0).numpy(), np.cov(pops[1].numpy(), rowvar=False)
    covmean = scipy.linalg.sqrtm(s1 @ s2).real
    want_fid = float((mu1 - mu2) @ (mu1 - mu2) + np.trace(s1) + np.trace(s2) - 2.0 * np.trace(covmean))
    fid_rel = abs(fid.item() - want_fid) / abs(want_fid)
    check(fid.dtype == torch.float64 and fid.device.type == "cuda" and fid_rel <= FID_RTOL,
          f"[safety] FID {fid.item()} vs scipy {want_fid}: {fid_rel}")
    print(f"[safety] frechet_distance float64 on the card, 2 x {n} x {dim}: {fid.item():.10f} vs scipy sqrtm "
          f"{want_fid:.10f}, {fid_rel:.3e} relative (tol {FID_RTOL:.0e}); {fid_s:.3f} s on the card", flush=True)

    items = [(np.full((4,), i, np.float32), {"i": torch.full((2,), float(i))}) for i in range(6)]
    got = list(prefetch_to_device(iter(items), size=2, device="cuda"))
    check(len(got) == 6 and all(x.is_cuda and y["i"].is_cuda and int(x[0].item()) == i == int(y["i"][0].item())
                                for i, (x, y) in enumerate(got)), "[safety] prefetch_to_device order / device")

    q, k, v = (torch.randn(2, 4096, 320, device="cuda", dtype=torch.bfloat16) for _ in range(3))
    with tempfile.TemporaryDirectory() as tmp:
        reset_counts()
        with profiling.trace(tmp):
            with profiling.annotate("vs:k1_probe"):
                A.flash_attention_packed(q, k, v, 5)
            torch.cuda.synchronize()
        with open(os.path.join(tmp, "trace.json")) as f:
            events = json.load(f)["traceEvents"]
    kernels = sorted({e["name"] for e in events if e.get("cat") == "kernel" and "flash_fwd" in e.get("name", "")})
    check(kernels and any(e.get("name") == "vs:k1_probe" for e in events), f"[safety] trace kernels {kernels}")
    print(f"[safety] prefetch_to_device: 6 batches on cuda in order; profiling.trace names {kernels}", flush=True)
    reset_counts()
    return launches


def video_gradients(torch, trainer, n_videos):
    """The step-1 gradients of each video of scripts/train_path.py's batch of
    `n_videos`, alone, as the rank that holds it computes them under
    FSDPTrainStep (sigma and noise drawn for the whole batch, then sliced;
    the loss the mean over its frames): their mean and the mean of their
    magnitudes over the videos, fp32, by parameter name."""
    from vidseg_diffusion_tpu_torch.scripts import train_path

    latents, cond = train_path.batch(n_videos)
    sigma, noise = trainer.loss_mod.draw(latents, train_path.generators())
    f = train_path.NUM_FRAMES
    mean, scale = {}, {}
    for r in range(n_videos):
        share = slice(r * f, (r + 1) * f)
        trainer.model.zero_grad(set_to_none=True)
        loss = trainer.loss_mod(trainer.network_factory(trainer.model), latents[share],
                                {k: v[share] for k, v in cond.items()}, sigma=sigma[share], noise=noise[share])
        loss.backward()
        for name, p in trainer.model.named_parameters():
            if p.grad is not None:
                g = p.grad.float()
                mean[name] = mean[name] + g / n_videos if name in mean else g / n_videos
                scale[name] = scale[name] + g.abs() / n_videos if name in scale else g.abs() / n_videos
    trainer.model.zero_grad(set_to_none=True)
    return mean, scale


def reduced_gradient_violations(torch, grads, mean, scale, world):
    """Elements of the reduced step-1 gradients `grads` farther from the mean
    of the ranks' own gradients than a bf16 sum of `world` terms can round:
    world x 2^-8 x the mean of their magnitudes (a leaf missing counts
    whole)."""
    bad = sum(mean[n].numel() for n in set(mean) - set(grads)) + sum(grads[n].numel() for n in set(grads) - set(mean))
    for name in set(grads) & set(mean):
        bad += int(((grads[name].float() - mean[name]).abs() > world * 2.0 ** -8 * scale[name]).sum())
    return bad


def adam_bound_violations(torch, got, want, lr):
    """Elements of two runs' params and EMA (parts 1, 2 of a state) farther
    apart than FSDP_STEPS bf16 Adam steps on different gradients can take
    them: 2 x FSDP_STEPS x 1.05 lr (an early Adam step moves an element by at
    most lr, 1 % more for the bf16 moments) plus 4 bf16 steps of the element
    for the roundings of the params and the EMA."""
    bad = 0
    for part in (1, 2):
        for name, w in want[part].items():
            w = w.float()
            ulp = torch.exp2(torch.floor(torch.log2(w.abs().clamp(min=2.0 ** -126))) - 7)
            bad += int(((got[part][name].float() - w).abs() > 2 * FSDP_STEPS * 1.05 * lr + 4 * ulp).sum())
    return bad


def main_ranks():
    """`torchrun --nproc_per_node W chip_smoke.py --ranks` on W cards (the
    kernels built beforehand, once): the two paths of parallel/ that exist
    only across cards, each held to one card's result.
    1. The main path's run_single_video (scripts/main_path.py: 2 masks, so
       with W > 2 some ranks hold no mask and join every collective with
       padding alone) with its runs over the W ranks, against the same call
       without a group on each rank: final latents, difference maps, masks
       and labels bit-equal on every rank; the seconds of both.
    2. scripts/train_path.py's step FSDP-wrapped over the W ranks (NCCL
       all-gather and reduce-scatter, each parameter sharded on JAX's dim)
       on a batch of W videos, each rank on its video and its share of the
       sigma / noise drawn for the whole batch (FSDPTrainStep), FSDP_STEPS
       steps with cuDNN's deterministic algorithms. On the first rank:
       - the reduced step-1 gradients against the mean of each video's
         gradient computed alone on one card with FSDP's input nodes (what
         each rank computes), within what a bf16 sum over W ranks can round
         (reduced_gradient_violations); a sum where the mean is due must
         fail that bound (checked);
       - the params and EMA after the steps against the unwrapped steps on
         one card's W-video batch, within what FSDP_STEPS Adam steps on
         other gradients can move an element (adam_bound_violations); a
         leaf whose shards trade places must fail it (checked); the loss
         within 1e-2; no stale weight copy read. The gradients and updates
         by norm against the unwrapped steps are printed (Adam's first steps,
         about lr x sign(g), magnify a changed rounding of a near-zero
         gradient). Step seconds of both.
    Prints the card line and one JSON line of the readings."""
    import numpy as np
    import torch

    from vidseg_diffusion_tpu_torch.ops import _cuda
    from vidseg_diffusion_tpu_torch.parallel.mesh import initialize_distributed
    from vidseg_diffusion_tpu_torch.pipelines.single_video import run_single_video
    from vidseg_diffusion_tpu_torch.scripts import main_path, train_path

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this run needs NVIDIA cards")
    group = initialize_distributed()
    rank, world = group.rank(), group.size()
    _cuda.load_library()
    say = (lambda msg: print(f"[ranks] {msg}", flush=True)) if rank == 0 else (lambda msg: None)
    say(f"{world} ranks, NCCL; {card_line()}")
    out = {"world": world}

    pipe = main_path.build()
    frames, names, args = main_path.frames(), main_path.frame_names(), main_path.vidseg_args()
    seconds = {}
    for tag, pg in (("one", None), ("group", group)):
        torch.cuda.synchronize()
        group.barrier()
        t0 = time.perf_counter()
        timings = {}
        res = run_single_video(pipe, frames, names, args, write_outputs=False, timings=timings, process_group=pg)
        seconds[tag] = (time.perf_counter() - t0, timings["modulated_runs"])
        if pg is None:
            ref = res
    same = all(np.array_equal(getattr(res, k), getattr(ref, k))
               for k in ("final_latents", "diff_maps", "seg_raw", "seg_filtered", "masks", "unique_labels"))
    flags = torch.tensor([int(same)], device="cuda")
    torch.distributed.all_reduce(flags, op=torch.distributed.ReduceOp.MIN, group=group)
    out["runs"] = {"bit_equal_on_every_rank": bool(flags.item()), "one_rank_s": seconds["one"][0],
                   "one_rank_modulated_runs_s": seconds["one"][1], "group_s": seconds["group"][0],
                   "group_modulated_runs_s": seconds["group"][1], "masks": args.num_masks}
    say(f"run_single_video alone {seconds['one'][0]:.2f} s (modulated_runs {seconds['one'][1]:.2f} s), over the "
        f"{world} ranks {seconds['group'][0]:.2f} s ({seconds['group'][1]:.2f} s); bit-equal on every rank: "
        f"{bool(flags.item())}")
    check(bool(flags.item()), "[ranks] the runs over the ranks differ from one rank's run")
    del pipe, res, ref
    torch.cuda.empty_cache()

    saved_det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    trainer = train_path.build(fsdp=True)
    state, times, losses, stale = two_train_steps(torch, trainer, n_videos=world)
    shard = {type(p).__name__ for p in trainer.model.parameters()}
    check(shard == {"DTensor"}, f"[ranks] wrapped parameters are {shard}")
    del trainer
    torch.cuda.empty_cache()
    n_stale = torch.tensor([len(stale)], device="cuda")
    torch.distributed.all_reduce(n_stale, group=group)
    if rank == 0:
        plain_trainer = train_path.build()
        init = {n: p.detach().clone() for n, p in plain_trainer.model.named_parameters()}
        plain, plain_times, plain_losses, _ = two_train_steps(torch, plain_trainer, n_videos=world)
        del plain_trainer
        torch.cuda.empty_cache()
        gap = state_gap(torch, state, plain, init)
        del init
        ref_trainer = train_path.build()
        fsdp_input_nodes(torch, ref_trainer.model)
        mean, scale = video_gradients(torch, ref_trainer, world)
        del ref_trainer
        torch.cuda.empty_cache()
        grad_bad = reduced_gradient_violations(torch, state[0], mean, scale, world)
        summed_bad = reduced_gradient_violations(torch, {n: g * world for n, g in state[0].items()}, mean, scale, world)
        del mean, scale
        adam_bad = adam_bound_violations(torch, state, plain, train_path.LR)
        big = max(state[1], key=lambda n: state[1][n].numel())
        swapped = (state[0], dict(state[1], **{big: state[1][big].roll(state[1][big].shape[0] // 2, 0)}), state[2])
        swapped_bad = adam_bound_violations(torch, swapped, plain, train_path.LR)
        loss_err = max(abs(a - b) / abs(b) for a, b in zip(losses, plain_losses))
        out["fsdp"] = {"videos": world, "step_s": times, "unwrapped_step_s": plain_times, "losses": losses,
                       "unwrapped_losses": plain_losses, "grad_elements_beyond_the_reduce_bound": grad_bad,
                       "planted_sum_elements_beyond": summed_bad, "param_ema_elements_beyond_the_adam_bound": adam_bad,
                       "planted_swap_elements_beyond": swapped_bad, "grad_err": gap[0], "update_err": gap[1],
                       "elements_beyond_a_bf16_step": gap[2], "stale_copies": int(n_stale.item())}
        say(f"FSDP over {world} ranks, a video each of {world}: step_s {[round(x, 4) for x in times]} vs unwrapped "
            f"{[round(x, 4) for x in plain_times]} on one card; losses {losses} vs {plain_losses}; reduced step-1 "
            f"gradients beyond the bf16 reduce bound {grad_bad} elements (a planted sum {summed_bad}); params and EMA "
            f"beyond the Adam bound {adam_bad} (a planted shard swap of {big} {swapped_bad}); by norm against "
            f"unwrapped: step-1 gradients {gap[0]:.2e}, updates {gap[1]:.2e}, {gap[2]} elements more than one bf16 "
            f"step apart; stale copies read {int(n_stale.item())}")
        check(grad_bad == 0 and adam_bad == 0 and n_stale.item() == 0 and loss_err <= 1e-2,
              f"[ranks] the FSDP steps over {world} ranks differ from one card's: {grad_bad} gradient and {adam_bad} "
              f"param / EMA elements beyond their bounds, loss {loss_err:.2e}, {int(n_stale.item())} stale copies")
        check(summed_bad > 0 and swapped_bad > 0, "[ranks] a planted fault passed the bounds")
    torch.backends.cudnn.deterministic = saved_det
    group.barrier()
    torch.distributed.destroy_process_group()
    if rank == 0:
        print(json.dumps({"ranks": out}))
        print(card_line())


def main():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs an NVIDIA card")
    sys.path.insert(0, ROOT)
    from vidseg_diffusion_tpu_torch.ops import _cuda
    from vidseg_diffusion_tpu_torch.ops import norm as N

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

    module_hooks()
    torch.nn.modules.module.register_module_forward_pre_hook(HOOKS["group_norm_route"])
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
    t0 = time.perf_counter()
    options_launches = phase_model_options(torch)
    phases["model_options"] = time.perf_counter() - t0
    for name, fn in (("unet", phase_unet), ("train_grad", phase_train_grad)):
        t0 = time.perf_counter()
        fn(torch)
        phases[name] = time.perf_counter() - t0
    t0 = time.perf_counter()
    launches, pipe, plain_res = phase_main(torch)
    phases["main"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    group = join_group()
    fsdp_runs_launches = phase_fsdp_runs(torch, pipe, plain_res, launches, group)
    phases["fsdp_runs"] = time.perf_counter() - t0
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
    for name, fn in (("sweep", phase_sweep), ("refine", phase_refine), ("api_img2vid", phase_api_img2vid)):
        t0 = time.perf_counter()
        fn(torch, pipe)
        phases[name] = time.perf_counter() - t0
    del pipe
    gc.collect()   # free the SVD models before the SD and training phases
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    long_video_launches = phase_long_video(torch)
    phases["long_video"] = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    sd_launches, pipe = phase_sd(torch)
    phases["sd"] = time.perf_counter() - t0
    for name, fn in (("sweep_sd", phase_sweep_sd), ("api_nti", phase_api_nti)):
        t0 = time.perf_counter()
        fn(torch, pipe)
        phases[name] = time.perf_counter() - t0
    del pipe
    gc.collect()
    torch.cuda.empty_cache()
    for name, fn in (("api_sdxl", phase_api_sdxl), ("api_fp32", phase_api_fp32), ("api_t5", phase_api_t5)):
        t0 = time.perf_counter()
        fn(torch)
        phases[name] = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    demo_images = phase_demo(torch)
    phases["demo"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    safety_launches = phase_safety(torch, demo_images)
    phases["safety"] = time.perf_counter() - t0
    del demo_images
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    train_launches = phase_train(torch)
    phases["train"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    fsdp_launches = phase_fsdp(torch)
    phases["fsdp"] = time.perf_counter() - t0
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
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    phase_ae_video_train(torch)
    phases["ae_video_train"] = time.perf_counter() - t0
    check(N.group_norm_backward_route.unplaced == 0, "a GroupNorm backward's slab plan the card could not place")
    print(f"[phases] seconds {json.dumps({k: round(v, 1) for k, v in phases.items()})} ({card})", flush=True)
    torch.distributed.destroy_process_group()

    kernels = []
    tags = ("main", "inject", "sd", "train", "ae_train", "sweep", "sweep_sd")
    # this slice's paths: the inversion run, the VideoDecoder's two time modes
    # (their decodes summed), and the tiny config's run for the D = 16 instances
    slice_runs = {"inversion": inversion_launches, "tiny": tiny_launches,
                  "vae_time_mode": {k: sum(r[k] for r in vae_launches.values()) for k in inversion_launches}}
    DIM_COUNTS["vae_time_mode"] = sum_dims(DIM_COUNTS[f"vae_{m}"] for m in VAE_TIME_MODES)
    ROUTE_COUNTS["vae_time_mode"] = sum_dims(ROUTE_COUNTS[f"vae_{m}"] for m in VAE_TIME_MODES)
    # the sampling API's runs, each summed over its tag's runs (the fp32 tiny runs apart), and
    # svd.yaml's first stage trained at its three decoder modes (summed)
    for tag in ("api", "img2vid", "nti", "t5", "demo", "ae_video_train"):
        slice_runs[tag] = {k: API_RUNS[tag].get(k, 0) for k in inversion_launches}
        DIM_COUNTS[tag], ROUTE_COUNTS[tag] = API_DIMS[tag], API_ROUTES[tag]
    # the T5-XXL txt2img and the demo's requests (API runs, above), the safety filter's tower
    slice_runs["safety"] = safety_launches
    # the model options' card runs, the main path's runs over the one-rank group, the FSDP steps
    slice_runs.update(model_options=options_launches, fsdp_runs=fsdp_runs_launches, fsdp=fsdp_launches,
                      long_video=long_video_launches)
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
        elif "long_dims" in meta:  # K2 / K6 past 32 frames: the wrapper's long-route launches at those head dims
            runs = {tag: sum(DIM_COUNTS.get(tag, {}).get(f"{meta['wrapper']}.long", {}).get(d, 0)
                             for d in meta["long_dims"])
                    for tag in tags + tuple(slice_runs) + ((meta["path"],) if meta["path"] else ())}
            runs["main"] = runs[meta["path"]] if meta["path"] else 0   # its path's run
            check(not meta["path"] or runs["main"] > 0, f"{name} never launched in the {meta['path']} run")
            extra = {"path": meta["path"] or "none (no path runs it)", "long_dims": list(meta["long_dims"])}
            routed = None
        elif "route_of" in meta:  # the kernels of a route: their wrappers' launches on it in each run
            route = meta.get("route", "tf32x3")
            paths = meta.get("paths", (meta["path"],))
            ROUTE_COUNTS.setdefault("api_fp32", API_ROUTES.get("api_fp32", {}))   # the fp32 sampling runs summed
            runs = {tag: sum(ROUTE_COUNTS.get(tag, {}).get(w, {}).get(route, 0) for w in meta["route_of"])
                    for tag in tags + tuple(slice_runs) + paths}
            runs["main"] = runs[meta["path"]]   # its path's run
            check(all(runs[p] > 0 for p in paths), f"{name} never launched in a run of {paths}: {runs}")
            extra = {"path": meta["path"], "counted_route": route}
            if len(paths) > 1:
                extra["path_launches"] = {p: runs[p] for p in paths}
            routed = None
        else:
            # the run of its path: inference for K1-K4, K7, K8, K11, K12, diffusion training for
            # K5, K6, the GroupNorm backward's kernels, autoencoder training for K13
            path_launches = (launches if name in INFERENCE_KERNELS
                             else ae_launches if name in AE_KERNELS else train_launches)
            runs = dict(main=path_launches[name], inject=inject_launches[name], sd=sd_launches[name],
                        train=train_launches[name], ae_train=ae_launches[name], sweep=SWEEP["sweep"][name],
                        sweep_sd=SWEEP["sweep_sd"][name],
                        **{tag: r[name] for tag, r in slice_runs.items()})
            # K1, K2, K3, K4, K5, K6, K11 and K13: the launches of each path by the kernel that ran
            # (checked); the GroupNorm forward's routes are kernels of their own (K7 + K8, the fused K7+K8)
            routed = ({tag: ROUTE_COUNTS[tag][name] for tag in tags + ("inversion", "api", "img2vid", "nti", "t5",
                                                                     "demo", "safety", "ae_video_train",
                                                                     "long_video")}
                      if name in ROUTED else None)
            if name.startswith("group_norm_backward"):   # the runs' GroupNorm backwards by route
                extra = {"backward_routes": {tag: r for tag, r in GN_BWD_RUNS.items() if any(r.values())}}
        kernels.append(dict(
            name=name, route="cuda", source=meta["source"], replaces=meta["replaces"],
            launches=runs["main"], inject_launches=runs["inject"], sd_launches=runs["sd"],
            train_launches=runs["train"], ae_launches=runs["ae_train"], sweep_launches=runs["sweep"],
            sweep_sd_launches=runs["sweep_sd"], inversion_launches=runs["inversion"],
            vae_time_mode_launches=runs["vae_time_mode"], tiny_launches=runs["tiny"],
            api_launches=runs["api"], img2vid_launches=runs["img2vid"], nti_launches=runs["nti"],
            t5_launches=runs["t5"], demo_launches=runs["demo"], safety_launches=runs["safety"],
            model_options_launches=runs["model_options"], fsdp_runs_launches=runs["fsdp_runs"],
            fsdp_launches=runs["fsdp"], ae_video_train_launches=runs["ae_video_train"],
            long_video_launches=runs["long_video"],
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
    main_ranks() if sys.argv[1:] == ["--ranks"] else main()
