"""The VidSeg pipeline on one video, on one device (PyTorch).

Counterpart of vidseg_diffusion_tpu/pipelines/single_video.py
(run_single_video, :269-646) for its default flags: conditioning, VAE
encode, add_noise (or, with inversion_type 'inversion', the DDIM inversion of
the latent over all num_steps, :372-387), the feature/x_t pass with the q
harvest (from step min(modulate_timestep), or from step 0 after an
inversion), KMeans
proto-masks, the 2*num_masks +/-lambda modulated runs with latent blending
(each run decoded by the temporal VAE as soon as it finishes), uint8_wrap
difference maps and the argmax; with is_injected_features the feature pass
also caches the temporal self-attention q/k of every attention-bearing output
block on the device and the modulated runs inject them (:315-322, :400-418,
device branch). Stage seconds use the JAX package's keys.

A pipeline built from an SD 2.1 YAML takes the image branch (:300, :363-369):
the conditioning is the OpenCLIP text embedding of `text_tokens` (the empty
prompt in the VidSeg pipelines) for c and uc alike, the clustering block is 7,
every frame is an image of the UNet batch, the image VAE decodes, and with
`sd_blend_window` latent blending stops one step after the first modulated
one; is_injected_features caches and injects the spatial self- and
cross-attention q/k.

Masks: kmeans_masks, or match_gt_mask (:468-473) seeded by `gt_mask` (the
first frame's GT at the clustering block's token resolution, or the clusters
themselves without one) in a first window and by the carried `gt_state` in
later ones; the result's gt_state is the state for the next window. With
is_refine_mask the feature pass also harvests output block 7's spatial q and
the masks are refined along its dense tracks (:475-498).

The parameters are the JAX function's, in its order (:269-284), with
`process_group` in the place of its `mesh`: `mask_override` ([K, T, fh*fw]
masks at the clustering block's token resolution, `cluster_feature_hw`)
replaces the clustering as in JAX (:458-463). Under a `process_group` of W
ranks (JAX's runs mesh, which run_single_video takes whenever it sees more
than one device) every rank runs the conditioning, encode and feature pass
itself (the injected q/k cache is not sent between ranks), takes the first
rank's masks and labels, runs and decodes its share of the 2*K modulated
runs (parallel/runs.py) and gathers the others'; every rank returns the same
result, and only the first rank writes outputs. Random sites draw from their
own torch.Generator seeded from args.seed; a caller (a parity test) can
instead hand over, by keyword, the cond-aug noise, the add_noise noise and the
kmeans initial centres JAX drew.

The in-process device mesh and the host-RAM streaming of the JAX package are
TPU workarounds and are not ported.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from vidseg_diffusion_tpu_torch.io import video as vio
from vidseg_diffusion_tpu_torch.engine.build import Pipeline
from vidseg_diffusion_tpu_torch.engine.masks import (
    GTMatchState,
    aggregate_blocks,
    correct_low_res_mask,
    kmeans_masks,
    match_gt_mask,
)
from vidseg_diffusion_tpu_torch.engine.modulation import ModulationConfig
from vidseg_diffusion_tpu_torch.engine.segmentation import (
    compute_difference,
    segmentation_argmax,
    soft_color_map,
)
from vidseg_diffusion_tpu_torch.engine.vidseg import (
    HarvestSpec,
    masks_to_latent,
    sd_harvest_spec,
    svd_harvest_spec,
)
from vidseg_diffusion_tpu_torch.ops.image import resize_bicubic
from vidseg_diffusion_tpu_torch.parallel.runs import all_gather_runs, broadcast_from_first


@dataclasses.dataclass
class VidSegArgs:
    """CLI-parity knobs (svd_single_video_inference.py:31-64, 600-625)."""

    exp_name: str = "default"
    num_steps: int = 25
    seed: int = 1
    fps_id: int = 14
    motion_bucket_id: int = 127
    cond_aug: float = 0.02
    decoding_t: int = 1
    modulate_block_idx: Tuple[int, ...] = (8,)
    modulate_timestep: Tuple[int, ...] = (17,)
    feature_timestep: Tuple[int, ...] = (24,)
    modulate_schedule: str = "constant"
    modulate_lambda_start: float = 50.0
    modulate_lambda_end: float = 50.0
    modulate_layer_type: Tuple[str, ...] = ("spatial",)
    modulate_attn_type: Tuple[str, ...] = ("cross_attn",)
    modulate_timestep_frames_schedule: str = "constant"
    num_masks: int = 10
    feature_extraction_mode: str = "kmeans_masks"
    gt_mask_path: Optional[str] = None
    is_injected_features: bool = False
    is_latent_blending: bool = True
    is_refine_mask: bool = False
    is_aggre_attn: bool = False
    feature_folder: str = "features_outputs"
    inversion_type: str = "add_noise"
    # t_start of the modulated runs; None = max(0, min(modulate_timestep) - 3),
    # the reference's hardcoded 14 at the default modulate_timestep 17
    modulate_t_start: Optional[int] = None
    # SD pipeline: latent blending ends at min(modulate_timestep) + 1
    # (sd_pipeline_vspw.py:490); SVD blends through the last step
    sd_blend_window: bool = False


@dataclasses.dataclass
class VidSegResult:
    seg_raw: np.ndarray            # [T, H, W] labels
    seg_filtered: np.ndarray       # [T, H, W] labels (filter_s 0.7)
    masks: np.ndarray              # [K, T, fh, fw]
    unique_labels: np.ndarray      # [K]
    cluster_features: np.ndarray   # [2T, fh*fw, C] harvested q
    diff_maps: np.ndarray          # [K, T, H, W]
    feature_x0: np.ndarray         # [T, h, w, z] end of the feature pass
    final_latents: np.ndarray      # [2, K, T, h, w, z] +lambda runs then -lambda
    cached_xt: np.ndarray          # [W, T, h, w, z] feature-pass trajectory from t0
    cache_t0: int
    masks_latent: np.ndarray       # [K, T, h, w] latent-blend masks
    injected_sites: int = 0        # (block, step) sites that took cached q/k, all runs
    injected_cache_bytes: int = 0  # device bytes of the cached q/k that are injected
    gt_state: Optional[GTMatchState] = None  # match_gt_mask: the state carried to the next window


def _check_supported(args: VidSegArgs) -> None:
    if args.feature_extraction_mode not in ("kmeans_masks", "match_gt_mask"):
        raise ValueError(args.feature_extraction_mode)
    if args.inversion_type not in ("add_noise", "inversion"):
        raise ValueError(f"Invalid inversion type {args.inversion_type}")


def _cluster_block_names(args: VidSegArgs, video: bool) -> Tuple[int, ...]:
    """Clustering blocks: 8 for SVD (svd_single_video_inference.py:361-364),
    7 for SD (sd_pipeline_vspw.py:639); with is_aggre_attn also the two
    blocks before it."""
    base = 8 if video else 7
    return (base, base - 1, base - 2) if args.is_aggre_attn else (base,)


def _resolve_blocks(unet_cfg, blocks: Sequence[int], mod_cfg: ModulationConfig):
    """Reference output-block indices -> this model's blocks: the identity on
    the full 12-block UNet, the last attention block of the matching
    resolution on reduced ones. Returns (indices, {index: latent divisor})."""
    _, _, out_layout = unet_cfg.block_layout()
    attn = {i: s["ds"] for i, s in enumerate(out_layout) if s.get("attn")}
    max_ds = max(attn.values())
    resolved, divisors, used = [], {}, set()
    for b in blocks:
        if len(out_layout) == 12 and b not in attn:
            raise ValueError(f"block {b} has no attention on the full 12-block UNet "
                             f"(attention blocks: {sorted(attn)})")
        if b in attn and len(out_layout) == 12:
            idx = b
        else:
            target = min(mod_cfg.block_resolution_divisor(b), max_ds)
            candidates = [i for i, d in attn.items() if d == target and i not in used]
            if not candidates:
                candidates = [i for i in attn if i not in used] or list(attn)
            idx = max(candidates)
        used.add(idx)
        resolved.append(idx)
        divisors[idx] = attn[idx]
    return tuple(resolved), divisors


def _cluster_site(unet_cfg, args: VidSegArgs, mod_cfg: ModulationConfig, h_lat: int,
                  w_lat: int) -> Tuple[Tuple[int, ...], int, int]:
    """The clustering blocks and their token resolution (fh, fw) at a latent
    resolution: one rule for run_single_video's step 3 and cluster_feature_hw."""
    blocks, div = _resolve_blocks(unet_cfg, _cluster_block_names(args, unet_cfg.video), mod_cfg)
    d = div[blocks[0]]
    return blocks, h_lat // d, w_lat // d


def cluster_feature_hw(pipeline: Pipeline, args: VidSegArgs, hpx: int, wpx: int,
                       num_frames: int) -> Tuple[int, int]:
    """Token resolution (fh, fw) of the clustering block at a pixel
    resolution: the resolution of `mask_override` and of GT masks
    (single_video.py:157-170)."""
    _, fh, fw = _cluster_site(pipeline.spec.unet_config, args, make_mod_config(args, num_frames),
                              hpx // 8, wpx // 8)
    return fh, fw


def make_harvest(args: VidSegArgs, video: bool, cluster_blocks: Sequence[int],
                 track_blocks: Sequence[int], injection_blocks: Sequence[int]) -> HarvestSpec:
    """The feature pass's harvest: the spatial q of the clustering blocks and
    of the refinement's tracking blocks (output block 7,
    svd_single_video_inference.py:393), plus with is_injected_features the
    q/k of `injection_blocks` (temporal self for the video UNet, spatial self
    and cross for the image UNet; single_video.py:194-217)."""
    spec = svd_harvest_spec if video else sd_harvest_spec
    cluster = tuple(cluster_blocks) + tuple(b for b in track_blocks if b not in cluster_blocks)
    return spec(cluster_blocks=cluster, injection=args.is_injected_features,
                injection_blocks=tuple(injection_blocks))


def make_mod_config(args: VidSegArgs, num_frames: int) -> ModulationConfig:
    return ModulationConfig(
        modulate_block_idx=tuple(args.modulate_block_idx),
        modulate_timestep=tuple(args.modulate_timestep),
        feature_timestep=tuple(args.feature_timestep),
        modulate_schedule=args.modulate_schedule,
        modulate_lambda_start=args.modulate_lambda_start,
        modulate_lambda_end=args.modulate_lambda_end,
        modulate_layer_type=tuple(args.modulate_layer_type),
        modulate_attn_type=tuple(args.modulate_attn_type),
        modulate_timestep_frames_schedule=args.modulate_timestep_frames_schedule,
        num_steps=args.num_steps,
        num_frames=num_frames,
        is_injected_features=args.is_injected_features,
        is_latent_blending=args.is_latent_blending,
        latent_mask_end=min(args.modulate_timestep) + 1 if args.sd_blend_window else None,
    )


def _generator(seed: int, site: int) -> torch.Generator:
    return torch.Generator().manual_seed(seed * 16 + site)


@torch.no_grad()
def run_single_video(
    pipeline: Pipeline,
    frames: np.ndarray,                  # [T, H, W, 3] in [-1, 1], H, W % 64 == 0
    frame_names: Sequence[str],
    args: VidSegArgs,
    ori_hw: Optional[Tuple[int, int]] = None,
    gt_mask: Optional[np.ndarray] = None,          # [fh*fw] first-frame GT ids (match_gt_mask)
    gt_state: Optional[GTMatchState] = None,       # carried from the previous window
    text_tokens: Optional[np.ndarray] = None,      # [1, 77] token ids, the SD 2.1 path
    write_outputs: bool = True,
    mask_override: Optional[np.ndarray] = None,    # [K, T, fh*fw] precomputed masks
    timings: Optional[Dict[str, float]] = None,    # out-param: per-stage seconds
    process_group=None,                            # the runs over its ranks (JAX's runs mesh)
    *,
    cond_aug_noise: Optional[np.ndarray] = None,   # [1, H, W, 3]
    noise: Optional[np.ndarray] = None,            # [T, H/8, W/8, z]
    kmeans_init: Optional[np.ndarray] = None,      # [n_init, K, C]
) -> VidSegResult:
    _check_supported(args)
    dev = pipeline.device
    clock = {"t": time.perf_counter()}

    def mark(stage):
        if timings is None:
            return
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        now = time.perf_counter()
        timings[stage] = now - clock["t"]
        clock["t"] = now

    t, hpx, wpx = frames.shape[:3]
    h_lat, w_lat = hpx // 8, wpx // 8
    unet_cfg = pipeline.spec.unet_config
    video = unet_cfg.video
    base_cfg = make_mod_config(args, t)
    cluster_blocks, fh, fw = _cluster_site(unet_cfg, args, base_cfg, h_lat, w_lat)
    mod_blocks, mod_div = _resolve_blocks(unet_cfg, tuple(args.modulate_block_idx), base_cfg)
    track_blocks, track_div = (_resolve_blocks(unet_cfg, (7,), base_cfg) if args.is_refine_mask
                               else ((), {}))
    _, _, out_layout = unet_cfg.block_layout()
    attn_blocks = tuple(i for i, s in enumerate(out_layout) if s.get("attn"))
    mod_cfg = dataclasses.replace(base_cfg, modulate_block_idx=mod_blocks,
                                  output_block_indices=attn_blocks)
    engine = pipeline.make_engine(mod_cfg, make_harvest(args, video, cluster_blocks, track_blocks, attn_blocks))
    fs = pipeline.first_stage

    # ---- conditioning (svd_single_video_inference.py:282-312) -------------
    frames_t = torch.from_numpy(np.ascontiguousarray(frames, dtype=np.float32)).to(dev)
    if video:
        image = frames_t[:1]
        if cond_aug_noise is None:
            aug = torch.randn(image.shape, generator=_generator(args.seed, 1))
        else:
            aug = torch.tensor(np.asarray(cond_aug_noise, dtype=np.float32))
        c, uc = pipeline.condition_video(
            image, aug, float(args.fps_id), float(args.motion_bucket_id), args.cond_aug, t
        )
    else:
        if text_tokens is None:
            raise ValueError("the SD path needs tokenized text (io/tokenizer.py: tokenize_empty)")
        ctx = torch.repeat_interleave(pipeline.clip_apply(np.asarray(text_tokens)), t, dim=0)
        c, uc = {"crossattn": ctx}, {"crossattn": ctx}
    mark("conditioning")

    # ---- steps 1+2: add_noise or inversion + feature/x_t pass ---------------
    # t_start: min(modulate_timestep) for add_noise, 0 for inversion (JAX :372-375)
    t_start_feat = min(args.modulate_timestep) if args.inversion_type == "add_noise" else 0
    latent = fs.encode(frames_t, chunk=args.decoding_t)
    mark("encode")
    if args.inversion_type == "add_noise":
        eps = None if noise is None else torch.tensor(np.asarray(noise))
        noised = engine.sampler.add_noise(latent, t_start_feat, noise=eps,
                                          generator=_generator(args.seed, 2))
    else:
        # the full inversion over the flipped schedule (JAX :380-383); its
        # seconds count in "feature_pass", as in JAX
        noised = engine.invert(c, uc, latent)
    x0, cache = engine.xt_cache_pass(c, uc, noised, t_start_feat)
    mark("feature_pass")

    # ---- step 3: masks ------------------------------------------------------
    cache_t0 = int(cache["t0"])
    if len(args.feature_timestep) != 1:
        raise ValueError(f"feature_timestep takes exactly one step, got {args.feature_timestep}")
    feat_t = args.feature_timestep[0]
    if feat_t >= args.num_steps:
        raise ValueError(f"feature_timestep {feat_t} out of range for num_steps {args.num_steps}")
    if feat_t < cache_t0:
        raise ValueError(
            f"feature_timestep {feat_t} precedes the cache window start {cache_t0} "
            "(= min(modulate_timestep) for add_noise inversion): the feature pass only runs "
            "steps >= t_start, so features at earlier steps were never produced. Use "
            "feature_timestep >= min(modulate_timestep) or inversion_type='inversion'."
        )
    feats = [cache[HarvestSpec.name(b, "spatial_self", "q")][feat_t - cache_t0] for b in cluster_blocks]
    feat = aggregate_blocks(feats) if len(feats) > 1 else feats[0]
    init = None if kmeans_init is None else torch.tensor(np.asarray(kmeans_init, dtype=np.float32))
    new_gt_state = None
    if mask_override is not None:
        # externally supplied masks replace the clustering (JAX :458-463)
        masks_tok = torch.as_tensor(np.asarray(mask_override), dtype=torch.float32,
                                    device=feat.device).reshape(-1, t, fh * fw)
        unique_labels = np.arange(masks_tok.shape[0])
    elif args.feature_extraction_mode == "kmeans_masks":
        masks_tok, unique_labels = kmeans_masks(
            feat, args.num_masks, t, generator=_generator(args.seed, 3), init_centers=init
        )
    else:
        masks_tok, new_gt_state = match_gt_mask(
            feat, args.num_masks, t, gt_mask=gt_mask, state=gt_state,
            generator=_generator(args.seed, 3), init_centers=init,
        )
        unique_labels = new_gt_state.unique_labels
    if args.is_refine_mask:
        masks_tok = _refine(cache[HarvestSpec.name(track_blocks[0], "spatial_self", "q")][feat_t - cache_t0],
                            masks_tok, t, (h_lat, w_lat), (fh, fw), track_div[track_blocks[0]])
    if process_group is not None:
        # one clustering for every rank: the first rank's
        masks_cpu, unique_labels, new_gt_state = broadcast_from_first(
            (masks_tok.cpu(), np.asarray(unique_labels), _state_to(new_gt_state, "cpu")), process_group)
        masks_tok, new_gt_state = masks_cpu.to(feat.device), _state_to(new_gt_state, feat.device)
    k = masks_tok.shape[0]
    masks_px = masks_tok.reshape(k, t, fh, fw)
    mark("masks")

    # ---- step 4: modulated runs, each decoded as soon as it finishes --------
    mdiv = mod_div[mod_blocks[0]]
    mh, mw = h_lat // mdiv, w_lat // mdiv
    masks_block = resize_bicubic(masks_px, (mh, mw)).clamp(0.0, 1.0).reshape(k, t, mh * mw)
    masks_latent = masks_to_latent(masks_px, (h_lat, w_lat))
    t_start_mod = (args.modulate_t_start if args.modulate_t_start is not None
                   else max(0, min(args.modulate_timestep) - 3))
    decoded_runs: Dict[int, torch.Tensor] = {}

    def on_run_done(r, x_final):
        decoded_runs[r] = fs.decode(x_final, chunk=args.decoding_t)

    finals = engine.modulated_runs(noised, c, uc, masks_block, masks_latent, cache,
                                   t_start_mod, on_run_done=on_run_done, process_group=process_group)
    mark("modulated_runs")
    if process_group is None:
        decoded = torch.stack([decoded_runs[r] for r in range(2 * k)])
    else:
        decoded = all_gather_runs(decoded_runs, k, process_group)
    decoded = decoded.reshape((2, k) + decoded.shape[1:])
    decoded = ((decoded + 1.0) / 2.0).clamp(0.0, 1.0) * 255.0
    mark("decode")

    # ---- step 5: difference maps + segmentation -----------------------------
    diff = compute_difference(decoded[0], decoded[1])
    labels_t = torch.from_numpy(np.asarray(unique_labels))
    seg_raw = segmentation_argmax(diff, labels=labels_t).cpu().numpy()
    seg_filtered = segmentation_argmax(diff, masks=masks_px, filter_s=0.7, labels=labels_t).cpu().numpy()
    mark("seg_assembly")

    masks_np = masks_px.cpu().numpy()
    if write_outputs and (process_group is None or dist.get_rank(process_group) == 0):
        _write_outputs(args, masks_np, decoded, seg_raw, seg_filtered, cluster_blocks,
                       frame_names, feat_t, unique_labels, ori_hw)
    f32 = lambda a: a.float().cpu().numpy()
    injected = ("_temporal_self_",) if video else ("_spatial_self_", "_spatial_cross_")
    return VidSegResult(
        seg_raw=seg_raw, seg_filtered=seg_filtered, masks=masks_np,
        unique_labels=np.asarray(unique_labels), cluster_features=f32(feat),
        diff_maps=f32(diff), feature_x0=f32(x0), final_latents=f32(finals),
        cached_xt=f32(cache["xt"]), cache_t0=cache_t0, masks_latent=f32(masks_latent),
        injected_sites=engine.injected_sites,
        injected_cache_bytes=sum(v.numel() * v.element_size() for n, v in cache.items()
                                 if args.is_injected_features and any(s in n for s in injected)),
        gt_state=new_gt_state,
    )


def _state_to(state: Optional[GTMatchState], device) -> Optional[GTMatchState]:
    if state is None:
        return None
    return dataclasses.replace(state, ref_features=state.ref_features.to(device),
                               ref_labels=state.ref_labels.to(device))


def _refine(track_feat, masks_tok, t, latent_hw, feature_hw, tdiv):
    """--is_refine_mask (JAX :477-498): correct_low_res_mask on the tracking
    block's features; masks cross to its token resolution and back by a
    bicubic resize thresholded at 0.5 where the two resolutions differ."""
    (h_lat, w_lat), (fh, fw) = latent_hw, feature_hw
    th, tw = h_lat // tdiv, w_lat // tdiv
    k = masks_tok.shape[0]
    if (th, tw) == (fh, fw):
        return correct_low_res_mask(track_feat, masks_tok, t, width=tw)
    tm = resize_bicubic(masks_tok.reshape(k, t, fh, fw), (th, tw))
    refined = correct_low_res_mask(track_feat, (tm > 0.5).float().reshape(k, t, th * tw), t, width=tw)
    rm = resize_bicubic(refined.reshape(k, t, th, tw), (fh, fw))
    return (rm > 0.5).float().reshape(k, t, fh * fw)


def _write_outputs(args, masks_px, decoded, seg_raw, seg_filtered, cluster_blocks,
                   frame_names, feat_t, unique_labels, ori_hw):
    """The reference's output tree: mask PNGs, modulated frames, label maps."""
    from vidseg_diffusion_tpu_torch.io.native import ParallelFrameWriter

    base = os.path.join(args.feature_folder, args.exp_name)
    block_str = "_".join(f"output_block_{b}" for b in cluster_blocks)
    mask_dir = os.path.join(base, args.feature_extraction_mode,
                            f"{block_str}_spatial_self_attn_q_masks_{args.num_masks}")
    vio.save_binary_masks(masks_px, mask_dir, frame_names, feat_t, unique_labels)
    mod_dir = os.path.join(base, "modulated_output")
    writer = ParallelFrameWriter(workers=4)
    try:
        for sign_idx, lam in ((0, args.modulate_lambda_start), (1, -args.modulate_lambda_start)):
            for ki, lab in enumerate(unique_labels):
                vio.save_frames_png(
                    decoded[sign_idx, ki].float().cpu().numpy() / 255.0,
                    os.path.join(mod_dir, f"{0:06d}_l_{lam}_mask_{int(lab)}"),
                    frame_names, ori_hw, writer=writer,
                )
    finally:
        writer.close()
    cm = soft_color_map()
    for name, seg in (("segmentation_map_raw", seg_raw), ("segmentation_map_raw_f_0.7", seg_filtered)):
        vio.save_label_maps(
            seg, os.path.join(base, name, f"{0:06d}_l_{args.modulate_lambda_start}"), frame_names,
            color_map=cm,
            color_folder=os.path.join(base, name.replace("_raw", ""), f"{0:06d}_l_{args.modulate_lambda_start}"),
        )
