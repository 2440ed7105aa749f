"""SVD single-video VidSeg CLI on PyTorch/CUDA, flag-compatible with
scripts/sampling/svd_single_video_inference.py.

    python -m vidseg_diffusion_tpu_torch.scripts.svd_single_video_inference \
        --input_video_path path/to/frames --exp_name swan

Frames load through vidseg_diffusion_tpu_torch/io/video.py. The run is on
the card (--device cuda, bf16) and raises without one; --device cpu asks for
the CPU (fp32 by default). --is_injected_features caches the feature pass's
temporal self-attention q/k on the device and injects them into the
modulated runs. --feature_extraction_mode match_gt_mask needs --gt_mask_path,
the first frame's GT label image, which loads nearest-resized to the
clustering block's token grid. --inversion_type inversion replaces add_noise
by the DDIM inversion of the latents over all --num_steps (the feature pass
then runs every step); the JAX package's CLI has no such flag and keeps
add_noise, which stays the default here.

Under torchrun (WORLD_SIZE above 1) the process group is joined
(parallel/mesh.py::initialize_distributed: NCCL, one card per rank; gloo with
--device cpu) and the 2 * num_masks modulated runs split over the ranks,
where the JAX package's CLI shards them over its devices (mesh "auto"); the
first rank writes the outputs:

    torchrun --nproc_per_node 4 -m vidseg_diffusion_tpu_torch.scripts.svd_single_video_inference \
        --input_video_path path/to/frames --exp_name swan
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--input_video_path", type=str, default=None,
                   help="path to the input video which needs to be inverted")
    p.add_argument("--exp_name", type=str, default="default")
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--motion_bucket_id", type=int, default=127)
    p.add_argument("--cond_aug", type=float, default=0.02)
    p.add_argument("--modulate_block_idx", type=str, default="8")
    p.add_argument("--modulate_timestep", type=str, default="17")
    p.add_argument("--feature_timestep", type=str, default="24")
    p.add_argument("--modulate_schedule", type=str, default="constant")
    p.add_argument("--modulate_lambda_start", type=float, default=50.0)
    p.add_argument("--modulate_lambda_end", type=float, default=50.0)
    p.add_argument("--num_masks", type=int, default=10)
    p.add_argument("--feature_extraction_mode", type=str, default="kmeans_masks")
    p.add_argument("--gt_mask_path", type=str, default=None)
    p.add_argument("--is_injected_features", default=False, action="store_true")
    p.add_argument("--modulate_layer_type", type=str, default="spatial")
    p.add_argument("--modulate_attn_type", type=str, default="cross_attn")
    p.add_argument("--modulate_timestep_frames_schedule", type=str, default="constant")
    p.add_argument("--disable_latent_blending", default=False, action="store_true")
    p.add_argument("--is_refine_mask", default=False, action="store_true")
    p.add_argument("--is_aggre_attn", default=False, action="store_true")
    p.add_argument("--inversion_type", type=str, default="add_noise", choices=["add_noise", "inversion"],
                   help="noise the latents at min(modulate_timestep), or invert them over every step")
    p.add_argument("--model_config", type=str, default="configs/inference/svd.yaml")
    p.add_argument("--ckpt_path", type=str, default=None,
                   help="override the YAML ckpt_path; omit + missing file -> random weights")
    p.add_argument("--num_steps", type=int, default=25)
    p.add_argument("--feature_folder", type=str, default="features_outputs")
    p.add_argument("--decoding_t", type=int, default=1,
                   help="frames decoded per VAE-decoder call")
    p.add_argument("--dtype", type=str, default=None, choices=["bfloat16", "float32"],
                   help="compute dtype (default: bfloat16 on cuda, float32 on the CPU)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; the default needs a CUDA card, 'cpu' runs the plain versions")
    return p.parse_args(argv)


def _csv_ints(s):
    return tuple(int(x) for x in s.split(",") if x)


def _csv_strs(s):
    return tuple(x for x in s.split(",") if x)


def main(argv=None):
    args = parse_args(argv)
    from vidseg_diffusion_tpu_torch.engine.build import build_pipeline_from_args
    from vidseg_diffusion_tpu_torch.io.video import list_video_frames, load_frames
    from vidseg_diffusion_tpu_torch.pipelines.single_video import VidSegArgs, cluster_feature_hw, run_single_video
    from vidseg_diffusion_tpu_torch.pipelines.vspw import load_label_image

    if not args.input_video_path:
        raise SystemExit("--input_video_path is required")
    if args.feature_extraction_mode == "match_gt_mask" and not args.gt_mask_path:
        raise SystemExit("--gt_mask_path is required for --feature_extraction_mode match_gt_mask")
    group = None
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        from vidseg_diffusion_tpu_torch.parallel.mesh import initialize_distributed

        group = initialize_distributed(device=args.device)
    frames, names, ori_hw = load_frames(list_video_frames(args.input_video_path))
    print(f"loaded {len(names)} frames, model size {frames.shape[1]}x{frames.shape[2]}")
    pipeline = build_pipeline_from_args(args, len(names))
    vargs = VidSegArgs(
        exp_name=args.exp_name, num_steps=args.num_steps, seed=args.seed,
        motion_bucket_id=args.motion_bucket_id, cond_aug=args.cond_aug,
        modulate_block_idx=_csv_ints(args.modulate_block_idx),
        modulate_timestep=_csv_ints(args.modulate_timestep),
        feature_timestep=_csv_ints(args.feature_timestep),
        modulate_schedule=args.modulate_schedule,
        modulate_lambda_start=args.modulate_lambda_start,
        modulate_lambda_end=args.modulate_lambda_end,
        modulate_layer_type=_csv_strs(args.modulate_layer_type),
        modulate_attn_type=_csv_strs(args.modulate_attn_type),
        modulate_timestep_frames_schedule=args.modulate_timestep_frames_schedule,
        num_masks=args.num_masks, feature_extraction_mode=args.feature_extraction_mode,
        gt_mask_path=args.gt_mask_path, is_injected_features=args.is_injected_features,
        is_latent_blending=not args.disable_latent_blending, is_refine_mask=args.is_refine_mask,
        is_aggre_attn=args.is_aggre_attn, feature_folder=args.feature_folder,
        decoding_t=args.decoding_t, inversion_type=args.inversion_type,
    )
    gt_mask = None
    if args.feature_extraction_mode == "match_gt_mask":
        gt_mask = load_label_image(args.gt_mask_path,
                                   *cluster_feature_hw(pipeline, vargs, frames.shape[1], frames.shape[2], len(names)))
    result = run_single_video(pipeline, frames, names, vargs, ori_hw=ori_hw, gt_mask=gt_mask,
                              process_group=group)
    if group is None or group.rank() == 0:
        print(f"unique_labels: {result.unique_labels}")
        print(f"wrote outputs under {args.feature_folder}/{args.exp_name}")


if __name__ == "__main__":
    main()
