"""SVD single-video VidSeg CLI on PyTorch/CUDA, flag-compatible with
scripts/sampling/svd_single_video_inference.py.

    python -m vidseg_diffusion_tpu_torch.scripts.svd_single_video_inference \
        --input_video_path path/to/frames --exp_name swan

Frames load through vidseg_diffusion_tpu_torch/io/video.py. The run is on
the card (--device cuda, bf16) and raises without one; --device cpu asks for
the CPU (fp32 by default). --is_injected_features caches the feature pass's
temporal self-attention q/k on the device and injects them into the
modulated runs. Flags whose paths are not ported yet (refinement,
match_gt_mask, inversion) raise NotImplementedError.
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
    import torch

    from vidseg_diffusion_tpu_torch.io.video import list_video_frames, load_frames
    from vidseg_diffusion_tpu_torch.engine.build import build_pipeline
    from vidseg_diffusion_tpu_torch.pipelines.single_video import VidSegArgs, run_single_video

    if not args.input_video_path:
        raise SystemExit("--input_video_path is required")
    device = torch.device(args.device)
    dtype = {"bfloat16": torch.bfloat16, "float32": torch.float32}.get(
        args.dtype, torch.bfloat16 if device.type == "cuda" else torch.float32
    )
    print("device:", device, "dtype:", dtype)
    frames, names, ori_hw = load_frames(list_video_frames(args.input_video_path))
    print(f"loaded {len(names)} frames, model size {frames.shape[1]}x{frames.shape[2]}")
    if args.ckpt_path and not os.path.exists(args.ckpt_path):
        raise FileNotFoundError(f"--ckpt_path {args.ckpt_path!r} does not exist")
    pipeline = build_pipeline(args.model_config, ckpt_path=args.ckpt_path, num_steps=args.num_steps,
                              num_frames=len(names), dtype=dtype, device=device, seed=args.seed)
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
        decoding_t=args.decoding_t,
    )
    result = run_single_video(pipeline, frames, names, vargs, ori_hw=ori_hw)
    print(f"unique_labels: {result.unique_labels}")
    print(f"wrote outputs under {args.feature_folder}/{args.exp_name}")


if __name__ == "__main__":
    main()
