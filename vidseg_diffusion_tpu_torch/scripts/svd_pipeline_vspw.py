"""SVD VSPW sweep CLI on PyTorch/CUDA, flag-compatible with
scripts/sampling/svd_pipeline_vspw.py.

    python -m vidseg_diffusion_tpu_torch.scripts.svd_pipeline_vspw \
        --data_root path/to/VSPW/data --val_list val.txt --manifest sweep.jsonl

Each video of <data_root>/<video>/origin runs in 14-frame sliding windows,
labels seeded from the first frame's GT in <video>/mask (match_gt_mask with 20
k-means clusters) and carried across windows; a failed video is journaled and
skipped; mIoU and mVC_8 / mVC_16 are printed with the sweep's counts as one
JSON line. The sweep runs on the card (--device cuda, bf16) and raises
without one; --device cpu asks for the CPU (fp32 by default). The JAX CLI's
--runs_chunk and --data_groups (TPU dispatch and its device mesh) are not
taken.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))


def build_parser(exp_name="vspw", block="8", step="17", config="configs/inference/svd.yaml", video=True):
    """The sweep flags, with the SVD (or, given other defaults, the SD 2.1)
    CLI's defaults; `video` adds the video conditioning's two flags."""
    p = argparse.ArgumentParser()
    p.add_argument("--data_root", type=str, required=True,
                   help="VSPW root containing <video>/origin and <video>/mask")
    p.add_argument("--val_list", type=str, default=None,
                   help="file listing val video names (default: all dirs)")
    p.add_argument("--exp_name", type=str, default=exp_name)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--num_frames", type=int, default=14)
    p.add_argument("--num_steps", type=int, default=25)
    if video:
        p.add_argument("--motion_bucket_id", type=int, default=127)
        p.add_argument("--cond_aug", type=float, default=0.02)
    p.add_argument("--modulate_block_idx", type=str, default=block)
    p.add_argument("--modulate_timestep", type=str, default=step)
    p.add_argument("--feature_timestep", type=str, default="24")
    p.add_argument("--modulate_schedule", type=str, default="constant")
    p.add_argument("--modulate_lambda_start", type=float, default=50.0)
    p.add_argument("--modulate_lambda_end", type=float, default=50.0)
    p.add_argument("--num_masks", type=int, default=20)
    p.add_argument("--feature_extraction_mode", type=str, default="match_gt_mask")
    p.add_argument("--is_injected_features", default=False, action="store_true")
    p.add_argument("--modulate_layer_type", type=str, default="spatial")
    p.add_argument("--modulate_attn_type", type=str, default="cross_attn")
    p.add_argument("--disable_latent_blending", default=False, action="store_true")
    p.add_argument("--is_refine_mask", default=False, action="store_true")
    p.add_argument("--is_aggre_attn", default=False, action="store_true")
    p.add_argument("--exp_start_idx", type=int, default=0)
    p.add_argument("--num_exp", type=int, default=None)
    p.add_argument("--model_config", type=str, default=config)
    p.add_argument("--ckpt_path", type=str, default=None)
    p.add_argument("--feature_folder", type=str, default="features_outputs")
    p.add_argument("--dtype", type=str, default=None, choices=["bfloat16", "float32"],
                   help="compute dtype (default: bfloat16 on cuda, float32 on the CPU)")
    p.add_argument("--num_classes", type=int, default=124)
    p.add_argument("--no_eval", default=False, action="store_true")
    p.add_argument("--manifest", type=str, default=None,
                   help="JSON-lines resume journal; completed videos are skipped on re-run")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; the default needs a CUDA card, 'cpu' runs the plain versions")
    return p


def parse_args(argv=None):
    return build_parser().parse_args(argv)


def video_names(args):
    """The --val_list names, or every directory under --data_root, sorted."""
    if args.val_list:
        with open(args.val_list) as f:
            return [line.strip() for line in f if line.strip()]
    return sorted(d for d in os.listdir(args.data_root) if os.path.isdir(os.path.join(args.data_root, d)))


def vidseg_args(args, **extra):
    from vidseg_diffusion_tpu_torch.pipelines.single_video import VidSegArgs

    csv_i = lambda s: tuple(int(x) for x in s.split(",") if x)
    csv_s = lambda s: tuple(x for x in s.split(",") if x)
    video = {k: getattr(args, k) for k in ("motion_bucket_id", "cond_aug") if hasattr(args, k)}
    return VidSegArgs(
        exp_name=args.exp_name, num_steps=args.num_steps, seed=args.seed, **video,
        modulate_block_idx=csv_i(args.modulate_block_idx), modulate_timestep=csv_i(args.modulate_timestep),
        feature_timestep=csv_i(args.feature_timestep), modulate_schedule=args.modulate_schedule,
        modulate_lambda_start=args.modulate_lambda_start, modulate_lambda_end=args.modulate_lambda_end,
        modulate_layer_type=csv_s(args.modulate_layer_type), modulate_attn_type=csv_s(args.modulate_attn_type),
        num_masks=args.num_masks, feature_extraction_mode=args.feature_extraction_mode,
        is_injected_features=args.is_injected_features, is_latent_blending=not args.disable_latent_blending,
        is_refine_mask=args.is_refine_mask, is_aggre_attn=args.is_aggre_attn,
        feature_folder=args.feature_folder, **extra,
    )


def build(args):
    """The pipeline of --model_config on --device (engine/build.py:
    build_pipeline_from_args, shared with the single-video CLI)."""
    from vidseg_diffusion_tpu_torch.engine.build import build_pipeline_from_args

    return build_pipeline_from_args(args, args.num_frames)


def sweep(args, pipeline, text_tokens=None, vargs=None):
    """run_vspw_sweep over the CLI's videos with its flags."""
    from vidseg_diffusion_tpu_torch.pipelines.vspw import run_vspw_sweep

    return run_vspw_sweep(
        pipeline, args.data_root, video_names(args), vargs or vidseg_args(args),
        num_frames=args.num_frames, exp_start_idx=args.exp_start_idx, num_exp=args.num_exp,
        text_tokens=text_tokens, num_classes=args.num_classes, evaluate=not args.no_eval,
        manifest_path=args.manifest,
    )


def main(argv=None):
    args = parse_args(argv)
    out = sweep(args, build(args))
    print(json.dumps(out, default=str))
    return out


if __name__ == "__main__":
    main()
