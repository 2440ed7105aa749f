"""Sampling demo CLI (PyTorch): txt2img / img2img to a PNG, img2vid to PNG
frames.

Counterpart of the repository's scripts/demo/sampling.py (a terminal front
end over the sampling API, for the reference's Streamlit demos
scripts/demo/{sampling,video_sampling}.py). It prints the device it runs on
and, without a card, fails unless given --device cpu. The prompt is the
empty one (any other needs the CLIP BPE vocabulary, which is not in the
repository); without a checkpoint the weights are random (a structure demo).

    python -m vidseg_diffusion_tpu_torch.scripts.demo.sampling --mode txt2img \\
        --config configs/inference/sd_2_1.yaml [--ckpt checkpoints/sd21.safetensors] --steps 40 --out out.png
    python -m vidseg_diffusion_tpu_torch.scripts.demo.sampling --mode img2img --image in.png --strength 0.6 ...
    python -m vidseg_diffusion_tpu_torch.scripts.demo.sampling --mode img2vid --image in.png \\
        --config configs/inference/svd.yaml --width 1024 --height 576 --out frames.png
"""

import argparse
import os

import torch

from vidseg_diffusion_tpu_torch.scripts.demo.serve import load_init, to_uint8


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--mode", choices=["txt2img", "img2img", "img2vid"], default="txt2img")
    p.add_argument("--config", default="configs/inference/sd_2_1.yaml")
    p.add_argument("--ckpt", default=None)
    p.add_argument("--image", default=None)
    p.add_argument("--strength", type=float, default=0.75)
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--height", type=int, default=512)
    p.add_argument("--steps", type=int, default=40)
    p.add_argument("--scale", type=float, default=5.0)
    p.add_argument("--sampler", default="EulerEDMSampler")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default="demo_out.png")
    # img2vid (the reference's video_sampling.py VERSION2SPECS defaults)
    p.add_argument("--num_frames", type=int, default=14)
    p.add_argument("--fps_id", type=int, default=6)
    p.add_argument("--motion_bucket_id", type=int, default=127)
    p.add_argument("--cond_aug", type=float, default=0.02)
    p.add_argument("--min_cfg", type=float, default=1.0)
    p.add_argument("--max_cfg", type=float, default=2.5)
    p.add_argument("--decoding_t", type=int, default=1)
    p.add_argument("--device", default="cuda")
    p.add_argument("--dtype", choices=("bfloat16", "float32"), default=None)
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from PIL import Image

    from vidseg_diffusion_tpu_torch.engine.build import build_pipeline
    from vidseg_diffusion_tpu_torch.inference.api import (
        Sampler,
        SamplingParams,
        SamplingPipeline,
        VideoSamplingParams,
    )
    from vidseg_diffusion_tpu_torch.io.tokenizer import tokenize_empty

    device = torch.device(args.device)
    dtype = {"bfloat16": torch.bfloat16, "float32": torch.float32}.get(
        args.dtype, torch.bfloat16 if device.type == "cuda" else torch.float32)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"device: {device} ({name}), dtype: {dtype}", flush=True)
    if args.mode == "img2vid" and args.config == "configs/inference/sd_2_1.yaml":
        args.config = "configs/inference/svd.yaml"   # the video default
    ckpt = args.ckpt if (args.ckpt and os.path.exists(args.ckpt)) else None
    if ckpt is None:
        print("WARNING: no checkpoint - random weights (structure demo only)")
    gen = torch.Generator(device=device).manual_seed(args.seed)
    if args.mode == "img2vid":
        steps = args.steps if args.steps != 40 else 25   # SVD's default
        api = SamplingPipeline(build_pipeline(args.config, ckpt_path=ckpt, num_steps=steps,
                                              num_frames=args.num_frames, dtype=dtype, device=device))
        vparams = VideoSamplingParams(
            width=args.width, height=args.height, steps=steps, num_frames=args.num_frames, fps_id=args.fps_id,
            motion_bucket_id=args.motion_bucket_id, cond_aug=args.cond_aug, min_cfg=args.min_cfg,
            max_cfg=args.max_cfg, decoding_t=args.decoding_t)
        frames = to_uint8(api.image_to_video(vparams, load_init(args.image, args.width, args.height), generator=gen))
        base, ext = os.path.splitext(args.out)
        for i, f in enumerate(frames):
            Image.fromarray(f).save(f"{base}_{i:05d}{ext or '.png'}")
        print(f"wrote {len(frames)} frames to {base}_*{ext or '.png'}")
        return

    api = SamplingPipeline(build_pipeline(args.config, ckpt_path=ckpt, num_steps=args.steps, dtype=dtype,
                                          device=device))
    params = SamplingParams(width=args.width, height=args.height, steps=args.steps, scale=args.scale,
                            sampler=Sampler(args.sampler), img2img_strength=args.strength)
    tokens = tokenize_empty(1)
    if args.mode == "txt2img":
        out = api.text_to_image(params, tokens, generator=gen)
    else:
        out = api.image_to_image(params, load_init(args.image, args.width, args.height), tokens, generator=gen)
    Image.fromarray(to_uint8(out[0])).save(args.out)
    print("wrote", args.out)


if __name__ == "__main__":
    main()
