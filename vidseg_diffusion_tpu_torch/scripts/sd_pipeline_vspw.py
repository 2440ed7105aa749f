"""SD 2.1 VSPW sweep CLI on PyTorch/CUDA, flag-compatible with
scripts/sampling/sd_pipeline_vspw.py.

    python -m vidseg_diffusion_tpu_torch.scripts.sd_pipeline_vspw \
        --data_root path/to/VSPW/data --val_list val.txt --manifest sweep_sd.jsonl

The SVD sweep's loop (svd_pipeline_vspw.py) on the image UNet: the empty
prompt's text conditioning (sd_pipeline_vspw.py:277-307), clustering block 7
(:639), modulation at step 22 (:640) and latent blending that ends one step
after it (:490). Runs on the card by default; --device cpu asks for the CPU.
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from vidseg_diffusion_tpu_torch.scripts import svd_pipeline_vspw as svd_cli  # noqa: E402


def build_parser():
    return svd_cli.build_parser(exp_name="vspw_sd", block="7", step="22",
                                config="configs/inference/sd_2_1.yaml", video=False)


def parse_args(argv=None):
    return build_parser().parse_args(argv)


def vidseg_args(args):
    return svd_cli.vidseg_args(args, sd_blend_window=True)


def sweep(args, pipeline):
    from vidseg_diffusion_tpu_torch.io.tokenizer import tokenize_empty

    return svd_cli.sweep(args, pipeline, text_tokens=tokenize_empty(1), vargs=vidseg_args(args))


def main(argv=None):
    args = parse_args(argv)
    out = sweep(args, svd_cli.build(args))
    print(json.dumps(out, default=str))
    return out


if __name__ == "__main__":
    main()
