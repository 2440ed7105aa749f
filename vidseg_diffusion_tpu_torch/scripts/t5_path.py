"""The T5-conditioned text_to_image run that chip_smoke.py checks, defined
once; also a command line for one image.

No shipped config uses T5. The reference's FrozenT5Embedder defaults to
google/t5-v1_1-xxl (sgm/modules/encoders/modules.py:249-283), so the run
conditions configs/inference/sd_2_1.yaml's image UNet (its context_dim set
to 4096) with a T5 v1.1-XXL encoder at full width: vocabulary 32128,
d_model 4096, 64 heads x 64, d_ff 10240, 24 layers, gated-GELU, 32 buckets,
max distance 128 (4.76 B parameters, 9.5 GB in bf16). The YAML is written to
a directory the caller names, from sd_2_1.yaml with the conditioner swapped;
no repository config is added. Weights are random bf16 from a seed; the
prompt is 77 ids drawn from a seeded generator (T5's SentencePiece
vocabulary is not in the repository; models/t5.t5_tokenize needs a
spiece.model). text_to_image at 512x512, 25 Euler steps, CFG 5.

    python -m vidseg_diffusion_tpu_torch.scripts.t5_path [--device cpu --tiny]
"""

import argparse
import os
import tempfile
import time

import numpy as np
import torch
import yaml

from vidseg_diffusion_tpu_torch.engine.build import build_pipeline
from vidseg_diffusion_tpu_torch.inference.api import SamplingParams, SamplingPipeline
from vidseg_diffusion_tpu_torch.scripts.main_path import ROOT

T5_XXL = dict(vocab_size=32128, d_model=4096, d_kv=64, num_heads=64, d_ff=10240, num_layers=24,
              relative_attention_num_buckets=32, relative_attention_max_distance=128,
              feed_forward_proj="gated-gelu")
# a CPU-sized tower of the same kind (the command line's --tiny)
T5_TINY = dict(T5_XXL, d_model=64, d_kv=16, num_heads=4, d_ff=128, num_layers=2)
SIZE, STEPS, SCALE, TOKENS = 512, 25, 5.0, 77


def write_config(directory: str, t5_cfg=None) -> str:
    """sd_2_1.yaml with its conditioner replaced by one FrozenT5Embedder
    (t5_cfg, default T5_XXL) and the UNet's context_dim set to its d_model;
    returns the written YAML's path."""
    t5_cfg = dict(T5_XXL if t5_cfg is None else t5_cfg)
    with open(os.path.join(ROOT, "configs/inference/sd_2_1.yaml")) as f:
        cfg = yaml.safe_load(f)
    params = cfg["model"]["params"]
    params["network_config"]["params"]["context_dim"] = t5_cfg["d_model"]
    params["conditioner_config"]["params"]["emb_models"] = [dict(
        is_trainable=False, input_key="txt", target="sgm.modules.encoders.modules.FrozenT5Embedder",
        params=dict(version="google/t5-v1_1-xxl", max_length=TOKENS, t5_cfg=t5_cfg))]
    path = os.path.join(directory, "sd_2_1_t5_xxl.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


def write_class_config(directory: str) -> str:
    """A tiny class-conditioned config: sd_tiny.yaml with its conditioner
    replaced by a ClassEmbedder (7 classes, embed_dim the UNet's context_dim,
    add_sequence_dim: labels [b] -> crossattn [b, 1, context_dim])."""
    with open(os.path.join(ROOT, "configs/inference/sd_tiny.yaml")) as f:
        cfg = yaml.safe_load(f)
    params = cfg["model"]["params"]
    params["conditioner_config"]["params"]["emb_models"] = [dict(
        is_trainable=False, input_key="cls", target="sgm.modules.encoders.modules.ClassEmbedder",
        params=dict(embed_dim=params["network_config"]["params"]["context_dim"], n_classes=7,
                    add_sequence_dim=True))]
    path = os.path.join(directory, "sd_tiny_class.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


def build(directory: str, device="cuda", dtype=torch.bfloat16, seed: int = 0, t5_cfg=None) -> SamplingPipeline:
    return SamplingPipeline(build_pipeline(write_config(directory, t5_cfg), dtype=dtype, device=device, seed=seed))


def tokens(seed: int = 14) -> np.ndarray:
    """[1, 77] ids in [2, 32128) (T5-XXL's vocabulary) from a seeded
    generator (0 and 1 are T5's pad and EOS)."""
    return torch.randint(2, T5_XXL["vocab_size"], (1, TOKENS), generator=torch.Generator().manual_seed(seed)).numpy()


def params(size: int = SIZE, steps: int = STEPS) -> SamplingParams:
    return SamplingParams(width=size, height=size, steps=steps, scale=SCALE)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--tiny", action="store_true", help="a 2-layer T5 of width 64 in place of T5-XXL")
    ap.add_argument("--size", type=int, default=SIZE)
    ap.add_argument("--steps", type=int, default=STEPS)
    args = ap.parse_args()
    dtype = torch.bfloat16 if args.device == "cuda" else torch.float32
    with tempfile.TemporaryDirectory() as tmp:
        api = build(tmp, args.device, dtype, t5_cfg=T5_TINY if args.tiny else None)
    t0 = time.perf_counter()
    out = api.text_to_image(params(args.size, args.steps), tokens(),
                            generator=torch.Generator(device=args.device).manual_seed(0))
    if args.device == "cuda":
        torch.cuda.synchronize()
    print(f"image {tuple(out.shape)} in [{out.min().item():.3f}, {out.max().item():.3f}], "
          f"{time.perf_counter() - t0:.2f} s")


if __name__ == "__main__":
    main()
