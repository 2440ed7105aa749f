"""Assemble a model stack (SVD or SD 2.1) from a YAML and a checkpoint or a
seed.

Counterpart of vidseg_diffusion_tpu/engine/build.py (Pipeline,
build_pipeline): the SVD stack is the video UNet, the VAE with the temporal
decoder, the OpenCLIP image tower and the conditioning-frame encoder; the SD
2.1 stack is the image UNet, the VAE with the image decoder and the OpenCLIP
text tower. With a checkpoint, the sgm state dict loads straight into the
modules (their names are the sgm keys; the open_clip in_proj is split).
Without one, weights are random from a seed
and scaled as the JAX package's _synthesize_params scales them
(build.py:62-99): every parameter of rank <= 1 (biases, norm scales, mix
factors, the class embedding) is 0.5, every other one is N(0, 1/fan_in)
with fan_in taken in JAX's shape convention (all dims but the last of the
flax kernel). Other scales can overflow bf16 at 1.5 B parameters.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Dict, Optional

import torch
import torch.nn as nn

from vidseg_diffusion_tpu_torch.config import ModelSpec, load_model_spec
from vidseg_diffusion_tpu_torch.engine.diffusion_engine import FirstStage
from vidseg_diffusion_tpu_torch.engine.modulation import ModulationConfig
from vidseg_diffusion_tpu_torch.engine.vidseg import HarvestSpec, VidSegEngine
from vidseg_diffusion_tpu_torch.io.convert import split_packed_qkv
from vidseg_diffusion_tpu_torch.models.clip import (
    CLIPTextTransformer,
    CLIPVisionTransformer,
    clip_preprocess,
)
from vidseg_diffusion_tpu_torch.models.conditioner import build_svd_conditioner
from vidseg_diffusion_tpu_torch.models.layers import Conv2dNHWC
from vidseg_diffusion_tpu_torch.models.unet import UNetModel
from vidseg_diffusion_tpu_torch.models.vae import Decoder, Encoder, gaussian_sample


def _jax_fan_in(module: nn.Module, name: str, p: torch.Tensor) -> int:
    """fan_in of the flax kernel this torch parameter corresponds to."""
    owner = module.get_submodule(name.rsplit(".", 1)[0]) if "." in name else module
    if isinstance(owner, nn.Linear):
        return p.shape[1]               # flax Dense kernel [in, out]
    if p.dim() >= 4:
        return math.prod(p.shape[1:])   # flax conv kernel [..., in, out]
    return p.shape[0]                   # positional_embedding / proj: same layout


@torch.no_grad()
def randomize_(module: nn.Module, generator: torch.Generator) -> None:
    """Fill every parameter as _synthesize_params does (see module doc)."""
    for name, p in module.named_parameters():
        if p.dim() <= 1:
            p.fill_(0.5)
        else:
            std = (1.0 / max(_jax_fan_in(module, name, p), 1)) ** 0.5
            vals = torch.randn(p.shape, generator=generator, device=generator.device)
            p.copy_(vals * std)


def _load_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    if path.endswith(".safetensors"):
        from safetensors.torch import load_file

        return load_file(path)
    sd = torch.load(path, map_location="cpu", weights_only=False)
    return sd.get("state_dict", sd)


def _sub(sd: Dict[str, torch.Tensor], prefix: str) -> Dict[str, torch.Tensor]:
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


@dataclasses.dataclass
class Pipeline:
    """A model stack on one device, ready for run_single_video: `clip` and
    `cond_encoder` are the SVD conditioner's towers, `text` the SD 2.1 one."""

    spec: ModelSpec
    unet: UNetModel
    first_stage: FirstStage
    clip: Optional[CLIPVisionTransformer]
    cond_encoder: Optional[Encoder]
    device: torch.device
    text: Optional[CLIPTextTransformer] = None

    def make_engine(self, mod_cfg: ModulationConfig, harvest: HarvestSpec) -> VidSegEngine:
        return VidSegEngine(self.unet, self.spec.denoiser, self.spec.sampler,
                            self.spec.guider, mod_cfg, harvest)

    @torch.no_grad()
    def condition_video(self, image: torch.Tensor, cond_aug_noise: torch.Tensor, fps_id: float,
                        motion_bucket_id: float, cond_aug: float, t: int):
        """SVD conditioning of one video from its first frame [1, H, W, 3]
        through the SVD conditioner: c = {crossattn: CLIP(image), vector:
        [fps | motion | aug] embeddings, concat: VAE-mode(image + cond_aug *
        noise)}; uc zeroes crossattn and concat (modules.py:166-184); both
        repeated per frame."""
        dev = self.device
        image = image.to(dev)
        conditioner = build_svd_conditioner(
            lambda f: self.clip(clip_preprocess(f)),
            lambda f: gaussian_sample(self.cond_encoder(f)),
        )
        batch = {
            "cond_frames_without_noise": image,
            "cond_frames": image + cond_aug * cond_aug_noise.to(dev),
            "fps_id": torch.tensor([fps_id], device=dev),
            "motion_bucket_id": torch.tensor([motion_bucket_id], device=dev),
            "cond_aug": torch.tensor([cond_aug], device=dev),
        }
        c, uc = conditioner.get_unconditional_conditioning(
            batch, force_uc_zero_embeddings=["cond_frames", "cond_frames_without_noise"]
        )
        rep = lambda d: {k: torch.repeat_interleave(v, t, dim=0) for k, v in d.items()}
        return rep(c), rep(uc)

    @torch.no_grad()
    def clip_apply(self, tokens) -> torch.Tensor:
        """SD 2.1 text conditioning: token ids [b, 77] -> [b, 77, width]."""
        return self.text(torch.as_tensor(tokens).to(self.device))


def build_pipeline(config_path: str, ckpt_path: Optional[str] = None,
                   num_steps: Optional[int] = None, num_frames: Optional[int] = None,
                   dtype: torch.dtype = torch.float32, device="cuda", seed: int = 0) -> Pipeline:
    """Build the stack the YAML describes in `dtype` on `device` (the card
    unless the caller asks for the CPU; without a card the default raises):
    from `ckpt_path` (or the YAML's ckpt_path when that file exists), else
    random weights from `seed`. An explicit ckpt_path that does not exist
    raises."""
    device = torch.device(device)
    spec = load_model_spec(config_path, num_steps=num_steps, num_frames=num_frames, dtype=dtype)
    video = spec.unet_config.video
    unet = UNetModel(spec.unet_config)
    enc, dec = Encoder(spec.vae_config), Decoder(spec.vae_config)
    if video:
        tower, cond_enc = CLIPVisionTransformer(spec.clip_config), Encoder(spec.vae_config)
        tower_prefix = "conditioner.embedders.0.open_clip.model.visual."
    else:
        tower, cond_enc = CLIPTextTransformer(spec.text_config), None
        tower_prefix = "conditioner.embedders.0.model."
    modules = [unet, enc, dec, tower] + ([cond_enc] if video else [])
    quant = post_quant = None

    if ckpt_path is not None and not os.path.exists(ckpt_path):
        raise FileNotFoundError(ckpt_path)
    ckpt = ckpt_path or (spec.ckpt_path if spec.ckpt_path and os.path.exists(spec.ckpt_path) else None)
    if ckpt:
        sd = _load_checkpoint(ckpt)
        unet.load_state_dict(_sub(sd, "model.diffusion_model."))
        enc.load_state_dict(_sub(sd, "first_stage_model.encoder."))
        dec.load_state_dict(_sub(sd, "first_stage_model.decoder."))
        tower_sd = split_packed_qkv(_sub(sd, tower_prefix))
        # the checkpoint also holds what the tower never runs (the text tower's
        # last block, text_projection, attn_mask): every key the tower has must
        # be there, the rest is left unused
        tower.load_state_dict({k: tower_sd[k] for k in tower.state_dict()})
        if video:
            cond_sd = _sub(sd, "conditioner.embedders.3.encoder.encoder.")
            cond_enc.load_state_dict(cond_sd or enc.state_dict())
        if "first_stage_model.quant_conv.weight" in sd:
            z2 = sd["first_stage_model.quant_conv.weight"].shape[0]
            quant, post_quant = Conv2dNHWC(z2, z2, 1), Conv2dNHWC(spec.vae_config.z_channels,
                                                                  spec.vae_config.z_channels, 1)
            quant.load_state_dict(_sub(sd, "first_stage_model.quant_conv."))
            post_quant.load_state_dict(_sub(sd, "first_stage_model.post_quant_conv."))
            modules += [quant, post_quant]
        for m in modules:
            m.to(device=device, dtype=dtype)
    else:
        gen = torch.Generator(device=device)
        for i, m in enumerate((unet, enc, dec, tower)):
            m.to(device=device)
            randomize_(m, gen.manual_seed(seed * 1000 + i + 1))
            m.to(dtype=dtype)
        if video:
            # the JAX package's random build reuses the first-stage encoder
            # weights for the conditioning-frame encoder
            cond_enc.load_state_dict(enc.state_dict())
            cond_enc.to(device=device, dtype=dtype)
    for m in modules:
        m.eval().requires_grad_(False)
    first_stage = FirstStage(enc, dec, spec.scale_factor, quant, post_quant)
    if video:
        return Pipeline(spec, unet, first_stage, tower, cond_enc, device)
    return Pipeline(spec, unet, first_stage, None, None, device, text=tower)


def build_pipeline_from_args(args, num_frames: int) -> Pipeline:
    """The pipeline a CLI's flags name (--model_config, --ckpt_path,
    --num_steps, --seed) on --device, in --dtype: bf16 on the card and fp32 on
    the CPU when the flag is not given. A --ckpt_path that does not exist
    raises FileNotFoundError, as build_pipeline does."""
    device = torch.device(args.device)
    dtype = {"bfloat16": torch.bfloat16, "float32": torch.float32}.get(
        args.dtype, torch.bfloat16 if device.type == "cuda" else torch.float32)
    print("device:", device, "dtype:", dtype)
    return build_pipeline(args.model_config, ckpt_path=args.ckpt_path, num_steps=args.num_steps,
                          num_frames=num_frames, dtype=dtype, device=device, seed=args.seed)
