"""Assemble the SVD model stack from a YAML and a checkpoint or a seed.

Counterpart of vidseg_diffusion_tpu/engine/build.py (Pipeline,
build_pipeline) for the SVD path. With a checkpoint, the sgm state dict
loads straight into the modules (their names are the sgm keys; the
open_clip in_proj is split). Without one, weights are random from a seed
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
from vidseg_diffusion_tpu_torch.models.clip import CLIPVisionTransformer, clip_preprocess
from vidseg_diffusion_tpu_torch.models.conditioner import build_svd_conditioner
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
    """The SVD model stack on one device, ready for run_single_video."""

    spec: ModelSpec
    unet: UNetModel
    first_stage: FirstStage
    clip: CLIPVisionTransformer
    cond_encoder: Encoder
    device: torch.device

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


def build_pipeline(config_path: str, ckpt_path: Optional[str] = None,
                   num_steps: Optional[int] = None, num_frames: Optional[int] = None,
                   dtype: torch.dtype = torch.float32, device="cpu", seed: int = 0) -> Pipeline:
    """Build the SVD stack in `dtype` on `device`: from `ckpt_path` (or the
    YAML's ckpt_path when that file exists), else random weights from
    `seed`. An explicit ckpt_path that does not exist raises."""
    device = torch.device(device)
    spec = load_model_spec(config_path, num_steps=num_steps, num_frames=num_frames, dtype=dtype)
    unet = UNetModel(spec.unet_config)
    enc, dec = Encoder(spec.vae_config), Decoder(spec.vae_config)
    clip = CLIPVisionTransformer(spec.clip_config)
    cond_enc = Encoder(spec.vae_config)
    modules = (unet, enc, dec, clip, cond_enc)

    if ckpt_path is not None and not os.path.exists(ckpt_path):
        raise FileNotFoundError(ckpt_path)
    ckpt = ckpt_path or (spec.ckpt_path if spec.ckpt_path and os.path.exists(spec.ckpt_path) else None)
    if ckpt:
        sd = _load_checkpoint(ckpt)
        unet.load_state_dict(_sub(sd, "model.diffusion_model."))
        enc.load_state_dict(_sub(sd, "first_stage_model.encoder."))
        dec.load_state_dict(_sub(sd, "first_stage_model.decoder."))
        clip.load_state_dict(split_packed_qkv(_sub(sd, "conditioner.embedders.0.open_clip.model.visual.")))
        cond_sd = _sub(sd, "conditioner.embedders.3.encoder.encoder.")
        cond_enc.load_state_dict(cond_sd or enc.state_dict())
        for m in modules:
            m.to(device=device, dtype=dtype)
    else:
        gen = torch.Generator(device=device)
        for i, m in enumerate((unet, enc, dec, clip)):
            m.to(device=device)
            randomize_(m, gen.manual_seed(seed * 1000 + i + 1))
            m.to(dtype=dtype)
        # the JAX package's random build reuses the first-stage encoder
        # weights for the conditioning-frame encoder
        cond_enc.load_state_dict(enc.state_dict())
        cond_enc.to(device=device, dtype=dtype)
    for m in modules:
        m.eval().requires_grad_(False)
    return Pipeline(spec, unet, FirstStage(enc, dec, spec.scale_factor), clip, cond_enc, device)
