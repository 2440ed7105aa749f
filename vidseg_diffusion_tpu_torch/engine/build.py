"""Assemble a model stack (SVD, SD 2.1, SDXL base or refiner, or an image
UNet conditioned by T5 / ByT5 or a class label) from a YAML and a checkpoint
or a seed.

Counterpart of vidseg_diffusion_tpu/engine/build.py (Pipeline,
build_pipeline, :352-430 for SDXL): the SVD stack is the video UNet, the VAE
with the temporal decoder, the OpenCLIP image tower and the
conditioning-frame encoder; the SD 2.1 stack is the image UNet, the VAE with
the image decoder and the OpenCLIP text tower; the SDXL base adds to the
image UNet (per-level depth, a class embedding) the HF CLIP-L tower and the
pooled bigG tower, the refiner the bigG tower alone; a T5 stack has the
image UNet and an HF-named T5 encoder (build.py:453-496: its architecture
read from the checkpoint's conditioner.embedders.{i}.transformer.*, else
the YAML's t5_cfg), a class stack the ClassEmbedder (build.py:497-528:
conditioner.embedders.{i}.embedding.weight). `Pipeline.conditioner`
is the stack's conditioner and `kind` names it. With a checkpoint, the sgm
state dict loads straight into the modules (their names are the sgm keys;
the open_clip in_proj is split; CLIP-L and T5 keep HF's names).
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
    HFCLIPTextTransformer,
    clip_preprocess,
)
from vidseg_diffusion_tpu_torch.models.aux_encoders import ClassEmbedder
from vidseg_diffusion_tpu_torch.models.conditioner import (
    Conditioner,
    build_class_conditioner,
    build_sd_text_conditioner,
    build_sdxl_conditioner,
    build_sdxl_refiner_conditioner,
    build_svd_conditioner,
    build_t5_text_conditioner,
)
from vidseg_diffusion_tpu_torch.models.layers import Conv2dNHWC
from vidseg_diffusion_tpu_torch.models.t5 import T5Encoder, t5_config_from_state_dict
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
    """A model stack on one device: `clip` and `cond_encoder` are the SVD
    conditioner's towers, `text` SD 2.1's, `text_l` and `text_g` SDXL's
    (the refiner has text_g alone), `t5` the T5 stack's, `class_embedder`
    the class stack's; `conditioner` runs them."""

    spec: ModelSpec
    unet: UNetModel
    first_stage: FirstStage
    clip: Optional[CLIPVisionTransformer]
    cond_encoder: Optional[Encoder]
    device: torch.device
    text: Optional[CLIPTextTransformer] = None
    text_l: Optional[HFCLIPTextTransformer] = None
    text_g: Optional[CLIPTextTransformer] = None
    t5: Optional[T5Encoder] = None
    class_embedder: Optional[ClassEmbedder] = None
    conditioner: Optional[Conditioner] = None

    @property
    def kind(self) -> str:
        """'svd', 'sd_text', 'sdxl', 'sdxl_refiner', 't5_text' or 'class'."""
        return self.spec.kind

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
        batch = {
            "cond_frames_without_noise": image,
            "cond_frames": image + cond_aug * cond_aug_noise.to(dev),
            "fps_id": torch.tensor([fps_id], device=dev),
            "motion_bucket_id": torch.tensor([motion_bucket_id], device=dev),
            "cond_aug": torch.tensor([cond_aug], device=dev),
        }
        c, uc = self.conditioner.get_unconditional_conditioning(
            batch, force_uc_zero_embeddings=["cond_frames", "cond_frames_without_noise"]
        )
        rep = lambda d: {k: torch.repeat_interleave(v, t, dim=0) for k, v in d.items()}
        return rep(c), rep(uc)

    @torch.no_grad()
    def clip_apply(self, tokens) -> torch.Tensor:
        """The one conditioning tower of an SD 2.1, T5 or class stack: token
        ids [b, 77] -> [b, 77, width] (SD 2.1), ids [b, l] -> [b, l, d_model]
        (T5), labels -> embeddings (class)."""
        tower = {"sd_text": self.text, "t5_text": self.t5, "class": self.class_embedder}.get(self.kind)
        if tower is None:
            raise ValueError(f"clip_apply needs an SD 2.1, T5 or class stack, not {self.kind!r}")
        return tower(torch.as_tensor(tokens).to(self.device))


def _towers(spec: ModelSpec):
    """{Pipeline field: (module, checkpoint prefix)} of the conditioner's
    towers (the SVD conditioning-frame encoder apart)."""
    if spec.kind == "svd":
        return {"clip": (CLIPVisionTransformer(spec.clip_config), "conditioner.embedders.0.open_clip.model.visual.")}
    if spec.kind == "sd_text":
        return {"text": (CLIPTextTransformer(spec.text_config, penultimate=spec.text_penultimate),
                         "conditioner.embedders.0.model.")}
    if spec.kind == "t5_text":
        return {"t5": (T5Encoder(spec.t5_config), f"conditioner.embedders.{spec.embedder_index}.transformer.")}
    if spec.kind == "class":
        return {"class_embedder": (ClassEmbedder(**spec.class_config),
                                   f"conditioner.embedders.{spec.embedder_index}.")}
    g = CLIPTextTransformer(spec.text_g_config, return_pooled=True)
    if spec.kind == "sdxl_refiner":
        return {"text_g": (g, "conditioner.embedders.0.model.")}
    return {"text_l": (HFCLIPTextTransformer(spec.text_l_config, spec.text_l_layer_idx),
                       "conditioner.embedders.0.transformer."),
            "text_g": (g, "conditioner.embedders.1.model.")}


def _conditioner(pipe: Pipeline) -> Conditioner:
    if pipe.kind == "svd":
        return build_svd_conditioner(lambda f: pipe.clip(clip_preprocess(f)),
                                     lambda f: gaussian_sample(pipe.cond_encoder(f)))
    if pipe.kind == "sd_text":
        return build_sd_text_conditioner(pipe.text)
    if pipe.kind == "t5_text":
        return build_t5_text_conditioner(pipe.t5)
    if pipe.kind == "class":
        return build_class_conditioner(pipe.class_embedder)
    if pipe.kind == "sdxl_refiner":
        return build_sdxl_refiner_conditioner(pipe.text_g, pipe.spec.size_outdim)
    return build_sdxl_conditioner(pipe.text_l, pipe.text_g, pipe.spec.size_outdim)


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
    if ckpt_path is not None and not os.path.exists(ckpt_path):
        raise FileNotFoundError(ckpt_path)
    ckpt = ckpt_path or (spec.ckpt_path if spec.ckpt_path and os.path.exists(spec.ckpt_path) else None)
    sd = _load_checkpoint(ckpt) if ckpt else None
    if sd is not None and spec.kind == "t5_text":
        # the reference YAMLs name only the HF version: the architecture is the checkpoint's
        t5_sd = _sub(sd, f"conditioner.embedders.{spec.embedder_index}.transformer.")
        spec = dataclasses.replace(spec, t5_config=t5_config_from_state_dict(t5_sd, dtype))
    video = spec.kind == "svd"
    # built without storage, then given uninitialised storage in `dtype` on the
    # device: the checkpoint or randomize_ writes every parameter (the modules
    # hold no buffers), so no default initialisation runs, no full-width stack
    # passes through host memory and none is held in fp32 on the way to bf16
    # (19 GB for T5-XXL); a load or randomize_'s fp32 draw rounds once into the
    # parameter, as a cast afterwards would
    with torch.device("meta"):
        unet = UNetModel(spec.unet_config)
        enc, dec = Encoder(spec.vae_config), Decoder(spec.vae_config)
        towers = _towers(spec)
        cond_enc = Encoder(spec.vae_config) if video else None
    modules = [unet, enc, dec] + [m for m, _ in towers.values()] + ([cond_enc] if video else [])
    for m in modules:
        m.to(dtype=dtype).to_empty(device=device)
    quant = post_quant = None

    if sd is not None:
        unet.load_state_dict(_sub(sd, "model.diffusion_model."))
        enc.load_state_dict(_sub(sd, "first_stage_model.encoder."))
        dec.load_state_dict(_sub(sd, "first_stage_model.decoder."))
        for tower, prefix in towers.values():
            tower_sd = split_packed_qkv(_sub(sd, prefix))
            # the checkpoint also holds what a tower never runs (the layers past
            # the one it reads, the final norms it skips, attn_mask, position_ids):
            # every key the tower has must be there, the rest is left unused
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
        for i, m in enumerate([unet, enc, dec] + [m for m, _ in towers.values()]):
            randomize_(m, gen.manual_seed(seed * 1000 + i + 1))
        if video:
            # the JAX package's random build reuses the first-stage encoder
            # weights for the conditioning-frame encoder
            cond_enc.load_state_dict(enc.state_dict())
    for m in modules:
        m.eval().requires_grad_(False)
    first_stage = FirstStage(enc, dec, spec.scale_factor, quant, post_quant)
    pipe = Pipeline(spec, unet, first_stage, towers.pop("clip", (None,))[0], cond_enc, device,
                    **{name: m for name, (m, _) in towers.items()})
    pipe.conditioner = _conditioner(pipe)
    return pipe


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
