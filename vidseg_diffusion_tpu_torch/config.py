"""Reference-format YAML -> typed configs (SVD targets only).

Counterpart of vidseg_diffusion_tpu/config.py for the targets of
configs/inference/svd.yaml: VideoUNet, AutoencodingEngine with a
VideoDecoder, Denoiser with VScalingWithEDMcNoise, EulerEDMSampler with
EDMDiscretization and LinearPredictionGuider, and the OpenCLIP image
embedder's vision_cfg. Any other target raises NotImplementedError; the
remaining targets are ROADMAP Queue A items.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
import yaml

from vidseg_diffusion_tpu_torch.diffusion.denoiser import Denoiser
from vidseg_diffusion_tpu_torch.diffusion.discretization import EDMDiscretization
from vidseg_diffusion_tpu_torch.diffusion.guidance import LinearPredictionGuider
from vidseg_diffusion_tpu_torch.diffusion.sampling import EulerEDMSampler
from vidseg_diffusion_tpu_torch.diffusion.scaling import VScalingWithEDMcNoise
from vidseg_diffusion_tpu_torch.models.clip import CLIPVisionConfig
from vidseg_diffusion_tpu_torch.models.unet import UNetConfig
from vidseg_diffusion_tpu_torch.models.vae import VAEConfig


def _name(node: Dict[str, Any]) -> str:
    return node["target"].rsplit(".", 1)[-1]


def _expect(node: Dict[str, Any], *names: str) -> Dict[str, Any]:
    if _name(node) not in names:
        raise NotImplementedError(
            f"target {node['target']} is not ported yet (the port covers the SVD "
            f"targets; ROADMAP Queue A lists the rest)"
        )
    return node.get("params") or {}


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    unet_config: UNetConfig
    vae_config: VAEConfig
    clip_config: CLIPVisionConfig
    denoiser: Denoiser
    sampler: EulerEDMSampler
    guider: LinearPredictionGuider
    scale_factor: float
    ckpt_path: Optional[str]


def load_model_spec(path: str, num_steps: Optional[int] = None, num_frames: Optional[int] = None,
                    dtype: torch.dtype = torch.float32) -> ModelSpec:
    """Parse an SVD inference YAML; num_steps / num_frames override the
    sampler's step count and the guider's frame count as load_model does
    (svd_single_video_inference.py:570-578)."""
    with open(path) as f:
        root = yaml.safe_load(f)["model"]["params"]

    p = _expect(root["network_config"], "VideoUNet")
    cd = p.get("context_dim", 1024)
    if isinstance(cd, list):
        if len(set(cd)) != 1:
            raise ValueError(f"non-uniform per-level context_dim unsupported: {cd}")
        cd = cd[0]
    unet = UNetConfig(
        in_channels=p["in_channels"], out_channels=p["out_channels"],
        model_channels=p["model_channels"], num_res_blocks=p["num_res_blocks"],
        attention_resolutions=tuple(p["attention_resolutions"]),
        channel_mult=tuple(p.get("channel_mult", (1, 2, 4, 8))),
        num_head_channels=p.get("num_head_channels", 64),
        transformer_depth=p.get("transformer_depth", 1), context_dim=cd,
        adm_in_channels=p.get("adm_in_channels"), video=True,
        merge_strategy=p.get("merge_strategy", "learned_with_images"),
        merge_factor=p.get("merge_factor", 0.5),
        video_kernel_size=tuple(p.get("video_kernel_size", (3, 1, 1))), dtype=dtype,
        remat=bool(p.get("use_checkpoint", False)),
    )

    fs = _expect(root["first_stage_config"], "AutoencodingEngine")
    dd = fs["encoder_config"]["params"]
    dec = fs["decoder_config"]
    _expect(dec, "VideoDecoder")
    vae = VAEConfig(
        ch=dd["ch"], out_ch=dd["out_ch"], in_channels=dd["in_channels"],
        z_channels=dd["z_channels"], ch_mult=tuple(dd["ch_mult"]),
        num_res_blocks=dd["num_res_blocks"], double_z=dd.get("double_z", True),
        video_decoder=True,
        video_kernel_size=tuple(dec["params"].get("video_kernel_size", (3, 1, 1))),
        dtype=dtype,
    )

    dn = _expect(root["denoiser_config"], "Denoiser")
    _expect(dn["scaling_config"], "VScalingWithEDMcNoise")
    sp = _expect(root["sampler_config"], "EulerEDMSampler")
    disc = _expect(sp["discretization_config"], "EDMDiscretization")
    gp = _expect(sp["guider_config"], "LinearPredictionGuider")
    sampler = EulerEDMSampler(
        EDMDiscretization(disc.get("sigma_min", 0.002), disc.get("sigma_max", 80.0), disc.get("rho", 7.0)),
        num_steps if num_steps is not None else sp.get("num_steps", 25),
    )
    guider = LinearPredictionGuider(
        max_scale=gp["max_scale"], num_frames=gp.get("num_frames", num_frames),
        min_scale=gp.get("min_scale", 1.0),
    )

    clip = None
    for emb in (root.get("conditioner_config", {}).get("params", {}).get("emb_models", [])):
        if _name(emb) == "FrozenOpenCLIPImagePredictionEmbedder":
            clip = CLIPVisionConfig(dtype=dtype, **((emb.get("params") or {}).get("vision_cfg") or {}))
    if clip is None:
        raise NotImplementedError("only the SVD image-conditioned conditioner is ported")
    return ModelSpec(
        unet_config=unet, vae_config=vae, clip_config=clip,
        denoiser=Denoiser(VScalingWithEDMcNoise()), sampler=sampler, guider=guider,
        scale_factor=root.get("scale_factor", 0.18215), ckpt_path=root.get("ckpt_path"),
    )
