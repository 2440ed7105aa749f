"""Reference-format YAML -> typed configs (the SVD and SD 2.1 targets).

Counterpart of vidseg_diffusion_tpu/config.py for the targets of
configs/inference/svd.yaml (VideoUNet, AutoencodingEngine with a
VideoDecoder, Denoiser with VScalingWithEDMcNoise, EulerEDMSampler with
EDMDiscretization and LinearPredictionGuider, the OpenCLIP image embedder's
vision_cfg) and of configs/inference/sd_2_1.yaml (UNetModel, AutoencoderKL,
DiscreteDenoiser with EpsScaling, LegacyDDPMDiscretization, VanillaCFG, the
OpenCLIP text embedder's text_cfg). Any other target raises
NotImplementedError; the remaining targets (SDXL, T5, the other samplers)
are ROADMAP Queue A items.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Union

import torch
import yaml

from vidseg_diffusion_tpu_torch.diffusion.denoiser import Denoiser, DiscreteDenoiser
from vidseg_diffusion_tpu_torch.diffusion.discretization import (
    EDMDiscretization,
    LegacyDDPMDiscretization,
)
from vidseg_diffusion_tpu_torch.diffusion.guidance import LinearPredictionGuider, VanillaCFG
from vidseg_diffusion_tpu_torch.diffusion.sampling import EulerEDMSampler
from vidseg_diffusion_tpu_torch.diffusion.scaling import EpsScaling, VScalingWithEDMcNoise
from vidseg_diffusion_tpu_torch.models.clip import CLIPTextConfig, CLIPVisionConfig
from vidseg_diffusion_tpu_torch.models.unet import UNetConfig
from vidseg_diffusion_tpu_torch.models.vae import VAEConfig


def _name(node: Dict[str, Any]) -> str:
    return node["target"].rsplit(".", 1)[-1]


def _expect(node: Dict[str, Any], *names: str) -> Dict[str, Any]:
    if _name(node) not in names:
        raise NotImplementedError(
            f"target {node['target']} is not ported yet (the port covers the SVD and "
            f"SD 2.1 targets; ROADMAP Queue A lists the rest)"
        )
    return node.get("params") or {}


def _discretization(node: Dict[str, Any]):
    p = _expect(node, "EDMDiscretization", "LegacyDDPMDiscretization")
    if _name(node) == "EDMDiscretization":
        return EDMDiscretization(p.get("sigma_min", 0.002), p.get("sigma_max", 80.0), p.get("rho", 7.0))
    return LegacyDDPMDiscretization(p.get("linear_start", 0.00085), p.get("linear_end", 0.0120),
                                    p.get("num_timesteps", 1000))


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    """clip_config is the image tower's (SVD) and text_config the text
    tower's (SD 2.1): one of them is None."""

    unet_config: UNetConfig
    vae_config: VAEConfig
    clip_config: Optional[CLIPVisionConfig]
    text_config: Optional[CLIPTextConfig]
    denoiser: Denoiser
    sampler: EulerEDMSampler
    guider: Union[LinearPredictionGuider, VanillaCFG]
    scale_factor: float
    ckpt_path: Optional[str]


def load_model_spec(path: str, num_steps: Optional[int] = None, num_frames: Optional[int] = None,
                    dtype: torch.dtype = torch.float32) -> ModelSpec:
    """Parse an SVD or SD 2.1 inference YAML; num_steps / num_frames override
    the sampler's step count and the guider's frame count as load_model does
    (svd_single_video_inference.py:570-578)."""
    with open(path) as f:
        root = yaml.safe_load(f)["model"]["params"]

    p = _expect(root["network_config"], "VideoUNet", "UNetModel")
    video = _name(root["network_config"]) == "VideoUNet"
    if not isinstance(p.get("transformer_depth", 1), int):
        raise NotImplementedError("per-level transformer_depth (SDXL) is not ported yet (ROADMAP Queue A)")
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
        adm_in_channels=p.get("adm_in_channels"), video=video,
        merge_strategy=p.get("merge_strategy", "learned_with_images"),
        merge_factor=p.get("merge_factor", 0.5),
        video_kernel_size=tuple(p.get("video_kernel_size", (3, 1, 1))), dtype=dtype,
        remat=bool(p.get("use_checkpoint", False)),
    )

    fs = _expect(root["first_stage_config"], "AutoencodingEngine", "AutoencoderKL", "AutoencoderKLModeOnly")
    if _name(root["first_stage_config"]) == "AutoencodingEngine":
        dd = fs["encoder_config"]["params"]
        dec = fs["decoder_config"]
        _expect(dec, "VideoDecoder")
        video_decoder, vks = True, tuple(dec["params"].get("video_kernel_size", (3, 1, 1)))
    else:
        dd, video_decoder, vks = fs["ddconfig"], False, (3, 1, 1)
    vae = VAEConfig(
        ch=dd["ch"], out_ch=dd["out_ch"], in_channels=dd["in_channels"],
        z_channels=dd["z_channels"], ch_mult=tuple(dd["ch_mult"]),
        num_res_blocks=dd["num_res_blocks"], double_z=dd.get("double_z", True),
        video_decoder=video_decoder, video_kernel_size=vks, dtype=dtype,
    )

    dn = _expect(root["denoiser_config"], "Denoiser", "DiscreteDenoiser")
    _expect(dn["scaling_config"], "VScalingWithEDMcNoise", "EpsScaling")
    scaling = VScalingWithEDMcNoise() if _name(dn["scaling_config"]) == "VScalingWithEDMcNoise" else EpsScaling()
    if _name(root["denoiser_config"]) == "Denoiser":
        denoiser = Denoiser(scaling)
    else:
        denoiser = DiscreteDenoiser(scaling, _discretization(dn["discretization_config"]),
                                    dn.get("num_idx", 1000), dn.get("quantize_c_noise", True))

    sp = _expect(root["sampler_config"], "EulerEDMSampler")
    if sp.get("s_churn", 0.0) > 0:
        raise NotImplementedError("s_churn > 0 is not ported (no shipped config sets it)")
    sampler = EulerEDMSampler(
        _discretization(sp["discretization_config"]),
        num_steps if num_steps is not None else sp.get("num_steps", 25),
    )
    gp = _expect(sp["guider_config"], "LinearPredictionGuider", "VanillaCFG")
    if _name(sp["guider_config"]) == "VanillaCFG":
        guider = VanillaCFG(scale=gp["scale"])
    else:
        guider = LinearPredictionGuider(
            max_scale=gp["max_scale"], num_frames=gp.get("num_frames", num_frames),
            min_scale=gp.get("min_scale", 1.0),
        )

    clip = text = None
    for emb in (root.get("conditioner_config", {}).get("params", {}).get("emb_models", [])):
        params = emb.get("params") or {}
        if _name(emb) == "FrozenOpenCLIPImagePredictionEmbedder":
            clip = CLIPVisionConfig(dtype=dtype, **(params.get("vision_cfg") or {}))
        elif _name(emb) == "FrozenOpenCLIPEmbedder":
            if params.get("layer", "last") != "penultimate":
                raise NotImplementedError("of the OpenCLIP text embedder only layer 'penultimate' is ported")
            text = CLIPTextConfig(dtype=dtype, **(params.get("text_cfg") or {}))
    if (clip is None) == (text is None) or (clip is None) == video:
        raise NotImplementedError(
            "the ported conditioners are the SVD image conditioner (with VideoUNet) and the "
            "SD 2.1 OpenCLIP text embedder (with UNetModel)")
    return ModelSpec(
        unet_config=unet, vae_config=vae, clip_config=clip, text_config=text,
        denoiser=denoiser, sampler=sampler, guider=guider,
        scale_factor=root.get("scale_factor", 0.18215), ckpt_path=root.get("ckpt_path"),
    )
