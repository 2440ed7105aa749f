"""Reference-format YAML -> typed configs, for every YAML of
configs/inference/.

Counterpart of vidseg_diffusion_tpu/config.py: the network (VideoUNet, or
UNetModel with one transformer depth or one per level), the first stage
(AutoencodingEngine with a VideoDecoder, AutoencoderKL), the denoiser
(Denoiser, DiscreteDenoiser) and its scaling (VScalingWithEDMcNoise,
EpsScaling, VScaling, EDMScaling), the optional sampler_config (the six
samplers of diffusion/sampling.py and sampling_extra.py, with s_churn /
s_tmin / s_tmax / s_noise, eta, order), its discretization and guider
(VanillaCFG, LinearPredictionGuider, IdentityGuider), and the conditioner's
embedders: the SVD image conditioner, SD 2.1's OpenCLIP text embedder (layer
'penultimate' or 'last'), SDXL's CLIP-L (layer 'hidden') + bigG (pooled)
and the refiner's bigG, with their ConcatTimestepEmbedderND size embedders,
the T5 / ByT5 text embedder (FrozenT5Embedder / FrozenByT5Embedder; the
architecture from the checkpoint, else from params.t5_cfg) and the
ClassEmbedder. Any other target raises NotImplementedError.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
import yaml

from vidseg_diffusion_tpu_torch.diffusion.denoiser import Denoiser, DiscreteDenoiser
from vidseg_diffusion_tpu_torch.diffusion.discretization import (
    EDMDiscretization,
    LegacyDDPMDiscretization,
)
from vidseg_diffusion_tpu_torch.diffusion.guidance import IdentityGuider, LinearPredictionGuider, VanillaCFG
from vidseg_diffusion_tpu_torch.diffusion.sampling import (
    EulerAncestralSampler,
    EulerEDMSampler,
    HeunEDMSampler,
)
from vidseg_diffusion_tpu_torch.diffusion.sampling_extra import (
    DPMPP2MSampler,
    DPMPP2SAncestralSampler,
    LinearMultistepSampler,
)
from vidseg_diffusion_tpu_torch.diffusion.scaling import (
    EDMScaling,
    EpsScaling,
    VScaling,
    VScalingWithEDMcNoise,
)
from vidseg_diffusion_tpu_torch.models.clip import CLIPTextConfig, CLIPVisionConfig
from vidseg_diffusion_tpu_torch.models.t5 import T5Config
from vidseg_diffusion_tpu_torch.models.unet import UNetConfig
from vidseg_diffusion_tpu_torch.models.vae import VAEConfig

SAMPLERS = {cls.__name__: cls for cls in (EulerEDMSampler, HeunEDMSampler, EulerAncestralSampler,
                                          DPMPP2SAncestralSampler, DPMPP2MSampler, LinearMultistepSampler)}
SCALINGS = {cls.__name__: cls for cls in (EDMScaling, EpsScaling, VScaling, VScalingWithEDMcNoise)}


def _name(node: Dict[str, Any]) -> str:
    return node["target"].rsplit(".", 1)[-1]


def _expect(node: Dict[str, Any], *names: str) -> Dict[str, Any]:
    if _name(node) not in names:
        raise NotImplementedError(
            f"target {node['target']} is not ported yet (ported: {', '.join(names)}; ROADMAP Queue A lists "
            f"the rest)")
    return node.get("params") or {}


def _discretization(node: Dict[str, Any]):
    p = _expect(node, "EDMDiscretization", "LegacyDDPMDiscretization")
    if _name(node) == "EDMDiscretization":
        return EDMDiscretization(p.get("sigma_min", 0.002), p.get("sigma_max", 80.0), p.get("rho", 7.0))
    return LegacyDDPMDiscretization(p.get("linear_start", 0.00085), p.get("linear_end", 0.0120),
                                    p.get("num_timesteps", 1000))


def _guider(node: Optional[Dict[str, Any]], num_frames: Optional[int]):
    if node is None:
        return IdentityGuider()
    p = _expect(node, "VanillaCFG", "LinearPredictionGuider", "IdentityGuider")
    if _name(node) == "VanillaCFG":
        return VanillaCFG(scale=p["scale"])
    if _name(node) == "IdentityGuider":
        return IdentityGuider()
    return LinearPredictionGuider(max_scale=p["max_scale"], num_frames=p.get("num_frames", num_frames),
                                  min_scale=p.get("min_scale", 1.0))


def _sampler(node: Dict[str, Any], num_steps: Optional[int]):
    p = _expect(node, *SAMPLERS)
    kw = dict(s_churn=p.get("s_churn", 0.0), s_tmin=p.get("s_tmin", 0.0),
              s_tmax=p.get("s_tmax", float("inf")), s_noise=p.get("s_noise", 1.0))
    if _name(node) in ("EulerAncestralSampler", "DPMPP2SAncestralSampler"):
        kw["eta"] = p.get("eta", 1.0)
    if _name(node) == "LinearMultistepSampler":
        kw["order"] = p.get("order", 4)
    steps = num_steps if num_steps is not None else p.get("num_steps", 25)
    return SAMPLERS[_name(node)](_discretization(p["discretization_config"]), steps, **kw)


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    """`kind` names the conditioner: 'svd' (clip_config, the image tower),
    'sd_text' (text_config, layer 'penultimate' unless text_penultimate is
    False), 'sdxl' (text_l_config with text_l_layer_idx, and text_g_config)
    or 'sdxl_refiner' (text_g_config), 't5_text' (t5_config, the YAML's
    t5_cfg; a checkpoint's shapes override it) or 'class' (class_config:
    embed_dim, n_classes, add_sequence_dim); embedder_index is the T5 or
    class embedder's place in emb_models (its checkpoint prefix);
    size_outdim is the SDXL size embedders' width. sampler and guider are
    None without a sampler_config."""

    unet_config: UNetConfig
    vae_config: VAEConfig
    clip_config: Optional[CLIPVisionConfig]
    text_config: Optional[CLIPTextConfig]
    denoiser: Denoiser
    sampler: Optional[EulerEDMSampler]
    guider: Any
    scale_factor: float
    ckpt_path: Optional[str]
    kind: str = "svd"
    text_penultimate: bool = True
    text_l_config: Optional[CLIPTextConfig] = None
    text_l_layer_idx: int = 11
    text_g_config: Optional[CLIPTextConfig] = None
    size_outdim: int = 256
    t5_config: Optional[T5Config] = None
    class_config: Optional[Dict[str, Any]] = None
    embedder_index: int = 0


def _conditioner(root: Dict[str, Any], dtype: torch.dtype) -> Dict[str, Any]:
    """The ModelSpec fields of the conditioner_config's embedders."""
    out: Dict[str, Any] = {}
    outdims = []
    for idx, emb in enumerate(root.get("conditioner_config", {}).get("params", {}).get("emb_models", [])):
        name, params = _name(emb), emb.get("params") or {}
        if name in ("FrozenT5Embedder", "FrozenByT5Embedder"):
            out["t5_config"] = T5Config(dtype=dtype, **(params.get("t5_cfg") or {}))
            out["embedder_index"] = idx
        elif name == "ClassEmbedder":
            out["class_config"] = dict(embed_dim=params["embed_dim"], n_classes=params.get("n_classes", 1000),
                                       add_sequence_dim=params.get("add_sequence_dim", False))
            out["embedder_index"] = idx
        elif name == "FrozenOpenCLIPImagePredictionEmbedder":
            out["clip_config"] = CLIPVisionConfig(dtype=dtype, **(params.get("vision_cfg") or {}))
        elif name == "FrozenOpenCLIPEmbedder":
            layer = params.get("layer", "last")
            if layer not in ("penultimate", "last"):
                raise NotImplementedError(f"OpenCLIP text layer {layer!r}: the port has 'penultimate' and 'last'")
            out["text_config"] = CLIPTextConfig(dtype=dtype, **(params.get("text_cfg") or {}))
            out["text_penultimate"] = layer == "penultimate"
        elif name == "FrozenOpenCLIPEmbedder2":
            if params.get("layer", "last") != "penultimate" or not params.get("always_return_pooled") \
                    or params.get("legacy", True):
                raise NotImplementedError("FrozenOpenCLIPEmbedder2: the port has SDXL's layer 'penultimate', "
                                          "always_return_pooled and legacy False")
            tc = params.get("text_cfg") or dict(width=1280, heads=20, layers=32)
            out["text_g_config"] = CLIPTextConfig(dtype=dtype, **tc)
        elif name == "FrozenCLIPEmbedder":
            if params.get("layer", "last") != "hidden":
                raise NotImplementedError("FrozenCLIPEmbedder: the port has layer 'hidden' (SDXL's)")
            tc = params.get("text_cfg") or dict(width=768, heads=12, layers=12)
            out["text_l_config"] = CLIPTextConfig(dtype=dtype, act="quick_gelu", **tc)
            out["text_l_layer_idx"] = params.get("layer_idx", 11)
        elif name == "ConcatTimestepEmbedderND":
            outdims.append(params.get("outdim", 256))
        elif name != "VideoPredictionEmbedderWithEncoder":
            raise NotImplementedError(f"embedder {emb['target']} is not ported yet (ROADMAP Queue A)")
    if outdims:
        out["size_outdim"] = outdims[0]
    has = lambda k: out.get(k) is not None
    kinds = [k for k, ok in (("svd", has("clip_config")), ("sd_text", has("text_config")),
                             ("sdxl", has("text_l_config") and has("text_g_config")),
                             ("sdxl_refiner", has("text_g_config") and not has("text_l_config")),
                             ("t5_text", has("t5_config")), ("class", has("class_config"))) if ok]
    if len(kinds) != 1 or (has("text_l_config") and not has("text_g_config")):
        raise NotImplementedError(
            "the ported conditioners are SVD's image conditioner, SD 2.1's OpenCLIP text embedder, SDXL's "
            "base and refiner text embedders, the T5 / ByT5 text embedder and the ClassEmbedder, one at a time")
    out["kind"] = kinds[0]
    return out


def load_model_spec(path: str, num_steps: Optional[int] = None, num_frames: Optional[int] = None,
                    dtype: torch.dtype = torch.float32) -> ModelSpec:
    """Parse a reference-format inference YAML; num_steps / num_frames
    override the sampler's step count and the guider's frame count as
    load_model does (svd_single_video_inference.py:570-578)."""
    with open(path) as f:
        root = yaml.safe_load(f)["model"]["params"]

    p = _expect(root["network_config"], "VideoUNet", "UNetModel")
    video = _name(root["network_config"]) == "VideoUNet"
    td = p.get("transformer_depth", 1)
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
        transformer_depth=tuple(td) if isinstance(td, list) else td, context_dim=cd,
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
    _expect(dn["scaling_config"], *SCALINGS)
    scaling = SCALINGS[_name(dn["scaling_config"])](**(dn["scaling_config"].get("params") or {}))
    if _name(root["denoiser_config"]) == "Denoiser":
        denoiser = Denoiser(scaling)
    else:
        denoiser = DiscreteDenoiser(scaling, _discretization(dn["discretization_config"]),
                                    dn.get("num_idx", 1000), dn.get("quantize_c_noise", True))

    # sampler_config is optional on DiffusionEngine (the demo / API supplies a sampler)
    sampler = guider = None
    if "sampler_config" in root:
        sampler = _sampler(root["sampler_config"], num_steps)
        guider = _guider((root["sampler_config"].get("params") or {}).get("guider_config"), num_frames)

    cond = _conditioner(root, dtype)
    if (cond["kind"] == "svd") != video:
        raise NotImplementedError("the SVD image conditioner goes with VideoUNet, the text conditioners with "
                                  "UNetModel")
    return ModelSpec(
        unet_config=unet, vae_config=vae, clip_config=cond.pop("clip_config", None),
        text_config=cond.pop("text_config", None), denoiser=denoiser, sampler=sampler, guider=guider,
        scale_factor=root.get("scale_factor", 0.18215), ckpt_path=root.get("ckpt_path"), **cond,
    )
