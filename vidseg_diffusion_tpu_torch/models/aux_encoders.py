"""Auxiliary conditioner encoders (PyTorch).

Counterpart of vidseg_diffusion_tpu/models/aux_encoders.py, the rest of the
reference's embedder family (sgm/modules/encoders/modules.py), none of which
a shipped VidSeg config uses:
- identity_encoder   (IdentityEncoder, modules.py:207-212);
- ClassEmbedder      (modules.py:215-234), the class n_classes - 1 for
  unconditional guidance;
- SpatialRescaler    (modules.py:757-815): n resize stages and an optional
  channel-mapping conv, per frame with wrap_video;
- LowScaleEncoder    (modules.py:818-911): the noise-augmented low-resolution
  latent of upscaler-style models;
- clip_t5_text_fn    (FrozenCLIPT5Encoder, modules.py:729-754).

Layouts are channels-last ([b, h, w, c]; video [b, t, h, w, c]), as in the
JAX package. The resizes follow jax.image.resize with antialias=False
(`_RESIZE_METHOD`: 'area' is linear there, bicubic the Keys cubic) on
ops/image.py's weight matrices, not F.interpolate, whose bicubic differs.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch
import torch.nn as nn

from vidseg_diffusion_tpu_torch.diffusion.discretization import LegacyDDPMDiscretization
from vidseg_diffusion_tpu_torch.models.layers import Conv2dNHWC
from vidseg_diffusion_tpu_torch.ops.image import resize_bicubic, resize_linear, resize_nearest


def identity_encoder(x: torch.Tensor) -> torch.Tensor:
    return x


class ClassEmbedder(nn.Module):
    """Labels [b] -> embeddings [b, embed_dim] ([b, 1, embed_dim] with
    add_sequence_dim); key `embedding.weight`."""

    def __init__(self, embed_dim: int, n_classes: int = 1000, add_sequence_dim: bool = False):
        super().__init__()
        self.n_classes, self.add_sequence_dim = n_classes, add_sequence_dim
        self.embedding = nn.Embedding(n_classes, embed_dim)

    def forward(self, c) -> torch.Tensor:
        c = torch.as_tensor(c).to(self.embedding.weight.device).long()
        emb = self.embedding.weight[c]
        return emb[:, None, :] if self.add_sequence_dim else emb

    def get_unconditional_class(self, bs: int, device=None) -> torch.Tensor:
        return torch.full((bs,), self.n_classes - 1, dtype=torch.int32, device=device)


_RESIZE_METHOD = {
    "nearest": "nearest",
    "linear": "linear",
    "bilinear": "linear",
    "trilinear": "linear",
    "bicubic": "cubic",
    "area": "linear",   # as the JAX package: jax.image has no 'area'
}
_RESIZE = {"nearest": resize_nearest,
           "linear": resize_linear,
           "cubic": lambda x, shape: resize_bicubic(x, shape, antialias=False)}


class SpatialRescaler(nn.Module):
    """x [b, h, w, c] (or [b, t, h, w, c] with wrap_video) resized n_stages
    times by `multiplier`, then mapped to out_channels by `channel_mapper`
    (a kernel_size conv, SAME padding) when remap_output or out_channels is
    given."""

    def __init__(self, n_stages: int = 1, method: str = "bilinear", multiplier: float = 0.5,
                 in_channels: int = 3, out_channels: Optional[int] = None, bias: bool = False,
                 wrap_video: bool = False, kernel_size: int = 1, remap_output: bool = False):
        super().__init__()
        if method not in _RESIZE_METHOD:
            raise ValueError(f"unknown resize method {method!r}")
        if kernel_size % 2 == 0:
            raise ValueError("channel_mapper takes an odd kernel_size (SAME padding on both sides)")
        self.n_stages, self.method, self.multiplier, self.wrap_video = n_stages, method, multiplier, wrap_video
        self.channel_mapper = None
        if remap_output or out_channels is not None:
            self.channel_mapper = Conv2dNHWC(in_channels, out_channels, kernel_size, padding=kernel_size // 2,
                                             bias=bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        video = self.wrap_video and x.dim() == 5
        if video:
            b, t = x.shape[:2]
            x = x.reshape((b * t,) + x.shape[2:])
        resize = _RESIZE[_RESIZE_METHOD[self.method]]
        for _ in range(self.n_stages):
            h, w = int(x.shape[1] * self.multiplier), int(x.shape[2] * self.multiplier)
            x = resize(x.permute(0, 3, 1, 2), (h, w)).permute(0, 2, 3, 1)
        if self.channel_mapper is not None:
            x = self.channel_mapper(x)
        if video:
            x = x.reshape((b, t) + x.shape[1:])
        return x


@dataclasses.dataclass(frozen=True)
class LowScaleEncoder:
    """VAE-encode, scale, q-sample at a noise level below max_noise_level,
    nearest-resize to out_size; returns (z, noise_level), the level an extra
    condition of the model. `encode_fn`: frames [b, h, w, 3] -> a latent
    sample. The noise level and noise are passed in or drawn from
    `generator`."""

    encode_fn: Callable[[torch.Tensor], torch.Tensor]
    decode_fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
    linear_start: float = 1e-4
    linear_end: float = 2e-2
    timesteps: int = 1000
    max_noise_level: int = 250
    out_size: Optional[int] = 64
    scale_factor: float = 1.0

    def q_sample(self, z: torch.Tensor, t: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
        cumprod = LegacyDDPMDiscretization(self.linear_start, self.linear_end, self.timesteps).alphas_cumprod
        ac = torch.as_tensor(cumprod, dtype=torch.float32, device=z.device)[torch.as_tensor(t).long().to(z.device)]
        shape = (z.shape[0],) + (1,) * (z.dim() - 1)
        return torch.sqrt(ac).reshape(shape) * z + torch.sqrt(1.0 - ac).reshape(shape) * noise

    def __call__(self, x: torch.Tensor, noise_level: Optional[torch.Tensor] = None,
                 noise: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        z = self.encode_fn(x) * self.scale_factor
        gen_device = generator.device if generator is not None else z.device
        if noise_level is None:
            noise_level = torch.randint(0, self.max_noise_level, (x.shape[0],), generator=generator,
                                        device=gen_device)
        if noise is None:
            noise = torch.randn(z.shape, generator=generator, device=gen_device, dtype=z.dtype)
        noise_level = torch.as_tensor(noise_level).to(z.device)
        z = self.q_sample(z, noise_level, torch.as_tensor(noise).to(z.device, z.dtype))
        if self.out_size is not None:
            z = resize_nearest(z.permute(0, 3, 1, 2), (self.out_size, self.out_size)).permute(0, 2, 3, 1)
        return z, noise_level

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        if self.decode_fn is None:
            raise ValueError("LowScaleEncoder.decode needs a decode_fn")
        return self.decode_fn(z / self.scale_factor)


def clip_t5_text_fn(clip_fn: Callable, t5_fn: Callable) -> Callable:
    """FrozenCLIPT5Encoder: both towers on a (clip tokens, t5 tokens) pair;
    the conditioner routes the pair's two outputs and concatenates them on
    the crossattn feature axis, as GeneralConditioner does with the
    reference's returned list."""

    def fn(tokens_pair):
        clip_tokens, t5_tokens = tokens_pair
        return clip_fn(clip_tokens), t5_fn(t5_tokens)

    return fn
