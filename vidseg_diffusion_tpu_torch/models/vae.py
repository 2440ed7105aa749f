"""VAE encoder and decoders, channels-last (PyTorch).

Counterpart of vidseg_diffusion_tpu/models/vae.py: Encoder; Decoder, either
the image decoder (SD 2.1: VAEResnetBlocks, no time mix) or, with
`video_decoder`, the SVD VideoDecoder in time_mode 'conv-only' (every
ResnetBlock gains a (3,1,1) temporal ResBlock with a learned alpha merge,
and conv_out a temporal mix conv); AttnBlock (single-head attention over
the latent's tokens: K3 on CUDA) and gaussian_sample. Module names are the
sgm keys (down.{i}.block.{j}, mid.attn_1, up.{i}.upsample, conv_out.time_mix_conv).
The 'all' / 'attn-only' time modes (VideoAttnBlock) are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from vidseg_diffusion_tpu_torch.models.layers import Conv2dNHWC, GroupNorm32
from vidseg_diffusion_tpu_torch.models.unet import TemporalConv, nearest_up2
from vidseg_diffusion_tpu_torch.ops.attention import dot_product_attention


def _norm(c: int) -> GroupNorm32:
    return GroupNorm32(c, eps=1e-6)


class VAEResnetBlock(nn.Module):
    """norm -> swish -> conv, twice, with a 1x1 nin shortcut (model.py:94-151)."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.norm1 = _norm(cin)
        self.conv1 = Conv2dNHWC(cin, cout, 3, padding=1)
        self.norm2 = _norm(cout)
        self.conv2 = Conv2dNHWC(cout, cout, 3, padding=1)
        if cin != cout:
            self.nin_shortcut = Conv2dNHWC(cin, cout, 1)

    def forward(self, x):
        h = self.conv1(self.norm1(x, silu=True))
        h = self.conv2(self.norm2(h, silu=True))
        if hasattr(self, "nin_shortcut"):
            x = self.nin_shortcut(x)
        return x + h


class TemporalResnetBlock3D(nn.Module):
    """time_stack of temporal_ae.VideoResBlock (skip_t_emb): two (3,1,1)
    convolutions over [b, t, H, W, C]; keys in_layers.{0,2}, out_layers.{0,3}."""

    def __init__(self, channels: int, kernel=(3, 1, 1)):
        super().__init__()
        self.in_layers = nn.ModuleList([_norm(channels), nn.SiLU(), TemporalConv(channels, channels, kernel)])
        self.out_layers = nn.ModuleList(
            [_norm(channels), nn.SiLU(), nn.Identity(), TemporalConv(channels, channels, kernel)]
        )

    def forward(self, x):
        h = self.in_layers[2](self.in_layers[0](x, silu=True))
        h = self.out_layers[3](self.out_layers[0](h, silu=True))
        return x + h


class VideoVAEResnetBlock(VAEResnetBlock):
    """VAEResnetBlock + temporal ResBlock + learned merge
    (temporal_ae.py:18-83, merge_strategy 'learned', alpha 0)."""

    def __init__(self, cin: int, cout: int, kernel=(3, 1, 1), alpha: float = 0.0):
        super().__init__(cin, cout)
        self.time_stack = TemporalResnetBlock3D(cout, kernel)
        self.mix_factor = nn.Parameter(torch.full((1,), float(alpha)))

    def forward(self, x, timesteps: int):
        x = super().forward(x)
        bt, h, w, c = x.shape
        x5 = x.reshape(bt // timesteps, timesteps, h, w, c)
        x_tem = self.time_stack(x5)
        a = torch.sigmoid(self.mix_factor.float()).to(x.dtype)
        return (a * x_tem + (1.0 - a) * x5).reshape(bt, h, w, c)


class AttnBlock(nn.Module):
    """Single-head self-attention over the tokens (model.py:161-203)."""

    def __init__(self, c: int):
        super().__init__()
        self.norm = _norm(c)
        self.q = Conv2dNHWC(c, c, 1)
        self.k = Conv2dNHWC(c, c, 1)
        self.v = Conv2dNHWC(c, c, 1)
        self.proj_out = Conv2dNHWC(c, c, 1)

    def forward(self, x):
        b, h, w, c = x.shape
        hn = self.norm(x)
        q, k, v = (m(hn).reshape(b, 1, h * w, c) for m in (self.q, self.k, self.v))
        out = dot_product_attention(q, k, v).reshape(b, h, w, c)
        return x + self.proj_out(out)


class VAEDownsample(nn.Module):
    """Asymmetric-padded stride-2 conv (model.py:74-91)."""

    def __init__(self, c: int):
        super().__init__()
        self.conv = Conv2dNHWC(c, c, 3, stride=2, padding=0)

    def forward(self, x):
        return self.conv(F.pad(x, (0, 0, 0, 1, 0, 1)))


class VAEUpsample(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.conv = Conv2dNHWC(c, c, 3, padding=1)

    def forward(self, x):
        return self.conv(nearest_up2(x))


class AE3DConv(Conv2dNHWC):
    """Spatial conv followed by a temporal mix conv (temporal_ae.py:86-108)."""

    def __init__(self, cin: int, cout: int, kernel=(3, 1, 1)):
        super().__init__(cin, cout, 3, padding=1)
        self.time_mix_conv = TemporalConv(cout, cout, kernel)

    def forward(self, x, timesteps: int):
        y = super().forward(x)
        bt, h, w, c = y.shape
        return self.time_mix_conv(y.reshape(bt // timesteps, timesteps, h, w, c)).reshape(bt, h, w, c)


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    ch: int = 128
    out_ch: int = 3
    in_channels: int = 3
    z_channels: int = 4
    ch_mult: Tuple[int, ...] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    double_z: bool = True
    video_decoder: bool = False
    video_kernel_size: Tuple[int, ...] = (3, 1, 1)
    time_mode: str = "conv-only"
    dtype: torch.dtype = torch.float32


class _Mid(nn.Module):
    def __init__(self, block_1, attn_1, block_2):
        super().__init__()
        self.block_1, self.attn_1, self.block_2 = block_1, attn_1, block_2


class Encoder(nn.Module):
    """x [B, H, W, 3] -> moments [B, H/8, W/8, 2z] (model.py:487-602)."""

    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.config = cfg
        self.conv_in = Conv2dNHWC(cfg.in_channels, cfg.ch, 3, padding=1)
        self.down = nn.ModuleList()
        cin = cfg.ch
        for i_level, mult in enumerate(cfg.ch_mult):
            level = nn.Module()
            blocks = []
            for _ in range(cfg.num_res_blocks):
                blocks.append(VAEResnetBlock(cin, cfg.ch * mult))
                cin = cfg.ch * mult
            level.block = nn.ModuleList(blocks)
            if i_level != len(cfg.ch_mult) - 1:
                level.downsample = VAEDownsample(cin)
            self.down.append(level)
        self.mid = _Mid(VAEResnetBlock(cin, cin), AttnBlock(cin), VAEResnetBlock(cin, cin))
        self.norm_out = _norm(cin)
        out_c = 2 * cfg.z_channels if cfg.double_z else cfg.z_channels
        self.conv_out = Conv2dNHWC(cin, out_c, 3, padding=1)

    def forward(self, x):
        h = self.conv_in(x.to(self.config.dtype))
        for level in self.down:
            for block in level.block:
                h = block(h)
            if hasattr(level, "downsample"):
                h = level.downsample(h)
        h = self.mid.block_2(self.mid.attn_1(self.mid.block_1(h)))
        return self.conv_out(self.norm_out(h, silu=True))


class Decoder(nn.Module):
    """z [B, h, w, z] -> x [B, 8h, 8w, 3] (model.py:604-748). The image
    decoder treats the batch as images; with `video_decoder` it is the SVD
    VideoDecoder, time_mode 'conv-only' (temporal_ae.py:293-349), the batch
    being one video of `timesteps` frames."""

    def __init__(self, cfg: VAEConfig):
        super().__init__()
        if cfg.video_decoder and cfg.time_mode != "conv-only":
            raise NotImplementedError(
                "of the VideoDecoder only time_mode 'conv-only' is ported ('all' / 'attn-only' "
                "need VideoAttnBlock, a ROADMAP Queue A item)"
            )
        self.config = cfg
        kernel = tuple(cfg.video_kernel_size)
        block_in = cfg.ch * cfg.ch_mult[-1]

        def res(cin, cout):
            return VideoVAEResnetBlock(cin, cout, kernel) if cfg.video_decoder else VAEResnetBlock(cin, cout)

        self.conv_in = Conv2dNHWC(cfg.z_channels, block_in, 3, padding=1)
        self.mid = _Mid(res(block_in, block_in), AttnBlock(block_in), res(block_in, block_in))
        levels = [None] * len(cfg.ch_mult)
        cin = block_in
        for i_level in reversed(range(len(cfg.ch_mult))):
            level = nn.Module()
            cout = cfg.ch * cfg.ch_mult[i_level]
            blocks = []
            for _ in range(cfg.num_res_blocks + 1):
                blocks.append(res(cin, cout))
                cin = cout
            level.block = nn.ModuleList(blocks)
            if i_level != 0:
                level.upsample = VAEUpsample(cin)
            levels[i_level] = level
        self.up = nn.ModuleList(levels)
        self.norm_out = _norm(cin)
        self.conv_out = (AE3DConv(cin, cfg.out_ch, kernel) if cfg.video_decoder
                         else Conv2dNHWC(cin, cfg.out_ch, 3, padding=1))

    def forward(self, z, timesteps: int = 1):
        t = (timesteps,) if self.config.video_decoder else ()
        h = self.conv_in(z.to(self.config.dtype))
        h = self.mid.block_2(self.mid.attn_1(self.mid.block_1(h, *t)), *t)
        for i_level in reversed(range(len(self.up))):
            level = self.up[i_level]
            for block in level.block:
                h = block(h, *t)
            if hasattr(level, "upsample"):
                h = level.upsample(h)
        return self.conv_out(self.norm_out(h, silu=True), *t)


def gaussian_sample(moments: torch.Tensor) -> torch.Tensor:
    """Mode of the DiagonalGaussianDistribution in moments [..., 2z]
    (AutoencoderKLModeOnly, the SVD first stage and cond-frame encoder)."""
    return moments.chunk(2, dim=-1)[0]
