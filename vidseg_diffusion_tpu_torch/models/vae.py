"""VAE encoder and decoders, channels-last (PyTorch).

Counterpart of vidseg_diffusion_tpu/models/vae.py: Encoder; Decoder, either
the image decoder (SD 2.1: VAEResnetBlocks, no time mix) or, with
`video_decoder`, the SVD VideoDecoder in its three time modes: 'conv-only'
(svd.yaml's: every ResnetBlock gains a (3,1,1) temporal ResBlock with a
learned alpha merge, and conv_out a temporal mix conv), 'all' (that, and the
mid attention a VideoAttnBlock) and 'attn-only' (plain ResnetBlocks and
conv_out, the mid attention a VideoAttnBlock); AttnBlock (single-head
attention over the latent's tokens: K3 on CUDA), VideoAttnBlock (AttnBlock's
attention, then a one-head VideoTransformerBlock over a frame-position
embedding: K2 and K1 at one 512-dim head on CUDA) and gaussian_sample.
Module names are the sgm keys (down.{i}.block.{j}, mid.attn_1,
mid.attn_1.time_mix_block, mid.attn_1.video_time_embed.{0,2}, up.{i}.upsample,
conv_out.time_mix_conv).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from vidseg_diffusion_tpu_torch.models.layers import Conv2dNHWC, GroupNorm32, linear, timestep_embedding
from vidseg_diffusion_tpu_torch.models.unet import TemporalConv, nearest_up2
from vidseg_diffusion_tpu_torch.models.video_layers import VideoTransformerBlock
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

    def attend(self, x):
        """The single-head attention over the tokens of each image: [B, H, W, C]
        -> [B, H*W, C] (before proj_out)."""
        b, h, w, c = x.shape
        hn = self.norm(x)
        # the projections come out channels-last (no copy); a convolution
        # without cuDNN returns them NCHW, which K3 cannot read in place
        q, k, v = (m(hn).reshape(b, 1, h * w, c).contiguous() for m in (self.q, self.k, self.v))
        return dot_product_attention(q, k, v).reshape(b, h * w, c)

    def forward(self, x):
        return x + self.proj_out(self.attend(x).reshape(x.shape))


class VideoAttnBlock(AttnBlock):
    """Spatio-temporal VAE attention of the VideoDecoder's 'all' and
    'attn-only' time modes (JAX vae.py:116-148, temporal_ae.py VideoBlock
    :110-177): AttnBlock's attention, then the sinusoidal frame-position
    embedding through video_time_embed.{0,2}, a one-head VideoTransformerBlock
    (dim_head = C, ff_in, no context: attn2 attends over the tokens of each
    frame in the direct layout, as JAX does), the sigmoid(mix_factor) merge,
    proj_out and the residual."""

    def __init__(self, c: int):
        super().__init__(c)
        self.time_mix_block = VideoTransformerBlock(c, 1, c, context_dim=None)
        self.video_time_embed = nn.ModuleList([nn.Linear(c, 4 * c), nn.SiLU(), nn.Linear(4 * c, c)])
        self.mix_factor = nn.Parameter(torch.zeros(1))

    def forward(self, x, timesteps: int):
        bt, h, w, c = x.shape
        att = self.attend(x)
        frame_ids = torch.arange(timesteps, device=x.device).repeat(bt // timesteps)
        emb = linear(timestep_embedding(frame_ids, c).to(att.dtype), self.video_time_embed[0])
        emb = linear(F.silu(emb), self.video_time_embed[2])
        x_mix = self.time_mix_block(att + emb[:, None, :], None, timesteps)
        a = torch.sigmoid(self.mix_factor.float()).to(att.dtype)
        merged = a * att + (1.0 - a) * x_mix
        return x + self.proj_out(merged.reshape(bt, h, w, c))


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


TIME_MODES = ("conv-only", "all", "attn-only")


class Decoder(nn.Module):
    """z [B, h, w, z] -> x [B, 8h, 8w, 3] (model.py:604-748). The image
    decoder treats the batch as images; with `video_decoder` it is the SVD
    VideoDecoder (temporal_ae.py:293-349, JAX vae.py:224-277), the batch
    being one video of `timesteps` frames: time_mode 'conv-only' and 'all'
    hold video ResnetBlocks and conv_out's temporal mix conv, 'all' and
    'attn-only' a VideoAttnBlock as the mid attention."""

    def __init__(self, cfg: VAEConfig):
        super().__init__()
        if cfg.time_mode not in TIME_MODES:
            raise ValueError(f"time_mode {cfg.time_mode!r} not in {TIME_MODES}")
        self.config = cfg
        kernel = tuple(cfg.video_kernel_size)
        block_in = cfg.ch * cfg.ch_mult[-1]
        self.time_res = cfg.video_decoder and cfg.time_mode != "attn-only"
        self.time_attn = cfg.video_decoder and cfg.time_mode in ("all", "attn-only")

        def res(cin, cout):
            return VideoVAEResnetBlock(cin, cout, kernel) if self.time_res else VAEResnetBlock(cin, cout)

        self.conv_in = Conv2dNHWC(cfg.z_channels, block_in, 3, padding=1)
        attn = VideoAttnBlock(block_in) if self.time_attn else AttnBlock(block_in)
        self.mid = _Mid(res(block_in, block_in), attn, res(block_in, block_in))
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
        self.conv_out = (AE3DConv(cin, cfg.out_ch, kernel) if self.time_res
                         else Conv2dNHWC(cin, cfg.out_ch, 3, padding=1))

    def forward(self, z, timesteps: int = 1):
        t = (timesteps,) if self.time_res else ()
        h = self.conv_in(z.to(self.config.dtype))
        h = self.mid.block_1(h, *t)
        h = self.mid.attn_1(h, timesteps) if self.time_attn else self.mid.attn_1(h)
        h = self.mid.block_2(h, *t)
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
