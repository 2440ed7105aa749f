"""The diffusion UNets (PyTorch), channels-last: the SVD video UNet and the
image UNet (SD 2.1, the SDXL base and refiner).

Counterpart of vidseg_diffusion_tpu/models/unet.py: ResBlock, TemporalConv,
TemporalResBlock3D, VideoResBlock and UNetModel with the VidSeg hooks
(per-output-block modulation, injection and the q/k harvest). With
`UNetConfig.video` the blocks are VideoResBlock + SpatialVideoTransformer on
video tensors [(b t), H, W, C], the temporal (kt,1,1) convolutions running on
[b, t, H*W, C] through K4 on CUDA; without it they are plain ResBlock +
SpatialTransformer, every frame an image of the batch, with a class
embedding where adm_in_channels is set (SDXL: 2816 base, 2560 refiner).
`transformer_depth` is one depth or one per level (SDXL [1, 2, 10]; the
middle block takes the last level's). The two 3x3 convolutions of every
ResBlock go through conv3x3_same (K12 on CUDA). The block topology is built from the
config exactly as the reference's constructor loops build it, so module
names are the sgm state-dict keys (input_blocks.{i}.{j}, middle_block,
output_blocks, out).

With `UNetConfig.remat` (the reference's use_checkpoint) each ResBlock and
transformer runs under torch.utils.checkpoint while grad
is enabled: its activations are recomputed in the backward instead of
kept. Inference (no grad) and blocks with VidSeg hooks run as they are.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.profiler import record_function
from torch.utils.checkpoint import checkpoint

from vidseg_diffusion_tpu_torch.models.layers import (
    AlphaBlender,
    Conv2dNHWC,
    Conv3x3NHWC,
    GroupNorm32,
    SpatialTransformer,
    linear,
    timestep_embedding,
)
from vidseg_diffusion_tpu_torch.models.video_layers import (
    SiteInjection,
    SiteModulation,
    SpatialVideoTransformer,
)
from vidseg_diffusion_tpu_torch.ops.temporal_conv import temporal_conv_1x1


@dataclasses.dataclass
class UNetHooks:
    """VidSeg state threaded into one UNet forward. Keys are output-block
    indices. `sow_blocks` lists the output blocks whose attention q/k are
    harvested into `intermediates` as
    intermediates[f"output_blocks_{i}_1"][child][attn]["q" | "k"]."""

    output_mod: Dict[int, SiteModulation] = dataclasses.field(default_factory=dict)
    output_inj: Dict[int, SiteInjection] = dataclasses.field(default_factory=dict)
    sow_blocks: Tuple[int, ...] = ()
    intermediates: Optional[Dict] = None


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    """Static architecture config (the network_config of
    configs/inference/svd.yaml or, with video False, sd_2_1.yaml)."""

    in_channels: int = 8
    out_channels: int = 4
    model_channels: int = 320
    num_res_blocks: int = 2
    attention_resolutions: Tuple[int, ...] = (4, 2, 1)
    channel_mult: Tuple[int, ...] = (1, 2, 4, 4)
    num_head_channels: int = 64
    # int (every level) or one depth per level: SDXL's [1, 2, 10]
    transformer_depth: Union[int, Tuple[int, ...]] = 1
    context_dim: int = 1024
    adm_in_channels: Optional[int] = 768
    video: bool = True
    merge_strategy: str = "learned_with_images"
    merge_factor: float = 0.5
    video_kernel_size: Tuple[int, ...] = (3, 1, 1)
    dtype: torch.dtype = torch.float32
    # per-block activation recompute in the backward (use_checkpoint; the
    # JAX package's nn.remat with the default full-recompute policy)
    remat: bool = False

    def depth_for_level(self, level: int) -> int:
        td = self.transformer_depth
        return td[level] if isinstance(td, (tuple, list)) else td

    def block_layout(self):
        """Per input/output block (kind, ch, ds, attn, ...), reproducing the
        reference's constructor loops (the JAX UNetConfig.block_layout)."""
        ch = self.model_channels
        ds = 1
        input_blocks = [dict(kind="conv_in", ch=ch, ds=ds)]
        input_chans = [ch]
        for level, mult in enumerate(self.channel_mult):
            for _ in range(self.num_res_blocks):
                ch = mult * self.model_channels
                input_blocks.append(
                    dict(kind="res", ch=ch, ds=ds, attn=ds in self.attention_resolutions, level=level)
                )
                input_chans.append(ch)
            if level != len(self.channel_mult) - 1:
                ds *= 2
                input_blocks.append(dict(kind="down", ch=ch, ds=ds))
                input_chans.append(ch)
        middle = dict(ch=ch, ds=ds, level=len(self.channel_mult) - 1)
        output_blocks = []
        for level, mult in list(enumerate(self.channel_mult))[::-1]:
            for i in range(self.num_res_blocks + 1):
                ich = input_chans.pop()
                ch = self.model_channels * mult
                attn = ds in self.attention_resolutions
                up = level > 0 and i == self.num_res_blocks
                if up:
                    ds //= 2
                output_blocks.append(
                    dict(kind="res", ch=ch, skip_ch=ich, ds=ds * (2 if up else 1),
                         attn=attn, up=up, level=level)
                )
        return input_blocks, middle, output_blocks


class TemporalConv(nn.Module):
    """(kt, 1, 1) video convolution with Conv3d parameters [Cout, Cin, kt, 1, 1]
    (the reference's nn.Conv3d), computed by temporal_conv_1x1 (K4 on CUDA,
    which reads a cached K-major copy of the weight) on x [b, t, H, W, C]."""

    def __init__(self, cin: int, cout: int, kernel: Tuple[int, int, int] = (3, 1, 1)):
        super().__init__()
        if tuple(kernel[1:]) != (1, 1) or kernel[0] % 2 == 0:
            raise NotImplementedError(f"temporal conv kernel {kernel}: only (odd, 1, 1)")
        self.weight = nn.Parameter(torch.empty(cout, cin, *kernel))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, h, w, c = x.shape
        with record_function("vs:TemporalConv"):
            y = temporal_conv_1x1(x.reshape(b, t, h * w, c).contiguous(), self.weight, self.bias)
            return y.reshape(b, t, h, w, -1)


class ResBlock(nn.Module):
    """GroupNorm -> SiLU -> conv, timestep-embedding add, GroupNorm -> SiLU ->
    conv, skip (openaimodel.py:220-370); keys in_layers.{0,2},
    emb_layers.1, out_layers.{0,3}, skip_connection."""

    def __init__(self, cin: int, cout: int, emb_dim: int):
        super().__init__()
        self.in_layers = nn.ModuleList([GroupNorm32(cin), nn.SiLU(), Conv3x3NHWC(cin, cout)])
        self.emb_layers = nn.ModuleList([nn.SiLU(), nn.Linear(emb_dim, cout)])
        self.out_layers = nn.ModuleList(
            [GroupNorm32(cout), nn.SiLU(), nn.Identity(), Conv3x3NHWC(cout, cout)]
        )
        self.skip_connection = Conv2dNHWC(cin, cout, 1) if cin != cout else nn.Identity()

    def forward(self, x, emb):
        h = self.in_layers[2](self.in_layers[0](x, silu=True))
        e = linear(F.silu(emb), self.emb_layers[1])
        h = h + e[:, None, None, :]
        h = self.out_layers[3](self.out_layers[0](h, silu=True))
        return self.skip_connection(x) + h


class TemporalResBlock3D(nn.Module):
    """The `time_stack` of VideoResBlock (video_model.py:45-58): a ResBlock
    with (kt,1,1) convolutions over [b, t, H, W, C]; GroupNorm statistics
    span (t, H, W) of each video."""

    def __init__(self, channels: int, emb_dim: int, kernel=(3, 1, 1)):
        super().__init__()
        self.in_layers = nn.ModuleList([GroupNorm32(channels), nn.SiLU(), TemporalConv(channels, channels, kernel)])
        self.emb_layers = nn.ModuleList([nn.SiLU(), nn.Linear(emb_dim, channels)])
        self.out_layers = nn.ModuleList(
            [GroupNorm32(channels), nn.SiLU(), nn.Identity(), TemporalConv(channels, channels, kernel)]
        )

    def forward(self, x, emb):
        # x [b, t, H, W, C]; emb [b, t, E]
        h = self.in_layers[2](self.in_layers[0](x, silu=True))
        e = linear(F.silu(emb), self.emb_layers[1])
        h = h + e[:, :, None, None, :]
        h = self.out_layers[3](self.out_layers[0](h, silu=True))
        return x + h


class VideoResBlock(ResBlock):
    """Spatial ResBlock + temporal ResBlock + learned alpha merge
    (video_model.py:15-89)."""

    def __init__(self, cin, cout, emb_dim, merge_factor=0.5,
                 merge_strategy="learned_with_images", kernel=(3, 1, 1)):
        super().__init__(cin, cout, emb_dim)
        self.time_stack = TemporalResBlock3D(cout, emb_dim, kernel)
        self.time_mixer = AlphaBlender(merge_factor, merge_strategy, broadcast="b_t")

    def forward(self, x, emb, num_video_frames: int, image_only_indicator=None):
        x = super().forward(x, emb)
        bt, h, w, c = x.shape
        t = num_video_frames
        x5 = x.reshape(bt // t, t, h, w, c)
        x_tem = self.time_stack(x5, emb.reshape(bt // t, t, -1))
        return self.time_mixer(x5, x_tem, image_only_indicator).reshape(bt, h, w, c)


class Downsample(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.op = Conv2dNHWC(channels, channels, 3, stride=2, padding=1)

    def forward(self, x):
        return self.op(x)


def nearest_up2(x: torch.Tensor) -> torch.Tensor:
    return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


class Upsample(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = Conv2dNHWC(channels, channels, 3, padding=1)

    def forward(self, x):
        return self.conv(nearest_up2(x))


class UNetModel(nn.Module):
    """The UNet, video or image per config.video: forward(x [(b t), H, W, Cin],
    timesteps [(b t)], context [(b t), Lc, ctx], y [(b t), adm] or None,
    num_video_frames, image_only_indicator [b, t], hooks) -> [(b t), H, W,
    Cout] in x's dtype. The image UNet ignores num_video_frames and
    image_only_indicator."""

    def __init__(self, config: UNetConfig):
        super().__init__()
        self.config = cfg = config
        mc = cfg.model_channels
        emb_dim = mc * 4
        self.time_embed = nn.ModuleList([nn.Linear(mc, emb_dim), nn.SiLU(), nn.Linear(emb_dim, emb_dim)])
        if cfg.adm_in_channels is not None:
            self.label_emb = nn.ModuleList([
                nn.ModuleList([nn.Linear(cfg.adm_in_channels, emb_dim), nn.SiLU(),
                               nn.Linear(emb_dim, emb_dim)])
            ])
        input_layout, middle, output_layout = cfg.block_layout()

        def res(cin, cout):
            if not cfg.video:
                return ResBlock(cin, cout, emb_dim)
            return VideoResBlock(cin, cout, emb_dim, cfg.merge_factor, cfg.merge_strategy,
                                 tuple(cfg.video_kernel_size))

        def attn(ch, level):
            heads = ch // cfg.num_head_channels
            depth = cfg.depth_for_level(level)
            if not cfg.video:
                return SpatialTransformer(ch, heads, cfg.num_head_channels, cfg.context_dim, depth=depth)
            return SpatialVideoTransformer(
                ch, heads, cfg.num_head_channels, cfg.context_dim,
                depth=depth, merge_factor=cfg.merge_factor,
                merge_strategy=cfg.merge_strategy,
            )

        self.input_blocks = nn.ModuleList()
        ch = mc
        for spec in input_layout:
            if spec["kind"] == "conv_in":
                mods = [Conv2dNHWC(cfg.in_channels, mc, 3, padding=1)]
            elif spec["kind"] == "down":
                mods = [Downsample(ch)]
            else:
                mods = [res(ch, spec["ch"])]
                ch = spec["ch"]
                if spec.get("attn"):
                    mods.append(attn(ch, spec["level"]))
            self.input_blocks.append(nn.ModuleList(mods))
        # the middle block takes the last level's depth
        self.middle_block = nn.ModuleList([res(ch, ch), attn(ch, middle["level"]), res(ch, ch)])
        self.output_blocks = nn.ModuleList()
        for spec in output_layout:
            mods = [res(ch + spec["skip_ch"], spec["ch"])]
            ch = spec["ch"]
            if spec.get("attn"):
                mods.append(attn(ch, spec["level"]))
            if spec.get("up"):
                mods.append(Upsample(ch))
            self.output_blocks.append(nn.ModuleList(mods))
        self.out = nn.ModuleList([GroupNorm32(ch), nn.SiLU(), Conv2dNHWC(ch, cfg.out_channels, 3, padding=1)])

    def forward(self, x, timesteps, context=None, y=None, num_video_frames: int = 1,
                image_only_indicator=None, hooks: Optional[UNetHooks] = None):
        cfg = self.config
        dt = cfg.dtype
        hooks = hooks if hooks is not None else UNetHooks()
        t_emb = timestep_embedding(timesteps, cfg.model_channels).to(dt)
        emb = linear(F.silu(linear(t_emb, self.time_embed[0])), self.time_embed[2])
        if y is not None:
            le = self.label_emb[0]
            emb = emb + linear(F.silu(linear(y.to(dt), le[0])), le[2])
        if context is not None:
            context = context.to(dt)
        t = num_video_frames
        remat = cfg.remat and torch.is_grad_enabled()

        def call(m, *args):
            if remat:
                return checkpoint(m, *args, use_reentrant=False)
            return m(*args)

        def run_block(mods, h, mod=None, inj=None, sow=None):
            for m in mods:
                if isinstance(m, VideoResBlock):
                    h = call(m, h, emb, t, image_only_indicator)
                elif isinstance(m, SpatialVideoTransformer):
                    if mod is None and inj is None and sow is None:
                        h = call(m, h, context, t, image_only_indicator)
                    else:
                        h = m(h, context, t, image_only_indicator, mod, inj, sow)
                elif isinstance(m, ResBlock):
                    h = call(m, h, emb)
                elif isinstance(m, SpatialTransformer):
                    if mod is None and inj is None and sow is None:
                        h = call(m, h, context)
                    else:
                        h = m(h, context, mod.spatial if mod is not None else None,
                              inj.spatial if inj is not None else None, sow)
                else:
                    h = m(h)
            return h

        hs = []
        h = x.to(dt)
        for mods in self.input_blocks:
            h = run_block(mods, h)
            hs.append(h)
        h = run_block(self.middle_block, h)
        for i, mods in enumerate(self.output_blocks):
            h = torch.cat([h, hs.pop()], dim=-1)
            sow = None
            if hooks.intermediates is not None and i in hooks.sow_blocks:
                sow = hooks.intermediates.setdefault(f"output_blocks_{i}_1", {})
            h = run_block(mods, h, hooks.output_mod.get(i), hooks.output_inj.get(i), sow)
        h = self.out[2](self.out[0](h, silu=True))
        return h.to(x.dtype)
