"""The full-width autoencoder training steps that chip_smoke.py checks and
profile_train.py --autoencoder profiles, defined once so both see the same work.

The configs/inference/sd_2_1.yaml first stage at full width, nothing cut
(AutoencoderKL: ch 128, ch_mult 1,2,4,4, 2 res blocks, z 4, double_z, the
1x1 quant / post_quant convs, the image Decoder), or svd.yaml's own
(svd_vae_config: the same Encoder, no quant convs, the temporal VideoDecoder
with video_kernel_size [3,1,1] at its time_mode, conv-only as shipped) in bf16 with random weights
from a seed (the pipeline's randomize_); the losses of
engine/train.py::AutoencoderTrainStep: LPIPS (VGG16 trunk and linear heads
He-normal from a seed, the heads non-negative as trained ones are: N(0, 0.02)
would let the 13-layer ReLU trunk die and the perceptual term carry no
signal) and NLayerDiscriminator(ndf=64, n_layers=3) (the JAX defaults;
weights as sgm's weights_init: convs N(0, 0.02), norm scales N(1, 0.02));
AutoencoderLossConfig's defaults but disc_start=0, so both phases carry the
adversarial term from the first step; torch.optim.Adam for both phases.
The batch: 2 synthetic frames of 448x832 (the main path's frame size), so
each mid attention is [2, 1, 5824, 512]; for svd.yaml's first stage one clip
of SVD_FRAMES = 7 frames of 448x832 (the main path's decoding_t: the frames
the VideoDecoder's temporal layers see), the mid attentions [7, 1, 5824, 512]
and, at 'all' / 'attn-only', the VideoAttnBlock's [7, 5824, 1 x 512] (attn2)
and [7, 5824, 1, 512] at t = 7 (the time mix).
"""

import dataclasses
import os
from typing import Optional, Tuple

import torch

from vidseg_diffusion_tpu_torch.config import load_model_spec
from vidseg_diffusion_tpu_torch.engine.build import randomize_
from vidseg_diffusion_tpu_torch.engine.diffusion_engine import FirstStage
from vidseg_diffusion_tpu_torch.engine.train import AutoencoderTrainStep
from vidseg_diffusion_tpu_torch.models.layers import Conv2dNHWC
from vidseg_diffusion_tpu_torch.models.lpips import LPIPS, AutoencoderLossConfig, NLayerDiscriminator
from vidseg_diffusion_tpu_torch.models.vae import Decoder, Encoder, VAEConfig

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
N_FRAMES, HEIGHT, WIDTH = 2, 448, 832
SVD_FRAMES = 7
LR = 1e-4
DEVICE = "cuda"
WEIGHT_SEED, LOSS_SEED, BATCH_SEED, NOISE_SEED = 0, 1, 7, 11
LOSS_CONFIG = AutoencoderLossConfig(disc_start=0)


def vae_config(dtype=torch.bfloat16) -> VAEConfig:
    """sd_2_1.yaml's first stage."""
    return load_model_spec(os.path.join(ROOT, "configs/inference/sd_2_1.yaml"), dtype=dtype).vae_config


def svd_vae_config(time_mode: str = "conv-only", dtype=torch.bfloat16) -> VAEConfig:
    """svd.yaml's first stage, its VideoDecoder at `time_mode`."""
    cfg = load_model_spec(os.path.join(ROOT, "configs/inference/svd.yaml"), dtype=dtype).vae_config
    return dataclasses.replace(cfg, time_mode=time_mode)


@torch.no_grad()
def init_loss_modules_(lpips: LPIPS, disc: NLayerDiscriminator, generator: torch.Generator) -> None:
    """LPIPS He-normal (heads non-negative), biases 0; the discriminator as
    sgm's weights_init."""
    rn = lambda p: torch.randn(p.shape, generator=generator, device=generator.device)
    for name, p in lpips.named_parameters():
        if p.dim() == 1:
            p.zero_()
        else:
            w = rn(p) * (2.0 / p[0].numel()) ** 0.5
            p.copy_(w.abs() if name.startswith("lin_") else w)
    for name, p in disc.named_parameters():
        if name.startswith("norm"):
            p.copy_(1.0 + 0.02 * rn(p) if name.endswith("weight") else torch.zeros_like(p))
        else:
            p.copy_(0.02 * rn(p))


def build(device: str = DEVICE, vae: Optional[VAEConfig] = None) -> Tuple[AutoencoderTrainStep, FirstStage]:
    """The trainer and the first stage it trains (`vae`: sd_2_1.yaml's in
    bf16 unless given; its dtype is the loss modules' too). An image decoder
    comes with the AutoencoderKL's 1x1 quant / post_quant convs, a video
    decoder (svd_vae_config) without, as svd.yaml's AutoencodingEngine; the
    video decoder sees the batch as one clip."""
    vae = vae or vae_config()
    z = vae.z_channels
    with torch.device(device):
        enc, dec = Encoder(vae), Decoder(vae)
        quant = post_quant = None
        if not vae.video_decoder:
            quant = Conv2dNHWC(2 * z if vae.double_z else z, 2 * z if vae.double_z else z, 1)
            post_quant = Conv2dNHWC(z, z, 1)
        lpips, disc = LPIPS(), NLayerDiscriminator(ndf=64, n_layers=3)
    gen = torch.Generator(device=device)
    for i, m in enumerate((enc, dec, quant, post_quant)):
        if m is not None:
            randomize_(m, gen.manual_seed(WEIGHT_SEED * 1000 + i + 1))
    init_loss_modules_(lpips, disc, gen.manual_seed(LOSS_SEED))
    for m in (enc, dec, quant, post_quant, lpips, disc):
        if m is not None:
            m.to(vae.dtype)
    lpips.eval().requires_grad_(False)
    fs = FirstStage(enc, dec, quant_conv=quant, post_quant_conv=post_quant)
    trainer = AutoencoderTrainStep(
        fs.moments, fs.reconstruct, disc, lpips,
        torch.optim.Adam(fs.modules().parameters(), lr=LR), torch.optim.Adam(disc.parameters(), lr=LR),
        LOSS_CONFIG)
    return trainer, fs


def batch(device: str = DEVICE, dtype=torch.bfloat16, height: int = HEIGHT, width: int = WIDTH,
          frames: int = N_FRAMES) -> torch.Tensor:
    """`frames` frames [N, height, width, 3] in [-1, 1] from a seed."""
    g = torch.Generator(device=device).manual_seed(BATCH_SEED)
    return (torch.rand(frames, height, width, 3, generator=g, device=device) * 2 - 1).to(dtype)


def noise_generator(device: str = DEVICE) -> torch.Generator:
    """The posterior sample's draw."""
    return torch.Generator(device=device).manual_seed(NOISE_SEED)
