"""The full-width SVD diffusion training step that chip_smoke.py checks and
profile_train.py profiles, defined once so both see the same work.

Counterpart of scripts/tests/train_bench.py::build_train with n_videos=2
(the BENCH_TRAIN.json setting): the configs/inference/svd.yaml VideoUNet
(1.52 B parameters, model_channels 320, channel_mult 1,2,4,4, 64-dim heads)
in bf16 with remat on, random N(0, 0.02) weights from a seed; a UNet batch
of 2 videos x 14 frames of [56, 104, 4] swan-shape latents with the concat
conditioning [28, 56, 104, 4] joined on the channel axis (8 input
channels), crossattn [28, 1, 1024], vector [28, 768];
StandardDiffusionLoss(Denoiser(VScalingWithEDMcNoise()), EDMSigmaSampling()),
l2, unit weighting; torch.optim.Adam and an EMA of the weights.
"""

import dataclasses
import os

import torch

from vidseg_diffusion_tpu_torch.config import load_model_spec
from vidseg_diffusion_tpu_torch.diffusion.denoiser import Denoiser
from vidseg_diffusion_tpu_torch.diffusion.loss import EDMSigmaSampling, StandardDiffusionLoss
from vidseg_diffusion_tpu_torch.diffusion.scaling import VScalingWithEDMcNoise
from vidseg_diffusion_tpu_torch.engine.train import DiffusionTrainStep
from vidseg_diffusion_tpu_torch.models.unet import UNetModel

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
NUM_FRAMES, HEIGHT, WIDTH, N_VIDEOS = 14, 56, 104, 2
LR = 1e-4
INIT_STD = 0.02
DEVICE = "cuda"
WEIGHT_SEED, BATCH_SEED, LOSS_SEED = 0, 7, 11


def unet_config(dtype=torch.bfloat16, num_frames=NUM_FRAMES):
    """svd.yaml's UNet with remat on."""
    spec = load_model_spec(os.path.join(ROOT, "configs/inference/svd.yaml"),
                           num_frames=num_frames, dtype=dtype)
    return dataclasses.replace(spec.unet_config, remat=True)


@torch.no_grad()
def init_normal_(module: torch.nn.Module, generator: torch.Generator) -> None:
    """Every parameter N(0, INIT_STD), as build_train's synth fills the tree."""
    for p in module.parameters():
        p.copy_(torch.randn(p.shape, generator=generator, device=generator.device) * INIT_STD)


def network_factory(num_frames: int):
    """model -> network(x, c_noise, cond) -> (out, None): the concat
    conditioning joined on the channel axis, no image-only frames."""

    def factory(unet):
        def network(x, c_noise, cond):
            x = torch.cat([x, cond["concat"].to(x.dtype)], dim=-1)
            ioi = torch.zeros(x.shape[0] // num_frames, num_frames, device=x.device)
            out = unet(x, c_noise, cond["crossattn"], cond["vector"], num_video_frames=num_frames,
                       image_only_indicator=ioi)
            return out, None

        return network

    return factory


def loss_module() -> StandardDiffusionLoss:
    return StandardDiffusionLoss(Denoiser(VScalingWithEDMcNoise()), EDMSigmaSampling())


def build(fsdp: bool = False) -> DiffusionTrainStep:
    """The trainer: bf16 UNet with random N(0, INIT_STD) weights, Adam, EMA.
    With `fsdp` the UNet is sharded over the default process group
    (parallel/fsdp.py::fsdp_wrap) before the optimizer and the EMA are made
    over its parameters, and each rank steps on its share of the videos
    (FSDPTrainStep)."""
    with torch.device(DEVICE):
        unet = UNetModel(unet_config())
    unet.to(torch.bfloat16)
    init_normal_(unet, torch.Generator(device=DEVICE).manual_seed(WEIGHT_SEED))
    opt = lambda: torch.optim.Adam(unet.parameters(), lr=LR)
    if not fsdp:
        return DiffusionTrainStep(unet, network_factory(NUM_FRAMES), loss_module(), opt())
    from vidseg_diffusion_tpu_torch.parallel.fsdp import FSDPTrainStep, fsdp_wrap

    fsdp_wrap(unet)
    return FSDPTrainStep(unet, network_factory(NUM_FRAMES), loss_module(), opt(), unit=NUM_FRAMES)


def batch(n_videos: int = N_VIDEOS):
    """(latents [n_videos x 14, 56, 104, 4], cond) in bf16 from a seed."""
    g = torch.Generator(device=DEVICE).manual_seed(BATCH_SEED)
    n = n_videos * NUM_FRAMES
    rn = lambda *shape: torch.randn(*shape, generator=g, device=DEVICE).to(torch.bfloat16)
    latents = rn(n, HEIGHT, WIDTH, 4)
    cond = {"crossattn": rn(n, 1, 1024), "vector": rn(n, 768), "concat": rn(n, HEIGHT, WIDTH, 4)}
    return latents, cond


def generators():
    """One generator per random site of the loss: (sigma draw, noise draw)."""
    return (torch.Generator(device=DEVICE).manual_seed(LOSS_SEED),
            torch.Generator(device=DEVICE).manual_seed(LOSS_SEED + 1))
