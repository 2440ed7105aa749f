"""LPIPS perceptual loss and the PatchGAN discriminator, channels-last
(PyTorch): the losses of autoencoder training.

Counterpart of vidseg_diffusion_tpu/models/lpips.py (the reference's
lpips/loss/lpips.py VGG16 LPIPS and discriminator_loss.py's
GeneralLPIPSWithDiscriminator with the NLayerDiscriminator and the hinge /
vanilla losses). The convolutions are library convolutions, as JAX's nn.Conv
are: no Pallas kernel runs here. Module names are the flax module names
(vgg.conv_{i}, lin_{i}; conv0, conv{i}, norm{i}, conv_out), which
io/convert.py's module_key_fn maps; the JAX package loads no
checkpoint into these modules either.

Three places where the JAX modules differ from a plain torch transcription,
and the port follows JAX:
- flax's "SAME" padding is asymmetric for the stride-1 4x4 convolutions
  (conv{n_layers}, conv_out: 1 before, 2 after) and for a stride-2 4x4
  convolution of an odd input;
- nn.GroupNorm(group_size=1) (one channel per group) uses eps 1e-6;
- _normalize_tensor puts its eps inside the square root.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from vidseg_diffusion_tpu_torch.models.layers import Conv2dNHWC

_VGG16_CFG = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
              512, 512, 512, "M", 512, 512, 512, "M")
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


def _same_pad(size: int, k: int, s: int) -> Tuple[int, int]:
    """flax/XLA "SAME": output ceil(size / s), the padding split low-first."""
    total = max((-(-size // s) - 1) * s + k - size, 0)
    return total // 2, total - total // 2


class SameConv(Conv2dNHWC):
    """Conv2dNHWC with flax's "SAME" padding, asymmetric where flax's is."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1, bias: bool = True):
        super().__init__(cin, cout, k, stride=stride, padding=0, bias=bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k, s = self.kernel_size[0], self.stride[0]
        (ht, hb), (wl, wr) = _same_pad(x.shape[1], k, s), _same_pad(x.shape[2], k, s)
        return super().forward(F.pad(x, (0, 0, wl, wr, ht, hb)))


class VGG16Features(nn.Module):
    """The VGG16 conv trunk; returns the five LPIPS taps (relu1_2, relu2_2,
    relu3_3, relu4_3, relu5_3: the activations before each max-pool)."""

    def __init__(self):
        super().__init__()
        cin, i = 3, 0
        for c in _VGG16_CFG:
            if c != "M":
                self.add_module(f"conv_{i}", Conv2dNHWC(cin, c, 3, padding=1))
                cin, i = c, i + 1

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        taps, i = [], 0
        for c in _VGG16_CFG[:-1]:  # the last max-pool feeds nothing
            if c == "M":
                taps.append(x)
                x = F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)
            else:
                x = F.relu(getattr(self, f"conv_{i}")(x))
                i += 1
        return (*taps, x)


def _normalize_tensor(x: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    return x / torch.sqrt((x ** 2).sum(dim=-1, keepdim=True) + eps)


class LPIPS(nn.Module):
    """Learned perceptual distance: unit-normalized VGG feature differences
    through 1x1 linear heads, averaged over space and summed over the taps.
    Computes in the dtype of its weights."""

    def __init__(self):
        super().__init__()
        self.vgg = VGG16Features()
        for i, c in enumerate((64, 128, 256, 512, 512)):
            self.add_module(f"lin_{i}", Conv2dNHWC(c, 1, 1, bias=False))
        self.register_buffer("shift", torch.tensor(_SHIFT), persistent=False)
        self.register_buffer("scale", torch.tensor(_SCALE), persistent=False)

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """x, y: [B, H, W, 3] in [-1, 1] -> [B] distances."""
        dtype = self.vgg.conv_0.weight.dtype
        scale = lambda t: ((t.float() - self.shift.float()) / self.scale.float()).to(dtype)
        fx, fy = self.vgg(scale(x)), self.vgg(scale(y))
        total = 0.0
        for i, (a, b) in enumerate(zip(fx, fy)):
            d = (_normalize_tensor(a) - _normalize_tensor(b)) ** 2
            total = total + getattr(self, f"lin_{i}")(d).mean(dim=(1, 2, 3))
        return total


class InstanceGroupNorm(nn.Module):
    """nn.GroupNorm(group_size=1) of flax on channels-last input: one channel
    per group, eps 1e-6, a scale and a bias (the library op: JAX runs no
    Pallas kernel here)."""

    def __init__(self, channels: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.group_norm(x.permute(0, 3, 1, 2), x.shape[-1], self.weight.to(x.dtype),
                         self.bias.to(x.dtype), self.eps)
        return y.permute(0, 2, 3, 1)


class NLayerDiscriminator(nn.Module):
    """PatchGAN discriminator (discriminator_loss.py's actnorm-free config):
    [B, H, W, 3] -> patch logits [B, h, w, 1]."""

    def __init__(self, ndf: int = 64, n_layers: int = 3, in_channels: int = 3):
        super().__init__()
        self.n_layers = n_layers
        self.conv0 = SameConv(in_channels, ndf, 4, stride=2)
        cin = ndf
        for i in range(1, n_layers + 1):
            cout = ndf * min(2 ** i, 8)
            self.add_module(f"conv{i}", SameConv(cin, cout, 4, stride=2 if i < n_layers else 1, bias=False))
            self.add_module(f"norm{i}", InstanceGroupNorm(cout))
            cin = cout
        self.conv_out = SameConv(cin, 1, 4)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.leaky_relu(self.conv0(x), 0.2)
        for i in range(1, self.n_layers + 1):
            h = F.leaky_relu(getattr(self, f"norm{i}")(getattr(self, f"conv{i}")(h)), 0.2)
        return self.conv_out(h)


def hinge_d_loss(logits_real: torch.Tensor, logits_fake: torch.Tensor) -> torch.Tensor:
    return 0.5 * (F.relu(1.0 - logits_real).mean() + F.relu(1.0 + logits_fake).mean())


def vanilla_d_loss(logits_real: torch.Tensor, logits_fake: torch.Tensor) -> torch.Tensor:
    return 0.5 * (F.softplus(-logits_real).mean() + F.softplus(logits_fake).mean())


def generator_adv_loss(logits_fake: torch.Tensor) -> torch.Tensor:
    return -logits_fake.mean()


@dataclasses.dataclass(frozen=True)
class AutoencoderLossConfig:
    """GeneralLPIPSWithDiscriminator knobs (discriminator_loss.py:306)."""

    kl_weight: float = 1e-6
    perceptual_weight: float = 1.0
    disc_weight: float = 0.5
    disc_start: int = 50001
    disc_loss: str = "hinge"


def autoencoder_reconstruction_loss(
    lpips_apply: Optional[Callable[[torch.Tensor, torch.Tensor], torch.Tensor]],
    x: torch.Tensor, recon: torch.Tensor, kl: torch.Tensor, cfg: AutoencoderLossConfig,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """L1 reconstruction + perceptual_weight * LPIPS + kl_weight * KL, and
    the logs rec_loss, p_loss (with LPIPS), kl_loss, total."""
    loss = (x - recon).abs().mean()
    logs = {"rec_loss": loss}
    if lpips_apply is not None and cfg.perceptual_weight > 0:
        p = lpips_apply(x, recon).mean()
        loss = loss + cfg.perceptual_weight * p
        logs["p_loss"] = p
    loss = loss + cfg.kl_weight * kl.mean()
    logs["kl_loss"] = kl.mean()
    logs["total"] = loss
    return loss, logs
