"""First stage (VAE) encode/decode with the latent scale and chunking.

Counterpart of vidseg_diffusion_tpu/engine/diffusion_engine.py FirstStage:
encode to the posterior mode times 0.18215, decode divided by it; both
process the batch in chunks of `chunk` frames (decoding_t), the ragged tail
at its natural length, as the reference's en_and_decode_n_samples_a_time
loop (diffusion.py:117-151). For the temporal video decoder the chunk is
the number of frames its temporal convolutions see. An AutoencoderKL
checkpoint (SD 2.1) also carries the 1x1 quant_conv after the encoder and
post_quant_conv before the decoder; the SVD first stage has neither.
encode / decode run under torch.no_grad (inference); `moments` and
`reconstruct` are the same modules under autograd, for autoencoder training
(engine/train.py AutoencoderTrainStep), and `modules` holds what that
training optimizes. A video decoder's temporal layers see the batch as one
clip (a chunk of decode, or one training clip: its `timesteps` is the batch's
length, as JAX's decode_apply closes over the clip length).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn as nn

from vidseg_diffusion_tpu_torch.models.layers import Conv2dNHWC
from vidseg_diffusion_tpu_torch.models.vae import Decoder, Encoder, gaussian_sample


def _chunked(fn, x: torch.Tensor, chunk: Optional[int]) -> torch.Tensor:
    if chunk is None or chunk >= x.shape[0]:
        return fn(x)
    return torch.cat([fn(x[i:i + chunk]) for i in range(0, x.shape[0], chunk)], dim=0)


@dataclasses.dataclass
class FirstStage:
    encoder: Encoder
    decoder: Decoder
    scale_factor: float = 0.18215
    quant_conv: Optional[Conv2dNHWC] = None        # 1x1 on the moments
    post_quant_conv: Optional[Conv2dNHWC] = None   # 1x1 on the latents

    def moments(self, x: torch.Tensor) -> torch.Tensor:
        """[-1, 1] frames [B, H, W, 3] -> posterior moments [B, H/8, W/8, 2z]
        (the encoder, then quant_conv), under autograd."""
        moments = self.encoder(x)
        return self.quant_conv(moments) if self.quant_conv is not None else moments

    def reconstruct(self, z: torch.Tensor) -> torch.Tensor:
        """Unscaled latents [B, h, w, z] -> frames [B, 8h, 8w, 3]
        (post_quant_conv, then the decoder), under autograd; a video decoder
        sees the B latents as one clip of B frames."""
        if self.post_quant_conv is not None:
            z = self.post_quant_conv(z.to(self.decoder.config.dtype))
        return self.decoder(z, z.shape[0])

    def modules(self) -> nn.ModuleDict:
        """The first stage's modules under the sgm AutoencoderKL prefixes."""
        mods = dict(encoder=self.encoder, decoder=self.decoder, quant_conv=self.quant_conv,
                    post_quant_conv=self.post_quant_conv)
        return nn.ModuleDict({k: m for k, m in mods.items() if m is not None})

    @torch.no_grad()
    def encode(self, x: torch.Tensor, chunk: Optional[int] = None) -> torch.Tensor:
        """[-1, 1] frames [B, H, W, 3] -> scaled mode latents [B, H/8, W/8, z]."""
        return self.scale_factor * _chunked(lambda xc: gaussian_sample(self.moments(xc)), x, chunk)

    @torch.no_grad()
    def decode(self, z: torch.Tensor, chunk: Optional[int] = None) -> torch.Tensor:
        """Scaled latents [B, h, w, z] -> [-1, 1] frames [B, 8h, 8w, 3]."""
        return _chunked(self.reconstruct, z / self.scale_factor, chunk)
