"""First stage (VAE) encode/decode with the latent scale and chunking.

Counterpart of vidseg_diffusion_tpu/engine/diffusion_engine.py FirstStage:
encode to the posterior mode times 0.18215, decode divided by it; both
process the batch in chunks of `chunk` frames (decoding_t), the ragged tail
at its natural length, as the reference's en_and_decode_n_samples_a_time
loop (diffusion.py:117-151). For the temporal video decoder the chunk is
the number of frames its temporal convolutions see. An AutoencoderKL
checkpoint (SD 2.1) also carries the 1x1 quant_conv after the encoder and
post_quant_conv before the decoder; the SVD first stage has neither.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

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

    @torch.no_grad()
    def encode(self, x: torch.Tensor, chunk: Optional[int] = None) -> torch.Tensor:
        """[-1, 1] frames [B, H, W, 3] -> scaled mode latents [B, H/8, W/8, z]."""
        def enc(xc):
            moments = self.encoder(xc)
            if self.quant_conv is not None:
                moments = self.quant_conv(moments)
            return gaussian_sample(moments)

        return self.scale_factor * _chunked(enc, x, chunk)

    @torch.no_grad()
    def decode(self, z: torch.Tensor, chunk: Optional[int] = None) -> torch.Tensor:
        """Scaled latents [B, h, w, z] -> [-1, 1] frames [B, 8h, 8w, 3]."""
        def dec(zc):
            if self.post_quant_conv is not None:
                zc = self.post_quant_conv(zc.to(self.decoder.config.dtype))
            return self.decoder(zc, zc.shape[0])

        return _chunked(dec, z / self.scale_factor, chunk)
