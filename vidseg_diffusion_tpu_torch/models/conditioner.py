"""Conditioner: embedders routed to vector / crossattn / concat (PyTorch).

Counterpart of vidseg_diffusion_tpu/models/conditioner.py for the SVD
conditioner (configs/inference/svd.yaml conditioner_config): the CLIP image
embedding of the first frame -> crossattn [b, 1, 1024]; sinusoidal
embeddings of fps_id, motion_bucket_id and cond_aug -> vector [b, 768];
the VAE mode-encoding of the noised first frame -> concat [b, h, w, 4].
Outputs route by rank (2 -> vector, 3 -> crossattn, 4 -> concat) and
`get_unconditional_conditioning` zeroes the outputs of the force-zero keys.
The SD 2.1 conditioner (configs/inference/sd_2_1.yaml) is one OpenCLIP text
embedder: token ids -> crossattn [b, 77, 1024].
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Sequence, Tuple

import torch

from vidseg_diffusion_tpu_torch.models.layers import timestep_embedding

Batch = Dict[str, torch.Tensor]

_DIM2KEY = {2: "vector", 3: "crossattn", 4: "concat", 5: "concat"}
_KEY2DIM = {"vector": 1, "crossattn": 2, "concat": -1}


def concat_timestep_embedder(x: torch.Tensor, outdim: int = 256) -> torch.Tensor:
    """Each scalar column embedded sinusoidally, concatenated
    (ConcatTimestepEmbedderND, modules.py:913-929)."""
    if x.dim() == 1:
        x = x[:, None]
    b, dims = x.shape
    return timestep_embedding(x.reshape(-1), outdim).reshape(b, dims * outdim)


@dataclasses.dataclass(frozen=True)
class EmbedderSpec:
    input_key: str
    fn: Callable[[torch.Tensor], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class Conditioner:
    embedders: Tuple[EmbedderSpec, ...]

    def get_unconditional_conditioning(self, batch: Batch,
                                       force_uc_zero_embeddings: Sequence[str] = ()):
        """(c, uc) for one batch. Each embedder runs once; uc takes zeros for
        the force-zero keys (eager PyTorch would otherwise run the CLIP tower
        and the VAE encoder a second time only to zero their output)."""
        c: Batch = {}
        uc: Batch = {}
        for spec in self.embedders:
            emb = spec.fn(batch[spec.input_key])
            key = _DIM2KEY[emb.dim()]
            uc_emb = torch.zeros_like(emb) if spec.input_key in force_uc_zero_embeddings else emb
            for out, e in ((c, emb), (uc, uc_emb)):
                out[key] = torch.cat([out[key], e], dim=_KEY2DIM[key]) if key in out else e
        return c, uc


def build_svd_conditioner(
    clip_image_fn: Callable[[torch.Tensor], torch.Tensor],
    vae_encode_fn: Callable[[torch.Tensor], torch.Tensor],
) -> Conditioner:
    """clip_image_fn: [-1,1] frames [b,h,w,3] -> [b, 1024];
    vae_encode_fn: frames -> mode-encoded latents [b, h/8, w/8, 4]."""
    return Conditioner(embedders=(
        EmbedderSpec("cond_frames_without_noise", lambda f: clip_image_fn(f)[:, None, :]),
        EmbedderSpec("fps_id", lambda v: concat_timestep_embedder(v, 256)),
        EmbedderSpec("motion_bucket_id", lambda v: concat_timestep_embedder(v, 256)),
        EmbedderSpec("cond_frames", vae_encode_fn),
        EmbedderSpec("cond_aug", lambda v: concat_timestep_embedder(v, 256)),
    ))


def build_sd_text_conditioner(clip_text_fn: Callable[[torch.Tensor], torch.Tensor]) -> Conditioner:
    """clip_text_fn: token ids [b, 77] -> hidden states [b, 77, 1024]."""
    return Conditioner(embedders=(EmbedderSpec("txt_tokens", clip_text_fn),))
