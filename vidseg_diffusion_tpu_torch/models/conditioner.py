"""Conditioner: embedders routed to vector / crossattn / concat (PyTorch).

Counterpart of vidseg_diffusion_tpu/models/conditioner.py (:62-99,
:171-244): the SVD conditioner (configs/inference/svd.yaml: the CLIP image
embedding of the first frame -> crossattn [b, 1, 1024]; sinusoidal embeddings
of fps_id, motion_bucket_id and cond_aug -> vector [b, 768]; the VAE
mode-encoding of the noised first frame -> concat [b, h, w, 4]); SD 2.1's one
OpenCLIP text embedder (token ids -> crossattn [b, 77, 1024]); SDXL's base
(CLIP-L 768 | bigG 1280 -> crossattn 2048; vector = bigG pooled 1280 | orig
512 | crop 512 | target 512 = 2816) and refiner (bigG only -> crossattn 1280;
vector = pooled 1280 | orig | crop | aesthetic 256 = 2560); the T5 / ByT5
text conditioner (ids 'txt_t5_tokens' -> crossattn [b, l, d_model]) and the
class conditioner (labels 'cls' -> vector, or crossattn with
add_sequence_dim). An embedder may emit several outputs (bigG: hidden and
pooled; the CLIP + T5 pair). Outputs route by rank (2 ->
vector, 3 -> crossattn, 4 -> concat) and concatenate in embedder order.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence, Tuple

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
    fn: Callable


def _outputs(spec: EmbedderSpec, value) -> Tuple[torch.Tensor, ...]:
    out = spec.fn(value)
    return tuple(out) if isinstance(out, (tuple, list)) else (out,)


def _route(out: Batch, emb: torch.Tensor) -> None:
    key = _DIM2KEY[emb.dim()]
    out[key] = torch.cat([out[key], emb], dim=_KEY2DIM[key]) if key in out else emb


@dataclasses.dataclass(frozen=True)
class Conditioner:
    embedders: Tuple[EmbedderSpec, ...]

    def __call__(self, batch: Batch, force_zero_embeddings: Sequence[str] = ()) -> Batch:
        """Every embedder on its input key, routed; the outputs of the
        force-zero keys zeroed (modules.py:142-157)."""
        out: Batch = {}
        for spec in self.embedders:
            for e in _outputs(spec, batch[spec.input_key]):
                _route(out, torch.zeros_like(e) if spec.input_key in force_zero_embeddings else e)
        return out

    def get_unconditional_conditioning(self, batch_c: Batch, batch_uc: Optional[Batch] = None,
                                       force_uc_zero_embeddings: Sequence[str] = (),
                                       force_cond_zero_embeddings: Sequence[str] = ()):
        """(c, uc): c from batch_c, uc from batch_uc (default batch_c), each
        with the outputs of its force-zero keys zeroed (modules.py:154-184).
        An embedder runs once for both where uc reads the same value as c or
        zeroes it (eager PyTorch would otherwise run a tower a second time
        only to zero its output); where uc reads another value (the
        refiner's negative prompt and aesthetic score) it runs on each."""
        batch_uc = batch_c if batch_uc is None else batch_uc
        c: Batch = {}
        uc: Batch = {}
        for spec in self.embedders:
            key = spec.input_key
            embs = _outputs(spec, batch_c[key])
            if key in force_uc_zero_embeddings:
                uc_embs = tuple(torch.zeros_like(e) for e in embs)
            elif batch_uc[key] is batch_c[key]:
                uc_embs = embs
            else:
                uc_embs = _outputs(spec, batch_uc[key])
            if key in force_cond_zero_embeddings:
                embs = tuple(torch.zeros_like(e) for e in embs)
            for e, u in zip(embs, uc_embs):
                _route(c, e)
                _route(uc, u)
        return c, uc


def _sizes(names: Sequence[str], outdim: int) -> Tuple[EmbedderSpec, ...]:
    return tuple(EmbedderSpec(n, lambda v: concat_timestep_embedder(v, outdim)) for n in names)


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


def build_sdxl_conditioner(clip_l_fn: Callable, clip_g_fn: Callable, size_outdim: int = 256) -> Conditioner:
    """SDXL base (sd_xl_base.yaml:35-73). clip_l_fn: tokens -> [b, 77, 768];
    clip_g_fn: tokens -> ([b, 77, 1280], pooled [b, 1280]); both read the
    same tokens."""
    return Conditioner(embedders=(
        EmbedderSpec("txt_tokens", clip_l_fn), EmbedderSpec("txt_tokens", clip_g_fn),
    ) + _sizes(("original_size_as_tuple", "crop_coords_top_left", "target_size_as_tuple"), size_outdim))


def build_sdxl_refiner_conditioner(clip_g_fn: Callable, size_outdim: int = 256) -> Conditioner:
    """SDXL refiner (sd_xl_refiner.yaml:36-63): bigG only, the target-size
    embedder replaced by the aesthetic score's."""
    return Conditioner(embedders=(EmbedderSpec("txt_tokens", clip_g_fn),)
                       + _sizes(("original_size_as_tuple", "crop_coords_top_left", "aesthetic_score"), size_outdim))


def build_t5_text_conditioner(t5_fn: Callable[[torch.Tensor], torch.Tensor]) -> Conditioner:
    """FrozenT5Embedder / FrozenByT5Embedder (modules.py:249-328): ids
    'txt_t5_tokens' [b, l] -> the last hidden state [b, l, d_model]."""
    return Conditioner(embedders=(EmbedderSpec("txt_t5_tokens", t5_fn),))


def build_class_conditioner(class_fn: Callable[[torch.Tensor], torch.Tensor]) -> Conditioner:
    """ClassEmbedder (modules.py:215-234): labels 'cls' -> an embedding,
    routed by rank (vector, or crossattn with add_sequence_dim)."""
    return Conditioner(embedders=(EmbedderSpec("cls", class_fn),))
