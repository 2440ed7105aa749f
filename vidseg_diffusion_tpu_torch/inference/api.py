"""Enum-driven sampling API (PyTorch), of vidseg_diffusion_tpu/inference/api.py
(:1-483; the reference's sgm/inference/api.py and the demo's video path).

`SamplingParams` / `VideoSamplingParams` and the `Sampler` / `Discretization`
/ `Guider` enums; `SamplingPipeline` over a built Pipeline:
`text_to_image` (SD 2.1, the SDXL base, or an image UNet conditioned by T5
ids or class labels [b, 1]; `txt2noisy_strength` stops the
loop at a nonzero sigma, `return_latents` hands the latents on),
`image_to_image`, `refiner` (the SDXL refiner on base latents, `add_noise`
False to finish a noisy handoff) and `image_to_video` (SVD). Randomness comes
as tensors or from a torch.Generator, never from a global seed:
`noise` is the initial latent noise (txt2img, img2vid) or the add_noise
noise (img2img, refiner), `step_noise` the sampler's per-step draws
[steps in the window, *latent shape] (churn, ancestral noise),
`aug_noise` img2vid's cond-frame augmentation; what is not given is drawn
from `generator` (default: a generator on the pipeline's device seeded 0).
The JAX package draws these from its keys: a parity test hands the draws
over. Images are [B, H, W, 3] in [-1, 1]; outputs are fp32 in [0, 1].
"""

from __future__ import annotations

import dataclasses
from enum import Enum
from typing import Dict, Optional

import numpy as np
import torch

from vidseg_diffusion_tpu_torch.diffusion.discretization import EDMDiscretization, LegacyDDPMDiscretization
from vidseg_diffusion_tpu_torch.diffusion.guidance import IdentityGuider, LinearPredictionGuider, VanillaCFG
from vidseg_diffusion_tpu_torch.diffusion.sampling import (
    EulerAncestralSampler,
    EulerEDMSampler,
    HeunEDMSampler,
)
from vidseg_diffusion_tpu_torch.diffusion.sampling_extra import (
    DPMPP2MSampler,
    DPMPP2SAncestralSampler,
    LinearMultistepSampler,
)
from vidseg_diffusion_tpu_torch.engine.build import Pipeline


class Sampler(str, Enum):
    EULER_EDM = "EulerEDMSampler"
    HEUN_EDM = "HeunEDMSampler"
    EULER_ANCESTRAL = "EulerAncestralSampler"
    DPMPP2S_ANCESTRAL = "DPMPP2SAncestralSampler"
    DPMPP2M = "DPMPP2MSampler"
    LINEAR_MULTISTEP = "LinearMultistepSampler"


class Discretization(str, Enum):
    LEGACY_DDPM = "LegacyDDPMDiscretization"
    EDM = "EDMDiscretization"


class Guider(str, Enum):
    VANILLA = "VanillaCFG"
    IDENTITY = "IdentityGuider"


_SAMPLERS = {
    Sampler.EULER_EDM: EulerEDMSampler,
    Sampler.HEUN_EDM: HeunEDMSampler,
    Sampler.EULER_ANCESTRAL: EulerAncestralSampler,
    Sampler.DPMPP2S_ANCESTRAL: DPMPP2SAncestralSampler,
    Sampler.DPMPP2M: DPMPP2MSampler,
    Sampler.LINEAR_MULTISTEP: LinearMultistepSampler,
}


@dataclasses.dataclass
class SamplingParams:
    width: int = 512
    height: int = 512
    steps: int = 40
    sampler: Sampler = Sampler.EULER_EDM
    discretization: Discretization = Discretization.LEGACY_DDPM
    guider: Guider = Guider.VANILLA
    scale: float = 5.0
    eta: float = 1.0
    img2img_strength: float = 1.0
    sigma_min: float = 0.002
    sigma_max: float = 80.0
    rho: float = 7.0
    s_churn: float = 0.0
    s_tmin: float = 0.0
    s_tmax: float = 999.0
    s_noise: float = 1.0
    # SDXL size / crop conditioning
    orig_width: int = 1024
    orig_height: int = 1024
    crop_coords_top: int = 0
    crop_coords_left: int = 0
    # SDXL refiner aesthetic conditioning (refiner() sets 6.0 / 2.5)
    aesthetic_score: float = 5.0
    negative_aesthetic_score: float = 5.0


@dataclasses.dataclass(frozen=True)
class Txt2NoisyDiscretizationWrapper:
    """Stop-short sigma pruning for the SDXL base -> refiner handoff
    (scripts/demo/discretization.py:30-57): drops the smallest
    clamp(int(strength * steps) - 1, 0, steps - 1) sigmas (steps =
    original_steps + 1 when given, else the schedule's length)."""

    discretization: object
    strength: float = 0.0
    original_steps: Optional[int] = None

    def __post_init__(self):
        if not 0.0 <= self.strength <= 1.0:
            raise ValueError(f"strength must be in [0, 1], got {self.strength}")

    def prune_index(self, num_sigmas: int) -> int:
        steps = self.original_steps + 1 if self.original_steps is not None else num_sigmas
        return max(min(int(self.strength * steps) - 1, steps - 1), 0)

    def __call__(self, n: int, do_append_zero: bool = True, flip: bool = False) -> torch.Tensor:
        sig = self.discretization(n, do_append_zero=do_append_zero, flip=flip)
        k = self.prune_index(sig.shape[0])
        if k == 0:
            return sig
        return sig[k:] if flip else sig.flip(0)[k:].flip(0)

    def t_end(self, num_steps: int) -> int:
        """The loop end over the unpruned steps + 1 schedule that runs the
        pruned schedule's steps."""
        return num_steps - self.prune_index(num_steps + 1)


@dataclasses.dataclass
class VideoSamplingParams:
    """SVD image -> video (video_sampling.py VERSION2SPECS 'svd': 14 frames,
    CFG 1 -> 2.5 over the frames, 25 steps, sigma in [0.002, 700])."""

    width: int = 1024
    height: int = 576
    num_frames: int = 14
    steps: int = 25
    sigma_min: float = 0.002
    sigma_max: float = 700.0
    rho: float = 7.0
    min_cfg: float = 1.0
    max_cfg: float = 2.5
    fps_id: int = 6
    motion_bucket_id: int = 127
    cond_aug: float = 0.02
    decoding_t: int = 1


def img2img_t_start(steps: int, strength: float) -> int:
    """The first step an img2img run takes: the reference's
    Img2ImgDiscretizationWrapper keeps max(int((steps + 1) * strength), 1)
    sigmas of the steps + 1 schedule."""
    n_sig = steps + 1
    return n_sig - max(int(n_sig * strength), 1)


class SamplingPipeline:
    """txt2img / img2img / refiner / img2vid over a built Pipeline."""

    def __init__(self, pipeline: Pipeline):
        self.pipeline = pipeline

    @property
    def device(self) -> torch.device:
        return self.pipeline.device

    def _generator(self, generator: Optional[torch.Generator]) -> torch.Generator:
        return generator if generator is not None else torch.Generator(device=self.device).manual_seed(0)

    def _randn(self, shape, generator: torch.Generator, noise: Optional[torch.Tensor]) -> torch.Tensor:
        if noise is not None:
            return torch.as_tensor(noise, dtype=torch.float32).to(self.device)
        return torch.randn(shape, generator=generator, device=generator.device).to(self.device)

    def make_sampler(self, params: SamplingParams) -> EulerEDMSampler:
        if params.discretization == Discretization.EDM:
            disc = EDMDiscretization(params.sigma_min, params.sigma_max, params.rho)
        else:
            disc = LegacyDDPMDiscretization()
        kwargs = dict(s_churn=params.s_churn, s_tmin=params.s_tmin, s_tmax=params.s_tmax, s_noise=params.s_noise)
        if params.sampler in (Sampler.EULER_ANCESTRAL, Sampler.DPMPP2S_ANCESTRAL):
            kwargs["eta"] = params.eta
        return _SAMPLERS[Sampler(params.sampler)](disc, params.steps, **kwargs)

    @staticmethod
    def guider(params: SamplingParams):
        return VanillaCFG(scale=params.scale) if params.guider == Guider.VANILLA else IdentityGuider()

    def denoise_fn(self, c: Dict, uc: Dict, guider, num_frames: Optional[int] = None):
        """denoise_fn(x, sigma, i) -> (guided denoised, None): the guider's
        CFG batch through the denoiser and the UNet; `num_frames` for the
        video UNet (zeros for the image-only indicator)."""
        p = self.pipeline

        def network(xs, c_noise, cond):
            if "concat" in cond:
                xs = torch.cat([xs, cond["concat"].to(xs.dtype)], dim=-1)
            kw = {}
            if num_frames is not None:
                kw = dict(num_video_frames=num_frames,
                          image_only_indicator=torch.zeros(xs.shape[0] // num_frames, num_frames,
                                                           dtype=xs.dtype, device=xs.device))
            return p.unet(xs, c_noise, cond.get("crossattn"), cond.get("vector"), **kw), None

        def fn(x, sigma, i):
            s = torch.full((x.shape[0],), sigma, dtype=x.dtype, device=x.device)
            x_in, s_in, cond = guider.prepare_inputs(x, s, c, uc)
            out, _ = p.spec.denoiser(network, x_in, s_in, cond)
            return guider(out, sigma), None

        return fn

    def _tokens(self, tokens) -> torch.Tensor:
        return torch.as_tensor(np.asarray(tokens)).long().to(self.device)

    @torch.no_grad()
    def make_cond(self, params: SamplingParams, prompt_tokens, negative_prompt_tokens, batch_size: int):
        """(c, uc) of the CFG pair, each repeated to batch_size. uc's prompt is
        the negative one, by default the empty prompt framed with the prompt's
        own SOT / EOT ids (EOT the largest id): zeros, column 0 the prompt's
        first id, column 1 its largest, as JAX builds it for every kind (for
        T5 ids too; for labels [b, 1] column 1 does not exist, JAX's scatter
        drops it, so the default negative is the label itself). SD 2.1, T5,
        class: the one tower's output (`clip_apply`) as crossattn. SDXL base:
        the dual-text conditioner with the size / crop / target-size vector,
        uc's text outputs zeroed (hidden and pooled);
        refiner: the aesthetic score (negative for uc), uc's text not zeroed
        (the reference calls its img2img with force_uc_zero_embeddings=[])."""
        p = self.pipeline
        pt = self._tokens(prompt_tokens)
        if negative_prompt_tokens is None:
            neg = torch.zeros_like(pt)
            neg[:, 0] = pt[:, 0]
            if pt.shape[1] > 1:
                neg[:, 1] = pt.max(dim=1).values
        else:
            neg = self._tokens(negative_prompt_tokens)
        rep = lambda d: {k: torch.repeat_interleave(v, batch_size, dim=0) for k, v in d.items()}
        if p.kind in ("sdxl", "sdxl_refiner"):
            refiner = p.kind == "sdxl_refiner"
            pair = lambda a, b: torch.tensor([[float(a), float(b)]], device=self.device)
            batch_c = {"txt_tokens": pt,
                       "original_size_as_tuple": pair(params.orig_height, params.orig_width),
                       "crop_coords_top_left": pair(params.crop_coords_top, params.crop_coords_left)}
            if refiner:
                batch_c["aesthetic_score"] = torch.tensor([[params.aesthetic_score]], device=self.device)
                batch_uc = dict(batch_c, aesthetic_score=torch.tensor([[params.negative_aesthetic_score]],
                                                                      device=self.device))
            else:
                batch_c["target_size_as_tuple"] = pair(params.height, params.width)
                batch_uc = dict(batch_c)
            batch_uc["txt_tokens"] = neg
            c, uc = p.conditioner.get_unconditional_conditioning(
                batch_c, batch_uc, force_uc_zero_embeddings=[] if refiner else ["txt_tokens"])
            return rep(c), rep(uc)
        if p.kind not in ("sd_text", "t5_text", "class"):
            raise ValueError(f"text conditioning needs a text or class pipeline, not {p.kind!r}")
        return rep({"crossattn": p.clip_apply(pt)}), rep({"crossattn": p.clip_apply(neg)})

    def decode(self, z: torch.Tensor, chunk: Optional[int] = None) -> torch.Tensor:
        """Latents -> images in [0, 1] (fp32), `chunk` frames a decoder call."""
        frames = self.pipeline.first_stage.decode(z, chunk=chunk).float()
        return torch.clamp((frames + 1.0) / 2.0, 0.0, 1.0)

    @torch.no_grad()
    def text_to_image(self, params: SamplingParams, prompt_tokens, negative_prompt_tokens=None, samples: int = 1,
                      noise: Optional[torch.Tensor] = None, step_noise: Optional[torch.Tensor] = None,
                      generator: Optional[torch.Generator] = None, txt2noisy_strength: Optional[float] = None,
                      return_latents: bool = False):
        """[samples, H, W, 3] (and the latents with return_latents).
        txt2noisy_strength ends the loop at a nonzero sigma
        (Txt2NoisyDiscretizationWrapper), the base stage of a base -> refiner
        pipeline: pair it with refiner(..., add_noise=False)."""
        gen = self._generator(generator)
        c, uc = self.make_cond(params, prompt_tokens, negative_prompt_tokens, samples)
        x = self._randn((samples, params.height // 8, params.width // 8, 4), gen, noise)
        sampler = self.make_sampler(params)
        t_end = None
        if txt2noisy_strength is not None:
            t_end = Txt2NoisyDiscretizationWrapper(sampler.discretization, txt2noisy_strength,
                                                   params.steps).t_end(params.steps)
        if t_end == 0:  # strength ~1: no step runs, the pre-scaled noise is the latent
            z = sampler.prescale(x, sampler.sigmas())
        else:
            z, _ = sampler(self.denoise_fn(c, uc, self.guider(params)), x, t_end=t_end, noise=step_noise,
                           generator=gen)
        frames = self.decode(z)
        return (frames, z) if return_latents else frames

    @torch.no_grad()
    def image_to_image(self, params: SamplingParams, image, prompt_tokens, negative_prompt_tokens=None,
                       noise: Optional[torch.Tensor] = None, step_noise: Optional[torch.Tensor] = None,
                       generator: Optional[torch.Generator] = None):
        """img2img: encode, noise to the strength's first step, denoise, decode."""
        z = self.pipeline.first_stage.encode(torch.as_tensor(image, dtype=torch.float32).to(self.device)).float()
        return self._denoise_from_latent(params, z, prompt_tokens, negative_prompt_tokens, noise, step_noise,
                                         generator)

    def _denoise_from_latent(self, params, z, prompt_tokens, negative_prompt_tokens, noise, step_noise,
                             generator, add_noise: bool = True):
        """img2img's tail. add_noise False: z is already noisy at the
        strength's first sigma (a txt2noisy base run); only the pre-scale's
        inverse is applied, so the loop's pre-scale gives z back."""
        gen = self._generator(generator)
        sampler = self.make_sampler(params)
        c, uc = self.make_cond(params, prompt_tokens, negative_prompt_tokens, z.shape[0])
        t_start = img2img_t_start(params.steps, params.img2img_strength)
        if t_start >= params.steps:  # strength ~0: no step runs, the input comes back
            zf = z
        else:
            if add_noise:
                noised = sampler.add_noise(z, t_start, noise=self._randn(z.shape, gen, noise))
            else:
                noised = z / torch.sqrt(1.0 + sampler.sigmas()[0] ** 2.0).item()
            zf, _ = sampler(self.denoise_fn(c, uc, self.guider(params)), noised, t_start=t_start,
                            noise=step_noise, generator=gen)
        return self.decode(zf)

    @torch.no_grad()
    def refiner(self, params: SamplingParams, latents, prompt_tokens, negative_prompt_tokens=None,
                noise: Optional[torch.Tensor] = None, step_noise: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None, add_noise: bool = True):
        """The SDXL refiner on base latents [B, h, w, 4] (img2img without the
        encode): sizes from the latents, aesthetic scores 6.0 / 2.5. With
        add_noise False, pass the img2img_strength the base's
        txt2noisy_strength used, so the refiner resumes where the base
        stopped."""
        z = torch.as_tensor(latents, dtype=torch.float32).to(self.device)
        h, w = z.shape[1] * 8, z.shape[2] * 8
        rp = dataclasses.replace(params, width=w, height=h, orig_width=w, orig_height=h, crop_coords_top=0,
                                 crop_coords_left=0, aesthetic_score=6.0, negative_aesthetic_score=2.5)
        return self._denoise_from_latent(rp, z, prompt_tokens, negative_prompt_tokens, noise, step_noise,
                                         generator, add_noise=add_noise)

    @torch.no_grad()
    def image_to_video(self, params: VideoSamplingParams, image, noise: Optional[torch.Tensor] = None,
                       aug_noise: Optional[torch.Tensor] = None, generator: Optional[torch.Generator] = None):
        """SVD image -> video: the still frame [1, H, W, 3] (or [H, W, 3])
        conditions the SVD conditioner (CLIP image embedding -> crossattn,
        the VAE mode of the cond_aug-noised frame -> concat, fps / motion /
        aug embeddings -> vector; uc zeroes the frame's), T latent frames
        are denoised from noise under the per-frame CFG ramp and decoded
        decoding_t frames at a time. Returns [T, H, W, 3] in [0, 1]."""
        p = self.pipeline
        if not p.spec.unet_config.video:
            raise ValueError("image_to_video requires a video (SVD) pipeline")
        t = params.num_frames
        gen = self._generator(generator)
        image = torch.as_tensor(image, dtype=torch.float32).to(self.device)
        if image.dim() == 3:
            image = image[None]
        aug = self._randn(image.shape, gen, aug_noise)
        x = self._randn((t, params.height // 8, params.width // 8, 4), gen, noise)
        c, uc = p.condition_video(image, aug, float(params.fps_id), float(params.motion_bucket_id), params.cond_aug, t)
        sampler = EulerEDMSampler(EDMDiscretization(params.sigma_min, params.sigma_max, params.rho), params.steps)
        guider = LinearPredictionGuider(max_scale=params.max_cfg, num_frames=t, min_scale=params.min_cfg)
        z, _ = sampler(self.denoise_fn(c, uc, guider, num_frames=t), x)
        return self.decode(z, chunk=params.decoding_t)
