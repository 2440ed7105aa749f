"""The sampling-API runs that chip_smoke.py checks, defined once; also a
command line for one txt2img (optionally handed to the refiner).

- SDXL (configs/inference/sd_xl_base.yaml, sd_xl_refiner.yaml at full width,
  random bf16 weights, seeds 0 and 1): text_to_image at 1024x1024 with the
  config's 40 Euler steps and CFG 5; each other sampler for 6 steps;
  image_to_image at strength 0.5; the base -> refiner handoff at strength
  0.2 (the base stops at a nonzero sigma, the refiner finishes without fresh
  noise).
- img2vid (configs/inference/svd.yaml): image_to_video at
  VideoSamplingParams' defaults (1024x576, 14 frames, 25 steps, decoding_t 1).
- null-text inversion (configs/inference/sd_2_1.yaml at 512x512): the
  inversion of an encoded image over a 4-step schedule, then
  null_text_optimization with 3 inner steps, then `edit` with a window
  inside the schedule.

The prompts are token ids of the repository's tiny BPE vocabulary (the
production vocabulary is not in the repository).

    python -m vidseg_diffusion_tpu_torch.scripts.api_path --config configs/inference/sd_xl_tiny.yaml \\
        --device cpu --size 64 --steps 4 [--refiner configs/inference/sd_xl_refiner_tiny.yaml]

On the card at its defaults (SDXL base, 1024x1024, 40 steps), `--repeat 5`
gives the seconds of an image after a warm-up, wall and the process's CPU
time, each line one image.
"""

import argparse
import dataclasses
import os
import time

import numpy as np
import torch

from vidseg_diffusion_tpu_torch.diffusion.discretization import Discretization
from vidseg_diffusion_tpu_torch.diffusion.guidance import VanillaCFG
from vidseg_diffusion_tpu_torch.diffusion.sampling_extra import edit, null_text_optimization
from vidseg_diffusion_tpu_torch.engine.build import build_pipeline
from vidseg_diffusion_tpu_torch.inference.api import SamplingParams, SamplingPipeline
from vidseg_diffusion_tpu_torch.io.tokenizer import TINY_VOCAB, tokenize
from vidseg_diffusion_tpu_torch.scripts.main_path import ROOT

SDXL_SIZE, SDXL_STEPS, OTHER_STEPS = 1024, 40, 6
IMG2IMG_STRENGTH, HANDOFF_STRENGTH = 0.5, 0.2
NTI_SIZE, NTI_STEPS, NTI_INNER = 512, 4, 3
EDIT_WINDOW = (1, 2)   # edit_start_step, edit_end_step of the 4-step schedule
PROMPT, EDIT_PROMPT = "a photo of a cat", "a photo of a dog"


def build(config: str, device="cuda", dtype=torch.bfloat16, seed: int = 0) -> SamplingPipeline:
    path = config if os.path.isabs(config) or os.path.exists(config) else os.path.join(ROOT, config)
    return SamplingPipeline(build_pipeline(path, dtype=dtype, device=device, seed=seed))


def tokens(prompt: str = PROMPT) -> np.ndarray:
    return tokenize([prompt], bpe_path=TINY_VOCAB)


def sdxl_params(size: int = SDXL_SIZE, steps: int = SDXL_STEPS, **kw) -> SamplingParams:
    return SamplingParams(width=size, height=size, steps=steps, orig_width=size, orig_height=size, **kw)


def image(height: int, width: int) -> np.ndarray:
    """[1, H, W, 3] in [-1, 1]: a smooth colour pattern plus low noise."""
    rng = np.random.RandomState(0)
    yy, xx = np.meshgrid(np.linspace(-1, 1, height), np.linspace(-1, 1, width), indexing="ij")
    img = np.stack([np.sin(3 * xx), np.cos(2 * yy), xx * yy], -1) * 0.8 + 0.1 * rng.randn(height, width, 3)
    return np.clip(img, -1, 1).astype(np.float32)[None]


@dataclasses.dataclass(frozen=True)
class FlooredDiscretization(Discretization):
    """`base`'s schedule with `floor` in place of the appended zero, so the
    flipped schedule of an inversion starts at `floor`: from sigma = 1e-8 a
    DiscreteDenoiser's first step scales the latent by ~1e6 (ROADMAP section
    C), from its smallest table sigma the first step is an epsilon step."""

    base: Discretization
    floor: float

    def __call__(self, n: int, do_append_zero: bool = True, flip: bool = False) -> torch.Tensor:
        sigmas = self.base(n, do_append_zero=False)
        if do_append_zero:
            sigmas = torch.cat([sigmas, sigmas.new_full((1,), self.floor)])
        return sigmas.flip(0) if flip else sigmas


def nti_and_edit(api: SamplingPipeline, size: int = NTI_SIZE, steps: int = NTI_STEPS, inner: int = NTI_INNER,
                 window=EDIT_WINDOW, on_loss=None):
    """The inversion of image(size, size), null_text_optimization over it and
    `edit` from its end latent, the edit prompt inside `window`. Returns
    (latents_inv, uc_list, edited frames [1, size, size, 3], base-only
    frames)."""
    p = api.pipeline
    params = SamplingParams(width=size, height=size, steps=steps)
    sampler, guider = api.make_sampler(params), VanillaCFG(params.scale)
    c, uc = api.make_cond(params, tokens(), None, 1)
    c_edit, _ = api.make_cond(params, tokens(EDIT_PROMPT), None, 1)
    with torch.no_grad():
        z = p.first_stage.encode(torch.from_numpy(image(size, size)).to(api.device)).float()
        table_min = float(p.spec.denoiser.discretization(p.spec.denoiser.num_idx, do_append_zero=False).min())
        floored = dataclasses.replace(sampler, discretization=FlooredDiscretization(sampler.discretization, table_min))
        _, latents_inv = floored.inversion(api.denoise_fn(c, uc, guider), z)
    uc_list = null_text_optimization(sampler, lambda u: api.denoise_fn(c, {"crossattn": u}, guider), latents_inv,
                                     uc["crossattn"], num_inner_steps=inner, on_loss=on_loss)
    with torch.no_grad():
        base_fn = api.denoise_fn(c, {"crossattn": uc_list[-1]}, guider)
        edit_fn = api.denoise_fn(c_edit, {"crossattn": uc_list[-1]}, guider)
        x_T = latents_inv[-1]
        z_edit, _ = edit(sampler, base_fn, edit_fn, x_T, edit_start_step=window[0], edit_end_step=window[1],
                         prescale=False)
        z_base, _ = sampler(base_fn, x_T, prescale=False)
        return latents_inv, uc_list, api.decode(z_edit), api.decode(z_base)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", default="configs/inference/sd_xl_base.yaml")
    ap.add_argument("--refiner", default=None, help="an SDXL refiner config: hand the base's latents to it")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", choices=("bfloat16", "float32"), default=None)
    ap.add_argument("--size", type=int, default=SDXL_SIZE)
    ap.add_argument("--steps", type=int, default=SDXL_STEPS)
    ap.add_argument("--sampler", default="EulerEDMSampler")
    ap.add_argument("--prompt", default=PROMPT, help="tokenized with the repository's tiny vocabulary")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--repeat", type=int, default=1,
                    help="images made one after another from the same seed, each timed (the first one warms up)")
    args = ap.parse_args()
    dtype = {"bfloat16": torch.bfloat16, "float32": torch.float32}.get(
        args.dtype, torch.bfloat16 if args.device == "cuda" else torch.float32)
    api = build(args.config, args.device, dtype)
    ref = None if args.refiner is None else build(args.refiner, args.device, dtype, seed=1)
    params = sdxl_params(args.size, args.steps, sampler=args.sampler)
    for _ in range(args.repeat):
        gen = torch.Generator(device=args.device).manual_seed(args.seed)
        t0, cpu0 = time.perf_counter(), time.process_time()
        if ref is None:
            out = api.text_to_image(params, tokens(args.prompt), generator=gen)
        else:
            _, z = api.text_to_image(params, tokens(args.prompt), generator=gen,
                                     txt2noisy_strength=HANDOFF_STRENGTH, return_latents=True)
            out = ref.refiner(dataclasses.replace(params, img2img_strength=HANDOFF_STRENGTH), z, tokens(args.prompt),
                              generator=gen, add_noise=False)
        if args.device == "cuda":
            torch.cuda.synchronize()
        print(f"image {tuple(out.shape)} in [{out.min().item():.3f}, {out.max().item():.3f}], "
              f"{time.perf_counter() - t0:.3f} s, {time.process_time() - cpu0:.3f} s of the process's CPU time",
              flush=True)


if __name__ == "__main__":
    main()
