"""EDM samplers (PyTorch): Euler with s_churn, Heun and Euler ancestral, of
vidseg_diffusion_tpu/diffusion/sampling.py (sampling.py:92-262, 417-528 of
the reference).

The schedule (flipped for inversion), the sqrt(1 + sigma_0^2) pre-scale and
its inverse in `add_noise` (they cancel by construction, and VidSeg relies on
it), one step, the loop over the window [t_start, t_end) and the DDIM-style
inversion. The VidSeg engine's own step loops (engine/vidseg.py) call `step`.

The sigma arithmetic is the JAX package's fp32 scalar arithmetic (fp32 CPU
scalars here). Randomness: step k of the window draws its noise (the churn's
eps, the ancestral noise) from `noise[k]` when given (e.g. the draws JAX makes
from jax.random.split(rng, t_end - t_start)[k]), else from `generator`; with
neither there is no noise, as in JAX with rng None. Where JAX evaluates both
branches of a jnp.where (Heun's final-step switch), the port runs only the
branch that is taken: the values agree, and the UNet call counts are the
port's own (Heun makes 2n - 1 calls for n steps ending at sigma = 0).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence

import torch

from vidseg_diffusion_tpu_torch.diffusion.discretization import Discretization

def f32(v) -> torch.Tensor:
    """A fp32 scalar on the CPU: the JAX package's sigma arithmetic is fp32."""
    return torch.as_tensor(v, dtype=torch.float32)


def to_d(x: torch.Tensor, sigma, denoised: torch.Tensor) -> torch.Tensor:
    """ODE derivative (x - D(x)) / sigma."""
    return (x - denoised) / float(sigma)


def get_ancestral_step(sigma_from, sigma_to, eta: float = 1.0):
    """(sigma_down, sigma_up) of an ancestral step, fp32 scalars."""
    sf, st = f32(sigma_from), f32(sigma_to)
    sigma_up = torch.minimum(st, eta * (st ** 2 * (sf ** 2 - st ** 2) / sf ** 2) ** 0.5)
    sigma_down = (st ** 2 - sigma_up ** 2) ** 0.5
    return sigma_down, sigma_up


def draw(noise, k: int, x: torch.Tensor, generator: Optional[torch.Generator]) -> Optional[torch.Tensor]:
    """Step k's noise in x's shape: noise[k] (a tensor of draws, one per loop
    step) when given, else a draw from `generator` (on its device), else None."""
    if noise is not None:
        return noise[k].to(device=x.device, dtype=x.dtype)
    if generator is not None:
        return torch.randn(x.shape, generator=generator, device=generator.device,
                           dtype=x.dtype).to(x.device)
    return None


@dataclasses.dataclass(frozen=True)
class EulerEDMSampler:
    discretization: Discretization
    num_steps: int
    s_churn: float = 0.0
    s_tmin: float = 0.0
    s_tmax: float = float("inf")
    s_noise: float = 1.0

    def sigmas(self, flip: bool = False) -> torch.Tensor:
        """[num_steps + 1] fp32 on the CPU, last entry 0; `flip` reverses it
        and adds 1e-8 to the first entry, so the loop never starts at sigma 0
        (JAX sampling.py:68-74)."""
        sig = self.discretization(self.num_steps, do_append_zero=True)
        if flip:
            sig = sig.flip(0)
            sig[0] += 1e-8
        return sig

    def prescale(self, x: torch.Tensor, sigmas: torch.Tensor) -> torch.Tensor:
        return x * torch.sqrt(1.0 + sigmas[0] ** 2.0).item()

    def add_noise(self, x: torch.Tensor, noise_level: int, noise: Optional[torch.Tensor] = None,
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """(x + sigma[noise_level] * eps) / sqrt(1 + sigma_0^2) in fp32. eps is
        `noise` when given (e.g. the array JAX drew), else drawn from
        `generator` (CPU) in x's dtype, as the JAX package draws it."""
        sigmas = self.sigmas()
        if noise is None:
            noise = torch.randn(x.shape, generator=generator, dtype=x.dtype)
        eps = noise.to(x.device).float() * sigmas[noise_level].item()
        return (x.float() + eps) / torch.sqrt(1.0 + sigmas[0] ** 2.0).item()

    def gammas(self, sigmas: torch.Tensor) -> List[float]:
        """The churn factor per step: min(s_churn / n, sqrt(2) - 1) where
        s_tmin <= sigma <= s_tmax, else 0 (JAX sampling.py:100-105)."""
        if self.s_churn <= 0:
            return [0.0] * len(sigmas)
        gamma = min(self.s_churn / (len(sigmas) - 1), 2 ** 0.5 - 1)
        return [gamma if self.s_tmin <= s <= self.s_tmax else 0.0 for s in sigmas.tolist()]

    def _churn(self, x, sigma, gamma, noise):
        """(x with the churn noise added, sigma_hat) (JAX sampling.py:118-122)."""
        sigma_hat = f32(sigma) * (f32(gamma) + 1.0)
        if noise is not None and self.s_churn > 0:
            churn = torch.sqrt(torch.clamp(sigma_hat ** 2 - f32(sigma) ** 2, min=0.0))
            x = x + noise * self.s_noise * churn.item()
        return x, sigma_hat

    def corrects(self, sigma, next_sigma) -> bool:
        """Whether the step from sigma to next_sigma calls the denoiser a
        second time (a second-order correction); Euler's never does."""
        return False

    def step(self, denoise_fn, x, sigma, next_sigma, i: int, gamma: float = 0.0,
             noise: Optional[torch.Tensor] = None):
        """One Euler step (sampling.py:103-131). denoise_fn(x, sigma, i) ->
        (denoised, aux); returns (x_next, aux)."""
        x, sigma_hat = self._churn(x, sigma, gamma, noise)
        denoised, aux = denoise_fn(x, sigma_hat.item(), i)
        return x + (f32(next_sigma) - sigma_hat).item() * to_d(x, sigma_hat, denoised), aux

    def window(self, t_start: int, t_end: Optional[int]):
        n = self.num_steps
        t_end = n if t_end is None else min(t_end, n)
        if not 0 <= t_start < t_end:
            raise ValueError(f"empty step window [{t_start}, {t_end})")
        return t_start, t_end

    def __call__(self, denoise_fn, x: torch.Tensor, *, t_start: int = 0, t_end: Optional[int] = None,
                 post_step_fn: Optional[Callable] = None, noise: Optional[Sequence] = None,
                 generator: Optional[torch.Generator] = None, prescale: bool = True):
        """Steps i = t_start .. t_end - 1 (default t_end = num_steps) of
        denoise_fn(x, sigma, i) -> (denoised, aux), post_step_fn(x, i) -> x
        after each. Returns (x_final, [aux of each step])."""
        t_start, t_end = self.window(t_start, t_end)
        sig = self.sigmas()
        sigmas, gammas = sig.tolist(), self.gammas(sig)
        if prescale:
            x = self.prescale(x, sig)
        auxes = []
        for k, i in enumerate(range(t_start, t_end)):
            x, aux = self.step(denoise_fn, x, sigmas[i], sigmas[i + 1], i, gammas[i],
                               noise=draw(noise, k, x, generator))
            if post_step_fn is not None:
                x = post_step_fn(x, i)
            auxes.append(aux)
        return x, auxes

    def inversion(self, denoise_fn, x: torch.Tensor):
        """DDIM-style inversion over the flipped schedule (JAX
        sampling.py:185-218): x * sqrt(1 + sigma_0^2), then num_steps Euler
        steps from sigma ~ 0 up to sigma_max, then / sqrt(1 + sigma_last^2).
        Returns (x_T, latents [num_steps + 1, ...]): the trajectory from the
        pre-scaled start latent on; fp32, as JAX's product with its fp32 scale
        promotes a bf16 latent."""
        sig = self.sigmas(flip=True)
        sigmas = sig.tolist()
        x = x.float() * torch.sqrt(1.0 + sig[0] ** 2.0).item()
        latents = [x]
        for i in range(len(sigmas) - 1):
            x, _ = self.step(denoise_fn, x, sigmas[i], sigmas[i + 1], i)
            latents.append(x)
        return x / torch.sqrt(1.0 + sig[-1] ** 2.0).item(), torch.stack(latents)


@dataclasses.dataclass(frozen=True)
class HeunEDMSampler(EulerEDMSampler):
    """Heun's 2nd-order correction (sampling.py:502-518); the Euler step
    alone where the next sigma is 0."""

    def corrects(self, sigma, next_sigma) -> bool:
        return next_sigma >= 1e-14

    def step(self, denoise_fn, x, sigma, next_sigma, i: int, gamma: float = 0.0,
             noise: Optional[torch.Tensor] = None):
        x, sigma_hat = self._churn(x, sigma, gamma, noise)
        denoised, aux = denoise_fn(x, sigma_hat.item(), i)
        d = to_d(x, sigma_hat, denoised)
        dt = (f32(next_sigma) - sigma_hat).item()
        euler = x + dt * d
        if not self.corrects(sigma, next_sigma):
            return euler, aux
        denoised2, _ = denoise_fn(euler, float(next_sigma), i)
        d2 = to_d(euler, next_sigma, denoised2)
        return x + (f32(dt) * 0.5).item() * (d + d2), aux


@dataclasses.dataclass(frozen=True)
class EulerAncestralSampler(EulerEDMSampler):
    """Euler ancestral (sampling.py:417-454, 521-528): no churn; the step's
    noise times s_noise * sigma_up."""

    eta: float = 1.0

    def step(self, denoise_fn, x, sigma, next_sigma, i: int, gamma: float = 0.0,
             noise: Optional[torch.Tensor] = None):
        sigma_down, sigma_up = get_ancestral_step(sigma, next_sigma, eta=self.eta)
        denoised, aux = denoise_fn(x, float(sigma), i)
        x = x + (sigma_down - f32(sigma)).item() * to_d(x, sigma, denoised)
        if noise is not None:
            x = x + noise * self.s_noise * sigma_up.item()
        return x, aux


def denoiser_calls(sampler: EulerEDMSampler, t_start: int = 0, t_end: Optional[int] = None) -> int:
    """Denoiser calls of a loop over [t_start, t_end): one a step, two where
    the sampler's step corrects (`corrects`)."""
    t_start, t_end = sampler.window(t_start, t_end)
    sig = sampler.sigmas().tolist()
    return sum(1 + sampler.corrects(sig[i], sig[i + 1]) for i in range(t_start, t_end))
