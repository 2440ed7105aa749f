"""The rest of the sampler family (PyTorch), of
vidseg_diffusion_tpu/diffusion/sampling_extra.py: DPM-Solver++(2S) ancestral,
DPM-Solver++(2M), linear multistep, conditioning-swap `edit` and null-text
inversion (`null_text_optimization`), the reference's sampling.py:298-646.

As in diffusion/sampling.py the sigma arithmetic is fp32 and the per-step
noise comes as `noise[k]` or from a generator. DPM++ 2S runs only the branch
it takes (JAX evaluates both under jnp.where), so it makes 2n - 1 denoiser
calls for n steps whose last sigma_down is 0. `edit` calls the edit
denoiser inside its window for the denoised value and the base denoiser at
every step for the aux, as JAX returns the base branch's aux.
`null_text_optimization` writes optax's scale_by_adam update itself on torch
autograd.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from vidseg_diffusion_tpu_torch.diffusion.sampling import EulerEDMSampler, f32, get_ancestral_step, to_d


def _t(sigma) -> torch.Tensor:
    return -torch.log(f32(sigma))


def _sigma(t: torch.Tensor) -> torch.Tensor:
    return torch.exp(-t)


@dataclasses.dataclass(frozen=True)
class DPMPP2SAncestralSampler(EulerEDMSampler):
    """DPM-Solver++(2S) with ancestral noise (sampling.py:521-575): the Euler
    step where sigma_down is 0, else the midpoint correction."""

    eta: float = 1.0

    def corrects(self, sigma, next_sigma) -> bool:
        return get_ancestral_step(sigma, next_sigma, eta=self.eta)[0].item() >= 1e-14

    def step(self, denoise_fn, x, sigma, next_sigma, i: int, gamma: float = 0.0,
             noise: Optional[torch.Tensor] = None):
        sigma_down, sigma_up = get_ancestral_step(sigma, next_sigma, eta=self.eta)
        denoised, aux = denoise_fn(x, float(sigma), i)
        if not self.corrects(sigma, next_sigma):
            x = x + (sigma_down - f32(sigma)).item() * to_d(x, sigma, denoised)
        else:
            t, t_next = _t(sigma), _t(sigma_down)
            h = t_next - t
            s = t + 0.5 * h
            x2 = (_sigma(s) / _sigma(t)).item() * x - torch.expm1(-0.5 * h).item() * denoised
            denoised2, _ = denoise_fn(x2, _sigma(s).item(), i)
            x = (_sigma(t_next) / _sigma(t)).item() * x - torch.expm1(-h).item() * denoised2
        if noise is not None:
            x = x + noise * self.s_noise * sigma_up.item()
        return x, aux


@dataclasses.dataclass(frozen=True)
class DPMPP2MSampler(EulerEDMSampler):
    """DPM-Solver++(2M) (sampling.py:578-646): carries the previous denoised
    estimate and step size; the last step to sigma = 0 returns `denoised`."""

    def __call__(self, denoise_fn, x, *, t_start: int = 0, t_end: Optional[int] = None,
                 post_step_fn=None, noise=None, generator=None, prescale: bool = True):
        t_start, t_end = self.window(t_start, t_end)
        sig = self.sigmas()
        sigmas = sig.tolist()
        if prescale:
            x = self.prescale(x, sig)
        old_denoised, old_h, auxes = None, None, []
        for i in range(t_start, t_end):
            denoised, aux = denoise_fn(x, sigmas[i], i)
            t, t_next = _t(sigmas[i]), _t(max(sigmas[i + 1], 1e-10))
            h = t_next - t
            mixed = denoised
            if old_denoised is not None:
                r = old_h / h
                mixed = (1 + 1 / (2 * r)).item() * denoised - (1 / (2 * r)).item() * old_denoised
            if sigmas[i + 1] < 1e-14:
                x = denoised
            else:
                x = (_sigma(t_next) / _sigma(t)).item() * x - torch.expm1(-h).item() * mixed
            if post_step_fn is not None:
                x = post_step_fn(x, i)
            old_denoised, old_h = denoised, h
            auxes.append(aux)
        return x, auxes


def linear_multistep_coeff(order: int, sigmas: np.ndarray, i: int, j: int) -> float:
    """The integral of the j-th Lagrange basis polynomial over [sigma_i,
    sigma_i+1] (sampling_utils.py, scipy quad)."""
    from scipy import integrate

    if order - 1 > i:
        raise ValueError(f"order {order} too high for step {i}")

    def fn(tau):
        prod = 1.0
        for k in range(order):
            if j != k:
                prod *= (tau - sigmas[i - k]) / (sigmas[i - j] - sigmas[i - k])
        return prod

    return integrate.quad(fn, sigmas[i], sigmas[i + 1], epsrel=1e-4)[0]


def lms_coefficients(sigmas: torch.Tensor, t_start: int, t_end: int, order: int) -> np.ndarray:
    """[t_end - t_start, order] fp32: loop step si's coefficients, its order
    capped at si + 1 (only si + 1 derivatives exist there, also when
    t_start > 0), zero-padded (JAX sampling_extra.py:166-176)."""
    sig64 = sigmas.double().numpy()
    coeffs = np.zeros((t_end - t_start, order), dtype=np.float32)
    for si, i in enumerate(range(t_start, t_end)):
        cur = min(si + 1, order)
        for j in range(cur):
            coeffs[si, j] = linear_multistep_coeff(cur, sig64, i, j)
    return coeffs


@dataclasses.dataclass(frozen=True)
class LinearMultistepSampler(EulerEDMSampler):
    """LMS (sampling.py:457-492): x += sum_j c_j d_{k-j} over the last
    `order` derivatives, the coefficient table built on the host."""

    order: int = 4

    def __call__(self, denoise_fn, x, *, t_start: int = 0, t_end: Optional[int] = None,
                 post_step_fn=None, noise=None, generator=None, prescale: bool = True):
        t_start, t_end = self.window(t_start, t_end)
        sig = self.sigmas()
        sigmas = sig.tolist()
        coeffs = lms_coefficients(sig, t_start, t_end, self.order)
        if prescale:
            x = self.prescale(x, sig)
        ds, auxes = [], []
        for si, i in enumerate(range(t_start, t_end)):
            denoised, aux = denoise_fn(x, sigmas[i], i)
            ds = [to_d(x, sigmas[i], denoised)] + ds[: self.order - 1]
            upd = sum(float(c) * d for c, d in zip(coeffs[si], ds))
            x = x + upd
            if post_step_fn is not None:
                x = post_step_fn(x, i)
            auxes.append(aux)
        return x, auxes


def edit(sampler: EulerEDMSampler, denoise_fn_base: Callable, denoise_fn_edit: Callable, x: torch.Tensor,
         edit_start_step: int = 5, edit_end_step: int = 24, **kwargs):
    """Conditioning-swap editing (sampling.py:381-415): at the steps i with
    edit_start_step <= i <= edit_end_step the edit denoiser's value drives the
    sampler; every step returns the base denoiser's aux."""

    def denoise_fn(xc, sigma, i):
        base, aux = denoise_fn_base(xc, sigma, i)
        if edit_start_step <= i <= edit_end_step:
            return denoise_fn_edit(xc, sigma, i)[0], aux
        return base, aux

    return sampler(denoise_fn, x, **kwargs)


def null_text_optimization(sampler: EulerEDMSampler, make_denoise_fn: Callable, latents_inv: torch.Tensor,
                           uc_crossattn: torch.Tensor, num_inner_steps: int = 10, lr: float = 1e-2,
                           on_loss: Optional[Callable] = None):
    """Null-text inversion (sampling.py:298-378): for each outer step i,
    `num_inner_steps` Adam steps on a copy of uc_crossattn so one sampler step
    from the current latent reproduces latents_inv[n - i - 1], at the step
    size lr * (1 - i / 100); then the latent advances under the optimized uc.
    Returns the optimized uc of every step. The Adam update is optax's
    scale_by_adam (b1 0.9, b2 0.999, eps 1e-8, bias-corrected moments).
    `on_loss(i, inner, loss)` sees every loss (a 0-dim tensor)."""
    b1, b2, eps = 0.9, 0.999, 1e-8
    n = sampler.num_steps
    sigmas = sampler.sigmas().tolist()
    latent_cur = latents_inv[-1]
    uc_list = []
    for i in range(n):
        target = latents_inv[n - i - 1]
        lr_t = float(np.float32(lr * (1.0 - i / 100.0)))
        uc = uc_crossattn.detach().clone()
        mu, nu = torch.zeros_like(uc), torch.zeros_like(uc)
        for count in range(1, num_inner_steps + 1):
            leaf = uc.detach().requires_grad_(True)
            with torch.enable_grad():
                x_next, _ = sampler.step(make_denoise_fn(leaf), latent_cur, sigmas[i], sigmas[i + 1], i)
                loss = torch.mean((x_next - target) ** 2)
                (grad,) = torch.autograd.grad(loss, leaf)
            if on_loss is not None:
                on_loss(i, count - 1, loss.detach())
            mu = b1 * mu + (1 - b1) * grad
            nu = b2 * nu + (1 - b2) * grad * grad
            mu_hat = mu / (1 - f32(b1) ** count).item()
            nu_hat = nu / (1 - f32(b2) ** count).item()
            uc = uc - lr_t * (mu_hat / (torch.sqrt(nu_hat) + eps))
        uc_list.append(uc)
        with torch.no_grad():
            latent_cur = sampler.step(make_denoise_fn(uc), latent_cur, sigmas[i], sigmas[i + 1], i)[0]
    return uc_list
