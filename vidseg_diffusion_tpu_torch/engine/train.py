"""The training steps (PyTorch): diffusion, and the two-phase GAN autoencoder.

Counterpart of vidseg_diffusion_tpu/engine/train.py. make_diffusion_train_step
-> DiffusionTrainStep: one step draws sigma and noise, runs the loss through
the network, back-propagates, applies the optimizer and updates the EMA. The
optimizer is any torch.optim.Optimizer over the model's parameters (JAX takes
an optax transform); `network_factory(model)` returns the callable
network(x, c_noise, cond) -> (out, aux) the denoiser calls, as the JAX
factory closes the network over params. make_autoencoder_train_step ->
AutoencoderTrainStep (train.py:76-123): a generator phase, then a
discriminator phase, each with its own optimizer.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn as nn
from torch.profiler import record_function

from vidseg_diffusion_tpu_torch.diffusion.loss import StandardDiffusionLoss
from vidseg_diffusion_tpu_torch.models.lpips import (
    AutoencoderLossConfig,
    autoencoder_reconstruction_loss,
    generator_adv_loss,
    hinge_d_loss,
    vanilla_d_loss,
)
from vidseg_diffusion_tpu_torch.models.regularizers import DiagonalGaussian
from vidseg_diffusion_tpu_torch.utils.ema import EmaState, ema_init, ema_update


class DiffusionTrainStep:
    """Training state (model, optimizer, EMA, step count) and its step."""

    def __init__(self, model: nn.Module, network_factory: Callable, loss_mod: StandardDiffusionLoss,
                 optimizer: torch.optim.Optimizer, use_ema: bool = True,
                 ema_decay: float = 0.9999):
        self.model = model
        self.network_factory = network_factory
        self.loss_mod = loss_mod
        self.optimizer = optimizer
        self.ema_decay = ema_decay
        self.ema: Optional[EmaState] = ema_init(model) if use_ema else None
        self.step_count = 0

    def step(self, batch: torch.Tensor, cond: Dict[str, torch.Tensor],
             generators: Optional[Tuple[torch.Generator, torch.Generator]] = None,
             sigma: Optional[torch.Tensor] = None,
             noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One step on `batch`; generators = (sigma draw, noise draw), or the
        drawn `sigma` / `noise` themselves. Returns the loss (detached)."""
        self.optimizer.zero_grad(set_to_none=True)
        loss = self.loss_mod(self.network_factory(self.model), batch, cond,
                             generators=generators, sigma=sigma, noise=noise)
        loss.backward()
        with record_function("vs:optimizer"):
            self.optimizer.step()
        if self.ema is not None:
            with record_function("vs:ema"):
                ema_update(self.ema, self.model, decay=self.ema_decay)
        self.step_count += 1
        return loss.detach()


class AutoencoderTrainStep:
    """The two-phase GAN autoencoder step (GeneralLPIPSWithDiscriminator):
    - generator: encode -> DiagonalGaussian -> sample -> decode; L1 + LPIPS
      + KL, plus disc_weight times the adversarial term once global_step >=
      disc_start (before that it is computed and weighted by 0, as in JAX);
      the discriminator's parameters get no gradient in this phase;
    - discriminator: hinge or vanilla loss on x against the reconstruction
      from before the generator's update, detached.
    No adaptive discriminator weight: the JAX package has none.

    encode(x) -> moments [..., 2z] and decode(z) -> recon run under autograd
    over the parameters `gen_optimizer` holds (FirstStage.moments /
    .reconstruct); lpips_fn(x, y) -> [B], or None, is applied as it is (its
    weights are frozen by the caller)."""

    def __init__(self, encode: Callable, decode: Callable, discriminator: nn.Module,
                 lpips_fn: Optional[Callable], gen_optimizer: torch.optim.Optimizer,
                 disc_optimizer: torch.optim.Optimizer,
                 cfg: AutoencoderLossConfig = AutoencoderLossConfig()):
        self.encode, self.decode = encode, decode
        self.discriminator = discriminator
        self.lpips_fn = lpips_fn
        self.gen_optimizer, self.disc_optimizer = gen_optimizer, disc_optimizer
        self.cfg = cfg
        self.d_loss_fn = hinge_d_loss if cfg.disc_loss == "hinge" else vanilla_d_loss
        self.step_count = 0

    def step(self, x: torch.Tensor, global_step: int, noise: Optional[torch.Tensor] = None,
             generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        """One step on frames x [B, H, W, 3] in [-1, 1]; the posterior's noise
        is `noise`, or drawn from `generator`. Returns the logs (detached):
        rec_loss, p_loss (with LPIPS), kl_loss, total, g_adv, g_loss, d_loss."""
        cfg = self.cfg
        self.gen_optimizer.zero_grad(set_to_none=True)
        self.discriminator.requires_grad_(False)
        try:
            with record_function("vs:ae:encoder"):
                post = DiagonalGaussian.from_moments(self.encode(x))
            with record_function("vs:ae:decoder"):
                recon = self.decode(post.sample(noise, generator))
            with record_function("vs:ae:lpips"):
                loss, logs = autoencoder_reconstruction_loss(self.lpips_fn, x, recon, post.kl(), cfg)
            with record_function("vs:ae:discriminator"):
                adv = generator_adv_loss(self.discriminator(recon))
            g_loss = loss + float(global_step >= cfg.disc_start) * cfg.disc_weight * adv
            g_loss.backward()
        finally:
            self.discriminator.requires_grad_(True)
        with record_function("vs:optimizer"):
            self.gen_optimizer.step()

        self.disc_optimizer.zero_grad(set_to_none=True)
        with record_function("vs:ae:discriminator"):
            d_loss = self.d_loss_fn(self.discriminator(x), self.discriminator(recon.detach()))
        d_loss.backward()
        with record_function("vs:optimizer"):
            self.disc_optimizer.step()
        self.step_count += 1
        logs = dict(logs, g_adv=adv, g_loss=g_loss, d_loss=d_loss)
        return {k: v.detach() for k, v in logs.items()}
