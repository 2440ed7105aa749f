"""The diffusion training step (PyTorch).

Counterpart of vidseg_diffusion_tpu/engine/train.py::make_diffusion_train_step:
one step draws sigma and noise, runs the loss through the network, back-
propagates, applies the optimizer and updates the EMA. The optimizer is any
torch.optim.Optimizer over the model's parameters (JAX takes an optax
transform); `network_factory(model)` returns the callable
network(x, c_noise, cond) -> (out, aux) the denoiser calls, as the JAX
factory closes the network over params. The two-phase GAN autoencoder step
(train.py:76-123) comes with the autoencoder-training slice.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn as nn
from torch.profiler import record_function

from vidseg_diffusion_tpu_torch.diffusion.loss import StandardDiffusionLoss
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
