"""EDM sigma discretization (PyTorch).

Counterpart of vidseg_diffusion_tpu/diffusion/discretization.py
(EDMDiscretization, the Karras rho-ramp; SVD uses sigma_max = 700). The
schedule is computed in float64 numpy and returned as fp32, as there.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class EDMDiscretization:
    sigma_min: float = 0.002
    sigma_max: float = 80.0
    rho: float = 7.0

    def get_sigmas(self, n: int) -> torch.Tensor:
        ramp = np.linspace(0.0, 1.0, n)
        min_inv_rho = self.sigma_min ** (1.0 / self.rho)
        max_inv_rho = self.sigma_max ** (1.0 / self.rho)
        sigmas = (max_inv_rho + ramp * (min_inv_rho - max_inv_rho)) ** self.rho
        return torch.tensor(sigmas, dtype=torch.float32)

    def __call__(self, n: int, do_append_zero: bool = True) -> torch.Tensor:
        sigmas = self.get_sigmas(n)
        if do_append_zero:
            sigmas = torch.cat([sigmas, sigmas.new_zeros(1)])
        return sigmas
