"""First-stage latent regularizers (PyTorch).

Counterpart of vidseg_diffusion_tpu/models/regularizers.py: the diagonal
Gaussian posterior (DiagonalGaussianRegularizer and
DiagonalGaussianDistribution of the reference), nearest-codebook vector
quantization with its EMA variant, and Gumbel quantization (quantize.py).
Random draws are explicit: a noise or uniform tensor, or a torch.Generator,
so a test can hand the port the arrays JAX drew. Straight-through gradients
go through z + (zq - z).detach().
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class DiagonalGaussian:
    """Posterior N(mean, diag(var)) from concatenated moments [..., 2z]."""

    mean: torch.Tensor
    logvar: torch.Tensor

    @classmethod
    def from_moments(cls, moments: torch.Tensor) -> "DiagonalGaussian":
        mean, logvar = moments.chunk(2, dim=-1)
        return cls(mean=mean, logvar=logvar.clamp(-30.0, 20.0))

    def sample(self, noise: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """mean + std * noise; the noise is drawn from `generator` unless given."""
        if noise is None:
            noise = torch.randn(self.mean.shape, generator=generator, device=self.mean.device,
                                dtype=self.mean.dtype)
        return self.mean + torch.exp(0.5 * self.logvar) * noise.to(self.mean.dtype)

    def mode(self) -> torch.Tensor:
        return self.mean

    def kl(self) -> torch.Tensor:
        """KL to N(0, I), summed over the non-batch dims (distributions.py:60-82)."""
        per = 0.5 * (self.mean ** 2 + torch.exp(self.logvar) - 1.0 - self.logvar)
        return per.reshape(per.shape[0], -1).sum(dim=1)


def diagonal_gaussian_regularizer(
    moments: torch.Tensor, noise: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None, sample: bool = True,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(z, log) like DiagonalGaussianRegularizer.forward (:21-31): a sample
    when asked for one and a draw is given (noise or generator), else the mode."""
    post = DiagonalGaussian.from_moments(moments)
    drawn = noise is not None or generator is not None
    z = post.sample(noise, generator) if (sample and drawn) else post.mode()
    return z, {"kl_loss": post.kl().mean()}


def _nearest(flat: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    d2 = ((flat ** 2).sum(dim=1, keepdim=True) - 2.0 * flat @ codebook.T
          + (codebook ** 2).sum(dim=1)[None])
    return d2.argmin(dim=1)


def vector_quantize(
    z: torch.Tensor, codebook: torch.Tensor, beta: float = 0.25,
) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]:
    """Nearest-codebook quantization of z [..., D] with the codebook [N, D],
    straight-through gradients and the commitment loss (VectorQuantizer).
    Returns (z_q, indices, log)."""
    idx = _nearest(z.reshape(-1, z.shape[-1]), codebook)
    zq = codebook[idx].reshape(z.shape)
    commit = ((zq.detach() - z) ** 2).mean()
    embed = ((zq - z.detach()) ** 2).mean()
    zq_st = z + (zq - z).detach()
    return zq_st, idx.reshape(z.shape[:-1]), {"vq_loss": beta * commit + embed}


@dataclasses.dataclass(frozen=True)
class EMACodebook:
    """State of EMAVectorQuantizer (quantize.py:302-353, the EmbeddingEMA
    buffers) as explicit tensors: an update returns a new state."""

    weight: torch.Tensor        # [N, D]
    cluster_size: torch.Tensor  # [N]
    embed_avg: torch.Tensor     # [N, D]
    decay: float = 0.99
    eps: float = 1e-5

    @classmethod
    def create(cls, n_embed: int, dim: int, generator: Optional[torch.Generator] = None,
               **kw) -> "EMACodebook":
        w = torch.randn(n_embed, dim, generator=generator)
        return cls(weight=w, cluster_size=torch.zeros(n_embed), embed_avg=w.clone(), **kw)


def ema_vector_quantize(
    z: torch.Tensor, codebook: EMACodebook, beta: float = 0.25, train: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, torch.Tensor], EMACodebook]:
    """EMAVectorQuantizer.forward (quantize.py:355-445): nearest-codebook
    lookup, straight-through gradients, the commitment loss only, and in
    training the EMA codebook update with Laplace-smoothed cluster sizes.
    Returns (z_q, indices, log, new codebook)."""
    flat = z.reshape(-1, z.shape[-1])
    idx = _nearest(flat, codebook.weight)
    n_embed = codebook.weight.shape[0]
    onehot = F.one_hot(idx, n_embed).to(flat.dtype)
    avg_probs = onehot.mean(dim=0)
    perplexity = torch.exp(-(avg_probs * torch.log(avg_probs + 1e-10)).sum())

    new_cb = codebook
    if train:
        d = codebook.decay
        with torch.no_grad():
            cluster = d * codebook.cluster_size + (1 - d) * onehot.sum(dim=0)
            embed_avg = d * codebook.embed_avg + (1 - d) * (onehot.T @ flat)
            n = cluster.sum()
            smoothed = (cluster + codebook.eps) / (n + n_embed * codebook.eps) * n
        new_cb = dataclasses.replace(codebook, weight=embed_avg / smoothed[:, None],
                                     cluster_size=cluster, embed_avg=embed_avg)

    zq = codebook.weight[idx].reshape(z.shape)
    loss = beta * ((zq.detach() - z) ** 2).mean()
    zq_st = z + (zq - z).detach()
    return zq_st, idx.reshape(z.shape[:-1]), {"loss/vq": loss, "perplexity": perplexity}, new_cb


def gumbel_quantize(
    logits: torch.Tensor, codebook: torch.Tensor, uniform: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None, tau: float = 1.0, hard: bool = True,
    kl_weight: float = 5e-4,
) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]:
    """GumbelQuantizer.forward (quantize.py:64-157) on codebook logits
    [..., N]: gumbel-softmax with the noise from a uniform draw on
    [1e-10, 1) (`uniform`, or drawn from `generator`), or the deterministic
    softmax when neither is given (the eval path, JAX's rng=None); hard
    straight-through selection; the KL-to-uniform diversity loss.
    Returns (z_q, indices, log)."""
    n_embed = codebook.shape[0]
    if uniform is not None or generator is not None:
        if uniform is None:
            uniform = 1e-10 + (1.0 - 1e-10) * torch.rand(logits.shape, generator=generator,
                                                         device=logits.device)
        g = -torch.log(-torch.log(uniform.to(logits.dtype)))
        y_soft = torch.softmax((logits + g) / tau, dim=-1)
    else:
        y_soft = torch.softmax(logits / tau, dim=-1)
    idx = y_soft.argmax(dim=-1)
    if hard:
        y_hard = F.one_hot(idx, n_embed).to(y_soft.dtype)
        y = y_soft + (y_hard - y_soft).detach()
    else:
        y = y_soft
    zq = y @ codebook
    qy = torch.softmax(logits, dim=-1)
    kl = kl_weight * (qy * torch.log(qy * n_embed + 1e-10)).sum(dim=-1).mean()
    return zq, idx, {"loss/vq": kl}
