"""Fully sharded data-parallel training of the UNet over torch.distributed.

Counterpart of vidseg_diffusion_tpu/parallel/fsdp.py. JAX annotates every
parameter and its optimizer state with a sharding over the 'data' mesh axis
(fsdp_shardings, :49) and lets XLA place the all-gathers and the gradients'
reduce-scatters (fsdp_train_step, :83-105). Here FSDP2 (fully_shard) does the
same over the ranks of a process group:

- `leaf_shard_dim(shape, world)` is JAX's _leaf_spec (:33-46): the largest
  dim divisible by the world size, the first of equal ones, or none. It reads
  the JAX layout, so `param_shard_dim` hands it a port parameter's JAX-layout
  shape and maps its choice back through io/convert.py's permutation: each
  weight shards along the same logical axis in both packages (a square 3x3
  conv, HWIO [3, 3, C, C] in JAX, shards on Cin, torch dim 1 of [C, C, 3, 3],
  not on the Cout a torch-layout reading would pick).
- Leaves JAX replicates (no dim divisible by the world: the AlphaBlenders'
  [1] mix_factor, biases and norms of odd width) take FSDP's default instead,
  Shard(0), padded where the world does not divide dim 0. FSDP keeps no
  replicated parameter; the values and the step are the same.
- `fsdp_wrap(model)` shards each module of every UNet input, middle and
  output block (the blocks are ModuleLists, which FSDP cannot hook: their
  modules are what the UNet calls), then the root with the rest (time and
  label embeddings, the output head): `wrapped_modules`. Before each forward
  of a wrapped module it retires the K4 / K12 weight copies of that module's
  parameters (ops/relayout.py): FSDP refills the same unsharded Parameter
  objects on every all-gather without a version bump.
- `FSDPTrainStep` is engine/train.py::DiffusionTrainStep on the wrapped
  model; its optimizer and EMA are made over the wrapped (sharded)
  parameters, and the EMA updates them shard for shard. Its step takes the
  whole batch, draws sigma and noise for all of it as the one-process step
  does, and runs on this rank's contiguous share of each (`rank_share`, whole
  videos): JAX's batch_sharding. FSDP averages the gradients over the ranks,
  so with equal shares the step is the one-process step on the whole batch.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn as nn

from vidseg_diffusion_tpu_torch.engine.train import DiffusionTrainStep
from vidseg_diffusion_tpu_torch.ops import relayout

# io/convert.py's to_torch_layout of a flax kernel: torch dim i is JAX dim PERM[i]
_TO_TORCH = {2: (1, 0), 4: (3, 2, 0, 1), 5: (4, 3, 0, 1, 2)}


def leaf_shard_dim(shape: Sequence[int], world: int) -> Optional[int]:
    """JAX _leaf_spec's sharded dim of a JAX-layout shape, or None."""
    best = None
    for i, d in enumerate(shape):
        if d % world == 0 and d >= world and (best is None or d > shape[best]):
            best = i
    return best


def is_kernel(module: nn.Module, name: str, param: torch.Tensor) -> bool:
    """A weight io/convert.py moves from a flax 'kernel' (transposed): Linear,
    Conv2d and the temporal Conv3d layouts; not Embedding or norm weights."""
    return name == "weight" and param.dim() in _TO_TORCH and not isinstance(module, nn.Embedding)


def param_shard_dim(shape: Sequence[int], kernel: bool, world: int) -> Optional[int]:
    """The torch dim a port parameter shards on: leaf_shard_dim of its JAX
    layout (`kernel`: a flax kernel's transposed layout), mapped back."""
    if not kernel:
        return leaf_shard_dim(shape, world)
    perm = _TO_TORCH[len(shape)]
    jax_shape = [0] * len(shape)
    for i, j in enumerate(perm):
        jax_shape[j] = shape[i]
    d = leaf_shard_dim(jax_shape, world)
    return None if d is None else perm.index(d)


def shard_dims(model: nn.Module, world: int):
    """{parameter name: its shard dim or None} over the model."""
    out = {}
    for mod_name, module in model.named_modules():
        for name, p in module.named_parameters(recurse=False):
            full = f"{mod_name}.{name}" if mod_name else name
            out[full] = param_shard_dim(tuple(p.shape), is_kernel(module, name, p), world)
    return out


def wrapped_modules(model: nn.Module) -> List[nn.Module]:
    """The modules fsdp_wrap shards, in its order: each module of every UNet
    input, middle and output block that holds parameters, then the root."""
    mods = [module for blocks in (model.input_blocks, [model.middle_block], model.output_blocks)
            for block in blocks for module in block if any(True for _ in module.parameters())]
    return mods + [model]


def fsdp_wrap(model: nn.Module) -> nn.Module:
    """Shard `model` (a UNetModel) in place with FSDP2 over the ranks of the
    default process group and return it."""
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import Shard

    mesh = DeviceMesh.from_group(dist.group.WORLD, next(model.parameters()).device.type)
    by_name = shard_dims(model, mesh.size())
    dims = {id(p): by_name[n] for n, p in model.named_parameters()}

    def placement(p: nn.Parameter):
        d = dims.get(id(p))
        return None if d is None else Shard(d)

    modules = wrapped_modules(model)
    for module in modules:
        fully_shard(module, mesh=mesh, shard_placement_fn=placement)
    for module in modules:   # after FSDP's own pre-hook, which gathers the parameters
        module.register_forward_pre_hook(lambda mod, args: relayout.invalidate(mod.parameters()))
    return model


def rank_share(x: torch.Tensor, unit: int = 1) -> torch.Tensor:
    """This rank's contiguous share of a batch whose leading axis holds whole
    items of `unit` rows (a video's frames), the items split evenly over the
    ranks of the default group."""
    items, world, rank = x.shape[0] // unit, dist.get_world_size(), dist.get_rank()
    if items * unit != x.shape[0] or items % world:
        raise ValueError(f"a batch of {x.shape[0]} rows is not {world} equal shares of whole {unit}-row items")
    n = x.shape[0] // world
    return x[rank * n:(rank + 1) * n]


class FSDPTrainStep(DiffusionTrainStep):
    """DiffusionTrainStep on an fsdp_wrap'ed model, each rank on its share of
    the batch (`unit` rows an item: a video's frames)."""

    def __init__(self, *args, unit: int = 1, **kwargs):
        super().__init__(*args, **kwargs)
        self.unit = unit

    def step(self, batch: torch.Tensor, cond: Dict[str, torch.Tensor],
             generators: Optional[Tuple[torch.Generator, torch.Generator]] = None,
             sigma: Optional[torch.Tensor] = None,
             noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One step on the whole batch (the same on every rank): sigma and
        noise drawn for all of it as DiffusionTrainStep draws them, then this
        rank's share of each. Returns the whole batch's loss."""
        sigma, noise = self.loss_mod.draw(batch, generators, sigma, noise)
        share = lambda x: rank_share(x, self.unit)
        loss = super().step(share(batch), {k: share(v) for k, v in cond.items()},
                            sigma=share(sigma), noise=share(noise))
        dist.all_reduce(loss)
        return loss / dist.get_world_size()


def full_tensor(p: torch.Tensor) -> torch.Tensor:
    """A parameter (or its EMA) whole on every rank: a DTensor gathered, a
    plain tensor as it is."""
    return p.full_tensor() if hasattr(p, "full_tensor") else p


def replicated_state(model: nn.Module, ema=None) -> Tuple[dict, Optional[dict]]:
    """({name: whole parameter}, {name: whole EMA tensor} or None) on every
    rank, detached."""
    params = {n: full_tensor(p.detach()) for n, p in model.named_parameters()}
    shadows = None if ema is None else {n: full_tensor(e) for n, e in ema.params.items()}
    return params, shadows
