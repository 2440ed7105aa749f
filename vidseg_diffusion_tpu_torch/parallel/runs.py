"""The 2 * num_masks (mask, +/-lambda) modulated runs split over the ranks of
a process group: the counterpart of the JAX package's 'runs' mesh axis
(pipelines/single_video.py:526-546, engine/vidseg.py modulated_runs_sharded
and _decode_runs_sharded), which shards the runs grid over the devices of
one process.

Run r = sign * num_masks + mask (+lambda first), as on one process. The rank
q of a group of W takes the masks k = q (mod W) and both signs of each, so it
holds whole (+lambda, -lambda) pairs. Outputs come back to every rank in run
order by one all_gather, each rank's runs padded to the most any rank holds
(rank 0's); a rank with no mask joins with padding alone.
"""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.distributed as dist


def group_device(group) -> torch.device:
    """The device a collective of the group takes its tensors on: this
    process's card under NCCL, else the CPU."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def runs_of_rank(num_masks: int, rank: int, world: int) -> List[int]:
    """The runs rank `rank` of `world` takes, ascending."""
    return [r for r in range(2 * num_masks) if (r % num_masks) % world == rank]


def broadcast_from_first(obj, group):
    """`obj` as the group's first rank has it (pickled; tensors inside must
    lie on the CPU)."""
    box = [obj]
    dist.broadcast_object_list(box, src=dist.get_global_rank(group, 0), group=group)
    return box[0]


def all_gather_runs(local: Dict[int, torch.Tensor], num_masks: int, group) -> torch.Tensor:
    """{run: tensor} of this rank's runs -> [2 * num_masks, ...] of every
    rank's, in run order, on every rank. All runs share one shape and dtype;
    the first rank (which holds mask 0) tells the others."""
    rank, world = dist.get_rank(group), dist.get_world_size(group)
    mine = runs_of_rank(num_masks, rank, world)
    assert sorted(local) == mine, (sorted(local), mine)
    first = local[mine[0]] if mine else None
    shape, dtype = broadcast_from_first((tuple(first.shape), first.dtype) if rank == 0 else None, group)
    device = first.device if first is not None else group_device(group)
    most = len(runs_of_rank(num_masks, 0, world))
    mine_stacked = torch.zeros((most,) + shape, dtype=dtype, device=device)
    for i, r in enumerate(mine):
        mine_stacked[i] = local[r]
    gathered = [torch.empty_like(mine_stacked) for _ in range(world)]
    dist.all_gather(gathered, mine_stacked, group=group)
    out = torch.empty((2 * num_masks,) + shape, dtype=dtype, device=device)
    for q in range(world):
        for i, r in enumerate(runs_of_rank(num_masks, q, world)):
            out[r] = gathered[q][i]
    return out


def all_reduce_sum(n: int, group) -> int:
    """The sum over the group's ranks of an integer count."""
    t = torch.tensor([n], dtype=torch.int64, device=group_device(group))
    dist.all_reduce(t, group=group)
    return int(t.item())
