"""The process group, and each process's share of a work list.

Counterpart of vidseg_diffusion_tpu/parallel/mesh.py's two functions that
cross processes, initialize_distributed (:57-78) and process_slice (:81-88),
over torch.distributed. The JAX module's in-process device mesh (make_mesh
and its shardings) serves one TPU host's chips and is not ported: a torch
process drives one card, and the ranks of a group take the work JAX spreads
over a mesh's devices (parallel/runs.py, parallel/fsdp.py).
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist


def initialize_distributed(coordinator_address: Optional[str] = None, num_processes: Optional[int] = None,
                           process_id: Optional[int] = None, device: str = "cuda"):
    """Join the default process group and return it; a second call returns
    the group already joined.

    `coordinator_address` is host:port (tcp://) or a full init URL
    (file://...); without one the group is read from the environment
    torchrun sets (env://: MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK).
    `num_processes` / `process_id` default to WORLD_SIZE / RANK. On the card
    (the default) the backend is NCCL and this process takes the card
    LOCAL_RANK (or process_id modulo the cards); device="cpu" asks for gloo.
    Without a card the default raises instead of falling back."""
    if dist.is_initialized():
        return dist.group.WORLD
    card = None
    if torch.device(device).type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("initialize_distributed: no CUDA card (pass device='cpu' for gloo)")
        local = os.environ.get("LOCAL_RANK")
        card = torch.device("cuda", int(local) if local is not None
                            else (process_id or 0) % torch.cuda.device_count())
        torch.cuda.set_device(card)
    backend = "gloo" if card is None else "nccl"
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = "tcp://" + coordinator_address
    dist.init_process_group(backend, init_method=init_method,
                            world_size=-1 if num_processes is None else num_processes,
                            rank=-1 if process_id is None else process_id, device_id=card)
    return dist.group.WORLD


def process_slice(n_items: int) -> slice:
    """This process's contiguous share of a length-n work list (JAX's
    process_slice): the first n % world ranks take one item more; the whole
    list outside a process group."""
    world, rank = (dist.get_world_size(), dist.get_rank()) if dist.is_initialized() else (1, 0)
    base, rem = divmod(n_items, world)
    start = rank * base + min(rank, rem)
    return slice(start, start + base + (1 if rank < rem else 0))
