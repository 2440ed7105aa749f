"""Copies of a weight in a kernel's layout, kept per weight tensor: K4's
K-major copy (ops/temporal_conv.py::k_major) and K12's tap-major copy
(ops/conv3x3.py::tap_major).

An entry holds while its weight tensor lives, keeps its version counter, its
storage pointer and the dtype asked for, and was not retired by
`invalidate(params)`. A frozen model thus pays one copy per parameter, a
training step one per optimizer update (the update bumps the version).

A parameter refilled in place without a version bump needs `invalidate`:
FSDP all-gathers into the same unsharded Parameter objects before every
forward, keeps their version counters, and the caching allocator can hand back
the same storage. parallel/fsdp.py::fsdp_wrap retires the copies of a wrapped
module's parameters before each of its forwards, so no step runs on the
weights of an earlier one; other models keep theirs.
"""

from __future__ import annotations

import weakref
from typing import Callable, Iterable, List, Tuple

import torch

_CACHES: List["RelayoutCache"] = []


def invalidate(params: Iterable[torch.Tensor]) -> None:
    """Retire the cached copies of these weights (they are made again on
    their next use)."""
    for p in params:
        for cache in _CACHES:
            cache.retire(p)


def _state(weight: torch.Tensor, dtype: torch.dtype) -> tuple:
    """What a copy depends on besides the weight's identity."""
    return weight._version, weight.data_ptr(), dtype


class RelayoutCache:
    """id(weight) -> (weakref to the weight, (version, storage pointer,
    dtype) or None once retired, the copy)."""

    def __init__(self):
        self._entries = {}
        _CACHES.append(self)

    def retire(self, weight: torch.Tensor) -> None:
        hit = self._entries.get(id(weight))
        if hit is not None and hit[0]() is weight:
            self._entries[id(weight)] = (hit[0], None, None)

    def get(self, weight: torch.Tensor, dtype: torch.dtype,
            relayout: Callable[[torch.Tensor, torch.dtype], torch.Tensor]) -> Tuple[torch.Tensor, bool]:
        """(the copy relayout(weight, dtype) made under no_grad, made now?)"""
        key, state = id(weight), _state(weight, dtype)
        hit = self._entries.get(key)
        if hit is not None and hit[0]() is weight and hit[1] == state:
            return hit[2], False
        with torch.no_grad():
            copy = relayout(weight.detach(), dtype)
        if hit is None or hit[0]() is not weight:
            weakref.finalize(weight, self._entries.pop, key, None)
        self._entries[key] = (weakref.ref(weight), state, copy)
        return copy, True
