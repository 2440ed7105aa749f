"""Tracing and step timing (PyTorch).

Counterpart of vidseg_diffusion_tpu/utils/profiling.py, on torch.profiler:
- `trace(logdir)`: profiles the block (CPU, and CUDA when a card is there)
  and writes a Chrome trace, `trace.json`, into logdir;
- `annotate(name)`: a record_function range, a named span in the trace;
- `StepTimer`: host-clock step times that wait for the device: a stage's
  registered output (or a `measure`d call's) has its device synchronized
  (torch.cuda.synchronize on a CUDA tensor) before the clock is read, where
  the JAX package calls block_until_ready.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Dict, List, Optional

import torch
from torch.profiler import ProfilerActivity, profile, record_function


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block; on exit write logdir/trace.json (Chrome format).
    Yields the profiler (its key_averages() sums by kernel)."""
    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def annotate(name: str):
    return record_function(name)


def _wait(out) -> None:
    """Synchronize the devices of the CUDA tensors in `out` (a tensor or a
    tuple / list / dict of them)."""
    if isinstance(out, torch.Tensor):
        if out.is_cuda:
            torch.cuda.synchronize(out.device)
    elif isinstance(out, (tuple, list)):
        for o in out:
            _wait(o)
    elif isinstance(out, dict):
        for o in out.values():
            _wait(o)


class StepTimer:
    """Named step timings on the host clock, each after its output's device
    finished."""

    def __init__(self):
        self.records: Dict[str, List[float]] = {}

    @contextlib.contextmanager
    def time(self, name: str):
        """`with timer.time('stage') as done: out = step(); done(out)`:
        register the stage's output so the timer waits for its device;
        without it only the launch is timed."""
        holder = []
        t0 = time.perf_counter()
        yield holder.append
        if holder:
            _wait(holder[0])
        self.records.setdefault(name, []).append(time.perf_counter() - t0)

    def measure(self, name: str, fn, *args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        _wait(out)
        self.records.setdefault(name, []).append(time.perf_counter() - t0)
        return out

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {name: {"count": len(ts), "total_s": sum(ts), "mean_s": sum(ts) / len(ts), "min_s": min(ts),
                       "max_s": max(ts)} for name, ts in self.records.items()}

    def dump(self, path: Optional[str] = None) -> str:
        s = json.dumps(self.summary(), indent=2)
        if path:
            with open(path, "w") as f:
                f.write(s)
        return s
