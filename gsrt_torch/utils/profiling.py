"""Tracing and stage timers (counterpart of `gsrt.utils.profiling`).

`StageTimer` times named stages across frames: on the card with CUDA
events around each stage (read once, in `report`), on the CPU with the
host clock. `device_sync` waits for the devices of the given tensors.
`torch_trace` records a `torch.profiler` trace (CPU and, where there is
one, CUDA activity) and writes it as a Chrome trace, the counterpart of
`gsrt`'s `xla_trace`.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, List

import torch

from gsrt_torch.core.types import resolve_device


def device_sync(*tensors) -> None:
    """Wait for the work queued on each CUDA tensor's device."""
    for t in tensors:
        if isinstance(t, torch.Tensor) and t.is_cuda:
            torch.cuda.synchronize(t.device)


class StageTimer:
    """Accumulates the time of each named stage across frames, on
    `device` (CUDA unless named): CUDA events there, the host clock on
    the CPU."""

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self._cuda = self.device.type == "cuda"
        self.totals: Dict[str, float] = {}     # seconds, host-timed stages
        self.counts: Dict[str, int] = {}
        self._events: Dict[str, List[tuple]] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        if self._cuda:
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            yield
            end.record()
            self._events.setdefault(name, []).append((start, end))
        else:
            t0 = time.perf_counter()
            yield
            self.totals[name] = (self.totals.get(name, 0.0)
                                 + time.perf_counter() - t0)
        self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> Dict[str, float]:
        """Mean ms a stage, rounded to 0.01 ms."""
        if self._events:
            torch.cuda.synchronize(self.device)
            for name, pairs in self._events.items():
                self.totals[name] = self.totals.get(name, 0.0) + sum(
                    s.elapsed_time(e) for s, e in pairs) * 1e-3
            self._events.clear()
        return {k: round(self.totals[k] / max(self.counts[k], 1) * 1e3, 2)
                for k in self.totals}


@contextlib.contextmanager
def torch_trace(log_dir: str):
    """torch.profiler trace of the block, written to
    `log_dir/trace.json` (open in Perfetto or chrome://tracing)."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
