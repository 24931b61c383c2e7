"""Render statistics (counterpart of `gsrt.utils.stats`).

Carries over the quantities the reference's simulator reported
(gpu-sim.cc print_stats: rt_n_total_rays, rt_num_hits, rt_avg_nodes_per_ray
— SURVEY.md §5) in renderer-level terms, plus the app-level Mrays/s
(RayTracer.cpp:180-183). The fields and the JSON are `gsrt`'s; the means
are taken in NumPy as `gsrt` takes them, so one output gives one record.
"""

from __future__ import annotations

import dataclasses
import json
import time

import torch

from gsrt_torch.utils.image import as_numpy


@dataclasses.dataclass
class RenderStats:
    width: int = 0
    height: int = 0
    samples: int = 1
    n_splats: int = 0
    total_pairs: int = 0            # (tile, splat) pairs — traversal work
    frame_time_s: float = 0.0
    mrays_per_s: float = 0.0        # W·H·spp / time (reference definition)
    mean_hits_per_pixel: float = 0.0
    max_hits_per_pixel: int = 0
    mean_passes_per_pixel: float = 0.0  # k-buffer pass count analogue
    mean_transmittance: float = 0.0
    overflow: bool = False
    hits_granularity: str = "pixel"  # "pixel": exact per-pixel counts
                                     # (reference / fast paths);
                                     # "tile-pairs": the tiled path reports
                                     # its tile's pair count for every
                                     # pixel of the tile (candidates, not
                                     # accepted hits)

    def finish(self, dt: float) -> "RenderStats":
        self.frame_time_s = dt
        rays = self.width * self.height * self.samples
        self.mrays_per_s = rays / dt / 1e6 if dt > 0 else 0.0
        return self

    def from_output(self, out, hits_granularity: str = None
                    ) -> "RenderStats":
        if hits_granularity is not None:
            self.hits_granularity = hits_granularity
        hits = as_numpy(out.hits)
        self.mean_hits_per_pixel = float(hits.mean())
        self.max_hits_per_pixel = int(hits.max())
        self.mean_passes_per_pixel = float(as_numpy(out.passes).mean())
        self.mean_transmittance = float(as_numpy(out.trans).mean())
        return self

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))


def _sync() -> None:
    # work queued on the card finishes before the clock is read; a process
    # that never touched CUDA has nothing queued
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class Timer:
    """Host wall-clock timer of a block; the card's queued work is
    finished before each clock read when the process uses CUDA."""

    def __enter__(self):
        _sync()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        _sync()
        self.dt = time.perf_counter() - self.t0
