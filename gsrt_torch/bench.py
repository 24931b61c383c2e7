"""Headline benchmark of the port: Mrays/s of the tiled 3DGS renderer on
one CUDA card (counterpart of the JAX package's `bench.py`).

    python -m gsrt_torch.bench

Workload (`bench.py`'s, uncut): random_cloud(1_000_000, seed=0,
scale_range=(0.004, 0.03)) at 1920x1080, SH degree 3,
RenderConfig(conic_mode="standard") otherwise at its defaults — the group
stream through the pair-expansion and packed blend kernels. The buffers
are sized once by `GaussianRayTracer(cfg, "tiled").calibrate`; then 3
groups of 10 frames are queued back to back and timed on the host's clock
from a synchronised card to the end of the group's last frame; the best
group counts. Mrays/s is W·H / frame time (RayTracer.cpp:180-183).

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline"}, with
vs_baseline = value / 100 Mrays/s (BASELINE.json's north-star target) and
the card's name in the metric. Without CUDA it raises, as every entry
point of the port does.
"""

from __future__ import annotations

import json
import sys
import time

import torch

WIDTH, HEIGHT, SPLATS, SEED = 1920, 1080, 1_000_000, 0
FRAMES, GROUPS = 10, 3
BASELINE_MRAYS = 100.0


def run() -> dict:
    from gsrt_torch.core.config import RenderConfig
    from gsrt_torch.core.types import resolve_device
    from gsrt_torch.models.gaussian_rt import GaussianRayTracer, render_tiled
    from gsrt_torch.scene.catalog import random_cloud

    dev = resolve_device()   # CUDA, or it raises
    cfg = RenderConfig(width=WIDTH, height=HEIGHT, conic_mode="standard")
    cloud, camera = random_cloud(SPLATS, seed=SEED, width=WIDTH,
                                 height=HEIGHT, scale_range=(0.004, 0.03),
                                 device=dev)
    tracer = GaussianRayTracer(cfg, "tiled", device=dev)
    max_pairs = tracer.calibrate(cloud, camera)

    def frame():
        return render_tiled(cloud, camera, cfg, max_pairs=max_pairs,
                            max_rows=tracer.max_rows)

    out = frame()          # warm: kernel libraries, allocator
    checksum = float(out.trans.sum() + out.color.sum())
    if checksum != checksum or bool(out.overflow):
        raise RuntimeError(f"the warm frame is off: checksum {checksum}, "
                           f"overflow {bool(out.overflow)}")
    times = []
    for _ in range(GROUPS):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        for _ in range(FRAMES):
            frame()
        torch.cuda.synchronize(dev)
        times.append((time.perf_counter() - t0) / FRAMES)
    dt = min(times)
    mrays = WIDTH * HEIGHT / dt / 1e6
    return {"metric": f"Mrays/s (1M-splat 3DGS @1080p, tiled CUDA, "
                      f"{torch.cuda.get_device_name(dev)})",
            "value": round(mrays, 4), "unit": "Mrays/s",
            "vs_baseline": round(mrays / BASELINE_MRAYS, 3)}


def main() -> int:
    print(json.dumps(run()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
