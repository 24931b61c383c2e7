"""What the frame loops (`loops/view.py`, `loops/serve.py`) share: the
scene made from the seed, the frames kept for the check, the check
against the reference, and the work count of the frames a trace saw."""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import compare, port, roofline, scene
from benchmark.reference import splats


class FrameLoop:
    SPANS = (("gsrt_torch.models.gaussian_rt:_precompute", "project"),
             ("gsrt_torch.ops.tile_binning:build_tile_binning", "binning"),
             ("gsrt_torch.ops.splat_packed:blend_packed", "blend"))

    def __init__(self, config: dict, mix: dict, seed: int, device: str):
        self.config, self.mix, self.seed = config, mix, int(seed)
        self.device = torch.device(device)
        self.W, self.H = config["width"], config["height"]
        self.kept: list = []        # [(item, view, color, trans)]
        self._rng = scene.seeded_rng(self.seed ^ 0x5EED)
        self._last = None           # (view, RenderOutput) of the last item
        self._seen = 0              # completed frames offered to keep
        self.marks: list = []       # (set-up phase, host clock at its end)

    def mark(self, label: str) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        self.marks.append((label, time.perf_counter()))

    def make_scene(self) -> None:
        c = self.config
        a = c["assumed"]
        self.cloud = scene.random_cloud(
            c["splats"], self.seed, self.device, extent=a["extent"],
            scale_range=a["scale_range"], opacity_range=a["opacity_range"],
            sh_degree=c["sh_degree"], scene_seed=a["scene_seed"])
        self.cov = scene.cov3d(self.cloud.quats, self.cloud.scales)
        self.port_cloud = port.cloud(self.cloud, self.cov)
        self.cfg = port.render_config(c)

    def views_at(self, angles) -> list:
        return scene.orbit_from_mix(self.mix["orbit"], angles, self.W,
                                    self.H)

    def object_spans(self):
        return ()

    def keep(self, index: int, rec: dict) -> None:
        """Reservoir sample of check_items completed frames, drawn from
        the seed: a copy of the frame as the window produced it."""
        if rec.get("latency_s") is None or self._last is None:
            return
        k = int(self.mix["check_items"])
        self._seen += 1
        slot = len(self.kept) if len(self.kept) < k else \
            int(self._rng.integers(0, self._seen))
        if slot < k:
            view, out = self._last
            item = (index, view, out.color.clone(), out.trans.clone())
            if slot < len(self.kept):
                self.kept[slot] = item
            else:
                self.kept.append(item)

    def release(self) -> None:
        """Drop the program's state before the reference runs."""
        self._last = None

    def check(self, limits: dict) -> dict:
        self.release()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        nums = []
        for _, view, color, trans in self.kept:
            r = splats.render(self.cloud, self.cov, view)
            nums.append(compare.frame_numbers(color, trans, r["color"],
                                              r["trans"]))
        if not nums:
            return {k: {"value": float("inf"), "limit": float(v)}
                    for k, v in limits.items()}
        return compare.with_limits(compare.worst(nums), limits)

    def least_seconds(self, items) -> float:
        """Least seconds of the forward blend over the traced frames."""
        total = 0.0
        for rec in items:
            if rec.get("latency_s") is None:
                continue
            r = splats.render(self.cloud, self.cov, rec["view"], count=True)
            counts = {k: int(r[k].sum()) for k in ("accepted", "pairs_read")}
            total += roofline.blend_forward(counts, self.W * self.H,
                                            self.config["payload"])
        return total


def seeded_order(n: int, seed: int) -> np.ndarray:
    return scene.seeded_rng(seed).permutation(n)
