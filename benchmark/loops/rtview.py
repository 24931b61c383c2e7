"""Ray-traced frames: every view rendered by `GaussianRayTracer(cfg,
"traced")`, one ray a pixel through the cloud's per-ray tree with the
k-buffer passes, one frame in flight (a closed loop), over `views`
cameras evenly spaced on the orbit, in an order drawn from the seed,
looped.

Set-up builds the tracer first (a program without the traced mode fails
there at once), then the scene, and renders `warm_frames` frames, the
first of which builds the tree. The check traces `check_pixels` seeded
pixels of `check_items` frames the window produced through the plain
reference (`reference/splat_rt.py`), all passes."""

from __future__ import annotations

import numpy as np
import torch

from benchmark import compare, port, rt_roofline
from benchmark.frames import FrameLoop, seeded_order
from benchmark.reference import splat_rt

DIVERGED = 1e-3      # a pixel differs: its colour in a channel or its
#                      transmittance by more
ROOFLINE_PIXELS = 4096   # pixels a traced frame whose hits the reference
#                          counts for the least time


def numbers(color, trans, hits, ref) -> dict:
    """The check's numbers of one frame's checked pixels against the
    reference's (`splat_rt.trace`): the share (%) whose hit count
    differs, the share (%) whose colour or transmittance differs by more
    than DIVERGED, and the mean |Δ colour|."""
    dc = (color.float() - ref["color"]).abs()
    dt = (trans.float() - ref["trans"]).abs()
    return dict(
        hits_mismatch_pct=100.0 * float(
            (hits.long() != ref["hits"]).float().mean()),
        pixel_diverged_pct=100.0 * float(
            ((dc.amax(-1) > DIVERGED) | (dt > DIVERGED)).float().mean()),
        color_mae=float(dc.mean()))


class Loop(FrameLoop):

    def make_views(self) -> None:
        n = int(self.mix["views"])
        self.views = self.views_at([360.0 * i / n for i in range(n)])
        self.order = seeded_order(n, self.seed)

    def check_views(self, k: int) -> list:
        return [self.views[i] for i in self.order[:k]]

    def setup(self) -> None:
        from gsrt_torch.models.gaussian_rt import GaussianRayTracer
        self.mark("imports")
        self.tracer = GaussianRayTracer(port.render_config(self.config),
                                        "traced", device=self.device)
        self.make_scene()
        self.make_views()
        self.mark("scene")
        self.cams = [port.camera(v, self.device) for v in self.views]
        n = len(self.views)
        for k in range(int(self.mix["warm_frames"])):
            self.tracer(self.port_cloud, self.cams[self.order[k % n]])
        self.mark(f"tree and {self.mix['warm_frames']} warm frames")
        self.i = 0

    def step(self) -> dict:
        vi = int(self.order[self.i % len(self.order)])
        self.i += 1
        out = self.tracer(self.port_cloud, self.cams[vi])
        self._last = (self.views[vi], out)
        return {"view": self.views[vi], "pixels": self.W * self.H}

    def keep(self, index: int, rec: dict) -> None:
        """Reservoir sample of check_items completed frames, drawn from
        the seed: the frame's colour, transmittance and hits as the
        window produced them."""
        if rec.get("latency_s") is None or self._last is None:
            return
        k = int(self.mix["check_items"])
        self._seen += 1
        slot = len(self.kept) if len(self.kept) < k else \
            int(self._rng.integers(0, self._seen))
        if slot < k:
            view, out = self._last
            item = (index, view, out.color.reshape(-1, 3).clone(),
                    out.trans.reshape(-1).clone(),
                    out.hits.reshape(-1).clone())
            if slot < len(self.kept):
                self.kept[slot] = item
            else:
                self.kept.append(item)

    def release(self) -> None:
        super().release()
        self.tracer = None

    def pixels(self, item: int, count: int | None = None,
               stream: int = 7) -> torch.Tensor:
        """The checked pixels of window item `item` (stream 7; the least
        time's, stream 8), drawn from the seed."""
        n = self.W * self.H
        count = min(int(self.mix["check_pixels"]) if count is None
                    else count, n)
        rng = np.random.default_rng([self.seed % (1 << 63), stream, item])
        pix = rng.choice(n, count, replace=False)
        return torch.as_tensor(np.sort(pix), device=self.device)

    def reference(self, view, pixels, **kw) -> dict:
        return splat_rt.trace(self.cloud, self.cov, view, pixels,
                              splat_rt.constants(self.config["render"]),
                              **kw)

    def check(self, limits: dict) -> dict:
        self.release()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        nums = []
        for item, view, color, trans, hits in self.kept:
            pix = self.pixels(item)
            nums.append(numbers(color[pix], trans[pix], hits[pix],
                                self.reference(view, pix)))
        if not nums:
            return {k: {"value": float("inf"), "limit": float(v)}
                    for k, v in limits.items()}
        return compare.with_limits(compare.worst(nums), limits)

    def least_seconds(self, items) -> float:
        """Least seconds of the tracing kernel over the traced frames
        (`rt_roofline.py`), each frame's hits estimated from the
        reference's on ROOFLINE_PIXELS seeded pixels."""
        thr = self.config["render"]["alpha_threshold"]
        splats = int((self.cloud.opacity > thr).sum())
        total = 0.0
        for j, rec in enumerate(items):
            if rec.get("latency_s") is None:
                continue
            pix = self.pixels(j, ROOFLINE_PIXELS, stream=8)
            hits = self.reference(rec["view"], pix)["hits"]
            total += rt_roofline.least_seconds(
                float(hits.double().mean()) * self.W * self.H, splats,
                self.W * self.H)
        return total
