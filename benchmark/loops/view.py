"""Fresh frames: every view rendered from scratch by
`GaussianRayTracer(cfg, "tiled")`, one frame in flight (a closed loop),
over `views` cameras evenly spaced on the orbit, in an order drawn from
the seed, looped."""

from __future__ import annotations

import torch

from benchmark import counts, port
from benchmark.frames import FrameLoop, seeded_order


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
        self.make_scene()
        self.make_views()
        self.mark("scene")
        n = len(self.views)
        self.cams = [port.camera(v, self.device) for v in self.views]
        self.tracer = GaussianRayTracer(self.cfg, "tiled",
                                        device=self.device)
        # size the buffers on the lap's largest view, then render the
        # lap, so that no calibration falls in the window
        need = [counts.rect_pairs(self.cloud, self.cov, v)
                for v in self.views]
        big = max(range(n), key=need.__getitem__)
        self.mark("count")
        self.tracer.calibrate(self.port_cloud, self.cams[big])
        self.mark("calibrate")
        for i in self.order:
            self.tracer(self.port_cloud, self.cams[i])
        self.mark(f"warm lap (max_pairs {self.tracer.max_pairs}, "
                  f"max_rows {self.tracer.max_rows})")
        self.i = 0

    def step(self) -> dict:
        vi = int(self.order[self.i % len(self.order)])
        self.i += 1
        out = self.tracer(self.port_cloud, self.cams[vi])
        self._last = (self.views[vi], out)
        return {"view": self.views[vi], "pixels": self.W * self.H}

    def release(self) -> None:
        super().release()
        self.tracer = None
