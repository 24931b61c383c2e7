"""Served frames: `ServingRenderer` (strict, so a frame whose cull lost
content is rendered again) along the orbit at `step_deg` a frame from
`start_deg`, round and round, one frame in flight (a viewer shows a
frame before it asks for the next). The path is the same for every seed
(the seed draws the scene): a window covers a fraction of a lap more or
less, and a start drawn from the seed changed the frames' work by up to
6% from seed to seed."""

from __future__ import annotations

from benchmark import port
from benchmark.frames import FrameLoop


class Loop(FrameLoop):

    def make_views(self) -> None:
        step = float(self.mix["step_deg"])
        start = float(self.mix["start_deg"])
        lap = round(360.0 / step)
        self.views = self.views_at([start + step * j for j in range(lap)])

    def check_views(self, k: int) -> list:
        return [self.views[j * len(self.views) // k] for j in range(k)]

    def setup(self) -> None:
        from gsrt_torch.serving import ServingRenderer
        self.mark("imports")
        self.make_scene()
        self.make_views()
        self.mark("scene")
        self.cams = [port.camera(v, self.device) for v in self.views]
        self.srv = ServingRenderer(self.cfg, strict=bool(self.mix["strict"]),
                                   device=self.device)
        self.f = 0
        for _ in range(int(self.mix["warm_frames"])):
            self.step()
        self.mark("warm frames")

    def step(self) -> dict:
        j = self.f % len(self.views)
        self.f += 1
        out = self.srv(self.port_cloud, self.cams[j])
        self._last = (self.views[j], out)
        return {"view": self.views[j], "pixels": self.W * self.H,
                "stats": self.srv.stats[-1]}

    def release(self) -> None:
        super().release()
        self.srv = None
