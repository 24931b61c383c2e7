"""Path-traced frames of a still camera over a triangle scene: one
`render_path_traced_calibrated` call a frame (the configuration's samples
a pixel and bounces), one frame in flight, frame k's samples drawn from
(run seed, k), so a still viewer accumulates them.

Set-up builds the scene (`tri_scene.py`), the traversal table
(`with_tri_table`), sizes the binned primary's pair buffer from the
port's count × `pair_slack`, and renders `warm_frames` frames. The window
never grows a buffer (max_retries 0): a frame whose binning or visit list
overflows fails, and the check fails with it. The check traces
`check_pixels` seeded pixels of `check_items` frames the window produced
through the plain reference (`reference/pathtrace.py`), all bounces."""

from __future__ import annotations

import inspect
import time

import numpy as np
import torch

from benchmark import compare, counts, port, tri_scene
from benchmark.reference import pathtrace as ref

DIVERGED = 1e-3      # a pixel's linear colour differs: any channel by more


def numbers(color, primary, ref_color, ref_primary) -> dict:
    """The check's numbers of one frame's checked pixels: the share (%)
    whose bounce-0 triangle differs from the reference's, the share (%)
    whose colour differs by more than DIVERGED in a channel, and the mean
    |Δ colour|."""
    d = (color.float() - ref_color.float()).abs()
    return dict(
        primary_id_mismatch_pct=100.0 * float(
            (primary != ref_primary).float().mean()),
        pixel_diverged_pct=100.0 * float(
            (d.amax(-1) > DIVERGED).float().mean()),
        color_mae=float(d.mean()))


class Loop:
    SPANS = ()

    def __init__(self, config: dict, mix: dict, seed: int, device: str):
        self.config, self.mix, self.seed = config, mix, int(seed)
        self.device = torch.device(device)
        fr = config["frame"]
        self.W, self.H = fr["width"], fr["height"]
        self.spp = fr["samples_per_pixel"]
        if self.spp != 1:
            raise ValueError("the reference traces one sample a pixel")
        self.trace_items = 0
        self.marks: list = []       # (set-up phase, host clock at its end)
        self.kept: list = []        # [(item, frame seed, colour, primary)]
        self.overflow_frames = 0
        self.i = 0
        self._seen = 0
        self._last = None
        self._rng = np.random.default_rng([self.seed % (1 << 63), 0x5EED])

    def mark(self, label: str) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        self.marks.append((label, time.perf_counter()))

    def frame_seed(self, stream: int, k: int) -> int:
        """Frame k's sample seed: stream 0 the window, 1 the warm-up."""
        ss = np.random.SeedSequence([self.seed % (1 << 63), stream, k])
        return int(ss.generate_state(1, np.uint64)[0] >> 1)

    def pixels(self, item: int) -> torch.Tensor:
        """The checked pixels of window item `item`, drawn from the seed."""
        rng = np.random.default_rng([self.seed % (1 << 63), 7, item])
        pix = rng.choice(self.W * self.H, int(self.mix["check_pixels"]),
                         replace=False)
        return torch.as_tensor(np.sort(pix), device=self.device)

    def make_scene(self) -> None:
        c = self.config
        self.scene = tri_scene.build(c["triangles"], self.W, self.H,
                                     c["assumed"]["scene_seed"])

    def setup(self) -> None:
        from gsrt_torch.core.config import RenderConfig
        from gsrt_torch.interop import scene_from_numpy
        from gsrt_torch.models import path_tracer
        from gsrt_torch.ops.tri_binning import count_tri_pairs_numpy
        if "primary_ids" not in inspect.signature(
                path_tracer.render_path_traced).parameters:
            raise SystemExit("this program's render_path_traced reports no "
                             "bounce-0 triangles (primary_ids): the cell's "
                             "check cannot run")
        self.mark("imports")
        self.make_scene()
        s, c = self.scene, self.config
        self.mark(f"scene ({s.n} triangles)")
        self.port_scene = path_tracer.with_tri_table(
            scene_from_numpy(s.fields(), device=self.device))
        self.cam = port.camera(s.view, self.device)
        self.cfg = RenderConfig(width=self.W, height=self.H,
                                samples=self.spp, bounces=c["bounces"],
                                t_min=c["t_min"], t_max=c["t_max"],
                                **c["render"])
        self.mark("table")
        need = count_tri_pairs_numpy(s.v0, s.v1, s.v2, self.cam,
                                     tile_w=self.cfg.tile_w,
                                     tile_h=self.cfg.tile_h)
        self.max_pairs = counts.pair_bucket(int(need * self.mix["pair_slack"]))
        self.mark(f"count ({need} pairs, max_pairs {self.max_pairs})")
        self._pt = path_tracer
        for k in range(int(self.mix["warm_frames"])):
            self._render(self.frame_seed(1, k))
        self.mark(f"{self.mix['warm_frames']} warm frames")

    def _render(self, seed: int):
        ids: list = []
        img, info = self._pt.render_path_traced_calibrated(
            self.port_scene, self.cam, self.cfg, seed=seed,
            tri_max_pairs=self.max_pairs, max_retries=0,
            primary_impl="binned", primary_ids=ids)
        flags = info["flags"]
        if flags["binned_pairs_overflow"] or flags["tri_visits_overflow"]:
            self.overflow_frames += 1
            raise RuntimeError(f"the frame overflowed: {flags}")
        return img, ids[0]

    def step(self) -> dict:
        k = self.i
        self.i += 1
        s = self.frame_seed(0, k)
        img, ids = self._render(s)
        self._last = (s, img, ids)
        return {"pixels": self.W * self.H * self.spp, "frame_seed": s}

    def object_spans(self):
        return ()

    def keep(self, index: int, rec: dict) -> None:
        """Reservoir sample of check_items completed frames, drawn from
        the seed: the frame's colour and bounce-0 triangles as the window
        produced them."""
        if rec.get("latency_s") is None or self._last is None:
            return
        k = int(self.mix["check_items"])
        self._seen += 1
        slot = len(self.kept) if len(self.kept) < k else \
            int(self._rng.integers(0, self._seen))
        if slot < k:
            s, img, ids = self._last
            item = (index, s, img.reshape(-1, 3).clone(),
                    ids.reshape(-1).clone())
            if slot < len(self.kept):
                self.kept[slot] = item
            else:
                self.kept.append(item)

    def release(self) -> None:
        """Drop the program's state before the reference runs."""
        self._last = self.port_scene = self._pt = None

    def reference_scene(self, dtype=torch.float32):
        s = self.scene
        return ref.make_scene(s.v0, s.v1, s.v2, s.mat, s.materials,
                              self.device, dtype)

    def reference(self, sc, seed: int, pixels, **kw):
        c = self.config
        return ref.trace(sc, self.scene.view, seed, pixels,
                         bounces=kw.pop("bounces", c["bounces"]),
                         t_min=c["t_min"], t_max=c["t_max"], **kw)

    def check(self, limits: dict) -> dict:
        self.release()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        nums = []
        sc = self.reference_scene()
        for item, s, color, primary in self.kept:
            pix = self.pixels(item)
            rc, rp = self.reference(sc, s, pix)
            nums.append(numbers(color[pix], primary[pix], rc, rp))
        out = compare.worst(nums) if nums else \
            {k: float("inf") for k in limits if k != "overflow_frames"}
        out["overflow_frames"] = self.overflow_frames
        return compare.with_limits(out, limits)
