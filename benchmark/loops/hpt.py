"""Path-traced frames of splats and inserted meshes in one scene: every
frame one `render_path_traced_calibrated` call over the triangles with
the splat cloud (`gaussians`) and its per-ray tree (`gauss_tree`), one
sample a pixel and the configuration's bounces, one frame in flight (a
closed loop), over `views` cameras evenly spaced on the orbit, in an
order drawn from the seed, looped; frame k's samples come from (run
seed, k).

Set-up first checks that the program's `render_path_traced` takes a
splat tree: a program without one would trace the cloud brute force for
hours a frame, so it stops there. Then it builds the scene (the meshes
of `hybrid_scene.py`, the cloud of `scene.py`), the triangle table and
its tree, the splat tree, sizes the binned primary's pair buffer from
the port's count over the lap's views, the largest × `pair_slack`, and
renders `warm_frames` frames. The window never grows a buffer
(max_retries 0): a frame whose binning overflows fails, and the check
fails with it. The check traces `check_pixels` seeded pixels of
`check_items` frames the window produced through the plain reference
(`reference/hybrid_pt.py`), every segment of every path."""

from __future__ import annotations

import inspect

import numpy as np
import torch

from benchmark import compare, counts, hybrid_scene, port, rt_roofline, scene
from benchmark.frames import seeded_order
from benchmark.loops import pt
from benchmark.reference import hybrid_pt, splat_rt

ROOFLINE_PIXELS = 4096   # pixels a traced frame whose splat hits and
#                          segments the reference counts for the least time
NEEDS = ("gauss_tree", "primary_splat_hits")


def numbers(color, primary, hits, ref: dict) -> dict:
    """The check's numbers of one frame's checked pixels against the
    reference's (`hybrid_pt.trace`): `pt.numbers`' bounce-0 triangle,
    diverged pixels and colour error, and the share (%) whose bounce-0
    splat hit count differs."""
    out = pt.numbers(color, primary, ref["color"], ref["primary"])
    out["hits_mismatch_pct"] = 100.0 * float(
        (hits.long() != ref["hits"]).float().mean())
    return out


class Loop(pt.Loop):

    def make_scene(self) -> None:
        c, a = self.config, self.config["assumed"]
        self.scene = hybrid_scene.build(c["meshes"])
        if self.scene.n != c["triangles"]:
            raise ValueError(f"the meshes have {self.scene.n} triangles, the "
                             f"configuration {c['triangles']}")
        self.cloud = scene.random_cloud(
            c["splats"], self.seed, self.device, extent=a["extent"],
            scale_range=a["scale_range"], opacity_range=a["opacity_range"],
            sh_degree=c["sh_degree"], scene_seed=a["scene_seed"])
        self.cov = scene.cov3d(self.cloud.quats, self.cloud.scales)
        n = int(self.mix["views"])
        self.views = scene.orbit_from_mix(
            self.mix["orbit"], [360.0 * i / n for i in range(n)], self.W,
            self.H)
        self.order = seeded_order(n, self.seed)
        self.consts = splat_rt.constants(dict(c["render"], t_min=c["t_min"],
                                              t_max=c["t_max"]))

    def setup(self) -> None:
        from gsrt_torch.models import path_tracer
        takes = inspect.signature(path_tracer.render_path_traced).parameters
        if not all(k in takes for k in NEEDS):
            raise SystemExit("this program's render_path_traced takes no "
                             "splat tree (gauss_tree) or reports no bounce-0 "
                             "splat hits (primary_splat_hits): it would trace "
                             "2.96M splats brute force, and the cell's check "
                             "cannot run")
        from gsrt_torch.core.config import RenderConfig
        from gsrt_torch.interop import scene_from_numpy
        from gsrt_torch.ops.splat_bvh import build_splat_bvh
        from gsrt_torch.ops.tri_binning import count_tri_pairs_numpy
        self.mark("imports")
        self.make_scene()
        s, c = self.scene, self.config
        self.mark(f"scene ({s.n} triangles, {self.cloud.n} splats)")
        self.port_scene = path_tracer.with_tri_table(
            scene_from_numpy(s.fields(), device=self.device))
        self.port_cloud = port.cloud(self.cloud, self.cov)
        self.cfg = RenderConfig(width=self.W, height=self.H,
                                samples=self.spp, bounces=c["bounces"],
                                t_min=c["t_min"], t_max=c["t_max"],
                                sh_degree=c["sh_degree"], **c["render"])
        self.tree = build_splat_bvh(self.port_cloud, self.cfg)
        self.mark(f"table and trees ({self.tree.n_leaves} leaves)")
        self.cams = [port.camera(v, self.device) for v in self.views]
        need = max(count_tri_pairs_numpy(s.v0, s.v1, s.v2, cam,
                                         tile_w=self.cfg.tile_w,
                                         tile_h=self.cfg.tile_h)
                   for cam in self.cams)
        self.max_pairs = counts.pair_bucket(int(need * self.mix["pair_slack"]))
        self.mark(f"count ({need} pairs, max_pairs {self.max_pairs})")
        self._pt = path_tracer
        n = len(self.views)
        for k in range(int(self.mix["warm_frames"])):
            self._render(self.frame_seed(1, k), int(self.order[k % n]))
        self.mark(f"{self.mix['warm_frames']} warm frames")

    def _render(self, seed: int, vi: int):
        ids: list = []
        hits: list = []
        img, info = self._pt.render_path_traced_calibrated(
            self.port_scene, self.cams[vi], self.cfg, seed=seed,
            tri_max_pairs=self.max_pairs, max_retries=0,
            primary_impl="binned", primary_ids=ids,
            gaussians=self.port_cloud, gauss_tree=self.tree,
            primary_splat_hits=hits)
        flags = info["flags"]
        if any(flags.values()):
            self.overflow_frames += 1
            raise RuntimeError(f"the frame overflowed: {flags}")
        return img, ids[0], hits[0]

    def step(self) -> dict:
        k = self.i
        self.i += 1
        vi = int(self.order[k % len(self.order)])
        s = self.frame_seed(0, k)
        self._last = (s, vi, *self._render(s, vi))
        return {"pixels": self.W * self.H * self.spp, "frame_seed": s,
                "view": vi}

    def keep(self, index: int, rec: dict) -> None:
        """Reservoir sample of check_items completed frames, drawn from
        the seed: the frame's colour, bounce-0 triangles and bounce-0
        splat hits as the window produced them."""
        if rec.get("latency_s") is None or self._last is None:
            return
        k = int(self.mix["check_items"])
        self._seen += 1
        slot = len(self.kept) if len(self.kept) < k else \
            int(self._rng.integers(0, self._seen))
        if slot < k:
            s, vi, img, ids, hits = self._last
            item = (index, s, vi, img.reshape(-1, 3).clone(),
                    ids.reshape(-1).clone(), hits.reshape(-1).clone())
            if slot < len(self.kept):
                self.kept[slot] = item
            else:
                self.kept.append(item)

    def release(self) -> None:
        super().release()
        self.port_cloud = self.tree = None

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

    def reference(self, sc, seed: int, vi: int, pixels, *,
                  dtype=torch.float32, window: bool = True) -> dict:
        c, view = self.config, self.views[vi]
        sp = hybrid_pt.splats(self.cloud, self.cov, view, self.consts, dtype)
        return hybrid_pt.trace(sc, sp, view, seed, pixels,
                               bounces=c["bounces"], t_min=c["t_min"],
                               t_max=c["t_max"], consts=self.consts,
                               has_sky=c["render"]["has_sky"], dtype=dtype,
                               window=window)

    def check(self, limits: dict) -> dict:
        self.release()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        sc = self.reference_scene()
        nums = []
        for item, s, vi, color, primary, hits in self.kept:
            pix = self.pixels(item)
            nums.append(numbers(color[pix], primary[pix], hits[pix],
                                self.reference(sc, s, vi, pix)))
        out = compare.worst(nums) if nums else \
            {k: float("inf") for k in limits if k != "overflow_frames"}
        out["overflow_frames"] = self.overflow_frames
        return compare.with_limits(out, limits)

    def least_seconds(self, items) -> float:
        """Least seconds of the splat kernel's launches over the traced
        frames (`rt_roofline.py`): each frame's splat hits and live
        segments, all bounces, estimated from the reference's on
        ROOFLINE_PIXELS seeded pixels; every splat above the threshold
        read once a frame."""
        thr = self.config["render"]["alpha_threshold"]
        splats = int((self.cloud.opacity > thr).sum())
        sc = self.reference_scene()
        n = self.W * self.H
        total = 0.0
        for j, rec in enumerate(items):
            if rec.get("latency_s") is None:
                continue
            r = self.reference(sc, rec["frame_seed"], rec["view"],
                               self.pixels(j, ROOFLINE_PIXELS, stream=8))
            total += rt_roofline.least_seconds(
                float(r["splat_hits"].double().mean()) * n, splats,
                float(r["segments"].double().mean()) * n)
        return total
