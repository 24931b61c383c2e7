"""Temporal-reuse serving: frame-coherent rendering of camera paths
(counterpart of `gsrt.serving`).

Consecutive frames of a path see nearly the same splats, and a
front-to-back blend only needs each tile's pairs up to its saturation
depth. Per frame:

  1. the packed tile-stream blend records, per tile, the first pair chunk
     at whose start the tile was saturated (`track_consumed`);
  2. `update_cutoff_map` turns that into a per-tile depth cutoff: the
     camera depth of the pair at margin × the pairs used (+ a floor), from
     the pair depths the binning carries; unsaturated tiles get +inf;
  3. the next frame's binning drops the splats behind the cutoff of every
     supertile their footprint's corners touch
     (`ops.tile_binning.cutoff_cull`), so every pair-linear stage shrinks,
     and `ServingRenderer` re-buckets the pair buffer once the culled total
     settles.

A tile that had a finite cutoff and did not saturate may have lost
content: its cutoff resets to +inf and the frame counts as a violation;
`strict=True` renders such frames again without the cull.

The policy, the stats and the host's reactions are the JAX package's.
Each frame's four host-side numbers (violations, pairs, overflow, finite
cutoffs) stay in one int32 tensor on the device and are read
`pipeline_depth` frames later with one transfer; the cutoff map chains on
the device, so only the host's reactions lag.
"""

from __future__ import annotations

from typing import Optional

import torch

from gsrt_torch.core.config import RenderConfig
from gsrt_torch.core.types import Camera, GaussianCloud, resolve_device
from gsrt_torch.models.gaussian_rt import (RenderOutput, ServingAux,
                                           count_pairs_numpy, pair_bucket,
                                           render_tiled)
from gsrt_torch.ops.tile_binning import tile_extent
from gsrt_torch.utils.profiling import TRACER

TERM_EPS = 1e-4


def update_cutoff_map(aux: ServingAux, trans: torch.Tensor,
                      old_map: torch.Tensor, *, width: int, height: int,
                      tile_w: int, tile_h: int, bs: int,
                      term_eps: float = TERM_EPS, margin: float = 1.5,
                      floor_pairs: int = 32, chunk: int = 128):
    """Fold one frame's saturation feedback into the per-tile depth-cutoff
    map. Returns (new_map [T] f32, violation [T] bool).

    Per tile: saturated, and the margin'd pair budget fits strictly inside
    its (already culled) segment → the budget's depth; saturated otherwise
    → the old cutoff; not saturated → +inf, a violation if the old cutoff
    was finite. bs and chunk are the blend's group size and chunk."""
    ntx, nty = tile_extent(width, height, tile_w, tile_h)
    T = ntx * nty
    ts, counts = aux.tile_start, aux.tile_count
    tr = torch.nn.functional.pad(trans, (0, ntx * tile_w - width,
                                         0, nty * tile_h - height))
    tile_trans = tr.reshape(nty, tile_h, ntx, tile_w).amax((1, 3)).reshape(-1)
    saturated = tile_trans < term_eps

    sat = aux.consumed.reshape(-1)[:T]       # first saturated chunk index
    grp = torch.arange(T, dtype=torch.int32, device=ts.device) // bs
    astart = (ts[(grp * bs).long()] // chunk) * chunk   # group chunk base
    end_g = ts[torch.clamp_max((grp + 1) * bs, T).long()]
    total_chunks = -((astart - end_g) // chunk)          # ceil division
    sat_hit = sat < total_chunks             # == total_chunks: never
    satpos = torch.where(sat_hit, astart + sat * chunk, ts[1:T + 1])
    n_used = torch.minimum(torch.clamp_min(satpos - ts[:T], 0), counts)
    target = torch.minimum((margin * n_used).to(torch.int32) + floor_pairs,
                           counts)
    tighten = saturated & sat_hit & (target < counts)
    idx = torch.clamp(ts[:T] + target - 1, 0, aux.pair_depth.shape[0] - 1)
    inf = torch.full_like(old_map, float("inf"))
    new_map = torch.where(tighten, aux.pair_depth[idx.long()],
                          torch.where(saturated, old_map, inf))
    violation = ~saturated & torch.isfinite(old_map)
    return new_map, violation


def _serving_step(cloud: GaussianCloud, camera: Camera,
                  cutoff_map: torch.Tensor, cfg: RenderConfig,
                  max_pairs: int, margin: float, floor_pairs: int,
                  use_cull: bool):
    """One serving frame: (out, new_map, scalars [4] int32 on the device
    = [violations, culled pair total, overflow, finite cutoffs]).
    use_cull=False still tracks saturation but skips the cull, which can
    drop nothing while the map has no finite entry; it reports no
    violations, since nothing was dropped."""
    out, aux = render_tiled(cloud, camera, cfg, max_pairs=max_pairs,
                            cutoff_map=cutoff_map if use_cull else None,
                            serving=True)
    with TRACER.span("serve.cutoff"):
        new_map, violation = update_cutoff_map(
            aux, out.trans, cutoff_map, width=camera.width,
            height=camera.height, tile_w=cfg.tile_w, tile_h=cfg.tile_h,
            bs=cfg.blend_bs,
            chunk=min(cfg.pair_chunk, 128),   # render_tiled's
            term_eps=TERM_EPS, margin=margin, floor_pairs=floor_pairs)
        nviol = violation.sum(dtype=torch.int32) if use_cull else \
            torch.zeros((), dtype=torch.int32, device=new_map.device)
        scalars = torch.stack([
            nviol, aux.tile_count.sum(dtype=torch.int32),
            out.overflow.to(torch.int32),
            torch.isfinite(new_map).sum(dtype=torch.int32)])
    return out, new_map, scalars


class ServingRenderer:
    """Stateful frame-sequence renderer with temporal pair culling.

        srv = ServingRenderer(cfg)
        for camera in path:
            out = srv(cloud, camera)
        srv.finish()   # read the frames still in flight
        srv.stats      # per-frame dicts: pairs, violations, ...

    Frames are queued on the device and each frame's stats are read
    `pipeline_depth` frames later, so the host does not wait for the card
    every frame. strict=True reads every frame at once (depth 1) and
    renders a frame whose cull proved too aggressive (or whose buffer
    overflowed) again without the cull, so served images are never
    degraded."""

    SHRINK_PATIENCE = 3     # frames of consistently smaller pair totals
    SHRINK_HEADROOM = 1.35  # before the static buffer re-buckets

    def __init__(self, cfg: RenderConfig, max_pairs: Optional[int] = None,
                 margin: float = 1.5, floor_pairs: int = 32,
                 strict: bool = False, pipeline_depth: int = 4,
                 device=None):
        self.cfg = cfg
        self.max_pairs = max_pairs
        self.margin = margin
        self.floor_pairs = floor_pairs
        self.strict = strict
        self.pipeline_depth = 1 if strict else max(1, pipeline_depth)
        self.device = resolve_device(device)
        self.cutoff_map: Optional[torch.Tensor] = None
        self.stats: list[dict] = []
        self._src = None            # the caller's cloud object
        self._cloud: Optional[GaussianCloud] = None   # on self.device
        self._shrink_run = 0
        self._use_cull = False      # no finite cutoffs yet: skip the cull
        self._pending: list = []    # (stats dict, scalars on the device)

    def _step(self, camera, cutoff_map, use_cull):
        return _serving_step(self._cloud, camera, cutoff_map, self.cfg,
                             self.max_pairs, self.margin, self.floor_pairs,
                             use_cull)

    def reset(self):
        """Drop temporal state (scene cut / teleport)."""
        self.finish()
        self.cutoff_map = None
        self._shrink_run = 0
        self._use_cull = False

    def calibrate(self, cloud: GaussianCloud, camera: Camera) -> int:
        total = count_pairs_numpy(cloud, camera, self.cfg)
        self.max_pairs = pair_bucket(int(total * 1.1))
        return self.max_pairs

    def _drain_one(self) -> dict:
        rec, scalars = self._pending.pop(0)
        with TRACER.span("serve.sync"):
            nviol, total, overflow, n_finite = scalars.tolist()  # one read
        rec.update(violations=nviol, pairs=total, overflow=bool(overflow))
        self._use_cull = n_finite > 0
        if overflow:
            # the camera outgrew the bucket up to pipeline_depth frames
            # ago: re-bucket for the next frames
            self.max_pairs = pair_bucket(int(total * 1.3))
            self._shrink_run = 0
        elif total * self.SHRINK_HEADROOM < self.max_pairs:
            # re-bucket the static buffer once the culled total settles
            self._shrink_run += 1
            if self._shrink_run >= self.SHRINK_PATIENCE:
                self.max_pairs = pair_bucket(int(total * 1.15))
                self._shrink_run = 0
        else:
            self._shrink_run = 0
        return rec

    def finish(self):
        """Read the stats of the frames still in flight (end of a path, or
        before reading self.stats)."""
        while self._pending:
            self._drain_one()

    def __call__(self, cloud: GaussianCloud, camera: Camera) -> RenderOutput:
        with TRACER.span("serve.frame", root=True):
            with TRACER.span("render.prepare"):
                if self.max_pairs is None:
                    self.calibrate(cloud, camera)
                if self._src is not cloud:
                    self._src, self._cloud = cloud, cloud.to(self.device)
                    self.reset()
                camera = camera.to(self.device)
                ntx, nty = tile_extent(camera.width, camera.height,
                                       self.cfg.tile_w, self.cfg.tile_h)
                T = ntx * nty
                if self.cutoff_map is None or self.cutoff_map.shape[0] != T:
                    self.finish()
                    self.cutoff_map = torch.full((T,), float("inf"),
                                                 device=self.device)
                    self._use_cull = False   # an all-inf map culls nothing

            used_cull = self._use_cull
            out, new_map, scalars = self._step(camera, self.cutoff_map,
                                               used_cull)
            self.cutoff_map = new_map
            rec = dict(max_pairs=self.max_pairs, cull=used_cull,
                       full_renders=0)
            self._pending.append((rec, scalars))
            self.stats.append(rec)
            if len(self._pending) < self.pipeline_depth:
                return out
            drained = self._drain_one()
            if self.strict and drained is rec and (
                    drained["overflow"]
                    or (used_cull and drained["violations"] > 0)):
                # serve an exact, cull-free frame at the (possibly
                # re-bucketed) size; keep the corrected map for the next
                with TRACER.span("serve.rerender"):
                    nocull = torch.full((T,), float("inf"),
                                        device=self.device)
                    out, _, s2 = self._step(camera, nocull, False)
                    with TRACER.span("serve.sync"):
                        _, total, overflow, _ = s2.tolist()
                    if overflow:                   # still overflowing
                        self.max_pairs = pair_bucket(total * 2)
                        out, _, _ = self._step(camera, nocull, False)
                rec["full_renders"] += 1
            return out
