"""Ray-traced 3D Gaussian Splatting renderer (counterpart of
`gsrt.models.gaussian_rt`).

* `render_reference`: the paper's multi-pass k-buffer algorithm — per
  pass, the k nearest splats beyond each pixel's depth front, composited
  front to back, the front advanced; `trace_gaussian_rays` runs the same
  passes for arbitrary rays through the ray-space response.
* `render_fast`: one front-to-back sweep over splats sorted by camera
  depth — per-pixel visit order is exact because depth is per splat, so
  it computes what the k-buffer passes compute. The port's semantic
  oracle.
* `render_tiled`: the performance path. Projection and SH, footprint
  extents and the alive mask (`_precompute`: one kernel launch on CUDA),
  binning, then a blend kernel, by the JAX package's gating:
  the group stream through the packed group kernel (the defaults), the
  tile stream with either payload through the packed tile kernel, the f32
  stream through the subtile kernel (blend_impl="subtile") or, at 128×8
  tiles, through `blend_tiles`. Under `serving=True` it takes the tile
  stream, culls by a cutoff map, and returns the saturation feedback
  (`ServingAux`) that `gsrt_torch.serving` consumes. `cfg.span_mode =
  "ellipse"` bins ellipse spans on the tile stream (at most 255 tile rows;
  rect spans past that).
* `GaussianRayTracer`: "fast", "reference" or "tiled"; in "tiled" mode
  it sizes the static pair and unit buffers from a
  NumPy count of the view (`calibrate`) and re-renders a frame that
  overflowed them, at once or, with defer_overflow=N, N frames later.

Entry points render on the device the cloud lives on; clouds and cameras
come from `gsrt_torch.scene` or `gsrt_torch.interop`, which default to
CUDA.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from gsrt_torch.core.config import RenderConfig
from gsrt_torch.core.types import Camera, GaussianCloud, resolve_device
from gsrt_torch.ops import explut
from gsrt_torch.ops.gaussian import (eval_gaussian_response, invert_cov3d,
                                     project_gaussians,
                                     ray_gaussian_response)
from gsrt_torch.ops.gaussian import screen_extents_abc  # noqa: F401 re-export
from gsrt_torch.ops.kbuffer import finish_pass, merge_nearest, ray_window
from gsrt_torch.ops.project import alive_mask  # noqa: F401 re-export
from gsrt_torch.ops.project import SplatColumns, project_splats, unit_dirs
from gsrt_torch.ops.sh import eval_sh
from gsrt_torch.ops.tile_binning import group_rows_k, tile_extent
from gsrt_torch.utils.profiling import TRACER


class RenderOutput(NamedTuple):
    trans: torch.Tensor    # [H, W] final transmittance
    color: torch.Tensor    # [H, W, 3]
    passes: torch.Tensor   # [H, W] int32 — equivalent k-buffer passes
    hits: torch.Tensor     # [H, W] int32 — splats blended per pixel
                           #   (render_tiled: the tile's pair count)
    depth: Optional[torch.Tensor] = None     # render_fast(with_depth=True)
    overflow: Optional[torch.Tensor] = None  # [] bool, render_tiled only


def _pixel_grid(width: int, height: int, device) -> torch.Tensor:
    """[H*W, 2] pixel centers at integer coordinates."""
    ys, xs = torch.meshgrid(torch.arange(height, device=device),
                            torch.arange(width, device=device),
                            indexing="ij")
    return torch.stack([xs.reshape(-1), ys.reshape(-1)], -1).float()


def _project_sh(cloud: GaussianCloud, camera: Camera, cfg: RenderConfig):
    """Project all splats and evaluate per-splat SH color (view direction
    from the camera origin to the splat center)."""
    depth, mean2d, quad, det, in_front = project_gaussians(
        cloud.means, cloud.cov3d, camera, conic_mode=cfg.conic_mode,
        cov2d_dilation=cfg.cov2d_dilation)
    colors = eval_sh(cloud.sh, unit_dirs(cloud.means, camera.position),
                     min(cfg.sh_degree, cloud.sh_degree))
    return depth, mean2d, quad, in_front, colors


def _precompute(cloud: GaussianCloud, camera: Camera,
                cfg: RenderConfig) -> SplatColumns:
    """The tiled forward's projection layer: projection, SH colour,
    extents and the alive mask in one kernel launch on CUDA, as plain ops
    on the CPU (`ops.project.project_splats`). No gradients: the
    differentiable paths call `_project_sh`. `render_tiled` reaches the
    layer through this name, which benchmark/frames.py times."""
    return project_splats(cloud, camera, cfg)


def blend_params(cfg: RenderConfig) -> dict:
    """The blend's constants for a configuration, shared by the forward
    and the backward."""
    return dict(
        g_cutoff=cfg.g_cutoff, alpha_threshold=cfg.alpha_threshold,
        alpha_clamp=0.99 if cfg.conic_mode == "standard" else 0.999999,
        # in standard mode with opacity ≤ 1, alpha > 1/255 implies
        # g < ln(255) < g_cutoff: the blend can skip the range test
        skip_range_check=(cfg.conic_mode == "standard"
                          and cfg.alpha_threshold >= 1.0 / 255.0
                          and cfg.g_cutoff >= 5.55
                          and not cfg.use_exp_lut),
        use_exp_lut=cfg.use_exp_lut)


def _empty_output(camera: Camera, cfg: RenderConfig) -> RenderOutput:
    H, W, dev = camera.height, camera.width, camera.device
    bg = 1.0 if cfg.white_background else 0.0
    zi = torch.zeros((H, W), dtype=torch.int32, device=dev)
    return RenderOutput(trans=torch.ones((H, W), device=dev),
                        color=torch.full((H, W, 3), bg, device=dev),
                        passes=zi, hits=zi.clone())


def _chunk_alphas(pix, mean2d_c, quad_c, depth_c, opacity_c, in_front_c,
                  cfg: RenderConfig, lut):
    """alpha [P, C] and accept [P, C] for a pixel block × splat chunk."""
    g = eval_gaussian_response(pix[:, None, :], mean2d_c[None], quad_c[None])
    in_range = (g >= 0.0) & (g <= cfg.g_cutoff)
    gc = torch.where(in_range, g, torch.zeros_like(g))
    power = explut.linear_exp(gc, lut) if cfg.use_exp_lut else torch.exp(-gc)
    alpha = opacity_c[None, :] * power
    if cfg.conic_mode == "standard":
        alpha = torch.clamp_max(alpha, 0.99)
    in_window = ((depth_c > cfg.t_min)
                 & (depth_c < min(cfg.t_max, cfg.init_depth)))[None, :]
    accept = (in_range & (alpha > cfg.alpha_threshold)
              & in_front_c[None, :] & in_window)
    return torch.where(accept, alpha, torch.zeros_like(alpha)), accept


def render_fast(cloud: GaussianCloud, camera: Camera, cfg: RenderConfig,
                with_depth: bool = False) -> RenderOutput:
    """Single-sweep sorted front-to-back blend over every pixel × splat
    (chunks of cfg.splat_chunk splats). with_depth also accumulates the
    alpha-weighted expected depth."""
    if cloud.n == 0:
        return _empty_output(camera, cfg)
    dev = cloud.device
    depth, mean2d, quad, in_front, colors = _project_sh(cloud, camera, cfg)
    lut = explut.build_exp_lut(device=dev) if cfg.use_exp_lut else None
    order = torch.argsort(torch.where(in_front, depth,
                                      torch.full_like(depth, float("inf"))))
    depth, mean2d, quad = depth[order], mean2d[order], quad[order]
    opac, in_front, colors = cloud.opacity[order], in_front[order], \
        colors[order]

    pix = _pixel_grid(camera.width, camera.height, dev)
    P = pix.shape[0]
    trans = torch.ones(P, device=dev)
    color = torch.zeros((P, 3), device=dev)
    hits = torch.zeros(P, dtype=torch.int32, device=dev)
    dacc = torch.zeros(P, device=dev)
    chunk = cfg.splat_chunk
    for c0 in range(0, cloud.n, chunk):
        sl = slice(c0, c0 + chunk)
        alpha, accept = _chunk_alphas(pix, mean2d[sl], quad[sl], depth[sl],
                                      opac[sl], in_front[sl], cfg, lut)
        cum = torch.cumprod(1.0 - alpha, dim=-1)
        excl = torch.cat([torch.ones_like(cum[:, :1]), cum[:, :-1]], -1)
        w = alpha * excl * trans[:, None]
        color = color + w @ colors[sl]
        if with_depth:
            ds = depth[sl]
            dacc = dacc + w @ torch.where(torch.isfinite(ds), ds,
                                          torch.zeros_like(ds))
        trans = trans * cum[:, -1]
        hits = hits + accept.sum(-1, dtype=torch.int32)

    if cfg.white_background:
        color = color + trans[:, None]
    H, W = camera.height, camera.width
    passes = -(-hits // cfg.k)
    return RenderOutput(trans=trans.reshape(H, W),
                        color=color.reshape(H, W, 3),
                        passes=passes.reshape(H, W),
                        hits=hits.reshape(H, W),
                        depth=dacc.reshape(H, W) if with_depth else None)


def _nearest_pass(n_rays: int, candidates, k: int, init_d: float, dev):
    """One k-buffer pass: every chunk's candidates (depth, alpha, id)
    merged into a fresh buffer. Returns (kd, ka, ki, count)."""
    kd = torch.full((n_rays, k), init_d, device=dev)
    ka = torch.zeros((n_rays, k), device=dev)
    ki = torch.zeros((n_rays, k), dtype=torch.int64, device=dev)
    for cd, ca, ci in candidates:
        kd, ka, ki = merge_nearest(kd, ka, ki, cd, ca, ci)
    return kd, ka, ki, (kd < init_d).sum(-1, dtype=torch.int32)


def render_reference(cloud: GaussianCloud, camera: Camera,
                     cfg: RenderConfig) -> RenderOutput:
    """The paper's multi-pass k-buffer render: each pass keeps, per pixel,
    the k nearest accepted splats beyond its depth front (chunks of
    cfg.splat_chunk splats merged into the buffer), composites them front
    to back and advances the front to the last one. A pixel is done on a
    pass that finds nothing or after cfg.max_passes passes; `passes`
    counts the passes that found something, `hits` the splats blended.
    Equal depths are taken lowest splat index first (`ops.kbuffer`).

    Each pass traces only the pixels still live; the JAX package runs
    every pixel each pass and keeps the finished ones' state unchanged,
    which gives the same outputs."""
    if cloud.n == 0:
        return _empty_output(camera, cfg)
    dev = cloud.device
    depth, mean2d, quad, in_front, colors = _project_sh(cloud, camera, cfg)
    lut = explut.build_exp_lut(device=dev) if cfg.use_exp_lut else None
    pix = _pixel_grid(camera.width, camera.height, dev)
    P = pix.shape[0]
    init_d = float(cfg.init_depth)
    ids = torch.arange(cloud.n, device=dev)
    front = torch.zeros(P, device=dev)
    trans = torch.ones(P, device=dev)
    color = torch.zeros((P, 3), device=dev)
    passes = torch.zeros(P, dtype=torch.int32, device=dev)
    hits = torch.zeros(P, dtype=torch.int32, device=dev)
    live = torch.arange(P, device=dev)

    def candidates(px, fr):
        for c0 in range(0, cloud.n, cfg.splat_chunk):
            sl = slice(c0, c0 + cfg.splat_chunk)
            alpha, accept = _chunk_alphas(px, mean2d[sl], quad[sl],
                                          depth[sl], cloud.opacity[sl],
                                          in_front[sl], cfg, lut)
            ds = depth[sl][None, :]
            valid = accept & (ds > fr[:, None])
            yield (torch.where(valid, ds, init_d),
                   torch.where(valid, alpha, 0.0), ids[sl])

    while live.numel():
        fr = front[live]
        kd, ka, ki, count = _nearest_pass(
            live.numel(), candidates(pix[live], fr), cfg.k, init_d, dev)
        trans[live], color[live], front[live] = finish_pass(
            trans[live], color[live], fr, kd, ka, colors[ki], count)
        miss = count == 0
        p = passes[live] + (~miss).to(torch.int32)
        passes[live] = p
        hits[live] += count
        live = live[~(miss | (p >= cfg.max_passes))]

    if cfg.white_background:
        color = color + trans[:, None]
    H, W = camera.height, camera.width
    return RenderOutput(trans=trans.reshape(H, W),
                        color=color.reshape(H, W, 3),
                        passes=passes.reshape(H, W),
                        hits=hits.reshape(H, W))


def trace_gaussian_rays(cloud: GaussianCloud, origins, dirs,
                        cfg: RenderConfig, colors=None, t_max=None,
                        sh_origin=None):
    """The k-buffer passes for arbitrary rays, through the ray-space
    response (`ops.gaussian.ray_gaussian_response`, t* as the depth).

    origins, dirs [R, 3] (dirs need not be unit: t is the ray parameter);
    t_max an optional per-ray [R] bound on t (cfg.t_max when None),
    clamped to cfg.init_depth; colors [N, 3] per splat, or SH seen from
    sh_origin (a [3] point), or the SH's DC term when both are None.
    Returns (trans [R], color [R, 3], hits [R]). A ray is done on a pass
    that finds nothing or once hits ≥ cfg.max_passes·k. Every pass sweeps
    all splats in chunks of cfg.splat_chunk, tracing only the rays still
    live (the same outputs as tracing all). Equal t* are taken lowest
    splat index first."""
    dev = origins.device
    R, N = origins.shape[0], cloud.n
    cov_inv = invert_cov3d(cloud.cov3d)
    if colors is None:
        if sh_origin is not None:
            colors = eval_sh(cloud.sh, unit_dirs(cloud.means, sh_origin),
                             min(cfg.sh_degree, cloud.sh_degree))
        else:
            colors = eval_sh(cloud.sh, torch.zeros_like(cloud.means), 0)
    tmax_r = ray_window(t_max, R, cfg, dev)
    op = torch.where(cloud.opacity > cfg.alpha_threshold, cloud.opacity,
                     torch.zeros_like(cloud.opacity))
    init_d = float(cfg.init_depth)
    ids = torch.arange(N, device=dev)
    front = torch.zeros(R, device=dev)
    trans = torch.ones(R, device=dev)
    color = torch.zeros((R, 3), device=dev)
    hits = torch.zeros(R, dtype=torch.int32, device=dev)
    live = torch.arange(R, device=dev)

    def candidates(o, d, lo, hi):
        for c0 in range(0, N, cfg.splat_chunk):
            sl = slice(c0, c0 + cfg.splat_chunk)
            t_star, g = ray_gaussian_response(o, d, cloud.means[sl],
                                              cov_inv[sl])
            alpha = torch.clamp_max(op[sl][None, :] * torch.exp(-g), 0.99)
            valid = ((g <= cfg.g_cutoff) & (alpha > cfg.alpha_threshold)
                     & (t_star > lo) & (t_star < hi))
            yield (torch.where(valid, t_star, init_d),
                   torch.where(valid, alpha, 0.0), ids[sl])

    while live.numel():
        fr = front[live]
        kd, ka, ki, count = _nearest_pass(
            live.numel(),
            candidates(origins[live], dirs[live],
                       torch.clamp_min(fr, cfg.t_min)[:, None],
                       tmax_r[live][:, None]),
            cfg.k, init_d, dev)
        trans[live], color[live], front[live] = finish_pass(
            trans[live], color[live], fr, kd, ka, colors[ki], count)
        h = hits[live] + count
        hits[live] = h
        live = live[~((count == 0) | (h >= cfg.max_passes * cfg.k))]
    return trans, color, hits


class StreamPlan(NamedTuple):
    span_mode: str      # after the ellipse → rect fallback
    stream: str         # "group" or "tile"
    compact: bool
    group_k: Optional[int]


def stream_plan(cfg: RenderConfig, width: int, height: int,
                serving: bool = False) -> StreamPlan:
    """The JAX package's render_tiled gating (gaussian_rt.py:403-436):
    payload tier, span mode after its fallback, stream. Serving keeps to
    the tile stream, whose per-tile pair positions its feedback reads.
    `render_tiled` and `GaussianRayTracer.calibrate` both read it, so the
    buffers calibrate sizes are the ones the render uses."""
    tw, th = cfg.tile_w, cfg.tile_h
    ntx, nty = tile_extent(width, height, tw, th)
    compact = (cfg.payload == "compact" and cfg.blend_impl == "packed"
               and ntx <= 127 and (tw, th) != (128, 8))
    span_mode = cfg.span_mode
    if span_mode == "ellipse" and nty > 255:
        span_mode = "rect"   # 8-bit row-count budget
    group_k = group_rows_k(ntx)
    stream = cfg.stream
    if stream == "group" and not (
            compact and not serving and cfg.scan_impl == "logmm"
            and span_mode == "rect" and group_k is not None):
        stream = "tile"
    return StreamPlan(span_mode, stream, compact, group_k)


class ServingAux(NamedTuple):
    """Per-frame feedback the serving loop consumes (`gsrt_torch.serving`):
    raw binning and kernel outputs of a frame rendered with serving=True."""
    tile_start: torch.Tensor   # [T + 1] int32 pair offsets
    tile_count: torch.Tensor   # [T] int32 pairs per tile (culled stream)
    pair_depth: torch.Tensor   # [max_pairs] f32 camera depth per pair
    consumed: torch.Tensor     # [G, bs] int32 first saturated chunk index
                               # (the group's chunk count if never)


def render_tiled(cloud: GaussianCloud, camera: Camera, cfg: RenderConfig,
                 max_pairs: int = 1 << 20, max_rows: int | None = None,
                 cutoff_map: torch.Tensor | None = None,
                 serving: bool = False):
    """Tile-binned splatting; see the module docstring for the streams.

    max_pairs sizes the pair buffer, max_rows the group stream's unit
    buffer (max_pairs when None); a view that needs more sets `overflow`
    and renders the truncated stream. cfg.exact_hits reports each pixel's
    accepted pairs from the packed kernels; otherwise each pixel reports
    its tile's pair count. With serving=True (packed blend, tiles other
    than 128×8) the frame blends the compact or f32 tile stream at
    128-pair chunks, `cutoff_map` [T] (optional) culls splats behind the
    previous frame's saturation depths, and the call returns
    (RenderOutput, ServingAux). The blends compute in f32 whatever
    `cfg.blend_math` says: the port has no bf16 tier."""
    from gsrt_torch.ops.splat_packed import blend_packed
    from gsrt_torch.ops.splat_pallas import blend_tiles
    from gsrt_torch.ops.splat_subtile import blend_subtiles
    from gsrt_torch.ops.tile_binning import build_tile_binning

    tw, th = cfg.tile_w, cfg.tile_h
    tiles128 = (tw, th) == (128, 8)
    if serving and (cfg.blend_impl != "packed" or tiles128):
        raise ValueError("serving needs the packed blend and tiles other "
                         "than 128x8")
    plan = stream_plan(cfg, camera.width, camera.height, serving)
    ntx, nty = tile_extent(camera.width, camera.height, tw, th)
    bs = plan.group_k * ntx if plan.stream == "group" else cfg.blend_bs
    if cloud.n == 0:
        out = _empty_output(camera, cfg)._replace(
            overflow=torch.zeros((), dtype=torch.bool, device=camera.device))
        if not serving:
            return out
        zi = lambda *shape: torch.zeros(shape, dtype=torch.int32,
                                        device=camera.device)
        return out, ServingAux(
            tile_start=zi(ntx * nty + 1), tile_count=zi(ntx * nty),
            pair_depth=torch.zeros(max_pairs, device=camera.device),
            consumed=zi(1, cfg.blend_bs))

    with TRACER.span("render.project"):
        cols = _precompute(cloud, camera, cfg)
    with TRACER.span("render.binning"):
        binning = build_tile_binning(
            cols.depth, cols.m2x, cols.m2y, cols.qa, cols.qb, cols.qc,
            cloud.opacity, cols.cr, cols.cg, cols.cb, cols.rx, cols.ry,
            cols.alive,
            width=camera.width, height=camera.height, tile_w=tw, tile_h=th,
            max_pairs=max_pairs, compact=plan.compact,
            span_mode=plan.span_mode, max_rows=max_rows, stream=plan.stream,
            expand_impl=cfg.expand_impl, cutoff_map=cutoff_map,
            carry_depth=serving, cull_super=cfg.serving_super,
            g_cutoff=cfg.g_cutoff, alpha_threshold=cfg.alpha_threshold)
        TRACER.count(pairs=binning.total_pairs, max_pairs=max_pairs)
    size = dict(width=camera.width, height=camera.height)
    exact_hits = None
    consumed = None
    with TRACER.span("render.blend"):
        if tiles128:
            # the (128, 8) and subtile blends stage and stop at 128-pair
            # chunks
            color, trans = blend_tiles(
                binning, chunk=min(cfg.pair_chunk, 128), **size,
                **blend_params(cfg))
        elif cfg.blend_impl == "subtile":
            color, trans = blend_subtiles(
                binning, sub_w=tw, sub_h=th, chunk=min(cfg.pair_chunk, 128),
                **size, **blend_params(cfg))
        else:
            res = list(blend_packed(
                binning, sub_w=tw, sub_h=th, bs=bs,
                group_stream=plan.stream == "group", track_consumed=serving,
                track_hits=cfg.exact_hits,
                # serving reads saturation positions at chunk granularity:
                # a 384-pair chunk rounds them up so far that the cull
                # never engages (the JAX package clamps the same way)
                chunk=min(cfg.pair_chunk, 128) if serving
                else cfg.pair_chunk,
                **size, **blend_params(cfg)))
            color, trans = res[0], res[1]
            consumed = res[2] if serving else None
            exact_hits = res[-1] if cfg.exact_hits else None
    if cfg.white_background:
        color = color + trans[..., None]

    H, W = camera.height, camera.width
    if exact_hits is not None:
        hits = exact_hits
    else:
        # the blend does not count: each pixel reports its tile's pair
        # count (metrics-grade, as in the JAX package)
        hits = binning.tile_count.reshape(nty, ntx).repeat_interleave(
            th, 0).repeat_interleave(tw, 1)[:H, :W]
    out = RenderOutput(trans=trans, color=color, passes=-(-hits // cfg.k),
                       hits=hits, overflow=binning.overflow)
    if serving:
        return out, ServingAux(tile_start=binning.tile_start,
                               tile_count=binning.tile_count,
                               pair_depth=binning.pair_depth,
                               consumed=consumed)
    return out


def count_pairs(cloud: GaussianCloud, camera: Camera,
                cfg: RenderConfig) -> torch.Tensor:
    """Total (tile, splat) pairs this view generates under rect spans,
    counted on the cloud's device: a 0-d int64 tensor (read it when the
    host needs the value)."""
    from gsrt_torch.ops.gaussian import screen_extents
    from gsrt_torch.ops.tile_binning import compute_tile_spans
    _, mean2d, quad, _, in_front = project_gaussians(
        cloud.means, cloud.cov3d, camera, conic_mode=cfg.conic_mode,
        cov2d_dilation=cfg.cov2d_dilation)
    rx, ry = screen_extents(quad, cfg.conic_mode, cfg.g_cutoff,
                            opacity=cloud.opacity,
                            alpha_threshold=cfg.alpha_threshold)
    alive = in_front & (cloud.opacity > cfg.alpha_threshold)
    *_, touched = compute_tile_spans(
        mean2d[:, 0], mean2d[:, 1], rx, ry, alive, camera.width,
        camera.height, cfg.tile_w, cfg.tile_h)
    return touched.sum(dtype=torch.int64)


# --- host-side (NumPy) buffer sizing, copied from the JAX package ---

def _spans_numpy(cloud: GaussianCloud, camera: Camera,
                 cfg: RenderConfig) -> dict:
    """NumPy projection + rect tile spans for the host-side pair counters
    (mirrors _precompute + compute_tile_spans)."""
    TILE_W, TILE_H = cfg.tile_w, cfg.tile_h
    means = cloud.means.detach().cpu().numpy()
    cov = cloud.cov3d.detach().cpu().numpy()
    opacity = cloud.opacity.detach().cpu().numpy()
    view = camera.view.detach().cpu().numpy()
    fx, fy = float(camera.fx), float(camera.fy)
    R, t = view[:3, :3], view[:3, 3]
    p = means @ R.T + t
    z = p[:, 2]
    in_front = z > 1e-4
    zs = np.where(in_front, z, 1.0)
    inv_z = 1.0 / zs
    px_c = fx * p[:, 0] * inv_z + float(camera.cx)
    py_c = fy * p[:, 1] * inv_z + float(camera.cy)
    j00 = fx * inv_z
    j02 = -fx * p[:, 0] * inv_z * inv_z
    j11 = fy * inv_z
    j12 = -fy * p[:, 1] * inv_z * inv_z
    t0 = np.stack([j00 * R[0, 0] + j02 * R[2, 0],
                   j00 * R[0, 1] + j02 * R[2, 1],
                   j00 * R[0, 2] + j02 * R[2, 2]], -1)
    t1 = np.stack([j11 * R[1, 0] + j12 * R[2, 0],
                   j11 * R[1, 1] + j12 * R[2, 1],
                   j11 * R[1, 2] + j12 * R[2, 2]], -1)
    sig = np.zeros((means.shape[0], 3, 3), np.float32)
    sig[:, 0, 0], sig[:, 0, 1], sig[:, 0, 2] = cov[:, 0], cov[:, 1], cov[:, 2]
    sig[:, 1, 0], sig[:, 1, 1], sig[:, 1, 2] = cov[:, 1], cov[:, 3], cov[:, 4]
    sig[:, 2, 0], sig[:, 2, 1], sig[:, 2, 2] = cov[:, 2], cov[:, 4], cov[:, 5]
    u = np.einsum("nij,nj->ni", sig, t0)
    v = np.einsum("nij,nj->ni", sig, t1)
    a = np.sum(t0 * u, -1) + cfg.cov2d_dilation
    b = np.sum(t1 * u, -1)
    c = np.sum(t1 * v, -1) + cfg.cov2d_dilation
    det = a * c - b * b
    if cfg.conic_mode == "standard":
        in_front &= det > 1e-12
        dq = np.maximum(det, 1e-12)
        qa, qb, qc = c / dq, -b / dq, a / dq
    else:
        qa, qb, qc = a, b, c
    qdet = np.maximum(qa * qc - qb * qb, 1e-18)
    g = np.minimum(cfg.g_cutoff,
                   np.maximum(np.log(np.maximum(
                       opacity / cfg.alpha_threshold, 1e-6)), 0.0))
    rx = np.sqrt(np.maximum(2.0 * g * qc / qdet, 0.0))
    ry = np.sqrt(np.maximum(2.0 * g * qa / qdet, 0.0))
    alive = in_front & (opacity > cfg.alpha_threshold) & (rx > 0) & (ry > 0)
    W, H = camera.width, camera.height
    ntx, nty = -(-W // TILE_W), -(-H // TILE_H)
    x0 = np.clip(np.floor((px_c - rx) / TILE_W), 0, ntx - 1)
    x1 = np.clip(np.floor((px_c + rx) / TILE_W), 0, ntx - 1)
    y0 = np.clip(np.floor((py_c - ry) / TILE_H), 0, nty - 1)
    y1 = np.clip(np.floor((py_c + ry) / TILE_H), 0, nty - 1)
    on = ((px_c + rx >= 0) & (px_c - rx < W) &
          (py_c + ry >= 0) & (py_c - ry < H))
    touched = np.where(alive & on, (x1 - x0 + 1) * (y1 - y0 + 1), 0)
    return dict(px=px_c, py=py_c, qa=qa, qb=qb, qc=qc, g=g,
                x0=x0.astype(np.int64), x1=x1.astype(np.int64),
                y0=y0.astype(np.int64), y1=y1.astype(np.int64),
                touched=touched.astype(np.int64))


def count_pairs_numpy(cloud: GaussianCloud, camera: Camera,
                      cfg: RenderConfig) -> int:
    """Host-side count of the (tile, splat) pairs of this view."""
    return int(_spans_numpy(cloud, camera, cfg)["touched"].sum())


def count_rows_pairs_numpy(cloud: GaussianCloud, camera: Camera,
                           cfg: RenderConfig) -> tuple[int, int]:
    """Host-side (pairs, tile-row units) under ellipse spans: the span math
    of `tile_binning._build_ellipse` in float64, 1e-3 px dilation
    included (so the count may differ from the binning's f32 by a few
    pairs)."""
    s = _spans_numpy(cloud, camera, cfg)
    alive = s["touched"] > 0
    x0, x1, y0, y1 = s["x0"], s["x1"], s["y0"], s["y1"]
    rows = np.where(alive, y1 - y0 + 1, 0).astype(np.int64)
    idx = np.repeat(np.arange(rows.shape[0]), rows)
    off = np.cumsum(rows) - rows
    ty = y0[idx] + (np.arange(idx.shape[0]) - off[idx])
    qa = np.maximum(s["qa"][idx], 1e-12)
    qb = s["qb"][idx]
    det = np.maximum(qa * s["qc"][idx] - qb * qb, 1e-18)
    g = s["g"][idx]
    my, mx = s["py"][idx], s["px"][idx]
    th, tw = cfg.tile_h, cfg.tile_w
    dy_lo = ty * th - my
    dy_hi = dy_lo + (th - 1)
    dy0 = np.clip(0.0, dy_lo, dy_hi)
    wmax = np.sqrt(np.maximum(2.0 * g * qa - det * dy0 * dy0, 0.0)) / qa \
        + 1e-3
    slope = qb / qa
    xc_lo = mx - slope * dy_lo
    xc_hi = mx - slope * dy_hi
    dxmin = np.minimum(xc_lo, xc_hi) - wmax
    dxmax = np.maximum(xc_lo, xc_hi) + wmax
    tx0 = np.clip(np.floor(dxmin / tw), x0[idx], x1[idx])
    tx1 = np.clip(np.floor(dxmax / tw), tx0, x1[idx])
    return int((tx1 - tx0 + 1).sum()), int(rows.sum())


def count_units_numpy(cloud: GaussianCloud, camera: Camera,
                      cfg: RenderConfig, k: int) -> tuple[int, int]:
    """Host-side (pairs, row-group units) for the group-contiguous stream:
    a unit per k-tile-row band the footprint bbox crosses."""
    s = _spans_numpy(cloud, camera, cfg)
    alive = s["touched"] > 0
    units = np.where(alive, s["y1"] // k - s["y0"] // k + 1, 0)
    return int(s["touched"].sum()), int(units.sum())


def pair_bucket(need: int) -> int:
    """Round a pair count up to a (k/8)·2^j bucket (≤ 12.5% slack), then to
    a multiple of 128."""
    need = max(1 << 14, need)
    p = 1 << (need - 1).bit_length()
    step = max(p // 8, 128)
    mp = -(-need // step) * step
    return -(-mp // 128) * 128


class GaussianRayTracer:
    """Chooses the execution path. In "tiled" mode the static pair and unit
    buffers are sized on the first call by `calibrate` and re-sized, with a
    re-render, when a frame overflows them. defer_overflow=N > 0 reads a
    frame's overflow flag N frames later instead of at once (one host
    synchronisation per frame less): an overflowing frame is then served
    truncated, and the frame at which its flag is read re-calibrates and
    renders again."""

    def __init__(self, cfg: RenderConfig, mode: str = "fast",
                 max_pairs: Optional[int] = None, device=None,
                 defer_overflow: int = 0):
        if mode not in ("fast", "reference", "tiled"):
            raise ValueError(f"unknown mode {mode!r}")
        self.cfg = cfg
        self.mode = mode
        self.device = resolve_device(device)
        self.max_pairs = max_pairs
        self.max_rows = None
        self.defer_overflow = defer_overflow
        self._overflow_pending: list[torch.Tensor] = []

    def calibrate(self, cloud: GaussianCloud, camera: Camera) -> int:
        """Size max_pairs (and max_rows: the group stream's units or the
        ellipse spans' tile rows) from a NumPy count of this view with 10%
        slack. The span mode and stream are decided by the same gating
        `render_tiled` applies — after the ellipse → rect fallback — so
        the buffers sized are the ones the render uses."""
        plan = stream_plan(self.cfg, camera.width, camera.height)
        if plan.span_mode == "ellipse":
            total, rows = count_rows_pairs_numpy(cloud, camera, self.cfg)
            self.max_rows = pair_bucket(int(rows * 1.1))
        elif plan.stream == "group":
            total, units = count_units_numpy(cloud, camera, self.cfg,
                                             plan.group_k)
            self.max_rows = pair_bucket(int(units * 1.1))
        else:
            total = count_pairs_numpy(cloud, camera, self.cfg)
            self.max_rows = None
        self.max_pairs = pair_bucket(int(total * 1.1))
        return self.max_pairs

    def _render(self, cloud, camera) -> RenderOutput:
        return render_tiled(cloud, camera, self.cfg,
                            max_pairs=self.max_pairs, max_rows=self.max_rows)

    def __call__(self, cloud: GaussianCloud, camera: Camera) -> RenderOutput:
        with TRACER.span("render.frame", root=True):
            cloud, camera = cloud.to(self.device), camera.to(self.device)
            if self.mode == "fast":
                return render_fast(cloud, camera, self.cfg)
            if self.mode == "reference":
                return render_reference(cloud, camera, self.cfg)
            if self.max_pairs is None:
                self.calibrate(cloud, camera)
            out = self._render(cloud, camera)
            if self.defer_overflow > 0:
                self._overflow_pending.append(out.overflow)
                # read a flag only once it is defer_overflow frames old
                if len(self._overflow_pending) <= self.defer_overflow:
                    return out
                with TRACER.span("render.sync"):
                    overflow = bool(self._overflow_pending.pop(0))
                if overflow:
                    self.calibrate(cloud, camera)
                    out = self._render(cloud, camera)
                    self._overflow_pending.clear()
                return out
            with TRACER.span("render.sync"):
                overflow = bool(out.overflow)
            if overflow:
                # the view outgrew the buffers (zoom, scene growth): re-size
                # and render again rather than serve truncated pairs
                self.calibrate(cloud, camera)
                out = self._render(cloud, camera)
            return out
