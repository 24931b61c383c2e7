"""Differentiable tiled splatting: an autograd function around the binned
blend (counterpart of `gsrt.models.tiled_diff`).

`render_fast` differentiates through plain tensor code but costs
O(splats × pixels); this module makes the tiled path trainable. The
forward is the f32 tile-stream binning and the subtile blend kernel
(`blend_tiles` at 128×8 tiles, the same kernel); the backward is the
blend's backward kernel (`gsrt_torch.ops.splat_grad`),
which re-walks each tile's pair list and emits per-pair gradients, routed
back to splats by `route_pair_grads`.

The depth sort order, the footprint extents, the culling masks and the
pack15 colour quantisation are constants of the step, like the sort and
cull indices of the standard CUDA trainer: the quantiser passes gradients
straight through, also where a colour was clipped to [0, PACK_RANGE).
"""

from __future__ import annotations

import torch

from gsrt_torch.core.config import RenderConfig
from gsrt_torch.core.types import Camera, GaussianCloud
from gsrt_torch.models.gaussian_rt import (_project_sh, alive_mask,
                                           blend_params)
from gsrt_torch.ops.gaussian import screen_extents_abc
from gsrt_torch.ops.tile_binning import tile_extent
from gsrt_torch.utils.profiling import TRACER


def tilefy(img: torch.Tensor, tile_w: int, tile_h: int) -> torch.Tensor:
    """[H, W] → [T · tile_h·tile_w]: zero-padded to whole tiles, tile-major,
    each tile's pixels in row-major order."""
    H, W = img.shape
    ntx, nty = tile_extent(W, H, tile_w, tile_h)
    a = torch.nn.functional.pad(img, (0, ntx * tile_w - W,
                                      0, nty * tile_h - H))
    return a.reshape(nty, tile_h, ntx, tile_w).permute(0, 2, 1, 3).reshape(-1)


def route_pair_grads(grad: torch.Tensor, pair_index: torch.Tensor,
                     sorted_base, sorted_touched, sorted_orig
                     ) -> torch.Tensor:
    """Per-pair gradients [R, max_pairs] in tile order → per-splat sums
    [R, N] in the caller's splat order.

    pair_index (payload row 7) is each column's depth-order pair index,
    max_pairs on dead columns, whose gradients are zero: scattering by it
    puts the columns in depth order. There a splat's pairs are the run
    [base, base + touched), so its sum is a difference of prefix sums;
    these are taken in float64, which keeps the difference exact to f32
    rounding, and nothing is added atomically, so the result is the same
    on every run."""
    max_pairs = grad.shape[1]
    # one column to the right, so that csum[:, k] sums the first k pairs;
    # the dead columns' zeros all land in the last, unread column
    g_depth = torch.zeros((grad.shape[0], max_pairs + 2),
                          dtype=torch.float64, device=grad.device)
    g_depth[:, pair_index.long() + 1] = grad.double()
    # one scan over the flattened rows (a per-row scan of a few long rows
    # runs on a few blocks): differences are taken within a row only
    csum = torch.cumsum(g_depth.view(-1), dim=0).view_as(g_depth)
    live = sorted_touched > 0
    lo = torch.where(live, sorted_base, torch.zeros_like(sorted_base)).long()
    hi = torch.clamp(lo + sorted_touched, 0, max_pairs)
    seg = torch.where(live[None, :], csum[:, hi] - csum[:, lo], 0.0)
    out = torch.empty_like(seg, dtype=grad.dtype)
    out[:, sorted_orig.long()] = seg.to(grad.dtype)   # a permutation
    return out


class PairOverflow(RuntimeError):
    """The view needs `needed` pairs, more than the step's max_pairs."""

    def __init__(self, needed: int, max_pairs: int):
        super().__init__(
            f"the view needs {needed} pairs and max_pairs is {max_pairs}: "
            f"a step on a truncated stream would train on a wrong image; "
            f"size max_pairs with pair_bucket(count_pairs_numpy(...))")
        self.needed, self.max_pairs = needed, max_pairs


class _TiledBlend(torch.autograd.Function):
    """(m2x, m2y, qa, qb, qc, opacity, cr, cg, cb) → (color [H, W, 3],
    trans [H, W]), background not applied. depth, rx, ry and alive only
    pick the visit order and the culling set and get no gradient."""

    @staticmethod
    def forward(ctx, m2x, m2y, qa, qb, qc, opacity, cr, cg, cb, depth, rx,
                ry, alive, cfg: RenderConfig, width: int, height: int,
                max_pairs: int):
        from gsrt_torch.ops.splat_pallas import blend_tiles
        from gsrt_torch.ops.splat_subtile import blend_subtiles
        from gsrt_torch.ops.tile_binning import build_tile_binning
        tw, th = cfg.tile_w, cfg.tile_h
        # the backward stages 128 pairs per chunk and the forward must stop
        # at the same boundaries, or pairs the forward blended inside a
        # straddling chunk would get zero gradients
        chunk = min(cfg.pair_chunk, 128)
        with TRACER.span("render.binning"):
            binning = build_tile_binning(
                depth, m2x, m2y, qa, qb, qc, opacity, cr, cg, cb, rx, ry,
                alive, width=width, height=height, tile_w=tw, tile_h=th,
                max_pairs=max_pairs, compact=False,
                expand_impl=cfg.expand_impl, with_ids=True)
            TRACER.count(pairs=binning.total_pairs, max_pairs=max_pairs)
        with TRACER.span("train.sync"):
            overflow = bool(binning.overflow)
        if overflow:
            raise PairOverflow(int(binning.total_pairs), max_pairs)
        with TRACER.span("render.blend"):
            if (tw, th) == (128, 8):
                color, trans = blend_tiles(
                    binning, width=width, height=height, chunk=chunk,
                    **blend_params(cfg))
            else:
                color, trans = blend_subtiles(
                    binning, width=width, height=height, sub_w=tw, sub_h=th,
                    chunk=chunk, **blend_params(cfg))
        ctx.save_for_backward(binning.payload, binning.tile_start,
                              binning.sorted_base, binning.sorted_touched,
                              binning.sorted_orig, color, trans)
        ctx.cfg, ctx.size, ctx.chunk = cfg, (width, height), chunk
        return color, trans

    @staticmethod
    def backward(ctx, dcolor, dtrans):
        from gsrt_torch.ops.splat_grad import blend_backward
        with TRACER.span("train.blend_bwd"):
            payload, tile_start, sbase, stouched, sorig, color, trans = \
                ctx.saved_tensors
            cfg, (width, height) = ctx.cfg, ctx.size
            tw, th = cfg.tile_w, cfg.tile_h
            planes = [color[..., 0], color[..., 1], color[..., 2], trans,
                      dcolor[..., 0], dcolor[..., 1], dcolor[..., 2], dtrans]
            pixstate = torch.stack([tilefy(p, tw, th) for p in planes])
            grad = blend_backward(
                payload, tile_start, pixstate, width=width, height=height,
                tile_w=tw, tile_h=th, chunk=ctx.chunk, **blend_params(cfg))
            per_splat = route_pair_grads(grad, payload[7], sbase, stouched,
                                         sorig)
        return (*per_splat, *([None] * 8))


def tiled_blend_diff(cfg: RenderConfig, camera: Camera, max_pairs: int,
                     depth, rx, ry, alive):
    """The differentiable blend core for one (cfg, camera, buffer size):
    core(m2x, m2y, qa, qb, qc, opacity, cr, cg, cb) → (color [H, W, 3],
    trans [H, W]), background not applied."""

    def core(m2x, m2y, qa, qb, qc, opacity, cr, cg, cb):
        return _TiledBlend.apply(m2x, m2y, qa, qb, qc, opacity, cr, cg, cb,
                                 depth, rx, ry, alive, cfg, camera.width,
                                 camera.height, max_pairs)
    return core


def render_tiled_diff(cloud: GaussianCloud, camera: Camera,
                      cfg: RenderConfig, max_pairs: int, stages=None):
    """Differentiable tiled render: color [H, W, 3] (plus the white
    background if cfg asks) and trans [H, W], trainable with respect to
    every field of the cloud. Raises when the view needs more than
    max_pairs pairs. With `stages` (a traced step's `BackwardStages`) the
    blend's inputs and outputs are marked: the backward closes its stage
    at the outputs and opens `train.project_bwd` past the blend."""
    with TRACER.span("render.project"):
        depth, mean2d, quad, in_front, colors = _project_sh(cloud, camera,
                                                            cfg)
        qa, qb, qc = quad.unbind(-1)
        with torch.no_grad():
            rx, ry = screen_extents_abc(qa, qb, qc, cfg.conic_mode,
                                        cfg.g_cutoff, opacity=cloud.opacity,
                                        alpha_threshold=cfg.alpha_threshold)
            alive = alive_mask(depth, cloud.opacity, in_front, cfg)
        cols = (*mean2d.unbind(-1), qa, qb, qc, cloud.opacity,
                *colors.unbind(-1))
        if stages is not None:
            cols = stages.mark("train.project_bwd", *cols)
    core = tiled_blend_diff(cfg, camera, max_pairs, depth.detach(), rx, ry,
                            alive)
    color, trans = core(*cols)
    if stages is not None:
        color, trans = stages.mark(None, color, trans)
    if cfg.white_background:
        color = color + trans[..., None]
    return color, trans
