"""Multi-view 3DGS fitting: the INRIA-style optimisation loop
(counterpart of `gsrt.models.multiview`).

A capture is dozens to hundreds of posed views. `ViewSet` holds them as
stacked tensors on one device; a train step takes its view by index.
Composes with `gsrt_torch.models.densify` (adaptive density control
between steps; the step folds the positional-gradient statistics),
`gsrt_torch.scene.colmap` (COLMAP models and SfM-point initialisation)
and the trainer's losses: `render_loss` (autograd of `render_fast`) for
small fits, `render_loss_tiled` (the tiled path's kernels) at real sizes.

PyTorch idiom where it differs from the JAX package: parameters and the
optimiser are updated in place, so a step is
step(params, optimizer, stats, viewset, i) → (stats, loss), and a densify
event returns new parameters that the same optimiser then holds. A tiled
step whose view needs more than `max_pairs` pairs grows its buffer and
takes the step again, so no step trains on a truncated stream.

Evaluation follows the INRIA/LLFF convention: every `holdout`-th view (by
sorted file name) is left out of training and scored by PSNR.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from gsrt_torch.core.config import RenderConfig
from gsrt_torch.core.types import Camera, resolve_device
from gsrt_torch.models.densify import (DensifyStats, accumulate_stats,
                                       densify_and_prune, init_stats,
                                       reset_opacity)
from gsrt_torch.models.gaussian_rt import pair_bucket
from gsrt_torch.models.tiled_diff import PairOverflow
from gsrt_torch.models.trainer import (GaussianParams, _step,
                                       make_optimizer, render_loss,
                                       render_loss_tiled)


class ViewSet(NamedTuple):
    """A posed multi-view capture as stacked tensors on one device."""

    views: torch.Tensor    # [V, 4, 4] world→camera
    fx: torch.Tensor       # [V]
    fy: torch.Tensor       # [V]
    cx: torch.Tensor       # [V]
    cy: torch.Tensor       # [V]
    images: torch.Tensor   # [V, H, W, 3] f32 targets

    @property
    def n_views(self) -> int:
        return self.images.shape[0]

    @property
    def height(self) -> int:
        return self.images.shape[1]

    @property
    def width(self) -> int:
        return self.images.shape[2]

    def camera_at(self, i: int) -> Camera:
        return Camera(view=self.views[i], fx=self.fx[i], fy=self.fy[i],
                      cx=self.cx[i], cy=self.cy[i], width=self.width,
                      height=self.height)

    def select(self, idx: Sequence[int]) -> "ViewSet":
        idx = torch.as_tensor(list(idx), dtype=torch.long,
                              device=self.views.device)
        return ViewSet(*(t.index_select(0, idx) for t in self))


def viewset_from_cameras(cameras: Sequence[Camera], images,
                         device=None) -> ViewSet:
    """Stack per-view cameras (all of one resolution) and their target
    images ([H, W, 3] each, NumPy or tensors) on `device`."""
    if not cameras or len(cameras) != len(images):
        raise ValueError("one target image per camera, at least one view")
    w, h = cameras[0].width, cameras[0].height
    if not all(c.width == w and c.height == h for c in cameras):
        raise ValueError("all views in a ViewSet share one resolution")
    dev = resolve_device(device)
    stack = lambda ts: torch.stack([torch.as_tensor(t).to(
        device=dev, dtype=torch.float32) for t in ts])
    return ViewSet(views=stack([c.view for c in cameras]),
                   fx=stack([c.fx for c in cameras]),
                   fy=stack([c.fy for c in cameras]),
                   cx=stack([c.cx for c in cameras]),
                   cy=stack([c.cy for c in cameras]),
                   images=stack(images))


def viewset_from_colmap(sparse_dir: str, images_dir: str,
                        downscale: int = 1, limit: Optional[int] = None,
                        device=None):
    """COLMAP capture → (ViewSet, initial GaussianParams, scene extent),
    on `device`. Reads the images with `scene.colmap.load_image_dir`."""
    from gsrt_torch.scene.colmap import (init_params_from_points,
                                         load_colmap_model, load_image_dir,
                                         scene_extent)
    dev = resolve_device(device)
    model = load_colmap_model(sparse_dir)
    imgs, _, _ = load_image_dir(model, images_dir, downscale=downscale,
                                limit=limit)
    ims = model.images[:limit] if limit else model.images
    s = 1.0 / downscale
    intr = lambda k: torch.tensor(
        [getattr(model.cameras[im.camera_id], k) * s for im in ims],
        dtype=torch.float32, device=dev)
    vs = ViewSet(
        views=torch.as_tensor(np.stack([im.view for im in ims]),
                              device=dev),
        fx=intr("fx"), fy=intr("fy"), cx=intr("cx"), cy=intr("cy"),
        images=torch.as_tensor(imgs, device=dev))
    params = init_params_from_points(model.points, model.colors, device=dev)
    return vs, params, scene_extent(model)


def holdout_split(n_views: int, holdout: int = 8):
    """(train_idx, test_idx): every `holdout`-th view is test (the
    INRIA/LLFF llffhold convention). holdout=0 → train on everything."""
    if holdout <= 0 or n_views < 2:
        return list(range(n_views)), []
    test = list(range(0, n_views, holdout))
    train = [i for i in range(n_views) if i % holdout != 0]
    return train, test


def make_train_step_mv(cfg: RenderConfig, lambda_ssim: float = 0.2,
                       max_pairs: Optional[int] = None,
                       growths: Optional[list] = None):
    """A multi-view step: step(params, optimizer, stats, vs, i) →
    (stats, loss) on view i; params and optimizer are updated in place.
    max_pairs switches to the tiled loss (its kernels) with a pair buffer
    of that size; a view that needs more grows the buffer to
    pair_bucket(1.1 × its pairs) and takes its step again (the failed
    attempt stops in the forward, before any update), so no step trains
    on a truncated stream. `growths`, if given, receives (pairs needed,
    new max_pairs) at each growth."""

    def step(params: GaussianParams, optimizer, stats: DensifyStats,
             vs: ViewSet, i: int):
        nonlocal max_pairs
        camera, target = vs.camera_at(i), vs.images[i]
        if max_pairs is None:
            loss = _step(lambda _: render_loss(params, target, camera,
                                               cfg, lambda_ssim), optimizer)
            return accumulate_stats(stats, params), loss
        fn = lambda stages: render_loss_tiled(params, target, camera, cfg,
                                              max_pairs, lambda_ssim, stages)
        try:
            loss = _step(fn, optimizer)
        except PairOverflow as e:
            max_pairs = pair_bucket(int(e.needed * 1.1))
            if growths is not None:
                growths.append((e.needed, max_pairs))
            loss = _step(fn, optimizer)
        return accumulate_stats(stats, params), loss

    return step


def psnr(a: torch.Tensor, b: torch.Tensor, max_val: float = 1.0) -> float:
    """Peak signal-to-noise ratio in dB, in float64."""
    mse = torch.mean((a.double() - b.double()) ** 2).item()
    if mse == 0:
        return float("inf")
    return float(10.0 * np.log10(max_val ** 2 / mse))


def eval_psnr(params: GaussianParams, vs: ViewSet, idx: Sequence[int],
              cfg: RenderConfig) -> float:
    """Mean PSNR of the fitted model over views `idx` (render_fast)."""
    from gsrt_torch.models.gaussian_rt import render_fast
    if not idx:
        return float("nan")
    with torch.no_grad():
        cloud = params.to_cloud()
        vals = [psnr(render_fast(cloud, vs.camera_at(i), cfg).color,
                     vs.images[i]) for i in idx]
    return float(np.mean(vals))


class FitReport(NamedTuple):
    losses: list
    n_splats: int
    train_psnr: float
    test_psnr: float
    pair_growths: tuple = ()    # the step's (pairs needed, new max_pairs)


def fit_views(
    vs: ViewSet,
    params: GaussianParams,
    cfg: RenderConfig,
    *,
    iters: int = 2000,
    lambda_ssim: float = 0.2,
    holdout: int = 8,
    densify_every: int = 0,
    densify_grad: float = 2e-4,
    densify_until: float = 0.75,
    scene_scale: float = 1.0,
    opacity_reset_every: int = 0,
    max_splats: Optional[int] = None,
    bucket: int = 4096,
    seed: int = 0,
    log_every: int = 0,
    optimizer: Optional[torch.optim.Optimizer] = None,
    max_pairs: Optional[int] = None,
):
    """The fit loop over a posed capture (the INRIA schedule's shape).

    Views are visited in epoch-shuffled order over the train split;
    densification events run every `densify_every` steps up to
    `densify_until`·iters; `opacity_reset_every` applies the periodic
    opacity clamp (`densify.reset_opacity`) over the same span. Densify
    thresholds scale with `scene_scale` (pass `scene_extent` of a COLMAP
    model). `optimizer`, if given, must hold `params` (as `make_optimizer`
    builds it); it is updated in place. Returns (params, FitReport)."""
    rng = np.random.default_rng(seed)
    train_idx, test_idx = holdout_split(vs.n_views, holdout)
    if optimizer is None:
        optimizer = make_optimizer(params, lr_means=1.6e-4 * scene_scale)
    stats = init_stats(params.means.shape[0], params.means.device)
    growths: list = []
    step = make_train_step_mv(cfg, lambda_ssim, max_pairs=max_pairs,
                              growths=growths)
    order: list = []
    losses = []
    for it in range(iters):
        if not order:
            order = list(rng.permutation(train_idx))
        v = int(order.pop())
        grown = len(growths)
        stats, loss = step(params, optimizer, stats, vs, v)
        losses.append(loss)
        for needed, mp in growths[grown:] if log_every else ():
            print(f"iter {it:5d}  view {v:3d}  pair buffer grown to {mp} "
                  f"({needed} pairs needed)")
        if (densify_every and (it + 1) % densify_every == 0
                and it < iters * densify_until):
            params, optimizer, stats, rep = densify_and_prune(
                params, optimizer, stats, grad_threshold=densify_grad,
                scale_threshold=0.01 * scene_scale, max_splats=max_splats,
                bucket=bucket, seed=seed + it)
            if log_every:
                print(f"iter {it:5d}  densify {rep.n_before}->{rep.n_after}"
                      f" (+{rep.n_cloned}c +{rep.n_split}s -{rep.n_pruned}p)")
        if (opacity_reset_every and (it + 1) % opacity_reset_every == 0
                and it < iters * densify_until):
            params = reset_opacity(params)
        if log_every and it % log_every == 0:
            print(f"iter {it:5d}  view {v:3d}  loss {loss.item():.5f}")
    report = FitReport(
        losses=torch.stack(losses).tolist() if losses else [],
        n_splats=int(params.means.shape[0]),
        train_psnr=eval_psnr(params, vs, train_idx[:8], cfg),
        test_psnr=eval_psnr(params, vs, test_idx[:8], cfg),
        pair_growths=tuple(growths))
    return params, report
