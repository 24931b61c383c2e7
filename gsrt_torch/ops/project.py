"""The tiled forward's projection layer: per splat the EWA projection, the
conic, the SH colour, the footprint extents and the alive mask, as the
twelve [N] columns `build_tile_binning` takes.

`project_splats` launches one CUDA kernel (`csrc/project.cu`) on CUDA
tensors and runs `project_splats_plain`, the same composition as plain
PyTorch ops, on CPU tensors. The kernel is bit-equal to the plain version
on the card; the plain version is the CPU's path and the kernel's
reference. Neither takes gradients: the training path projects under
autograd (`models.gaussian_rt._project_sh`).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from gsrt_torch import _kernels
from gsrt_torch.core.config import RenderConfig
from gsrt_torch.core.types import Camera, GaussianCloud
from gsrt_torch.ops.gaussian import project_gaussians, screen_extents_abc
from gsrt_torch.ops.sh import eval_sh


class SplatColumns(NamedTuple):
    """Per-splat [N] columns of one view, in `build_tile_binning`'s order
    (opacity, which the binning also takes, is the cloud's own)."""
    depth: torch.Tensor
    m2x: torch.Tensor
    m2y: torch.Tensor
    qa: torch.Tensor       # the quadratic form (the conic in standard mode)
    qb: torch.Tensor
    qc: torch.Tensor
    cr: torch.Tensor       # SH colour
    cg: torch.Tensor
    cb: torch.Tensor
    rx: torch.Tensor       # footprint half-extents
    ry: torch.Tensor
    alive: torch.Tensor    # bool


def unit_dirs(means: torch.Tensor, origin) -> torch.Tensor:
    """Unit directions from `origin` ([3]) to each mean: the view
    directions SH colours are evaluated at."""
    d = means - torch.as_tensor(origin, dtype=means.dtype,
                                device=means.device)
    inv_n = 1.0 / torch.clamp_min(
        torch.sqrt(d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2]),
        1e-9)
    return d * inv_n[:, None]


def alive_mask(depth, opacity, in_front, cfg: RenderConfig) -> torch.Tensor:
    """Splats the tiled path bins: in front, above the alpha threshold and
    inside the ray's depth window."""
    return (in_front & (opacity > cfg.alpha_threshold) & (depth > cfg.t_min)
            & (depth < min(cfg.t_max, cfg.init_depth)))


def project_splats_plain(cloud: GaussianCloud, camera: Camera,
                         cfg: RenderConfig) -> SplatColumns:
    """Projection, SH colour (seen from the camera's position), extents
    tightened by opacity, and the alive mask, as plain tensor ops."""
    depth, mean2d, quad, _, in_front = project_gaussians(
        cloud.means, cloud.cov3d, camera, conic_mode=cfg.conic_mode,
        cov2d_dilation=cfg.cov2d_dilation)
    colors = eval_sh(cloud.sh, unit_dirs(cloud.means, camera.position),
                     min(cfg.sh_degree, cloud.sh_degree))
    qa, qb, qc = quad[:, 0], quad[:, 1], quad[:, 2]
    rx, ry = screen_extents_abc(qa, qb, qc, cfg.conic_mode, cfg.g_cutoff,
                                opacity=cloud.opacity,
                                alpha_threshold=cfg.alpha_threshold)
    alive = alive_mask(depth, cloud.opacity, in_front, cfg)
    return SplatColumns(depth, mean2d[:, 0], mean2d[:, 1], qa, qb, qc,
                        colors[:, 0], colors[:, 1], colors[:, 2], rx, ry,
                        alive)


def _f32(t: torch.Tensor, name: str, dev) -> torch.Tensor:
    if t.dtype != torch.float32 or t.device != dev:
        raise ValueError(f"project_splats: {name} must be float32 on {dev}, "
                         f"got {t.dtype} on {t.device}")
    return t.contiguous()


def project_splats(cloud: GaussianCloud, camera: Camera,
                   cfg: RenderConfig) -> SplatColumns:
    """`project_splats_plain`'s columns: on CUDA tensors from one launch of
    the projection kernel (the eleven float columns are rows of one
    [11, N] buffer), on CPU tensors from the plain version. Raises on any
    other device."""
    dev = cloud.device
    if dev.type == "cpu":
        return project_splats_plain(cloud, camera, cfg)
    if dev.type != "cuda":
        raise ValueError(f"project_splats runs on CPU or CUDA tensors, "
                         f"not {dev}")
    if cfg.conic_mode not in ("standard", "reference"):
        raise ValueError(f"unknown conic_mode {cfg.conic_mode!r}")
    n, k = cloud.n, cloud.sh.shape[1]
    degree = min(cfg.sh_degree, cloud.sh_degree)
    means = _f32(cloud.means, "means", dev)
    cov = _f32(cloud.cov3d, "cov3d", dev)
    opacity = _f32(cloud.opacity, "opacity", dev)
    sh = _f32(cloud.sh, "sh", dev)
    if sh.data_ptr() % 16:
        sh = sh.clone()     # the kernel stages SH rows in 16-byte copies
    if means.shape != (n, 3) or cov.shape != (n, 6) or \
            opacity.shape != (n,) or sh.shape != (n, k, 3):
        raise ValueError(
            f"project_splats: shapes means {tuple(means.shape)}, cov3d "
            f"{tuple(cov.shape)}, opacity {tuple(opacity.shape)}, sh "
            f"{tuple(sh.shape)}")
    view = _f32(camera.view, "camera.view", dev)
    intr = [_f32(getattr(camera, a), f"camera.{a}", dev)
            for a in ("fx", "fy", "cx", "cy")]
    pos = camera.position.contiguous()
    out = torch.empty((11, n), dtype=torch.float32, device=dev)
    alive = torch.empty(n, dtype=torch.bool, device=dev)
    f32 = np.float32
    with torch.cuda.device(dev):
        _kernels.PROJECT(
            means.data_ptr(), cov.data_ptr(), opacity.data_ptr(),
            sh.data_ptr(), n, k, degree, int(cfg.conic_mode == "standard"),
            view.data_ptr(), *(t.data_ptr() for t in intr), pos.data_ptr(),
            f32(cfg.cov2d_dilation), f32(cfg.g_cutoff),
            f32(cfg.alpha_threshold),
            # PyTorch divides a CUDA tensor by a host scalar as the product
            # with the scalar's reciprocal, taken in double and rounded
            f32(1.0 / cfg.alpha_threshold), f32(cfg.t_min),
            f32(min(cfg.t_max, cfg.init_depth)), out.data_ptr(),
            alive.data_ptr(), _kernels.stream_ptr(means))
    return SplatColumns(*out.unbind(0), alive)
