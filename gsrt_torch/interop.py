"""Weight carry-over: build the port's objects (clouds, cameras, training
parameters, optimiser state, densification statistics, path-tracer
scenes, clustered splats) from the JAX package's arrays, handed over as NumPy.

The JAX package's cloud and camera hold device arrays; `np.asarray` turns
each field into NumPy, and these functions put the same bits on the
port's device. Tests use them so both packages see bit-identical inputs,
Σ included (the two packages may round `quat_scale_to_cov3d` differently
in the last place).
"""

from __future__ import annotations

import numpy as np
import torch

from gsrt_torch.core.types import (Camera, GaussianCloud, Materials,
                                   resolve_device)
from gsrt_torch.models.densify import DensifyStats
from gsrt_torch.models.path_tracer import PrimitiveScene
from gsrt_torch.models.trainer import GaussianParams


def _f32(a, device) -> torch.Tensor:
    return torch.as_tensor(np.array(a, dtype=np.float32), device=device)


def cloud_from_numpy(means, cov3d, opacity, sh, device=None
                     ) -> GaussianCloud:
    """means [N, 3], cov3d [N, 6], opacity [N], sh [N, K, 3] → cloud."""
    dev = resolve_device(device)
    return GaussianCloud(means=_f32(means, dev), cov3d=_f32(cov3d, dev),
                         opacity=_f32(opacity, dev), sh=_f32(sh, dev))


def camera_from_numpy(view, fx, fy, cx, cy, width: int, height: int,
                      device=None) -> Camera:
    """view [4, 4] world→camera and f32 intrinsics → camera."""
    dev = resolve_device(device)
    return Camera(view=_f32(view, dev), fx=_f32(fx, dev), fy=_f32(fy, dev),
                  cx=_f32(cx, dev), cy=_f32(cy, dev), width=int(width),
                  height=int(height))


def scene_from_numpy(fields: dict, device=None) -> PrimitiveScene:
    """A primitive scene from the JAX package's `PrimitiveScene` arrays as
    NumPy: `fields` maps the scene's field names (sph_center, ..., tri_mat,
    and any of tri_uv0/1/2) to arrays and "materials" to a dict of the
    Materials fields. Integer fields stay int32, the rest become f32, so
    both packages trace bit-identical geometry. Every field passes through:
    textures, cutout masks, mip pyramids and texel densities, cylinders
    and Mandelbulbs."""
    dev = resolve_device(device)

    def conv(a):
        if a is None:
            return None
        a = np.asarray(a)
        dtype = np.int32 if np.issubdtype(a.dtype, np.integer) \
            else np.float32
        return torch.as_tensor(np.array(a, dtype=dtype), device=dev)
    mats = Materials(**{k: conv(v) for k, v in fields["materials"].items()})
    return PrimitiveScene(materials=mats, **{
        k: conv(v) for k, v in fields.items() if k != "materials"})


def splat_clusters_from_numpy(cl_min, cl_max, sup_min, sup_max, valid,
                              sup: int, means, cov_inv, opacity, colors,
                              device=None):
    """Clustered splats (`ops.splat_clusters.SplatClusters`) from the JAX
    package's `SplatClusters` arrays as NumPy: the cluster and
    super-cluster boxes, the [M, K] slot mask, `sup`, and the [M, K, ...]
    means, Σ⁻¹, opacity and colours. Carrying them over traces the very
    clusters the JAX package built (its Morton sort may order equal codes
    otherwise than the port's stable one)."""
    from gsrt_torch.ops.clusters import Clusters
    from gsrt_torch.ops.splat_clusters import SplatClusters
    dev = resolve_device(device)
    clusters = Clusters(
        cl_min=_f32(cl_min, dev), cl_max=_f32(cl_max, dev),
        sup_min=_f32(sup_min, dev), sup_max=_f32(sup_max, dev),
        valid=torch.as_tensor(np.array(valid, dtype=bool), device=dev),
        sup=int(sup))
    return SplatClusters(clusters=clusters, means=_f32(means, dev),
                         cov_inv=_f32(cov_inv, dev),
                         opacity=_f32(opacity, dev), colors=_f32(colors, dev))


def params_from_numpy(means, log_scales, quats, opacity_logit, sh,
                      device=None) -> GaussianParams:
    """The five trainable arrays (means [N, 3], log_scales [N, 3], quats
    [N, 4], opacity_logit [N], sh [N, K, 3]) → parameters on the device."""
    dev = resolve_device(device)
    return GaussianParams(*(_f32(a, dev) for a in (
        means, log_scales, quats, opacity_logit, sh)), device=dev)


def params_to_numpy(params: GaussianParams) -> tuple[np.ndarray, ...]:
    """(means, log_scales, quats, opacity_logit, sh) as NumPy arrays."""
    return tuple(p.detach().cpu().numpy() for p in (
        params.means, params.log_scales, params.quats, params.opacity_logit,
        params.sh))


def opt_state_from_numpy(optimizer: torch.optim.Optimizer, mu, nu,
                         count) -> None:
    """Set the Adam state of the optimizer's groups, in their order (that
    of `make_optimizer`: means, log_scales, quats, opacity_logit, sh), from
    NumPy: mu[g] and nu[g] the group's first and second moments and
    count[g] its step count, the fields of each group's
    `optax.ScaleByAdamState` in the JAX package's `make_optimizer()`
    state."""
    groups = optimizer.param_groups
    if not len(mu) == len(nu) == len(count) == len(groups):
        raise ValueError(f"one mu, nu and count per group ({len(groups)})")
    for group, m, v, c in zip(groups, mu, nu, count):
        (p,) = group["params"]
        if np.shape(m) != tuple(p.shape) or np.shape(v) != tuple(p.shape):
            raise ValueError(f"moments of shape {np.shape(m)} for a "
                             f"parameter of shape {tuple(p.shape)}")
        optimizer.state[p] = {
            "step": torch.tensor(float(c), dtype=torch.float32),
            "exp_avg": _f32(m, p.device), "exp_avg_sq": _f32(v, p.device)}


def opt_state_to_numpy(optimizer: torch.optim.Optimizer):
    """(mu, nu, count): per group, in order, the Adam moments as NumPy and
    the step count as an int (zeros and 0 before the first step)."""
    mu, nu, count = [], [], []
    for group in optimizer.param_groups:
        (p,) = group["params"]
        st = optimizer.state.get(p, {})
        zeros = np.zeros(tuple(p.shape), np.float32)
        mu.append(st["exp_avg"].cpu().numpy() if st else zeros)
        nu.append(st["exp_avg_sq"].cpu().numpy() if st else zeros.copy())
        count.append(int(st["step"]) if st else 0)
    return mu, nu, count


def stats_from_numpy(grad_accum, count, device=None) -> DensifyStats:
    """Densification statistics ([N] f32 gradient sums, [N] int32 counts)
    on the device."""
    dev = resolve_device(device)
    return DensifyStats(grad_accum=_f32(grad_accum, dev),
                        count=torch.as_tensor(np.array(count, np.int32),
                                              device=dev))


def stats_to_numpy(stats: DensifyStats) -> tuple[np.ndarray, np.ndarray]:
    """(grad_accum, count) as NumPy arrays."""
    return stats.grad_accum.cpu().numpy(), stats.count.cpu().numpy()
