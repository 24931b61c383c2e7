"""Scene factories (counterpart of `gsrt.scene.catalog`).

`random_cloud` makes the same NumPy RNG calls in the same order as the JAX
package, so both draw identical centers, quaternions, scales, opacities
and SH coefficients from one seed; Σ is then built on the chosen device.
"""

from __future__ import annotations

import numpy as np
import torch

from gsrt_torch.core.types import (GaussianCloud, look_at, make_camera,
                                   resolve_device)
from gsrt_torch.ops.gaussian import quat_scale_to_cov3d
from gsrt_torch.ops.sh import C0


def _cloud_from_params(centers, quats, scales, opacities, rgb, device
                       ) -> GaussianCloud:
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    centers, quats, scales = f32(centers), f32(quats), f32(scales)
    rgb = f32(rgb)
    # DC coefficient such that degree-0 SH reproduces rgb: rgb = C0·sh0 + 0.5
    sh = ((rgb - 0.5) / C0)[:, None, :]
    return GaussianCloud(means=centers, cov3d=quat_scale_to_cov3d(quats,
                                                                  scales),
                         opacity=f32(opacities), sh=sh)


def demo_gauss_splat(width: int = 16, height: int = 16, device=None):
    """The reference's "3DGS" demo: two isotropic Gaussians at z = 5 and 3
    (scales 1 and 2, opacity 0.9) seen from (0, 0, 2) with a 90° FOV."""
    dev = resolve_device(device)
    cloud = _cloud_from_params(
        centers=[[0.0, 0.0, 5.0], [0.0, 0.0, 3.0]],
        quats=[[1.0, 0, 0, 0], [1.0, 0, 0, 0]],
        scales=[[1.0, 1, 1], [2.0, 2, 2]],
        opacities=[0.9, 0.9],
        rgb=[[0.9, 0.3, 0.2], [0.2, 0.4, 0.9]], device=dev)
    view = look_at(eye=(0, 0, 2.0), target=(0, 0, 5.0))
    camera = make_camera(view, fov_y_deg=90.0, width=width, height=height,
                         device=dev)
    return cloud, camera


def random_cloud_params(n: int, seed: int = 0, extent: float = 4.0,
                        scale_range=(0.02, 0.25), sh_degree: int = 3):
    """random_cloud's NumPy draws: (centres [n, 3], quats [n, 4], scales
    [n, 3], opacities [n], SH [n, K, 3]), as a splat file stores them."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-extent, extent, (n, 3)).astype(np.float32)
    centers[:, 2] += extent * 1.5  # keep in front of the camera
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    scales = rng.uniform(*scale_range, (n, 3)).astype(np.float32)
    opac = rng.uniform(0.2, 0.95, n).astype(np.float32)
    K = (sh_degree + 1) ** 2
    sh = rng.normal(0.0, 0.3, (n, K, 3)).astype(np.float32)
    sh[:, 0, :] = rng.uniform(-1.5, 1.5, (n, 3))
    return centers, quats, scales, opac, sh


def random_cloud(n: int, seed: int = 0, extent: float = 4.0,
                 scale_range=(0.02, 0.25), sh_degree: int = 3,
                 width: int = 800, height: int = 600, device=None):
    """Synthetic Gaussian cloud in front of a 60° camera — the benchmark
    workload (1M splats, scale_range (0.004, 0.03), 1920×1080)."""
    dev = resolve_device(device)
    centers, quats, scales, opac, sh = random_cloud_params(
        n, seed, extent, scale_range, sh_degree)
    t = lambda a: torch.as_tensor(a, device=dev)
    cloud = GaussianCloud(means=t(centers),
                          cov3d=quat_scale_to_cov3d(t(quats), t(scales)),
                          opacity=t(opac), sh=t(sh))
    view = look_at(eye=(0, 0, -1.0), target=(0, 0, extent))
    camera = make_camera(view, fov_y_deg=60.0, width=width, height=height,
                         device=dev)
    return cloud, camera
