"""Core types of the port: the splat cloud, the path tracer's material
table, the pinhole camera, and the device rule every entry point follows.

Counterpart of `gsrt.core.types`. The cloud stays a struct of arrays with
the JAX package's layouts ([N, 3] means, [N, 6] upper-triangular Σ, [N]
opacity, [N, K, 3] SH), so tests compare like with like.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another. Raises when CUDA is asked for (or defaulted to) and absent —
    a measurement or render never falls back to the CPU silently."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "gsrt_torch runs on CUDA by default and no CUDA device is "
            "available; pass device='cpu' to run the plain PyTorch path")
    return dev


class GaussianCloud(NamedTuple):
    means: torch.Tensor      # [N, 3] world-space centers
    cov3d: torch.Tensor      # [N, 6] upper-triangular Σ (xx, xy, xz, yy, yz, zz)
    opacity: torch.Tensor    # [N]
    sh: torch.Tensor         # [N, K, 3] real SH coefficients

    @property
    def n(self) -> int:
        return self.means.shape[0]

    @property
    def sh_degree(self) -> int:
        return int(round(self.sh.shape[1] ** 0.5)) - 1

    @property
    def device(self) -> torch.device:
        return self.means.device

    def to(self, device) -> "GaussianCloud":
        return GaussianCloud(*(t.to(device) for t in self))


class Materials(NamedTuple):
    """Material table of the path tracer, `gsrt.core.types.Materials`'s
    fields and model constants: model ∈ {0 lambertian, 1 metallic,
    2 dielectric, 3 isotropic, 4 diffuse_light}; texture_id ≥ 0 indexes a
    texture atlas (-1 = untextured)."""

    model: torch.Tensor              # [M] int32
    diffuse: torch.Tensor            # [M, 3]
    fuzziness: torch.Tensor          # [M]
    refraction_index: torch.Tensor   # [M]
    texture_id: torch.Tensor | None = None  # [M] int32

    LAMBERTIAN = 0
    METALLIC = 1
    DIELECTRIC = 2
    ISOTROPIC = 3
    DIFFUSE_LIGHT = 4


@dataclasses.dataclass(frozen=True)
class Camera:
    """Pinhole camera. view: [4, 4] world→camera, camera looks down +z,
    x right, y down; px = fx·x/z + cx. fx, fy, cx, cy are 0-d float32
    tensors on the camera's device."""

    view: torch.Tensor
    fx: torch.Tensor
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor
    width: int
    height: int

    @property
    def position(self) -> torch.Tensor:
        # inverse of [R|t]: origin = -Rᵀ t
        R = self.view[:3, :3]
        t = self.view[:3, 3]
        return -(R.T @ t)

    @property
    def device(self) -> torch.device:
        return self.view.device

    def to(self, device) -> "Camera":
        return dataclasses.replace(
            self, view=self.view.to(device), fx=self.fx.to(device),
            fy=self.fy.to(device), cx=self.cx.to(device),
            cy=self.cy.to(device))


def make_camera(view: np.ndarray, fov_y_deg: float, width: int, height: int,
                device=None) -> Camera:
    """Camera from a world→camera matrix and vertical FOV, with the JAX
    package's intrinsics: fy = fx = 0.5·H / tan(fov/2) (rounded to f32),
    principal point at the image center."""
    dev = resolve_device(device)
    f = 0.5 * height / np.tan(np.radians(fov_y_deg) * 0.5)
    f32 = lambda v: torch.tensor(np.float32(v), device=dev)
    return Camera(view=torch.as_tensor(np.asarray(view, np.float32),
                                       device=dev),
                  fx=f32(f), fy=f32(f), cx=f32(width * 0.5),
                  cy=f32(height * 0.5), width=width, height=height)


def look_at(eye, target, up=(0.0, 1.0, 0.0)) -> np.ndarray:
    """world→camera matrix, +z forward / y down (image convention)."""
    eye = np.asarray(eye, np.float64)
    target = np.asarray(target, np.float64)
    up = np.asarray(up, np.float64)
    fwd = target - eye
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(fwd, up)
    n = np.linalg.norm(right)
    if n < 1e-8:
        # view parallel to up: take an axis not parallel to fwd
        alt = np.array([0.0, 0.0, 1.0]) if abs(fwd[2]) < 0.9 \
            else np.array([1.0, 0.0, 0.0])
        right = np.cross(fwd, alt)
        n = np.linalg.norm(right)
    right = right / n
    down = np.cross(fwd, right)  # y axis points down in image space
    R = np.stack([right, down, fwd], axis=0)
    view = np.eye(4)
    view[:3, :3] = R
    view[:3, 3] = -R @ eye
    return view.astype(np.float32)
