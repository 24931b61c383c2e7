"""The benchmark's own inputs, made from the seed: the splat cloud, the
orbit's cameras and the training targets.

These are frozen copies of the port's `scene.catalog.random_cloud_params`
(its distributions, drawn by `torch.Generator` on the device in a few
large calls) and `scene.campath.orbit_path` / `core.types.look_at` /
`make_camera` (the camera convention: world→camera [R|t], +z forward, y
down, fx = fy = ½·H / tan(fov/2) rounded to f32, principal point at the
image centre, pixel centres at integer coordinates). Later changes to the
port's scene code leave the yardstick alone. The port and the reference
are handed the same tensors.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class View:
    """One camera: world→camera [4, 4] float32 (NumPy) and intrinsics."""
    view: np.ndarray
    fx: float
    fy: float
    cx: float
    cy: float
    width: int
    height: int

    @property
    def position(self) -> np.ndarray:
        R, t = self.view[:3, :3].astype(np.float64), self.view[:3, 3]
        return -(R.T @ t)


@dataclass
class Cloud:
    """Splat parameters as a splat file stores them, on one device."""
    means: torch.Tensor       # [N, 3]
    quats: torch.Tensor       # [N, 4] (w, x, y, z), not normalised
    scales: torch.Tensor      # [N, 3]
    opacity: torch.Tensor     # [N]
    sh: torch.Tensor          # [N, K, 3]

    @property
    def n(self) -> int:
        return self.means.shape[0]


def generator(seed: int, device) -> torch.Generator:
    """A generator on `device` seeded from any whole number (run seeds
    may exceed 32 bits)."""
    return torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))


def random_cloud(n: int, seed: int, device, extent: float = 4.0,
                 scale_range=(0.004, 0.03), opacity_range=(0.2, 0.95),
                 sh_degree: int = 3, scene_seed: int | None = None) -> Cloud:
    """`random_cloud_params`' distributions: centres uniform in a cube of
    half-side `extent` pushed 1.5·extent forward, normal quaternions,
    uniform scales and opacities, SH normal(0, 0.3) with a uniform DC term
    in [-1.5, 1.5].

    With `scene_seed`, the shapes (centres, rotations, scales,
    opacities), which alone decide the work (pairs, saturation, the
    serving cull), come from it and are the same for every `seed`; the
    seed draws the colours and the order the splats are stored in."""
    g = generator(seed if scene_seed is None else scene_seed, device)
    u = lambda *shape: torch.rand(shape, generator=g, device=device)
    means = (u(n, 3) * 2.0 - 1.0) * extent
    means[:, 2] += extent * 1.5
    quats = torch.randn((n, 4), generator=g, device=device)
    lo, hi = scale_range
    scales = lo + (hi - lo) * u(n, 3)
    olo, ohi = opacity_range
    opacity = olo + (ohi - olo) * u(n)
    if scene_seed is not None:
        g = generator(seed, device)
        perm = torch.randperm(n, generator=g, device=device)
        means, quats, scales, opacity = (t[perm] for t in
                                         (means, quats, scales, opacity))
    u = lambda *shape: torch.rand(shape, generator=g, device=device)
    K = (sh_degree + 1) ** 2
    sh = 0.3 * torch.randn((n, K, 3), generator=g, device=device)
    sh[:, 0, :] = u(n, 3) * 3.0 - 1.5
    return Cloud(means, quats, scales, opacity, sh)


def cov3d(quats: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """Σ = R·S²·Rᵀ as [N, 6] upper-triangular (xx, xy, xz, yy, yz, zz)."""
    q = quats / torch.sqrt((quats * quats).sum(-1, keepdim=True))
    w, x, y, z = q.unbind(-1)
    R = torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], -1).reshape(-1, 3, 3)
    s2 = scales * scales
    M = R * s2[:, None, :]                       # R·S²
    S = (M[:, :, None, :] * R[:, None, :, :]).sum(-1)   # (R·S²)·Rᵀ
    return torch.stack([S[:, 0, 0], S[:, 0, 1], S[:, 0, 2], S[:, 1, 1],
                        S[:, 1, 2], S[:, 2, 2]], -1)


def look_at(eye, target, up=(0.0, 1.0, 0.0)) -> np.ndarray:
    eye, target, up = (np.asarray(v, np.float64) for v in (eye, target, up))
    fwd = target - eye
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(fwd, up)
    right = right / np.linalg.norm(right)
    down = np.cross(fwd, right)
    R = np.stack([right, down, fwd], 0)
    view = np.eye(4)
    view[:3, :3] = R
    view[:3, 3] = -R @ eye
    return view.astype(np.float32)


def orbit(target, radius: float, angles_deg, *, height: float,
          fov_y_deg: float, width: int, height_px: int) -> list[View]:
    """Cameras on a circle round `target` at the given angles (degrees),
    the eye `height` above the target's plane, all looking at it."""
    target = np.asarray(target, np.float64)
    f = float(np.float32(0.5 * height_px / np.tan(np.radians(fov_y_deg)
                                                  * 0.5)))
    cams = []
    for deg in angles_deg:
        a = math.radians(deg)
        eye = target + np.array([radius * math.cos(a), height,
                                 radius * math.sin(a)])
        cams.append(View(look_at(eye, target), f, f,
                         float(np.float32(width * 0.5)),
                         float(np.float32(height_px * 0.5)), width,
                         height_px))
    return cams


def orbit_from_mix(orbit_spec: dict, angles_deg, width: int,
                   height: int) -> list[View]:
    return orbit(orbit_spec["target"], orbit_spec["radius"], angles_deg,
                 height=orbit_spec["eye_height"],
                 fov_y_deg=orbit_spec["fov_deg"], width=width,
                 height_px=height)


def lowfreq_targets(n: int, width: int, height: int, grid, seed: int,
                    device) -> torch.Tensor:
    """n seeded low-frequency images [n, H, W, 3] in [0, 1]: a random
    grid of colours bilinearly upsampled."""
    g = generator(seed + 1, device)
    gh, gw = grid
    coarse = torch.rand((n, 3, gh, gw), generator=g, device=device)
    img = torch.nn.functional.interpolate(coarse, size=(height, width),
                                          mode="bilinear",
                                          align_corners=True)
    return img.permute(0, 2, 3, 1).contiguous()


def seeded_rng(seed: int) -> np.random.Generator:
    return np.random.default_rng(int(seed))
