"""Offline camera paths (counterpart of `gsrt.scene.campath`): the
headless form of an interactive viewer's orbit and fly controls, made up
front and rendered in sequence (the serving loop, `gsrt_torch.serving`).

Every generator returns a list of cameras sharing intrinsics, on `device`
(CUDA unless the caller asks for the CPU).
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np

from gsrt_torch.core.types import Camera, look_at, make_camera


def orbit_path(target, radius: float, n_frames: int, *,
               height: float = 0.0, fov_y_deg: float = 40.0,
               width: int = 1920, height_px: int = 1080,
               degrees: float = 360.0, start_deg: float = 0.0,
               up=(0.0, 1.0, 0.0), device=None) -> list[Camera]:
    """Circular orbit around `target` at `radius`, the eye `height` above
    the target's plane, swept uniformly over `degrees`. A full loop spaces
    frames without repeating the start; a partial arc reaches its end."""
    target = np.asarray(target, np.float64)
    full_loop = abs(abs(degrees) - 360.0) < 1e-9
    denom = n_frames if full_loop else max(n_frames - 1, 1)
    cams = []
    for i in range(n_frames):
        a = math.radians(start_deg + degrees * i / max(denom, 1))
        eye = target + np.array([radius * math.cos(a), height,
                                 radius * math.sin(a)])
        cams.append(make_camera(look_at(eye, target, up), fov_y_deg, width,
                                height_px, device=device))
    return cams


def dolly_path(eye_from, eye_to, target, n_frames: int, *,
               fov_y_deg: float = 40.0, width: int = 1920,
               height_px: int = 1080, up=(0.0, 1.0, 0.0),
               device=None) -> list[Camera]:
    """Linear fly from eye_from to eye_to, always looking at `target`."""
    eye_from = np.asarray(eye_from, np.float64)
    eye_to = np.asarray(eye_to, np.float64)
    cams = []
    for i in range(n_frames):
        s = i / max(n_frames - 1, 1)
        eye = eye_from * (1.0 - s) + eye_to * s
        cams.append(make_camera(look_at(eye, target, up), fov_y_deg, width,
                                height_px, device=device))
    return cams


def interpolate_path(keyframes: Sequence[Camera], frames_per_seg: int,
                     up=(0.0, 1.0, 0.0)) -> list[Camera]:
    """Piecewise-linear interpolation of eye positions between keyframe
    cameras, each frame looking along the blended forward direction.
    Keyframes share intrinsics, and `up` should be the one they were
    built with (frames take their roll from it). Frames are made on the
    first keyframe's device."""
    if len(keyframes) < 2:
        return list(keyframes)
    k0 = keyframes[0]
    fov = math.degrees(2.0 * math.atan(0.5 * k0.height / float(k0.fy)))
    host = lambda t: t.detach().cpu().numpy().astype(np.float64)
    cams = []
    for a, b in zip(keyframes[:-1], keyframes[1:]):
        pa, pb = host(a.position), host(b.position)
        # forward = camera-space +z in world: third row of the rotation
        fa, fb = host(a.view[2, :3]), host(b.view[2, :3])
        for i in range(frames_per_seg):
            s = i / frames_per_seg
            eye = pa * (1 - s) + pb * s
            fwd = fa * (1 - s) + fb * s
            n = np.linalg.norm(fwd)
            fwd = fwd / (n if n > 1e-9 else 1.0)
            cams.append(make_camera(look_at(eye, eye + fwd, up), fov,
                                    k0.width, k0.height, device=k0.device))
    cams.append(keyframes[-1])
    return cams
