"""Gaussian math: 3D covariance construction and EWA screen projection.

Counterpart of `gsrt.ops.gaussian`, written as elementwise tensor code in
the JAX package's operation order so both round alike:

  * quaternion + scale → Σ = R·S²·Rᵀ, stored upper-triangular;
  * camera-space depth, pixel projection, the Jacobian J of the
    perspective map and Cov2D = (J·W)·Σ·(J·W)ᵀ;
  * the response g = ½·dᵀQd with Q the conic (inverse Cov2D) in
    "standard" mode or Cov2D itself in "reference" mode.

`project_gaussians` takes [N, 3]/[N, 6] rows and `project_gaussians_fm`
[3, N]/[6, N] feature rows; both run the same column math
(`_project_columns`), since a GPU needs no feature-major relayout.
"""

from __future__ import annotations

import torch

from gsrt_torch.core.types import Camera


def quat_scale_to_cov3d(quat: torch.Tensor, scale: torch.Tensor
                        ) -> torch.Tensor:
    """[N, 4] (w, x, y, z) quaternions + [N, 3] scales → [N, 6] upper-tri Σ."""
    q = quat / torch.linalg.norm(quat, dim=-1, keepdim=True)
    r, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r00 = 1 - 2 * (y * y + z * z); r01 = 2 * (x * y - r * z); r02 = 2 * (x * z + r * y)  # noqa: E702
    r10 = 2 * (x * y + r * z); r11 = 1 - 2 * (x * x + z * z); r12 = 2 * (y * z - r * x)  # noqa: E702
    r20 = 2 * (x * z - r * y); r21 = 2 * (y * z + r * x); r22 = 1 - 2 * (x * x + y * y)  # noqa: E702
    s2 = scale * scale
    s0, s1, s2 = s2[..., 0], s2[..., 1], s2[..., 2]

    def entry(a0, a1, a2, b0, b1, b2):
        return a0 * s0 * b0 + a1 * s1 * b1 + a2 * s2 * b2

    return torch.stack([
        entry(r00, r01, r02, r00, r01, r02),  # xx
        entry(r00, r01, r02, r10, r11, r12),  # xy
        entry(r00, r01, r02, r20, r21, r22),  # xz
        entry(r10, r11, r12, r10, r11, r12),  # yy
        entry(r10, r11, r12, r20, r21, r22),  # yz
        entry(r20, r21, r22, r20, r21, r22),  # zz
    ], dim=-1)


def _project_columns(mx, my, mz, cov, camera: Camera, conic_mode: str,
                     cov2d_dilation: float):
    """Per-splat projection on [N] columns; cov is a sequence of the six
    upper-triangular Σ columns. Returns (depth, m2x, m2y, a, b, c, det,
    in_front) with (a, b, c) the raw Cov2D entries."""
    R = camera.view[:3, :3]
    t = camera.view[:3, 3]
    px = R[0, 0] * mx + R[0, 1] * my + R[0, 2] * mz + t[0]
    py = R[1, 0] * mx + R[1, 1] * my + R[1, 2] * mz + t[1]
    pz = R[2, 0] * mx + R[2, 1] * my + R[2, 2] * mz + t[2]
    depth = pz
    in_front = depth > 1e-4
    z = torch.where(in_front, depth, torch.ones_like(depth))
    inv_z = 1.0 / z
    m2x = camera.fx * px * inv_z + camera.cx
    m2y = camera.fy * py * inv_z + camera.cy

    j00 = camera.fx * inv_z
    j02 = -camera.fx * px * inv_z * inv_z
    j11 = camera.fy * inv_z
    j12 = -camera.fy * py * inv_z * inv_z
    t00 = j00 * R[0, 0] + j02 * R[2, 0]
    t01 = j00 * R[0, 1] + j02 * R[2, 1]
    t02 = j00 * R[0, 2] + j02 * R[2, 2]
    t10 = j11 * R[1, 0] + j12 * R[2, 0]
    t11 = j11 * R[1, 1] + j12 * R[2, 1]
    t12 = j11 * R[1, 2] + j12 * R[2, 2]

    c0, c1, c2, c3, c4, c5 = cov
    u0 = c0 * t00 + c1 * t01 + c2 * t02
    u1 = c1 * t00 + c3 * t01 + c4 * t02
    u2 = c2 * t00 + c4 * t01 + c5 * t02
    v0 = c0 * t10 + c1 * t11 + c2 * t12
    v1 = c1 * t10 + c3 * t11 + c4 * t12
    v2 = c2 * t10 + c4 * t11 + c5 * t12

    a = t00 * u0 + t01 * u1 + t02 * u2 + cov2d_dilation
    b = t10 * u0 + t11 * u1 + t12 * u2
    c = t10 * v0 + t11 * v1 + t12 * v2 + cov2d_dilation
    det = a * c - b * b
    if conic_mode not in ("standard", "reference"):
        raise ValueError(f"unknown conic_mode {conic_mode!r}")
    return depth, m2x, m2y, a, b, c, det, in_front


def _conic(a, b, c, det, in_front, conic_mode: str):
    """(a, b, c) of the quadratic form: the inverse Cov2D in standard mode
    (degenerate splats zeroed and dropped from in_front), Cov2D itself in
    reference mode."""
    if conic_mode == "reference":
        return a, b, c, in_front
    ok = det > 1e-12
    inv_det = torch.where(ok, 1.0 / torch.clamp_min(det, 1e-12),
                          torch.zeros_like(det))
    return c * inv_det, -b * inv_det, a * inv_det, in_front & ok


def project_gaussians(means: torch.Tensor, cov3d: torch.Tensor,
                      camera: Camera, conic_mode: str = "standard",
                      cov2d_dilation: float = 0.0):
    """Returns (depth [N], mean2d [N, 2], quad [N, 3], det [N],
    in_front [N] bool) as `gsrt.ops.gaussian.project_gaussians`."""
    depth, m2x, m2y, a, b, c, det, in_front = _project_columns(
        means[:, 0], means[:, 1], means[:, 2],
        [cov3d[:, i] for i in range(6)], camera, conic_mode, cov2d_dilation)
    qa, qb, qc, in_front = _conic(a, b, c, det, in_front, conic_mode)
    return (depth, torch.stack([m2x, m2y], -1),
            torch.stack([qa, qb, qc], -1), det, in_front)


def project_gaussians_fm(meansT: torch.Tensor, cov3dT: torch.Tensor,
                         camera: Camera, conic_mode: str = "standard",
                         cov2d_dilation: float = 0.0):
    """Feature-row form: meansT [3, N], cov3dT [6, N]. Returns (depth, m2x,
    m2y, qa, qb, qc, det, in_front), all [N]."""
    depth, m2x, m2y, a, b, c, det, in_front = _project_columns(
        meansT[0], meansT[1], meansT[2], [cov3dT[i] for i in range(6)],
        camera, conic_mode, cov2d_dilation)
    qa, qb, qc, in_front = _conic(a, b, c, det, in_front, conic_mode)
    return depth, m2x, m2y, qa, qb, qc, det, in_front


def screen_extents_abc(a, b, c, conic_mode: str, g_cutoff: float,
                       opacity: torch.Tensor | None = None,
                       alpha_threshold: float = 1.0 / 255.0):
    """Half-extents (rx, ry) of the visible ellipse's bounding box from the
    quadratic-form columns. With `opacity`, the cutoff G shrinks to where
    alpha = opacity·e⁻ᵍ crosses the alpha threshold. conic_mode is kept
    for signature parity: the formula reads whichever (a, b, c) arrive."""
    det = torch.clamp_min(a * c - b * b, 1e-18)
    g = torch.full_like(a, g_cutoff)
    if opacity is not None:
        g_alpha = torch.log(torch.clamp_min(opacity / alpha_threshold, 1e-6))
        g = torch.minimum(g, torch.clamp_min(g_alpha, 0.0))
    rx = torch.sqrt(torch.clamp_min(2.0 * g * c / det, 0.0))
    ry = torch.sqrt(torch.clamp_min(2.0 * g * a / det, 0.0))
    return rx, ry


def screen_extents(quad: torch.Tensor, conic_mode: str, g_cutoff: float,
                   opacity: torch.Tensor | None = None,
                   alpha_threshold: float = 1.0 / 255.0):
    """`screen_extents_abc` on a [N, 3] quad."""
    return screen_extents_abc(quad[..., 0], quad[..., 1], quad[..., 2],
                              conic_mode, g_cutoff, opacity=opacity,
                              alpha_threshold=alpha_threshold)


def eval_gaussian_response(pix: torch.Tensor, mean2d: torch.Tensor,
                           quad: torch.Tensor) -> torch.Tensor:
    """g = ½(a·dx² + 2b·dx·dy + c·dy²)."""
    d = pix - mean2d
    dx, dy = d[..., 0], d[..., 1]
    a, b, c = quad[..., 0], quad[..., 1], quad[..., 2]
    return 0.5 * (a * dx * dx + 2.0 * b * dx * dy + c * dy * dy)


def invert_cov3d(cov3d: torch.Tensor, eps: float = 1e-30) -> torch.Tensor:
    """[..., 6] upper-triangular Σ → [..., 6] upper-triangular Σ⁻¹
    (closed-form adjugate)."""
    a, b, c, d, e, f = (cov3d[..., i] for i in range(6))
    A = d * f - e * e
    B = c * e - b * f
    C = b * e - c * d
    det = a * A + b * B + c * C
    inv_det = 1.0 / torch.where(det.abs() > eps, det,
                                torch.full_like(det, eps))
    return torch.stack(
        [A * inv_det, B * inv_det, C * inv_det,
         (a * f - c * c) * inv_det, (b * c - a * e) * inv_det,
         (a * d - b * b) * inv_det], -1)


def ray_gaussian_response(orig, dirn, means, cov3d_inv):
    """Largest response of rays x(t) = o + t·d against 3D Gaussians, in ray
    space: valid for any ray, not only camera rays. q(t) = (x − μ)ᵀΣ⁻¹(x − μ)
    is smallest at t* = −(dᵀΣ⁻¹m)/(dᵀΣ⁻¹d) with m = o − μ. orig, dirn
    [..., R, 3], means [..., P, 3], cov3d_inv [..., P, 6] (leading batch
    dims broadcast). Returns (t_star [..., R, P], g_min = ½·q(t*)), g with
    the pixel-space response's meaning (alpha = opacity·exp(−g)). The
    symmetric mat-vecs are elementwise, in the JAX package's order (no
    batched matmul, which would round otherwise)."""
    ci = cov3d_inv[..., None, :, :]
    i0, i1, i2, i3, i4, i5 = (ci[..., i] for i in range(6))
    m = orig[..., :, None, :] - means[..., None, :, :]       # [..., R, P, 3]
    mx, my, mz = m[..., 0], m[..., 1], m[..., 2]
    dx = dirn[..., :, None, 0]
    dy = dirn[..., :, None, 1]
    dz = dirn[..., :, None, 2]
    sd_x = i0 * dx + i1 * dy + i2 * dz
    sd_y = i1 * dx + i3 * dy + i4 * dz
    sd_z = i2 * dx + i4 * dy + i5 * dz
    d_sd = dx * sd_x + dy * sd_y + dz * sd_z                 # dᵀΣ⁻¹d > 0
    m_sd = mx * sd_x + my * sd_y + mz * sd_z                 # mᵀΣ⁻¹d
    sm_x = i0 * mx + i1 * my + i2 * mz
    m_sm = mx * sm_x + my * (i1 * mx + i3 * my + i4 * mz) \
        + mz * (i2 * mx + i4 * my + i5 * mz)                 # mᵀΣ⁻¹m
    d_sd_safe = torch.clamp_min(d_sd, 1e-12)
    t_star = -m_sd / d_sd_safe
    q_min = m_sm - (m_sd * m_sd) / d_sd_safe
    return t_star, 0.5 * torch.clamp_min(q_min, 0.0)
