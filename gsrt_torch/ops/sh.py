"""Real spherical-harmonics color, degrees 0–3 (counterpart of
`gsrt.ops.sh`, same basis constants and operation order)."""

from __future__ import annotations

import torch

C0 = 0.28209479177387814
C1 = 0.4886025119029199
C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
      -1.0925484305920792, 0.5462742152960396)
C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
      0.3731763325901154, -0.4570457994644658, 1.445305721320277,
      -0.5900435899266435)


def _sh_terms(coef, x, y, z, degree: int):
    """Σ basis·coefficient with coef(i) the i-th coefficient broadcast
    against the direction components; DC-centered (+0.5), clamped ≥ 0."""
    result = C0 * coef(0)
    if degree >= 1:
        result = (result
                  - C1 * y * coef(1)
                  + C1 * z * coef(2)
                  - C1 * x * coef(3))
    if degree >= 2:
        xx, yy, zz = x * x, y * y, z * z
        result = (result
                  + C2[0] * (x * y) * coef(4)
                  + C2[1] * (y * z) * coef(5)
                  + C2[2] * (2.0 * zz - xx - yy) * coef(6)
                  + C2[3] * (x * z) * coef(7)
                  + C2[4] * (xx - yy) * coef(8))
    if degree >= 3:
        result = (result
                  + C3[0] * y * (3.0 * xx - yy) * coef(9)
                  + C3[1] * (x * y) * z * coef(10)
                  + C3[2] * y * (4.0 * zz - xx - yy) * coef(11)
                  + C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy) * coef(12)
                  + C3[4] * x * (4.0 * zz - xx - yy) * coef(13)
                  + C3[5] * z * (xx - yy) * coef(14)
                  + C3[6] * x * (xx - 3.0 * yy) * coef(15))
    return torch.clamp_min(result + 0.5, 0.0)


def eval_sh(sh: torch.Tensor, dirs: torch.Tensor, degree: int
            ) -> torch.Tensor:
    """sh: [..., K, 3] with K ≥ (degree+1)²; dirs: [..., 3] normalized view
    directions. Returns [..., 3] RGB."""
    x, y, z = dirs[..., 0:1], dirs[..., 1:2], dirs[..., 2:3]
    return _sh_terms(lambda i: sh[..., i, :], x, y, z, degree)


def eval_sh_fm(shT: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
               z: torch.Tensor, degree: int):
    """Feature-row form: shT [K, 3, N], direction components [N]. Returns
    (r, g, b), each [N]."""
    return tuple(_sh_terms(lambda i: shT[i, ch], x, y, z, degree)
                 for ch in range(3))
