"""Piecewise-linear exp(-x) lookup table: the reference's 256 segments on
[0, 8] (slope −e^{−x₀}, intercept e^{−x₀} at each segment's left edge).
Counterpart of `gsrt.ops.explut`; `render_fast` uses it under
`use_exp_lut=True`. `exp_neg_lut` is the form the blend kernels compute
(the JAX package's `splat_pallas._exp_neg_lut`): the same segments with
the entries computed rather than gathered, and no clamp at 0."""

from __future__ import annotations

import numpy as np
import torch

from gsrt_torch.core.types import resolve_device

SEGMENTS = 256
X_MIN = 0.0
X_MAX = 8.0


def build_exp_lut(segments: int = SEGMENTS, x_min: float = X_MIN,
                  x_max: float = X_MAX, device=None) -> torch.Tensor:
    """[segments, 2] float32 (slope, bias) per segment, on `device`
    (CUDA unless the caller asks for the CPU)."""
    step = (x_max - x_min) / segments
    x0 = x_min + np.arange(segments) * step
    tab = np.stack([-np.exp(-x0), np.exp(-x0)], axis=-1).astype(np.float32)
    return torch.as_tensor(tab, device=resolve_device(device))


def linear_exp(x: torch.Tensor, lut: torch.Tensor,
               x_max: float = X_MAX) -> torch.Tensor:
    """exp(-x) through the LUT with the shader's arithmetic:
    qx = floor(scale·x), ex = slope[qx]·(x − qx/scale) + bias[qx], with
    scale = segments/x_max; clamped at 0."""
    scale = torch.tensor(lut.shape[0] / x_max, dtype=x.dtype,
                         device=x.device)
    tx = x * scale
    qx = torch.clamp(tx.to(torch.int32), 0, lut.shape[0] - 1)
    dx = x - qx.to(x.dtype) / scale
    seg = lut[qx.long()]
    return torch.clamp_min(seg[..., 0] * dx + seg[..., 1], 0.0)


def lut_x0(x: torch.Tensor) -> torch.Tensor:
    """Left edge of x's segment: clamp(trunc(32·x), 0, 255) / 32."""
    qx = torch.clamp((x * 32.0).to(torch.int32), 0, 255)
    return qx.to(torch.float32) * (1.0 / 32.0)


def exp_neg_lut(x: torch.Tensor) -> torch.Tensor:
    """exp(-x) as the blend kernels take it under use_exp_lut:
    −e^{−x₀}·(x − x₀) + e^{−x₀}. Its derivative is −e^{−x₀}."""
    x0 = lut_x0(x)
    e0 = torch.exp(-x0)
    return (-e0) * (x - x0) + e0


def exp_neg(x: torch.Tensor, lut: torch.Tensor | None = None,
            use_lut: bool = False) -> torch.Tensor:
    """exp(-x): the LUT for parity, exact exp otherwise."""
    if use_lut:
        if lut is None:
            raise ValueError("use_lut=True needs a lut")
        return linear_exp(x, lut)
    return torch.exp(-x)
