"""Morton (Z-order) codes (counterpart of `gsrt.ops.morton.morton3d`).

PyTorch has little uint32 arithmetic, so the bit spreading runs in int64
with explicit 32-bit masks; the codes equal the JAX package's bit for bit.
"""

from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF


def _expand_bits_3(v: torch.Tensor) -> torch.Tensor:
    """Spread the low 10 bits of v so they occupy every 3rd bit."""
    v = v.to(torch.int64)
    v = ((v * 0x00010001) & _M32) & 0xFF0000FF
    v = ((v * 0x00000101) & _M32) & 0x0F00F00F
    v = ((v * 0x00000011) & _M32) & 0xC30C30C3
    v = ((v * 0x00000005) & _M32) & 0x49249249
    return v


def morton3d(points: torch.Tensor, lo=None, hi=None) -> torch.Tensor:
    """30-bit 3D Morton codes (int64) of [N, 3] points normalised to
    [lo, hi] (their own bounds by default)."""
    if lo is None:
        lo = points.amin(0)
    if hi is None:
        hi = points.amax(0)
    lo = torch.as_tensor(lo, dtype=points.dtype, device=points.device)
    hi = torch.as_tensor(hi, dtype=points.dtype, device=points.device)
    scale = torch.where(hi > lo, 1023.0 / (hi - lo), torch.zeros_like(hi))
    q = torch.clamp((points - lo) * scale, 0.0, 1023.0).to(torch.int64)
    return ((_expand_bits_3(q[:, 0]) << 2) | (_expand_bits_3(q[:, 1]) << 1)
            | _expand_bits_3(q[:, 2]))
