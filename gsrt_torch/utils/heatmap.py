"""Per-pixel cost heatmaps (counterpart of `gsrt.utils.heatmap`).

The reference visualizes per-pixel shader clocks with a 10-stop
Turbo-style colormap (assets/shaders/Heatmap.glsl:3-32, toggled at
RayTracer.cpp:215). Here the cost signals are renderer-native: splats
blended per pixel (`hits`) or k-buffer passes (`passes`). The map is
computed in NumPy float32, as `gsrt` computes it, so both give the same
bits.
"""

from __future__ import annotations

import numpy as np

from gsrt_torch.utils.image import as_numpy

# the reference's 10-stop colormap (Heatmap.glsl:5-16 values)
_STOPS = np.array([
    [0.0, 0.0, 0.0],
    [0.0, 0.0, 1.0],
    [0.0, 1.0, 1.0],
    [0.0, 1.0, 0.0],
    [1.0, 1.0, 0.0],
    [1.0, 0.0, 0.0],
    [1.0, 0.0, 1.0],
    [1.0, 1.0, 1.0],
    [1.0, 1.0, 1.0],
    [1.0, 1.0, 1.0],
], np.float32)


def heatmap(values, scale: float | None = None) -> np.ndarray:
    """[H,W] scalar cost (array or tensor) → [H,W,3] colormapped image."""
    v = np.asarray(as_numpy(values), np.float32)
    if scale is None:
        scale = max(float(v.max()), 1e-9)
    t = np.clip(v / scale, 0.0, 1.0) * (len(_STOPS) - 1)
    i = np.clip(t.astype(np.int32), 0, len(_STOPS) - 2)
    f = (t - i)[..., None]
    return _STOPS[i] * (1 - f) + _STOPS[i + 1] * f
