"""Progressive sample accumulation across frames (counterpart of
`gsrt.utils.accumulate`).

The reference accumulates samples in an AccumulationImage across frames
(RayTracing.rgen:87-95: running sum ÷ TotalNumberOfSamples, camera motion
resets). Same contract here, on the host in float64: feed per-frame
linear images (arrays or tensors), read the gamma-corrected running
average any time.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from gsrt_torch.utils.image import as_numpy


class ProgressiveAccumulator:
    def __init__(self, gamma_correction: bool = True):
        self.gamma = gamma_correction
        self._sum: Optional[np.ndarray] = None
        self._samples = 0

    def reset(self) -> None:
        """Camera moved / scene changed (RayTracer resetAccumulation_)."""
        self._sum = None
        self._samples = 0

    def add(self, linear_image, samples: int = 1) -> None:
        img = np.asarray(as_numpy(linear_image), np.float64)
        if self._sum is None:
            self._sum = np.zeros_like(img)
        self._sum = self._sum + img * samples
        self._samples += samples

    @property
    def total_samples(self) -> int:
        return self._samples

    @property
    def image(self) -> np.ndarray:
        if self._samples <= 0:
            raise ValueError("no samples accumulated")
        out = (self._sum / self._samples).astype(np.float32)
        if self.gamma:  # sqrt gamma, RayTracing.rgen:93
            out = np.sqrt(np.clip(out, 0.0, 1.0))
        return out
