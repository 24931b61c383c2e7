"""Sanitizers (counterpart of `gsrt.utils.debug`): NaN / Inf / range
guards over a cloud's and a framebuffer's arrays, with `gsrt`'s messages
for the same faults. The port's kernel sanitizer is each kernel's plain
PyTorch version, which the tests and `chip_smoke.py` hold it against."""

from __future__ import annotations

from typing import List

import numpy as np

from gsrt_torch.utils.image import as_numpy


def validate_cloud(cloud) -> List[str]:
    """Returns a list of problems (empty = clean)."""
    problems = []
    means = as_numpy(cloud.means)
    cov = as_numpy(cloud.cov3d)
    op = as_numpy(cloud.opacity)
    sh = as_numpy(cloud.sh)
    if not np.isfinite(means).all():
        problems.append("non-finite means")
    if not np.isfinite(cov).all():
        problems.append("non-finite cov3d")
    if not np.isfinite(sh).all():
        problems.append("non-finite SH coefficients")
    if (op < 0).any() or (op > 1).any():
        problems.append("opacity outside [0, 1]")
    # diagonal entries of Σ must be ≥ 0; det of each 2x2 principal minor too
    if (cov[:, [0, 3, 5]] < -1e-6).any():
        problems.append("negative covariance diagonal")
    det_xy = cov[:, 0] * cov[:, 3] - cov[:, 1] ** 2
    if (det_xy < -1e-4).any():
        problems.append("covariance not PSD (xy minor)")
    return problems


def validate_output(out) -> List[str]:
    problems = []
    trans = as_numpy(out.trans)
    color = as_numpy(out.color)
    if not np.isfinite(trans).all():
        problems.append("non-finite transmittance")
    if not np.isfinite(color).all():
        problems.append("non-finite color")
    if (trans < -1e-6).any() or (trans > 1 + 1e-5).any():
        problems.append("transmittance outside [0, 1]")
    if (color < -1e-5).any():
        problems.append("negative color")
    return problems
