"""Render configuration: the port's own copy of `gsrt.core.config`.

The fields, names and defaults are those of the JAX package, so one
`RenderConfig(...)` call means the same render in both. The reference's
numeric thresholds (k = 8, g ∈ [0, 5.6], alpha > 1/255, the 256-segment exp
LUT on [0, 8], tMin/tMax = 1e-3/1e4) are kept exactly so parity tests are
bit-meaningful. The option comments of the JAX file record why each
default was chosen there; only what each option selects is repeated here.
"""

from __future__ import annotations

import dataclasses
from typing import Literal


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    # --- image / launch ---
    width: int = 128
    height: int = 128
    samples: int = 1
    bounces: int = 16
    shadow_rays: int = 2
    ao_rays: int = 4

    # --- 3DGS splatting ---
    k: int = 8                # per-ray k-nearest hit buffer depth
    g_cutoff: float = 5.6     # reject splats with 0.5*d'Σ⁻¹d outside [0, g_cutoff]
    alpha_threshold: float = 1.0 / 255.0
    max_passes: int = 64
    use_exp_lut: bool = False # True → 256-segment piecewise-linear exp(-x)
    conic_mode: Literal["reference", "standard"] = "standard"
    cov2d_dilation: float = 0.0
    sh_degree: int = 3
    white_background: bool = False

    # --- ray march bounds ---
    t_min: float = 1e-3
    t_max: float = 1e4
    init_depth: float = 1e4

    # --- tiling (the tiled path) ---
    tile_w: int = 32
    tile_h: int = 16
    pair_chunk: int = 384     # pairs per blend chunk in the JAX kernel; the
                              # port's group-stream blend reads tile_w*tile_h
                              # pairs per batch and ignores it
    expand_impl: Literal["pallas", "xla", "fused", "binned"] = "fused"
    blend_impl: Literal["packed", "subtile"] = "packed"
    blend_bs: int = 128
    splat_chunk: int = 256    # splats per chunk in render_fast
    exact_hits: bool = False
    scan_impl: Literal["roll", "logmm"] = "logmm"
    blend_math: Literal["f32", "bf16"] = "bf16"
                              # ignored by the port: its blend computes in
                              # f32 in either tier (the JAX kernel's bf16
                              # tier is a TPU vector-unit trade)
    payload: Literal["f32", "compact"] = "compact"
    stream: Literal["tile", "group"] = "group"
    span_mode: Literal["rect", "ellipse"] = "rect"
    serving_super: int = 8

    # --- BVH ---
    bvh_branching: int = 8
    bvh_leaf_size: int = 4
    traversal_stack_depth: int = 64

    # --- path tracing ---
    has_sky: bool = True
    gamma_correction: bool = True

    # --- numerics ---
    dtype: str = "float32"

    @property
    def num_pixels(self) -> int:
        return self.width * self.height

    @property
    def sh_coeffs(self) -> int:
        return (self.sh_degree + 1) ** 2

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)


# Reference demo configuration: 16x16 launch, 2 hardcoded gaussians.
REFERENCE_DEMO = RenderConfig(
    width=16, height=16, samples=1, bounces=4, k=8,
    use_exp_lut=True, conic_mode="reference", gamma_correction=False,
)
