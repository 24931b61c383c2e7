"""The least time of a ray-traced splat frame's tracing kernel
(`splat_trace_roofline`), from work that any structure must do, against
the published H100 SXM peaks of `roofline.py`:

* every hit a ray blends must be evaluated and blended once:
  HIT_FLOPS operations, counted from `reference/splat_rt.py`'s formula
  (the response 64: m = o − μ 3, Σ⁻¹d 15, dᵀΣ⁻¹d 5, mᵀΣ⁻¹d 5, Σ⁻¹m 15,
  mᵀΣ⁻¹m 5, the clamp 1, t* 2, q(t*) 3, g 2, alpha 4 with the exp counted
  as one, the four tests 4; the blend 9: the weight 1, the colour 6, the
  transmittance 2). Hits that a structure evaluates and rejects, and the
  buffer's sorting, are left out: another structure may need fewer;
* every splat above the alpha threshold is read once, SPLAT_BYTES (mean,
  Σ⁻¹, opacity and colour in float32), and every ray's origin and
  direction read and its transmittance, colour, hits and passes written
  once, RAY_BYTES.

The hits are the reference's, never a counter or buffer of the program:
a frame's are its sampled pixels' mean hits times its pixels, an estimate
within about 1% of the frame's sum (the share then reads that much off,
never near 100%)."""

from __future__ import annotations

from benchmark import roofline

RESPONSE_FLOPS = 64
BLEND_FLOPS = 9
HIT_FLOPS = RESPONSE_FLOPS + BLEND_FLOPS
SPLAT_BYTES = 4 * (3 + 6 + 1 + 3)
RAY_BYTES = 4 * (3 + 3) + 4 * (1 + 3 + 1 + 1)


def least_seconds(hits: float, splats: int, rays: int) -> float:
    """Least seconds of one frame: `hits` blended in all, `splats` above
    the alpha threshold, `rays` traced."""
    return roofline.least_seconds(HIT_FLOPS * hits,
                                  SPLAT_BYTES * splats + RAY_BYTES * rays)
