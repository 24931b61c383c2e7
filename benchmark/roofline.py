"""The kernels' least times: operations and bytes that the inputs need,
against the published H100 SXM peaks (NVIDIA data sheet, dense, at the
full 700 W; the run records the card's power limit beside them).

The work is counted by the reference (`reference/splats.composite` with
count=True), from the cell's inputs and never from a counter or buffer
of the port, so a change to the port's binning, payload or kernels leaves
the count alone. It is a lower bound of what any kernel must do:

* a (pixel, pair) that the pixel accepts, in a tile's pairs up to the
  one that saturates the tile, must be evaluated and blended: forward
  BLEND_FLOPS operations (chip_smoke.py's rule for the packed blends:
  offsets 2, response 5, alpha 2, blend 9, compare 2, the exp counted as
  one more); the backward re-tests it (TEST_FLOPS, 18) and differentiates
  it (BWD_ACCEPT_FLOPS, 65, chip_smoke.py's count from splat_grad.cu);
* a pair that at least one pixel of its tile accepts must be read once:
  PAIR_BYTES of the payload the configuration states (the compact
  payload's four 4-byte words; the f32 stream's seven 4-byte fields), and
  the backward writes 9 f32 gradients a pair;
* every pixel's colour and transmittance are written once (16 bytes);
  the backward reads 8 f32 planes a pixel.

(pixel, pair) products that no pixel takes, pairs past the stop and
padding pixels are left out: a kernel that skips them does no less than
this count. So a share above 100% means a miscount."""

from __future__ import annotations

F32_FLOPS = 67e12          # float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
BLEND_FLOPS = 20
TEST_FLOPS = 18
BWD_ACCEPT_FLOPS = 65
PAIR_BYTES = {"compact": 16, "f32": 28}
PIXEL_OUT_BYTES = 16
BWD_PIXEL_BYTES = 32
BWD_PAIR_OUT_BYTES = 36


def least_seconds(flops: float, nbytes: float) -> float:
    return max(flops / F32_FLOPS, nbytes / HBM_BYTES_PER_S)


def blend_forward(counts: dict, pixels: int, payload: str) -> float:
    """Least seconds of one frame's forward blend."""
    flops = BLEND_FLOPS * counts["accepted"]
    nbytes = PAIR_BYTES[payload] * counts["pairs_read"] + \
        PIXEL_OUT_BYTES * pixels
    return least_seconds(flops, nbytes)


def blend_backward(counts: dict, pixels: int) -> float:
    """Least seconds of one step's backward blend (f32 stream)."""
    flops = (TEST_FLOPS + BWD_ACCEPT_FLOPS) * counts["accepted"]
    nbytes = (PAIR_BYTES["f32"] + BWD_PAIR_OUT_BYTES) * counts["pairs_read"] \
        + BWD_PIXEL_BYTES * pixels
    return least_seconds(flops, nbytes)
