"""The (128, 8)-tile blend (counterpart of `gsrt.ops.splat_pallas`).

`blend_tiles` blends the f32 tile stream over tiles of 128×8 pixels: each
tile walks its own segment in 128-pair chunks and stops at a chunk
boundary once no pixel has trans > term_eps. The TPU kernel
`_blend_kernel` computes the same function as the subtile kernel at that
tile shape (the JAX suite holds the two equal), so on a CUDA tensor this
launches the subtile kernel, `csrc/splat_subtile.cu`, with 1024-thread
blocks, under a launch count of its own; on a CPU tensor it runs the
subtile blend's plain version.
"""

from __future__ import annotations

from gsrt_torch import _kernels
from gsrt_torch.ops.splat_subtile import blend_subtiles
from gsrt_torch.ops.tile_binning import TileBinning

TILE_W, TILE_H = 128, 8


def blend_tiles(binning: TileBinning, *, width: int, height: int,
                chunk: int = 128, g_cutoff: float = 5.6,
                alpha_threshold: float = 1.0 / 255.0,
                alpha_clamp: float = 0.99, term_eps: float = 1e-4,
                skip_range_check: bool = False, use_exp_lut: bool = False):
    """(color [H, W, 3], trans [H, W]) float32 of a binning built with
    compact=False and 128×8 tiles."""
    return blend_subtiles(
        binning, width=width, height=height, sub_w=TILE_W, sub_h=TILE_H,
        chunk=chunk, g_cutoff=g_cutoff, alpha_threshold=alpha_threshold,
        alpha_clamp=alpha_clamp, term_eps=term_eps,
        skip_range_check=skip_range_check, use_exp_lut=use_exp_lut,
        kernel=_kernels.BLEND_TILES)
