"""Backward of the f32 tile-stream blend: per-pair gradients.

Counterpart of `gsrt.ops.splat_grad.blend_backward`. On a CUDA tensor it
launches `csrc/splat_grad.cu` (which replaces the TPU kernel
`_blend_bwd_kernel`); on a CPU tensor it runs `blend_backward_plain`, a
per-tile loop of tensor code computing the same function.

Each tile walks its segment front to back as the forward did
(`gsrt_torch.ops.splat_subtile`), carrying the transmittance T_i in front
of each pair and the prefix colour P_i; the colour behind a pair comes
from the forward's final colour, S_i = C − P_i, so no back-to-front pass
is needed:

    ∂C/∂α_i  = T_i c_i − S_i / (1 − α_i)
    ∂T_N/∂α_i = −T_N / (1 − α_i)
    ∂L/∂c_i  = dC · α_i T_i

∂L/∂α_i is zero where the pair was not accepted or where op·e(g)
exceeded alpha_clamp; ∂α/∂g = op·e'(g), with e'(g) = −exp(−g), or, under
use_exp_lut, the slope −e^{−x₀} of g's LUT segment. The walk stops where
the forward's did, so pairs behind the stop get zeros.
"""

from __future__ import annotations

import torch

from gsrt_torch import _kernels
from gsrt_torch.ops.splat_subtile import (check_stream, culled_steps,
                                          decode_pairs, live_pairs,
                                          pair_alphas, tile_pixels,
                                          warp_footprint)
from gsrt_torch.ops.tile_binning import tile_extent

GRAD_ROWS = 9   # d mean x, y, d conic a, b, c, d opacity, d r, g, b
PIXELS_PER_THREAD = 2   # pixels of one column a thread of the kernel holds


def _check_pixstate(pixstate: torch.Tensor, payload: torch.Tensor, T: int,
                    npx: int) -> None:
    if pixstate.dtype != torch.float32 or pixstate.shape != (8, T * npx):
        raise ValueError(f"pixstate must be float32 [8, {T * npx}], got "
                         f"{pixstate.dtype} {tuple(pixstate.shape)}")
    if pixstate.device != payload.device or not pixstate.is_contiguous():
        raise ValueError("pixstate must be contiguous, on the payload's "
                         "device")


def blend_backward_plain(payload, tile_start, pixstate, *, width: int,
                         height: int, tile_w: int, tile_h: int, chunk: int,
                         g_cutoff: float, alpha_threshold: float,
                         alpha_clamp: float, term_eps: float = 1e-4,
                         skip_range_check: bool = False,
                         use_exp_lut: bool = False,
                         stats: dict | None = None) -> torch.Tensor:
    """Plain version of the backward blend: [9, max_pairs] float32. A
    `stats` dict receives "pairs_blended", the pairs the tiles walk before
    their stop, "accepted", the (pixel, pair) products among them that
    were accepted, and "warp_steps" and "culled_steps", the (warp, pair)
    steps of the kernel's warps (PIXELS_PER_THREAD pixels a thread) and
    those its warp cull skips."""
    ntx, nty = tile_extent(width, height, tile_w, tile_h)
    npx = tile_w * tile_h
    dev = payload.device
    grad = torch.zeros((GRAD_ROWS, payload.shape[1]), dtype=torch.float32,
                       device=dev)
    ts = tile_start.tolist()
    foot = warp_footprint(tile_w, tile_h, PIXELS_PER_THREAD, dev)
    blended = accepted = culled = 0
    for tile in range(ntx * nty):
        lo, hi = ts[tile], ts[tile + 1]
        if hi <= lo:
            continue
        f = decode_pairs(payload[:, lo:hi])
        px, py = tile_pixels(tile, ntx, tile_w, tile_h, dev)
        dx, dy, expg, dexp, raw, accept = pair_alphas(
            f, px, py, g_cutoff=g_cutoff, alpha_threshold=alpha_threshold,
            skip_range_check=skip_range_check, use_exp_lut=use_exp_lut,
            floor_g=True)
        zero = torch.zeros_like(raw)
        alpha = torch.where(accept, torch.clamp_max(raw, alpha_clamp), zero)
        one_minus = 1.0 - alpha
        incl = torch.cumprod(one_minus, dim=1)
        t_i = torch.cat([torch.ones_like(incl[:, :1]), incl[:, :-1]], dim=1)
        n_live = live_pairs(t_i, chunk, term_eps)
        if stats is not None:
            blended += n_live
            accepted += int(accept[:, :n_live].sum())
            culled += culled_steps(
                f, foot, tile, ntx, tile_w, tile_h, n_live,
                g_cutoff=g_cutoff, alpha_threshold=alpha_threshold,
                skip_range_check=skip_range_check, use_exp_lut=use_exp_lut)
        sl = slice(0, n_live)
        st = pixstate[:, tile * npx:(tile + 1) * npx, None]    # [8, P, 1]
        c_fin, t_n, dc, d_tn = st[0:3], st[3], st[4:7], st[7]
        w = (alpha * t_i)[:, sl]                               # [P, n]
        col = f["rgb"][sl].T[:, None, :]                       # [3, 1, n]
        behind = c_fin - torch.cumsum(w[None] * col, dim=2)    # [3, P, n]
        inv_om = 1.0 / one_minus[:, sl]
        d_alpha = ((dc * (t_i[None, :, sl] * col - behind * inv_om)).sum(0)
                   - d_tn * t_n * inv_om)
        d_alpha = torch.where(accept[:, sl] & (raw[:, sl] <= alpha_clamp),
                              d_alpha, zero[:, sl])
        d_gq = d_alpha * f["op"][sl] * dexp[:, sl]
        dx, dy = dx[:, sl], dy[:, sl]
        qa, qb, qc = f["qa"][sl], f["qb"][sl], f["qc"][sl]
        grad[:, lo:lo + n_live] = torch.stack([
            (d_gq * -(qa * dx + qb * dy)).sum(0),
            (d_gq * -(qb * dx + qc * dy)).sum(0),
            (d_gq * (0.5 * dx * dx)).sum(0),
            (d_gq * (dx * dy)).sum(0),
            (d_gq * (0.5 * dy * dy)).sum(0),
            (d_alpha * expg[:, sl]).sum(0),
            *(dc * w[None]).sum(1)])
    if stats is not None:
        stats.update(pairs_blended=blended, accepted=accepted,
                     warp_steps=blended * foot[0].numel(),
                     culled_steps=culled)
    return grad


def blend_backward(payload, tile_start, pixstate, *, width: int, height: int,
                   tile_w: int, tile_h: int, chunk: int, g_cutoff: float,
                   alpha_threshold: float, alpha_clamp: float,
                   term_eps: float = 1e-4, skip_range_check: bool = False,
                   use_exp_lut: bool = False) -> torch.Tensor:
    """Run the backward blend.

    payload and tile_start are the arrays the forward consumed; pixstate
    is [8, T·tile_w·tile_h] float32, per tile its pixels in row-major
    order: the forward's final colour (3 rows) and transmittance, then
    their cotangents; padding pixels past the image edge hold zeros.
    Returns the per-pair gradient table [9, max_pairs], aligned with the
    payload's columns (the JAX package pads it to 16 rows and by its DMA
    tail)."""
    ntx, nty = tile_extent(width, height, tile_w, tile_h)
    T = ntx * nty
    check_stream(payload, tile_start, T, tile_w, tile_h, chunk)
    _check_pixstate(pixstate, payload, T, tile_w * tile_h)
    if not payload.is_cuda:
        return blend_backward_plain(
            payload, tile_start, pixstate, width=width, height=height,
            tile_w=tile_w, tile_h=tile_h, chunk=chunk, g_cutoff=g_cutoff,
            alpha_threshold=alpha_threshold, alpha_clamp=alpha_clamp,
            term_eps=term_eps, skip_range_check=skip_range_check,
            use_exp_lut=use_exp_lut)
    # zeroed: the kernel stores only the columns its walk reaches
    grad = torch.zeros((GRAD_ROWS, payload.shape[1]), dtype=torch.float32,
                       device=payload.device)
    with torch.cuda.device(payload.device):
        _kernels.BLEND_BACKWARD(
            payload.data_ptr(), payload.shape[1], tile_start.data_ptr(),
            pixstate.data_ptr(), T, ntx, tile_w, tile_h, chunk,
            PIXELS_PER_THREAD, g_cutoff,
            int(skip_range_check), alpha_threshold, alpha_clamp, term_eps,
            int(use_exp_lut), grad.data_ptr(), _kernels.stream_ptr(payload))
    return grad
