"""Run expansion of a depth-sorted source table into pair columns.

Counterpart of `gsrt.ops.pair_expand`: `expand_pairs_fused` and
`expand_pairs` copy source columns, and `expand_pairs_binned` emits the
compact pair payload; each kernel finds every pair's source itself. On a
CUDA tensor they launch `csrc/pair_expand.cu` (which replaces the TPU
kernels `_expand_fused_kernel` and `_expand_kernel`); on a CPU tensor they
run the plain versions below, which compute the same function with
`torch.searchsorted` and a gather. Tables are int32: float rows travel as
their bits.
"""

from __future__ import annotations

import torch

from gsrt_torch import _kernels
from gsrt_torch.ops.tile_binning import MEAN_COARSE_BIAS, _pack_mean_axis

_DEAD_BASE = 1 << 30   # base sentinel for sources that emit no pairs
EMIT_TAB_ROWS = 7      # geometry, base, mean x, mean y, qab, qcd, rgba
EMIT_ROWS = 5          # mean, qab, qcd, rgba, tile id


def _check(tab: torch.Tensor, base: torch.Tensor, min_rows: int) -> None:
    if tab.dtype != torch.int32 or base.dtype != torch.int32:
        raise TypeError("tab and base must be int32")
    if tab.dim() != 2 or base.dim() != 1 or tab.shape[1] != base.shape[0]:
        raise ValueError(f"tab [rows, N] and base [N] expected, got "
                         f"{tuple(tab.shape)} and {tuple(base.shape)}")
    if tab.shape[0] < min_rows or tab.shape[1] == 0:
        raise ValueError(f"tab needs >= {min_rows} rows and >= 1 column")
    if tab.device != base.device:
        raise ValueError("tab and base must share a device")
    if not (tab.is_contiguous() and base.is_contiguous()):
        raise ValueError("tab and base must be contiguous")


def source_index(base: torch.Tensor, max_pairs: int) -> torch.Tensor:
    """s(p) = clamp(#{j: base[j] <= p} - 1, 0, N - 1) for p < max_pairs."""
    p = torch.arange(max_pairs, dtype=torch.int32, device=base.device)
    s = torch.searchsorted(base, p, right=True) - 1
    return s.clamp_(0, base.shape[0] - 1)


def expand_pairs_plain(tab: torch.Tensor, base: torch.Tensor,
                       max_pairs: int) -> torch.Tensor:
    """Plain version of the copy mode: [rows, max_pairs] int32."""
    return tab[:, source_index(base, max_pairs)]


def expand_pairs_binned_plain(tab, base, max_pairs: int, *, total, ntx: int,
                              T: int, tile_w: int, tile_h: int
                              ) -> torch.Tensor:
    """Plain version of the emit mode: [5, max_pairs] int32 rows (packed
    tile-relative mean, qab, qcd, rgba, tile id)."""
    z = expand_pairs_plain(tab[:EMIT_TAB_ROWS], base, max_pairs)
    p = torch.arange(max_pairs, dtype=torch.int32, device=tab.device)
    e0 = z[0]
    gx0 = e0 & 0xFFF
    gy0 = (e0 >> 12) & 0xFFF
    gw = torch.clamp_min((e0 >> 24) & 0x7F, 1)
    rank = torch.clamp_min(p - z[1], 0)
    q = torch.div(rank, gw, rounding_mode="floor")
    tx = gx0 + (rank - q * gw)
    ty = gy0 + q
    mx_rel = z[2].view(torch.float32) - tx.to(torch.float32) * float(tile_w)
    my_rel = z[3].view(torch.float32) - ty.to(torch.float32) * float(tile_h)
    meanp = (_pack_mean_axis(mx_rel) << 16) | _pack_mean_axis(my_rel)
    mean_sat = ((mx_rel.abs() >= MEAN_COARSE_BIAS - 0.5)
                | (my_rel.abs() >= MEAN_COARSE_BIAS - 0.5))
    dead = p >= total
    zero = torch.zeros_like(meanp)
    rgba = torch.where(mean_sat | dead, zero, z[6])
    tile = torch.where(dead, torch.full_like(tx, T), ty * ntx + tx)
    return torch.stack([meanp, z[4], z[5], rgba, tile])


def _copy(kernel, tab: torch.Tensor, base: torch.Tensor,
          max_pairs: int) -> torch.Tensor:
    _check(tab, base, 1)
    if not tab.is_cuda:
        return expand_pairs_plain(tab, base, max_pairs)
    out = torch.empty((tab.shape[0], max_pairs), dtype=torch.int32,
                      device=tab.device)
    with torch.cuda.device(tab.device):
        kernel(tab.data_ptr(), tab.shape[0], tab.shape[1], base.data_ptr(),
               max_pairs, out.data_ptr(), _kernels.stream_ptr(tab))
    return out


def expand_pairs_fused(tab: torch.Tensor, base: torch.Tensor,
                       max_pairs: int) -> torch.Tensor:
    """out[:, p] = tab[:, s(p)]: [rows, max_pairs] int32. base must be
    strictly increasing over the sources that emit pairs, followed by
    _DEAD_BASE for those that emit none."""
    return _copy(_kernels.EXPAND_PLAIN, tab, base, max_pairs)


def expand_pairs(tab: torch.Tensor, base: torch.Tensor,
                 max_pairs: int) -> torch.Tensor:
    """The counterpart of the JAX package's `expand_pairs`, which merges
    s(p) outside its kernel; here it is the same one launch as
    `expand_pairs_fused`, with a launch count of its own. Same contract
    and the same result, bit for bit."""
    return _copy(_kernels.EXPAND_PAIRS, tab, base, max_pairs)


def expand_pairs_binned(tab: torch.Tensor, base: torch.Tensor,
                        max_pairs: int, *, total: torch.Tensor, ntx: int,
                        T: int, tile_w: int, tile_h: int) -> torch.Tensor:
    """Expansion that emits the compact pair payload: [5, max_pairs] int32
    rows — 0 tile-relative two-tier mean, 1 qab, 2 qcd, 3 rgba (zeroed for
    dead or mean-saturated pairs), 4 tile id (T past `total`). tab holds
    the unit table rows (geometry x0 | ys << 12 | w << 24, base, mean x/y
    bits, qab, qcd, rgba); total is a one-element int32 tensor, the live
    pair count."""
    _check(tab, base, EMIT_TAB_ROWS)
    total = total.reshape(1).to(device=tab.device, dtype=torch.int32)
    if not tab.is_cuda:
        return expand_pairs_binned_plain(tab, base, max_pairs, total=total,
                                         ntx=ntx, T=T, tile_w=tile_w,
                                         tile_h=tile_h)
    out = torch.empty((EMIT_ROWS, max_pairs), dtype=torch.int32,
                      device=tab.device)
    with torch.cuda.device(tab.device):
        _kernels.EXPAND_EMIT(tab.data_ptr(), tab.shape[1], base.data_ptr(),
                             max_pairs, total.data_ptr(), ntx, T, tile_w,
                             tile_h, out.data_ptr(), _kernels.stream_ptr(tab))
    return out
