"""Texture mip pyramids and trilinear ray-cone sampling (counterpart of
`gsrt.ops.mip`).

One [NT, TH, TW + TW/2, C] array per atlas: level 0 fills the left TW
columns, levels 1..L stack down the right TW/2 columns, so a per-ray
level is an index computation. The pyramid is built once per scene on
the host in NumPy, as the JAX package builds it, so the two atlases are
bit-equal; the result goes to the caller's device. A ray cone's
footprint t·angle times a material's texel density gives texels per
pixel; the LOD is its log2.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from gsrt_torch.core.types import resolve_device
from gsrt_torch.ops.primitives import _cross, _norm, _sqrt


class MipAtlas(NamedTuple):
    """data: [NT, TH, TW + TW//2, C] (or [NT, TH, TW + TW//2]) packed
    pyramid; level offsets follow from (TH, TW, level), `_level_origin`."""
    data: torch.Tensor
    n_levels: int       # level 0 included
    base_h: int
    base_w: int


def _level_origin(th: int, tw: int, level: int):
    """(x0, y0, w, h) of `level` inside the packed array."""
    if level == 0:
        return 0, 0, tw, th
    y0, h = 0, th // 2
    for _ in range(1, level):
        y0 += h
        h //= 2
    return tw, y0, tw >> level, th >> level


def build_mip_atlas(textures, device=None) -> MipAtlas:
    """2×2 average-pool pyramid of [NT, TH, TW, 3] (or [NT, TH, TW] alpha)
    textures with power-of-two sides, in NumPy f32; on CUDA unless
    device="cpu" (a tensor's own device when `textures` is one)."""
    if isinstance(textures, torch.Tensor):
        device = textures.device if device is None else device
        textures = textures.cpu().numpy()
    dev = resolve_device(device)
    tex = np.asarray(textures, np.float32)
    squeeze = tex.ndim == 3
    if squeeze:
        tex = tex[..., None]
    nt, th, tw, c = tex.shape
    if th & (th - 1) or tw & (tw - 1):
        raise ValueError("a mip atlas needs power-of-two textures")
    n_levels = 1 + max(min(th, tw).bit_length() - 1, 0)
    out = np.zeros((nt, th, tw + tw // 2, c), np.float32)
    level = tex
    for lv in range(n_levels):
        x0, y0, w, h = _level_origin(th, tw, lv)
        out[:, y0:y0 + h, x0:x0 + w] = level
        if lv + 1 < n_levels:
            level = level.reshape(nt, h // 2, 2, w // 2, 2, c) \
                         .mean(axis=(2, 4))
    data = torch.as_tensor(out[..., 0] if squeeze else out, device=dev)
    return MipAtlas(data=data, n_levels=n_levels, base_h=th, base_w=tw)


def _bilinear_at_level(mip: MipAtlas, t, uv, level_idx):
    """Bilinear taps at a per-ray integer level [R]."""
    data = mip.data
    orgs = torch.tensor([_level_origin(mip.base_h, mip.base_w, lv)
                         for lv in range(mip.n_levels)], dtype=torch.int32,
                        device=data.device)[level_idx.long()]
    x0, y0, w, h = orgs.unbind(-1)
    u = torch.clamp(uv[:, 0], 0.0, 1.0) * (w - 1).to(torch.float32)
    v = torch.clamp(uv[:, 1], 0.0, 1.0) * (h - 1).to(torch.float32)
    # a NaN coordinate indexes 0, as XLA converts NaN to int
    xf = torch.floor(u).to(torch.int32).clamp_min(0)
    yf = torch.floor(v).to(torch.int32).clamp_min(0)
    x1 = torch.minimum(xf + 1, w - 1)
    y1 = torch.minimum(yf + 1, h - 1)
    fx = u - xf
    fy = v - yf
    if data.dim() == 4:
        fx, fy = fx[:, None], fy[:, None]
    t = t.long()
    ya, yb = (y0 + yf).long(), (y0 + y1).long()
    xa, xb = (x0 + xf).long(), (x0 + x1).long()
    c00, c01 = data[t, ya, xa], data[t, ya, xb]
    c10, c11 = data[t, yb, xa], data[t, yb, xb]
    return ((1 - fy) * ((1 - fx) * c00 + fx * c01)
            + fy * ((1 - fx) * c10 + fx * c11))


def sample_texture_lod(mip: MipAtlas, tex_id, uv, lod):
    """Trilinear sample: tex_id [R] int32 (-1 → white), uv [R, 2] in
    [0, 1), lod [R] (clamped to the pyramid); the lerp of the bilinear
    taps at floor(lod) and the level above."""
    nt = mip.data.shape[0]
    t = torch.clamp(tex_id, 0, nt - 1)
    lod = torch.clamp(lod, 0.0, float(mip.n_levels - 1))
    # a NaN lod (a miss: t = inf on a density of 0) takes level 0 and
    # samples NaN, as XLA's NaN-to-int conversion gives 0
    l0 = torch.floor(torch.nan_to_num(lod, nan=0.0)).to(torch.int32)
    l1 = torch.clamp_max(l0 + 1, mip.n_levels - 1)
    f = lod - l0.to(torch.float32)
    a = _bilinear_at_level(mip, t, uv, l0)
    b = _bilinear_at_level(mip, t, uv, l1)
    sel = tex_id >= 0
    if mip.data.dim() == 4:
        f, sel = f[:, None], sel[:, None]
    col = (1 - f) * a + f * b
    return torch.where(sel, col, torch.ones_like(col))


def triangle_texel_density(v0, v1, v2, uv0, uv1, uv2, tex_res: int):
    """Texels per world unit of each triangle: tex_res · sqrt(uv area /
    world area); degenerate UVs give 0 (level-0 sampling)."""
    wa = 0.5 * _norm(_cross(v1 - v0, v2 - v0))
    u1, u2 = uv1 - uv0, uv2 - uv0
    ua = 0.5 * (u1[..., 0] * u2[..., 1] - u1[..., 1] * u2[..., 0]).abs()
    return tex_res * _sqrt(ua / torch.clamp_min(wa, 1e-12))


def ray_cone_lod(t_hit, cone_angle, texel_density):
    """lod = log2(t · cone_angle · texel_density), at least 0."""
    texels = t_hit * cone_angle * texel_density
    return torch.clamp_min(torch.log2(torch.clamp_min(texels, 1.0)), 0.0)
