"""gsrt_torch tile-sorted compact stream (`ops/tile_binning.py`,
stream="tile"), serving's cutoff cull, and the packed blend's tile-stream
mode (`ops/splat_packed.py`, group_stream=False) against the JAX package
on the same NumPy inputs (CPU; JAX Pallas kernels in interpret mode with
math_dtype="f32").

Tolerances:
  * binning: payload rows 0-3 bit for bit on live columns, the tile row,
    tile_start, tile_count, total_pairs, overflow and pair_depth (on live
    columns) exact, with and without a cutoff map; cutoff_cull's keep mask
    exact;
  * blend_packed on the tile stream, plain version against the JAX
    kernel on the same payload: color and trans atol 1e-4 (the JAX kernel
    multiplies a chunk's transmittances as a doubling scan or a log-space
    product, the port in pair order); `consumed` exact; `hits` exact on
    the f32 payload. On the compact payload the JAX kernel forms the
    response as x·l11 + y·l21 + c where the port forms l11·(x − mx) +
    l21·(y − my): at most 0.1% of pixels may differ, each by one hit.
The CUDA kernel is held against the plain version in
tests/test_torch_gpu.py, which needs a card.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_env  # noqa: F401
from gsrt.core.config import RenderConfig as JCfg
from gsrt.models.gaussian_rt import _precompute_fm, fm_from_cloud
from gsrt.ops import splat_packed as j_sp
from gsrt.ops import tile_binning as j_tb
from gsrt.ops.gaussian import screen_extents_abc
from gsrt.scene.catalog import random_cloud

from gsrt_torch.ops import splat_packed as t_sp
from gsrt_torch.ops import tile_binning as t_tb

W, H, TW, TH = 96, 64, 16, 16
NTX, NTY = W // TW, H // TH
T = NTX * NTY
MP = 1 << 15
BS = 16                      # 24 tiles: two groups, the last one padded
BLEND = dict(g_cutoff=5.6, alpha_threshold=1.0 / 255.0, alpha_clamp=0.99)


def scene_columns(kind: str):
    """The 13 per-splat columns of a 96x64 view, from the JAX package's
    projection: "dense" (large overlapping splats, every tile saturates)
    or "sparse"."""
    n, seed, scales = {"dense": (1500, 7, (0.3, 0.7)),
                       "sparse": (1200, 3, (0.02, 0.12))}[kind]
    cloud, camera = random_cloud(n, seed=seed, width=W, height=H,
                                 scale_range=scales)
    cfg = JCfg(width=W, height=H)
    fm = fm_from_cloud(cloud)
    depth, m2x, m2y, qa, qb, qc, inf, cr, cg, cb = _precompute_fm(
        fm, camera, cfg)
    rx, ry = screen_extents_abc(qa, qb, qc, "standard", cfg.g_cutoff,
                                opacity=fm.opacity)
    alive = inf & (fm.opacity > cfg.alpha_threshold) & (depth > 1e-3) \
        & (depth < 1e4)
    return [np.asarray(a) for a in (depth, m2x, m2y, qa, qb, qc, fm.opacity,
                                    cr, cg, cb, rx, ry, alive)]


def cutoff_map(cols, seed=0):
    """A finite-in-places cutoff map that culls a share of the splats."""
    rng = np.random.default_rng(seed)
    d = cols[0][cols[12]]
    cm = rng.uniform(np.quantile(d, 0.3), np.quantile(d, 0.9), T)
    cm[rng.random(T) < 0.25] = np.inf
    return cm.astype(np.float32)


_JAX_BINNINGS: dict = {}


def jax_binning(cols, *, compact=True, expand_impl="fused", cm=None):
    """The JAX package's tile stream (chunk 384: its payload tail covers
    both blend chunks); built once per input within the module."""
    key = (id(cols), compact, expand_impl, cm is None)
    if key not in _JAX_BINNINGS:
        _JAX_BINNINGS[key] = _jax_binning(cols, compact, expand_impl, cm)
    return _JAX_BINNINGS[key]


def _jax_binning(cols, compact, expand_impl, cm):
    return j_tb.build_tile_binning(
        *(jnp.asarray(c) for c in cols), width=W, height=H, tile_w=TW,
        tile_h=TH, chunk=384, max_pairs=MP, expand_impl=expand_impl,
        interpret=True, compact=compact, stream="tile",
        cutoff_map=None if cm is None else jnp.asarray(cm),
        carry_depth=True, cull_super=2)


def port_binning(cols, *, compact=True, expand_impl="fused", cm=None):
    return t_tb.build_tile_binning(
        *(torch.as_tensor(np.array(c)) for c in cols), width=W, height=H,
        tile_w=TW, tile_h=TH, max_pairs=MP, compact=compact, stream="tile",
        expand_impl=expand_impl,
        cutoff_map=None if cm is None else torch.as_tensor(cm),
        carry_depth=True, cull_super=2)


def carry_over(jb, compact: bool) -> t_tb.TileBinning:
    """The JAX package's tile-stream binning as the port's, via NumPy."""
    t = lambda a: torch.as_tensor(np.array(a))
    pay = np.asarray(jb.payload)[:, :MP]
    pay = pay[:5] if compact else pay.view(np.int32)
    return t_tb.TileBinning(
        payload=t(pay), tile_start=t(jb.tile_start),
        tile_count=t(jb.tile_count), total_pairs=t(jb.total_pairs),
        overflow=t(jb.overflow))


@pytest.fixture(scope="module")
def dense():
    return scene_columns("dense")


@pytest.fixture(scope="module")
def sparse():
    return scene_columns("sparse")


@pytest.mark.parametrize("with_cull", [False, True])
@pytest.mark.parametrize("expand_impl", ["fused", "binned", "xla"])
def test_compact_tile_binning_matches_jax(dense, expand_impl, with_cull):
    cm = cutoff_map(dense) if with_cull else None
    jb = jax_binning(dense, expand_impl=expand_impl, cm=cm)
    tb = port_binning(dense, expand_impl=expand_impl, cm=cm)
    for name in ("tile_start", "tile_count", "total_pairs", "overflow"):
        np.testing.assert_array_equal(getattr(tb, name).numpy(),
                                      np.asarray(getattr(jb, name)), name)
    total = int(tb.total_pairs)
    assert 2000 < total < MP and tb.payload.shape == (5, MP)
    if with_cull:
        full = port_binning(dense, expand_impl=expand_impl)
        assert total < int(full.total_pairs)       # the cull dropped pairs
    jp = np.asarray(jb.payload)[:5, :MP]
    tp = tb.payload.numpy()
    np.testing.assert_array_equal(tp[:4, :total], jp[:4, :total])
    np.testing.assert_array_equal(tp[4], jp[4])          # tile row, all
    np.testing.assert_array_equal(tb.pair_depth.numpy()[:total],
                                  np.asarray(jb.pair_depth)[:total])


def test_f32_tile_binning_carries_depth(sparse):
    cm = cutoff_map(sparse, seed=1)
    jb = jax_binning(sparse, compact=False, cm=cm)
    tb = port_binning(sparse, compact=False, cm=cm)
    total = int(tb.total_pairs)
    np.testing.assert_array_equal(
        tb.payload.numpy(), np.asarray(jb.payload)[:, :MP].view(np.int32))
    np.testing.assert_array_equal(tb.tile_start.numpy(),
                                  np.asarray(jb.tile_start))
    np.testing.assert_array_equal(tb.pair_depth.numpy()[:total],
                                  np.asarray(jb.pair_depth)[:total])
    assert port_binning(sparse, compact=False).total_pairs > total


def test_cutoff_cull_matches_jax():
    # the random spans of tests/test_serving.py's conservative-cull test
    rng = np.random.default_rng(0)
    ntx, nty, n = 13, 9, 400
    x0 = rng.integers(0, ntx, n).astype(np.int32)
    x1 = np.minimum(x0 + rng.integers(0, 5, n), ntx - 1).astype(np.int32)
    y0 = rng.integers(0, nty, n).astype(np.int32)
    y1 = np.minimum(y0 + rng.integers(0, 5, n), nty - 1).astype(np.int32)
    depth = rng.uniform(0, 10, n).astype(np.float32)
    cmap = rng.uniform(0, 10, (nty, ntx)).astype(np.float32)
    cmap[rng.random((nty, ntx)) < 0.3] = np.inf
    kept = []
    for super_size in (j_tb.SUPER, 2, 1):
        want = np.asarray(j_tb.cutoff_cull(
            depth, x0, x1, y0, y1, cmap.reshape(-1), ntx, nty,
            super_size=super_size))
        got = t_tb.cutoff_cull(*(torch.as_tensor(a) for a in (
            depth, x0, x1, y0, y1, cmap.reshape(-1))), ntx, nty,
            super_size=super_size)
        np.testing.assert_array_equal(got.numpy(), want)
        kept.append(int(want.sum()))
    assert min(kept) < n, kept           # some supertile size culls


@pytest.fixture(scope="module")
def streams(dense, sparse):
    """The JAX package's tile-stream binnings by (scene, payload)."""
    return {(scene, compact): jax_binning(cols, compact=compact)
            for scene, cols in (("dense", dense), ("sparse", sparse))
            for compact in (True, False)}


def _blend_kw(use_exp_lut):
    # the LUT chord sits above exp, so with it the range test stays on
    return dict(width=W, height=H, sub_w=TW, sub_h=TH, bs=BS,
                skip_range_check=not use_exp_lut, use_exp_lut=use_exp_lut,
                track_consumed=True, track_hits=True, group_stream=False,
                **BLEND)


@pytest.mark.parametrize("use_exp_lut", [False, True])
@pytest.mark.parametrize("chunk", [128, 384])
@pytest.mark.parametrize("payload", ["compact", "f32"])
@pytest.mark.parametrize("scene", ["dense", "sparse"])
def test_tile_blend_matches_jax(streams, scene, payload, chunk, use_exp_lut):
    compact = payload == "compact"
    jb = streams[scene, compact]
    kw = _blend_kw(use_exp_lut)
    jc, jt, jcons, jhits = (np.asarray(a) for a in j_sp.blend_packed(
        jb, interpret=True, scan_impl="roll", math_dtype="f32", chunk=chunk,
        **kw))
    tc, tt, tcons, thits = t_sp.blend_packed(carry_over(jb, compact),
                                             chunk=chunk, **kw)
    assert tc.shape == (H, W, 3) and tcons.shape == jcons.shape == (2, BS)
    np.testing.assert_allclose(tc.numpy(), jc, atol=1e-4)
    np.testing.assert_allclose(tt.numpy(), jt, atol=1e-4)
    np.testing.assert_array_equal(tcons.numpy(), jcons)
    if scene == "dense":
        assert (jcons[0] < jcons[0].max()).any()     # tiles saturate
    diff = thits.numpy() - jhits
    if compact:
        assert np.abs(diff).max() <= 1 and (diff != 0).mean() <= 1e-3
    else:
        np.testing.assert_array_equal(thits.numpy(), jhits)
