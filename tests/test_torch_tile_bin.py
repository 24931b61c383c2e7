"""The group stream's kernel route (`gsrt_torch.ops.tile_bin`,
`csrc/tile_bin.cu`) as far as the CPU reaches it: CPU tensors take the
plain version and launch nothing, a frame's binning counts no kernel
route, the wrapper refuses what the kernels do not take, and the
kernels' workspace regions are aligned and apart. The kernels
themselves are held bit for bit to the plain version on the card
(tests/test_torch_gpu.py).
"""

from __future__ import annotations

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import _torch_env  # noqa: F401
from gsrt_torch import RenderConfig, _kernels
from gsrt_torch.models import gaussian_rt as t_rt
from gsrt_torch.ops import tile_bin, tile_binning
from gsrt_torch.scene import random_cloud
from gsrt_torch.utils.profiling import TRACER

W, H = 64, 48
MP = 1 << 13


@pytest.fixture(scope="module")
def columns():
    """A small view's binning columns, contiguous as the projection
    kernel hands them over."""
    cfg = RenderConfig(width=W, height=H, tile_w=16, tile_h=16)
    cloud, cam = random_cloud(400, seed=3, width=W, height=H, device="cpu")
    cols = t_rt._precompute(cloud, cam, cfg)
    return tuple(c.contiguous() for c in (
        cols.depth, cols.m2x, cols.m2y, cols.qa, cols.qb, cols.qc,
        cloud.opacity, cols.cr, cols.cg, cols.cb, cols.rx, cols.ry,
        cols.alive))


def _kw(**over):
    kw = dict(width=W, height=H, tile_w=16, tile_h=16, max_pairs=MP,
              max_units=MP)
    kw.update(over)
    return kw


def test_cpu_tensors_take_the_plain_route(columns, monkeypatch):
    calls = []
    plain = tile_binning.group_stream_plain

    def spy(*args, **kw):
        calls.append(kw["max_units"])
        return plain(*args, **kw)
    monkeypatch.setattr(tile_binning, "group_stream_plain", spy)
    before = _kernels.launch_counts()
    b = tile_binning.build_tile_binning(
        *columns, width=W, height=H, tile_w=16, tile_h=16, max_pairs=MP,
        max_rows=MP // 2)
    assert calls == [MP // 2]
    assert _kernels.launch_counts() == before
    assert int(b.total_pairs) > 0 and not bool(b.overflow)


def test_cpu_frame_counts_no_group_kernel_route():
    cfg = RenderConfig(width=W, height=H, tile_w=16, tile_h=16)
    cloud, cam = random_cloud(400, seed=3, width=W, height=H, device="cpu")
    tracer = t_rt.GaussianRayTracer(cfg, "tiled", device="cpu")
    tracer.calibrate(cloud, cam)
    TRACER.reset()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            tracer(cloud, cam)
        spans = [s for s in TRACER.report() if s["name"] == "render.binning"]
    finally:
        TRACER.reset()
    assert len(spans) == 1
    assert spans[0]["counters"]["group_bin_fused"] == 0


def _swap(cols, i, t):
    return cols[:i] + (t,) + cols[i + 1:]


REFUSALS = {
    # name: (edit of the columns, keyword changes, message fragment)
    "cpu": (lambda c: c, {}, "runs on CUDA tensors"),
    "meta_column": (lambda c: _swap(c, 4, torch.empty(c[4].shape,
                                                      device="meta")),
                    {}, "qb is on meta"),
    "float64": (lambda c: _swap(c, 1, c[1].double()), {}, "m2x must be"),
    "alive_uint8": (lambda c: _swap(c, 12, c[12].to(torch.uint8)), {},
                    "alive must be"),
    "short_column": (lambda c: _swap(c, 10, c[10][:-1]), {},
                     "rx must have shape"),
    "two_dims": (lambda c: _swap(c, 0, c[0][:, None]), {},
                 r"depth must be \[N\]"),
    "strided": (lambda c: _swap(c, 7, torch.stack([c[7], c[7]], 1)[:, 0]),
                {}, "cr must be contiguous"),
    "keep_float": (lambda c: c, {"keep": "float"}, "keep must be"),
    "no_units": (lambda c: c, {"max_units": 0}, "needs splats and buffers"),
    # 17 tile columns: no k <= 7 rows makes a group of 8k tiles
    "no_group_shape": (lambda c: c, {"width": 68, "tile_w": 4},
                       "has no group stream"),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_wrapper_refuses_what_the_kernels_do_not_take(columns, case):
    edit, over, msg = REFUSALS[case]
    cols = edit(tuple(columns))
    if over.get("keep") == "float":
        over = dict(over, keep=torch.ones(cols[0].shape[0]))
    before = _kernels.launch_counts()
    with pytest.raises(ValueError, match=msg):
        tile_bin.bin_group_stream(*cols, **_kw(**over))
    assert _kernels.launch_counts() == before


@pytest.mark.parametrize("n,max_units,ntx,nty,n_groups", [
    (1, 1, 1, 1, 1), (2_960_000, 5_242_880, 60, 68, 34),
    (2_960_000, 5_242_880, 120, 68, 68), (1_000_003, 77, 30, 68, 17),
    (5, 3_000_001, 120, 4095, 4095)])
def test_workspace_regions_are_aligned_and_apart(n, max_units, ntx, nty,
                                                 n_groups):
    off = tile_bin.workspace_layout(n, max_units, ntx, nty, n_groups)
    words = {"grid": (nty + 1) * (ntx + 1), "sums": 3, "tickets": 3,
             "status": 2 * -(-n // tile_bin.GATHER_THREADS),
             "totals": 2 * (n_groups + 1),
             "unit_status": 2 * -(-max_units // tile_bin.UNIT_TILE)
             * (n_groups + 1),
             "key": n, "rec": 8 * n, "tab1": 8 * n,
             "base": 2 * (n_groups + 1)}
    names = list(off)
    assert names[0] == "grid" and names[-1] == "end"
    assert all(v % 4 == 0 for v in off.values())   # 16-byte aligned
    for a, b in zip(names, names[1:]):
        assert off[a] + words.get(a, 0) <= off[b], (a, b)
    # bin_prep clears the grid, sums, tickets and look-back words, and only
    # those
    zeroed = {a for a in names if off[a] < off["zero"]}
    assert zeroed == {"grid", "sums", "tickets", "status", "totals",
                      "unit_status"}
