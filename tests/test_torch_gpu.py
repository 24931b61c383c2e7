"""gsrt_torch CUDA kernels against their plain PyTorch versions, on the
card. Every test here needs a CUDA device and skips without one. The file
imports neither jax nor gsrt, so it runs where only PyTorch is installed:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q

Tolerances: the expand kernel is compared bit for bit in both modes; the
blend kernel at atol 2e-3 on color and trans (f32 summation order and the
exp implementation differ from the plain version's).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from gsrt_torch import RenderConfig, _kernels
from gsrt_torch.models import gaussian_rt as t_rt
from gsrt_torch.ops import pair_expand as t_pe
from gsrt_torch.ops import splat_packed as t_sp
from gsrt_torch.scene import random_cloud

pytestmark = pytest.mark.gpu
DEAD = t_pe._DEAD_BASE


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels have no CPU "
                    "mode")
    return torch.device("cuda")


def _runs_to_base(runs):
    return np.where(runs > 0, np.cumsum(runs) - runs, DEAD).astype(np.int32)


def test_expand_copy_kernel_bitwise(cuda):
    rng = np.random.default_rng(2)
    n = 50_000
    runs = np.where(np.arange(n) < 45_000, rng.integers(1, 9, n), 0)
    base = torch.as_tensor(_runs_to_base(runs), device=cuda)
    tab = torch.as_tensor(rng.integers(-2**31, 2**31 - 1, (8, n))
                          .astype(np.int32), device=cuda)
    before = _kernels.EXPAND_PLAIN.launches
    for mp in (int(runs.sum()) + 1000, int(runs.sum()) - 777):
        assert torch.equal(t_pe.expand_pairs_fused(tab, base, mp),
                           t_pe.expand_pairs_plain(tab, base, mp))
    assert _kernels.EXPAND_PLAIN.launches == before + 2


def test_expand_emit_kernel_bitwise(cuda):
    rng = np.random.default_rng(3)
    n, ntx, nty, tw, th = 20_000, 60, 68, 32, 16
    x0 = rng.integers(0, ntx, n)
    w = np.minimum(rng.integers(1, 4, n), ntx - x0)
    ys = rng.integers(0, nty, n)
    rows = np.minimum(rng.integers(1, 3, n), nty - ys)
    runs = np.where(np.arange(n) < 19_000, rows * w, 0)
    mx = ((x0 + w / 2) * tw + rng.normal(0, 40, n)).astype(np.float32)
    my = ((ys + rows / 2) * th + rng.normal(0, 40, n)).astype(np.float32)
    mx[:3] = [3000.0, -2500.0, 70.0]
    words = rng.integers(-2**31, 2**31 - 1, (3, n)).astype(np.int32)
    tab = np.stack([(x0 | (ys << 12) | (w << 24)).astype(np.int32),
                    _runs_to_base(runs), mx.view(np.int32),
                    my.view(np.int32), *words])
    tab_t = torch.as_tensor(tab, device=cuda)
    total = int(runs.sum())
    kw = dict(total=torch.tensor(total - 5, dtype=torch.int32, device=cuda),
              ntx=ntx, T=ntx * nty, tile_w=tw, tile_h=th)
    before = _kernels.EXPAND_EMIT.launches
    got = t_pe.expand_pairs_binned(tab_t, tab_t[1].contiguous(), total + 99,
                                   **kw)
    want = t_pe.expand_pairs_binned_plain(tab_t, tab_t[1].contiguous(),
                                          total + 99, **kw)
    assert torch.equal(got, want)
    assert _kernels.EXPAND_EMIT.launches == before + 1


def test_blend_kernel_matches_plain(cuda):
    cfg = RenderConfig(width=320, height=256)
    cloud, cam = random_cloud(20_000, seed=1, width=320, height=256,
                              device=cuda)
    tr = t_rt.GaussianRayTracer(cfg, "tiled", device=cuda)
    tr.calibrate(cloud, cam)
    from gsrt_torch.ops import tile_binning as t_tb
    d, m2, q, inf, col = t_rt._precompute(cloud, cam, cfg)
    rx, ry = t_rt.screen_extents_abc(q[:, 0], q[:, 1], q[:, 2], "standard",
                                     5.6, opacity=cloud.opacity)
    alive = inf & (cloud.opacity > 1 / 255) & (d > 1e-3) & (d < 1e4)
    b = t_tb.build_tile_binning(
        d, m2[:, 0], m2[:, 1], q[:, 0], q[:, 1], q[:, 2], cloud.opacity,
        col[:, 0], col[:, 1], col[:, 2], rx, ry, alive, width=320,
        height=256, max_pairs=tr.max_pairs, max_rows=tr.max_rows)
    kw = dict(width=320, height=256, sub_w=32, sub_h=16,
              bs=t_tb.group_rows_k(10) * 10, skip_range_check=True)
    before = _kernels.BLEND_GROUP.launches
    ck, tk = t_sp.blend_packed(b, **kw)
    cp, tp = t_sp.blend_packed_plain(b, **kw)
    assert _kernels.BLEND_GROUP.launches == before + 1
    assert (ck - cp).abs().max().item() <= 2e-3
    assert (tk - tp).abs().max().item() <= 2e-3


def test_render_tiled_cuda_matches_cpu(cuda):
    cfg = RenderConfig(width=256, height=256)
    c, cam = random_cloud(3000, seed=0, width=256, height=256, device="cpu")
    out_cpu = t_rt.render_tiled(c, cam, cfg, max_pairs=1 << 16,
                                max_rows=1 << 14)
    out_gpu = t_rt.render_tiled(c.to(cuda), cam.to(cuda), cfg,
                                max_pairs=1 << 16, max_rows=1 << 14)
    assert not bool(out_gpu.overflow)
    np.testing.assert_allclose(out_gpu.color.cpu().numpy(),
                               out_cpu.color.numpy(), atol=2e-3)
    np.testing.assert_allclose(out_gpu.trans.cpu().numpy(),
                               out_cpu.trans.numpy(), atol=2e-3)
