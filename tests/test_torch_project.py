"""gsrt_torch's projection layer (`ops.project`): the plain version, which
is the CPU's path and the CUDA kernel's reference, against the
composition it replaced in `render_tiled` (`_project_sh`, then
`screen_extents_abc` and `alive_mask`), bit for bit on every column (CPU).
The kernel itself is held to the plain version on the card in
tests/test_torch_gpu.py, over the same clouds (`edge_cloud`).

The file imports neither jax nor gsrt.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import _torch_env  # noqa: F401
from gsrt_torch import RenderConfig
from gsrt_torch.core.types import GaussianCloud, look_at, make_camera
from gsrt_torch.models import gaussian_rt as t_rt
from gsrt_torch.ops import project as t_proj
from gsrt_torch.ops import tile_binning
from gsrt_torch.ops.gaussian import (project_gaussians, quat_scale_to_cov3d,
                                     screen_extents_abc)

W, H = 320, 240
T_MAX = 12.0
# (coefficient rows K of the cloud, cfg.sh_degree): every degree, and K
# above (degree + 1)^2 (the colour reads the first rows of a longer row)
SH_CASES = [(1, 0), (4, 1), (9, 2), (16, 3), (16, 0), (16, 1), (16, 2),
            (9, 1)]
# the edge cases' slots in edge_cloud
BEHIND, NEAR, FAR, FLAT, NEEDLE, FAINT = range(6)


def edge_cloud(n: int, k: int, seed: int = 0, device="cpu"):
    """(cloud, camera) of n splats with k SH rows, seen from an oblique
    camera, the first 6 * 8 splats edge cases in slots of 8 (`slot::6`):
    behind the camera, in front but nearer than t_min, past T_MAX,
    degenerate Σ (all zero: det ≤ 1e-12 without dilation), a needle Σ
    (rank one), opacity under the alpha threshold."""
    rng = np.random.default_rng(seed)
    eye, target = np.array([3.0, -2.0, -6.0]), np.array([0.0, 0.0, 4.0])
    view = look_at(eye=eye, target=target)
    fwd = (target - eye) / np.linalg.norm(target - eye)
    means = rng.uniform(-4.0, 4.0, (n, 3)) + target
    quats = rng.normal(size=(n, 4))
    scales = rng.uniform(0.01, 0.3, (n, 3))
    opacity = rng.uniform(0.2, 0.95, n)
    sh = rng.normal(0.0, 0.3, (n, k, 3))
    sh[:, 0] = rng.uniform(-1.5, 1.5, (n, 3))
    slot = np.arange(min(n, 48)) % 6
    edge = np.arange(slot.size)
    depth_at = lambda d: eye + d[:, None] * fwd        # noqa: E731
    for s, d in ((BEHIND, -2.0), (NEAR, 5e-4), (FAR, T_MAX + 3.0)):
        rows = edge[slot == s]
        means[rows] = depth_at(np.full(rows.size, d)) + rng.normal(
            0.0, 1e-5, (rows.size, 3))
    scales[edge[slot == FLAT]] = 0.0
    scales[edge[slot == NEEDLE]] = [0.5, 0.0, 0.0]
    opacity[edge[slot == FAINT]] = rng.uniform(0.0, 1.0 / 255.0,
                                               (slot == FAINT).sum())
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    cloud = GaussianCloud(means=t(means),
                          cov3d=quat_scale_to_cov3d(t(quats), t(scales)),
                          opacity=t(opacity), sh=t(sh))
    camera = make_camera(view, fov_y_deg=50.0, width=W, height=H,
                         device=device)
    return cloud, camera


def edge_config(conic_mode: str, degree: int, dilation: float):
    return RenderConfig(width=W, height=H, conic_mode=conic_mode,
                        sh_degree=degree, cov2d_dilation=dilation,
                        t_max=T_MAX)


def composed(cloud, camera, cfg) -> list:
    """The columns as `render_tiled` computed them before the projection
    layer was one function."""
    depth, mean2d, quad, in_front, colors = t_rt._project_sh(cloud, camera,
                                                             cfg)
    rx, ry = screen_extents_abc(quad[:, 0], quad[:, 1], quad[:, 2],
                                cfg.conic_mode, cfg.g_cutoff,
                                opacity=cloud.opacity,
                                alpha_threshold=cfg.alpha_threshold)
    alive = t_rt.alive_mask(depth, cloud.opacity, in_front, cfg)
    return [depth, mean2d[:, 0], mean2d[:, 1], quad[:, 0], quad[:, 1],
            quad[:, 2], colors[:, 0], colors[:, 1], colors[:, 2], rx, ry,
            alive]


@pytest.mark.parametrize("dilation", [0.0, 0.3])
@pytest.mark.parametrize("k,degree", SH_CASES)
@pytest.mark.parametrize("conic_mode", ["standard", "reference"])
def test_plain_projection_is_the_old_composition(conic_mode, k, degree,
                                                 dilation):
    cloud, camera = edge_cloud(389, k, seed=k + degree)
    cfg = edge_config(conic_mode, degree, dilation)
    got = t_rt._precompute(cloud, camera, cfg)
    assert isinstance(got, t_proj.SplatColumns)
    for name, g, w in zip(t_proj.SplatColumns._fields, got,
                          composed(cloud, camera, cfg)):
        assert g.shape == (cloud.n,) and g.dtype == w.dtype, name
        assert torch.equal(g, w), name
    # every edge case is dropped, and the rest mostly kept
    alive = got.alive.numpy()
    assert not alive[:48][np.isin(np.arange(48) % 6,
                                  (BEHIND, NEAR, FAR, FAINT))].any()
    assert alive[48:].mean() > 0.5


@pytest.mark.parametrize("conic_mode", ["standard", "reference"])
def test_edge_cloud_reaches_every_branch(conic_mode):
    """The clouds the kernel is held to hold each case its branches
    treat apart: splats behind the camera and nearer than t_min, past
    t_max, with det <= 1e-12 (standard mode zeroes their conic), and
    under the alpha threshold."""
    cloud, camera = edge_cloud(389, 16)
    cfg = edge_config(conic_mode, 3, 0.0)
    det = project_gaussians(cloud.means, cloud.cov3d, camera,
                            conic_mode=conic_mode)[3]
    cols = t_rt._precompute(cloud, camera, cfg)
    d = cols.depth.numpy()
    slot = np.arange(48) % 6
    assert (d[:48][slot == BEHIND] < 0).all()
    assert ((d[:48][slot == NEAR] > 1e-4)
            & (d[:48][slot == NEAR] < cfg.t_min)).all()
    assert (d[:48][slot == FAR] > T_MAX).all()
    assert (cloud.opacity[:48][slot == FAINT] < cfg.alpha_threshold).all()
    flat = torch.as_tensor(slot == FLAT)
    assert (det[:48][flat] <= 1e-12).all()
    q = torch.stack([cols.qa, cols.qb, cols.qc], -1)[:48][flat]
    assert (q == 0).all()
    if conic_mode == "standard":
        assert not cols.alive[:48][flat].any()


def test_precompute_takes_the_plain_version_on_the_cpu(monkeypatch):
    cloud, camera = edge_cloud(64, 16)
    cfg = edge_config("standard", 3, 0.0)

    def no_kernel(*args):
        raise AssertionError("the kernel launched on CPU tensors")
    monkeypatch.setattr(t_proj._kernels, "PROJECT", no_kernel)
    for got, want in zip(t_rt._precompute(cloud, camera, cfg),
                         t_proj.project_splats_plain(cloud, camera, cfg)):
        assert torch.equal(got, want)


def test_project_splats_refuses_other_devices():
    cloud, camera = edge_cloud(16, 4)
    meta = GaussianCloud(*(x.to("meta") for x in cloud))
    with pytest.raises(ValueError, match="CPU or CUDA"):
        t_proj.project_splats(meta, camera, edge_config("standard", 1, 0.0))


def test_render_tiled_bins_the_projection_layer(monkeypatch):
    """render_tiled hands `_precompute`'s columns to the binning as they
    are, with the cloud's opacity."""
    cloud, camera = edge_cloud(600, 16)
    cfg = edge_config("standard", 3, 0.0)
    seen = {}
    orig = tile_binning.build_tile_binning

    def spy(*cols, **kw):
        seen["cols"] = cols
        return orig(*cols, **kw)
    monkeypatch.setattr(tile_binning, "build_tile_binning", spy)
    out = t_rt.render_tiled(cloud, camera, cfg, max_pairs=1 << 15,
                            max_rows=1 << 13)
    assert not bool(out.overflow) and "cols" in seen
    want = t_rt._precompute(cloud, camera, cfg)
    got = seen["cols"]
    assert got[6] is cloud.opacity
    for g, w in zip(got[:6] + got[7:], want):
        assert torch.equal(g, w)
