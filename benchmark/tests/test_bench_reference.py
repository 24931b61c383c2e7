"""The plain reference against a brute-force composite, its training
gradients against autograd, the roofline's work count, and what the
reference and the harness import."""

from __future__ import annotations

import ast
from pathlib import Path

import pytest
import torch

from benchmark import roofline, scene
from benchmark.reference import splats
from benchmark.reference import train as rtrain

PKG = Path(__file__).resolve().parents[1]


def brute_force(cloud, cov, view, consts=splats.CONSTS):
    """Every pixel against every splat, sorted by depth, composited to
    the end (no tiles, no stop), through autograd-friendly ops."""
    p = splats.project(cloud.means, cov, cloud.opacity, cloud.sh, view)
    order = torch.argsort(torch.where(p["alive"], p["depth"],
                                      torch.full_like(p["depth"], 1e30)),
                          stable=True)
    H, W = view.height, view.width
    ys, xs = torch.meshgrid(torch.arange(H, dtype=torch.float32),
                            torch.arange(W, dtype=torch.float32),
                            indexing="ij")
    px, py = xs.reshape(-1, 1), ys.reshape(-1, 1)
    dx, dy = px - p["mx"][order], py - p["my"][order]
    g = 0.5 * (p["qa"][order] * dx * dx + 2 * p["qb"][order] * dx * dy
               + p["qc"][order] * dy * dy)
    a = torch.clamp_max(p["op"][order] * torch.exp(-g), 0.99)
    ok = (p["alive"][order] & (g >= 0) & (g <= consts["g_cutoff"])
          & (a > consts["alpha_threshold"]))
    a = torch.where(ok, a, torch.zeros_like(a))
    t = torch.cumprod(1 - a, -1)
    texc = torch.cat([torch.ones_like(t[:, :1]), t[:, :-1]], -1)
    color = (a * texc) @ p["rgb"][order]
    return color.reshape(H, W, 3), t[:, -1].reshape(H, W)


def _scene(n, scale, seed=4, W=80, H=56):
    cl = scene.random_cloud(n, seed, "cpu", scale_range=(scale / 4, scale))
    cov = scene.cov3d(cl.quats, cl.scales)
    view = scene.orbit((0, 0, 6), 10, [25.0], height=2, fov_y_deg=40,
                       width=W, height_px=H)[0]
    return cl, cov, view


@pytest.mark.parametrize("n,scale,tol", [
    (400, 0.3, 2e-6),      # sparse: no tile saturates
    (4000, 0.3, 5e-4),     # dense: tiles stop at term_eps
])
def test_reference_matches_brute_force(n, scale, tol):
    cl, cov, view = _scene(n, scale)
    r = splats.render(cl, cov, view)
    color, trans = brute_force(cl, cov, view)
    assert (r["color"] - color).abs().max() <= tol
    assert (r["trans"] - trans).abs().max() <= tol


def test_reference_gradients_match_autograd():
    cl, _, view = _scene(300, 0.3, W=48, H=32)
    params = dict(means=cl.means, log_scales=torch.log(cl.scales),
                  quats=cl.quats,
                  opacity_logit=torch.log(cl.opacity / (1 - cl.opacity)),
                  sh=cl.sh)
    target = scene.lowfreq_targets(1, 48, 32, (3, 4), 1, "cpu")[0]
    loss, grads = rtrain.loss_and_grads(params, view, target, 0.2)
    leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    cov = scene.cov3d(leaves["quats"], torch.exp(leaves["log_scales"]))
    c = scene.Cloud(leaves["means"], leaves["quats"], None,
                    torch.sigmoid(leaves["opacity_logit"]), leaves["sh"])
    color, _ = brute_force(c, cov, view)
    want = rtrain.image_loss(color, target, 0.2)
    want.backward()
    assert float(loss) == pytest.approx(float(want.detach()), rel=1e-6)
    for k in rtrain.LEAVES:
        g, w = grads[k], leaves[k].grad
        assert (g - w).norm() <= 1e-4 * w.norm() + 1e-9, k


def test_work_count_ignores_the_port(monkeypatch):
    """The roofline's count is the reference's: breaking the port's
    binning, blend and buffer sizing leaves it as it was."""
    cl, cov, view = _scene(3000, 0.3)
    before = splats.render(cl, cov, view, count=True)
    import gsrt_torch.models.gaussian_rt as grt
    import gsrt_torch.ops.splat_packed as sp
    import gsrt_torch.ops.tile_binning as tb

    def broken(*a, **kw):
        raise AssertionError("the count reached the port")
    for mod, name in ((tb, "build_tile_binning"), (sp, "blend_packed"),
                      (grt, "count_pairs_numpy"), (grt, "render_tiled")):
        monkeypatch.setattr(mod, name, broken)
    after = splats.render(cl, cov, view, count=True)
    for k in ("pairs_needed", "pairs_read", "accepted"):
        assert torch.equal(before[k], after[k])
    start, _ = splats.bin_pairs(splats.project(cl.means, cov, cl.opacity,
                                               cl.sh, view), 80, 56)
    pairs = (start[1:] - start[:-1])
    assert (after["pairs_needed"] <= pairs).all()
    assert (after["pairs_read"] <= after["pairs_needed"]).all()
    assert (after["accepted"] <= 512 * after["pairs_read"]).all()
    counts = {k: int(after[k].sum()) for k in ("accepted", "pairs_read")}
    t = roofline.blend_forward(counts, 80 * 56, "compact")
    assert t == pytest.approx(max(
        20 * counts["accepted"] / roofline.F32_FLOPS,
        (16 * counts["pairs_read"] + 16 * 80 * 56)
        / roofline.HBM_BYTES_PER_S))


def _imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and \
                node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(
    p for p in PKG.rglob("*.py") if "tests" not in p.parts),
    ids=lambda p: str(p.relative_to(PKG)))
def test_benchmark_imports_neither_jax_nor_gsrt(path):
    bad = _imports(path) & {"jax", "jaxlib", "flax", "gsrt"}
    assert not bad
    if "reference" in path.parts:
        assert "gsrt_torch" not in _imports(path)
