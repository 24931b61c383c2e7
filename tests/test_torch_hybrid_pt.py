"""gsrt_torch's path tracer with splats traced through their per-ray tree
(`render_path_traced(gaussians=..., gauss_tree=...)`), on the CPU: a
small hybrid scene of the benchmark's generators (`benchmark/
hybrid_scene.py`: a mirror and a glass icosphere at subdivision 2 and a
ground quad, 642 triangles, inside 2,000 seeded splats) at 32×24 and 4
bounces, held against the benchmark's plain reference
(`benchmark/reference/hybrid_pt.py`) and against the brute-force
`gaussians=` route; retired and parked rays, which must cost the splat
walk nothing; the spans and counters. On the card (marker gpu): the
kernel route against the plain route on the hybrid waves, its counters
against the walk's, and a wave of retired rays that fetches no node.

Tolerances: the reference forms the camera rays as the program rounds
them and the response, passes and scatter as the plain versions do, so
bounce-0 triangles and splat hits are equal and colours agree within
1e-5 (measured: 1.1e-6; a pass's colours summed in another order). The
tree route on the CPU is the brute force over the tree's splats: within
1e-6 of the `gaussians=` route. The kernel sums a pass's colours in slot
order: within 1e-4 of the plain route, hits equal.
"""

from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

import _torch_env  # noqa: F401
from benchmark import hybrid_scene, port, scene
from benchmark.reference import hybrid_pt, pathtrace, splat_rt
from gsrt_torch import RenderConfig
from gsrt_torch.interop import scene_from_numpy
from gsrt_torch.models import path_tracer as t_pt
from gsrt_torch.ops import splat_bvh
from gsrt_torch.ops.bvh import slab
from gsrt_torch.utils.profiling import TRACER

W, H, BOUNCES, SEED = 32, 24, 4, 11
MESHES = dict(subdivision=2,
              mirror=dict(center=[-2.0, 0.0, 6.0], radius=1.5,
                          albedo=[0.9, 0.9, 0.9], fuzz=0.0),
              glass=dict(center=[2.0, 0.0, 6.0], radius=1.5, ior=1.5),
              ground=dict(y=-4.5, x=[-20.0, 20.0], z=[-14.0, 26.0],
                          albedo=[0.5, 0.5, 0.5]))
RENDER = dict(k=8, g_cutoff=5.6, alpha_threshold=1.0 / 255.0, max_passes=64,
              init_depth=1e4, t_min=1e-3, t_max=1e4)


def build(device="cpu"):
    """(mesh scene, cloud, Σ, view, port scene, port cloud, tree, camera,
    config) of the small hybrid scene."""
    s = hybrid_scene.build(MESHES)
    cloud = scene.random_cloud(2000, 5, device, extent=4.0,
                               scale_range=(0.1, 0.4),
                               opacity_range=(0.2, 0.95), scene_seed=0)
    cov = scene.cov3d(cloud.quats, cloud.scales)
    view = scene.orbit((0.0, 0.0, 6.0), 10.0, [30.0], height=2.0,
                       fov_y_deg=40.0, width=W, height_px=H)[0]
    cfg = RenderConfig(width=W, height=H, samples=1, bounces=BOUNCES,
                       has_sky=True, gamma_correction=False)
    ps = t_pt.with_tri_table(scene_from_numpy(s.fields(), device=device))
    pc = port.cloud(cloud, cov)
    return dict(s=s, cloud=cloud, cov=cov, view=view, ps=ps, pc=pc,
                tree=splat_bvh.build_splat_bvh(pc, cfg),
                cam=port.camera(view, device), cfg=cfg)


@functools.cache
def small():
    return build()


def render(h, **kw):
    ids, hits = [], []
    img, flags = t_pt.render_path_traced(
        h["ps"], h["cam"], h["cfg"], seed=SEED, gaussians=h["pc"],
        return_flags=True, primary_ids=ids, primary_splat_hits=hits, **kw)
    assert not any(bool(v) for v in flags.values())
    return img.reshape(-1, 3), ids[0].reshape(-1), hits[0].reshape(-1)


def reference(h, pixels, **kw):
    consts = splat_rt.constants(RENDER)
    s = h["s"]
    sc = pathtrace.make_scene(s.v0, s.v1, s.v2, s.mat, s.materials,
                              h["cloud"].means.device)
    sp = hybrid_pt.splats(h["cloud"], h["cov"], h["view"], consts)
    return hybrid_pt.trace(sc, sp, h["view"], SEED, pixels,
                           bounces=BOUNCES, t_min=RENDER["t_min"],
                           t_max=RENDER["t_max"], consts=consts, **kw)


@functools.cache
def full_reference():
    return reference(small(), torch.arange(W * H))


def test_scene_has_its_triangles_and_materials():
    s = small()["s"]
    assert s.n == 2 * 20 * 4 ** 2 + 2
    assert hybrid_scene.build(dict(MESHES, subdivision=6)).n == 163_842
    assert s.materials["model"].tolist() == [
        hybrid_scene.LAMBERTIAN, hybrid_scene.METALLIC,
        hybrid_scene.DIELECTRIC]
    ball = hybrid_scene.icosphere(3)
    np.testing.assert_allclose(np.linalg.norm(ball, axis=-1), 1.0,
                               atol=1e-12)


@pytest.mark.parametrize("sort", [True, False], ids=["sorted", "unsorted"])
@pytest.mark.parametrize("impl", ["binned", "block"])
def test_tree_route_matches_reference(impl, sort):
    """Every pixel: bounce-0 triangles and splat hits equal, colour within
    1e-5; bounce 0 sees the ground, the mirror and the glass, and paths
    go on past them."""
    h = small()
    got, ids, hits = render(h, gauss_tree=h["tree"], primary_impl=impl,
                            sort_bounces=sort)
    want = full_reference()
    assert torch.equal(ids, want["primary"])
    assert torch.equal(hits.long(), want["hits"])
    np.testing.assert_allclose(got.numpy(), want["color"].numpy(), rtol=0,
                               atol=1e-5)
    seen = h["s"].mat[want["primary"][want["primary"] >= 0].numpy()]
    assert set(seen.tolist()) == {0, 1, 2}
    assert float(want["hits"].float().mean()) > 10
    assert float(want["segments"].float().mean()) > 1.5


def test_reference_subset_equals_its_full_trace():
    pix = torch.as_tensor(np.sort(np.random.default_rng(4).choice(
        W * H, 200, replace=False)))
    sub, full = reference(small(), pix), full_reference()
    for k in ("color", "primary", "hits", "splat_hits", "segments"):
        assert torch.equal(sub[k], full[k][pix]), k


def test_tree_route_matches_brute_force():
    """The tree route against the `gaussians=` route (every splat against
    every ray each pass), sorted and binned as the cell runs."""
    h = small()
    got = render(h, gauss_tree=h["tree"], primary_impl="binned")
    want = render(h, primary_impl="binned")
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=1e-6)
    assert torch.equal(got[1], want[1])
    assert torch.equal(got[2], want[2])


def test_gauss_tree_needs_the_gaussians():
    h = small()
    with pytest.raises(ValueError, match="gauss_tree"):
        t_pt.render_path_traced(h["ps"], h["cam"], h["cfg"],
                                gauss_tree=h["tree"])


def _wave(h, R=256, seed=3):
    """(o, d, t, hit) of rays from inside the cloud in every direction,
    half of them stopped at t in (0.5, 3)."""
    rng = np.random.default_rng(seed)
    o = rng.uniform((-3.0, -3.0, 3.0), (3.0, 3.0, 9.0), (R, 3))
    d = rng.normal(size=(R, 3))
    t = rng.uniform(0.5, 3.0, R)
    f = lambda x: torch.as_tensor(x, dtype=torch.float32)  # noqa: E731
    return f(o), f(d), f(t), torch.as_tensor(rng.random(R) < 0.5)


def test_retired_rays_add_nothing():
    """A wave's splat segment through the tree: rays not live blend
    nothing, whatever their position; the live ones get what a wave of
    live rays alone gives them, windowed at their hits (fewer hits than
    the same rays unstopped)."""
    h = small()
    o, d, t, hit = _wave(h)
    live = torch.as_tensor(np.random.default_rng(5).random(len(t)) < 0.6)
    seg = functools.partial(t_pt._splat_segment, h["cfg"], gaussians=h["pc"],
                            gauss_tree=h["tree"],
                            colors=torch.rand(h["pc"].n, 3))
    trans, color, hits, ovf = seg(o, d, t, hit, live)
    assert not bool(ovf)
    assert bool((trans[~live] == 1).all()) and bool((color[~live] == 0).all())
    assert int(hits[~live].sum()) == 0
    alone = seg(o[live], d[live], t[live], hit[live],
                torch.ones(int(live.sum()), dtype=torch.bool))
    for a, b in zip((trans, color, hits), alone[:3]):
        assert torch.equal(a[live], b)
    unstopped = seg(o, d, t, torch.zeros_like(hit), live)[2]
    assert bool((hits <= unstopped).all())
    assert bool((hits[live & hit] < unstopped[live & hit]).any())
    assert torch.equal(hits[live & ~hit], unstopped[live & ~hit])


def test_empty_windows_make_no_walk():
    """The kernel's walk in tensor code (its counters the kernel's): rays
    whose window is empty (t_max −inf, as the path tracer gives retired
    rays, or under t_min) make no walk and fetch no node record; the
    others walk as before."""
    h = small()
    o, d, t, _ = _wave(h, R=64)
    cfg, colors = h["cfg"], torch.rand(h["pc"].n, 3)
    full = splat_bvh.walk_splat_bvh_plain(h["tree"], o, d, cfg, colors, t)
    empty = torch.where(torch.arange(64) % 2 == 0, torch.tensor(-np.inf),
                        torch.tensor(cfg.t_min * 0.5))
    none = splat_bvh.walk_splat_bvh_plain(h["tree"], o, d, cfg, colors,
                                          empty)
    assert none[4].tolist() == [0, 0, 0, 0, 0]
    assert bool((none[0] == 1).all()) and int(none[2].sum()) == 0
    assert int(full[4][0]) > 0 and int(full[4][2]) >= 64


def test_parked_rays_lie_outside_the_tree():
    """With a splat tree the sort bounds hold its root box, so a parked
    ray starts outside it, heads away from it and misses its root even
    with a window as long as the scene's."""
    h = small()
    tree = h["tree"]
    lo, hi, park_o, park_d = t_pt._scene_sort_bounds(h["ps"],
                                                     gauss_tree=tree)
    rb = tree.root_box
    assert bool((lo <= rb[:3]).all()) and bool((hi >= rb[3:]).all())
    assert bool((park_o > rb[3:]).all()) and bool((park_d > 0).all())
    root = rb[[0, 3, 1, 4, 2, 5]]
    entered, _ = slab(root, (*park_o.tolist(), h["cfg"].t_min),
                      [1.0 / float(c) for c in park_d], h["cfg"].t_max)
    assert not bool(entered)
    o = park_o.expand(8, 3).contiguous()
    d = park_d.expand(8, 3).contiguous()
    walk = splat_bvh.walk_splat_bvh_plain(tree, o, d, h["cfg"],
                                          torch.rand(h["pc"].n, 3))
    assert int(walk[4][0]) == 0


def test_spans_and_counters():
    """Under a recording profiler a hybrid frame's root `pt.frame` holds
    `pt.colors` once and a `pt.splats` a wave, beside (not inside)
    `pt.primary` and `pt.traverse`; each `pt.splats` counts the wave's
    live rays as `splat_rays`. A frame without splats has neither."""
    from torch.profiler import ProfilerActivity, profile
    h = small()
    TRACER.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        t_pt.render_path_traced(h["ps"], h["cam"], h["cfg"], seed=SEED,
                                gaussians=h["pc"], gauss_tree=h["tree"],
                                primary_impl="binned")
        t_pt.render_path_traced(h["ps"], h["cam"], h["cfg"], seed=SEED,
                                primary_impl="binned")
    rep = TRACER.report()
    TRACER.reset()
    roots = [i for i, s in enumerate(rep) if s["root"] == i]
    assert [rep[i]["name"] for i in roots] == ["pt.frame"] * 2
    kids = [[s for s in rep if s["root"] == r and s["parent"] == r]
            for r in roots]
    names = [[s["name"] for s in k] for k in kids]
    assert names[0].count("pt.colors") == 1
    assert names[0].count("pt.splats") == BOUNCES
    assert names[0].index("pt.splats") == names[0].index("pt.primary") + 1
    assert "pt.splats" not in names[1] and "pt.colors" not in names[1]
    splat_rays = [s["counters"]["splat_rays"] for s in kids[0]
                  if s["name"] == "pt.splats"]
    assert splat_rays[0] == W * H
    assert sum(splat_rays) == rep[roots[0]]["counters"]["live_rays"]
    assert all(set(s["counters"]) == {"splat_rays"} for s in kids[0]
               if s["name"] == "pt.splats")


# --- on the card ---

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the tree's kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
def test_kernel_route_matches_plain_route(cuda, monkeypatch):
    """The hybrid frame on the card with the kernel against the same
    frame with the plain version in its place: bounce-0 splat hits equal,
    colour within 1e-4; on every wave of the frame (camera rays, rays
    leaving the mirror, the glass and the ground from inside the cloud,
    retired and parked rays) the kernel's hits equal the plain version's
    and its five counters the walk's."""
    h = build(cuda)
    waves = []
    kernel = splat_bvh.trace_gaussian_rays_bvh

    def keep(tree, o, d, cfg, colors, t_max=None, counts=None):
        waves.append((o.clone(), d.clone(), t_max.clone(), colors))
        return kernel(tree, o, d, cfg, colors, t_max, counts=counts)
    monkeypatch.setattr(splat_bvh, "trace_gaussian_rays_bvh", keep)
    got = render(h, gauss_tree=h["tree"], primary_impl="binned")
    assert len(waves) == BOUNCES
    monkeypatch.setattr(
        splat_bvh, "trace_gaussian_rays_bvh",
        lambda tree, o, d, cfg, colors, t_max=None, counts=None:
        splat_bvh.trace_gaussian_rays_bvh_plain(tree, o, d, cfg, colors,
                                                t_max))
    want = render(h, gauss_tree=h["tree"], primary_impl="binned")
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=1e-4)
    retired = 0
    for o, d, t_max, colors in waves:
        counts = torch.zeros(5, dtype=torch.int64, device=cuda)
        k = kernel(h["tree"], o, d, h["cfg"], colors, t_max, counts=counts)
        walk = splat_bvh.walk_splat_bvh_plain(h["tree"], o, d, h["cfg"],
                                              colors, t_max)
        assert torch.equal(k[2], walk[2]) and torch.equal(k[3], walk[3])
        assert torch.equal(counts.cpu(), walk[4])
        retired += int((t_max == -np.inf).sum())
    assert retired > 0


@pytest.mark.gpu
def test_a_wave_of_retired_rays_fetches_no_node(cuda):
    """A wave whose rays are all retired, from inside the cloud: one
    launch, and the `pt.splats` counters read no node record and no walk;
    every ray blends nothing."""
    from torch.profiler import ProfilerActivity, profile
    from gsrt_torch import _kernels
    h = build(cuda)
    o, d, t, hit = (x.to(cuda) for x in _wave(h))
    colors = torch.rand(h["pc"].n, 3, device=cuda)
    before = _kernels.SPLAT_BVH.launches
    TRACER.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        with TRACER.span("pt.frame", root=True):
            trans, color, hits, _ = t_pt._splat_segment(
                h["cfg"], o, d, t, hit, torch.zeros_like(hit),
                gaussians=h["pc"], gauss_tree=h["tree"], colors=colors)
    rep = TRACER.report()
    TRACER.reset()
    assert _kernels.SPLAT_BVH.launches == before + 1
    (c,) = [s["counters"] for s in rep if s["name"] == "pt.splats"]
    assert c == dict(splat_rays=0, splat_nodes=0, splat_tests=0,
                     splat_walks=0, splat_hits=0, splat_replays=0)
    assert bool((trans == 1).all()) and int(hits.sum()) == 0
