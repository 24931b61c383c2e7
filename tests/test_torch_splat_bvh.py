"""gsrt_torch's per-ray tree over a Gaussian cloud (`ops.splat_bvh`) and
the ray-traced frame (`GaussianRayTracer(cfg, "traced")`), on the CPU:
the tree's structure; the plain version and the kernel's walk in tensor
code against `trace_gaussian_rays` on rays from outside and inside the
cloud, rays that miss, per-ray windows, exact ties of t*, rays capped at
max_passes·k, rays of over KW hits (a walk's buffer replayed pass after
pass, then walked again), ties placed on a pass's end and on a buffer's
last entry, and clouds of one splat and of none; the traced mode and
the CLI; the benchmark's plain reference (`benchmark/reference/
splat_rt.py`) against `trace_gaussian_rays`; the triangle tree's node
records, which the splat tree's build shares, against the build they
were factored out of. On the card (marker gpu): the kernel against the
plain version and its five counters against the walk's.

Tolerances: the plain version, the walk and `trace_gaussian_rays` take
the same hits (the same response, rounded alike, and the same
composite), so hits and passes are equal and trans and colour within
1e-5. The kernel rounds the response as the plain version does on the
card, so hits are equal; it sums a pass's colours in slot order, so
colour and trans within 1e-4. The reference rounds rays and response as
the port does but evaluates SH its own way: hits equal, trans and colour
within 1e-5.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import pytest
import torch

import _torch_env  # noqa: F401
from benchmark import port, scene
from benchmark.reference import splat_rt
from gsrt_torch import RenderConfig, _kernels
from gsrt_torch.core.types import GaussianCloud
from gsrt_torch.models import gaussian_rt as t_rt
from gsrt_torch.ops import splat_bvh, tri_bvh, tri_kernel
from gsrt_torch.ops.bvh import build_lbvh, tree_depth
from gsrt_torch.ops.splat_clusters import splat_world_radius
from gsrt_torch.scene import random_cloud
from gsrt_torch.utils.profiling import TRACER

KINDS = ("outside", "inside", "miss", "t_max", "ties", "capped", "deep")
TOL = dict(rtol=0, atol=1e-5)
CFG = RenderConfig(width=32, height=24)


def cloud(n=600, seed=3, extent=1.0, scale_range=(0.03, 0.15),
          device="cpu") -> GaussianCloud:
    c, _ = random_cloud(n, seed=seed, extent=extent,
                        scale_range=scale_range, device=device)
    return c


def with_ties(c: GaussianCloud, seed=4) -> GaussianCloud:
    """The cloud with a third of its splats copied to later indices: a
    copy meets every ray at its original's t*."""
    rng = np.random.default_rng(seed)
    idx = torch.as_tensor(rng.choice(c.n, c.n // 3, replace=False))
    return GaussianCloud(*(torch.cat([t, t[idx]]) for t in c))


def splat_rays(kind: str, c: GaussianCloud, R: int = 96, seed: int = 1):
    """(origins, dirs, t_max) of one kind of ray for the cloud `c`:
    `outside`, from a sphere round the cloud at points inside its box;
    `inside`, from points inside it in every direction; `miss`, from
    outside, pointing away; `t_max`, as outside with per-ray windows that
    end inside the cloud. Unit directions but for a third of `inside`
    (scaled by 0.5 to 2: t is the ray parameter)."""
    rng = np.random.default_rng(seed)
    m = c.means.numpy().astype(np.float64)
    lo, hi = m.min(0), m.max(0)
    mid, size = 0.5 * (lo + hi), float((hi - lo).max())
    unit = lambda d: d / np.linalg.norm(d, axis=1, keepdims=True)  # noqa
    out = unit(rng.normal(size=(R, 3)))
    t_max = None
    if kind == "inside":
        o = rng.uniform(lo, hi, (R, 3))
        d = unit(rng.normal(size=(R, 3)))
        d[: R // 3] *= rng.uniform(0.5, 2.0, (R // 3, 1))
    elif kind == "miss":
        o = mid + 1.5 * size * out
        d = unit(out + 0.2 * rng.normal(size=(R, 3)))
    else:
        o = mid + 1.5 * size * out
        d = unit(rng.uniform(lo, hi, (R, 3)) - o)
        if kind == "t_max":
            t_max = torch.as_tensor(rng.uniform(1.0, 2.2, R) * size,
                                    dtype=torch.float32)
    f = lambda x: torch.as_tensor(x, dtype=torch.float32)  # noqa: E731
    return f(o), f(d), t_max


def case(kind: str):
    """(cloud, cfg, origins, dirs, t_max, colors) of a test kind: a ray
    kind of `splat_rays`, or `ties` (outside rays, a third of the splats
    copied), `capped` (outside rays through a dense cloud, max_passes 2),
    `deep` (outside rays through a dense cloud: over KW hits a ray)."""
    c = cloud()
    cfg = CFG
    if kind == "ties":
        c = with_ties(c)
    if kind == "capped":
        c = cloud(n=3000, scale_range=(0.1, 0.3))
        cfg = dataclasses.replace(CFG, max_passes=2)
    if kind == "deep":
        c = cloud(n=1200, scale_range=(0.05, 0.2))
    o, d, t_max = splat_rays("outside" if kind in ("ties", "capped", "deep")
                             else kind, c)
    colors = torch.abs(torch.sin(c.means * 5.0))
    return c, cfg, o, d, t_max, colors


def want_of(c, cfg, o, d, t_max, colors):
    return t_rt.trace_gaussian_rays(c, o, d, cfg, colors=colors,
                                    t_max=t_max)


@functools.cache
def walk_of(kind: str):
    """`walk_splat_bvh_plain` on the kind's case (computed once)."""
    c, cfg, o, d, t_max, colors = case(kind)
    tree = splat_bvh.build_splat_bvh(c, cfg)
    return splat_bvh.walk_splat_bvh_plain(tree, o, d, cfg, colors, t_max)


def assert_same(got, want, k, tol=TOL):
    trans, color, hits, passes = got[:4]
    assert torch.equal(hits, want[2])
    assert torch.equal(passes, -(-want[2] // k))
    np.testing.assert_allclose(trans.numpy(), want[0].numpy(), **tol)
    np.testing.assert_allclose(color.numpy(), want[1].numpy(), **tol)


def test_tree_structure():
    """Every splat above the threshold in exactly one slot, its record
    its own; padding slots at opacity 0 and index -1; each leaf's box
    holds its splats' spheres; every node's box holds its children's; the
    depth within the stack."""
    c = cloud()
    op = c.opacity.clone()
    op[::7] = CFG.alpha_threshold        # at the threshold: left out
    c = c._replace(opacity=op)
    tree = splat_bvh.build_splat_bvh(c, CFG)
    L, n = tree.n_leaves, tree.n_splats
    keep = (op > CFG.alpha_threshold).nonzero()[:, 0]
    assert n == keep.numel() and L == -(-n // splat_bvh.LEAF)
    rows = tree.slots.permute(1, 0, 2).reshape(splat_bvh.ROWS, -1)
    ids = rows[splat_bvh._ID].contiguous().view(torch.int32).long()
    assert torch.equal(torch.sort(ids[:n]).values, keep)
    assert bool((ids[n:] == -1).all()) and bool((rows[9, n:] == 0).all())
    assert torch.equal(rows[0:3, :n].T, c.means[ids[:n]])
    assert torch.equal(rows[9, :n], op[ids[:n]])
    kids = tree.nodes[:, 12:14].contiguous().view(torch.int32).long()
    leaves = ~kids[kids < 0]
    assert torch.equal(torch.sort(leaves).values, torch.arange(L))
    boxes = torch.stack([tree.nodes[:, [0, 2, 8, 1, 3, 9]],
                         tree.nodes[:, [4, 6, 10, 5, 7, 11]]], 1)
    leaf_box = torch.empty(L, 6)
    leaf_box[leaves] = boxes[kids < 0]
    r = splat_world_radius(c, CFG)[ids[:n]][:, None]
    box = leaf_box[torch.arange(n) // splat_bvh.LEAF]
    mu = c.means[ids[:n]]
    assert bool(((box[:, :3] <= mu - r) & (mu + r <= box[:, 3:])).all())
    node_box = torch.empty(L - 1, 6)
    node_box[0] = tree.root_box
    node_box[kids[kids >= 0]] = boxes[kids >= 0]
    for j in range(2):
        assert bool((node_box[:, :3] <= boxes[:, j, :3]).all())
        assert bool((boxes[:, j, 3:] <= node_box[:, 3:]).all())
    assert 1 < tree.depth == tree_depth(kids) <= splat_bvh.STACK


def test_a_tree_deeper_than_the_stack_raises(monkeypatch):
    c = cloud()
    depth = splat_bvh.build_splat_bvh(c, CFG).depth
    monkeypatch.setattr(splat_bvh, "STACK", depth - 1)
    with pytest.raises(ValueError, match="stack"):
        splat_bvh.build_splat_bvh(c, CFG)


@pytest.mark.parametrize("kind", KINDS)
def test_plain_matches_trace_gaussian_rays(kind):
    """The tree's plain version (what a CPU tensor runs) takes
    `trace_gaussian_rays`' hits and passes, its trans and colour."""
    c, cfg, o, d, t_max, colors = case(kind)
    tree = splat_bvh.build_splat_bvh(c, cfg)
    got = splat_bvh.trace_gaussian_rays_bvh(tree, o, d, cfg, colors, t_max)
    assert_same(got, want_of(c, cfg, o, d, t_max, colors), cfg.k)


@pytest.mark.parametrize("kind", KINDS)
def test_walk_matches_trace_gaussian_rays(kind):
    """The kernel's walk in tensor code finds every hit brute force
    finds: the padded boxes and the buffer's window skip no box that
    holds one of the KW nearest; ties go lowest index first and hits
    tied with a pass's last are dropped, as in the plain code; rays are
    capped at max_passes·k. Its counters: every pass blended either the
    first of a walk or a replay, and a walk more only where a ray's last
    walk found nothing (never at the cap, nor after a pass of under k);
    the hits blended, LEAF tests a leaf."""
    c, cfg, o, d, t_max, colors = case(kind)
    want = want_of(c, cfg, o, d, t_max, colors)
    got = walk_of(kind)
    assert_same(got, want, cfg.k)
    nodes, tests, walks, blended, replays = got[4].tolist()
    cap = cfg.max_passes * cfg.k
    passes = int(got[3].sum())
    can_end_empty = int(((want[2] < cap) & (want[2] % cfg.k == 0)).sum())
    assert blended == int(want[2].sum())
    assert passes <= walks + replays <= passes + can_end_empty
    assert tests % splat_bvh.LEAF == 0
    if kind == "miss":
        assert int(want[2].max()) == 0 and walks == o.shape[0]
    else:
        assert float(want[2].float().mean()) > 4
        assert walks < passes and replays > 0
    if kind == "capped":
        assert float((want[2] == cap).float().mean()) > 0.5
    if kind == "ties":
        assert tests > blended
    if kind == "deep":                  # buffers replayed, then re-walked
        assert float((want[2] > splat_bvh.KW).float().mean()) > 0.9
        assert walks > o.shape[0]


@pytest.mark.parametrize("kind", KINDS)
def test_walk_matches_plain(kind):
    """The replaying walk against the tree's plain version (brute force,
    a pass at a time): hits and passes equal, trans and colour within
    1e-5."""
    c, cfg, o, d, t_max, colors = case(kind)
    tree = splat_bvh.build_splat_bvh(c, cfg)
    want = splat_bvh.trace_gaussian_rays_bvh_plain(tree, o, d, cfg, colors,
                                                   t_max)
    got = walk_of(kind)
    assert torch.equal(got[3], want[3])
    assert_same(got, want, cfg.k)


@pytest.mark.parametrize("k", [splat_bvh.KW, splat_bvh.KW + 1])
def test_walk_takes_k_up_to_its_buffer(k):
    """As the kernel, the walk takes passes of up to KW hits: at k = KW
    a full buffer is one pass, and the ray walks again after it; a
    larger k raises."""
    c, cfg, o, d, t_max, colors = case("deep")
    cfg = dataclasses.replace(cfg, k=k)
    tree = splat_bvh.build_splat_bvh(c, cfg)
    if k > splat_bvh.KW:
        with pytest.raises(ValueError, match="buffer"):
            splat_bvh.walk_splat_bvh_plain(tree, o, d, cfg, colors, t_max)
        return
    got = splat_bvh.walk_splat_bvh_plain(tree, o, d, cfg, colors, t_max)
    assert_same(got, want_of(c, cfg, o, d, t_max, colors), k)
    walks, replays = got[4][[2, 4]].tolist()
    assert replays == 0 and walks >= int(got[3].sum())


LINE = 45     # splats on a tied line's ray


def tied_line(ties, seed=0):
    """(cloud, origins, dirs, colors): LINE small splats on the z axis at
    depths 0.1, 0.2, ... 4.5 from one ray's origin, in a seeded index
    order, and a copy of each splat whose depth rank is in `ties`, at
    later indices (a copy meets the ray at its original's t*)."""
    rank = torch.as_tensor(np.random.default_rng(seed).permutation(LINE))
    ties = torch.as_tensor(ties, dtype=torch.long)
    rank = torch.cat([rank, ties])
    n = rank.numel()
    means = torch.zeros((n, 3))
    means[:, 2] = 0.1 * (rank + 1).float()
    cov = torch.tensor([1.0, 0.0, 0.0, 1.0, 0.0, 1.0]) * 0.02 ** 2
    c = GaussianCloud(means, cov.expand(n, 6).clone(), torch.full((n,), 0.1),
                      torch.zeros((n, 1, 3)))
    colors = torch.rand((n, 3), generator=torch.Generator().manual_seed(seed))
    return (c, torch.zeros((1, 3)), torch.tensor([[0.0, 0.0, 1.0]]),
            colors)


# (depth ranks copied, hits, walks, replays) with k = 8 and KW = 32
TIED_LINES = [
    # the 8th hit's copy is the buffer's 9th entry: skipped at the first
    # pass's end; the fourth pass finds 7 entries left and walks again
    ((7,), 45, 2, 4),
    # the 32nd hit's copy falls off the first buffer, whose fourth pass
    # ends on the 32nd: the second walk starts at it and drops the copy
    ((31,), 45, 2, 4),
    # as the first, and the 31st hit's copy falls off the first buffer
    # behind its last entry: the second walk blends both in one pass
    ((7, 30), 46, 2, 4),
    # copies inside passes: both blended
    ((3, 12), 47, 2, 4),
]


@pytest.mark.parametrize("ties,hits,walks,replays", TIED_LINES)
def test_ties_on_pass_and_buffer_ends(ties, hits, walks, replays):
    """Ties of t* placed on a pass's end inside a walk's buffer and on
    the buffer's last entry: the walk blends what `trace_gaussian_rays`
    blends (a copy tied with a pass's last is dropped, one inside a pass
    is blended), with the walks and replays the replay rules give."""
    c, o, d, colors = tied_line(ties)
    cfg = CFG
    assert splat_bvh.KW == 32 and cfg.k == 8
    tree = splat_bvh.build_splat_bvh(c, cfg)
    want = t_rt.trace_gaussian_rays(c, o, d, cfg, colors=colors)
    got = splat_bvh.walk_splat_bvh_plain(tree, o, d, cfg, colors)
    assert_same(got, want, cfg.k)
    assert int(want[2][0]) == hits
    assert got[4][[2, 4]].tolist() == [walks, replays]


def test_ties_are_taken_lowest_index_first():
    """Two copies of one splat meet a ray at one t*: with k = 1 a pass
    takes the lower index and the front moves past both, so the ray
    blends one of them, as `trace_gaussian_rays` does."""
    c = cloud(n=40)
    c = GaussianCloud(*(torch.cat([t[:1], t]) for t in c))
    cfg = dataclasses.replace(CFG, k=1)
    mu = c.means[0]
    o = (mu + torch.tensor([0.0, 0.0, -3.0]))[None]
    d = torch.tensor([[0.0, 0.0, 1.0]])
    colors = torch.rand((c.n, 3), generator=torch.Generator().manual_seed(0))
    tree = splat_bvh.build_splat_bvh(c, cfg)
    want = t_rt.trace_gaussian_rays(c, o, d, cfg, colors=colors)
    for got in (splat_bvh.trace_gaussian_rays_bvh(tree, o, d, cfg, colors),
                splat_bvh.walk_splat_bvh_plain(tree, o, d, cfg, colors)):
        assert_same(got, want, cfg.k)
    solo = t_rt.trace_gaussian_rays(c._replace(opacity=torch.cat(
        [c.opacity[:1], torch.zeros(1), c.opacity[2:]])), o, d, cfg,
        colors=colors)
    np.testing.assert_allclose(want[1].numpy(), solo[1].numpy(), **TOL)


@pytest.mark.parametrize("n", [0, 1])
def test_clouds_of_one_and_no_splat(n):
    """One splat makes one leaf, paired with an empty one (the Karras
    tree needs two); no splat (or none above the threshold) makes an
    empty tree that no ray enters."""
    c = cloud(n=max(n, 1))
    if n == 0:
        c = GaussianCloud(*(t[:0] for t in c))
    o = torch.tensor([[0.0, 0.0, -3.0], [5.0, 5.0, -3.0]])
    d = torch.nn.functional.normalize(
        torch.cat([c.means[:1], torch.zeros((1, 3))])[:2] - o
        if n else torch.tensor([[0.0, 0.0, 1.0]] * 2), dim=1)
    colors = torch.ones((c.n, 3))
    tree = splat_bvh.build_splat_bvh(c, CFG)
    assert tree.n_leaves == 2 * n and tree.n_splats == n
    want = t_rt.trace_gaussian_rays(c, o, d, CFG, colors=colors)
    for got in (splat_bvh.trace_gaussian_rays_bvh(tree, o, d, CFG, colors),
                splat_bvh.walk_splat_bvh_plain(tree, o, d, CFG, colors)):
        assert_same(got, want, CFG.k)
    assert int(want[2].sum()) == n
    dim = splat_bvh.build_splat_bvh(c._replace(opacity=torch.full_like(
        c.opacity, CFG.alpha_threshold)), CFG)
    assert dim.n_leaves == 0
    got = splat_bvh.trace_gaussian_rays_bvh(dim, o, d, CFG, colors)
    assert int(got[2].sum()) == 0 and bool((got[0] == 1).all())


def test_traced_mode_matches_trace_gaussian_rays():
    """`GaussianRayTracer(cfg, "traced")`: one unit ray a pixel through
    the pixel centres `_pixel_grid` gives, SH seen from the eye; the tree
    built once for a cloud and again for a changed one; a white
    background adds the transmittance."""
    c, cam = random_cloud(800, seed=5, extent=1.0,
                          scale_range=(0.03, 0.15), width=24, height=16,
                          device="cpu")
    cfg = RenderConfig(width=24, height=16)
    rt = t_rt.GaussianRayTracer(cfg, "traced", device="cpu")
    out = rt(c, cam)
    tree = rt.splat_tree(c)
    assert rt.splat_tree(c) is tree
    o, d = t_rt.camera_rays(cam)
    assert torch.allclose(o[0], cam.position, atol=1e-5)
    np.testing.assert_allclose(d.norm(dim=1).numpy(), 1.0, atol=1e-6)
    pix = t_rt._pixel_grid(24, 16, "cpu")
    R = cam.view[:3, :3]
    cam_d = d @ R.T
    np.testing.assert_allclose((cam_d[:, :2] / cam_d[:, 2:]).numpy(),
                               ((pix - torch.stack([cam.cx, cam.cy]))
                                / torch.stack([cam.fx, cam.fy])).numpy(),
                               atol=1e-5)
    want = t_rt.trace_gaussian_rays(c, o, d, cfg, sh_origin=o[0])
    got = (out.trans.reshape(-1), out.color.reshape(-1, 3),
           out.hits.reshape(-1), out.passes.reshape(-1))
    assert_same(got, want, cfg.k)
    assert float(want[2].float().mean()) > 4
    c.opacity.mul_(0.5)                  # changed in place: built again
    assert rt.splat_tree(c) is not tree
    white = t_rt.GaussianRayTracer(
        dataclasses.replace(cfg, white_background=True), "traced",
        device="cpu")(c, cam)
    black = rt(c, cam)
    np.testing.assert_allclose(white.color.numpy(),
                               (black.color + black.trans[..., None])
                               .numpy(), **TOL)


def test_traced_mode_records_its_spans():
    """Under a recording profiler a traced frame's root `render.frame`
    holds `render.prepare`, `rt.build` (first frame only), `rt.rays`,
    `rt.colors` and `rt.trace`."""
    from torch.profiler import ProfilerActivity, profile
    c, cam = random_cloud(200, seed=6, extent=1.0, width=8, height=8,
                          device="cpu")
    rt = t_rt.GaussianRayTracer(RenderConfig(width=8, height=8), "traced",
                                device="cpu")
    TRACER.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        rt(c, cam)
        rt(c, cam)
    rep = TRACER.report()
    TRACER.reset()
    roots = [i for i, s in enumerate(rep) if s["root"] == i]
    assert [rep[i]["name"] for i in roots] == ["render.frame"] * 2
    names = [[s["name"] for s in rep if s["root"] == r and s["parent"] == r]
             for r in roots]
    assert names == [["render.prepare", "rt.build", "rt.rays", "rt.colors",
                      "rt.trace"],
                     ["render.prepare", "rt.rays", "rt.colors", "rt.trace"]]


def test_cli_render_traced(tmp_path, capsys):
    """`cli render --mode traced` writes the traced mode's frame and
    prints its throughput in Mrays/s."""
    from gsrt_torch import cli
    from gsrt_torch.utils.image import read_png, save_png
    out = str(tmp_path / "t.png")
    assert cli.main(["render", "--scene", "random2000", "--width", "12",
                     "--height", "8", "--mode", "traced", "--out", out,
                     "--device", "cpu"]) == 0
    assert "Mrays/s" in capsys.readouterr().out
    c, cam = random_cloud(2000, width=12, height=8, device="cpu")
    frame = t_rt.GaussianRayTracer(RenderConfig(width=12, height=8),
                                   "traced", device="cpu")(c, cam).color
    save_png(str(tmp_path / "w.png"), frame)
    assert np.array_equal(read_png(out), read_png(str(tmp_path / "w.png")))


def test_reference_matches_trace_gaussian_rays():
    """`benchmark/reference/splat_rt.py` at 2,000 splats and 64×48 (the
    benchmark's cloud and orbit camera) against `trace_gaussian_rays`
    through the port's rays: hits equal, trans and colour within 1e-5;
    the program's traced frame agrees as closely."""
    bc = scene.random_cloud(2000, 7, "cpu", extent=1.5,
                            scale_range=(0.02, 0.1), scene_seed=0)
    cov = scene.cov3d(bc.quats, bc.scales)
    view = scene.orbit((0.0, 0.0, 2.25), 4.0, [30.0], height=1.0,
                       fov_y_deg=40.0, width=64, height_px=48)[0]
    c, cam = port.cloud(bc, cov), port.camera(view, "cpu")
    cfg = RenderConfig(width=64, height=48)
    o, d = t_rt.camera_rays(cam)
    want = t_rt.trace_gaussian_rays(c, o, d, cfg, sh_origin=o[0])
    consts = splat_rt.constants(dataclasses.asdict(cfg))
    ref = splat_rt.trace(bc, cov, view, torch.arange(64 * 48), consts)
    assert torch.equal(ref["hits"], want[2].long())
    np.testing.assert_allclose(ref["trans"].numpy(), want[0].numpy(), **TOL)
    np.testing.assert_allclose(ref["color"].numpy(), want[1].numpy(), **TOL)
    assert float(want[2].float().mean()) > 8 and int(want[2].max()) > 4 * cfg.k
    frame = t_rt.GaussianRayTracer(cfg, "traced", device="cpu")(c, cam)
    assert torch.equal(frame.hits.reshape(-1).long(), ref["hits"])
    np.testing.assert_allclose(frame.color.reshape(-1, 3).numpy(),
                               ref["color"].numpy(), **TOL)


def _parent_tri_nodes(tt):
    """The triangle tree's node records as `build_tri_bvh` built them
    before the record build moved to `ops.bvh.node_records`."""
    lo, hi = tri_bvh._leaf_boxes(tt)
    pad = tri_bvh.BOX_PAD * float((hi.amax(0) - lo.amin(0)).amax())
    lo, hi = lo - pad, hi + pad
    n_leaves = lo.shape[0]
    ids = torch.arange(n_leaves, dtype=torch.int32, device=lo.device)
    if n_leaves == 1:
        lo, hi, ids = lo.expand(2, 3), hi.expand(2, 3), ids.expand(2)
    bvh = build_lbvh(lo, hi)
    leaf_id = ids[bvh.leaf_prim.long()]
    sides = []
    for child, is_leaf in ((bvh.left, bvh.left_leaf),
                           (bvh.right, bvh.right_leaf)):
        ch = child.long()
        ci = torch.clamp_max(ch, bvh.n_leaves - 2)
        leaf = is_leaf[:, None]
        sides.append((torch.where(leaf, bvh.leaf_min[ch], bvh.node_min[ci]),
                      torch.where(leaf, bvh.leaf_max[ch], bvh.node_max[ci]),
                      torch.where(is_leaf, ~leaf_id[ch], child)))
    (min0, max0, kid0), (min1, max1, kid1) = sides
    nodes = torch.stack(
        [min0[:, 0], max0[:, 0], min0[:, 1], max0[:, 1],
         min1[:, 0], max1[:, 0], min1[:, 1], max1[:, 1],
         min0[:, 2], max0[:, 2], min1[:, 2], max1[:, 2],
         kid0.view(torch.float32), kid1.view(torch.float32),
         torch.zeros_like(min0[:, 0]), torch.zeros_like(min0[:, 0])], 1)
    return nodes, torch.cat([bvh.node_min[0], bvh.node_max[0]])


@pytest.mark.parametrize("n", [3, 5000])
def test_tri_nodes_bit_equal_to_before(n):
    """`build_tri_bvh` through `ops.bvh.node_records` gives the node
    records and root box it gave before, bit for bit, on a seeded
    soup (of one leaf and of 1,250)."""
    from test_torch_tri_bvh import soup
    v = [torch.as_tensor(a[:n]) for a in soup()]
    tt = tri_kernel.build_tri_table(*v)
    got = tri_bvh.build_tri_bvh(tt)
    nodes, box = _parent_tri_nodes(tt)
    assert torch.equal(got.nodes.view(torch.int32), nodes.view(torch.int32))
    assert torch.equal(got.root_box.view(torch.int32), box.view(torch.int32))


# --- on the card ---

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the tree's kernel has no CPU mode")
    return torch.device("cuda")


def _on(dev, *xs):
    return [None if x is None else x.to(dev) for x in xs]


@pytest.mark.gpu
@pytest.mark.parametrize("kind", KINDS)
def test_kernel_matches_plain(cuda, kind):
    """The kernel against its plain version on the card: hits and passes
    equal, trans and colour within 1e-4; its five counters equal the
    walk's; one launch a call, the same outputs without counters."""
    c, cfg, o, d, t_max, colors = case(kind)
    c = c.to(cuda)
    o, d, t_max, colors = _on(cuda, o, d, t_max, colors)
    tree = splat_bvh.build_splat_bvh(c, cfg)
    counts = torch.zeros(5, dtype=torch.int64, device=cuda)
    before = _kernels.SPLAT_BVH.launches
    got = splat_bvh.trace_gaussian_rays_bvh(tree, o, d, cfg, colors, t_max,
                                            counts=counts)
    assert _kernels.SPLAT_BVH.launches == before + 1
    want = splat_bvh.trace_gaussian_rays_bvh_plain(tree, o, d, cfg, colors,
                                                   t_max)
    tol = dict(rtol=0, atol=1e-4)
    assert_same([x.cpu() for x in got],
                [x.cpu() for x in want[:3]], cfg.k, tol)
    assert torch.equal(got[3], want[3])
    walk = splat_bvh.walk_splat_bvh_plain(tree, o, d, cfg, colors, t_max)
    assert torch.equal(counts.cpu(), walk[4])
    again = splat_bvh.trace_gaussian_rays_bvh(tree, o, d, cfg, colors, t_max)
    for a, b in zip(again, got):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_kernel_at_a_larger_cloud(cuda):
    """20,000 splats, 4,096 rays from outside and inside: hits and passes
    equal to the plain version's, trans and colour within 1e-4; over 32
    hits a ray, so walks' buffers are replayed and rays walk again; the
    counters equal the walk's."""
    c = cloud(n=20_000, extent=2.0, scale_range=(0.01, 0.06))
    o1, d1, _ = splat_rays("outside", c, R=2048, seed=8)
    o2, d2, _ = splat_rays("inside", c, R=2048, seed=9)
    o, d = torch.cat([o1, o2]).to(cuda), torch.cat([d1, d2]).to(cuda)
    c = c.to(cuda)
    colors = torch.abs(torch.sin(c.means * 5.0))
    cfg = dataclasses.replace(CFG, splat_chunk=4096)
    tree = splat_bvh.build_splat_bvh(c, cfg)
    counts = torch.zeros(5, dtype=torch.int64, device=cuda)
    got = splat_bvh.trace_gaussian_rays_bvh(tree, o, d, cfg, colors,
                                            counts=counts)
    want = splat_bvh.trace_gaussian_rays_bvh_plain(tree, o, d, cfg, colors)
    assert torch.equal(got[2], want[2]) and torch.equal(got[3], want[3])
    for a, b in zip(got[:2], want[:2]):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-4)
    assert float(want[2].float().mean()) > 32
    walk = splat_bvh.walk_splat_bvh_plain(tree, o, d, cfg, colors)
    assert torch.equal(counts.cpu(), walk[4])
    walks, replays = int(counts[2]), int(counts[4])
    assert walks > o.shape[0] and 0 < replays and walks < int(got[3].sum())


@pytest.mark.gpu
@pytest.mark.parametrize("ties,hits,walks,replays", TIED_LINES)
def test_kernel_on_tied_lines(cuda, ties, hits, walks, replays):
    """The kernel on `tied_line`'s rays: the walk's hits, passes and
    counters; trans and colour within 1e-4."""
    c, o, d, colors = tied_line(ties)
    c, o, d, colors = c.to(cuda), *_on(cuda, o, d, colors)
    tree = splat_bvh.build_splat_bvh(c, CFG)
    counts = torch.zeros(5, dtype=torch.int64, device=cuda)
    got = splat_bvh.trace_gaussian_rays_bvh(tree, o, d, CFG, colors,
                                            counts=counts)
    walk = splat_bvh.walk_splat_bvh_plain(tree, o, d, CFG, colors)
    assert torch.equal(got[2], walk[2]) and torch.equal(got[3], walk[3])
    assert int(got[2][0]) == hits
    assert torch.equal(counts.cpu(), walk[4])
    assert counts[[2, 4]].tolist() == [walks, replays]
    for a, b in zip(got[:2], walk[:2]):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,n", [(torch.int64, 4), (torch.int32, 5)])
def test_kernel_rejects_counts_not_int64_of_5(cuda, dtype, n):
    c, cfg, o, d, t_max, colors = case("outside")
    tree = splat_bvh.build_splat_bvh(c.to(cuda), cfg)
    with pytest.raises(ValueError, match="int64 \\[5\\]"):
        splat_bvh.trace_gaussian_rays_bvh(
            tree, *_on(cuda, o, d), cfg, colors.to(cuda),
            counts=torch.zeros(n, dtype=dtype, device=cuda))


@pytest.mark.gpu
def test_traced_frame_counts_walks_and_replays(cuda):
    """A traced frame under a recording profiler: `rt.trace` carries the
    kernel's counters, `rt_replays` among them; each pass that blended
    is a walk's own or a replay."""
    from torch.profiler import ProfilerActivity, profile
    c, cam = random_cloud(3000, seed=6, extent=1.0, width=32, height=24,
                          device="cuda")
    rt = t_rt.GaussianRayTracer(RenderConfig(width=32, height=24), "traced",
                                device="cuda")
    rt(c, cam)
    TRACER.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        out = rt(c, cam)
    rep = TRACER.report()
    TRACER.reset()
    got = [s["counters"] for s in rep if s["name"] == "rt.trace"]
    assert len(got) == 1
    n = {k: int(v) for k, v in got[0].items()}
    assert set(n) == {"rt_rays", "rt_nodes", "rt_tests", "rt_passes",
                      "rt_hits", "rt_replays"}
    passes = int(out.passes.sum())
    assert n["rt_rays"] == 32 * 24 and n["rt_hits"] == int(out.hits.sum())
    assert passes <= n["rt_passes"] + n["rt_replays"] <= passes + 32 * 24
