"""gsrt_torch's per-ray tree over the triangle table (`ops.tri_bvh`) on
the CPU: the tree's structure; the plain version against Möller–Trumbore
brute force over the scene's own triangles and against the block
traversal's plain version; the kernel's walk in tensor code against the
plain version on rays that test the build's padding (grazing the room's
axis-aligned grids and its smallest triangles, aimed at shared edges and
corners, parked outside the scene, per-ray windows, zero direction
components); and which waves of the path tracer take the tree.

Tolerances: the plain version, the walk and the kernel round
Möller–Trumbore alike, so they agree bit for bit in t and slot, but for
rays that meet a triangle within 1e-5 of parallel, where its rounding
may accept a hit that no padded box holds (at most 0.2% of the rays
grazing the smallest triangles); against
brute force over the scene's triangles t agrees bit for bit and the
triangle wherever its t is unique. The block traversal keeps the first
of equal t it meets and skips what its unpadded cluster boxes miss: at
most 0.01% of rays may differ, each a tie or a nearer hit here.
"""

from __future__ import annotations

import unittest.mock as mock

import numpy as np
import pytest
import torch

import _torch_env  # noqa: F401
from benchmark import port, tri_scene
from gsrt_torch import RenderConfig
from gsrt_torch.interop import scene_from_numpy
from gsrt_torch.models import path_tracer as t_pt
from gsrt_torch.ops import tri_bvh, tri_kernel
from gsrt_torch.ops.bvh import tree_depth

N_ROOM = 3000
RAYS = 2500
KINDS = ("random", "grazing", "edges", "parked", "t_min", "axis",
         "fixtures")
NEAR_PARALLEL = 1e-5   # |cos| of a ray to a triangle that rounding rules


def soup(n=5000, seed=6, spread=3.0, size=0.2):
    rng = np.random.default_rng(seed)
    c = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    return (c, c + rng.normal(0, size, (n, 3)).astype(np.float32),
            c + rng.normal(0, size, (n, 3)).astype(np.float32))


def room_scene(n=N_ROOM, device="cpu"):
    """(generator scene, port scene with its table and tree)."""
    s = tri_scene.build(n, 64, 48)
    return s, t_pt.with_tri_table(scene_from_numpy(s.fields(),
                                                   device=device))


def bvh_rays(kind: str, verts, R: int = RAYS, seed: int = 1,
             device="cpu"):
    """(orig, dirn, t_min, t_max) of one kind of ray inside the box of
    the triangles `verts` (three [N, 3] arrays): `random` origins and
    directions; `grazing` from on or just off a face of the scene's box,
    all but parallel to it (the room's walls); `edges` aimed at corners,
    edge midpoints and quarter points of random triangles; `parked`, half
    of them parked outside the scene as the path tracer parks retired
    rays; `t_min` with per-ray windows; `axis` along and across the axes,
    with exactly zero direction components; `fixtures` grazing the
    smallest tenth of the triangles (the room's fixtures), 1e-7 to 1e-1
    rad off their planes, aimed at points inside, on or just off their
    edges from 0.01 to 3 away."""
    rng = np.random.default_rng(seed)
    V = np.stack(verts, 1).astype(np.float64)             # [N, 3, 3]
    lo, hi = V.min((0, 1)), V.max((0, 1))
    unit = lambda d: d / np.linalg.norm(d, axis=1, keepdims=True)  # noqa
    o = rng.uniform(lo, hi, (R, 3))
    d = unit(rng.normal(size=(R, 3)))
    t_min, t_max = 1e-3, 1e4
    if kind == "grazing":
        ax, side = rng.integers(0, 3, R), rng.integers(0, 2, R)
        i = np.arange(R)
        off = rng.choice([0.0, 1e-3, 1e-2], R)
        o[i, ax] = np.where(side, hi[ax] - off, lo[ax] + off)
        d = rng.normal(size=(R, 3))
        d[i, ax] = np.where(side, 1, -1) * 10.0 ** rng.uniform(-6, -1, R)
        d = unit(d)
    elif kind == "edges":
        tri = rng.integers(0, V.shape[0], R)
        a = rng.integers(0, 3, R)
        b = (a + rng.integers(1, 3, R)) % 3
        w = rng.choice([0.0, 0.5, 0.25], R)[:, None]
        d = unit(V[tri, a] * (1 - w) + V[tri, b] * w - o)
    elif kind == "parked":
        park = rng.random(R) < 0.5
        o[park] = hi + (hi - lo) + 1.0
        d[park] = 1.0 / np.sqrt(3.0)
    elif kind == "t_min":
        t_min = rng.uniform(0.0, 1.0, (R, 1))
        t_max = t_min[:, 0] + rng.uniform(0.05, 3.0, R)
    elif kind == "fixtures":
        e1, e2 = V[:, 1] - V[:, 0], V[:, 2] - V[:, 0]
        size = np.maximum(np.linalg.norm(e1, axis=1),
                          np.linalg.norm(e2, axis=1))
        tri = rng.choice(np.argsort(size)[:max(1, V.shape[0] // 10)], R)
        n = unit(np.cross(e1[tri], e2[tri]))
        w = rng.dirichlet([1.0, 1.0, 1.0], R)
        on = rng.random(R) < 0.6
        w[on, rng.integers(0, 3, R)[on]] = rng.choice(
            [0.0, 1e-7, -1e-7, 1e-5], int(on.sum()))
        p = np.einsum("rk,rkd->rd", w / w.sum(1, keepdims=True), V[tri])
        a = rng.normal(size=(R, 3))
        a = unit(a - (a * n).sum(1, keepdims=True) * n)
        ang = 10.0 ** rng.uniform(-7, -1, R) * rng.choice([-1, 1], R)
        d = a * np.cos(ang)[:, None] + n * np.sin(ang)[:, None]
        o = p - 10.0 ** rng.uniform(-2, 0.5, R)[:, None] * d
    elif kind == "axis":
        d = np.zeros((R, 3))
        ax = rng.integers(0, 3, R)
        d[np.arange(R), ax] = rng.choice([-1.0, 1.0], R)
        two = rng.random(R) < 0.5
        d[two, (ax[two] + 1) % 3] = 0.75
        d = unit(d)
    f = lambda x: torch.as_tensor(np.asarray(x, np.float32),  # noqa: E731
                                  device=device)
    return (f(o), f(d), t_min if np.isscalar(t_min) else f(t_min),
            t_max if np.isscalar(t_max) else f(t_max))


@pytest.fixture(scope="module")
def room():
    return room_scene()


@pytest.fixture(scope="module")
def soup_table():
    v = soup()
    tt = tri_kernel.build_tri_table(*map(torch.as_tensor, v))
    return v, tt._replace(bvh=tri_bvh.build_tri_bvh(tt))


def _tables(room, soup_table):
    s, ps = room
    return {"room": ((s.v0, s.v1, s.v2), ps.tri_table), "soup": soup_table}


@pytest.mark.parametrize("scene", ["room", "soup"])
def test_tree_structure(room, soup_table, scene):
    """Every real slot in exactly one leaf; each leaf's box holds its
    triangles as the table holds them; every node's box holds its
    children's; the depth within the stack."""
    _, tt = _tables(room, soup_table)[scene]
    bvh = tt.bvh
    n, L = tt.n_tris, bvh.n_leaves
    assert L == -(-n // tri_bvh.LEAF) and bvh.nodes.shape == (L - 1, 16)
    kids = bvh.nodes[:, 12:14].contiguous().view(torch.int32).long()
    leaves = ~kids[kids < 0]
    assert torch.equal(torch.sort(leaves).values, torch.arange(L))
    inner = kids[kids >= 0]
    assert torch.equal(torch.sort(inner).values, torch.arange(1, L - 1))
    boxes = torch.stack([bvh.nodes[:, [0, 2, 8, 1, 3, 9]],
                         bvh.nodes[:, [4, 6, 10, 5, 7, 11]]], 1)
    # a leaf's box against its real triangles' corners
    leaf_box = torch.empty(L, 6)
    leaf_box[leaves] = boxes[kids < 0]
    rows = tt.table.permute(1, 0, 2).reshape(9, -1)[:, :n]
    v0 = rows[0:3].T
    for corner in (v0, v0 + rows[3:6].T, v0 + rows[6:9].T):
        box = leaf_box[torch.arange(n) // tri_bvh.LEAF]
        assert bool(((box[:, :3] <= corner) & (corner <= box[:, 3:])).all())
    # a node's box (in its parent's record, or the root's) holds both
    # children's
    node_box = torch.empty(L - 1, 6)
    node_box[0] = bvh.root_box
    node_box[inner] = boxes[kids >= 0]
    for j in range(2):
        assert bool((node_box[:, :3] <= boxes[:, j, :3]).all())
        assert bool((boxes[:, j, 3:] <= node_box[:, 3:]).all())
    assert 1 < bvh.depth <= tri_bvh.STACK
    assert bvh.depth == tree_depth(kids)


def test_a_tree_deeper_than_the_stack_raises(soup_table, monkeypatch):
    _, tt = soup_table
    monkeypatch.setattr(tri_bvh, "STACK", tt.bvh.depth - 1)
    with pytest.raises(ValueError, match="stack"):
        tri_bvh.build_tri_bvh(tt)


def test_one_leaf(soup_table):
    """Three triangles make one leaf, which the tree tests twice."""
    v = [torch.as_tensor(a[:3]) for a in soup_table[0]]
    tt = tri_kernel.build_tri_table(*v)
    tt = tt._replace(bvh=tri_bvh.build_tri_bvh(tt))
    assert tt.bvh.n_leaves == 1 and tt.bvh.nodes.shape[0] == 1
    c = (v[0] + v[1] + v[2]) / 3
    o = c + torch.tensor([0.0, 0.0, -5.0])
    d = torch.nn.functional.normalize(c - o, dim=1)
    want = tri_bvh.closest_hit_bvh_plain(tt, o, d, 1e-3, 1e4)
    t, slot, counts = tri_bvh.walk_bvh_plain(tt, o, d, 1e-3, 1e4)
    assert torch.equal(t, want[0]) and torch.equal(slot, want[1])
    assert bool(want[2].all())


@pytest.mark.parametrize("scene", ["room", "soup"])
def test_plain_matches_brute_force_mt(room, soup_table, scene):
    """closest_hit_bvh_plain against `_mt` over the scene's triangles in
    their own order: t bit for bit, the triangle wherever t is unique."""
    verts, tt = _tables(room, soup_table)[scene]
    o, d, _, _ = bvh_rays("random", verts, R=600, seed=2)
    t, slot, hit = tri_bvh.closest_hit_bvh_plain(tt, o, d, 1e-3, 1e4)
    v0, v1, v2 = (torch.as_tensor(a) for a in verts)
    g = torch.cat([v0, v1 - v0, v2 - v0], 1).T[None]         # [1, 9, N]
    ray = [x[:, None] for x in (*o.T, *d.T)]
    all_t = tri_kernel._mt(*ray, torch.tensor(1e-3), torch.tensor(1e4), g)
    want, tri = all_t.min(-1)
    assert torch.equal(t.view(torch.int32), want.view(torch.int32))
    unique = (all_t == want[:, None]).sum(-1) == 1
    got = tt.order[slot.long()].long()
    assert torch.equal(got[hit & unique], tri[hit & unique])
    assert 0.3 < hit.float().mean() and unique[hit].float().mean() > 0.99


def differ_near_parallel(tt, dirn, got, want) -> int:
    """The rays whose (t, slot) in `got` differ from brute force's
    `want`. Each must be a hit the tree skipped (got's t the farther) on a
    triangle that the ray meets within NEAR_PARALLEL of parallel, where
    Möller–Trumbore's u, v and t have lost their precision and may accept
    a hit outside any finite padding of the leaf boxes."""
    bad = (got[0].view(torch.int32) != want[0].view(torch.int32)) | \
        (got[1] != want[1])
    rows = tt.table.permute(1, 0, 2).reshape(tri_kernel.GEOM, -1)
    g = rows[:, want[1][bad].long()].double()
    n = torch.nn.functional.normalize(
        torch.linalg.cross(g[3:6].T, g[6:9].T), dim=1)
    d = torch.nn.functional.normalize(dirn[bad].double(), dim=1)
    cos = (n * d).sum(1).abs()
    assert bool((got[0][bad] > want[0][bad]).all())
    assert bool((cos <= NEAR_PARALLEL).all()), f"|cos| {cos.tolist()}"
    return int(bad.sum())


@pytest.mark.parametrize("pairs", [1 << 10, 1 << 24])
def test_plain_does_not_depend_on_the_batch(room, monkeypatch, pairs):
    """The CPU's batch of (ray, slot) products, smaller or larger than a
    ray's row, gives the same (t, slot) bit for bit."""
    s, ps = room
    tt = ps.tri_table
    o, d, t_min, t_max = bvh_rays("t_min", (s.v0, s.v1, s.v2), R=300)
    want = tri_bvh.closest_hit_bvh_plain(tt, o, d, t_min, t_max)
    monkeypatch.setattr(tri_bvh, "CPU_PAIRS", pairs)
    got = tri_bvh.closest_hit_bvh_plain(tt, o, d, t_min, t_max)
    assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
    assert torch.equal(got[1], want[1]) and bool(want[2].any())


@pytest.mark.parametrize("kind", KINDS)
def test_walk_matches_plain(room, kind):
    """The kernel's walk takes the brute force's (t, slot) bit for bit:
    the padded boxes skip no box that holds the nearest hit; rays outside
    the scene leave at the root. Rays grazing the smallest triangles may
    differ where a triangle lies within NEAR_PARALLEL of parallel to them
    (measured: 8 of 20,000 rays over 8 seeds, |cos| up to 2.1e-6), at
    most 0.2% of them."""
    s, ps = room
    tt = ps.tri_table
    o, d, t_min, t_max = bvh_rays(kind, (s.v0, s.v1, s.v2))
    want = tri_bvh.closest_hit_bvh_plain(tt, o, d, t_min, t_max)
    t, slot, counts = tri_bvh.walk_bvh_plain(tt, o, d, t_min, t_max)
    n_bad = differ_near_parallel(tt, d, (t, slot), want)
    assert n_bad <= (2e-3 * RAYS if kind == "fixtures" else 0), \
        f"{n_bad} rays differ"
    nodes, tests, entered = counts.tolist()
    assert 0 < entered <= RAYS and nodes >= entered
    assert tests % tri_bvh.LEAF == 0
    assert nodes < 100 * entered and tests < 100 * entered
    if kind == "parked":
        assert entered < 0.6 * RAYS


def test_plain_against_block_traversal(soup_table):
    """The per-ray tree and the block traversal's plain version on the
    soup: equal but for ties and the hits the block walk's unpadded
    cluster boxes skip, at most 0.01% of rays."""
    verts, tt = soup_table
    o, d, _, _ = bvh_rays("random", verts, R=6_000, seed=3)
    t, slot, hit = tri_bvh.closest_hit_bvh_plain(tt, o, d, 1e-3, 1e4)
    tq, sq, hq, _ = tri_kernel.closest_hit_packed_plain(tt, o, d, 1e-3, 1e4)
    assert bool((t <= tq).all())
    differ = (t != tq) | (slot != sq)
    tie = (t == tq) & (slot < sq)
    nearer = t < tq
    assert bool((~differ | tie | nearer).all())
    assert int(differ.sum()) <= 1e-4 * o.shape[0]
    assert hit.float().mean() > 0.3


def test_waves_after_bounce_0_walk_the_tree(room):
    """In a path-traced frame bounce 0 keeps the block traversal
    ("block") or the binned cast, and every later wave walks the tree;
    the flags keep `tri_visits_overflow`."""
    s, ps = room
    cfg = RenderConfig(width=16, height=12, samples=1, bounces=3,
                       has_sky=False, gamma_correction=False)
    cam = port.camera(s.view, "cpu")
    calls = {"bvh": 0, "packed": 0}

    def counted(name, fn):
        def f(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return f
    with mock.patch.object(tri_bvh, "closest_hit_bvh",
                           counted("bvh", tri_bvh.closest_hit_bvh)), \
            mock.patch.object(tri_kernel, "closest_hit_packed",
                              counted("packed",
                                      tri_kernel.closest_hit_packed)):
        _, flags = t_pt.render_path_traced(ps, cam, cfg, seed=3,
                                           primary_impl="block",
                                           return_flags=True)
    assert calls == {"bvh": 2, "packed": 1}
    assert set(flags) == {"tri_visits_overflow", "gauss_visits_overflow",
                          "binned_pairs_overflow"}
    assert not any(bool(v) for v in flags.values())


def test_per_ray_takes_closest_hits_only(room):
    o, d, _, _ = bvh_rays("random", (room[0].v0, room[0].v1, room[0].v2),
                          R=64)
    with pytest.raises(ValueError, match="closest hits"):
        t_pt._closest_hit(room[1], o, d, 1e-3, 1e4, any_hit=True,
                          per_ray=True)
