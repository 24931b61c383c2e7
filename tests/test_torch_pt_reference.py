"""gsrt_torch's path tracer (`models.path_tracer`) held against the
benchmark's plain reference (`benchmark/reference/pathtrace.py`) on the
CPU: a few-thousand-triangle room from the path-tracing cells' generator
(`benchmark/tri_scene.py`) with every material model (Lambertian walls
and fixtures, a fuzz-0 mirror, fuzz-0.1 chrome, a glass screen, a light
panel), at 64×48 and 4 bounces, on the same draws.

Tolerances: the reference rounds Möller–Trumbore and the scatter as the
plain cast and traversal do, so on the CPU the two agree pixel for pixel;
the renders allow 0.2% of pixels another bounce-0 triangle (a last-ulp
difference picks the other triangle of a near tie) and hold 99.5% of
pixels to atol 1e-4 and the mean colour to 2e-3, the soup rule of
`test_torch_pathtracer.py`. The scatter of metal and glass, which the
JAX package cannot check (its batch-wide norm), is held to the
reference's at rtol = atol = 1e-5. A ray's scatter and a reference
pixel are bit-equal whatever else shares their batch.
"""

from __future__ import annotations

import copy
import unittest.mock as mock

import numpy as np
import pytest
import torch

import _torch_env  # noqa: F401
from benchmark import harness, port, tri_scene
from benchmark.reference import pathtrace as ref
from gsrt_torch import RenderConfig
from gsrt_torch.core.types import Materials
from gsrt_torch.interop import scene_from_numpy
from gsrt_torch.models import path_tracer as t_pt

W, H, BOUNCES, N_TRIS = 64, 48, 4, 3000
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def room():
    """(generator scene, port scene, port camera, config, reference
    scene)."""
    s = tri_scene.build(N_TRIS, W, H)
    cfg = RenderConfig(width=W, height=H, samples=1, bounces=BOUNCES,
                       has_sky=False, gamma_correction=False)
    ps = t_pt.with_tri_table(scene_from_numpy(s.fields(), device="cpu"))
    return (s, ps, port.camera(s.view, "cpu"), cfg,
            ref.make_scene(s.v0, s.v1, s.v2, s.mat, s.materials, "cpu"))


def _reference(room, seed, pixels):
    s, _, _, cfg, sc = room
    return ref.trace(sc, s.view, seed, pixels, bounces=cfg.bounces,
                     t_min=cfg.t_min, t_max=cfg.t_max)


@pytest.fixture(scope="module")
def full_trace(room):
    """The reference's colour and bounce-0 triangles of every pixel of
    the frame drawn from seed 11."""
    return _reference(room, 11, torch.arange(W * H))


def test_room_has_the_count_and_every_material(room):
    s = room[0]
    assert s.n == N_TRIS
    assert tri_scene.build(359_309, 1920, 1080).n == 359_309
    models = set(s.materials["model"][np.unique(s.mat)].tolist())
    assert models == {Materials.LAMBERTIAN, Materials.METALLIC,
                      Materials.DIELECTRIC, Materials.DIFFUSE_LIGHT}
    fuzz = s.materials["fuzziness"][s.materials["model"] ==
                                    Materials.METALLIC]
    assert sorted(fuzz.tolist()) == pytest.approx([0.0, 0.1])


@pytest.mark.parametrize("sort", [True, False], ids=["sorted", "unsorted"])
@pytest.mark.parametrize("impl", ["binned", "block"])
def test_render_matches_reference(room, full_trace, impl, sort):
    """The port's PT (bounce 0 through the binned cast or the block
    traversal, the waves coherence sorted or not) against the
    reference's, every pixel, the same draws."""
    s, ps, cam, cfg, _ = room
    ids = []
    got, flags = t_pt.render_path_traced(
        ps, cam, cfg, seed=11, primary_impl=impl, sort_bounces=sort,
        tri_max_pairs=1 << 16, return_flags=True, primary_ids=ids)
    assert not any(bool(v) for v in flags.values())
    want, want_ids = full_trace
    bad = (ids[0].reshape(-1) != want_ids).numpy()
    assert bad.mean() <= 0.002
    # bounce 0 sees the mirror, the glass, chrome and Lambertian surfaces
    seen = s.mat[want_ids[want_ids >= 0].numpy()]
    mats = list(tri_scene.MATERIALS)
    assert {mats.index(m) for m in ("mirror", "glass", "chrome",
                                    "wall")} <= set(seen.tolist())
    got, want = got.reshape(-1, 3).numpy(), want.numpy()
    near = (np.abs(got - want) <= 1e-4).all(-1)
    assert near.mean() >= 0.995
    np.testing.assert_allclose(got.mean(0), want.mean(0), atol=2e-3)
    assert got.std() > 0.05      # the light reached through the bounces


def test_reference_subset_equals_its_full_trace(room, full_trace):
    full, full_ids = full_trace
    pix = torch.as_tensor(np.sort(np.random.default_rng(4).choice(
        W * H, 500, replace=False)))
    sub, sub_ids = _reference(room, 11, pix)
    assert torch.equal(sub, full[pix]) and torch.equal(sub_ids,
                                                       full_ids[pix])


def test_draws_match_the_reference(room):
    """The draw-order contract: the reference's `draws` are the tensors
    render_path_traced takes from its generator, in order and shape."""
    _, ps, cam, cfg, _ = room
    got = {"uniform": [], "unit": []}

    def record(fn, key):
        def f(*a, **kw):
            out = fn(*a, **kw)
            got[key].append(out)
            return out
        return f
    with mock.patch.multiple(
            t_pt, _uniform=record(t_pt._uniform, "uniform"),
            _random_unit=record(t_pt._random_unit, "unit")):
        t_pt.render_path_traced(ps, cam, cfg, seed=13, tri_max_pairs=1 << 16)
    want = ref.draws(13, W * H, cfg.bounces, "cpu")
    # the jitter, the thin lens's two draws, then a uniform a bounce
    assert len(got["uniform"]) == 3 + cfg.bounces
    assert torch.equal(got["uniform"][0], want["jitter"])
    assert all(torch.equal(g, w) for g, w in
               zip(got["uniform"][3:], want["uniform"]))
    assert len(got["unit"]) == cfg.bounces
    assert all(torch.equal(g, w) for g, w in zip(got["unit"], want["unit"]))


def _scatter_case(room, R=4000, seed=0):
    """Rays of every material but the light against random unit normals
    from both sides, and their draws."""
    s, ps = room[0], room[1]
    rng = np.random.default_rng(seed)
    n = rng.normal(size=(R, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    d = (rng.normal(size=(R, 3)) * rng.uniform(0.2, 2.0, (R, 1))).astype(
        np.float32)
    models = s.materials["model"]
    mat = rng.choice(np.flatnonzero(models != Materials.DIFFUSE_LIGHT), R)
    unit = rng.normal(size=(R, 3)).astype(np.float32)
    unit /= np.linalg.norm(unit, axis=1, keepdims=True)
    uni = rng.random(R).astype(np.float32)
    return ps, [torch.as_tensor(a) for a in (mat, d, n, unit, uni)]


def _port_scatter(ps, mat, d, n, unit, uni):
    with mock.patch.multiple(t_pt, _uniform=lambda gen, shape: uni,
                             _random_unit=lambda gen, shape: unit):
        return t_pt._scatter(None, ps.materials, mat, d, n)


def test_scatter_matches_reference(room):
    """Metal (fuzz 0 and 0.1), glass and Lambertian: direction,
    attenuation and whether the path goes on."""
    ps, (mat, d, n, unit, uni) = _scatter_case(room)
    got = _port_scatter(ps, mat, d, n, unit, uni)
    m = ps.materials
    atten, new_d, go, light = ref.scatter(
        m.model[mat.long()].long(), m.diffuse[mat.long()],
        m.fuzziness[mat.long()], m.refraction_index[mat.long()], d, n, unit,
        uni)
    np.testing.assert_allclose(got[0].numpy(), atten.numpy(), **TOL)
    np.testing.assert_allclose(got[1].numpy(), new_d.numpy(), **TOL)
    assert torch.equal(got[2], go) and not light.any()
    model = m.model[mat.long()]
    for kind in (Materials.METALLIC, Materials.DIELECTRIC):
        assert (model == kind).sum() > 300


def test_scatter_of_a_ray_does_not_depend_on_its_batch(room):
    ps, case = _scatter_case(room, seed=1)
    whole = _port_scatter(ps, *case)
    keep = torch.as_tensor(np.random.default_rng(2).permutation(4000)[:777])
    part = _port_scatter(ps, *(a[keep] for a in case))
    for w, p in zip(whole, part):
        assert torch.equal(w[keep], p)


def test_check_fails_a_frame_with_an_overflow_flag(tmp_path):
    """The cell's loop at a tiny size on the CPU: a window frame whose
    flags report an overflow fails, and the check fails with it."""
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    cell, cfg_entry = harness.find_cell(bench, "bathroom-pt")
    config = copy.deepcopy(harness.load_json(harness.ROOT
                                             / cfg_entry["file"]))
    config.update(triangles=2000, bounces=2,
                  frame=dict(width=32, height=24, samples_per_pixel=1))
    mix = dict(harness.load_json(harness.PKG / "traffic"
                                 / f"{cell['traffic']}.json"),
               warm_frames=1, check_pixels=200)
    limits = harness.load_json(harness.PKG / "limits" / "bathroom-pt.json")
    loop = harness.load_module("loops", mix["loop"], harness.PKG).Loop(
        config, mix, 2 ** 33 + 9, "cpu")
    loop.setup()
    real = loop._pt.render_path_traced_calibrated

    def overflowing(*a, **kw):
        img, info = real(*a, **kw)
        info["flags"]["binned_pairs_overflow"] = True
        return img, info
    rec = loop.step()
    loop.keep(0, dict(rec, latency_s=0.1))
    checks = loop.check(limits)
    assert all(c["value"] <= c["limit"] for c in checks.values()), checks

    loop.setup()
    loop._pt = mock.Mock(render_path_traced_calibrated=overflowing)
    with pytest.raises(RuntimeError, match="overflowed"):
        loop.step()
    checks = loop.check(limits)
    assert checks["overflow_frames"]["value"] == 1 > \
        checks["overflow_frames"]["limit"]
