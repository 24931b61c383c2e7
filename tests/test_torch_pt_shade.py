"""The path tracer's wave shading (`gsrt_torch.ops.pt_shade.shade_wave`)
on the CPU: the inputs it refuses, its plain path (`path_tracer.
_shade_plain`, updated in place, the same draws), and the counters a
traced render gives. `make_wave` builds the waves that
tests/test_torch_gpu.py holds the kernel to its plain version on.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import _torch_env  # noqa: F401
from gsrt_torch import RenderConfig, _kernels
from gsrt_torch.core.types import Materials
from gsrt_torch.models import path_tracer as t_pt
from gsrt_torch.ops import pt_shade
from gsrt_torch.utils.profiling import TRACER

# every model the kernel selects among: two Lambertian albedos, a mirror,
# fuzz-0.1 chrome, glass of index 1.5, an isotropic medium and a light
MATERIALS = dict(
    model=[0, 0, 1, 1, 2, 3, 4],
    diffuse=[[0.7, 0.7, 0.7], [0.8, 0.2, 0.1], [0.9, 0.9, 0.9],
             [0.8, 0.8, 0.7], [1.0, 1.0, 1.0], [0.5, 0.6, 0.7],
             [4.0, 4.0, 3.5]],
    fuzziness=[0.0, 0.0, 0.0, 0.1, 0.0, 0.0, 0.0],
    refraction_index=[1.0, 1.0, 1.0, 1.0, 1.5, 1.0, 1.0])
GLASS = 4
WAVE_KINDS = ["mixed", "glass_tir", "retired", "parked"]


def materials(device) -> Materials:
    m = MATERIALS
    f32 = lambda k: torch.tensor(m[k], dtype=torch.float32,  # noqa: E731
                                 device=device)
    return Materials(torch.tensor(m["model"], dtype=torch.int32,
                                  device=device),
                     f32("diffuse"), f32("fuzziness"),
                     f32("refraction_index"))


def make_wave(kind: str, R: int, tex: bool, device, seed: int = 0) -> dict:
    """One wave's shade_wave inputs (but the generator and materials):
    `mixed` rays of every material, live, retired and missing, normals on
    both sides of the direction, directions of any length; `glass_tir`
    rays leaving glass, most beyond the critical angle; `retired` rays no
    longer active, half of them hitting (they still move); and `parked`
    rays neither active nor hitting (the sorted waves' parked rays)."""
    rng = np.random.default_rng(seed)
    unit = rng.normal(size=(R, 3))
    unit /= np.linalg.norm(unit, axis=1, keepdims=True)
    d = rng.normal(size=(R, 3))
    d *= rng.uniform(0.5, 2.0, (R, 1)) / np.linalg.norm(d, axis=1,
                                                        keepdims=True)
    mat = rng.integers(0, len(MATERIALS["model"]), R)
    hit = rng.random(R) < 0.85
    active = rng.random(R) < 0.8
    n = unit
    if kind == "glass_tir":
        # n at angle acos(c) to the unit direction, on its side (dn > 0):
        # index 1.5 reflects everything below c = sqrt(1 - 1/2.25) ~ 0.745
        mat[:] = GLASS
        hit[:], active[:] = True, True
        du = d / np.linalg.norm(d, axis=1, keepdims=True)
        perp = np.cross(du, rng.normal(size=(R, 3)))
        perp /= np.linalg.norm(perp, axis=1, keepdims=True)
        c = np.where(rng.random(R) < 0.8, rng.uniform(0.01, 0.74, R),
                     rng.uniform(0.75, 1.0, R))[:, None]
        n = c * du + np.sqrt(1 - c * c) * perp
        n /= np.linalg.norm(n, axis=1, keepdims=True)
    elif kind == "retired":
        active[:] = False
        hit = rng.random(R) < 0.5
    elif kind == "parked":
        active[:], hit[:] = False, False
    t = np.where(hit, rng.uniform(1e-3, 3.0, R), np.inf)
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    cols = dict(t=f32(t), n=f32(n), mat=mat.astype(np.int32), hit=hit,
                orig=f32(rng.uniform(-2, 2, (R, 3))), dirn=f32(d),
                active=active, ray_color=f32(rng.uniform(0, 1, (R, 3))),
                out_color=f32(rng.uniform(0, 0.5, (R, 3))),
                tex_color=f32(rng.uniform(0, 1, (R, 3))) if tex else None)
    return {k: None if a is None else torch.as_tensor(a, device=device)
            for k, a in cols.items()}


def clone_wave(w: dict) -> dict:
    return {k: None if a is None else a.clone() for k, a in w.items()}


def shade(fn, seed: int, mats, w: dict, has_sky: bool):
    """fn(gen, mats, *wave) on a generator seeded with seed, on the
    wave's device; returns (outputs, generator)."""
    gen = torch.Generator(device=w["t"].device).manual_seed(seed)
    out = fn(gen, mats, w["t"], w["n"], w["mat"], w["hit"], w["orig"],
             w["dirn"], w["active"], w["ray_color"], w["out_color"],
             w["tex_color"], has_sky)
    return out, gen


OUTPUTS = ("orig", "dirn", "ray_color", "out_color", "active")


@pytest.mark.parametrize("has_sky", [False, True], ids=["nosky", "sky"])
@pytest.mark.parametrize("tex", [False, True], ids=["untextured", "tex"])
@pytest.mark.parametrize("kind", WAVE_KINDS)
def test_cpu_takes_the_plain_version_in_place(kind, tex, has_sky):
    """On CPU tensors shade_wave is _shade_plain's result written into
    its own inputs, drawing what _shade_plain draws; no kernel runs."""
    mats = materials("cpu")
    w = make_wave(kind, 517, tex, "cpu", seed=3)
    want, g_want = shade(t_pt._shade_plain, 21, mats, clone_wave(w),
                         has_sky)
    before = _kernels.PT_SHADE.launches
    got_w = clone_wave(w)
    got, g_got = shade(pt_shade.shade_wave, 21, mats, got_w, has_sky)
    assert _kernels.PT_SHADE.launches == before
    assert all(a is got_w[k] for a, k in zip(got, OUTPUTS))
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert torch.equal(g_got.get_state(), g_want.get_state())
    # the wave changed: rays moved, colours gathered, some retired
    if kind not in ("parked",):
        assert not torch.equal(got[0], w["orig"])
    if kind == "parked":
        for a, k in zip(got, OUTPUTS):
            assert torch.equal(a, w[k])


def _bad(kind: str, w: dict, mats: Materials):
    """Break one input of a wave (or the materials) the way `kind` says."""
    R = w["t"].shape[0]
    if kind == "t_float64":
        w["t"] = w["t"].double()
    elif kind == "mat_int64":
        w["mat"] = w["mat"].long()
    elif kind == "hit_uint8":
        w["hit"] = w["hit"].to(torch.uint8)
    elif kind == "active_float":
        w["active"] = w["active"].float()
    elif kind == "n_wide":
        w["n"] = torch.zeros((R, 4))
    elif kind == "orig_short":
        w["orig"] = w["orig"][:-1].contiguous()
    elif kind == "tex_shape":
        w["tex_color"] = torch.ones((R, 2))
    elif kind == "dirn_strided":
        w["dirn"] = w["dirn"].T.contiguous().T
    elif kind == "out_color_strided":
        w["out_color"] = torch.zeros((R, 4))[:, :3]
    elif kind == "t_meta":
        w["t"] = torch.empty(R, device="meta")
    elif kind == "tex_meta":
        w["tex_color"] = torch.empty((R, 3), device="meta")
    elif kind == "all_meta":
        w = {k: None if a is None else torch.empty_like(a, device="meta")
             for k, a in w.items()}
        mats = Materials(*(a.to("meta") for a in mats[:4]))
    elif kind == "diffuse_wide":
        mats = mats._replace(diffuse=torch.zeros((mats.model.shape[0], 4)))
    elif kind == "model_float":
        mats = mats._replace(model=mats.model.float())
    elif kind == "no_materials":
        mats = Materials(*(a[:0] for a in mats[:4]))
    return w, mats


@pytest.mark.parametrize("kind", [
    "t_float64", "mat_int64", "hit_uint8", "active_float", "n_wide",
    "orig_short", "tex_shape", "dirn_strided", "out_color_strided",
    "t_meta", "tex_meta", "all_meta", "diffuse_wide", "model_float",
    "no_materials"])
def test_wrapper_refuses(kind):
    """Mixed devices, other dtypes or shapes, rows that are not
    contiguous, a device that is neither CPU nor CUDA, a table without
    rows: shade_wave raises before it draws or writes anything."""
    w, mats = _bad(kind, make_wave("mixed", 64, True, "cpu"),
                   materials("cpu"))
    keep = {k: a.clone() for k, a in w.items()
            if a is not None and a.device.type == "cpu"}
    gen = torch.Generator().manual_seed(1)
    state = gen.get_state()
    with pytest.raises(ValueError):
        pt_shade.shade_wave(gen, mats, w["t"], w["n"], w["mat"], w["hit"],
                            w["orig"], w["dirn"], w["active"],
                            w["ray_color"], w["out_color"], w["tex_color"],
                            True)
    assert torch.equal(gen.get_state(), state)
    for k, a in keep.items():
        assert torch.equal(w[k], a)


def test_a_traced_render_counts_its_waves():
    """Under a recording profiler each `pt.shade` span counts one wave and,
    on the CPU, no wave the kernel shaded; the image is the untraced
    one."""
    from benchmark import port, tri_scene
    from gsrt_torch.interop import scene_from_numpy
    s = tri_scene.build(3000, 24, 16)
    ps = t_pt.with_tri_table(scene_from_numpy(s.fields(), device="cpu"))
    cfg = RenderConfig(width=24, height=16, samples=1, bounces=5,
                       has_sky=False, gamma_correction=False)
    cam = port.camera(s.view, "cpu")
    kw = dict(seed=2, tri_max_pairs=1 << 14)
    off = t_pt.render_path_traced(ps, cam, cfg, **kw)
    TRACER.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        on = t_pt.render_path_traced(ps, cam, cfg, **kw)
    rep = TRACER.report()
    TRACER.reset()
    assert torch.equal(on, off)
    shades = [r["counters"] for r in rep if r["name"] == "pt.shade"]
    assert len(shades) == cfg.bounces
    assert all(c == {"shade_waves": 1, "shade_fused": 0} for c in shades)
