"""gsrt_torch.parallel (sharded rendering over a mesh, multi-process
rendering on torch.distributed) and the data-parallel train step, held
against the JAX package on the same NumPy inputs (CPU).

The port's meshes here are of repeated CPU devices (`["cpu"] * n`), the
counterpart of the JAX suite's eight virtual CPU devices (conftest.py);
the JAX side runs under `jax.jit` (its eager shard_map compiles op by op
and takes minutes) and its Pallas kernels in interpret mode.

Tolerances:
  * shard_cloud_by_depth, calibrate_sharded: exact;
  * composites: rtol 1e-5 / atol 1e-6 against the JAX butterfly
    (tests/test_parallel.py:84-87: the butterfly reorders the product
    tree);
  * sharded renders against single-device renders: trans rtol 1e-4 /
    atol 1e-5, colour rtol 1e-3 / atol 1e-4 (tests/test_parallel.py:
    138-141); on the tiled path with the f32 payload, against the JAX
    package's single-device render_tiled, trans rtol 1e-5 / atol 1e-6 and
    colour rtol 1e-4 / atol 1e-5 (tests/test_parallel.py:112-115); with
    the compact payload atol 2e-3, the blends' tolerance;
  * the port's render_fast against the JAX package's is good to atol 1e-4
    (tests/test_torch_ops.py), so the port's render_fast slabs are held to
    the JAX sharded render at atol 1e-4;
  * the data-parallel step: loss rtol 1e-5, means and SH rtol 1e-4 / atol
    1e-6 after one step (tests/test_trainer.py:99-103);
  * two gloo processes: the gathered image against the JAX package's
    render_fast at atol 1e-4 (the render_fast parity), and equal to the
    port's in-process render_data_parallel bit for bit.
"""

from __future__ import annotations

import os
import pathlib
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

import _torch_env  # noqa: F401
from gsrt.core.config import RenderConfig as JCfg
from gsrt.models import gaussian_rt as j_rt
from gsrt.models import trainer as j_tr
from gsrt.parallel import tiles as j_tiles
from gsrt.scene.catalog import demo_gauss_splat as j_demo
from gsrt.scene.catalog import random_cloud as j_random_cloud

from gsrt_torch import RenderConfig
from gsrt_torch.interop import (camera_from_numpy, cloud_from_numpy,
                                params_from_numpy, params_to_numpy)
from gsrt_torch.models import gaussian_rt as t_rt
from gsrt_torch.models import trainer as t_tr
from gsrt_torch.parallel import (calibrate_sharded, make_render_mesh,
                                 multihost, render_data_parallel,
                                 render_splat_sharded, tiled_render_fn)
from gsrt_torch.parallel import tiles as t_tiles

REPO = pathlib.Path(__file__).resolve().parents[1]
SINGLE = dict(rtol=(1e-4, 1e-3), atol=(1e-5, 1e-4))   # (trans, colour)
F32_TIER = dict(rtol=(1e-5, 1e-4), atol=(1e-6, 1e-5))


def _n(t):
    return t.detach().cpu().numpy()


def _port(jc, jcam):
    c = cloud_from_numpy(*(np.asarray(a) for a in jc), device="cpu")
    cam = camera_from_numpy(np.asarray(jcam.view), np.asarray(jcam.fx),
                            np.asarray(jcam.fy), np.asarray(jcam.cx),
                            np.asarray(jcam.cy), jcam.width, jcam.height,
                            device="cpu")
    return c, cam


def _scene(n, seed, width, height):
    jc, jcam = j_random_cloud(n, seed=seed, width=width, height=height)
    return (jc, jcam) + _port(jc, jcam)


def _close(got, want, rtol, atol):
    """got, want: (trans, colour) pairs; rtol, atol: (trans, colour)."""
    for g, w, r, a in zip(got, want, rtol, atol):
        g = _n(g) if isinstance(g, torch.Tensor) else np.asarray(g)
        np.testing.assert_allclose(g, np.asarray(w), rtol=r, atol=a)


def _cpu_mesh(n_tiles, n_splats=1):
    return make_render_mesh(n_tiles, n_splats, ["cpu"] * (n_tiles * n_splats))


def test_make_render_mesh():
    mesh = make_render_mesh(2, 4, ["cpu"] * 9)
    assert mesh.shape == {"tiles": 2, "splats": 4}
    assert len(mesh.devices) == 2 and all(
        d == torch.device("cpu") for row in mesh.devices for d in row)
    assert not mesh.spans_processes and mesh.owns(1, 3)
    with pytest.raises(ValueError, match="need 8 devices, have 7"):
        make_render_mesh(2, 4, ["cpu"] * 7)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="devices="):
            make_render_mesh(1)


@pytest.mark.parametrize("n_shards", [4, 8])
def test_shard_cloud_by_depth_matches_jax(n_shards):
    jc, jcam, c, cam = _scene(333, 6, 64, 32)
    want = j_tiles.shard_cloud_by_depth(jc, jcam, n_shards)
    got = t_tiles.shard_cloud_by_depth(c, cam, n_shards)
    assert got.n == -(-333 // n_shards) * n_shards
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_n(g), np.asarray(w))
    assert not any(_n(x[333:]).any() for x in got)


@pytest.mark.parametrize("n_tiles,n_splats", [(2, 4), (8, 1), (4, 2)])
def test_calibrate_sharded_matches_jax(n_tiles, n_splats):
    jc, jcam, c, cam = _scene(400, 8, 64, 64)
    if n_splats > 1:
        jc = j_tiles.shard_cloud_by_depth(jc, jcam, n_splats)
        c = t_tiles.shard_cloud_by_depth(c, cam, n_splats)
    cfg = dict(width=64, height=64, conic_mode="standard")
    assert calibrate_sharded(c, cam, RenderConfig(**cfg), n_tiles,
                             n_splats) == \
        j_tiles.calibrate_sharded(jc, jcam, JCfg(**cfg), n_tiles, n_splats)


@pytest.mark.parametrize("n_sh", [4, 8])
def test_composites_match_jax_butterfly(n_sh):
    rng = np.random.default_rng(n_sh)
    trans = rng.uniform(0.0, 1.0, (n_sh, 12, 20)).astype(np.float32)
    trans[:, :3] = 1.0                     # empty slabs pass through
    color = rng.uniform(0.0, 2.0, (n_sh, 12, 20, 3)).astype(np.float32)
    mesh = Mesh(np.asarray(jax.devices()[:n_sh]), ("splats",))

    @jax.jit
    @jax.shard_map(mesh=mesh, in_specs=(P("splats"), P("splats")),
                   out_specs=(P("splats"), P("splats")), check_vma=False)
    def butterfly(t, c):
        t, c = j_tiles._composite_butterfly(t[0], c[0], "splats", n_sh)
        return t[None], c[None]

    jt, jcol = butterfly(jnp.asarray(trans), jnp.asarray(color))
    want = (np.asarray(jt)[0], np.asarray(jcol)[0])
    # every JAX shard ends with the whole composite
    np.testing.assert_array_equal(np.asarray(jt), np.broadcast_to(
        want[0], jt.shape))
    slabs = [(torch.as_tensor(trans[j]), torch.as_tensor(color[j]))
             for j in range(n_sh)]
    bound = dict(rtol=(1e-5, 1e-5), atol=(1e-6, 1e-6))
    _close(t_tiles._composite_butterfly(slabs), want, **bound)
    _close(t_tiles._composite_gather(slabs, torch.device("cpu")), want,
           **bound)


def test_render_data_parallel_matches_jax():
    jc, jcam, c, cam = _scene(200, 5, 64, 64)
    cfg = dict(width=64, height=64, conic_mode="standard")
    ref = j_rt.render_fast(jc, jcam, JCfg(**cfg))
    jmesh = j_tiles.make_render_mesh(8)
    want = jax.jit(lambda cl: j_tiles.render_data_parallel(
        cl, jcam, JCfg(**cfg), jmesh))(jc)
    got = render_data_parallel(c, cam, RenderConfig(**cfg), _cpu_mesh(8))
    _close(got, (ref.trans, ref.color), **SINGLE)
    _close(got, want, rtol=(0, 0), atol=(1e-4, 1e-4))


@pytest.mark.parametrize("mesh_shape,composite,white", [
    ((2, 4), "gather", False), ((2, 4), "butterfly", False),
    ((2, 4), "gather", True), ((1, 8), "butterfly", True)])
def test_render_splat_sharded_matches_jax(mesh_shape, composite, white):
    """333 splats pad to 336 over 4 shards (and to 336 over 8): the
    padding is in the last shard. The white background enters once, with
    the total transmittance."""
    n_tiles, n_sh = mesh_shape
    jc, jcam, c, cam = _scene(333, 6, 64, 32)
    cfg = dict(width=64, height=32, conic_mode="standard",
               white_background=white)
    ref = j_rt.render_fast(jc, jcam, JCfg(**cfg))
    jmesh = j_tiles.make_render_mesh(n_tiles, n_sh)
    js = j_tiles.shard_cloud_by_depth(jc, jcam, n_sh)
    want = jax.jit(lambda cl: j_tiles.render_splat_sharded(
        cl, jcam, JCfg(**cfg), jmesh, composite=composite))(js)
    got = render_splat_sharded(
        t_tiles.shard_cloud_by_depth(c, cam, n_sh), cam, RenderConfig(**cfg),
        _cpu_mesh(n_tiles, n_sh), composite=composite)
    _close(got, (ref.trans, ref.color), **SINGLE)
    _close(got, want, rtol=(0, 0), atol=(1e-4, 1e-4))


@pytest.fixture(scope="module")
def tiled_scene():
    """333 splats at 64x80: 4 row slabs of 20 rows and 2 of 40, neither a
    multiple of the 16-row tile, and 333 pads to 336 over 4 splat shards.
    The JAX package's single-device render_tiled, f32 payload (the
    bit-parity tier) and compact payload (f32 blend math)."""
    jc, jcam, c, cam = _scene(333, 8, 64, 80)
    base = dict(width=64, height=80, conic_mode="standard",
                blend_math="f32")
    refs = {}
    for payload in ("f32", "compact"):
        jcfg = JCfg(**base, payload=payload)
        mp = j_tiles.calibrate_sharded(jc, jcam, jcfg, n_tiles=1)
        out = jax.jit(lambda cl: j_rt.render_tiled(
            cl, jcam, jcfg, max_pairs=mp, interpret=True))(jc)
        refs[payload] = (np.asarray(out.trans), np.asarray(out.color))
    return jc, jcam, c, cam, base, refs


@pytest.mark.parametrize("payload", ["f32", "compact"])
def test_tiled_data_parallel_matches_jax(tiled_scene, payload):
    jc, jcam, c, cam, base, refs = tiled_scene
    cfg = RenderConfig(**base, payload=payload)
    mp = calibrate_sharded(c, cam, cfg, n_tiles=4)
    assert mp == j_tiles.calibrate_sharded(jc, jcam, JCfg(**base), 4)
    got = render_data_parallel(c, cam, cfg, _cpu_mesh(4),
                               render_fn=tiled_render_fn(mp))
    if payload == "f32":
        _close(got, refs[payload], **F32_TIER)
    else:
        _close(got, refs[payload], rtol=(0, 0), atol=(2e-3, 2e-3))
    single = t_rt.render_tiled(c, cam, cfg, max_pairs=mp)
    _close(got, (single.trans, single.color), **F32_TIER)


@pytest.mark.parametrize("payload", ["f32", "compact"])
def test_tiled_splat_sharded_matches_jax(tiled_scene, payload):
    """Both composites over a 2x4 mesh on the tiled path; the padding
    splats (opacity 0, Σ 0, at the origin) bin no pair in any slab."""
    jc, jcam, c, cam, base, refs = tiled_scene
    cfg = RenderConfig(**base, payload=payload)
    sharded = t_tiles.shard_cloud_by_depth(c, cam, 4)
    pad = t_tiles._shard(sharded, 3, 4)
    pad = type(pad)(*(x[-3:] for x in pad))
    assert not pad.opacity.any() and not pad.cov3d.any()
    for i in range(2):
        slab = t_tiles._slab_camera(cam, 40 * i, 40)
        assert int(t_rt.count_pairs(pad, slab, cfg)) == 0
        assert t_rt.count_pairs_numpy(pad, slab, cfg) == 0
        out = t_rt.render_tiled(pad, slab, cfg.replace(height=40),
                                max_pairs=1 << 14)
        assert bool((out.trans == 1).all()) and not out.color.any()
    mp = calibrate_sharded(sharded, cam, cfg, n_tiles=2, n_splats=4)
    js = j_tiles.shard_cloud_by_depth(jc, jcam, 4)
    assert mp == j_tiles.calibrate_sharded(js, jcam, JCfg(**base), 2, 4)
    mesh = _cpu_mesh(2, 4)
    got = {comp: render_splat_sharded(sharded, cam, cfg, mesh,
                                      render_fn=tiled_render_fn(mp),
                                      composite=comp)
           for comp in ("gather", "butterfly")}
    _close(got["butterfly"], got["gather"], rtol=(1e-5, 1e-5),
           atol=(1e-6, 1e-6))
    for out in got.values():
        if payload == "f32":
            _close(out, refs[payload], **SINGLE)
        else:
            _close(out, refs[payload], rtol=(0, 0), atol=(2e-3, 2e-3))


def test_tiled_white_background_enters_once():
    jc, jcam, c, cam = _scene(333, 6, 64, 32)
    cfg = RenderConfig(width=64, height=32, payload="f32",
                       white_background=True)
    single = t_rt.render_tiled(c, cam, cfg, max_pairs=1 << 14)
    ref = j_rt.render_fast(jc, jcam, JCfg(width=64, height=32,
                                          white_background=True))
    got = render_splat_sharded(
        t_tiles.shard_cloud_by_depth(c, cam, 4), cam, cfg, _cpu_mesh(2, 4),
        render_fn=tiled_render_fn(1 << 14), composite="butterfly")
    _close(got, (single.trans, single.color), **SINGLE)
    _close(got, (ref.trans, ref.color), rtol=(0, 0), atol=(2e-3, 2e-3))


def test_sharded_entry_points_reject_bad_input():
    _, _, c, cam = _scene(333, 6, 64, 32)
    cfg = RenderConfig(width=64, height=32, payload="f32")
    with pytest.raises(ValueError, match="height must divide"):
        render_data_parallel(c, cam, cfg, _cpu_mesh(3))
    with pytest.raises(ValueError, match="power-of-two"):
        render_splat_sharded(c, cam, cfg, _cpu_mesh(1, 3),
                             composite="butterfly")
    with pytest.raises(ValueError, match="divide the splat axis"):
        render_splat_sharded(c, cam, cfg, _cpu_mesh(1, 2))
    # a shard whose pairs outgrow the buffer raises, not truncates
    need = t_rt.count_pairs_numpy(c, t_tiles._slab_camera(cam, 0, 16), cfg)
    assert need > 64
    with pytest.raises(RuntimeError, match="calibrate_sharded"):
        render_data_parallel(c, cam, cfg, _cpu_mesh(2),
                             render_fn=tiled_render_fn(64))
    with pytest.raises(ValueError, match="backend"):
        multihost.initialize("localhost:1", 1, 0)


@pytest.mark.parametrize("n_tiles,lambda_ssim", [(8, 0.0), (2, 0.2)])
def test_train_step_dp_matches_jax(n_tiles, lambda_ssim):
    """The JAX package's make_train_step_dp on the 8-device CPU mesh
    (tests/test_trainer.py:80-103); with 16-row slabs the SSIM term runs
    per slab."""
    jcloud, jcam = j_demo(width=32, height=32)
    jcfg = JCfg(width=32, height=32, conic_mode="standard")
    target = jax.jit(lambda cl: j_rt.render_fast(cl, jcam, jcfg).color)(
        jcloud) * 0.5
    jparams = j_tr.init_params(jcloud)
    jopt = j_tr.make_optimizer()
    jstep = jax.jit(j_tr.make_train_step_dp(
        jcfg, jopt, j_tiles.make_render_mesh(n_tiles), lambda_ssim))
    jp, _, jloss = jstep(jparams, jopt.init(jparams), target, jcam)

    params = params_from_numpy(*(np.asarray(a) for a in jparams),
                               device="cpu")
    _, cam = _port(jcloud, jcam)
    step = t_tr.make_train_step_dp(
        RenderConfig(width=32, height=32, conic_mode="standard"),
        t_tr.make_optimizer(params), _cpu_mesh(n_tiles), lambda_ssim)
    loss = step(params, torch.as_tensor(np.array(target)), cam)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    got = params_to_numpy(params)
    for k in (0, 4):                       # means, sh
        np.testing.assert_allclose(got[k], np.asarray(jp[k]), rtol=1e-4,
                                   atol=1e-6)


def test_train_step_dp_equals_single_step():
    """With λ_ssim = 0 the slabs' mean loss is the whole image's, and so
    is the mean of their gradients: one DP step == one train_step."""
    jcloud, jcam = j_demo(width=32, height=32)
    c, cam = _port(jcloud, jcam)
    cfg = RenderConfig(width=32, height=32, conic_mode="standard")
    target = t_rt.render_fast(c, cam, cfg).color * 0.5
    arrays = params_to_numpy(t_tr.init_params(c))
    p1, p2 = (params_from_numpy(*arrays, device="cpu") for _ in range(2))
    loss1 = t_tr.train_step(p1, t_tr.make_optimizer(p1), target, cam, cfg,
                            lambda_ssim=0.0)
    step = t_tr.make_train_step_dp(cfg, t_tr.make_optimizer(p2),
                                   _cpu_mesh(4), lambda_ssim=0.0)
    loss2 = step(p2, target, cam)
    np.testing.assert_allclose(float(loss2), float(loss1), rtol=1e-5)
    for a, b in zip(params_to_numpy(p2), params_to_numpy(p1)):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6)


_WORKER = r"""
import sys
import numpy as np
import torch
from gsrt_torch import RenderConfig
from gsrt_torch.interop import camera_from_numpy, cloud_from_numpy
from gsrt_torch.parallel import multihost, render_data_parallel

scene, out, port, rank = sys.argv[1], sys.argv[2], sys.argv[3], int(sys.argv[4])
torch.set_num_threads(1)
multihost.initialize(f"localhost:{port}", 2, rank, backend="gloo")
d = np.load(scene)
cloud = cloud_from_numpy(d["means"], d["cov3d"], d["opacity"], d["sh"],
                         device="cpu")
cam = camera_from_numpy(d["view"], d["fx"], d["fy"], d["cx"], d["cy"], 64,
                        32, device="cpu")
cfg = RenderConfig(width=64, height=32, conic_mode="standard",
                   splat_chunk=64)
mesh = multihost.global_render_mesh(device="cpu")
assert mesh.shape == {"tiles": 2, "splats": 1} and mesh.spans_processes
slabs = multihost.render_data_parallel_global(cloud, cam, cfg, mesh)
assert slabs.y0 == (16 * rank,), slabs.y0
trans, color = multihost.gather_to_hosts(slabs)
multihost.sync_hosts()
if rank == 0:
    np.savez(out, trans=trans, color=color)
torch.distributed.destroy_process_group()
print("WORKER_OK", rank)
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_process_gloo_render_matches_jax(tmp_path):
    """Two ranks joined over TCP on localhost with gloo, each rendering
    its row slab of the global mesh; gather_to_hosts puts the frame
    together (tests/test_multihost.py's scene)."""
    jc, jcam, c, cam = _scene(256, 3, 64, 32)
    scene, out = tmp_path / "scene.npz", tmp_path / "out.npz"
    np.savez(scene, **{k: np.asarray(v) for k, v in jc._asdict().items()},
             view=np.asarray(jcam.view), fx=np.asarray(jcam.fx),
             fy=np.asarray(jcam.fy), cx=np.asarray(jcam.cx),
             cy=np.asarray(jcam.cy))
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, str(scene), str(out), str(port),
         str(rank)], cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for rank in range(2)]
    try:
        for p in procs:
            stdout, stderr = p.communicate(timeout=120)
            assert p.returncode == 0, f"worker failed:\n{stdout}\n{stderr}"
            assert "WORKER_OK" in stdout
    finally:
        for p in procs:
            p.kill()
    cfg = dict(width=64, height=32, conic_mode="standard", splat_chunk=64)
    ref = j_rt.render_fast(jc, jcam, JCfg(**cfg))
    got = np.load(out)
    _close((got["trans"], got["color"]), (ref.trans, ref.color),
           rtol=(0, 0), atol=(1e-4, 1e-4))
    t, col = render_data_parallel(c, cam, RenderConfig(**cfg), _cpu_mesh(2))
    np.testing.assert_array_equal(got["trans"], _n(t))
    np.testing.assert_array_equal(got["color"], _n(col))
