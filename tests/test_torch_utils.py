"""gsrt_torch.utils (image I/O with the port's PNG codec, metrics,
heatmap, accumulator, sanitizers, stats, timers, checkpoints) and
`models.gaussian_rt.count_pairs`, held against the JAX package on the
same NumPy inputs, on the CPU.

Tolerances: PNG files bit for bit both ways (the port's files as PIL
decodes them, PIL's files as the port decodes them, every filter type);
`dump_image_binary` bytes equal; PSNR and SSIM to 1e-12 (both float64
NumPy); the heatmap, the accumulator, the sanitizers' lists, the scene
checkpoints and the pair counts equal; a training checkpoint resumes so
that 3 + 3 steps equal 6 steps bit for bit; `RenderStats` JSON equal for
one output, frame time aside.
"""

from __future__ import annotations

import io
import json
import os
import struct
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import _torch_env  # noqa: F401
from gsrt.core.config import RenderConfig as JCfg
from gsrt.models import gaussian_rt as j_rt
from gsrt.ops import bvh as j_bvh
from gsrt.scene import catalog as j_catalog
from gsrt.utils import accumulate as j_acc
from gsrt.utils import checkpoint as j_ckpt
from gsrt.utils import debug as j_debug
from gsrt.utils import heatmap as j_heat
from gsrt.utils import image as j_img
from gsrt.utils import stats as j_stats

from gsrt_torch import RenderConfig
from gsrt_torch.interop import camera_from_numpy, cloud_from_numpy
from gsrt_torch.models import gaussian_rt as t_rt
from gsrt_torch.models import trainer as t_tr
from gsrt_torch.ops import bvh as t_bvh
from gsrt_torch.scene import catalog as t_catalog
from gsrt_torch.utils import accumulate as t_acc
from gsrt_torch.utils import checkpoint as t_ckpt
from gsrt_torch.utils import debug as t_debug
from gsrt_torch.utils import heatmap as t_heat
from gsrt_torch.utils import image as t_img
from gsrt_torch.utils import profiling as t_prof
from gsrt_torch.utils import stats as t_stats

CPU = "cpu"


def _jcloud_to_port(jc):
    return cloud_from_numpy(*(np.asarray(a) for a in (
        jc.means, jc.cov3d, jc.opacity, jc.sh)), device=CPU)


def _jcam_to_port(jcam):
    return camera_from_numpy(np.asarray(jcam.view), jcam.fx, jcam.fy,
                             jcam.cx, jcam.cy, jcam.width, jcam.height,
                             device=CPU)


def _image(h, w, c=3, seed=0):
    return np.random.default_rng(seed).random((h, w, c)).astype(np.float32)


# --------------------------------------------------------------- PNG codec


@pytest.mark.parametrize("shape", [(1, 1, 3), (17, 29, 3), (40, 9, 3),
                                   (23, 31)])
def test_port_png_read_by_pil(tmp_path, shape):
    img = np.random.default_rng(1).random(shape).astype(np.float32)
    path = str(tmp_path / "p.png")
    t_img.save_png(path, torch.as_tensor(img))
    want = t_img.to_uint8(img)
    if want.ndim == 2:
        want = np.stack([want] * 3, -1)
    got = Image.open(path)
    assert got.mode == "RGB"
    np.testing.assert_array_equal(np.asarray(got), want)
    # and gsrt's reader (PIL, convert("RGB")) gives the port's load_png
    np.testing.assert_array_equal(j_img.load_png(path), t_img.load_png(path))
    np.testing.assert_array_equal(t_img.load_png(path),
                                  want.astype(np.float32) / 255.0)


@pytest.mark.parametrize("mode,channels", [("L", 1), ("LA", 2),
                                           ("RGB", 3), ("RGBA", 4)])
def test_pil_png_read_by_port(tmp_path, mode, channels):
    arr = (np.random.default_rng(2).random((21, 34, channels)) * 255
           ).astype(np.uint8)
    path = str(tmp_path / f"{mode}.png")
    Image.fromarray(arr[..., 0] if channels == 1 else arr, mode).save(path)
    with open(path, "rb") as f:
        raw = t_img.decode_png(f.read())
    np.testing.assert_array_equal(raw.reshape(arr.shape),
                                  np.asarray(Image.open(path)).reshape(
                                      arr.shape))
    # load_png: RGB, alpha dropped and grey repeated, as convert("RGB")
    np.testing.assert_array_equal(t_img.load_png(path), j_img.load_png(path))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def _filter_row(ftype, row, prev, bpp):
    """One row filtered as the PNG specification defines it (a reference
    encoder written byte by byte)."""
    out = bytearray(len(row))
    for i, x in enumerate(row):
        a = row[i - bpp] if i >= bpp else 0
        b = prev[i]
        c = prev[i - bpp] if i >= bpp else 0
        pred = (0, a, b, (a + b) // 2, _paeth(a, b, c))[ftype]
        out[i] = (x - pred) % 256
    return bytes(out)


def _hand_png(arr, filters, ctype, depth=8, interlace=0, idat_parts=3):
    """A PNG of arr [H, W*C] uint8 with the given filter type per row, its
    zlib stream split over `idat_parts` IDAT chunks."""
    h, stride = arr.shape
    bpp = {0: 1, 2: 3, 4: 2, 6: 4}.get(ctype, 1)
    prev = bytes(stride)
    raw = b""
    for y in range(h):
        row = bytes(arr[y])
        raw += bytes([filters[y % len(filters)]]) + _filter_row(
            filters[y % len(filters)], row, prev, bpp)
        prev = row
    z = zlib.compress(raw)
    cut = np.linspace(0, len(z), idat_parts + 1).astype(int)
    chunk = lambda k, b: (struct.pack(">I", len(b)) + k + b  # noqa: E731
                          + struct.pack(">I", zlib.crc32(k + b)))
    w = stride // bpp
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0,
                                         0, interlace))
            + b"".join(chunk(b"IDAT", z[a:b]) for a, b in zip(cut, cut[1:]))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("filters", [(0,), (1,), (2,), (3,), (4,),
                                     (0, 1, 2, 3, 4)])
@pytest.mark.parametrize("ctype,channels", [(0, 1), (4, 2), (2, 3), (6, 4)])
def test_png_filter_types_and_split_idat(filters, ctype, channels):
    arr = (np.random.default_rng(3).random((9, 13 * channels)) * 255
           ).astype(np.uint8)
    data = _hand_png(arr, filters, ctype)
    got = t_img.decode_png(data)
    np.testing.assert_array_equal(got.reshape(9, -1), arr)
    # the hand-built file is a valid PNG: PIL reads the same pixels
    np.testing.assert_array_equal(
        np.asarray(Image.open(io.BytesIO(data))).reshape(9, -1), arr)


@pytest.mark.parametrize("kind,match", [("16-bit", "16-bit"),
                                        ("palette", "palette"),
                                        ("interlaced", "interlaced")])
def test_png_decoder_rejects_what_it_does_not_read(tmp_path, kind, match):
    if kind == "16-bit":
        arr = (np.arange(64, dtype=np.uint16) * 1000).reshape(8, 8)
        buf = io.BytesIO()
        Image.fromarray(arr).save(buf, format="PNG")     # mode I;16
        data = buf.getvalue()
    elif kind == "palette":
        buf = io.BytesIO()
        Image.fromarray(np.zeros((8, 8, 3), np.uint8)).convert(
            "P").save(buf, format="PNG")
        data = buf.getvalue()
    else:
        data = _hand_png(np.zeros((8, 24), np.uint8), (0,), 2, interlace=1)
    with pytest.raises(ValueError, match=match):
        t_img.decode_png(data)


def test_png_decoder_checks_crc():
    data = bytearray(t_img.encode_png(np.zeros((4, 4, 3), np.uint8)))
    data[20] ^= 1          # a byte of IHDR's body
    with pytest.raises(ValueError, match="CRC"):
        t_img.decode_png(bytes(data))


@pytest.mark.parametrize("shape", [(5, 7, 3), (6, 4), (3, 5, 4)])
def test_dump_image_binary_equal(tmp_path, shape):
    img = np.random.default_rng(4).random(shape).astype(np.float32) * 1.2
    j_img.dump_image_binary(str(tmp_path / "j.bin"), img)
    t_img.dump_image_binary(str(tmp_path / "t.bin"), torch.as_tensor(img))
    j = (tmp_path / "j.bin").read_bytes()
    assert j == (tmp_path / "t.bin").read_bytes()
    assert len(j) == shape[0] * shape[1] * 7


@pytest.mark.parametrize("shape", [(16, 20, 3), (9, 30)])
def test_psnr_ssim_agree(shape):
    a, b = _image(*shape[:2], seed=5), _image(*shape[:2], seed=6)
    if len(shape) == 2:
        a, b = a[..., 0], b[..., 0]
    b = 0.7 * a + 0.3 * b
    assert abs(t_img.psnr(torch.as_tensor(a), b) - j_img.psnr(a, b)) <= 1e-12
    assert abs(t_img.ssim(a, torch.as_tensor(b)) - j_img.ssim(a, b)) <= 1e-12
    assert t_img.psnr(a, a) == j_img.psnr(a, a) == float("inf")
    for fn in (t_img.ssim, j_img.ssim):
        with pytest.raises(ValueError, match="at least 7px"):
            fn(a[:6], b[:6])


# ---------------------------------------------------- heatmap, accumulator


@pytest.mark.parametrize("scale", [None, 3.5])
def test_heatmap_bit_equal(scale):
    v = np.random.default_rng(7).uniform(0, 10, (16, 24)).astype(np.float32)
    want = j_heat.heatmap(v, scale)
    got = t_heat.heatmap(torch.as_tensor(v), scale)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    hits = np.random.default_rng(8).integers(0, 40, (8, 8)).astype(np.int32)
    np.testing.assert_array_equal(t_heat.heatmap(torch.as_tensor(hits)),
                                  j_heat.heatmap(hits))


@pytest.mark.parametrize("gamma", [True, False])
def test_accumulator_equal(gamma):
    ja, ta = j_acc.ProgressiveAccumulator(gamma), \
        t_acc.ProgressiveAccumulator(gamma)
    for i, spp in enumerate((1, 3, 2)):
        img = _image(6, 5, seed=10 + i) * 1.3
        ja.add(img, samples=spp)
        ta.add(torch.as_tensor(img), samples=spp)
    assert ta.total_samples == ja.total_samples == 6
    np.testing.assert_array_equal(ta.image, ja.image)
    ta.reset()
    with pytest.raises(ValueError):
        ta.image


# ------------------------------------------------------------- sanitizers


def _broken(cloud, fault: str):
    means, cov, op, sh = (np.array(a) for a in (cloud.means, cloud.cov3d,
                                                cloud.opacity, cloud.sh))
    if fault == "nan-means":
        means[0, 0] = np.nan
    elif fault == "opacity":
        op[1] = 2.0
    elif fault == "inf-sh":
        sh[0, 0, 1] = np.inf
    elif fault == "cov":
        cov[0, 0] = -1.0
        cov[1, 1] = 10.0
    elif fault == "nan-cov":
        cov[1, 2] = np.nan
    return means, cov, op, sh


@pytest.mark.parametrize("fault", ["clean", "nan-means", "opacity", "inf-sh",
                                   "cov", "nan-cov"])
def test_validate_cloud_equal(fault):
    jc, _ = j_catalog.random_cloud(32, seed=3, width=16, height=16)
    means, cov, op, sh = _broken(jc, fault)
    jbad = jc._replace(means=jnp.asarray(means), cov3d=jnp.asarray(cov),
                       opacity=jnp.asarray(op), sh=jnp.asarray(sh))
    want = j_debug.validate_cloud(jbad)
    assert (want == []) == (fault == "clean")
    assert t_debug.validate_cloud(cloud_from_numpy(means, cov, op, sh,
                                                   device=CPU)) == want


@pytest.mark.parametrize("fault", ["clean", "nan-color", "trans", "negative"])
def test_validate_output_equal(fault):
    jc, jcam = j_catalog.demo_gauss_splat(16, 16)
    out = j_rt.render_fast(jc, jcam, JCfg(width=16, height=16))
    trans, color = np.array(out.trans), np.array(out.color)
    if fault == "nan-color":
        color[2, 3, 1] = np.nan
    elif fault == "trans":
        trans[0, 0] = 1.5
    elif fault == "negative":
        color[1, 1, 0] = -0.5
    jout = out._replace(trans=jnp.asarray(trans), color=jnp.asarray(color))
    tout = t_rt.RenderOutput(trans=torch.as_tensor(trans),
                             color=torch.as_tensor(color),
                             passes=torch.as_tensor(np.array(out.passes)),
                             hits=torch.as_tensor(np.array(out.hits)))
    want = j_debug.validate_output(jout)
    assert (want == []) == (fault == "clean")
    assert t_debug.validate_output(tout) == want


# ------------------------------------------------------------ checkpoints


def test_scene_checkpoint_gsrt_to_port(tmp_path):
    jc, _ = j_catalog.random_cloud(64, seed=0, width=32, height=32)
    amin, amax = jc.aabbs()
    jb = j_bvh.build_lbvh(amin, amax)
    path = str(tmp_path / "scene")          # np.savez adds ".npz"
    j_ckpt.save_scene(path, jc, jb)
    cloud, bvh = t_ckpt.load_scene(path, device=CPU)
    for k in jc._fields:
        np.testing.assert_array_equal(getattr(cloud, k).numpy(),
                                      np.asarray(getattr(jc, k)))
    for k in jb._fields:
        got, want = getattr(bvh, k).numpy(), np.asarray(getattr(jb, k))
        assert got.dtype == want.dtype, k
        np.testing.assert_array_equal(got, want)


def test_scene_checkpoint_port_to_gsrt(tmp_path):
    cloud, _ = t_catalog.random_cloud(64, seed=1, width=32, height=32,
                                      device=CPU)
    half = 3.0 * torch.sqrt(torch.clamp_min(cloud.cov3d[:, [0, 3, 5]], 0.0))
    bvh = t_bvh.build_lbvh(cloud.means - half, cloud.means + half)
    path = str(tmp_path / "scene.npz")
    t_ckpt.save_scene(path, cloud, bvh)
    jc, jb = j_ckpt.load_scene(path)
    for k in cloud._fields:
        np.testing.assert_array_equal(np.asarray(getattr(jc, k)),
                                      getattr(cloud, k).numpy())
    for k in bvh._fields:
        np.testing.assert_array_equal(np.asarray(getattr(jb, k)),
                                      getattr(bvh, k).numpy())
    # and without a BVH
    t_ckpt.save_scene(path, cloud)
    assert t_ckpt.load_scene(path, device=CPU)[1] is None
    assert j_ckpt.load_scene(path)[1] is None


def test_training_checkpoint_resumes_exactly(tmp_path):
    cloud, camera = t_catalog.demo_gauss_splat(16, 16, device=CPU)
    cfg = RenderConfig(width=16, height=16)
    target = t_rt.render_fast(cloud, camera, cfg).color.detach() * 0.6

    def steps(params, opt, n):
        for _ in range(n):
            t_tr.train_step(params, opt, target, camera, cfg)

    whole = t_tr.init_params(cloud)
    whole_opt = t_tr.make_optimizer(whole, lr_means=2e-3)
    steps(whole, whole_opt, 6)
    first = t_tr.init_params(cloud)
    first_opt = t_tr.make_optimizer(first, lr_means=2e-3)
    steps(first, first_opt, 3)
    path = str(tmp_path / "train")
    t_ckpt.save_training(path, first, first_opt, step=3)
    resumed, opt, step = t_ckpt.load_training(path, device=CPU)
    assert step == 3
    assert [g["lr"] for g in opt.param_groups] == \
        [g["lr"] for g in whole_opt.param_groups]
    steps(resumed, opt, 3)
    for k in ("means", "log_scales", "quats", "opacity_logit", "sh"):
        assert torch.equal(getattr(resumed, k), getattr(whole, k)), k
    for p, q in zip(opt.param_groups, whole_opt.param_groups):
        sp, sq = opt.state[p["params"][0]], whole_opt.state[q["params"][0]]
        assert all(torch.equal(sp[k], sq[k]) for k in sq), sq.keys()


# ------------------------------------------------------ count_pairs, stats


@pytest.mark.parametrize("conic", ["standard", "reference"])
@pytest.mark.parametrize("n,w,h", [(2000, 128, 96), (500, 64, 40)])
def test_count_pairs_equal(conic, n, w, h):
    jc, jcam = j_catalog.random_cloud(n, seed=2, width=w, height=h)
    kw = dict(width=w, height=h, conic_mode=conic)
    want = int(j_rt.count_pairs(jc, jcam, JCfg(**kw)))
    cloud, camera = _jcloud_to_port(jc), _jcam_to_port(jcam)
    got = t_rt.count_pairs(cloud, camera, RenderConfig(**kw))
    assert got.dim() == 0 and got.device.type == CPU
    assert int(got) == want
    assert t_rt.count_pairs_numpy(cloud, camera, RenderConfig(**kw)) == want


@pytest.mark.parametrize("granularity", [None, "tile-pairs"])
def test_render_stats_json_equal(granularity):
    jc, jcam = j_catalog.random_cloud(300, seed=4, width=24, height=20)
    out = j_rt.render_fast(jc, jcam, JCfg(width=24, height=20))
    tout = t_rt.RenderOutput(*(torch.as_tensor(np.array(a)) for a in (
        out.trans, out.color, out.passes, out.hits)))
    kw = dict(width=24, height=20, samples=2, n_splats=300)
    want = json.loads(j_stats.RenderStats(**kw).from_output(
        out, granularity).finish(0.004).to_json())
    got = json.loads(t_stats.RenderStats(**kw).from_output(
        tout, granularity).finish(0.004).to_json())
    assert got == want
    assert list(got) == list(want)


# ----------------------------------------------------------------- timers


def test_timers_on_the_cpu(tmp_path):
    with t_stats.Timer() as tm:
        torch.ones(64).sum()
    assert tm.dt >= 0.0
    # a StageTimer records only while a profiler does: torch_trace
    st = t_prof.StageTimer()
    with st.span("a", root=True):
        torch.ones(8).cumsum(0)
    assert st.report() == []
    with t_prof.torch_trace(str(tmp_path / "trace")):
        for _ in range(3):
            with st.span("a", root=True):
                torch.ones(16).exp()
    assert os.path.getsize(tmp_path / "trace" / "trace.json") > 0
    rep = st.report()
    assert [(s["name"], s["root"]) for s in rep] == [("a", 0), ("a", 1),
                                                     ("a", 2)]
    assert all(s["device_ms"] == s["host_ms"] >= 0.0 for s in rep)
    st.reset()
    assert st.report() == []
