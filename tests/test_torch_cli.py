"""gsrt_torch.cli and gsrt_torch.bench on the CPU (`--device cpu`):
in-process `main(argv)` of both packages where the JAX package runs the
same command, the port's own checks elsewhere, and the front ends with
PIL hidden, as on the card's machine.

Tolerances: `render` PNGs within 1 LSB of `gsrt`'s (the renders agree to
1e-4 elsewhere in the suite; a channel near a rounding boundary may
round the other way), `n_splats` and the stats' keys equal; `compare`
records equal (both read the same files and compute in float64 NumPy);
`orbit` records with equal keys, frames, violations, re-renders and pair
counts; `pt` PNGs byte-equal to `to_uint8` of a direct port render.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import _torch_env  # noqa: F401
from gsrt import cli as j_cli

from gsrt_torch import cli as t_cli
from gsrt_torch.core.types import look_at, make_camera
from gsrt_torch.models import path_tracer as t_pt
from gsrt_torch.models.gaussian_rt import render_fast
from gsrt_torch.scene import colmap as t_colmap
from gsrt_torch.scene import primitives_catalog as t_cat
from gsrt_torch.scene import reference_scenes as t_ref
from gsrt_torch.scene.catalog import random_cloud
from gsrt_torch.scene.ply import load_gaussian_ply
from gsrt_torch.utils.image import load_png, read_png, save_png, to_uint8

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = ["--device", "cpu"]


def _json_lines(text: str):
    return [json.loads(ln) for ln in text.splitlines() if ln.startswith("{")]


@pytest.mark.parametrize("mode", ["fast", "tiled"])
def test_render_matches_gsrt(tmp_path, capsys, mode):
    recs = {}
    for name, main, extra in (("j", j_cli.main, []), ("t", t_cli.main, CPU)):
        out, heat, dump = (str(tmp_path / f"{name}.{ext}")
                           for ext in ("png", "heat.png", "bin"))
        assert main(["render", "--scene", "3DGS", "--width", "16",
                     "--height", "16", "--mode", mode, "--out", out,
                     "--heatmap", heat, "--dump-binary", dump, "--stats",
                     *extra]) == 0
        recs[name] = _json_lines(capsys.readouterr().out)[0]
    j, t = (read_png(str(tmp_path / f"{n}.png")).astype(int) for n in "jt")
    assert np.abs(j - t).max() <= 1
    assert recs["t"]["n_splats"] == recs["j"]["n_splats"] == 2
    assert list(recs["t"]) == list(recs["j"])
    assert recs["t"]["hits_granularity"] == recs["j"]["hits_granularity"]
    assert os.path.getsize(tmp_path / "t.bin") == 16 * 16 * 7
    assert read_png(str(tmp_path / "t.heat.png")).shape == (16, 16, 3)


def test_compare_equals_gsrt(tmp_path, capsys):
    rng = np.random.default_rng(0)
    a, b = (str(tmp_path / f"{n}.png") for n in "ab")
    img = rng.random((20, 24, 3)).astype(np.float32)
    save_png(a, img)
    save_png(b, np.clip(img + rng.normal(0, 0.05, img.shape), 0, 1))
    for pair in ((a, b), (a, a)):
        assert j_cli.main(["compare", *pair]) == 0
        want = _json_lines(capsys.readouterr().out)[-1]
        assert t_cli.main(["compare", *pair]) == 0
        assert _json_lines(capsys.readouterr().out)[-1] == want
    assert want == {"psnr_db": 999.0, "ssim": 1.0}
    save_png(b, img[:10])
    assert t_cli.main(["compare", a, b]) == 2


@pytest.mark.parametrize("cmd", ["render", "pt"])
def test_unknown_scene_exits_2(capsys, cmd):
    assert t_cli.main([cmd, "--scene", "nonsense", *CPU]) == 2
    assert "unknown" in capsys.readouterr().err


def test_cli_never_picks_the_cpu_itself():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_cli.main(["render", "--scene", "3DGS", "--width", "8",
                    "--height", "8"])


def test_orbit_matches_gsrt(tmp_path, capsys):
    recs, stats = {}, {}
    for name, main, extra in (("j", j_cli.main, []), ("t", t_cli.main, CPU)):
        st = str(tmp_path / f"{name}.json")
        assert main(["orbit", "--scene", "random1000", "--width", "64",
                     "--height", "48", "--frames", "2", "--stats-out", st,
                     "--out-dir", str(tmp_path / name), *extra]) == 0
        recs[name] = _json_lines(capsys.readouterr().out)[-1]
        with open(st) as f:
            stats[name] = json.load(f)
    j, t = recs["j"], recs["t"]
    assert list(t) == list(j)
    for k in ("frames", "serving", "violations", "full_renders",
              "pairs_first", "pairs_last"):
        assert t[k] == j[k], k
    assert [f["pairs"] for f in stats["t"]] == [f["pairs"]
                                                for f in stats["j"]]
    for i in range(2):
        img = read_png(str(tmp_path / "t" / f"frame_{i:04d}.png"))
        assert img.shape == (48, 64, 3)


def test_pt_equals_direct_render(tmp_path, capsys):
    out = str(tmp_path / "pt.png")
    assert t_cli.main(["pt", "--scene", "cubes", "--width", "32",
                       "--height", "32", "--out", out, *CPU]) == 0
    assert "Mrays/s" in capsys.readouterr().out
    scene, cam, opts = t_cat.cube_and_spheres(32, 32, device="cpu")
    from gsrt_torch import RenderConfig
    cfg = RenderConfig(width=32, height=32, has_sky=opts["has_sky"],
                       gamma_correction=opts["gamma"])
    img = t_pt.render_path_traced(scene, cam, cfg,
                                  aperture=opts["aperture"],
                                  focus=opts["focus"])
    np.testing.assert_array_equal(read_png(out), to_uint8(img))


@pytest.mark.parametrize("shader", ["path", "shadow", "ao"])
def test_pt_sizes_the_pair_buffer_and_prints_the_flags(capsys, shader):
    """A triangle scene's binned primary gets a buffer sized from the
    port's count, and the render's overflow flags are printed."""
    assert t_cli.main(["pt", "--scene", "cornell", "--width", "32",
                       "--height", "32", "--shader-type", shader,
                       "--primary", "binned", *CPU]) == 0
    out = capsys.readouterr().out
    flags = json.loads(out.split("overflow flags: ")[1].splitlines()[0])
    assert flags["binned_pairs_overflow"] is False
    assert flags["tri_visits_overflow"] is False


def _soup_tree(root, n=300):
    """A reference tree with one directory scene (Bathroom): an OBJ soup
    of n triangles, enough for the traversal table, and a .camera file."""
    path = os.path.join(root, "Scenes", "Bathroom")
    os.makedirs(path)
    rng = np.random.default_rng(0)
    v = rng.uniform(-2, 2, (n, 1, 3)) + rng.normal(0, 0.3, (n, 3, 3))
    with open(os.path.join(path, "soup.obj"), "w") as f:
        f.writelines(f"v {x:.6f} {y:.6f} {z:.6f}\n"
                     for x, y, z in v.reshape(-1, 3))
        f.writelines(f"f {3 * i + 1} {3 * i + 2} {3 * i + 3}\n"
                     for i in range(n))
    with open(os.path.join(path, "view.camera"), "w") as f:
        f.write("0 0 -7 0 0 0\n")


def _check_mrays(recs):
    """Each record's Mrays/s is width·height·samples over its time: within
    its own rounding to 3 places (5e-4) plus what the rounding of ms to 2
    places (5e-3 ms) moves."""
    for r in recs:
        assert r["ms"] > 0
        want = r["width"] * r["height"] * r["samples"] / (r["ms"] * 1e3)
        assert abs(r["mrays_s"] - want) <= \
            5e-4 + want * 5e-3 / r["ms"] * 1.01, r


def test_bench_suites(tmp_path, capsys, monkeypatch):
    out = str(tmp_path / "bench.json")
    assert t_cli.main(["bench", "--primary", "binned", "--width", "16",
                       "--height", "16", "--bounces", "2", "--out", out,
                       *CPU]) == 0
    recs = _json_lines(capsys.readouterr().out)
    assert [(r["scene"], r["workload"]) for r in recs] == [
        (s, w) for s in ("rtiow", "cornell", "cubes")
        for w in ("PT", "SH", "AO")]
    with open(out) as f:
        assert json.load(f) == recs
    # the binned cast where there are triangles (the Cornell box's quads)
    assert all(("binned_pairs" in r) == (r["scene"] == "cornell")
               for r in recs)
    _check_mrays(recs)

    monkeypatch.setattr(t_ref, "REF_ROOT", str(tmp_path / "absent"))
    assert t_cli.main(["bench", "--suite", "lumibench", *CPU]) == 1
    assert "not found" in capsys.readouterr().err
    _soup_tree(str(tmp_path))
    monkeypatch.setattr(t_ref, "REF_ROOT", str(tmp_path))
    assert t_cli.main(["bench", "--suite", "lumibench", "--scenes",
                       "bathroom", "--primary", "binned", "--width", "16",
                       "--height", "16", "--bounces", "2", *CPU]) == 0
    recs = _json_lines(capsys.readouterr().out)
    assert len(recs) == 3 and all(r["tris"] == 300 for r in recs)
    _check_mrays(recs)
    assert all(r["sup_visits_per_block"] > 0 and r["binned_pairs"] > 0
               for r in recs)


@pytest.mark.parametrize("densify", [0, 2])
def test_train_writes_ply(tmp_path, capsys, densify):
    ply, png = str(tmp_path / "t.ply"), str(tmp_path / "t.png")
    assert t_cli.main(["train", "--iters", "4", "--n-gaussians", "16",
                       "--width", "24", "--height", "24", "--save-ply", ply,
                       "--out", png, "--densify-every", str(densify),
                       *CPU]) == 0
    text = capsys.readouterr().out
    losses = [float(ln.split()[-1]) for ln in text.splitlines()
              if " loss " in ln]
    assert len(losses) == 4 and all(np.isfinite(losses))
    cloud = load_gaussian_ply(ply, device="cpu")
    assert cloud.n == 16 if not densify else cloud.n >= 16
    assert read_png(png).shape == (24, 24, 3)


def _capture(root, views=4, w=32, h=24):
    """A posed capture: a random cloud's render_fast targets saved as PNGs
    by the port's encoder, the poses and 200 SfM points as a COLMAP text
    model."""
    cloud, _ = random_cloud(300, seed=1, extent=1.0, width=w, height=h,
                            device="cpu")
    os.makedirs(os.path.join(root, "images"))
    cam = make_camera(np.eye(4), 50.0, w, h, device="cpu")
    images = []
    from gsrt_torch import RenderConfig
    cfg = RenderConfig(width=w, height=h, conic_mode="standard")
    for i in range(views):
        ang = 2 * np.pi * i / views
        eye = np.array([4 * np.cos(ang), 0.5, 1.5 + 4 * np.sin(ang)])
        view = look_at(eye, (0.0, 0.0, 1.5))
        with torch.no_grad():
            img = render_fast(cloud, make_camera(view, 50.0, w, h,
                                                 device="cpu"), cfg).color
        save_png(os.path.join(root, "images", f"im_{i:02d}.png"), img)
        images.append(t_colmap.ColmapImage(f"im_{i:02d}.png", 1, view))
    pts = cloud.means[:200].numpy()
    t_colmap.write_text_model(os.path.join(root, "sparse", "0"),
                              t_colmap.ColmapModel(
        cameras={1: t_colmap.ColmapCamera("PINHOLE", w, h, float(cam.fx),
                                          float(cam.fy), w / 2, h / 2)},
        images=images, points=pts,
        colors=np.full_like(pts, 0.5)))


def test_fit_on_png_capture(tmp_path, capsys):
    _capture(str(tmp_path))
    ply, png = str(tmp_path / "fit.ply"), str(tmp_path / "fit.png")
    assert t_cli.main(["fit", "--colmap", str(tmp_path), "--iters", "3",
                       "--holdout", "2", "--save-ply", ply, "--out", png,
                       *CPU]) == 0
    text = capsys.readouterr().out
    assert "loaded 4 views @32x24, 200 SfM points" in text
    done = [ln for ln in text.splitlines() if ln.startswith("fit done")][0]
    train_psnr = float(done.split("train PSNR ")[1].split()[0])
    test_psnr = float(done.split("test PSNR ")[1].split()[0])
    assert np.isfinite(train_psnr) and np.isfinite(test_psnr)
    assert load_gaussian_ply(ply, device="cpu").n == 200
    assert read_png(png).shape == (24, 32, 3)


def test_front_ends_without_pil(tmp_path, capsys, monkeypatch):
    """The card's machine has no PIL: the codec, a viewer frame, compare
    and the fit's PNG loading work without it; what needs it raises."""
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError):
        import PIL  # noqa: F401
    img = np.random.default_rng(2).random((24, 32, 3)).astype(np.float32)
    a = str(tmp_path / "a.png")
    save_png(a, img)
    np.testing.assert_array_equal(load_png(a), to_uint8(img) / np.float32(
        255.0))
    assert t_cli.main(["compare", a, a]) == 0
    assert _json_lines(capsys.readouterr().out)[-1]["ssim"] == 1.0

    import urllib.request

    from gsrt_torch import RenderConfig
    from gsrt_torch.utils.image import decode_png
    from gsrt_torch.viewer.server import ViewerServer
    cloud, cam0 = random_cloud(200, width=32, height=24, device="cpu")
    srv = ViewerServer(cloud, RenderConfig(width=32, height=24), cam0,
                       renderer="fast", port=0, device="cpu")
    srv.start()
    try:
        for _ in range(600):
            with srv.state.lock:
                if srv.state.png:
                    break
            srv.state.stop.wait(0.05)
        with urllib.request.urlopen(
                f"http://127.0.0.1:{srv.port}/frame.png", timeout=30) as r:
            assert decode_png(r.read()).shape == (24, 32, 3)
    finally:
        srv.stop()

    _capture(str(tmp_path / "cap"))
    model = t_colmap.load_colmap_model(str(tmp_path / "cap"))
    imgs, w, h = t_colmap.load_image_dir(model, str(tmp_path / "cap" /
                                                    "images"))
    assert imgs.shape == (4, 24, 32, 3) and (w, h) == (32, 24)
    np.testing.assert_array_equal(
        imgs[0], load_png(str(tmp_path / "cap" / "images" / "im_00.png")))
    with pytest.raises(RuntimeError, match="resizing 32x24 to 16x12 needs "
                                           "PIL"):
        t_colmap.load_image_dir(model, str(tmp_path / "cap" / "images"),
                                downscale=2)
    os.rename(tmp_path / "cap" / "images" / "im_00.png",
              tmp_path / "cap" / "images" / "im_00.jpg")
    jpg = model._replace(images=[model.images[0]._replace(
        name="im_00.jpg")])
    with pytest.raises(RuntimeError, match="im_00.jpg: decoding a non-PNG "
                                           "image needs PIL"):
        t_colmap.load_image_dir(jpg, str(tmp_path / "cap" / "images"))


def test_module_entry_point(tmp_path):
    a = str(tmp_path / "a.png")
    save_png(a, np.full((8, 8, 3), 0.5, np.float32))
    r = subprocess.run([sys.executable, "-m", "gsrt_torch.cli", "compare",
                        a, a], capture_output=True, text=True, cwd=REPO,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-800:]
    assert json.loads(r.stdout.splitlines()[-1])["psnr_db"] == 999.0


def test_bench_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the benchmark would run")
    from gsrt_torch import bench
    with pytest.raises(RuntimeError, match="CUDA"):
        bench.main()
