"""gsrt_torch.viewer: the camera controller held against the JAX
package's over the event sequences of tests/test_viewer.py (view
matrices and the controller's answers; atol 1e-6), and the HTTP server
end to end on the CPU at 64x48: the page, a frame equal to a direct
render, input, the heatmap, bad input, and a failing renderer.

Tolerances: view matrices atol 1e-6 (both float64 NumPy, the same
operations: they agree to the last place in practice); the served frame,
decoded by the port's codec, byte-equal to `to_uint8` of a direct
`render_fast` at the controller's first view.
"""

from __future__ import annotations

import json
import math
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import _torch_env  # noqa: F401
from gsrt.core.types import look_at as j_look_at
from gsrt.viewer import controller as j_ctl

from gsrt_torch import RenderConfig
from gsrt_torch.core.types import look_at, make_camera
from gsrt_torch.models.gaussian_rt import render_fast
from gsrt_torch.scene.catalog import random_cloud
from gsrt_torch.utils.image import decode_png, to_uint8
from gsrt_torch.viewer import controller as t_ctl
from gsrt_torch.viewer.server import ViewerServer

W, H = 64, 48
R = t_ctl.ROTATION_DIV


def _drags(n=200, seed=0):
    rng = np.random.default_rng(seed)
    xy = np.cumsum(rng.normal(0, 40, (n, 2)), 0)
    return [("cursor", float(x), float(y)) for x, y in xy]


# the event sequences of tests/test_viewer.py: ("key", k, pressed),
# ("button", b, pressed), ("cursor", x, y), ("update", speed, dt),
# ("reset", eye, target)
SEQUENCES = {
    "reset": [("reset", (1.0, 2.0, -5.0), (0.3, -0.2, 1.0))],
    "wasd": [("key", "w", True), ("update", 2.0, 0.25), ("key", "w", False),
             ("update", 2.0, 0.25), ("key", "shift", True),
             ("update", 1.0, 1.0), ("key", "a", True), ("key", "ctrl", True),
             ("update", 0.5, 0.1)],
    "unknown-key": [("key", "x", True), ("update", 1.0, 1.0)],
    "drag-without-button": [("cursor", 10, 10), ("cursor", 50, 40),
                            ("update", 1.0, 0.1)],
    "yaw": [("button", "left", True), ("cursor", 0, 0),
            ("cursor", R * math.pi / 2, 0), ("update", 1.0, 0.1)],
    "pitch": [("button", "left", True), ("cursor", 0, 0),
              ("cursor", 0, R * 0.5), ("update", 1.0, 0.1)],
    "many-drags": [("button", "left", True), ("cursor", 0, 0)]
    + [e for c in _drags() for e in (c, ("update", 1.0, 0.016))],
    "model-rotation": [("button", "right", True), ("cursor", 0, 0),
                       ("cursor", 300.0, 0.0), ("update", 1.0, 0.1),
                       ("button", "right", False), ("button", "middle", True),
                       ("key", "d", True), ("update", 1.0, 0.5)],
}


def _drive(ctl, events):
    answers = []
    for ev in events:
        kind, *a = ev
        if kind == "key":
            answers.append(ctl.on_key(*a))
        elif kind == "button":
            answers.append(ctl.on_mouse_button(*a))
        elif kind == "cursor":
            answers.append(ctl.on_cursor(*a))
        elif kind == "update":
            answers.append(ctl.update(*a))
        else:
            ctl.reset(j_look_at(*a))
        answers.append(ctl.view().copy())
    return answers


@pytest.mark.parametrize("name", list(SEQUENCES))
def test_controller_equals_gsrt(name):
    start = j_look_at((0.0, 0.0, -5.0), (0.0, 0.0, 0.0))
    np.testing.assert_array_equal(
        look_at((0.0, 0.0, -5.0), (0.0, 0.0, 0.0)), start)
    jc, tc = j_ctl.CameraController(start), t_ctl.CameraController(start)
    want, got = _drive(jc, SEQUENCES[name]), _drive(tc, SEQUENCES[name])
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, np.ndarray):
            np.testing.assert_allclose(g, w, atol=1e-6)
        else:
            assert g == w
    np.testing.assert_allclose(tc.position, jc.position, atol=1e-6)
    np.testing.assert_allclose(tc.model_matrix(), jc.model_matrix(),
                               atol=1e-6)


# ------------------------------------------------------------------ server


def _scene():
    cloud, cam0 = random_cloud(500, width=W, height=H, device="cpu")
    return cloud, cam0, RenderConfig(width=W, height=H,
                                     conic_mode="standard")


@pytest.fixture
def viewer():
    cloud, cam0, cfg = _scene()
    srv = ViewerServer(cloud, cfg, cam0, renderer="fast", port=0,
                       max_fps=1000.0, device="cpu")
    srv.start()
    yield srv, cloud, cam0, cfg
    srv.stop()


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=30) as r:
        return r.read()


def _post(port, obj):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/input",
                                 data=json.dumps(obj).encode(),
                                 method="POST")
    with urllib.request.urlopen(req, timeout=30) as r:
        return r.read()


def _wait_frame(srv, min_id=1, tries=600):
    for _ in range(tries):
        with srv.state.lock:
            if srv.state.frame_id >= min_id and srv.state.png:
                return srv.state.frame_id
        time.sleep(0.05)
    raise AssertionError(f"no frame >= {min_id} rendered")


def test_server_page_and_first_frame(viewer):
    srv, cloud, cam0, cfg = viewer
    page = _get(srv.port, "/").decode()
    assert "gsrt viewer" in page and "/input" in page
    assert f'width="{W}"' in page
    _wait_frame(srv)
    png = _get(srv.port, "/frame.png")
    assert png[:8] == b"\x89PNG\r\n\x1a\n"
    stats = json.loads(_get(srv.port, "/stats"))
    assert stats["frame_id"] == 1     # no input yet: the first view
    assert stats["splats"] == 500 and stats["width"] == W
    assert stats["mrays_s"] > 0 and "overlay" in stats
    view = t_ctl.CameraController(cam0.view.numpy()).view()
    direct = render_fast(cloud, make_camera(view, srv.fov, W, H,
                                            device="cpu"), cfg).color
    np.testing.assert_array_equal(decode_png(png), to_uint8(direct))


def test_server_input_drives_camera_and_rerender(viewer):
    srv = viewer[0]
    first = _wait_frame(srv)
    pos0 = srv.state.controller.position.copy()
    _post(srv.port, {"type": "key", "key": "w", "pressed": True})
    _wait_frame(srv, first + 1)
    _post(srv.port, {"type": "key", "key": "w", "pressed": False})
    assert not np.allclose(srv.state.controller.position, pos0)
    assert json.loads(_get(srv.port, "/stats"))["frame_id"] > first


def test_server_heatmap_toggle(viewer):
    srv = viewer[0]
    _wait_frame(srv)
    _post(srv.port, {"type": "setting", "heatmap": "toggle"})
    for _ in range(600):
        stats = json.loads(_get(srv.port, "/stats"))
        if stats["heatmap"]:
            break
        time.sleep(0.05)
    assert stats["heatmap"] is True and "[heatmap]" in stats["overlay"]
    png = decode_png(_get(srv.port, "/frame.png"))
    assert png.shape == (H, W, 3)


@pytest.mark.parametrize("body", [b"{not json", b"[1, 2]",
                                  b'{"type": "cursor", "x": "left"}'])
def test_server_rejects_bad_input(viewer, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{viewer[0].port}/input", data=body,
        method="POST")
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req, timeout=30)
    assert e.value.code == 400


def test_renderer_exception_comes_out_of_stop():
    cloud, cam0, cfg = _scene()

    def broken(cloud, camera):
        raise FloatingPointError("renderer failed on purpose")

    srv = ViewerServer(cloud, cfg, cam0, renderer=broken, port=0,
                       device="cpu")
    srv.start()
    for _ in range(600):
        if srv.state.error is not None:
            break
        time.sleep(0.05)
    with pytest.raises(urllib.error.HTTPError) as e:
        _get(srv.port, "/stats")
    assert e.value.code == 500
    assert "renderer failed on purpose" in json.loads(e.value.read())[
        "error"]
    with pytest.raises(FloatingPointError, match="on purpose"):
        srv.stop()
    assert not any(t.is_alive() for t in srv._threads)


def test_unknown_renderer_and_default_device():
    cloud, cam0, cfg = _scene()
    with pytest.raises(ValueError, match="unknown renderer"):
        ViewerServer(cloud, cfg, cam0, renderer="magic", port=0,
                     device="cpu")
    if not torch.cuda.is_available():   # CUDA unless named
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ViewerServer(cloud, cfg, cam0, port=0)
