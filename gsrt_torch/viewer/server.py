"""Live HTTP viewer (counterpart of `gsrt.viewer.server`).

The reference opens a GLFW window, feeds key/cursor events into
ModelViewController, re-renders on every change, and draws an ImGui
overlay with fps / Mrays/s / settings / a heatmap toggle
(RayTracingInVulkan/src/UserInterface.cpp, src/RayTracer.cpp:172-189,
ModelViewController.cpp). A GPU server has no display either, so the port
serves the same loop over HTTP: a self-contained browser page (stdlib
http.server) streams PNG frames, encoded by the port's own codec
(`gsrt_torch.utils.image`), and posts key/mouse events back. The render
loop runs in a host thread and re-renders only when the camera or a
setting changed; moving frames flow through `gsrt_torch.serving`'s
temporal-reuse renderer by default.

An exception in the render thread is kept: `/stats` then answers 500 with
its traceback and `stop()` raises it.

Endpoints:
  GET  /           the viewer page (canvas + overlay, inline JS)
  GET  /frame.png  latest rendered frame (heatmap applied if toggled)
  GET  /stats      JSON: fps, ms, mrays_s, splats, frame id, settings
  POST /input      {type: key|button|cursor|setting, ...} events
"""

from __future__ import annotations

import json
import threading
import time
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional

from gsrt_torch.core.config import RenderConfig
from gsrt_torch.core.types import (Camera, GaussianCloud, make_camera,
                                   resolve_device)
from gsrt_torch.utils.heatmap import heatmap
from gsrt_torch.utils.image import as_numpy, png_bytes
from gsrt_torch.viewer.controller import CameraController

_PAGE = """<!doctype html>
<html><head><title>gsrt viewer</title><style>
 body { margin:0; background:#111; color:#ddd; font:13px monospace; }
 #wrap { position:relative; display:inline-block; }
 #overlay { position:absolute; top:8px; left:8px; background:#000a;
            padding:6px 10px; white-space:pre; pointer-events:none; }
 img { display:block; image-rendering:pixelated; }
</style></head><body>
<div id="wrap"><img id="frame" width="WIDTH" height="HEIGHT">
<div id="overlay">connecting...</div></div>
<div style="padding:6px">WASD fly &middot; shift/ctrl up/down &middot;
left-drag look &middot; right-drag rotate model &middot; H heatmap</div>
<script>
const post = (o) => fetch('/input', {method:'POST', body:JSON.stringify(o)});
const img = document.getElementById('frame');
const ov = document.getElementById('overlay');
const keymap = {KeyW:'w',KeyA:'a',KeyS:'s',KeyD:'d',
                ShiftLeft:'shift',ControlLeft:'ctrl'};
document.addEventListener('keydown', e => {
  if (e.code === 'KeyH') { post({type:'setting', heatmap:'toggle'}); return; }
  const k = keymap[e.code]; if (k) { post({type:'key', key:k, pressed:true});
                                     e.preventDefault(); }});
document.addEventListener('keyup', e => {
  const k = keymap[e.code]; if (k) post({type:'key', key:k, pressed:false});});
img.addEventListener('contextmenu', e => e.preventDefault());
img.addEventListener('mousedown', e => post({type:'button',
  button: e.button === 2 ? 'right' : 'left', pressed:true}));
document.addEventListener('mouseup', e => post({type:'button',
  button: e.button === 2 ? 'right' : 'left', pressed:false}));
img.addEventListener('mousemove', e => post({type:'cursor',
  x:e.clientX, y:e.clientY}));
let frameId = -1;
async function tick() {
  try {
    const s = await (await fetch('/stats')).json();
    ov.textContent = s.overlay;
    if (s.frame_id !== frameId) {
      frameId = s.frame_id;
      img.src = '/frame.png?id=' + frameId;
    }
  } catch (e) {}
  setTimeout(tick, 50);
}
tick();
</script></body></html>"""


class ViewerState:
    """Shared state between the HTTP handlers and the render thread."""

    def __init__(self, controller: CameraController):
        self.controller = controller
        self.lock = threading.Lock()
        self.png: bytes = b""
        self.frame_id = 0
        self.stats: dict = {}
        self.heatmap = False
        self.speed = 1.0
        self.dirty = True          # force first render
        self.stop = threading.Event()
        self.error: Optional[Exception] = None   # the render thread's
        self.error_text = ""

    def handle_input(self, ev) -> None:
        if not isinstance(ev, dict):
            raise ValueError("an input event is a JSON object")
        with self.lock:
            c = self.controller
            t = ev.get("type")
            if t == "key":
                c.on_key(str(ev.get("key", "")), bool(ev.get("pressed")))
            elif t == "button":
                c.on_mouse_button(str(ev.get("button", "")),
                                  bool(ev.get("pressed")))
            elif t == "cursor":
                c.on_cursor(float(ev.get("x", 0)), float(ev.get("y", 0)))
            elif t == "setting":
                if ev.get("heatmap") == "toggle":
                    self.heatmap = not self.heatmap
                elif "heatmap" in ev:
                    self.heatmap = bool(ev["heatmap"])
                if "speed" in ev and ev["speed"] != "toggle":
                    self.speed = float(ev["speed"])
                self.dirty = True


class ViewerServer:
    """Serve an interactive render session for one Gaussian cloud on
    `device` (CUDA unless named).

    `renderer`: "serving" (temporal reuse, the default), "tiled", "fast",
    "reference", or any callable (cloud, camera) -> RenderOutput.
    """

    def __init__(self, cloud: GaussianCloud, cfg: RenderConfig,
                 init_camera: Camera, *, renderer="serving",
                 fov_y_deg: float = 40.0, host: str = "127.0.0.1",
                 port: int = 8000, device=None, max_fps: float = 30.0):
        self.device = resolve_device(device)
        self.cloud = cloud.to(self.device)
        self.cfg = cfg
        self.fov = fov_y_deg
        self.max_fps = max_fps
        ctl = CameraController(as_numpy(init_camera.view))
        self.state = ViewerState(ctl)
        self._render = self._make_renderer(renderer)

        state = self.state
        width, height = cfg.width, cfg.height

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):        # quiet
                pass

            def _send(self, code, body, ctype):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.send_header("Cache-Control", "no-store")
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                path = self.path.split("?")[0]
                if path == "/":
                    page = (_PAGE.replace("WIDTH", str(width))
                                 .replace("HEIGHT", str(height)))
                    self._send(200, page.encode(), "text/html")
                elif path == "/frame.png":
                    with state.lock:
                        body = state.png
                    if not body:
                        self._send(503, b"no frame yet", "text/plain")
                    else:
                        self._send(200, body, "image/png")
                elif path == "/stats":
                    with state.lock:
                        failed = state.error is not None
                        body = json.dumps(
                            {"error": state.error_text} if failed
                            else state.stats).encode()
                    self._send(500 if failed else 200, body,
                               "application/json")
                else:
                    self._send(404, b"not found", "text/plain")

            def do_POST(self):
                if self.path.split("?")[0] != "/input":
                    self._send(404, b"not found", "text/plain")
                    return
                n = int(self.headers.get("Content-Length", 0))
                try:
                    ev = json.loads(self.rfile.read(n) or b"{}")
                    state.handle_input(ev)
                    self._send(200, b"ok", "text/plain")
                except (ValueError, KeyError) as e:
                    self._send(400, str(e).encode(), "text/plain")

        self.httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self.httpd.server_address[1]
        self._threads: list[threading.Thread] = []

    def _make_renderer(self, renderer) -> Callable:
        if callable(renderer):
            return renderer
        if renderer == "serving":
            from gsrt_torch.serving import ServingRenderer
            return ServingRenderer(self.cfg, device=self.device)
        if renderer in ("tiled", "fast", "reference"):
            from gsrt_torch.models.gaussian_rt import GaussianRayTracer
            return GaussianRayTracer(self.cfg, mode=renderer,
                                     device=self.device)
        raise ValueError(f"unknown renderer {renderer!r}")

    # --- render loop ------------------------------------------------------
    def _loop(self) -> None:
        try:
            self._run()
        except Exception as e:   # the thread's boundary: kept for stop()
            with self.state.lock:
                self.state.error = e
                self.state.error_text = traceback.format_exc()

    def _run(self) -> None:
        state = self.state
        cfg = self.cfg
        n = self.cloud.n
        last = time.perf_counter()
        fps_ema = 0.0
        while not state.stop.is_set():
            now = time.perf_counter()
            dt, last = now - last, now
            with state.lock:
                changed = state.controller.update(state.speed, dt)
                changed |= state.dirty
                state.dirty = False
                view = state.controller.view()
                heat = state.heatmap
            if not changed:
                state.stop.wait(0.02)
                continue
            t0 = time.perf_counter()
            camera = make_camera(view, self.fov, cfg.width, cfg.height,
                                 device=self.device)
            out = self._render(self.cloud, camera)
            # the host fetch waits for the frame
            img = heatmap(out.hits) if heat else as_numpy(out.color)
            ms = (time.perf_counter() - t0) * 1e3
            fps = 1000.0 / max(ms, 1e-6)
            fps_ema = fps if fps_ema == 0 else 0.8 * fps_ema + 0.2 * fps
            mrays = cfg.width * cfg.height / (ms * 1e-3) / 1e6
            png = png_bytes(img)
            with state.lock:
                state.png = png
                state.frame_id += 1
                # the reference overlay: fps + Mrays/s + settings
                # (UserInterface.cpp stats panel, RayTracer.cpp:180-183)
                state.stats = dict(
                    frame_id=state.frame_id, ms=round(ms, 2),
                    fps=round(fps_ema, 2), mrays_s=round(mrays, 3),
                    splats=n, width=cfg.width, height=cfg.height,
                    heatmap=heat, speed=state.speed,
                    overlay=(f"{fps_ema:6.1f} fps  {ms:7.1f} ms  "
                             f"{mrays:6.2f} Mrays/s\n"
                             f"{n} splats  {cfg.width}x{cfg.height}"
                             f"{'  [heatmap]' if heat else ''}"))
            # frame-rate cap
            sleep = 1.0 / self.max_fps - (time.perf_counter() - t0)
            if sleep > 0:
                state.stop.wait(sleep)

    def start(self) -> None:
        t1 = threading.Thread(target=self._loop, daemon=True)
        t2 = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        t1.start()
        t2.start()
        self._threads = [t1, t2]

    def stop(self) -> None:
        """Stop serving and rendering; raises the render thread's
        exception, if it had one."""
        self.state.stop.set()
        if self._threads:
            self.httpd.shutdown()
        self.httpd.server_close()
        for t in self._threads:
            t.join(timeout=30)
        if self.state.error is not None:
            raise self.state.error

    def serve_forever(self) -> None:
        """Serve until interrupted or until the render thread fails."""
        self.start()
        try:
            while self.state.error is None:
                time.sleep(0.5)
        except KeyboardInterrupt:
            pass
        self.stop()
