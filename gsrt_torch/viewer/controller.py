"""Interactive camera controller — ModelViewController parity
(counterpart of `gsrt.viewer.controller`, which is NumPy only; the port
keeps its own copy).

The reference drives its interactive window with a small state machine
(RayTracingInVulkan/src/ModelViewController.cpp):

  * WASD + LCtrl/LShift toggle per-axis motion flags (OnKey, :37-50);
    UpdateCamera(speed, dt) integrates position along the CAMERA basis
    vectors (:88-116, MoveForward/MoveRight/MoveUp :118-131).
  * Left-drag accumulates cursor deltas (OnCursorPosition :52-73); each
    update applies them as pitch-in-camera-space x yaw-about-world-Y,
    1/300 radians per pixel (Rotate :133-140, rotationDiv=300 :98).
  * Right-drag rotates the MODEL instead: 90 deg per 300 px about world
    Y then X, composed into the final modelview (ModelView() :23-35).

This is that controller rebuilt for gsrt's camera convention (world->
camera view matrix, camera looks down +z, x right, y DOWN --
gsrt_torch.core.types.Camera). It is pure NumPy host math: one 4x4 per
frame, nothing on the device, so it works the same headless (tests, the
HTTP viewer) and on any device.
"""

from __future__ import annotations

import math

import numpy as np

# pixels of drag per radian — the reference's rotationDiv
# (ModelViewController.cpp:98: Rotate(rotX/300, rotY/300))
ROTATION_DIV = 300.0
# right-drag model rotation: 90 deg per 300 px (ModelView() :25-30)
MODEL_DIV = 300.0


def _rot_x(a: float) -> np.ndarray:
    c, s = math.cos(a), math.sin(a)
    return np.array([[1, 0, 0], [0, c, -s], [0, s, c]], np.float64)


def _rot_y(a: float) -> np.ndarray:
    c, s = math.cos(a), math.sin(a)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float64)


class CameraController:
    """WASD-fly + mouse-look camera with the reference's control surface.

    Keys are lowercase strings ("w", "a", "s", "d", "ctrl", "shift");
    buttons are "left" / "right". `update(speed, dt)` returns True when
    the camera changed — the render loop's redraw trigger, exactly like
    the reference's UpdateCamera return feeding RayTracer::OnKey resets.
    """

    _KEY_FLAGS = {"w": "forward", "s": "backward", "a": "left",
                  "d": "right", "ctrl": "down", "shift": "up"}

    def __init__(self, view: np.ndarray | None = None):
        self._flags = {f: False for f in self._KEY_FLAGS.values()}
        self._rot_dx = 0.0      # accumulated left-drag pixels
        self._rot_dy = 0.0
        self._model_dx = 0.0    # accumulated right-drag pixels (total)
        self._model_dy = 0.0
        self._cursor = None     # last (x, y), None until first event
        self._pressed = {"left": False, "right": False}
        self.orientation = np.eye(3)   # world->camera rotation
        self.position = np.zeros(3)    # camera origin, world space
        if view is not None:
            self.reset(view)

    # --- event surface (ModelViewController::OnKey/OnMouseButton/
    # OnCursorPosition) -------------------------------------------------
    def reset(self, view: np.ndarray) -> None:
        """Adopt an existing world->camera matrix (Reset(), :4-20)."""
        view = np.asarray(view, np.float64)
        r = view[:3, :3]
        # re-orthonormalize (scene files carry f32 matrices)
        u, _, vt = np.linalg.svd(r)
        self.orientation = u @ vt
        self.position = -self.orientation.T @ view[:3, 3]
        self._rot_dx = self._rot_dy = 0.0
        self._model_dx = self._model_dy = 0.0
        self._pressed = {"left": False, "right": False}
        self._cursor = None

    def on_key(self, key: str, pressed: bool) -> bool:
        flag = self._KEY_FLAGS.get(key.lower())
        if flag is None:
            return False
        self._flags[flag] = bool(pressed)
        return True

    def on_mouse_button(self, button: str, pressed: bool) -> bool:
        if button not in self._pressed:
            return False
        self._pressed[button] = bool(pressed)
        return True

    def on_cursor(self, x: float, y: float) -> bool:
        if self._cursor is None:
            self._cursor = (x, y)
            return False
        dx, dy = x - self._cursor[0], y - self._cursor[1]
        self._cursor = (x, y)
        if self._pressed["left"]:
            self._rot_dx += dx
            self._rot_dy += dy
        if self._pressed["right"]:
            self._model_dx += dx
            self._model_dy += dy
        return self._pressed["left"] or self._pressed["right"]

    # --- camera basis in world space (y-down convention) ----------------
    @property
    def forward(self) -> np.ndarray:
        return self.orientation.T @ np.array([0.0, 0.0, 1.0])

    @property
    def right(self) -> np.ndarray:
        return self.orientation.T @ np.array([1.0, 0.0, 0.0])

    @property
    def up(self) -> np.ndarray:
        # screen-up: camera y points DOWN, so up is -y
        return self.orientation.T @ np.array([0.0, -1.0, 0.0])

    # --- per-frame integration (UpdateCamera, :88-116) -------------------
    def update(self, speed: float, dt: float) -> bool:
        d = float(speed) * float(dt)
        moved = False
        if self._flags["left"]:
            self.position -= d * self.right
            moved = True
        if self._flags["right"]:
            self.position += d * self.right
            moved = True
        if self._flags["backward"]:
            self.position -= d * self.forward
            moved = True
        if self._flags["forward"]:
            self.position += d * self.forward
            moved = True
        if self._flags["down"]:
            self.position -= d * self.up
            moved = True
        if self._flags["up"]:
            self.position += d * self.up
            moved = True

        rotated = self._rot_dx != 0.0 or self._rot_dy != 0.0
        if rotated:
            # drag right -> yaw right (about world Y), drag up -> look up
            # (pitch about camera x). Pitch PRE-multiplies (camera frame),
            # yaw POST-multiplies (world frame) — Rotate(), :133-140.
            # y-down flips the pitch sign relative to the GL original.
            yaw = self._rot_dx / ROTATION_DIV
            pitch = self._rot_dy / ROTATION_DIV
            self.orientation = (_rot_x(pitch) @ self.orientation
                                @ _rot_y(yaw))
            self._rot_dx = self._rot_dy = 0.0
        return moved or rotated

    # --- matrices --------------------------------------------------------
    def model_matrix(self) -> np.ndarray:
        """Right-drag model rotation (ModelView(), :23-35): 90 deg per
        MODEL_DIV px, yaw about world Y then pitch about world X."""
        my = self._model_dx / MODEL_DIV * (math.pi / 2.0)
        mx = self._model_dy / MODEL_DIV * (math.pi / 2.0)
        m = np.eye(4)
        m[:3, :3] = _rot_y(my) @ _rot_x(mx)
        return m

    def view(self) -> np.ndarray:
        """world->camera 4x4 including the model rotation:
        view_total = view @ model (ModelView(), :34)."""
        v = np.eye(4)
        v[:3, :3] = self.orientation
        v[:3, 3] = -self.orientation @ self.position
        return v @ self.model_matrix()
