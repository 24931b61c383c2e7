"""COLMAP capture loading for multi-view 3DGS fitting (counterpart of
`gsrt.scene.colmap`, a copy of its NumPy readers and writers; only
`init_params_from_points` differs: it returns the port's parameters on a
device, CUDA unless named).

Loads a COLMAP sparse reconstruction (cameras, poses, SfM points; text or
binary), initialises a Gaussian cloud from the SfM points and hands the
posed images to the multi-view trainer (`gsrt_torch.models.multiview`).

Conventions: COLMAP's camera frame is x-right / y-down / z-forward with
X_cam = R(q)·X_world + t, the port's Camera convention (+z forward, y
down), so a pose maps 1:1 into the view matrix with no axis flips.

Distortion parameters (SIMPLE_RADIAL k, OPENCV k1..p2) are parsed but
ignored: rendering assumes undistorted images (the Mip-NeRF360 release
and INRIA's loader use the undistorted `images/` set). `load_image_dir`
reads a PNG of the model's size with the port's own codec; JPEG and
resizing import PIL inside the function (and raise without it).
"""

from __future__ import annotations

import os
import struct
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch


class ColmapCamera(NamedTuple):
    model: str
    width: int
    height: int
    fx: float
    fy: float
    cx: float
    cy: float


class ColmapImage(NamedTuple):
    name: str
    camera_id: int
    view: np.ndarray      # [4,4] world→camera (R(q), t)


class ColmapModel(NamedTuple):
    cameras: Dict[int, ColmapCamera]
    images: List[ColmapImage]     # sorted by file name (deterministic split)
    points: np.ndarray            # [P, 3] f32 SfM points
    colors: np.ndarray            # [P, 3] f32 in [0, 1]


# camera model id → (name, param count); params order per COLMAP docs
_MODELS = {
    0: ("SIMPLE_PINHOLE", 3),   # f, cx, cy
    1: ("PINHOLE", 4),          # fx, fy, cx, cy
    2: ("SIMPLE_RADIAL", 4),    # f, cx, cy, k
    3: ("RADIAL", 5),           # f, cx, cy, k1, k2
    4: ("OPENCV", 8),           # fx, fy, cx, cy, k1, k2, p1, p2
    5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12),
    7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}
_NAME2ID = {name: mid for mid, (name, _) in _MODELS.items()}


def _intrinsics(model: str, params) -> Tuple[float, float, float, float]:
    p = [float(v) for v in params]
    if model in ("SIMPLE_PINHOLE", "SIMPLE_RADIAL", "RADIAL",
                 "SIMPLE_RADIAL_FISHEYE", "RADIAL_FISHEYE"):
        return p[0], p[0], p[1], p[2]
    # fx fy cx cy leading for the OpenCV-family and PINHOLE models
    return p[0], p[1], p[2], p[3]


def quat_to_rot(qw: float, qx: float, qy: float, qz: float) -> np.ndarray:
    """COLMAP Hamilton-convention unit quaternion → rotation matrix (same
    formula as gsrt_torch.ops.gaussian.quat_scale_to_cov3d's R)."""
    n = max(np.sqrt(qw * qw + qx * qx + qy * qy + qz * qz), 1e-12)
    w, x, y, z = qw / n, qx / n, qy / n, qz / n
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ], np.float64)


def _view_from_qt(q, t) -> np.ndarray:
    view = np.eye(4, dtype=np.float32)
    view[:3, :3] = quat_to_rot(*q)
    view[:3, 3] = t
    return view


# ---------------------------------------------------------------- text ---

def _read_cameras_txt(path: str) -> Dict[int, ColmapCamera]:
    cams: Dict[int, ColmapCamera] = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            tok = line.split()
            cid, model, w, h = int(tok[0]), tok[1], int(tok[2]), int(tok[3])
            fx, fy, cx, cy = _intrinsics(model, tok[4:])
            cams[cid] = ColmapCamera(model, w, h, fx, fy, cx, cy)
    return cams


def _read_images_txt(path: str) -> List[ColmapImage]:
    out: List[ColmapImage] = []
    with open(path) as f:
        lines = f.readlines()
    # two lines per image: pose line, then the 2D-point line — which may
    # be EMPTY (no observations), so pair with a cursor, not [0::2]
    i = 0
    while i < len(lines):
        ln = lines[i].strip()
        i += 1
        if not ln or ln.startswith("#"):
            continue
        tok = ln.split()
        q = tuple(float(v) for v in tok[1:5])
        t = [float(v) for v in tok[5:8]]
        out.append(ColmapImage(name=tok[9], camera_id=int(tok[8]),
                               view=_view_from_qt(q, t)))
        i += 1          # consume the (possibly empty) 2D-point line
    return out


def _read_points_txt(path: str) -> Tuple[np.ndarray, np.ndarray]:
    pts, cols = [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            tok = line.split()
            pts.append([float(v) for v in tok[1:4]])
            cols.append([float(v) for v in tok[4:7]])
    if not pts:
        return (np.zeros((0, 3), np.float32),) * 2
    return (np.asarray(pts, np.float32),
            np.asarray(cols, np.float32) / 255.0)


# -------------------------------------------------------------- binary ---

def _read_cameras_bin(path: str) -> Dict[int, ColmapCamera]:
    cams: Dict[int, ColmapCamera] = {}
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        for _ in range(n):
            cid, mid, w, h = struct.unpack("<iiQQ", f.read(24))
            name, n_par = _MODELS[mid]
            params = struct.unpack(f"<{n_par}d", f.read(8 * n_par))
            fx, fy, cx, cy = _intrinsics(name, params)
            cams[cid] = ColmapCamera(name, int(w), int(h), fx, fy, cx, cy)
    return cams


def _read_images_bin(path: str) -> List[ColmapImage]:
    out: List[ColmapImage] = []
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        for _ in range(n):
            _iid, qw, qx, qy, qz, tx, ty, tz, cid = struct.unpack(
                "<idddddddi", f.read(64))
            name = b""
            while True:
                c = f.read(1)
                if c == b"\x00":
                    break
                name += c
            (n2d,) = struct.unpack("<Q", f.read(8))
            f.seek(24 * n2d, os.SEEK_CUR)     # x, y, point3D_id per 2D point
            out.append(ColmapImage(
                name=name.decode("utf-8"), camera_id=cid,
                view=_view_from_qt((qw, qx, qy, qz), [tx, ty, tz])))
    return out


def _read_points_bin(path: str) -> Tuple[np.ndarray, np.ndarray]:
    pts, cols = [], []
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        for _ in range(n):
            _pid, x, y, z, r, g, b, _err = struct.unpack(
                "<QdddBBBd", f.read(43))
            (tlen,) = struct.unpack("<Q", f.read(8))
            f.seek(8 * tlen, os.SEEK_CUR)     # (image_id, point2D_idx) pairs
            pts.append([x, y, z])
            cols.append([r, g, b])
    if not pts:
        return (np.zeros((0, 3), np.float32),) * 2
    return (np.asarray(pts, np.float32),
            np.asarray(cols, np.float32) / 255.0)


# -------------------------------------------------------------- loader ---

def load_colmap_model(sparse_dir: str) -> ColmapModel:
    """Load a COLMAP sparse model directory (auto-detects .bin vs .txt;
    accepts either `<scene>/sparse/0` directly or a `<scene>` root that
    contains `sparse/0` or `sparse`)."""
    for sub in ("", "sparse/0", "sparse"):
        d = os.path.join(sparse_dir, sub)
        if (os.path.exists(os.path.join(d, "cameras.bin"))
                or os.path.exists(os.path.join(d, "cameras.txt"))):
            sparse_dir = d
            break
    else:
        raise FileNotFoundError(
            f"no COLMAP model (cameras.bin/.txt) under {sparse_dir!r}")

    if os.path.exists(os.path.join(sparse_dir, "cameras.bin")):
        cams = _read_cameras_bin(os.path.join(sparse_dir, "cameras.bin"))
        imgs = _read_images_bin(os.path.join(sparse_dir, "images.bin"))
        ppath = os.path.join(sparse_dir, "points3D.bin")
        pts, cols = (_read_points_bin(ppath) if os.path.exists(ppath)
                     else (np.zeros((0, 3), np.float32),) * 2)
    else:
        cams = _read_cameras_txt(os.path.join(sparse_dir, "cameras.txt"))
        imgs = _read_images_txt(os.path.join(sparse_dir, "images.txt"))
        ppath = os.path.join(sparse_dir, "points3D.txt")
        pts, cols = (_read_points_txt(ppath) if os.path.exists(ppath)
                     else (np.zeros((0, 3), np.float32),) * 2)
    imgs.sort(key=lambda im: im.name)
    return ColmapModel(cameras=cams, images=imgs, points=pts, colors=cols)


def scene_extent(model: ColmapModel) -> float:
    """INRIA's scene scale: radius of the camera-center bounding sphere
    (used to set densify scale thresholds and spatial learning rates)."""
    if not model.images:
        return 1.0
    centers = np.stack([-im.view[:3, :3].T @ im.view[:3, 3]
                        for im in model.images])
    mid = centers.mean(0)
    return float(np.linalg.norm(centers - mid, axis=-1).max()) or 1.0


def knn_mean_dist(points: np.ndarray, k: int = 3) -> np.ndarray:
    """[P] mean distance to each point's k nearest neighbors (INRIA's
    initial splat scale; cKDTree on the host, a one-time set-up cost)."""
    from scipy.spatial import cKDTree
    if points.shape[0] <= k:
        return np.full((points.shape[0],), 0.1, np.float32)
    d, _ = cKDTree(points).query(points, k=k + 1)   # col 0 = self (d=0)
    return d[:, 1:].mean(-1).astype(np.float32)


def init_params_from_points(points: np.ndarray, colors: np.ndarray,
                            sh_degree: int = 0, opacity: float = 0.1,
                            device=None):
    """SfM points → GaussianParams on `device`, the INRIA initialisation:
    isotropic scales at the kNN mean distance, identity rotations,
    logit(0.1) opacity, colours in the SH DC term ((rgb − 0.5)/C0)."""
    from gsrt_torch.models.trainer import GaussianParams
    from gsrt_torch.ops.sh import C0 as SH_C0

    P = points.shape[0]
    dist = np.clip(knn_mean_dist(points), 1e-7, None)
    K = (sh_degree + 1) ** 2
    sh = np.zeros((P, K, 3), np.float32)
    sh[:, 0, :] = (colors - 0.5) / SH_C0
    quats = np.zeros((P, 4), np.float32)
    quats[:, 0] = 1.0
    op_logit = float(np.log(opacity / (1.0 - opacity)))
    t = torch.as_tensor
    return GaussianParams(
        means=t(np.asarray(points, np.float32)),
        log_scales=t(np.log(dist))[:, None].repeat(1, 3),
        quats=t(quats),
        opacity_logit=torch.full((P,), op_logit, dtype=torch.float32),
        sh=t(sh), device=device)


def _read_rgb(path: str, w: int, h: int) -> np.ndarray:
    """One capture image as [h, w, 3] f32 in [0, 1]. A PNG of that size is
    read by the port's codec; JPEG, a PNG variant the codec does not read
    and resizing (LANCZOS) need PIL, and raise RuntimeError without it."""
    from gsrt_torch.utils.image import read_png
    if path.lower().endswith(".png"):
        try:
            img = read_png(path)
        except ValueError as e:
            why = f"decoding it ({e})"
        else:
            if img.shape[:2] == (h, w):
                return img.astype(np.float32) / 255.0
            why = f"resizing {img.shape[1]}x{img.shape[0]} to {w}x{h}"
    else:
        why = "decoding a non-PNG image"
    try:
        from PIL import Image
    except ImportError:
        raise RuntimeError(f"{path}: {why} needs PIL, which is not "
                           f"installed") from None
    img = Image.open(path).convert("RGB")
    if img.size != (w, h):
        img = img.resize((w, h), Image.LANCZOS)
    return np.asarray(img, np.float32) / 255.0


def load_image_dir(model: ColmapModel, images_dir: str,
                   downscale: int = 1,
                   limit: Optional[int] = None):
    """Load the capture's images (resized by 1/downscale) in model.images
    order. Returns (images [V,H,W,3] f32, width, height) — all views must
    share one camera resolution (true for the Mip-NeRF360/INRIA sets)."""
    ims = model.images[:limit] if limit else model.images
    if not ims:
        raise ValueError("COLMAP model contains no images")
    cam = model.cameras[ims[0].camera_id]
    w, h = cam.width // downscale, cam.height // downscale
    out = np.zeros((len(ims), h, w, 3), np.float32)
    for i, im in enumerate(ims):
        out[i] = _read_rgb(os.path.join(images_dir, im.name), w, h)
    return out, w, h


# ------------------------------------------------------------- writers ---
# (test fixtures and export for tools that read COLMAP models)

def write_text_model(dirpath: str, model: ColmapModel) -> None:
    os.makedirs(dirpath, exist_ok=True)
    with open(os.path.join(dirpath, "cameras.txt"), "w") as f:
        f.write("# cameras\n")
        for cid, c in model.cameras.items():
            f.write(f"{cid} PINHOLE {c.width} {c.height} "
                    f"{c.fx} {c.fy} {c.cx} {c.cy}\n")
    with open(os.path.join(dirpath, "images.txt"), "w") as f:
        f.write("# images\n")
        for i, im in enumerate(model.images):
            q = rot_to_quat(im.view[:3, :3])
            t = im.view[:3, 3]
            f.write(f"{i + 1} {q[0]} {q[1]} {q[2]} {q[3]} "
                    f"{t[0]} {t[1]} {t[2]} {im.camera_id} {im.name}\n\n")
    with open(os.path.join(dirpath, "points3D.txt"), "w") as f:
        f.write("# points\n")
        for i, (p, c) in enumerate(zip(model.points, model.colors)):
            r, g, b = (int(v * 255) for v in c)
            f.write(f"{i + 1} {p[0]} {p[1]} {p[2]} {r} {g} {b} 0.0\n")


def write_binary_model(dirpath: str, model: ColmapModel) -> None:
    os.makedirs(dirpath, exist_ok=True)
    with open(os.path.join(dirpath, "cameras.bin"), "wb") as f:
        f.write(struct.pack("<Q", len(model.cameras)))
        for cid, c in model.cameras.items():
            f.write(struct.pack("<iiQQ", cid, _NAME2ID["PINHOLE"],
                                c.width, c.height))
            f.write(struct.pack("<4d", c.fx, c.fy, c.cx, c.cy))
    with open(os.path.join(dirpath, "images.bin"), "wb") as f:
        f.write(struct.pack("<Q", len(model.images)))
        for i, im in enumerate(model.images):
            q = rot_to_quat(im.view[:3, :3])
            t = im.view[:3, 3]
            f.write(struct.pack("<idddddddi", i + 1, *q, *t, im.camera_id))
            f.write(im.name.encode("utf-8") + b"\x00")
            f.write(struct.pack("<Q", 0))
    with open(os.path.join(dirpath, "points3D.bin"), "wb") as f:
        f.write(struct.pack("<Q", model.points.shape[0]))
        for i, (p, c) in enumerate(zip(model.points, model.colors)):
            rgb = tuple(int(v * 255) for v in c)
            f.write(struct.pack("<QdddBBBd", i + 1, *map(float, p),
                                *rgb, 0.0))
            f.write(struct.pack("<Q", 0))


def rot_to_quat(R: np.ndarray) -> np.ndarray:
    """Rotation matrix → unit quaternion (w, x, y, z), w ≥ 0. Shepperd's
    branch selection keeps the divisor away from zero."""
    tr = np.trace(R)
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2
        q = np.array([0.25 * s, (R[2, 1] - R[1, 2]) / s,
                      (R[0, 2] - R[2, 0]) / s, (R[1, 0] - R[0, 1]) / s])
    elif R[0, 0] >= R[1, 1] and R[0, 0] >= R[2, 2]:
        s = np.sqrt(1.0 + R[0, 0] - R[1, 1] - R[2, 2]) * 2
        q = np.array([(R[2, 1] - R[1, 2]) / s, 0.25 * s,
                      (R[0, 1] + R[1, 0]) / s, (R[0, 2] + R[2, 0]) / s])
    elif R[1, 1] >= R[2, 2]:
        s = np.sqrt(1.0 + R[1, 1] - R[0, 0] - R[2, 2]) * 2
        q = np.array([(R[0, 2] - R[2, 0]) / s, (R[0, 1] + R[1, 0]) / s,
                      0.25 * s, (R[1, 2] + R[2, 1]) / s])
    else:
        s = np.sqrt(1.0 + R[2, 2] - R[0, 0] - R[1, 1]) * 2
        q = np.array([(R[1, 0] - R[0, 1]) / s, (R[0, 2] + R[2, 0]) / s,
                      (R[1, 2] + R[2, 1]) / s, 0.25 * s])
    if q[0] < 0:
        q = -q
    return q / np.linalg.norm(q)
