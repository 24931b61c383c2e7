"""3D Gaussian Splatting `.ply` files, INRIA layout (counterpart of
`gsrt.scene.ply`).

Per vertex: x y z nx ny nz f_dc_{0..2} f_rest_{..} opacity scale_{0..2}
rot_{0..3}, with opacity a logit, scales logs and rot a (w, x, y, z)
quaternion; f_rest is channel-major. All-f32 files decode through the
native row parser (`gsrt_torch.native`) where it is built, else in
NumPy. The cloud goes to CUDA unless device="cpu".
"""

from __future__ import annotations

import io
from typing import List, Tuple

import numpy as np
import torch

from gsrt_torch.core.types import GaussianCloud, resolve_device
from gsrt_torch.ops.gaussian import quat_scale_to_cov3d

_DTYPES = {
    "float": "<f4", "float32": "<f4", "double": "<f8",
    "uchar": "u1", "uint8": "u1", "char": "i1",
    "short": "<i2", "ushort": "<u2",
    "int": "<i4", "uint": "<u4", "int32": "<i4",
}


def _parse_header(f) -> Tuple[int, List[Tuple[str, str]], str]:
    if f.readline().strip() != b"ply":
        raise ValueError("not a PLY file")
    fmt, count, in_vertex = None, 0, False
    props: List[Tuple[str, str]] = []
    while True:
        line = f.readline()
        if not line:
            raise ValueError("unterminated PLY header")
        tok = line.decode("ascii", "replace").strip().split()
        if not tok:
            continue
        if tok[0] == "format":
            fmt = tok[1]
        elif tok[0] == "element":
            in_vertex = tok[1] == "vertex"
            if in_vertex:
                count = int(tok[2])
        elif tok[0] == "property" and in_vertex:
            props.append((tok[2], _DTYPES[tok[1]]))
        elif tok[0] == "end_header":
            break
    return count, props, fmt


def _cloud(means, quats, scales, opacity, sh, device) -> GaussianCloud:
    dev = resolve_device(device)
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=dev)  # noqa
    return GaussianCloud(means=t(means),
                         cov3d=quat_scale_to_cov3d(t(quats), t(scales)),
                         opacity=t(opacity), sh=t(sh))


def load_gaussian_ply(path: str, max_sh_degree: int = 3,
                      device=None) -> GaussianCloud:
    """A splat file as a GaussianCloud, SH up to max_sh_degree."""
    with open(path, "rb") as f:
        count, props, fmt = _parse_header(f)
        if fmt != "binary_little_endian":
            raise ValueError(f"unsupported PLY format {fmt!r}")
        dtype = np.dtype([(n, t) for n, t in props])
        raw = f.read(count * dtype.itemsize)
    data = np.frombuffer(raw, dtype=dtype)
    names = {n for n, _ in props}
    n_rest = sum(1 for n in names if n.startswith("f_rest_"))
    degree = min(max_sh_degree, int(round((1 + n_rest / 3) ** 0.5)) - 1)
    K = (degree + 1) ** 2

    if all(t == "<f4" for _, t in props) and \
            {"x", "f_dc_0", "opacity", "scale_0", "rot_0"} <= names:
        from gsrt_torch import native
        idx = {n: k for k, (n, _) in enumerate(props)}
        parsed = native.parse_ply_rows_native(
            raw, count, len(props), idx["x"], idx["f_dc_0"],
            idx.get("f_rest_0", idx["f_dc_0"]), n_rest, idx["opacity"],
            idx["scale_0"], idx["rot_0"], K) if native.available() else None
        if parsed is not None:
            means, sh, opacity, scales, quats = parsed
            return _cloud(means, quats, scales, opacity, sh, device)

    means = np.stack([data["x"], data["y"], data["z"]], -1).astype(np.float32)
    opacity = 1.0 / (1.0 + np.exp(-data["opacity"].astype(np.float32)))
    scales = np.exp(np.stack([data[f"scale_{i}"] for i in range(3)],
                             -1).astype(np.float32))
    quats = np.stack([data[f"rot_{i}"] for i in range(4)],
                     -1).astype(np.float32)
    sh = np.zeros((count, K, 3), np.float32)
    for c in range(3):
        sh[:, 0, c] = data[f"f_dc_{c}"]
    if K > 1:
        rest = np.stack([data[f"f_rest_{i}"] for i in range(n_rest)],
                        -1).astype(np.float32).reshape(count, 3, n_rest // 3)
        sh[:, 1:, :] = np.transpose(rest, (0, 2, 1))[:, :K - 1, :]
    return _cloud(means, quats, scales, opacity, sh, device)


def save_gaussian_ply(path: str, means, quats, scales, opacities, sh) -> None:
    """Write a splat file (opacity → logit, scale → log); arrays or
    tensors."""
    def f32(a):
        if isinstance(a, torch.Tensor):
            a = a.detach().cpu().numpy()
        return np.asarray(a, np.float32)
    means, sh = f32(means), f32(sh)
    n, K = means.shape[0], sh.shape[1]
    n_rest = (K - 1) * 3
    props = (["x", "y", "z", "nx", "ny", "nz"]
             + [f"f_dc_{i}" for i in range(3)]
             + [f"f_rest_{i}" for i in range(n_rest)]
             + ["opacity"] + [f"scale_{i}" for i in range(3)]
             + [f"rot_{i}" for i in range(4)])
    out = np.zeros(n, np.dtype([(p, "<f4") for p in props]))
    out["x"], out["y"], out["z"] = means.T
    for c in range(3):
        out[f"f_dc_{c}"] = sh[:, 0, c]
    rest = np.transpose(sh[:, 1:, :], (0, 2, 1)).reshape(n, -1)
    for i in range(n_rest):
        out[f"f_rest_{i}"] = rest[:, i]
    op = np.clip(f32(opacities), 1e-6, 1 - 1e-6)
    out["opacity"] = np.log(op / (1 - op))
    sc = f32(scales)
    for i in range(3):
        out[f"scale_{i}"] = np.log(np.maximum(sc[:, i], 1e-12))
    q = f32(quats)
    for i in range(4):
        out[f"rot_{i}"] = q[:, i]
    header = io.BytesIO()
    header.write(b"ply\nformat binary_little_endian 1.0\n")
    header.write(f"element vertex {n}\n".encode())
    for p in props:
        header.write(f"property float {p}\n".encode())
    header.write(b"end_header\n")
    with open(path, "wb") as f:
        f.write(header.getvalue())
        f.write(out.tobytes())
