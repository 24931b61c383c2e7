"""ctypes binding of the host runtime library `native/gsrt_native.cpp`
(counterpart of `gsrt.native`): a Karras LBVH builder and a binary-PLY
splat row decoder, over a plain C interface.

At first use the source is compiled with `g++ -O3 -shared -fPIC` into
`gsrt_torch/build/libgsrt_native.so` (git-ignored, beside the CUDA
libraries; rebuilt when the source is newer). Where the compiler or the
library is missing, `available()` is False and the callers take their
NumPy paths.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

SOURCE = Path(__file__).resolve().parent.parent / "native" / "gsrt_native.cpp"
LIB = Path(__file__).resolve().parent / "build" / "libgsrt_native.so"
CXXFLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-pthread")

_lib: Optional[ctypes.CDLL] = None
_tried = False


def _ensure_built() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    try:
        if not LIB.exists() or LIB.stat().st_mtime < SOURCE.stat().st_mtime:
            cxx = os.environ.get("CXX") or shutil.which("g++")
            if cxx is None:
                return None
            LIB.parent.mkdir(parents=True, exist_ok=True)
            tmp = LIB.with_suffix(f".{os.getpid()}.tmp")
            subprocess.run([cxx, *CXXFLAGS, "-o", str(tmp), str(SOURCE)],
                           check=True, capture_output=True)
            os.replace(tmp, LIB)      # atomic for concurrent builders
        lib = ctypes.CDLL(str(LIB))
        lib.gsrt_build_lbvh.restype = ctypes.c_int
        lib.gsrt_parse_ply_rows.restype = ctypes.c_int
        _lib = lib
    except (OSError, subprocess.CalledProcessError):
        _lib = None
    return _lib


def available() -> bool:
    return _ensure_built() is not None


def _p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def build_lbvh_native(aabb_min: np.ndarray, aabb_max: np.ndarray):
    """Host LBVH over [N, 3] boxes: a dict of NumPy arrays with
    `ops.bvh.LBVH`'s fields, or None without the library."""
    lib = _ensure_built()
    if lib is None:
        return None
    n = aabb_min.shape[0]
    amin = np.ascontiguousarray(aabb_min, np.float32)
    amax = np.ascontiguousarray(aabb_max, np.float32)
    out = dict(left=np.empty(n - 1, np.int32), right=np.empty(n - 1, np.int32),
               left_leaf=np.empty(n - 1, np.uint8),
               right_leaf=np.empty(n - 1, np.uint8),
               node_min=np.empty((n - 1, 3), np.float32),
               node_max=np.empty((n - 1, 3), np.float32),
               leaf_prim=np.empty(n, np.int32),
               leaf_min=np.empty((n, 3), np.float32),
               leaf_max=np.empty((n, 3), np.float32))
    rc = lib.gsrt_build_lbvh(
        _p(amin), _p(amax), ctypes.c_int(n), *(_p(out[k]) for k in (
            "left", "right", "left_leaf", "right_leaf", "node_min",
            "node_max", "leaf_prim", "leaf_min", "leaf_max")))
    if rc != 0:
        return None
    out["left_leaf"] = out["left_leaf"].astype(bool)
    out["right_leaf"] = out["right_leaf"].astype(bool)
    return out


def parse_ply_rows_native(raw: bytes, n: int, stride_f: int, off_xyz: int,
                          off_dc: int, off_rest: int, n_rest: int,
                          off_opacity: int, off_scale: int, off_rot: int,
                          K: int):
    """Decode n all-f32 splat rows of stride_f floats: (means, sh [n, K,
    3], opacity (sigmoid), scales (exp), quats), or None without the
    library."""
    lib = _ensure_built()
    if lib is None:
        return None
    means = np.empty((n, 3), np.float32)
    sh = np.zeros((n, K, 3), np.float32)
    opacity = np.empty(n, np.float32)
    scales = np.empty((n, 3), np.float32)
    quats = np.empty((n, 4), np.float32)
    rc = lib.gsrt_parse_ply_rows(
        ctypes.c_char_p(raw), ctypes.c_longlong(n), ctypes.c_int(stride_f),
        ctypes.c_int(off_xyz), ctypes.c_int(off_dc), ctypes.c_int(off_rest),
        ctypes.c_int(n_rest), ctypes.c_int(off_opacity),
        ctypes.c_int(off_scale), ctypes.c_int(off_rot), ctypes.c_int(K),
        _p(means), _p(sh), _p(opacity), _p(scales), _p(quats))
    if rc != 0:
        return None
    return means, sh, opacity, scales, quats
