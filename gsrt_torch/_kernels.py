"""Build and bind the port's CUDA kernels.

Each `csrc/<name>.cu` has a plain C interface. At first use it is compiled
by `nvcc` for `sm_90a` into `build/lib<name>.so` (git-ignored, inside the
package) and loaded with ctypes; a library newer than its source is
reused. Every C entry point returns `cudaGetLastError()` of its launch and
`CudaKernel` raises when that is not 0, so a refused launch surfaces at
the call. Each `CudaKernel` counts its successful launches in `launches`.

Nothing here runs at import, so importing the package needs neither
`nvcc` nor a GPU.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD = _PKG / "build"
SOURCES = ("pair_expand", "splat_packed", "splat_subtile",
           "splat_grad", "tri_cast", "tri_kernel", "tri_bvh", "project",
           "pt_shade", "splat_bvh", "tile_bin")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_LIBS: dict[str, ctypes.CDLL] = {}
_LOAD_LOCK = threading.Lock()   # the viewer's render thread loads too


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + [
            "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""]:
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _lib_path(name: str) -> Path:
    return BUILD / f"lib{name}.so"


def _fresh(name: str) -> bool:
    lib = _lib_path(name)
    newest = max(p.stat().st_mtime for p in
                 [CSRC / f"{name}.cu", *CSRC.glob("*.cuh")])
    return lib.exists() and lib.stat().st_mtime >= newest


def build(names=SOURCES, verbose: bool = False) -> dict[str, float]:
    """Compile the named sources that are stale, one `nvcc` each, all
    started together. Returns the wall seconds of each compile run;
    `verbose` adds `-Xptxas -v` and returns nvcc's report in
    `build.last_log`. Raises with nvcc's output if any compile fails."""
    BUILD.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    flags = NVCC_FLAGS + (("-Xptxas", "-v") if verbose else ())
    procs = {}
    for name in names:
        if _fresh(name):
            continue
        tmp = BUILD / f"lib{name}.{os.getpid()}.tmp"
        cmd = [nvcc, *flags, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, time.perf_counter())
    seconds, logs, failed = {}, [], []
    for name, (proc, tmp, t0) in procs.items():
        out, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        logs.append(f"== {name} ==\n{out}")
        if proc.returncode != 0:
            failed.append(name)
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, _lib_path(name))  # atomic for concurrent users
    build.last_log = "\n".join(logs)
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n{build.last_log}")
    return seconds


build.last_log = ""


def _load(name: str) -> ctypes.CDLL:
    with _LOAD_LOCK:
        if name not in _LIBS:
            if not _fresh(name):
                build((name,))
            lib = ctypes.CDLL(str(_lib_path(name)))
            lib.gsrt_error_string.argtypes = [ctypes.c_int]
            lib.gsrt_error_string.restype = ctypes.c_char_p
            _LIBS[name] = lib
        return _LIBS[name]


class CudaKernel:
    """One C entry point of a kernel library, with its launch count."""

    def __init__(self, name: str, lib: str, symbol: str, argtypes):
        self.name, self.lib, self.symbol = name, lib, symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self._fn = None

    def __call__(self, *args) -> None:
        if self._fn is None:
            fn = getattr(_load(self.lib), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        err = self._fn(*args)
        if err != 0:
            msg = _load(self.lib).gsrt_error_string(err).decode()
            if err == INVALID_CONFIGURATION:
                msg += ": the block does not fit the compiled kernel"
            raise RuntimeError(f"{self.symbol} launch failed: CUDA error "
                               f"{err} ({msg})")
        self.launches += 1


INVALID_CONFIGURATION = 9   # cudaErrorInvalidConfiguration

P, I, F, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, \
    ctypes.c_longlong

EXPAND_PLAIN = CudaKernel(
    "expand_pairs_fused", "pair_expand", "gsrt_expand_plain",
    [P, I, I, P, I, P, P])
EXPAND_EMIT = CudaKernel(
    "expand_pairs_binned", "pair_expand", "gsrt_expand_emit",
    [P, I, P, I, P, I, I, I, I, P, P])
# expand_pairs (the TPU's _expand_kernel) is the same copy kernel; it
# keeps a count of its own
EXPAND_PAIRS = CudaKernel(
    "expand_pairs", "pair_expand", "gsrt_expand_plain",
    [P, I, I, P, I, P, P])
PARTITION = CudaKernel(
    "partition_group_stream", "splat_packed", "gsrt_partition_group",
    [P, P, I, I, I, I, P, P, P, P])
BLEND_GROUP = CudaKernel(
    "blend_packed_group", "splat_packed", "gsrt_blend_group",
    [P, LL, P, P, I, I, I, I, I, I, I, F, I, F, F, F, I, P, P, P, P])
BLEND_TILE = CudaKernel(
    "blend_packed_tile", "splat_packed", "gsrt_blend_tile",
    [P, LL, I, P, I, I, I, I, I, I, I, I, I, F, I, F, F, F, I, P, P, P, P,
     P])
_SUBTILE_ARGS = [P, LL, P, I, I, I, I, I, I, I, I, F, I, F, F, F, I, P, P,
                 P]
BLEND_SUBTILE = CudaKernel(
    "blend_subtiles", "splat_subtile", "gsrt_blend_subtile", _SUBTILE_ARGS)
# the (128, 8)-tile blend is the subtile kernel at 1024-pixel tiles; it
# keeps a count of its own
BLEND_TILES = CudaKernel(
    "blend_tiles", "splat_subtile", "gsrt_blend_subtile", _SUBTILE_ARGS)
BLEND_BACKWARD = CudaKernel(
    "blend_backward", "splat_grad", "gsrt_blend_backward",
    [P, LL, P, P, I, I, I, I, I, I, F, I, F, F, F, I, P, P])

TRI_CAST = CudaKernel(
    "cast_primary", "tri_cast", "gsrt_tri_cast",
    [P, LL, P, P, I, I, I, I, I, I, P, F, F, P, P, P])
# one entry point, two modes: each keeps a count of its own
_TRAVERSE_ARGS = [P, P, P, I, P, P, P, I, P, I, I, I, I, P, P, P, P]
TRI_CLOSEST_HIT = CudaKernel(
    "closest_hit_packed", "tri_kernel", "gsrt_tri_traverse", _TRAVERSE_ARGS)
TRI_ANY_HIT = CudaKernel(
    "closest_hit_packed_any", "tri_kernel", "gsrt_tri_traverse",
    _TRAVERSE_ARGS)
TRI_BVH = CudaKernel(
    "closest_hit_bvh", "tri_bvh", "gsrt_tri_bvh",
    [P, P, P, P, P, P, F, P, F, I, P, P, P, P, P])

PROJECT = CudaKernel(
    "project_splats", "project", "gsrt_project",
    [P, P, P, P, I, I, I, I, P, P, P, P, P, P, F, F, F, F, F, F, P, P, P])

PT_SHADE = CudaKernel(
    "pt_shade", "pt_shade", "gsrt_pt_shade",
    [P, P, P, P, P, P, P, P, P, P, P, P, P, P, P, P, I, I, I, P])

SPLAT_BVH = CudaKernel(
    "trace_gaussian_rays_bvh", "splat_bvh", "gsrt_splat_bvh",
    [P, P, P, P, P, P, F, P, F, I, I, F, F, P, P, P, P, P, P, P])

# the group stream's binning (ops/tile_bin.py): three entry points
BIN_PREP = CudaKernel(
    "bin_prep", "tile_bin", "gsrt_bin_prep",
    [P] * 14 + [I] * 10 + [P, LL] + [P] * 9)
BIN_GATHER = CudaKernel(
    "bin_gather", "tile_bin", "gsrt_bin_gather",
    [P, I, P, I, I, I] + [P] * 7)
BIN_UNITS = CudaKernel(
    "bin_units", "tile_bin", "gsrt_bin_units", [P] + [I] * 5 + [P] * 6)

KERNELS = (EXPAND_PLAIN, EXPAND_EMIT, EXPAND_PAIRS, PARTITION, BLEND_GROUP,
           BLEND_TILE, BLEND_SUBTILE, BLEND_TILES, BLEND_BACKWARD, TRI_CAST,
           TRI_CLOSEST_HIT, TRI_ANY_HIT, TRI_BVH, PROJECT, PT_SHADE,
           SPLAT_BVH, BIN_PREP, BIN_GATHER, BIN_UNITS)


def launch_counts() -> dict[str, int]:
    return {k.name: k.launches for k in KERNELS}


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


def stream_ptr(t) -> int:
    """PyTorch's current CUDA stream on t's device, as a C pointer value."""
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream
