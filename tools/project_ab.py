#!/usr/bin/env python3
"""Same-card A/B of the projection kernel (`csrc/project.cu`) on
chip_smoke.py's projection cell (2.96M splats, SH 3, a 1080p orbit view).

    python3 tools/project_ab.py [--levers A,B,...] [--json PATH]

Versions, each built from its own copy of `csrc/project.cu` with the
port's nvcc flags (and -Xptxas -v) into gsrt_torch/build/ab_<NAME>.so:
  * package — the checkout's source;
  * one version per entry of LEVERS (all by default): the package's
    source with that lever changed, written to ab/levers/<NAME>/ (which
    .gitignore lists).
Each version runs through `ops.project.project_splats` (its library bound
in place of the package's: the same C interface), its twelve columns are
held bit for bit against the package's, and it is timed in turns (each
lever, the package, the package, each lever in reverse; CUDA events, 20
launches each). The plain version is timed too. Prints one JSON object as
its last line (and writes it to PATH with --json). Needs one CUDA card.
"""

from __future__ import annotations

import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

SRC = ROOT / "gsrt_torch" / "csrc" / "project.cu"
LEVER_DIR = ROOT / "ab" / "levers"
STAGED_READ = "        return row[4 * ((f >> 2) ^ swz) + (f & 3)];"

# Each lever: [(old, new), ...] on project.cu, every old text present.
LEVERS = {
    # every splat's SH read straight from global memory, a float at a time
    "scalar_loads": [("return degree == 3 && k == 16 ? kStaged : kGlobal;",
                      "return kGlobal;")],
    # no shared memory: each thread loads its row as 12 float4 through L1
    "float4_loads": [
        ("      cp_async16(sh_s + 4 * (r * kRowChunks + (c ^ ((r >> 1) & 3))),"
         "\n                 src + q);", "      (void)r, (void)c, (void)src;"),
        ("    const float* row = sh_s + r * kRowFloats;",
         "    float4 v[kRowChunks];\n"
         "#pragma unroll\n"
         "    for (int c = 0; c < kRowChunks; ++c)\n"
         "      v[c] = __ldg(reinterpret_cast<const float4*>(p.sh) +\n"
         "                   (size_t)i * kRowChunks + c);\n"
         "    (void)swz, (void)r;"),
        (STAGED_READ,
         "        const float4 q = v[f >> 2];\n"
         "        return (f & 3) == 0 ? q.x : (f & 3) == 1 ? q.y\n"
         "             : (f & 3) == 2 ? q.z : q.w;")],
    # the staged rows at a plain 48-word stride, no swizzle
    "no_swizzle": [("(c ^ ((r >> 1) & 3))", "c"),
                   ("swz = (r >> 1) & 3;", "swz = 0;")],
    # blocks of 256 splats (48 KB of staged rows a block)
    "threads256": [("constexpr int kThreads = 128;",
                    "constexpr int kThreads = 256;")],
}


def lever_source(name: str) -> Path:
    """ab/levers/<name>/project.cu: the package's source, lever changed."""
    out = LEVER_DIR / name
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    text = SRC.read_text()
    for old, new in LEVERS[name]:
        if old not in text:
            raise SystemExit(f"lever {name}: project.cu lacks {old!r}")
        text = text.replace(old, new)
    (out / "project.cu").write_text(text)
    return out / "project.cu"


def build(sources: dict) -> dict:
    """nvcc every version at once: {name: (library, ptxas lines)}."""
    from gsrt_torch import _kernels
    _kernels.BUILD.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, src in sources.items():
        lib = _kernels.BUILD / f"ab_{name}.so"
        cmd = [_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-Xptxas", "-v",
               "-o", str(lib), str(src)]
        procs[name] = (lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    built = {}
    for name, (lib, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{out}")
        built[name] = (lib, [ln.strip() for ln in out.splitlines()
                             if "registers" in ln or "spill" in ln])
    return built


def kernel_of(lib: Path):
    """A `CudaKernel` bound to another build of the same entry point."""
    from gsrt_torch import _kernels
    k = _kernels.CudaKernel("project_splats", "project", "gsrt_project",
                            _kernels.PROJECT.argtypes)
    fn = ctypes.CDLL(str(lib)).gsrt_project
    fn.argtypes, fn.restype = k.argtypes, ctypes.c_int
    k._fn = fn
    return k


def main() -> int:
    args = sys.argv[1:]
    opts = {}
    for flag in ("--levers", "--json"):
        if flag in args:
            at = args.index(flag)
            if at + 1 >= len(args):
                raise SystemExit(__doc__)
            opts[flag] = args[at + 1]
            del args[at:at + 2]
    if args:
        raise SystemExit(__doc__)
    levers = ([x for x in opts["--levers"].split(",") if x]
              if "--levers" in opts else list(LEVERS))
    sources = {"package": SRC, **{n: lever_source(n) for n in levers}}
    card = cs.phase_device()
    import torch
    from gsrt_torch import _kernels
    from gsrt_torch.ops import project
    built = build(sources)
    kernels = {name: kernel_of(lib) for name, (lib, _) in built.items()}
    cfg, cloud, camera = cs.projection_cell()
    n, k = cloud.n, cloud.sh.shape[1]
    bytes_moved = n * (4 * (3 + 6 + 1 + 3 * k) + 4 * 11 + 1)
    package = _kernels.PROJECT

    def run(name):
        _kernels.PROJECT = kernels[name]
        try:
            return project.project_splats(cloud, camera, cfg)
        finally:
            _kernels.PROJECT = package

    want = run("package")
    report = {"card": card, "splats": n, "bytes": bytes_moved,
              "bound_ms": bytes_moved / cs.HBM_BYTES_PER_S * 1e3,
              "versions": {}}
    for name in built:
        got = run(name)
        torch.cuda.synchronize()
        differ = sum(int((g.view(torch.int32) != w.view(torch.int32)).sum())
                     if g.is_floating_point() else int((g != w).sum())
                     for g, w in zip(got, want))
        report["versions"][name] = dict(ptxas=built[name][1],
                                        entries_differing=differ, ms=[])
    order = levers + ["package", "package"] + levers[::-1]
    for name in order:
        report["versions"][name]["ms"].append(
            cs.time_cuda(lambda: run(name), 20))
    report["plain_ms"] = cs.time_cuda(
        lambda: project.project_splats_plain(cloud, camera, cfg), 3)
    for name, v in report["versions"].items():
        v["best_ms"] = min(v["ms"])
        v["of_bound"] = report["bound_ms"] / v["best_ms"]
        print(f"{name}: {v}", flush=True)
    line = json.dumps(report)
    if "--json" in opts:
        Path(opts["--json"]).write_text(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
