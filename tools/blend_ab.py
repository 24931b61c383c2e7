#!/usr/bin/env python3
"""Same-card A/B of the packed blend kernels (Q2.3) on the payloads of
chip_smoke.py.

    python3 tools/blend_ab.py NAME=SOURCE.cu [...] [--json PATH]

Each SOURCE.cu is a version of gsrt_torch/csrc/splat_packed.cu: an earlier
commit's (unpacked with `git archive` under `ab/`, which .gitignore
lists), or a patched copy of the package's own kept there, for example one
without the row cull. Its gsrt_blend_group and gsrt_blend_tile are called with the arguments
their declarations name (earlier versions walk the group's columns and
take no `order`, `seg` or `batch`; later ones read the package's
partition). Every source is built with the port's nvcc flags (and -Xptxas
-v) into gsrt_torch/build/ab_<NAME>.so.

Cases: the group blend on the render cell's captured group stream (1M
splats, 1920x1080), and the tile blend with track_consumed on the serving
orbit's first frame (the compact tile stream). For each, every version
runs on the same inputs; its color and trans are held against the
package's (max |difference|, hits that differ) and it is timed in turns
(each other version, the package, the package, each other version in
reverse; CUDA events, 10 launches each). Prints one JSON object as its
last line (and writes it to PATH with --json). Needs one CUDA card.
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def build_sources(sources: dict) -> dict:
    """nvcc every source at once; {name: (lib path, ptxas report)}."""
    from gsrt_torch import _kernels
    _kernels.BUILD.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, src in sources.items():
        lib = _kernels.BUILD / f"ab_{name}.so"
        cmd = [_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-Xptxas",
               "-v", "-o", str(lib), str(src)]
        procs[name] = (lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    out = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        out[name] = (lib, log)
    return out


def _ctype(param: list):
    decl = " ".join(param)
    if "*" in decl:
        return ctypes.c_void_p
    if "long long" in decl:
        return ctypes.c_longlong
    return ctypes.c_float if param[0] == "float" else ctypes.c_int


def bind(lib: Path, src: Path, symbol: str):
    """The source's `symbol` as f(values) -> None, its arguments taken from
    `values` by the parameter names of its C declaration (pointers as
    tensors or None)."""
    decl = re.search(rf"int {symbol}\(([^)]*)\)", src.read_text())
    params = [p.split() for p in decl.group(1).split(",")]
    names = [p[-1].lstrip("*") for p in params]
    fn = getattr(ctypes.CDLL(str(lib)), symbol)
    fn.argtypes = [_ctype(p) for p in params]
    fn.restype = ctypes.c_int

    def run(values: dict) -> None:
        args = []
        for n, t in zip(names, fn.argtypes):
            v = values[n]
            if t is ctypes.c_void_p and v is not None and not isinstance(
                    v, int):
                v = v.data_ptr()
            args.append(v)
        err = fn(*args)
        if err:
            raise RuntimeError(f"{lib.name}: {symbol}: CUDA error {err}")
    return run


def capture(torch):
    """(group binning, its blend kwargs, serving binning, its kwargs)."""
    from gsrt_torch.models import gaussian_rt as grt
    from gsrt_torch.ops import splat_packed
    cfg, cloud, camera = cs.render_cell()
    tracer = grt.GaussianRayTracer(cfg, "tiled", device=cs.DEVICE)
    tracer.calibrate(cloud, camera)
    with cs.Recorder(splat_packed, "blend_packed") as rec:
        tracer(cloud, camera)
        torch.cuda.synchronize()
    (group_b,), group_kw = rec.calls[0]
    cam0 = cs.serving_orbit()[0]
    mp = grt.pair_bucket(int(grt.count_pairs_numpy(cloud, cam0, cfg) * 1.1))
    with cs.Recorder(splat_packed, "blend_packed") as rec:
        grt.render_tiled(cloud, cam0, cfg, max_pairs=mp, serving=True)
        torch.cuda.synchronize()
    (tile_b,), tile_kw = rec.calls[0]
    return group_b, group_kw, tile_b, tile_kw


def values_for(torch, binning, kw, group: bool) -> dict:
    """Every argument any version's entry point names, outputs allocated."""
    from gsrt_torch import _kernels
    from gsrt_torch.ops import splat_packed, tile_binning
    W, H = kw["width"], kw["height"]
    ntx, nty = tile_binning.tile_extent(W, H, kw["sub_w"], kw["sub_h"])
    T, bs = ntx * nty, kw["bs"]
    dev = binning.payload.device
    v = dict(payload=binning.payload, L=binning.payload.shape[1],
             tile_start=binning.tile_start, T=T, ntx=ntx, bs=bs,
             chunk=kw.get("chunk", 128), batch=splat_packed.BATCH,
             compact=int(binning.payload.shape[0]
                         == tile_binning.COMPACT_WIDTH),
             width=W, height=H, tile_w=kw["sub_w"], tile_h=kw["sub_h"],
             g_cutoff=kw["g_cutoff"],
             skip_range_check=int(kw["skip_range_check"]),
             alpha_threshold=kw["alpha_threshold"],
             alpha_clamp=kw["alpha_clamp"], term_eps=kw.get("term_eps", 1e-4),
             use_lut=int(kw["use_exp_lut"]),
             color=torch.empty((H, W, 3), device=dev),
             trans=torch.empty((H, W), device=dev),
             hits=torch.empty((H, W), dtype=torch.int32, device=dev),
             consumed=None if group else torch.empty(
                 -(-T // bs) * bs, dtype=torch.int32, device=dev),
             stream=_kernels.stream_ptr(binning.payload))
    if group:
        v["order"], v["seg"] = splat_packed.partition_group_stream(
            binning, T, bs)
    return v


def sass(lib, cuda_bin, name, old_name):
    """The per-(pixel, pair) loop of the main path's instance (skip-range
    rule, exact exp), or of the untemplated kernel of earlier versions."""
    return (cs.sass_inner_loop(lib, cuda_bin, name, "MUFU.EX2")
            or cs.sass_inner_loop(lib, cuda_bin, old_name, "MUFU.EX2"))


def main() -> int:
    args = sys.argv[1:]
    json_path = None
    if "--json" in args:
        at = args.index("--json")
        if at + 1 >= len(args):
            raise SystemExit(__doc__)
        json_path = Path(args[at + 1])
        del args[at:at + 2]
    pairs = [a.split("=", 1) for a in args]
    if any(len(p) != 2 for p in pairs):
        raise SystemExit(__doc__)
    sources = {name: Path(path).resolve() for name, path in pairs}
    card = cs.phase_device()
    import torch
    from gsrt_torch import _kernels

    pkg_src = ROOT / "gsrt_torch" / "csrc" / "splat_packed.cu"
    _kernels.build(verbose=True)
    built = build_sources(sources)
    built["package"] = (_kernels._lib_path("splat_packed"), "")
    sources["package"] = pkg_src
    cuda_bin = os.path.dirname(_kernels._nvcc())
    report = {"card": card, "sources": {}, "cases": {}}
    for name, (lib, log) in built.items():
        report["sources"][name] = dict(
            ptxas=[ln.strip() for ln in log.splitlines()
                   if "registers" in ln or "spill" in ln],
            sass_group=sass(lib, cuda_bin, "blend_group_kernelILi1EE",
                            "blend_group_kernelEP"),
            sass_tile=sass(lib, cuda_bin, "blend_tile_kernelILb1ELi1EE",
                           "blend_tile_kernelILb1EE"))
        print(f"{name}: {report['sources'][name]}", flush=True)

    group_b, group_kw, tile_b, tile_kw = capture(torch)
    for case, binning, kw, group in (("group", group_b, group_kw, True),
                                     ("tile", tile_b, tile_kw, False)):
        symbol = "gsrt_blend_group" if group else "gsrt_blend_tile"
        runs = {n: bind(lib, sources[n], symbol)
                for n, (lib, _) in built.items()}
        vals = {n: values_for(torch, binning, kw, group) for n in runs}
        for n, run in runs.items():
            run(vals[n])
        torch.cuda.synchronize()
        ref = vals["package"]
        others = [n for n in runs if n != "package"]
        times = {n: [] for n in runs}
        for n in others + ["package", "package"] + others[::-1]:
            times[n].append(cs.time_cuda(lambda n=n: runs[n](vals[n]), 10))
        out = {}
        for n in runs:
            v = vals[n]
            out[n] = dict(
                ms=times[n],
                max_abs_diff=cs.max_abs_err(v["color"] - ref["color"],
                                            v["trans"] - ref["trans"]),
                hits_differing=int((v["hits"] != ref["hits"]).sum()),
                consumed_equal=None if group else bool(torch.equal(
                    v["consumed"], ref["consumed"])))
            print(f"{case} {n}: {out[n]}", flush=True)
        if group:
            from gsrt_torch.ops import splat_packed
            T, bs = vals["package"]["T"], vals["package"]["bs"]
            out["partition_ms"] = cs.time_cuda(
                lambda: splat_packed.partition_group_stream(binning, T, bs),
                10)
            print(f"group partition: {out['partition_ms']} ms", flush=True)
        report["cases"][case] = out
    line = json.dumps(report)
    if json_path:
        json_path.parent.mkdir(parents=True, exist_ok=True)
        json_path.write_text(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
