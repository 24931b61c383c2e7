#!/usr/bin/env python3
"""Same-card A/B of the packed-cluster traversal kernel (Q2.8) on the
soup359k bundles of chip_smoke.py.

    python3 tools/traverse_ab.py NAME=SOURCE.cu [NAME=SOURCE.cu ...]
                                 [--json PATH]

Each SOURCE.cu is another version of gsrt_torch/csrc/tri_kernel.cu (for
example an earlier commit's, unpacked with `git archive` under `ab/`,
which .gitignore lists). Its gsrt_tri_traverse is called with the
arguments its declaration names (older ones lack `sup_box` or
`cull_rays`). Every source is built with the port's nvcc flags (and
-Xptxas -v) into gsrt_torch/build/ab_<NAME>.so.

On the three bundles of chip_smoke.py's tri-traverse phase (the PT
render's first bounce wave, the 1080p primary bundle, the SH render's
first shadow bundle) it runs the package's kernel and every other source
on the same prepared rays and plan, counts the rays whose t or slot
differ and the blocks whose executed visits differ, and times them in
turns (each other source, the package's, the package's, each other
source in reverse; CUDA events, 5 launches each). Then SH, AO and PT
render once with each kernel: card ms, mean colour, pixels that differ.
Prints one JSON object as its last line (and writes it to PATH with
--json). Needs one CUDA card.
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import subprocess
import sys
import time
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
        cmd = [_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-Xptxas", "-v",
               "-o", str(lib), str(src)]
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


def bind(lib: Path, src: Path):
    """The source's gsrt_tri_traverse as f(tt, rays, plan, rb, any_hit)
    -> (t, slot, actual), like tri_kernel.traverse; its arguments are
    matched by the parameter names of its C declaration."""
    import torch
    from gsrt_torch import _kernels
    from gsrt_torch.ops import tri_kernel
    decl = re.search(r"int gsrt_tri_traverse\(([^)]*)\)", src.read_text())
    params = [p.split() for p in decl.group(1).split(",")]
    names = [p[-1].lstrip("*") for p in params]
    fn = ctypes.CDLL(str(lib)).gsrt_tri_traverse
    fn.argtypes = [ctypes.c_void_p if "*" in "".join(p) else ctypes.c_int
                   for p in params]
    fn.restype = ctypes.c_int

    def run(tt, rays, plan, rb, any_hit):
        Rp = rays.shape[1]
        out = dict(
            t_out=torch.empty(Rp, dtype=torch.float32, device=rays.device),
            slot_out=torch.empty(Rp, dtype=torch.int32, device=rays.device),
            actual=torch.empty(Rp // rb, dtype=torch.int32,
                               device=rays.device))
        keep = dict(box=torch.cat([tt.cl_min, tt.cl_max], 1).contiguous(),
                    sup_box=torch.cat([tt.sup_min, tt.sup_max], 1)
                    .contiguous(), **out)
        ints = dict(m=tt.table.shape[0], mv=plan.visit.shape[0], Rp=Rp,
                    rb=rb, cull_rays=tri_kernel.CULL_RAYS,
                    any_hit=int(any_hit))
        ptrs = dict(table=tt.table, block_start=plan.block_start,
                    visit=plan.visit, visit_near=plan.visit_near, rays=rays,
                    **keep)
        args = [ints[n] if n in ints else _kernels.stream_ptr(rays)
                if n == "stream" else ptrs[n].data_ptr() for n in names]
        err = fn(*args)
        if err:
            raise RuntimeError(f"{lib.name}: CUDA error {err}")
        return out["t_out"], out["slot_out"], out["actual"]
    return run


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
    if not pairs or any(len(p) != 2 for p in pairs):
        raise SystemExit(__doc__)
    sources = {n: Path(p).resolve() for n, p in pairs}
    card = cs.phase_device()
    import torch
    from gsrt_torch import RenderConfig, _kernels
    from gsrt_torch.core.types import look_at, make_camera
    from gsrt_torch.models import path_tracer as pt
    from gsrt_torch.ops import tri_kernel

    _kernels.build(verbose=True)
    built = build_sources(sources)
    cuda_bin = os.path.dirname(_kernels._nvcc())
    kernels = {"package": tri_kernel.traverse}
    report = {"card": card, "sources": {}}
    for name, (lib, log) in built.items():
        kernels[name] = bind(lib, sources[name])
        report["sources"][name] = dict(
            ptxas=[ln.strip() for ln in log.splitlines()
                   if "registers" in ln or "spill" in ln],
            sass=cs.sass_inner_loop(lib, cuda_bin))
        print(f"{name}: {report['sources'][name]}", flush=True)
    report["package"] = cs.traverse_kernel_info(cs.RB)
    print(f"package: {report['package']}", flush=True)

    W, H = cs.WIDTH, cs.HEIGHT
    camera = make_camera(look_at((0, 0, -7.0), (0, 0, 0.0)), 55.0, W, H,
                         device=cs.DEVICE)
    cfg = RenderConfig(width=W, height=H, samples=cs.PT_SAMPLES,
                       bounces=cs.PT_BOUNCES)
    soup = pt.with_tri_table(cs.tri_scene(cs.tri_soup(cs.SOUP_TRIS,
                                                       cs.SOUP_SD)))
    tt = soup.tri_table
    renders = {
        "SH": lambda: pt.render_shadow_rays(
            soup, camera, cfg, cs.LIGHT_POS, cs.LIGHT_RADIUS, seed=cs.SEED),
        "AO": lambda: pt.render_ambient_occlusion(
            soup, camera, cfg, seed=cs.SEED, ao_radius=cs.AO_RADIUS),
        "PT": lambda: pt.render_path_traced(soup, camera, cfg,
                                            seed=cs.SEED)}
    with cs.Recorder(tri_kernel, "closest_hit_packed") as rec_pt:
        renders["PT"]()
    with cs.Recorder(tri_kernel, "closest_hit_packed") as rec_sh:
        renders["SH"]()
    torch.cuda.synchronize()
    gen = torch.Generator(device=cs.DEVICE).manual_seed(cs.SEED)
    orig, dirn = pt.generate_camera_rays(gen, camera, cfg)
    (_, *wave), wave_kw = rec_pt.calls[0]
    (_, *shadow), shadow_kw = rec_sh.calls[0]
    bundles = {"closest_hit_packed": (wave, wave_kw),
               "closest_hit_packed[primary]":
                   ((orig, dirn, cfg.t_min, cfg.t_max), {}),
               "closest_hit_packed_any": (shadow, shadow_kw)}
    del rec_pt, rec_sh

    others = [n for n in kernels if n != "package"]
    order = others + ["package", "package"] + others[::-1]
    report["bundles"] = {}
    for bname, (args, kw) in bundles.items():
        any_hit = kw.get("any_hit", False)
        rays, plan, R = tri_kernel._prepare(tt, *args, cs.RB, None)
        outs = {n: k(tt, rays, plan, cs.RB, any_hit)
                for n, k in kernels.items()}
        torch.cuda.synchronize()
        t0, s0, a0 = outs["package"]
        fig = {}
        for n in others:
            t, s, a = outs[n]
            fig[n] = dict(
                rays_differing=int(((t != t0) | (s != s0)).sum()),
                hits_differing=int((torch.isfinite(t)
                                    != torch.isfinite(t0)).sum()),
                blocks_visits_differing=int((a != a0).sum()))
        times = {n: [] for n in kernels}
        for n in order:
            times[n].append(cs.time_cuda(
                lambda n=n: kernels[n](tt, rays, plan, cs.RB, any_hit), 5))
        for n in kernels:
            fig.setdefault(n, {}).update(ms=times[n],
                                         visits_per_block=outs[n][2]
                                         .float().mean().item())
        report["bundles"][bname] = fig
        print(f"{bname}: {json.dumps(fig)}", flush=True)

    report["renders"] = {}
    traverse = tri_kernel.traverse
    for rname, render in renders.items():
        images, fig = {}, {}
        for n in kernels:
            tri_kernel.traverse = kernels[n]
            try:
                render()        # warm
                start, end = (torch.cuda.Event(enable_timing=True)
                              for _ in range(2))
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                start.record()
                images[n] = render()
                end.record()
                torch.cuda.synchronize()
            finally:
                tri_kernel.traverse = traverse
            fig[n] = dict(ms=start.elapsed_time(end),
                          host_ms=(time.perf_counter() - t0) * 1e3,
                          mean=images[n].mean().item())
        for n in others:
            d = (images[n] - images["package"]).abs()
            fig[n].update(pixels_differing=int((d.amax(-1) > 0).sum()),
                          max_abs_diff=d.max().item())
        report["renders"][rname] = fig
        print(f"{rname}: {json.dumps(fig)}", flush=True)

    if json_path is not None:
        json_path.parent.mkdir(parents=True, exist_ok=True)
        json_path.write_text(json.dumps(report, indent=1))
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
