#!/usr/bin/env python3
"""Same-card A/B of the binned primary cast (Q2.7, `csrc/tri_cast.cu`) and
the copy and emit expands (Q2.1, `csrc/pair_expand.cu`) on the inputs of
chip_smoke.py.

    python3 tools/cast_ab.py [--parent DIR] [--levers A,B,...] [--json PATH]

Versions, each built from its own copy of `csrc/` with the port's nvcc
flags (and -Xptxas -v) into gsrt_torch/build/ab_<NAME>_<LIB>.so:
  * package — the checkout's `gsrt_torch/csrc/`;
  * parent — DIR/gsrt_torch/csrc/, an earlier commit's sources unpacked
    with `git archive` under `ab/` (which .gitignore lists);
  * one version per entry of LEVERS (all by default): the package's
    sources with that lever switched off, written to ab/levers/<NAME>/.
Each entry point is called with the arguments its C declaration names.

Cases: the cast on soup359k (the SH render's captured binning and rays,
rect spans, and the same rays over an exact-span binning, 32x16 tiles) and
on bigtris (rect and exact, 16x8 tiles); the copy expand at the render
cell's level 1, the training cell's f32 table and the triangle binning's
15-row tables (rect; exact: triangles to rows, rows to pairs), and the
emit expand at the render cell's level 2. For each, every version runs on
the same inputs, its outputs are held bit for bit against the package's,
and it is timed in turns (each other version, the package, the package,
each other version in reverse; CUDA events, 20 launches each). Then SH,
AO and PT render on soup359k with each version's kernels in place of the
package's (its expand library, and its cast called by argument names
through `tri_binning.cast_primary`): card ms and the pixels that differ
from the package's image. Prints one JSON object as its last line (and
writes it to PATH with --json). Needs one CUDA card.
"""

from __future__ import annotations

import ctypes
import json
import os
import shutil
import subprocess
import sys
from contextlib import contextmanager
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

import chip_smoke as cs  # noqa: E402
from blend_ab import bind  # noqa: E402

CSRC = ROOT / "gsrt_torch" / "csrc"
LEVER_DIR = ROOT / "ab" / "levers"
LIBS = ("tri_cast", "pair_expand")

# Each lever switched off or set otherwise: {file: [(old, new), ...]},
# every old text present in its file (each replaced wherever it occurs).
LEVERS = {
    # the warp cull off: every warp steps through every live pair
    "no_warp_cull": {"tri_cast.cu": [(
        "keep = r.id != kSentinel &&\n"
        "               !culled(r, bx, by, bz, t_min, t_max, bound);",
        "keep = r.id != kSentinel;")]},
    # the geometric cull alone, no depth bound
    "no_depth_cull": {"tri_cast.cu": [(
        "t.lo >= t_max || t.lo > bound;", "t.lo >= t_max;")]},
    # the step's reciprocal as an IEEE division (the same bits), or taken
    # only where det passes (a branch)
    "fdiv": {"tri_cast.cu": [("__frcp_rn(det_ok ? det : 1.0f)",
                              "__fdiv_rn(1.0f, det_ok ? det : 1.0f)")]},
    "rcp_branch": {"tri_cast.cu": [(
        "const float rcp = __frcp_rn(det_ok ? det : 1.0f);  // no branch\n"
        "        const float inv_det = det_ok ? rcp : 0.0f;",
        "const float inv_det = det_ok ? __frcp_rn(det) : 0.0f;")]},
    # trusting the binning's zmin order: one zmin a chunk, the tile ends
    # at its first skipped chunk (wrong on an overflowed binning)
    "trust_order": {"tri_cast.cu": [
        ("    for (int j = threadIdx.x; j < n; j += blockDim.x)\n"
         "      below |= __ldg(zmin + c0 + j) < B;",
         "    below = threadIdx.x == 0 && __ldg(zmin + c0) < B;"),
        ("    c0 += n;\n    narrow = found;", "    return end;")]},
    # the expands' loads issued 8 or 16 rows at a time before their
    # stores, not 4
    "rows8": {"pair_expand.cu": [("constexpr int kMaxRows = 4;",
                                  "constexpr int kMaxRows = 8;")]},
    "rows16": {"pair_expand.cu": [("constexpr int kMaxRows = 4;",
                                   "constexpr int kMaxRows = 16;")]},
    # the expands' coalesced one-word stores also where int4 would do
    "scalar_stores": {"pair_expand.cu": [
        ("const bool vec = (mp & 3) == 0;", "const bool vec = false;")]},
}

CAST_SYMBOL = "gsrt_tri_cast"
COPY_SYMBOL = "gsrt_expand_plain"
EMIT_SYMBOL = "gsrt_expand_emit"


def lever_sources(name: str) -> Path:
    """ab/levers/<name>/: the package's csrc with lever `name` off."""
    out = LEVER_DIR / name
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(CSRC, out)
    for fname, edits in LEVERS[name].items():
        path = out / fname
        text = path.read_text()
        for old, new in edits:
            if old not in text:
                raise SystemExit(f"lever {name}: {fname} lacks {old!r}")
            text = text.replace(old, new)
        path.write_text(text)
    return out


def build_versions(dirs: dict) -> dict:
    """nvcc every (version, library) at once; {(name, lib): (path, ptxas
    report)}."""
    from gsrt_torch import _kernels
    _kernels.BUILD.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, d in dirs.items():
        for lib in LIBS:
            out = _kernels.BUILD / f"ab_{name}_{lib}.so"
            cmd = [_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-Xptxas", "-v",
                   "-o", str(out), str(d / f"{lib}.cu")]
            procs[name, lib] = (out, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
    built = {}
    for key, (out, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {key}:\n{log}")
        built[key] = (out, log)
    return built


def cast_values(torch, b, dirs, origin, kw, need_v0r=True) -> dict:
    """Every argument any version's gsrt_tri_cast names, outputs
    allocated (v0r, the payload's v0 minus the origin, for earlier
    versions)."""
    from gsrt_torch import _kernels
    W, H, tw, th = kw["width"], kw["height"], kw["tile_w"], kw["tile_h"]
    ntx = (W + tw - 1) // tw
    pay = b.payload.contiguous()
    o = origin.to(device=dirs.device, dtype=torch.float32).contiguous()
    return dict(
        v0r=(pay[0:3] - o[:, None]).contiguous() if need_v0r else None,
        origin=o, payload=pay, L=pay.shape[1], tile_start=b.tile_start,
        T=ntx * ((H + th - 1) // th), ntx=ntx, width=W, height=H,
        tile_w=tw, tile_h=th, dirs=dirs.contiguous(),
        t_min=kw.get("t_min", 1e-3), t_max=kw.get("t_max", 1e4),
        t_out=torch.empty((H, W), device=dirs.device),
        id_out=torch.empty((H, W), dtype=torch.int32, device=dirs.device),
        stream=_kernels.stream_ptr(dirs))


@contextmanager
def kernels_of(torch, built: dict, dirs: dict, name: str):
    """The package's entry points running version `name`'s kernels: its
    expand library in place of the package's (the same C interface), its
    cast through `tri_binning.cast_primary` called by argument names."""
    from gsrt_torch import _kernels
    from gsrt_torch.ops import tri_binning
    saved = _kernels._LIBS.get("pair_expand")
    cdll = ctypes.CDLL(str(built[name, "pair_expand"][0]))
    cdll.gsrt_error_string.argtypes = [ctypes.c_int]
    cdll.gsrt_error_string.restype = ctypes.c_char_p
    _kernels._LIBS["pair_expand"] = cdll
    reset = [k for k in _kernels.KERNELS if k.lib == "pair_expand"]
    for k in reset:
        k._fn = None
    src = dirs[name] / "tri_cast.cu"
    run = bind(built[name, "tri_cast"][0], src, CAST_SYMBOL)
    need_v0r = "const float* v0r" in src.read_text()
    cast_primary = tri_binning.cast_primary

    def cast(b, d, origin, **kw):
        vals = cast_values(torch, b, d, origin, kw, need_v0r)
        run(vals)
        return vals["t_out"], vals["id_out"]
    tri_binning.cast_primary = cast
    try:
        yield
    finally:
        tri_binning.cast_primary = cast_primary
        if saved is None:
            _kernels._LIBS.pop("pair_expand", None)
        else:
            _kernels._LIBS["pair_expand"] = saved
        for k in reset:
            k._fn = None


def capture(torch):
    """{case: (library, symbol, argument values, output names)} at the
    shapes chip_smoke.py runs, and the soup359k renders."""
    from gsrt_torch import RenderConfig, _kernels
    from gsrt_torch.core.types import look_at, make_camera
    from gsrt_torch.models import gaussian_rt as grt
    from gsrt_torch.models import path_tracer as pt
    from gsrt_torch.models import trainer
    from gsrt_torch.ops import pair_expand, tri_binning
    cases = {}
    stream = lambda t: _kernels.stream_ptr(t)                  # noqa: E731

    def copy_case(name, tab, base, mp):
        cases[name] = ("pair_expand", COPY_SYMBOL, dict(
            tab=tab, rows=tab.shape[0], n=tab.shape[1], base=base, mp=mp,
            out=torch.empty((tab.shape[0], mp), dtype=torch.int32,
                            device=tab.device), stream=stream(tab)),
            ("out",))

    cfg, cloud, camera = cs.render_cell()
    tracer = grt.GaussianRayTracer(cfg, "tiled", device=cs.DEVICE)
    tracer.calibrate(cloud, camera)
    with cs.Recorder(pair_expand, "expand_pairs_fused") as rf, \
            cs.Recorder(pair_expand, "expand_pairs_binned") as rb:
        tracer(cloud, camera)
        torch.cuda.synchronize()
    (tab1, ubase, mu), _ = rf.calls[0]
    copy_case("copy[level 1]", tab1, ubase, mu)
    (tab2, pbase, mp), kw = rb.calls[0]
    cases["emit[level 2]"] = ("pair_expand", EMIT_SYMBOL, dict(
        tab=tab2, n=tab2.shape[1], base=pbase, mp=mp,
        total=kw["total"].reshape(1).to(torch.int32), ntx=kw["ntx"],
        T=kw["T"], tile_w=kw["tile_w"], tile_h=kw["tile_h"],
        out=torch.empty((pair_expand.EMIT_ROWS, mp), dtype=torch.int32,
                        device=tab2.device), stream=stream(tab2)), ("out",))
    del tracer, cloud, rf, rb

    tcfg, _, tcam, params, target, _, tmp, _ = cs.train_cell()
    with cs.Recorder(pair_expand, "expand_pairs_fused") as rf:
        trainer.render_loss_tiled(params, target, tcam, tcfg, tmp)
        torch.cuda.synchronize()
    copy_case("copy[f32 table]", *rf.calls[0][0])
    del params, target, rf

    W, H = cs.WIDTH, cs.HEIGHT
    camera = make_camera(look_at((0, 0, -7.0), (0, 0, 0.0)), 55.0, W, H,
                         device=cs.DEVICE)
    pcfg = RenderConfig(width=W, height=H, samples=cs.PT_SAMPLES,
                        bounces=cs.PT_BOUNCES)
    soup = pt.with_tri_table(cs.tri_scene(cs.tri_soup(cs.SOUP_TRIS,
                                                       cs.SOUP_SD)))
    renders = {
        "SH": lambda: pt.render_shadow_rays(
            soup, camera, pcfg, cs.LIGHT_POS, cs.LIGHT_RADIUS,
            seed=cs.SEED),
        "AO": lambda: pt.render_ambient_occlusion(
            soup, camera, pcfg, seed=cs.SEED, ao_radius=cs.AO_RADIUS),
        "PT": lambda: pt.render_path_traced(soup, camera, pcfg,
                                            seed=cs.SEED)}

    def cast_case(name, b, dirs, origin, kw):
        cases[name] = ("tri_cast", CAST_SYMBOL,
                       cast_values(torch, b, dirs, origin, kw),
                       ("t_out", "id_out"))

    with cs.Recorder(tri_binning, "cast_primary") as rc, \
            cs.Recorder(tri_binning, "expand_pairs_fused") as rx:
        renders["SH"]()
        torch.cuda.synchronize()
    (b, dirs, origin), kw = rc.calls[0]
    cast_case("cast[soup359k]", b, dirs, origin, kw)
    copy_case("copy[tri]", *rx.calls[0][0])
    v = (soup.tri_v0, soup.tri_v1, soup.tri_v2)
    need = tri_binning.count_tri_pairs_numpy(*v, camera, tile_w=pcfg.tile_w,
                                             tile_h=pcfg.tile_h,
                                             span_exact=True)
    with cs.Recorder(tri_binning, "expand_pairs_fused") as rx:
        exact = tri_binning.build_tri_binning(
            *v, camera, tile_w=pcfg.tile_w, tile_h=pcfg.tile_h,
            max_pairs=int(need * 1.2) + 1024, span_exact=True)
    cast_case("cast[soup359k,exact]", exact, dirs, origin, kw)
    copy_case("copy[tri,rows]", *rx.calls[0][0])
    copy_case("copy[tri,pairs]", *rx.calls[1][0])

    big_v = tuple(torch.as_tensor(a, device=cs.DEVICE)
                  for a in cs.tri_soup(cs.BIGTRIS, 1.0))
    cfg16 = RenderConfig(width=W, height=H, tile_w=16, tile_h=8)
    gen = torch.Generator(device=cs.DEVICE).manual_seed(cs.SEED)
    _, big_dirs = pt.generate_camera_rays(gen, camera, cfg16)
    big_kw = dict(width=W, height=H, tile_w=16, tile_h=8,
                  t_min=cfg16.t_min, t_max=cfg16.t_max)
    for span_exact in (False, True):
        need = tri_binning.count_tri_pairs_numpy(
            *big_v, camera, tile_w=16, tile_h=8, span_exact=span_exact)
        b = tri_binning.build_tri_binning(
            *big_v, camera, tile_w=16, tile_h=8,
            max_pairs=int(need * 1.2) + 1024, span_exact=span_exact)
        cast_case("cast[bigtris" + (",exact]" if span_exact else "]"), b,
                  big_dirs, camera.position, big_kw)
    torch.cuda.synchronize()
    return cases, renders


def main() -> int:
    args = sys.argv[1:]
    opts = {}
    for flag in ("--parent", "--levers", "--json"):
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
    dirs = {"package": CSRC}
    if "--parent" in opts:
        dirs["parent"] = Path(opts["--parent"]).resolve() / "gsrt_torch" \
            / "csrc"
    for name in levers:
        dirs[name] = lever_sources(name)
    card = cs.phase_device()
    import torch
    from gsrt_torch import _kernels
    _kernels.build()
    built = build_versions(dirs)
    cuda_bin = os.path.dirname(_kernels._nvcc())
    report = {"card": card, "sources": {}, "cases": {}, "renders": {}}
    for (name, lib), (path, log) in built.items():
        report["sources"][f"{name}/{lib}"] = dict(
            ptxas=[ln.strip() for ln in log.splitlines()
                   if "registers" in ln or "spill" in ln],
            sass=(cs.sass_inner_loop(path, cuda_bin, "tri_cast_kernel")
                  if lib == "tri_cast" else None))
        print(f"{name}/{lib}: {report['sources'][f'{name}/{lib}']}",
              flush=True)

    cases, renders = capture(torch)
    others = [n for n in dirs if n != "package"]
    order = others + ["package", "package"] + others[::-1]
    for case, (lib, symbol, values, outs) in cases.items():
        runs = {n: bind(built[n, lib][0], dirs[n] / f"{lib}.cu", symbol)
                for n in dirs}
        vals = {n: dict(values, **{o: torch.empty_like(values[o])
                                   for o in outs}) for n in dirs}
        for n in dirs:
            runs[n](vals[n])
        torch.cuda.synchronize()
        fig = {n: dict(equal=all(torch.equal(vals[n][o],
                                             vals["package"][o])
                                 for o in outs), ms=[]) for n in dirs}
        fig["shape"] = {k: (list(v.shape) if hasattr(v, "shape") else v)
                        for k, v in values.items()
                        if k in ("tab", "mp", "payload", "T", "tile_w")}
        for n in order:
            fig[n]["ms"].append(cs.time_cuda(lambda n=n: runs[n](vals[n]),
                                             20))
        report["cases"][case] = fig
        print(f"{case}: {json.dumps(fig)}", flush=True)
        del vals

    for rname, render in renders.items():
        images, fig = {}, {}
        for n in ["package"] + others:
            with kernels_of(torch, built, dirs, n):
                render()            # warm
                start, end = (torch.cuda.Event(enable_timing=True)
                              for _ in range(2))
                torch.cuda.synchronize()
                start.record()
                images[n] = render()
                end.record()
                torch.cuda.synchronize()
            fig[n] = dict(ms=start.elapsed_time(end),
                          mean=images[n].mean().item())
        for n in others:
            d = (images[n] - images["package"]).abs()
            fig[n].update(pixels_differing=int((d.amax(-1) > 0).sum()),
                          max_abs_diff=d.max().item())
        report["renders"][rname] = fig
        print(f"{rname}: {json.dumps(fig)}", flush=True)
        del images

    line = json.dumps(report)
    if "--json" in opts:
        path = Path(opts["--json"])
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
