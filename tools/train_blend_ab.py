#!/usr/bin/env python3
"""Same-card A/B of the f32 tile stream's kernels (Q2.4 and Q2.6
`splat_subtile.cu`, Q2.5 `splat_grad.cu`) on the inputs of chip_smoke.py.

    python3 tools/train_blend_ab.py [--parent DIR] [--levers A,B,...]
                                    [--json PATH]

Versions, each built from its own copy of `csrc/` with the port's nvcc
flags (and -Xptxas -v) into gsrt_torch/build/ab_<NAME>_{subtile,grad}.so:
  * package — the checkout's `gsrt_torch/csrc/`;
  * parent — DIR/gsrt_torch/csrc/, an earlier commit's sources unpacked
    with `git archive` under `ab/` (which .gitignore lists);
  * one version per entry of LEVERS (all by default): the package's
    sources with that lever switched off, or set otherwise, written to
    ab/levers/<NAME>/.
Each entry point is called with the arguments its C declaration names, so
a version with another signature (the parent's takes no chunk or pix)
runs on the same values.

Cases: the training cell's forward and backward (chip_smoke.train_cell:
one render_loss_tiled forward and backward, the f32 stream and pixel
state recorded), and blend_tiles on the render cell at 128x8 tiles
(chip_smoke.render_cell). For each, every version runs on the same
inputs; its outputs are held against the package's (forward: max
|difference| of color and trans; backward: per gradient row, max
|difference| over the row's largest |value|) and it is timed in turns
(each other version, the package, the package, each other version in
reverse; CUDA events, 10 launches each). A version whose launch is
refused is reported so, not timed. Prints one
JSON object as its last line (and writes it to PATH with --json). Needs
one CUDA card.
"""

from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

import chip_smoke as cs  # noqa: E402
from blend_ab import bind  # noqa: E402

CSRC = ROOT / "gsrt_torch" / "csrc"
LEVER_DIR = ROOT / "ab" / "levers"
LIBS = {"subtile": ("splat_subtile.cu", "gsrt_blend_subtile"),
        "grad": ("splat_grad.cu", "gsrt_blend_backward")}

_STAGE_AHEAD = """      if (q < n) decode<kRule>(nxt, prm, st[slot ^ 1][lane]);
      if (q + kBatch < n) fetch(payload, L, lo + q + kBatch, nxt);"""
_STAGE_NOW = """      if (q < n) {
        fetch(payload, L, lo + q, nxt);
        decode<kRule>(nxt, prm, st[slot ^ 1][lane]);
      }"""

# Each lever switched off or set otherwise: {file: [(old, new), ...]},
# every old text present in its file.
LEVERS = {
    # the warp cull off: every warp runs every pair
    "no_cull": {"f32_stream.cuh": [("live = !(lb > C.y);", "live = true;")]},
    # the row bound alone, no column bound
    "row_only": {"f32_stream.cuh": [
        ("__fmul_rn(C.w, __fmul_rn(dx, dx))", "0.0f")]},
    # pixels a thread: the forward 2 or 8 (not 4), the backward 4 (not 2)
    "fwd_pix2": {"splat_subtile.cu": [("constexpr int kPix = 4;",
                                       "constexpr int kPix = 2;")]},
    "fwd_pix8": {"splat_subtile.cu": [("constexpr int kPix = 4;",
                                       "constexpr int kPix = 8;")]},
    "bwd_pix4": {"splat_grad.cu": [("constexpr int kPix = 2;",
                                    "constexpr int kPix = 4;")]},
    # the backward's warp sums by a butterfly a pair, not transposed
    "butterfly": {"splat_grad.cu": [
        ("constexpr int kGroup = 8;", "constexpr int kGroup = 1;"),
        ("constexpr int kGroupBits = 3;", "constexpr int kGroupBits = 0;")]},
    # the transposing reduction over 4 pairs, not 8
    "group4": {"splat_grad.cu": [
        ("constexpr int kGroup = 8;", "constexpr int kGroup = 4;"),
        ("constexpr int kGroupBits = 3;", "constexpr int kGroupBits = 2;")]},
    # the forward's launch bounds asking for 4 resident blocks of 256
    # threads (64 registers)
    "fwd_regs64": {"splat_subtile.cu": [
        ("__launch_bounds__(kMaxBlock)", "__launch_bounds__(kMaxBlock, 4)")]},
    # the backward's 1 / (1 - alpha) as an IEEE division, not __fdividef
    "ieee_div": {"splat_grad.cu": [
        ("__fdividef(1.0f, 1.0f - alpha)", "1.0f / (1.0f - alpha)")]},
    # no words held a batch ahead: warp 0 loads and decodes the next batch
    # at once
    "no_prefetch": {"splat_subtile.cu": [(_STAGE_AHEAD, _STAGE_NOW)],
                    "splat_grad.cu": [(_STAGE_AHEAD, _STAGE_NOW)]},
}


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
    """nvcc every (version, library) at once; {(name, lib): (path,
    ptxas report)}."""
    from gsrt_torch import _kernels
    _kernels.BUILD.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, d in dirs.items():
        for lib, (src, _) in LIBS.items():
            out = _kernels.BUILD / f"ab_{name}_{lib}.so"
            cmd = [_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-Xptxas", "-v",
                   "-o", str(out), str(d / src)]
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


def pix_of(src: Path) -> int:
    """The pixels a thread of a kernel source holds (1 before the
    constant existed)."""
    m = re.search(r"constexpr int kPix = (\d+);", src.read_text())
    return int(m.group(1)) if m else 1


def capture(torch):
    """(training binning, forward kwargs, backward (payload, tile_start,
    pixstate), backward kwargs, 128x8 binning, its kwargs)."""
    from gsrt_torch import RenderConfig
    from gsrt_torch.models import gaussian_rt as grt
    from gsrt_torch.models import trainer
    from gsrt_torch.ops import splat_grad, splat_pallas, splat_subtile
    cfg, _, camera, params, target, _, max_pairs, _ = cs.train_cell()
    with cs.Recorder(splat_subtile, "blend_subtiles") as fwd, \
            cs.Recorder(splat_grad, "blend_backward") as bwd:
        trainer.render_loss_tiled(params, target, camera, cfg,
                                  max_pairs).backward()
        torch.cuda.synchronize()
    (train_b,), fwd_kw = fwd.calls[0]
    bwd_args, bwd_kw = bwd.calls[0]
    del params, target
    _, cloud, camera = cs.render_cell()
    cfg128 = RenderConfig(width=cs.WIDTH, height=cs.HEIGHT,
                          conic_mode="standard", tile_w=128, tile_h=8)
    tracer = grt.GaussianRayTracer(cfg128, "tiled", device=cs.DEVICE)
    tracer.calibrate(cloud, camera)
    with cs.Recorder(splat_pallas, "blend_tiles") as rec:
        tracer(cloud, camera)
        torch.cuda.synchronize()
    (tiles_b,), tiles_kw = rec.calls[0]
    return train_b, fwd_kw, bwd_args, bwd_kw, tiles_b, tiles_kw


def values_for(torch, payload, tile_start, kw, tile_w, tile_h, pix,
               pixstate=None) -> dict:
    """Every argument an entry point names, outputs allocated."""
    from gsrt_torch import _kernels
    from gsrt_torch.ops import splat_grad, tile_binning
    W, H = kw["width"], kw["height"]
    ntx, nty = tile_binning.tile_extent(W, H, tile_w, tile_h)
    dev = payload.device
    return dict(
        payload=payload, L=payload.shape[1], tile_start=tile_start,
        pixstate=pixstate, T=ntx * nty, ntx=ntx, width=W, height=H,
        tile_w=tile_w, tile_h=tile_h, chunk=kw.get("chunk", 128), pix=pix,
        g_cutoff=kw["g_cutoff"], skip_range_check=int(kw["skip_range_check"]),
        alpha_threshold=kw["alpha_threshold"], alpha_clamp=kw["alpha_clamp"],
        term_eps=kw.get("term_eps", 1e-4), use_lut=int(kw["use_exp_lut"]),
        color=torch.empty((H, W, 3), device=dev),
        trans=torch.empty((H, W), device=dev),
        grad=torch.zeros((splat_grad.GRAD_ROWS, payload.shape[1]),
                         device=dev),
        stream=_kernels.stream_ptr(payload))


def run_case(torch, case, lib, runs, vals):
    """Run each version once (outputs kept), hold it against the package,
    time the versions in turns."""
    out, ok = {}, {}
    for n, run in runs.items():
        try:
            run(vals[n])
            torch.cuda.synchronize()
            ok[n] = True
        except RuntimeError as err:
            out[n] = dict(refused=str(err))
            ok[n] = False
    ref = vals["package"]
    others = [n for n in runs if n != "package" and ok[n]]
    times = {n: [] for n in runs}
    for n in others + ["package", "package"] + others[::-1]:
        times[n].append(cs.time_cuda(lambda n=n: runs[n](vals[n]), 10))
    for n in runs:
        if not ok[n]:
            continue
        v = vals[n]
        if lib == "grad":
            diff = max(cs.normalised_err(v["grad"][r], ref["grad"][r])
                       for r in range(v["grad"].shape[0]))
        else:
            diff = cs.max_abs_err(v["color"] - ref["color"],
                                  v["trans"] - ref["trans"])
        out[n] = dict(ms=times[n], max_diff=diff)
    for n, r in out.items():
        print(f"{case} {n}: {r}", flush=True)
    return out


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
    levers = (opts["--levers"].split(",") if "--levers" in opts
              else list(LEVERS))
    dirs = {"package": CSRC}
    if "--parent" in opts:
        dirs["parent"] = Path(opts["--parent"]).resolve() / "gsrt_torch" \
            / "csrc"
    for name in levers:
        dirs[name] = lever_sources(name)
    card = cs.phase_device()
    import torch
    from gsrt_torch import _kernels
    built = build_versions(dirs)
    cuda_bin = str(Path(_kernels._nvcc()).parent)
    report = {"card": card, "sources": {}, "cases": {}}
    for (name, lib), (path, log) in built.items():
        fn = ("subtile_fwd_kernelILi1EE" if lib == "subtile"
              else "subtile_bwd_kernelILi1EE")
        old = "blend_subtile_kernel" if lib == "subtile" else \
            "blend_bwd_kernel"
        report["sources"][f"{name}/{lib}"] = dict(
            ptxas=[ln.strip() for ln in log.splitlines()
                   if "registers" in ln or "spill" in ln],
            sass=(cs.sass_inner_loop(path, cuda_bin, fn, "MUFU.EX2")
                  or cs.sass_inner_loop(path, cuda_bin, old, "MUFU.EX2")))
        print(f"{name}/{lib}: {report['sources'][f'{name}/{lib}']}",
              flush=True)

    train_b, fwd_kw, (pay, ts, pixstate), bwd_kw, tiles_b, tiles_kw = \
        capture(torch)
    tw, th = fwd_kw["sub_w"], fwd_kw["sub_h"]
    cases = (("train_forward", "subtile", train_b.payload,
              train_b.tile_start, fwd_kw, tw, th, None),
             ("train_backward", "grad", pay, ts, bwd_kw, tw, th, pixstate),
             ("tiles128x8", "subtile", tiles_b.payload, tiles_b.tile_start,
              tiles_kw, 128, 8, None))
    for case, lib, p, t, kw, w, h, ps in cases:
        runs = {n: bind(built[n, lib][0], dirs[n] / LIBS[lib][0],
                        LIBS[lib][1]) for n in dirs}
        vals = {n: values_for(torch, p, t, kw, w, h,
                              pix_of(dirs[n] / LIBS[lib][0]), ps)
                for n in dirs}
        report["cases"][case] = run_case(torch, case, lib, runs, vals)
    line = json.dumps(report)
    if "--json" in opts:
        path = Path(opts["--json"])
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
