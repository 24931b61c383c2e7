"""Readings that set the limits of `correct` in the hybrid path-tracing
cells (the loop `hpt`), at a cell's own size, on the seeds given.

    python3 benchmark/control_hpt.py --workload m360-hpt --seeds 1 2 3

For the first check_items frames the cell's window would render (their
views, sample seeds and seeded pixels), the float32 reference
(`reference/hybrid_pt.py`) stands for the program and is compared, by
the numbers of the loop's check, with the control, the same reference in
bfloat16 (triangles, scatter, splat response and composite), and the
fault "splats past the surface", the float32 reference that composites
each segment's splats beyond its surface hit as well. Each seed prints
one JSON line. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark import compare, harness  # noqa: E402


def readings(workload: str, seed: int, device: str = "cuda", *,
             bench_path=None, pkg_root=None, repo_root=None) -> dict:
    repo_root = repo_root or harness.ROOT
    pkg_root = pkg_root or harness.PKG
    bench = harness.load_json(bench_path or repo_root / "BENCHMARK.json")
    cell, cfg_entry = harness.find_cell(bench, workload)
    config = harness.load_json(repo_root / cfg_entry["file"])
    mix = harness.load_json(pkg_root / "traffic" / f"{cell['traffic']}.json")
    mod = harness.load_module("loops", mix["loop"], pkg_root)
    loop = mod.Loop(config, mix, seed, device)
    loop.make_scene()
    f32 = loop.reference_scene()
    bf16 = loop.reference_scene(torch.bfloat16)
    out = {"workload": workload, "seed": seed, "control": [],
           "splats_past_the_surface": []}
    for item in range(int(mix["check_items"])):
        s, pix = loop.frame_seed(0, item), loop.pixels(item)
        vi = int(loop.order[item % len(loop.order)])
        want = loop.reference(f32, s, vi, pix)
        for key, sc, kw in (("control", bf16, dict(dtype=torch.bfloat16)),
                            ("splats_past_the_surface", f32,
                             dict(window=False))):
            got = loop.reference(sc, s, vi, pix, **kw)
            out[key].append(mod.numbers(got["color"], got["primary"],
                                        got["hits"], want))
    for k in ("control", "splats_past_the_surface"):
        out[k] = compare.worst(out[k])
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs CUDA", file=sys.stderr)
        return 2
    for s in args.seeds:
        print(json.dumps(readings(args.workload, s)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
