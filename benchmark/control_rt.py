"""Readings that set the limits of `correct` in the ray-traced splat
cells (the loop `rtview`), at a cell's own size, on the seeds given.

    python3 benchmark/control_rt.py --workload m360-rt --seeds 1 2 3

For the first check_items frames the cell's window would render and
their seeded pixels, the float32 reference (`reference/splat_rt.py`)
stands for the program and is compared, by the numbers of the loop's
check, with the control, the same reference in bfloat16, and the fault
"each pass's hits blended in walk order", the float32 reference that
composites a pass's hits in the order a sweep meets them (ascending
splat index) instead of by t*. Each seed prints one JSON line. The
benchmark's own runs never run this.
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
    loop.make_views()
    out = {"workload": workload, "seed": seed, "control": [],
           "walk_order": []}
    for item, view in enumerate(loop.check_views(int(mix["check_items"]))):
        pix = loop.pixels(item)
        want = loop.reference(view, pix)
        for key, kw in (("control", dict(dtype=torch.bfloat16)),
                        ("walk_order", dict(order="index"))):
            got = loop.reference(view, pix, **kw)
            out[key].append(mod.numbers(got["color"], got["trans"],
                                        got["hits"], want))
    for k in ("control", "walk_order"):
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
