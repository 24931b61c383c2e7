"""Readings that set the limits of `correct` in the path-tracing cells
(the loop `pt`), at a cell's own size, on the seeds given.

    python3 benchmark/control_pt.py --workload bathroom-pt --seeds 1 2 3

`control.py` puts the splat reference (`reference/splats.py`) in the
program's place for every frame loop, so the path tracer's control lives
here. For the first check_items frames the cell's window would render and
their seeded pixels, the float32 reference (`reference/pathtrace.py`)
stands for the program and is compared, by the numbers of the loop's
check, with the control, the same reference in bfloat16, and the fault
"the last bounce dropped", the float32 reference with one segment
fewer. Each seed prints one JSON line. The benchmark's own runs never
run this.
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
           "last_bounce_dropped": []}
    for item in range(int(mix["check_items"])):
        s, pix = loop.frame_seed(0, item), loop.pixels(item)
        want = loop.reference(f32, s, pix)
        out["control"].append(mod.numbers(
            *loop.reference(bf16, s, pix, dtype=torch.bfloat16), *want))
        out["last_bounce_dropped"].append(mod.numbers(
            *loop.reference(f32, s, pix, bounces=config["bounces"] - 1),
            *want))
    for k in ("control", "last_bounce_dropped"):
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
