"""Readings that set the limits of `correct`: the control and the faults,
at a cell's own size, on the seeds given.

    python3 benchmark/control.py --workload NAME --seeds 1 2 3

For every cell the control is the reference put in the program's place
and computed in bfloat16, the precision below the float32 the
configurations state: the frames the loop's check would compare (render
cells) or the first check_steps training steps (training cells), read by
the same numbers as a run's check. A training cell also reads the fault
"half of the batch left out, the mean taken over the rest": the f32
reference with its loss over the image's top half. Each seed prints one
JSON line. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark import compare, harness  # noqa: E402
from benchmark.reference import splats  # noqa: E402


def readings(workload: str, seed: int, device: str = "cuda", *,
             bench_path=None, pkg_root=None, repo_root=None) -> dict:
    repo_root = repo_root or harness.ROOT
    pkg_root = pkg_root or harness.PKG
    bench = harness.load_json(bench_path or repo_root / "BENCHMARK.json")
    cell, cfg_entry = harness.find_cell(bench, workload)
    config = harness.load_json(repo_root / cfg_entry["file"])
    mix = harness.load_json(pkg_root / "traffic" / f"{cell['traffic']}.json")
    loop = harness.load_module("loops", mix["loop"], pkg_root).Loop(
        config, mix, seed, device)
    out = {"workload": workload, "seed": seed}
    if mix["loop"] == "train":
        loop.make_inputs()
        f32 = loop.reference()
        out["control"] = compare.train_numbers(
            loop.reference(dtype=torch.bfloat16), f32, loop.params0)
        half = slice(0, config["height"] // 2)
        out["half_batch"] = compare.train_numbers(
            loop.reference(loss_rows=half), f32, loop.params0)
        return out
    loop.make_scene()
    loop.make_views()
    nums = []
    for view in loop.check_views(int(mix["check_items"])):
        r = splats.render(loop.cloud, loop.cov, view)
        c = splats.render(loop.cloud, loop.cov, view, dtype=torch.bfloat16)
        nums.append(compare.frame_numbers(c["color"], c["trans"],
                                          r["color"], r["trans"]))
    out["control"] = compare.worst(nums)
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
