#!/usr/bin/env python3
"""Where a benchmark cell's window items ask the card for memory.

    python3 tools/alloc_probe.py --workload NAME --seed N [--items K]
        [--traced] [--root DIR]

Runs the cell's loop as `benchmark/run.py` does (set-up, then items one
after another, each synchronised and handed to the loop's `keep`) with
the gsrt_torch and benchmark of `--root` (this checkout by default; the
parent commit unpacked under the git-ignored `ab/` gives the same run of
it), recording the caching allocator's history
(`torch.cuda.memory._record_memory_history`). For each item it prints
the host ms, the change of `num_device_alloc` (the cudaMalloc calls) and
every new segment: its bytes and the innermost frames of gsrt_torch and
benchmark that asked for it. `--traced` profiles items 0-5 as a traced
run does (warm-up 2, active 4). Prints one JSON object. Needs one CUDA
card.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--items", type=int, default=10)
    ap.add_argument("--traced", action="store_true")
    ap.add_argument("--root", default=str(ROOT))
    args = ap.parse_args(argv)
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import torch

    from benchmark import harness
    bench = harness.load_json(root / "BENCHMARK.json")
    cell, entry = harness.find_cell(bench, args.workload)
    mix = harness.load_json(root / "benchmark" / "traffic"
                            / f"{cell['traffic']}.json")
    loop = harness.load_module("loops", mix["loop"], root / "benchmark").Loop(
        harness.load_json(root / entry["file"]), mix, args.seed, "cuda")
    loop.setup()
    torch.cuda.synchronize()
    torch.cuda.memory._record_memory_history(max_entries=500_000,
                                             stacks="python")
    prof = None
    if args.traced:
        prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA],
            schedule=torch.profiler.schedule(
                wait=0, warmup=harness.PROFILE_WARMUP, active=4, repeat=1))
        prof.start()
    items, seen = [], 0
    for k in range(args.items):
        a0 = torch.cuda.memory_stats()["num_device_alloc"]
        t0 = time.perf_counter()
        rec = loop.step()
        torch.cuda.synchronize()
        rec["latency_s"] = time.perf_counter() - t0
        loop.keep(k, rec)
        torch.cuda.synchronize()
        allocs = torch.cuda.memory_stats()["num_device_alloc"] - a0
        if prof is not None:
            prof.step()
            if k == harness.PROFILE_WARMUP + 3:
                prof.stop()
                prof = None
        segs = [e for e in torch.cuda.memory._snapshot()["device_traces"][0]
                if e.get("action") == "segment_alloc"]
        items.append(dict(
            item=k, ms=rec["latency_s"] * 1e3, allocs=allocs,
            reserved=torch.cuda.memory_reserved(),
            segments=[dict(bytes=e["size"], frames=[
                f"{Path(f['filename']).name}:{f['line']}:{f['name']}"
                for f in e.get("frames", []) if "gsrt_torch" in
                f["filename"] or "benchmark" in f["filename"]][:6])
                for e in segs[seen:]]))
        seen = len(segs)
    print(json.dumps(dict(workload=args.workload, seed=args.seed,
                          traced=args.traced,
                          device=torch.cuda.get_device_name(0),
                          items=items)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
