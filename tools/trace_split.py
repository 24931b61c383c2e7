#!/usr/bin/env python3
"""Where a benchmark cell's traced time goes, by the program's own spans.

    python3 tools/trace_split.py --workload NAME --seed N [--seconds S]
        [--root DIR] [--json PATH]

Runs one traced run of the cell (`benchmark.harness.run_cell`, as
`benchmark/run.py --trace 1` does) with the gsrt_torch of `--root` (this
checkout by default; another one, such as the parent commit unpacked
under the git-ignored `ab/`, gives the same run without the program's
spans) and keeps the profiler's raw trace. It prints one JSON object as
its last line (and writes it to PATH with --json):

- `result`: the run's result line (`metrics`, `correct`, `device`);
- `traced_latency_ms`: each traced item's host-clock latency;
- `outside_traced_ms`: the benchmark's outside spans (harness.Spans)
  over the traced items alone, device ms an item, where the result
  line's averages take every item of the window;
- with the program's tracer (`gsrt_torch.utils.profiling.TRACER`):
  `tree`, for each span name under its parent, device ms an item; `self`,
  the roots' device ms an item less their direct children's;
  `kernels_by_span`, each kernel's device ms attributed to the innermost
  program span open on the thread that launched it (the launch's
  correlation id), top 40; `idle`, the traced stretch's idle split by
  what the host was doing at each gap's midpoint: inside a `*.sync` span
  (host wait), inside a layer span (launch idle, by the innermost), in a
  root outside its layers, or outside every root; `gaps`, the longest
  gaps with the innermost host range of any kind (as the ledger names
  them) and the innermost program span; `unspanned`, the roots' device
  ms an item in no leaf span (`benchmark/span_cover.py`).

With `--cost BLOCKS` it measures instead what the program's spans cost
while a profiler records: the cell's items in one process, in blocks of
8 under a recording profiler, alternating spans on and forced off
(`span_cost`), and prints the latency of each, and the host µs of the
tracer's own bookkeeping (`bookkeeping_cost`).

Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def innermost(ranges, t):
    """The shortest (start, end, name) range holding t, or None."""
    hold = [r for r in ranges if r[0] <= t <= r[1]]
    return min(hold, key=lambda r: r[1] - r[0]) if hold else None


def split(events, report, items: int) -> dict:
    """The trace's kernels and idle gaps by the program's spans."""
    from benchmark.harness import gaps
    names = {s["name"] for s in report}
    sync = {n for n in names if n.endswith(".sync")}
    roots = {s["name"] for i, s in enumerate(report) if s["root"] == i}
    spans, host, launches, device = [], [], {}, []
    for ev in events:
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        s, e = float(ev["ts"]), float(ev["ts"]) + float(ev["dur"])
        cat, name = ev.get("cat", ""), ev.get("name", "?")
        corr = (ev.get("args") or {}).get("correlation")
        if cat == "user_annotation" and name in names:
            spans.append((s, e, name, ev.get("tid")))
        if cat in ("cpu_op", "user_annotation", "cuda_runtime"):
            host.append((s, e, name))
        if cat == "cuda_runtime" and corr is not None:
            launches[corr] = (s, ev.get("tid"))
        elif cat in ("kernel", "gpu_memcpy", "gpu_memset"):
            device.append((s, e, name, corr))

    by_kernel: dict = {}
    for s, e, name, corr in device:
        at, tid = launches.get(corr, (None, None))
        # a thread with no span open (autograd's backward thread) launches
        # inside the span open on the root's thread, as the tracer parents
        span = None if at is None else (
            innermost([r for r in spans if r[3] == tid], at)
            or innermost(spans, at))
        key = (name[:200], span[2] if span else "outside the spans")
        by_kernel[key] = by_kernel.get(key, 0.0) + (e - s) * 1e-3 / items

    idle: dict = {}
    waits = [r for r in spans if r[2] in sync]
    layer = [r for r in spans if r[2] not in roots and r[2] not in sync]
    items_at = [r for r in spans if r[2] in roots]
    holes = gaps([(a, b) for a, b, _, _ in device])
    for s, e in holes:
        m = 0.5 * (s + e)
        if innermost(waits, m):
            key = f"host wait ({innermost(waits, m)[2]})"
        elif innermost(layer, m):
            key = f"launch idle ({innermost(layer, m)[2]})"
        elif innermost(items_at, m):
            key = "root, outside its layers"
        else:
            key = "outside every root"
        idle[key] = idle.get(key, 0.0) + (e - s) * 1e-3 / items
    named = []
    for s, e in sorted(holes, key=lambda g: g[0] - g[1])[:15]:
        m = 0.5 * (s + e)
        prog, anyr = innermost(spans, m), innermost(host, m)
        named.append([round((e - s) * 1e-3, 4),
                      anyr[2] if anyr else "host",
                      prog[2] if prog else None])
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:40]
    return dict(
        kernels_by_span=[[k, sp, round(ms, 4)] for (k, sp), ms in top],
        idle={k: round(v, 4) for k, v in sorted(idle.items(),
                                                key=lambda kv: -kv[1])},
        gaps=named)


def tree(report, items: int) -> dict:
    """Device ms an item by (parent name → span name), and roots' self."""
    out: dict = {}
    self_ms: dict = {}
    for i, s in enumerate(report):
        if s["root"] is None:
            continue
        up = report[s["parent"]]["name"] if s["parent"] is not None \
            else "-"
        key = f"{up} > {s['name']}"
        out[key] = out.get(key, 0.0) + s["device_ms"] / items
        if s["root"] == i:
            kids = sum(c["device_ms"] for c in report if c["parent"] == i)
            self_ms[s["name"]] = self_ms.get(s["name"], 0.0) + (
                s["device_ms"] - kids) / items
    return dict(tree={k: round(v, 4) for k, v in out.items()},
                self={k: round(v, 4) for k, v in self_ms.items()})


def span_cost(harness, torch, workload: str, seed: int, blocks: int,
              items: int) -> dict:
    """Host-clock latency of the cell's items under a recording profiler
    with the program's spans on and forced off, in alternating blocks
    of `items` (after 2 dropped; a first block of each dropped) in one
    process on one card: mean and quartiles (ms)."""
    import time
    from gsrt_torch.utils import profiling
    bench = harness.load_json(ROOT / "BENCHMARK.json")
    cell, entry = harness.find_cell(bench, workload)
    mix = harness.load_json(harness.PKG / "traffic"
                            / f"{cell['traffic']}.json")
    loop = harness.load_module("loops", mix["loop"], harness.PKG).Loop(
        harness.load_json(ROOT / entry["file"]), mix, seed, "cuda")
    loop.setup()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    on = profiling._profiling
    lat: dict = {"on": [], "off": []}
    # block -1 warms the profiler in both modes and is dropped
    for b in range(-1, blocks):
        for mode in ("on", "off") if b % 2 == 0 else ("off", "on"):
            profiling._profiling = on if mode == "on" else (lambda: False)
            with torch.profiler.profile(activities=acts):
                for i in range(items + 2):
                    t0 = time.perf_counter()
                    loop.step()
                    torch.cuda.synchronize()
                    if i >= 2 and b >= 0:
                        lat[mode].append((time.perf_counter() - t0) * 1e3)
            profiling._profiling = on
            profiling.TRACER.reset()
    return {mode: dict(mean=statistics.mean(v), n=len(v),
                       quartiles=statistics.quantiles(v, n=4))
            for mode, v in lat.items()}


def bookkeeping_cost(torch, n: int = 2000) -> dict:
    """Host µs, mean over n calls on one card, of what a span does besides
    its range: a root's read of the allocator's statistics
    (`_device_allocs`), and the creation and record of one CUDA event (a
    span makes two)."""
    import time
    from gsrt_torch.utils import profiling
    out = {}
    for name, fn in (
            ("device_allocs_us", profiling._device_allocs),
            ("event_us", lambda: torch.cuda.Event(enable_timing=True)
             .record())):
        for _ in range(50):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        out[name] = (time.perf_counter() - t0) / n * 1e6
        torch.cuda.synchronize()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--root", default=str(ROOT))
    ap.add_argument("--json")
    ap.add_argument("--cost", type=int, default=0, metavar="BLOCKS",
                    help="measure the spans' cost instead (see span_cost)")
    args = ap.parse_args(argv)

    # as benchmark/run.py: one core, one compute thread a library
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    if hasattr(os, "sched_setaffinity"):
        os.sched_setaffinity(0, {max(os.sched_getaffinity(0))})
    sys.path.insert(0, str(ROOT))
    from benchmark import harness       # this checkout's benchmark
    sys.path.insert(0, str(Path(args.root).resolve()))  # its gsrt_torch
    import torch

    if args.cost:
        torch.cuda.set_device(0)
        out = dict(workload=args.workload, seed=args.seed,
                   cost=span_cost(harness, torch, args.workload, args.seed,
                                  args.cost, 8),
                   bookkeeping=bookkeeping_cost(torch))
        print(json.dumps(out), flush=True)
        if args.json:
            Path(args.json).parent.mkdir(parents=True, exist_ok=True)
            Path(args.json).write_text(json.dumps(out) + "\n")
        return 0
    kept = {}
    read = harness.read_chrome_trace
    profiling = torch._C._autograd._profiler_enabled

    class Spans(harness.Spans):
        """The harness's outside spans, each call marked traced or not."""

        def __init__(self, *a):
            super().__init__(*a)
            self.traced: dict = {}
            kept["spans"] = self

        def wrap(self, obj, attr, label):
            super().wrap(obj, attr, label)
            inner = getattr(obj, attr)

            def marked(*args, **kw):
                on = profiling()
                out = inner(*args, **kw)
                self.traced.setdefault(label, []).append(on)
                return out
            setattr(obj, attr, marked)
    harness.Spans = Spans

    def keep(path, window_s, items):
        with open(path) as f:
            kept["events"] = json.load(f).get("traceEvents", [])
        kept["latency"] = [i.get("latency_s") for i in items]
        return read(path, window_s, items)
    harness.read_chrome_trace = keep
    torch.cuda.set_device(0)
    result = harness.run_cell(args.workload, args.seed, args.seconds, True)
    result.pop("breakdown", None)
    lat = [x * 1e3 for x in kept.get("latency", []) if x is not None]
    outside = kept["spans"]
    ms = outside.ms()
    out = dict(workload=args.workload, seed=args.seed, root=args.root,
               result=result, traced_latency_ms=lat,
               traced_mean_ms=sum(lat) / len(lat) if lat else None,
               # the outside spans over the traced items alone
               outside_traced_ms={
                   k: sum(t for t, on in zip(v, outside.traced[k]) if on)
                   / len(lat) for k, v in ms.items()} if lat else None)
    try:
        from gsrt_torch.utils.profiling import TRACER
    except ImportError:
        TRACER = None
    report = TRACER.report() if TRACER is not None else []
    items = sum(1 for i, s in enumerate(report) if s["root"] == i)
    if items:
        from benchmark.span_cover import unspanned
        out.update(tree(report, items))
        out["unspanned"] = round(unspanned(report) / items, 4)
        out.update(split(kept.get("events", []), report, items))
        out["items"] = items
    line = json.dumps(out)
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
