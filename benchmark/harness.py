"""The benchmark's runner: one run of one cell.

Everything that belongs to one configuration, traffic mix or metric is
found by name: the cell in `BENCHMARK.json`'s `workloads`, its
configuration in the file `configs` names, its traffic mix in
`benchmark/traffic/<traffic>.json`, the loop the mix names in
`benchmark/loops/<loop>.py`, and each metric's reader in
`benchmark/metrics/<metric>.py`. This file holds what every cell shares:
the window, the spans round the port's layers, the profiled stretch, the
module check and the result line.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import math
import os
import sys
import tempfile
import time
from dataclasses import dataclass, field
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PKG = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "gsrt")
# items a traced run profiles and drops before the stretch it reads: the
# profiler's start slows the first ones
PROFILE_WARMUP = 2


# --- arithmetic shared by the readers (kept here, tested on the CPU) ---

def percentile(values, q: float) -> float:
    """The q-th percentile (0-100) by linear interpolation between the
    closest ranks (numpy's default)."""
    v = sorted(values)
    if not v:
        raise ValueError("percentile of nothing")
    pos = (len(v) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def union_seconds(intervals) -> float:
    """Length of the union of [start, end) intervals (any unit)."""
    total, end = 0.0, -math.inf
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def gaps(intervals):
    """The holes between the union's pieces: [(start, end)]."""
    out, end = [], None
    for s, e in sorted(intervals):
        if end is not None and s > end:
            out.append((end, s))
        end = e if end is None else max(end, e)
    return out


def offending_modules(names) -> list[str]:
    """Loaded modules whose top-level name (before the first dot) is one
    of FORBIDDEN, compared whole: `gsrt_torch` passes, `gsrt.ops` fails."""
    return sorted({n for n in names if n.split(".", 1)[0] in FORBIDDEN})


# --- spans: CUDA events round calls into the port's layers ---

class Spans:
    """Wraps module functions from outside: each call records a CUDA event
    before and after it (on the current stream) and, while a profiler
    runs, a `record_function` range of the span's label. `ms()` gives
    each label's device-clock durations. On the CPU (tests) the host
    clock stands in."""

    def __init__(self, torch, cuda: bool):
        self.torch, self.cuda = torch, cuda
        self.events: dict[str, list] = {}
        self.patched = []

    def wrap(self, obj, attr: str, label: str) -> None:
        orig = getattr(obj, attr)
        torch, cuda, events = self.torch, self.cuda, self.events

        def wrapped(*args, **kw):
            with torch.profiler.record_function(label):
                if cuda:
                    a = torch.cuda.Event(enable_timing=True)
                    a.record()
                else:
                    a = time.perf_counter()
                out = orig(*args, **kw)
                if cuda:
                    b = torch.cuda.Event(enable_timing=True)
                    b.record()
                else:
                    b = time.perf_counter()
            events.setdefault(label, []).append((a, b))
            return out
        setattr(obj, attr, wrapped)
        self.patched.append((obj, attr, orig))

    def restore(self) -> None:
        for obj, attr, orig in reversed(self.patched):
            setattr(obj, attr, orig)
        self.patched = []

    def ms(self) -> dict[str, list[float]]:
        if self.cuda:
            self.torch.cuda.synchronize()
            return {k: [a.elapsed_time(b) for a, b in v]
                    for k, v in self.events.items()}
        return {k: [(b - a) * 1e3 for a, b in v]
                for k, v in self.events.items()}


def resolve_attr(path: str):
    """'gsrt_torch.models.gaussian_rt:_precompute' → (module, attr)."""
    mod, attr = path.split(":")
    return importlib.import_module(mod), attr


# --- the profiled stretch ---

@dataclass
class Trace:
    """What a profiled stretch of the window gives: device intervals
    (µs), kernel durations by name, host ranges by name, its length."""
    window_s: float
    device: list = field(default_factory=list)      # (start, end, name)
    host: list = field(default_factory=list)        # (start, end, name)
    items: list = field(default_factory=list)       # loop items traced

    @property
    def busy_s(self) -> float:
        return union_seconds([(s, e) for s, e, _ in self.device]) * 1e-6

    def kernel_seconds(self, name: str) -> float:
        return sum(e - s for s, e, n in self.device if name in n) * 1e-6

    def device_ops(self, top: int = 10) -> list:
        tot: dict[str, float] = {}
        for s, e, n in self.device:
            tot[n] = tot.get(n, 0.0) + (e - s) * 1e-6
        return sorted(([n[:120], t] for n, t in tot.items()),
                      key=lambda x: -x[1])[:top]

    def idle_gaps(self, top: int = 10) -> list:
        """The longest idle gaps, each named by the innermost host range
        that spans its midpoint."""
        holes = sorted(gaps([(s, e) for s, e, _ in self.device]),
                       key=lambda g: g[0] - g[1])[:top]
        out = []
        for s, e in holes:
            mid = 0.5 * (s + e)
            spans = [(hs, he, n) for hs, he, n in self.host
                     if hs <= mid <= he]
            name = min(spans, key=lambda x: x[1] - x[0])[2] if spans \
                else "host"
            out.append([name[:120], (e - s) * 1e-6])
        return out


def read_chrome_trace(path: str, window_s: float, items) -> Trace:
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    tr = Trace(window_s=window_s, items=list(items))
    for ev in events:
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        cat = ev.get("cat", "")
        s = float(ev["ts"])
        e = s + float(ev["dur"])
        if cat in ("kernel", "gpu_memcpy", "gpu_memset"):
            tr.device.append((s, e, ev.get("name", "?")))
        elif cat in ("cpu_op", "user_annotation", "cuda_runtime",
                     "python_function"):
            tr.host.append((s, e, ev.get("name", "?")))
    return tr


# --- the run ---

@dataclass
class Run:
    """What a metric's reader sees."""
    loop: object
    setup_s: float = 0.0
    window_s: float = 0.0
    items: list = field(default_factory=list)   # per item: dict
    spans: dict = field(default_factory=dict)   # label -> [ms]
    profile: Trace | None = None

    @property
    def completed(self) -> list:
        return [i for i in self.items if i.get("latency_s") is not None]

    def span_ms_per_item(self, label: str):
        """Mean device ms of a span per completed item, or None."""
        v = self.spans.get(label)
        if not v or not self.completed:
            return None
        return sum(v) / len(self.completed)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def find_cell(bench: dict, name: str):
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; known: "
                         f"{sorted(cells)}")
    cell = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    return cell, configs[cell["config"]]


def metrics_for(bench: dict, key: str, cell: str) -> list[dict]:
    return [m for m in bench[key]
            if "workloads" not in m or cell in m["workloads"]]


def load_module(kind: str, name: str, root: Path):
    """benchmark/<kind>/<name>.py under `root`, imported by path."""
    path = root / kind / f"{name}.py"
    if not path.is_file():
        raise SystemExit(f"no {kind[:-1]} file {path}")
    spec = importlib.util.spec_from_file_location(
        f"benchmark_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *,
             device: str = "cuda", bench_path: Path | None = None,
             pkg_root: Path | None = None, repo_root: Path | None = None,
             t_start: float | None = None, patch=None) -> dict:
    """Run one cell and return the result dict (without printing).
    `device`, `bench_path`, `pkg_root` and `patch` (a callable given the
    loop before its set-up) let tests drive a run on the CPU from a
    temporary directory."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    repo_root = repo_root or ROOT
    pkg_root = pkg_root or PKG
    bench = load_json(bench_path or repo_root / "BENCHMARK.json")
    cell, cfg_entry = find_cell(bench, workload)
    config = load_json(repo_root / cfg_entry["file"])
    mix = load_json(pkg_root / "traffic" / f"{cell['traffic']}.json")
    loop_mod = load_module("loops", mix["loop"], pkg_root)
    cuda = device.startswith("cuda")

    n_prof = int(mix.get("trace_items", 0)) if trace else 0
    loop = loop_mod.Loop(config, mix, seed, device)
    loop.trace_items = PROFILE_WARMUP + n_prof if n_prof else 0
    if patch is not None:
        patch(loop)
    loop.setup()
    if cuda:
        torch.cuda.synchronize()
    marks = getattr(loop, "marks", [])
    if marks:
        print("setup: " + ", ".join(f"{k} {t - t_start:.2f}s"
                                    for k, t in marks), file=sys.stderr)
    spans = Spans(torch, cuda)
    if trace:
        for path, label in loop.SPANS:
            obj, attr = resolve_attr(path)
            spans.wrap(obj, attr, label)
        for obj, attr, label in loop.object_spans():
            spans.wrap(obj, attr, label)
    if cuda:
        torch.cuda.synchronize()
    run = Run(loop=loop)
    run.setup_s = time.perf_counter() - t_start

    # the window: items one after another, each ending synchronised; a
    # traced run profiles items [PROFILE_WARMUP, PROFILE_WARMUP + n_prof)
    prof = None
    if n_prof and cuda:
        fd, trace_path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA],
            schedule=torch.profiler.schedule(
                wait=0, warmup=PROFILE_WARMUP, active=n_prof, repeat=1),
            on_trace_ready=lambda p: p.export_chrome_trace(trace_path))
        prof.start()
    w0 = time.perf_counter()
    while True:
        t0 = time.perf_counter()
        try:
            rec = loop.step()
            if cuda:
                torch.cuda.synchronize()
            rec["latency_s"] = time.perf_counter() - t0
        except Exception as e:   # noqa: BLE001 - a failed item is counted
            rec = {"latency_s": None, "error": f"{type(e).__name__}: {e}"}
            print(f"item {len(run.items)} failed: {rec['error']}",
                  file=sys.stderr)
        run.items.append(rec)
        loop.keep(len(run.items) - 1, rec)
        if prof is not None:
            n = len(run.items)
            if n == PROFILE_WARMUP + n_prof:
                prof_s = time.perf_counter() - prof_t0
            prof.step()
            if n == PROFILE_WARMUP:
                prof_t0 = time.perf_counter()
            elif n == PROFILE_WARMUP + n_prof:
                prof.stop()
                run.profile = read_chrome_trace(
                    trace_path, prof_s, run.items[PROFILE_WARMUP:n])
                os.unlink(trace_path)
                prof = None
        if time.perf_counter() - w0 >= seconds and prof is None:
            break
    run.window_s = time.perf_counter() - w0
    spans.restore()
    if trace:
        run.spans = spans.ms()
    memory_peak = torch.cuda.max_memory_allocated() if cuda else 0

    # metrics, then the program's state goes and the reference runs
    key = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in metrics_for(bench, key, cell["name"]):
        if m["name"] == "setup_s":
            value = run.setup_s
        else:
            value = load_module("metrics", m["name"], pkg_root).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    checks = loop.check(load_json(pkg_root / "limits"
                                  / f"{cell['name']}.json"))
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                  for c in checks.values())
    failed = sum(1 for i in run.items if i.get("latency_s") is None)
    if cuda:
        dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
               "count": int(cell.get("chips", 1)),
               "memory_peak_bytes": int(memory_peak)}
    else:
        dev = {"platform": "cpu", "kind": "cpu", "count": 1,
               "memory_peak_bytes": 0}
    result = {"correct": bool(correct), "attempted": len(run.items),
              "failed": failed, "metrics": metrics, "device": dev}
    if run.profile is not None:
        dev["busy_s"] = run.profile.busy_s
        dev["window_s"] = run.profile.window_s
        result["breakdown"] = {"device_ops": run.profile.device_ops(),
                               "idle_gaps": run.profile.idle_gaps()}
    result["checks"] = checks
    return result


def main(argv=None, t_start: float | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    bench = load_json(ROOT / "BENCHMARK.json")
    cell, _ = find_cell(bench, args.workload)
    chips = int(cell.get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"the cell needs {chips} CUDA device(s); "
              f"cuda available: {torch.cuda.is_available()}, devices: "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), t_start=t_start)
    bad = offending_modules(sys.modules)
    if bad:
        print("module check failed: the run loaded " + ", ".join(bad),
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(result), flush=True)
    return 0
