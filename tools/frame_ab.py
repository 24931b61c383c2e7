#!/usr/bin/env python3
"""Same-card A/B of whole frames: the render cell and the served orbit of
chip_smoke.py, run by two checkouts of the repository in alternating turns.

    python3 tools/frame_ab.py OLD_DIR [NEW_DIR] [--pairs N] [--json PATH]

OLD_DIR is another checkout (for example the parent commit unpacked with
`git archive` under the git-ignored `ab/`), NEW_DIR this one by default.
Each checkout gets one worker process, started in its directory so that it
imports its own gsrt_torch; the second starts once the first is set up, so
that neither profile overlaps other work on the card. The workloads and
`time_cuda` come from this checkout's chip_smoke.py, so both time the same
work. A worker builds its kernels, makes the render cell's cloud,
calibrates, warms the frame and the serving orbit, and profiles 10 frames
and one served orbit with torch.profiler (the kernels' device ms a frame
and a served frame). Then the two take N pairs of turns (default 10),
old/new and new/old in alternation. A turn times the frame (`render_tiled`;
CUDA events around 10 frames, in 3 groups) and serves the 48-frame orbit
once (ms/frame on the card's and on the host's clock). The summary gives
the median, minimum and maximum of each, and the device's busy shares:
profiled device ms a frame (a served frame) over the median frame (served
frame) timed without the profiler. Prints one JSON object as its last line
(and writes it to PATH with --json). Needs one CUDA card.
"""

from __future__ import annotations

import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
GROUPS = 3
TAG = "@@ "   # marks the worker's replies on its standard output


def load_chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def worker() -> None:
    sys.path.insert(0, os.getcwd())
    cs = load_chip_smoke()
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from gsrt_torch import _kernels
    from gsrt_torch.models import gaussian_rt as grt
    from gsrt_torch.serving import ServingRenderer

    _kernels.build()
    cfg, cloud, cam = cs.render_cell()
    tracer = grt.GaussianRayTracer(cfg, "tiled", device=cs.DEVICE)
    tracer.calibrate(cloud, cam)

    def frame():
        grt.render_tiled(cloud, cam, cfg, max_pairs=tracer.max_pairs,
                         max_rows=tracer.max_rows)

    path = cs.serving_orbit()
    srv = ServingRenderer(cfg, device=cs.DEVICE)

    def serve():
        srv.reset()
        for c in path:
            srv(cloud, c)
        srv.finish()

    def device_ms(fn, calls: int) -> dict:
        """Device ms a call by kernel, profiling `fn` (`calls` calls)."""
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        return {e.key: e.self_device_time_total / 1e3 / calls
                for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)}

    def reply(obj) -> None:
        print(TAG + json.dumps(obj), flush=True)

    cs.time_cuda(frame, cs.FRAMES)
    serve()
    frame_dev = device_ms(lambda: cs.time_cuda(frame, cs.FRAMES, warmup=0),
                          cs.FRAMES)
    served_dev = device_ms(serve, len(path))
    reply(dict(device_busy_ms=sum(frame_dev.values()),
               served_device_busy_ms=sum(served_dev.values()),
               top_device_ms=dict(sorted(frame_dev.items(),
                                         key=lambda kv: -kv[1])[:16])))

    for line in sys.stdin:
        if line.strip() != "turn":
            break
        frame_ms = [cs.time_cuda(frame, cs.FRAMES) for _ in range(GROUPS)]
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ev[0].record()
        serve()
        ev[1].record()
        torch.cuda.synchronize()
        reply(dict(frame_ms=frame_ms,
                   served_ms=ev[0].elapsed_time(ev[1]) / len(path),
                   served_host_ms=(time.perf_counter() - t0) * 1e3
                   / len(path)))


def read_reply(name: str, proc) -> dict:
    for line in proc.stdout:
        if line.startswith(TAG):
            return json.loads(line[len(TAG):])
    raise SystemExit(f"{name} worker ended with code {proc.wait()}")


def spread(xs: list) -> dict:
    return dict(median=statistics.median(xs), min=min(xs), max=max(xs))


def main() -> int:
    args = sys.argv[1:]
    if args == ["--worker"]:
        worker()
        return 0
    opts = {"--json": None, "--pairs": "10"}
    for key in opts:
        if key in args:
            at = args.index(key)
            if at + 1 >= len(args):
                raise SystemExit(__doc__)
            opts[key] = args[at + 1]
            del args[at:at + 2]
    if not 1 <= len(args) <= 2:
        raise SystemExit(__doc__)
    pairs = int(opts["--pairs"])
    dirs = {"old": Path(args[0]).resolve(),
            "new": Path(args[1]).resolve() if len(args) > 1 else ROOT}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    procs = {}
    report = {"card": smi, "pairs": pairs}
    try:
        for name, d in dirs.items():   # one at a time: profiles of its own
            procs[name] = subprocess.Popen(
                [sys.executable, str(Path(__file__).resolve()), "--worker"],
                cwd=d, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                text=True)
            report[name] = dict(setup=read_reply(name, procs[name]),
                                turns=[])
        for i in range(pairs):
            for name in ("old", "new") if i % 2 == 0 else ("new", "old"):
                proc = procs[name]
                proc.stdin.write("turn\n")
                proc.stdin.flush()
                turn = read_reply(name, proc)
                report[name]["turns"].append(turn)
                print(f"pair {i} {name}: frame {turn['frame_ms']} ms, served "
                      f"{turn['served_ms']:.4f} ms/frame (host "
                      f"{turn['served_host_ms']:.4f})", flush=True)
        for name in procs:
            turns = report[name]["turns"]
            frame = spread([statistics.median(t["frame_ms"]) for t in turns])
            served = spread([t["served_ms"] for t in turns])
            setup = report[name]["setup"]
            report[name]["summary"] = dict(
                frame_ms=frame, served_ms=served,
                served_host_ms=spread([t["served_host_ms"] for t in turns]),
                device_busy_share=setup["device_busy_ms"] / frame["median"],
                served_device_busy_share=setup["served_device_busy_ms"]
                / served["median"])
            print(f"{name}: {report[name]['summary']}; top device ms a frame "
                  f"{setup['top_device_ms']}", flush=True)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.stdin.close()
                try:
                    proc.wait(timeout=60)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait()
    line = json.dumps(report)
    if opts["--json"]:
        json_path = Path(opts["--json"])
        json_path.parent.mkdir(parents=True, exist_ok=True)
        json_path.write_text(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
