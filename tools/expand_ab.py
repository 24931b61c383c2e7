#!/usr/bin/env python3
"""Same-card A/B of `expand_pairs` (Q2.2) on the training cell's f32 table,
run by two checkouts of the repository in alternating turns.

    python3 tools/expand_ab.py OLD_DIR [NEW_DIR] [--pairs N] [--json PATH]

OLD_DIR is another checkout (for example the parent commit unpacked with
`git archive` under the git-ignored `ab/`), NEW_DIR this one by default.
Each checkout gets one worker process, started in its directory so that it
imports its own gsrt_torch. A worker builds its kernels, makes
chip_smoke.py's training cell (this checkout's `train_cell`), records the
inputs of the f32 table's expand in one forward of `render_loss_tiled`,
calls its own `pair_expand.expand_pairs` on them once with its launches
and its `torch.searchsorted` calls counted, and replies with a digest of
the inputs and the output, so that both are seen to expand the same table
to the same bits. Then the two take N pairs of turns (default 5), old/new
and new/old in alternation; a turn times `expand_pairs` through its
wrapper (CUDA events around 20 calls, after one). Prints one JSON object
as its last line (and writes it to PATH with --json). Needs one CUDA
card.
"""

from __future__ import annotations

import hashlib
import importlib.util
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
TAG = "@@ "   # marks the worker's replies on its standard output
CALLS = 20


def worker() -> None:
    sys.path.insert(0, os.getcwd())
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import torch
    from gsrt_torch import _kernels
    from gsrt_torch.models import trainer
    from gsrt_torch.ops import pair_expand
    _kernels.build()
    cfg, _, camera, params, target, _, max_pairs, _ = cs.train_cell()
    with cs.Recorder(pair_expand, "expand_pairs_fused") as rec:
        trainer.render_loss_tiled(params, target, camera, cfg, max_pairs)
        torch.cuda.synchronize()
    (tab, base, mp), _ = rec.calls[0]
    del params, target
    run = lambda: pair_expand.expand_pairs(tab, base, mp)   # noqa: E731
    searches = []
    search = torch.searchsorted

    def counted(*a, **kw):
        searches.append(1)
        return search(*a, **kw)
    before = _kernels.launch_counts()
    with cs.Replaced(torch, "searchsorted", counted):
        out = run()
        torch.cuda.synchronize()
    after = _kernels.launch_counts()
    digest = lambda *ts: hashlib.sha1(b"".join(          # noqa: E731
        t.cpu().numpy().tobytes() for t in ts)).hexdigest()

    def reply(obj) -> None:
        print(TAG + json.dumps(obj), flush=True)
    reply(dict(inputs=digest(tab, base), output=digest(out),
               shape=list(out.shape), searchsorted_calls=len(searches),
               launches={k: after[k] - before[k] for k in after
                         if after[k] != before[k]}))
    del out
    for line in sys.stdin:
        if line.strip() == "turn":
            reply(dict(ms=cs.time_cuda(run, CALLS)))


def read_reply(name: str, proc) -> dict:
    for line in proc.stdout:
        if line.startswith(TAG):
            return json.loads(line[len(TAG):])
    raise SystemExit(f"worker {name} ended: rc {proc.wait()}")


def main() -> int:
    args = sys.argv[1:]
    if not args or args[0].startswith("-"):
        raise SystemExit(__doc__)
    pairs = int(args[args.index("--pairs") + 1]) if "--pairs" in args \
        else 5
    out_json = args[args.index("--json") + 1] if "--json" in args else None
    pos = [a for i, a in enumerate(args) if not a.startswith("--")
           and (i == 0 or args[i - 1] not in ("--pairs", "--json"))]
    dirs = {"old": Path(pos[0]).resolve(),
            "new": Path(pos[1] if len(pos) > 1 else ROOT).resolve()}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    procs, setup = {}, {}
    try:
        for name, d in dirs.items():
            procs[name] = subprocess.Popen(
                [sys.executable, str(Path(__file__).resolve()), "--worker"],
                cwd=d, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                text=True)
            setup[name] = read_reply(name, procs[name])
            print(f"{name} ({d}): {setup[name]}", flush=True)
        if setup["old"]["inputs"] != setup["new"]["inputs"]:
            raise SystemExit("the two checkouts expand different tables")
        ms = {name: [] for name in dirs}
        for k in range(pairs):
            for name in (("old", "new") if k % 2 == 0 else ("new", "old")):
                procs[name].stdin.write("turn\n")
                procs[name].stdin.flush()
                ms[name].append(read_reply(name, procs[name])["ms"])
        print(f"card: {smi}", flush=True)
        for name in dirs:
            print(f"{name}: expand_pairs ms per call "
                  f"{', '.join(f'{x:.4f}' for x in ms[name])}", flush=True)
    finally:
        for proc in procs.values():
            proc.stdin.close()
            try:
                proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                proc.kill()
    result = dict(card=smi, same_output=setup["old"]["output"]
                  == setup["new"]["output"], setup=setup,
                  ms=ms, median_ms={k: statistics.median(v)
                                    for k, v in ms.items()})
    if out_json:
        Path(out_json).write_text(json.dumps(result, indent=1))
    print(json.dumps(result), flush=True)
    return 0 if result["same_output"] else 1


if __name__ == "__main__":
    if sys.argv[1:] == ["--worker"]:
        worker()
    else:
        sys.exit(main())
