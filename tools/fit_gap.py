#!/usr/bin/env python3
"""Splits the fit workload's holdout gap between view-dependent colour and
the rest (geometry, too few splats, too few views).

    python3 tools/fit_gap.py [--json PATH]

Makes chip_smoke.py's fit capture twice: with the ground truth's SH-3
colour, as the `fit` phase has it, and with the ground truth's SH bands
above 0 zeroed before the targets are rendered, so that a fit of SH
degree 0 can match every view. The second capture's targets are the
ground truth's own SH-0 renders, so their PSNR against the first's is the
ceiling of any SH-0 model on the SH-3 targets (train and holdout views).
Then it runs the phase's fit (`fit_views`, 2,000 tiled steps, the phase's
schedule) on each capture and prints the initial holdout PSNR, the train
and holdout PSNR at the end, the mean loss of the first and last 100
steps and each densify event's report. Prints one JSON object as its last
line (and writes it to PATH with --json). Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--json", help="also write the result here")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    card = cs.phase_device()
    import torch
    from gsrt_torch import _kernels
    from gsrt_torch.models import multiview as mv
    torch.backends.cuda.matmul.allow_tf32 = False
    _kernels.build()

    captures = {}
    for deg in (3, 0):
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as tmp:
            captures[deg] = cs.fit_capture(tmp, sh_degree=deg)
        torch.cuda.synchronize()
        cs.log(f"capture with ground truth SH {deg}: "
               f"{time.perf_counter() - t0:.2f} s")
    vs3, vs0 = captures[3][1], captures[0][1]
    train_idx, test_idx = mv.holdout_split(vs3.n_views, cs.FIT_HOLDOUT)
    ceiling = {
        split: float(sum(mv.psnr(vs0.images[i], vs3.images[i])
                         for i in idx[:8]) / len(idx[:8]))
        for split, idx in (("train", train_idx), ("holdout", test_idx))}
    cs.log(f"{card}: the ground truth's SH-0 renders against its SH-3 "
           f"targets: train PSNR {ceiling['train']:.4f} dB, holdout "
           f"{ceiling['holdout']:.4f} dB")
    result = dict(card=card, sh0_ceiling_on_sh3_targets=ceiling, arms={})

    for deg in (3, 0):
        cfg, vs, params, extent, _ = captures.pop(deg)
        psnr0 = mv.eval_psnr(params, vs, test_idx[:8], cfg)
        events = []
        densify = mv.densify_and_prune

        def recorded(*a, **kw):
            out = densify(*a, **kw)
            events.append(out[3]._asdict())
            return out
        t0 = time.perf_counter()
        with cs.Replaced(mv, "densify_and_prune", recorded):
            params, rep = mv.fit_views(vs, params, cfg, **cs.fit_kw(extent))
        torch.cuda.synchronize()
        w = cs.FIT_WINDOW
        arm = dict(initial_holdout_psnr=psnr0, train_psnr=rep.train_psnr,
                   holdout_psnr=rep.test_psnr, rows=rep.n_splats,
                   loss_first=sum(rep.losses[:w]) / w,
                   loss_last=sum(rep.losses[-w:]) / w, events=events,
                   fit_s=time.perf_counter() - t0)
        result["arms"][f"sh{deg}_targets"] = arm
        cs.log(f"{card}: ground truth SH {deg}: holdout PSNR {psnr0:.4f} -> "
               f"{rep.test_psnr:.4f} dB, train PSNR {rep.train_psnr:.4f} dB, "
               f"mean loss {arm['loss_first']:.5f} -> {arm['loss_last']:.5f},"
               f" live after each event "
               f"{[e['n_after'] for e in events]}, cloned "
               f"{[e['n_cloned'] for e in events]}, split "
               f"{[e['n_split'] for e in events]}, {arm['fit_s']:.2f} s")
        del vs, params
    line = json.dumps(result)
    if args.json:
        Path(args.json).write_text(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
