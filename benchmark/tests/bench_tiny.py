"""A copy of the benchmark at a size the CPU holds: every configuration
cut to a few thousand splats at 96x64, every mix to a few views. Tests
run cells of the copy through the harness on the CPU.

The copy's frames do not saturate as the cells' do, so the compact
payload's u8 opacity shows in the transmittance (about 5e-4 mean, where
the cells read about 2e-5): the frame cells' trans_mae limit is
TINY_TRANS_MAE here."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

TINY_TRANS_MAE = 4e-3
REPO = Path(__file__).resolve().parents[2]


def make_tiny(root: Path) -> Path:
    """Write the copy under root; returns root (its BENCHMARK.json, the
    package under root/benchmark)."""
    shutil.copytree(REPO / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    for c in bench["configs"]:
        p = root / c["file"]
        d = json.loads(p.read_text())
        d.update(splats=3000, width=96, height=64)
        d["assumed"]["scale_range"] = [0.05, 0.2]
        p.write_text(json.dumps(d))
    for p in (root / "benchmark" / "traffic").glob("*.json"):
        d = json.loads(p.read_text())
        if "views" in d:
            d["views"] = 4
        if "warm_frames" in d:
            d["warm_frames"] = 2
        if "target_grid" in d:
            d["target_grid"] = [3, 4]
        p.write_text(json.dumps(d))
    for p in (root / "benchmark" / "limits").glob("*.json"):
        d = json.loads(p.read_text())
        if "trans_mae" in d:
            d["trans_mae"] = TINY_TRANS_MAE
            p.write_text(json.dumps(d))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def run(root: Path, workload: str, seed: int = 2 ** 33 + 5,
        seconds: float = 1.0, trace: bool = False, patch=None) -> dict:
    from benchmark import harness
    return harness.run_cell(workload, seed, seconds, trace, device="cpu",
                            bench_path=root / "BENCHMARK.json",
                            pkg_root=root / "benchmark", repo_root=root,
                            patch=patch)
