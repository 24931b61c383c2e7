"""The control of `correct`: the reference in the program's place,
computed in bfloat16, fails a cell's limits. On the CPU at the tiny
copy's size; on the card (marker gpu) at each cell's own size, on three
seeds, as the limits were set."""

from __future__ import annotations

import json

import pytest
import torch

from benchmark import control, harness
from benchmark.tests.bench_tiny import make_tiny

CELLS = ("m360-view", "m360-serve", "tandt-train")


def _fails(numbers: dict, limits: dict) -> bool:
    return any(numbers[k] > limits[k] for k in limits)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return make_tiny(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_the_limits_on_cpu(tiny, workload):
    r = control.readings(workload, 11, "cpu",
                         bench_path=tiny / "BENCHMARK.json",
                         pkg_root=tiny / "benchmark", repo_root=tiny)
    limits = json.loads((tiny / "benchmark/limits" / f"{workload}.json")
                        .read_text())
    assert _fails(r["control"], limits), r
    if "half_batch" in r:
        assert _fails(r["half_batch"], limits), r


@pytest.mark.gpu
@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_the_limits_on_the_card(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cell's own size")
    limits = harness.load_json(harness.PKG / "limits" / f"{workload}.json")
    for seed in (4300000001, 4300000002, 4300000003):
        r = control.readings(workload, seed, "cuda")
        assert _fails(r["control"], limits), r
