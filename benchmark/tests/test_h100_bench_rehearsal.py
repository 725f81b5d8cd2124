"""A tiny-size CPU rehearsal of each cell's run: the entry's control flow,
the closed loop, the sampling and the comparison, with the kernels' plain
versions; it reports no device metric.  Without a card the run fails and
prints no result."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from benchmark import harness
from benchmark import run as brun

from conftest import ROOT, all_cells, tiny_cell

CELLS = all_cells()


@pytest.mark.parametrize("cell", CELLS)
def test_rehearsal_is_correct_and_reports_no_device_metric(cell):
    from xmris_tpu_torch.ops.kernels import PLAIN

    res = brun.run(tiny_cell(cell), 2**31 + 17, 2.0, False, device="cpu",
                   kernels=PLAIN)
    assert res["correct"], res["checks"]
    assert res["metrics"] == {} and res["device"]["platform"] == "cpu"
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert list(res)[-1] == "checks"
    assert set(res["checks"]) == set(tiny_cell(cell).workload["check"]["limits"])


def test_no_card_no_result():
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "p31_grid.maps", "--seed",
         "1", "--seconds", "1", "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert not out.stdout.strip()


def test_outside_a_checkout_no_result(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's files (no
    program) gives no result."""
    import shutil

    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "p31_grid.maps", "--seed",
         "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path, capture_output=True,
        text=True, env={"PATH": "/usr/bin:/bin"})
    assert out.returncode != 0
    assert not any(line.startswith("{") for line in out.stdout.splitlines())


@pytest.mark.cuda
def test_a_short_run_on_the_card_is_correct(card):
    res = brun.run(harness.load_cell("p31_grid.maps"), 5, 2.0, False)
    assert res["correct"], res["checks"]
    assert json.dumps(res)
