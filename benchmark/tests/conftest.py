"""Shared fixtures of the benchmark's own tests (run them with
``python -m pytest benchmark/tests`` from the root of a checkout)."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

pytest.register_assert_rewrite("config_checks")


@pytest.fixture
def card():
    """The CUDA device; the test skips where there is none (decided here,
    never at import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda", 0)


def all_cells():
    """Every workload file's cell, those that ``BENCHMARK.json`` does not
    name yet too."""
    from benchmark import harness

    return sorted(p.stem for p in (harness.HERE / "workloads").glob("*.json"))


def manifest_with_all_cells():
    """``BENCHMARK.json`` with an entry, on one chip, for every workload
    file it does not name."""
    import json

    from benchmark import harness

    man = harness.manifest()
    named = {w["name"] for w in man["workloads"]}
    for name in all_cells():
        if name not in named:
            wl = json.loads((harness.HERE / "workloads" / f"{name}.json").read_text())
            man["workloads"].append({"name": name, "config": wl["config"],
                                     "traffic": wl["traffic"], "chips": 1,
                                     "why": wl["why"]})
    return man


def tiny_cell(name: str, grid=(4, 4, 2), pool: int = 2, voxels: int = 16):
    """The cell ``name`` cut to a CPU-sized grid: same widths (points,
    zero-fill, prior), fewer voxels and pooled grids."""
    from benchmark import harness

    cell = harness.load_cell(name, manifest_with_all_cells())
    cell.config["grid"] = list(grid)
    cell.mix["pool"] = pool
    cell.workload["check"]["sample_voxels"] = voxels
    return cell
