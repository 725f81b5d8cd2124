"""BENCHMARK.json and the files it names: every workload, configuration,
traffic mix, entry and metric file loads, and names only what exists."""

from __future__ import annotations

import importlib
import json
import re

import pytest

from benchmark import harness, roofline

MAN = harness.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in MAN["workloads"]]


def test_every_workload_file_names_what_exists():
    """A workload file the manifest does not name yet still finds its
    config, traffic mix and entry."""
    from conftest import all_cells, tiny_cell

    assert set(CELLS) <= set(all_cells())
    for cell in all_cells():
        c = tiny_cell(cell)
        assert harness.entry_module(c) and c.mix["pool"] >= 1


def test_manifest_keys_and_names():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    assert MAN["paths"] == ["benchmark"]
    assert MAN["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= MAN["run_seconds"] <= 51
    names = [m["name"] for m in MAN["end_to_end"] + MAN["per_layer"]]
    names += CELLS + [c["name"] for c in MAN["configs"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert {m["name"] for m in MAN["end_to_end"]} == {
        "setup_s", "voxels_per_s", "grid_ms_p95", "peak_mem_gib"}
    for m in MAN["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for w in MAN["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
    pairs = [(w["config"], w["traffic"]) for w in MAN["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert len(json.dumps(MAN)) < 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_load(cell):
    c = harness.load_cell(cell)
    assert c.config["name"] == c.workload["config"]
    assert c.config["reduced"] == []
    assert harness.entry_module(c).__name__.endswith(c.workload["entry"])
    for fn in ("setup", "request", "failed", "record"):
        assert callable(getattr(harness.entry_module(c), fn))
    limits = c.workload["check"]["limits"]
    assert limits and all(v >= 0 for v in limits.values())
    moved = {m["name"] for m in c.end_to_end}
    for m in c.per_layer:
        assert m["moves"] in moved, (cell, m["name"])


@pytest.mark.parametrize("metric", [m["name"] for m in MAN["per_layer"]])
def test_metric_files_name_what_exists(metric):
    mod = harness.metric_module(metric)
    assert mod.KIND in ("profile", "kernel", "span")
    if mod.KIND == "span":
        for target in mod.WRAPS:
            module, attr = target.split(":")
            assert callable(getattr(importlib.import_module(module), attr)), target
    if mod.KIND == "kernel":
        from xmris_tpu_torch.ops.kernels import DISPATCH

        assert callable(getattr(DISPATCH, mod.SLOT))
        assert callable(getattr(roofline, mod.WORK))
    for cell in next(m for m in MAN["per_layer"] if m["name"] == metric)["workloads"]:
        assert cell in CELLS


def test_configs_hold_the_bench_protocol():
    from xmris_tpu_torch import bench_inputs as bi

    for c in MAN["configs"]:
        conf = json.loads((harness.ROOT / c["file"]).read_text())
        assert conf["source"] == c["source"] and conf["reduced"] == c["reduced"] == []
        assert tuple(conf["grid"]) == bi.GRID and conf["n_time"] == bi.N_TIME
        assert conf["zero_fill"] == bi.ZERO_FILL and conf["prior_csv"] == bi.PK_CSV
        assert (conf["sw_hz"], conf["mhz"]) == (bi.SW, bi.MHZ)
        assert [(p["shift_ppm"], p["linewidth_hz"]) for p in conf["peaks"]] == list(bi.PEAKS_31P)
        assert tuple(p["amplitude"] for p in conf["peaks"]) == bi.FIXED_AMPS_31P
