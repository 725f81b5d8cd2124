"""BENCHMARK.json and the files it names: every workload, configuration,
traffic mix, entry and metric file loads, and names only what exists.
Each configuration is held to its own source (``config_checks.py``); the
two of the bench protocol are held to ``bench_inputs`` besides."""

from __future__ import annotations

import importlib
import json
import re

import pytest

from benchmark import harness, roofline

import config_checks

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


def _check_manifest(man):
    cells = [w["name"] for w in man["workloads"]]
    assert set(man) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    assert man["paths"] == ["benchmark"]
    assert man["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= man["run_seconds"] <= 51
    names = [m["name"] for m in man["end_to_end"] + man["per_layer"]]
    names += cells + [c["name"] for c in man["configs"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in man["end_to_end"] + man["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert {m["name"] for m in man["end_to_end"]} == {
        "setup_s", "voxels_per_s", "grid_ms_p95", "peak_mem_gib"}
    for m in man["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for w in man["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
    pairs = [(w["config"], w["traffic"]) for w in man["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert len(json.dumps(man)) < 64 * 1024
    used = {w["config"] for w in man["workloads"]}
    assert used <= {c["name"] for c in man["configs"]}


def test_manifest_keys_and_names():
    _check_manifest(MAN)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_load(cell):
    c = harness.load_cell(cell)
    assert c.config["name"] == c.workload["config"]
    config_checks.check_config(
        next(e for e in MAN["configs"] if e["name"] == c.config["name"]), c.config)
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


@pytest.mark.parametrize("name", ["p31_csi", "p31_csi_8coil"])
def test_configs_hold_the_bench_protocol(name):
    from xmris_tpu_torch import bench_inputs as bi

    c = next(c for c in MAN["configs"] if c["name"] == name)
    conf = json.loads((harness.ROOT / c["file"]).read_text())
    assert conf["source"] == c["source"] and conf["reduced"] == c["reduced"] == []
    assert tuple(conf["grid"]) == bi.GRID and conf["n_time"] == bi.N_TIME
    assert conf["zero_fill"] == bi.ZERO_FILL and conf["prior_csv"] == bi.PK_CSV
    assert (conf["sw_hz"], conf["mhz"]) == (bi.SW, bi.MHZ)
    assert [(p["shift_ppm"], p["linewidth_hz"]) for p in conf["peaks"]] == list(bi.PEAKS_31P)
    assert tuple(p["amplitude"] for p in conf["peaks"]) == bi.FIXED_AMPS_31P


def _fixture_entry(conf):
    return {"name": conf["name"], "source": conf["source"],
            "file": f"benchmark/configs/{conf['name']}.json",
            "reduced": conf["reduced"], "why": conf["deployment"][:200]}


@pytest.mark.parametrize("name", [c["name"] for c in MAN["configs"]] + ["fixture"])
def test_each_config_holds_to_its_own_source(name):
    if name == "fixture":
        conf = config_checks.fixture()
        config_checks.check_config(_fixture_entry(conf), conf)
        return
    entry, conf = next((e, c) for e, c in config_checks.manifest_configs(MAN, harness.ROOT)
                       if e["name"] == name)
    config_checks.check_config(entry, conf)


def _listed(tmp_path, conf):
    """``(manifest, [(entry, file's content)])`` of a copy of the manifest
    that lists ``conf`` as a configuration file of its own under
    ``tmp_path``."""
    entry = _fixture_entry(conf)
    man = json.loads(json.dumps(MAN))
    man["configs"].append(entry)
    for c in man["configs"][:-1]:
        path = tmp_path / c["file"]
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text((harness.ROOT / c["file"]).read_text())
    (tmp_path / entry["file"]).write_text(json.dumps(conf, indent=1))
    return man, config_checks.manifest_configs(man, tmp_path)


def _cut(grid, why="a quarter of the bench grid, as the card's memory would force"):
    conf = config_checks.fixture(grid)
    conf["reduced"] = ["grid"]
    conf["assumed"]["grid"] = why
    return conf


@pytest.mark.parametrize("grid", [None, (16, 16, 16)])
def test_a_manifest_that_lists_the_12_line_config_passes(tmp_path, grid):
    """The 12-line 7 T brain configuration written as a file of its own and
    listed in a copy of the manifest (at the bench grid, and cut to a
    quarter of it with ``grid`` in ``reduced``) passes the manifest's and
    every configuration's checks; ``BENCHMARK.json`` is not touched."""
    conf = config_checks.fixture() if grid is None else _cut(grid)
    man, listed = _listed(tmp_path, conf)
    _check_manifest(man)
    assert [e["name"] for e, _ in listed][-1] == "p31_brain7t"
    for e, c in listed:
        config_checks.check_config(e, c)


def _width_cut(key):
    conf = config_checks.fixture()
    conf["reduced"] = [key]
    conf["assumed"][key] = "cut"
    return conf


@pytest.mark.parametrize("conf, why", [
    (_cut((4, 4, 2), "4x4x2, a CPU-sized grid"), "under the floor"),
    (_cut((16, 16, 8)), "under the floor"),
    (_width_cut("n_time"), "not a cut of scale"),
    (_width_cut("peaks"), "not a cut of scale"),
    (_width_cut("prior_csv"), "not a cut of scale"),
    (_width_cut("zero_fill"), "not a cut of scale"),
    (_cut(None, ""), "no assumed entry"),
], ids=["toy_4x4x2", "eighth_grid", "n_time", "peaks", "prior_csv", "zero_fill",
        "grid_unexplained"])
def test_a_listed_config_that_cuts_a_width_or_to_a_toy_fails(tmp_path, conf, why):
    """The same file cut to a toy grid, cut in a width, or with a cut that
    ``assumed`` does not explain fails the configuration check, whatever
    its ``deployment`` says."""
    conf["deployment"] += "; " + " ".join(conf["reduced"])
    man, listed = _listed(tmp_path, conf)
    _check_manifest(man)
    for e, c in listed[:-1]:
        config_checks.check_config(e, c)
    with pytest.raises(AssertionError, match=why):
        config_checks.check_config(*listed[-1])
