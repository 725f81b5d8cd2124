"""The 12-line 7 T brain 31P configuration (``p31_brain7t_k12``) and its
cell ``p31_brain7t.maps``: the configuration is the test data's
(``data/p31_brain7t.json``) under its own name and holds to its source;
the program's two fit paths at K = 12, F = 48 (the fused grid program and
``fit_amares``, plain twins on the CPU) land within the cell's limits of
the float64 reference; the bfloat16 control fails on every seed; and the
roofline counts at F = 48 are the hand counts."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from benchmark import control, harness, roofline
from benchmark.reference import check
from benchmark.traffic import generator

import config_checks
from conftest import ROOT, tiny_cell

CELL = "p31_brain7t.maps"
CONFIG = "p31_brain7t_k12"


def test_the_config_is_the_test_data_under_its_own_name():
    man = harness.manifest()
    entry = next(c for c in man["configs"] if c["name"] == CONFIG)
    conf = json.loads((ROOT / entry["file"]).read_text())
    config_checks.check_config(entry, conf)
    data = config_checks.fixture()
    assert conf["source"] == data["source"] == entry["source"]
    assert conf["reduced"] == [] == entry["reduced"]
    for key in data:
        if key not in ("name", "deployment", "assumed"):
            assert conf[key] == data[key], key
    # The seven new lines' values are the benchmark's design values, said so.
    for key in ("new_line_widths", "new_line_amplitudes", "new_line_shift_bounds"):
        assert "not published" in conf["assumed"][key], key
    assert "NAD+ and NADH" in conf["assumed"]["nad"]
    cell = harness.load_cell(CELL)
    assert cell.chips == 1 and cell.config["name"] == CONFIG
    assert cell.workload["entry"] == "grid_maps"
    grid = harness.load_cell("p31_grid.maps")
    assert cell.mix == grid.mix and cell.workload["check"] == grid.workload["check"]
    assert {m["name"] for m in cell.per_layer} == {
        "normal_eq_roofline_pct.k12", "spd_solve_roofline_pct.k12",
        "spd_inverse_roofline_pct.k12", "lm_card_ms.k12", "crlb_card_ms.k12",
        "lm_iters_per_grid.k12"}


def _limits():
    return tiny_cell(CELL).workload["check"]["limits"]


def test_the_grid_program_is_within_the_limits_of_the_reference():
    """``process_grid_planar_raw`` at the cell's protocol on a 4x4x2 grid of
    the 12-line phantom (plain twins): the fit's numbers against the
    float64 reference within the cell's limits."""
    from benchmark.entries import grid_maps
    from xmris_tpu_torch.ops.kernels import PLAIN

    cell = tiny_cell(CELL)
    pool = generator.make_pool(cell.config, cell.mix, 2**31 + 101, "cpu")
    run = grid_maps.setup(harness.context(cell, "cpu", PLAIN, pool))
    out = grid_maps.request(run, pool[0])
    assert out["x_free"].shape == (32, 48)
    rec = grid_maps.record(pool[0], out)
    nums = check.judge(rec, cell.config, cell.workload["check"], 2**31 + 101, 0)
    limits = _limits()
    for name in ("fit_excess", "cost_gap", "crlb_gap", "unconverged"):
        assert nums[name] <= limits[name], (name, nums)


def test_fit_amares_is_within_the_limits_of_the_reference():
    """The public ``fit_amares`` (kernel engine, plain twins on the CPU) on
    a 4x4x2 grid of the 12-line phantom: its maps and CRLB % against the
    float64 reference within the cell's limits."""
    from xmris_tpu_torch.core.array import Coord, XmrArray
    from xmris_tpu_torch.fitting.amares import fit_amares
    from xmris_tpu_torch.fitting.prior import prior_from_csv_text

    cell = tiny_cell(CELL)
    cfg = cell.config
    re, im = generator.fid_grid(cfg, 2**31 + 103, "cpu")
    t = generator.time_axis(cfg)
    da = XmrArray(torch.complex(re, im).reshape(tuple(cfg["grid"]) + (-1,)),
                  dims=("x", "y", "z", "time"), coords={"time": Coord("time", t)},
                  attrs={"MHz": cfg["mhz"]})
    pk = prior_from_csv_text(cfg["prior_csv"], CONFIG)
    ds = fit_amares(da, pk, engine="pallas", device="cpu", return_curves=False)
    maps = ("amplitude", "chem_shift", "linewidth", "phase")
    x = np.stack([np.asarray(ds[n].values).reshape(-1, 12) for n in maps], -1)
    rec = {"inputs": {"re": re, "im": im},
           "fit": {"x": x, "converged": np.asarray(ds["fit_converged"].values).reshape(-1),
                   "crlb_pct": np.asarray(ds["crlb"].values).reshape(-1, 12)}}
    nums = check.judge(rec, cfg, cell.workload["check"], 2**31 + 103, 0)
    limits = _limits()
    for name in ("fit_excess", "crlb_gap", "unconverged"):
        assert nums[name] <= limits[name], (name, nums)


@pytest.mark.parametrize("seed", [2**31 + 201, 2**31 + 202, 2**31 + 203])
def test_the_bfloat16_control_fails_on_every_seed(seed):
    c = tiny_cell(CELL)
    limits = c.workload["check"]["limits"]
    nums = control.control_readings(c, seed, device="cpu")
    assert [k for k, v in nums.items() if not v <= limits[k]], nums


def test_roofline_counts_at_f48_are_the_hand_counts():
    """At K = 12, F = 48, 1024 samples a voxel, q_n = 1 (g fixed):

    * K2 a voxel: per sample 12 bases and the model (10 operations each),
      the residual and cost (6), 12 residual moments (a complex product, 6,
      and 2 powers of 2 accumulators, 8: 14 each) and 78 pair moments (6 +
      3 powers x 4 = 18 each): 126 + 168 + 1 404 = 1 698 operations, over
      1 024 samples 1 738 752; bytes 4 x (60 parameters + 2 x 1 024 FID
      + 48 dx/du + 1 cost + 48 g + 2 304 H) = 18 036, and the time axis
      once.  4.29x the bench prior's 396 operations a sample.
    * K3 a voxel: H's upper triangle (1 176), g (48), lam and the step
      (48) in, 4 x 1 273 = 5 092 bytes; 48^3 / 3 + 2 x 48^2 = 41 472
      operations.
    * K4 a voxel: 4 x (1 176 + 48) = 4 896 bytes; 2 x 48^3 / 3 = 73 728.
    """
    from xmris_tpu_torch.fitting.lm import hashable_pmap, normal_eq_plan
    from xmris_tpu_torch.fitting.prior import prior_from_csv_text

    conf = json.loads((ROOT / "benchmark" / "configs" / f"{CONFIG}.json").read_text())
    pk = prior_from_csv_text(conf["prior_csv"], CONFIG)
    plan = normal_eq_plan(hashable_pmap(pk.pmap), pk.n_free, conf["mhz"], True)
    b, n = 16384, 1024
    meta = dict(device="meta")
    args = (torch.empty((b, 60), **meta), torch.empty((b, n), **meta),
            torch.empty((b, n), **meta), torch.empty((n,), **meta),
            torch.empty((b, 48), **meta), plan)
    nbytes, flops = roofline.normal_equations_work(args, {})
    assert flops == b * 1_738_752
    assert nbytes == b * 18_036 + 4 * n
    g = torch.empty((b, 48), **meta)
    h = torch.empty((48 * 48, b), **meta)
    assert roofline.spd_solve_work((h, g, torch.empty((b,), **meta)), {}) == (
        b * 5_092, b * 41_472)
    assert roofline.spd_inverse_work((h,), {"tikhonov": 1e-12}) == (
        b * 4_896, b * 73_728)
    # All three are bound as at F = 20: K2 by its operations, K3/K4 by bytes.
    assert flops / roofline.PEAK_FP32_FLOPS > nbytes / roofline.PEAK_BYTES_PER_S
    ms = 1e3 * roofline.least_seconds(nbytes, flops)
    assert abs(ms - 0.4252) < 5e-4, ms
