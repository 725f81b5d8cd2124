"""The fit reference: it refuses the priors it cannot judge, and it judges
the 12-line 7 T brain prior (K = 12, F = 48; ``config_checks.fixture``) on
a 4x4x2 grid of 1024 points on the CPU: its fit recovers the planted
lines, the comparison reads its own float64 fit as exact, and the
bfloat16 control fails the limits of ``p31_grid.maps``."""

from __future__ import annotations

import csv
import io
import json

import numpy as np
import pytest
import torch

from benchmark import control, harness
from benchmark.reference import check
from benchmark.reference import fit as rfit
from benchmark.traffic import generator

import config_checks
from conftest import tiny_cell

BENCH_CSV = harness.load_cell("p31_grid.maps").config["prior_csv"]
GRID = (4, 4, 2)
SIGMA = 0.01


def _edit(row_start: str, column: int, cell: str, after_bounds: bool) -> str:
    """The bench prior with cell ``column`` (0 = PCr) of the row named
    ``row_start`` above (or below) ``Bounds`` replaced by ``cell``."""
    lines = BENCH_CSV.splitlines()
    at = lines.index(next(s for s in lines if s.startswith("Bounds")))
    rows = range(at + 1, len(lines)) if after_bounds else range(1, at)
    i = next(i for i in rows if lines[i].startswith(row_start + ","))
    row = next(csv.reader(io.StringIO(lines[i])))
    row[1 + column] = cell
    out = io.StringIO()
    csv.writer(out, lineterminator="").writerow(row)
    lines[i] = out.getvalue()
    return "\n".join(lines) + "\n"


@pytest.mark.parametrize("text, column, cell", [
    (_edit("amplitude", 1, "0.5*PCr", False), "gATP", "0.5*PCr"),
    (_edit("phase", 2, "fixed", True), "aATP", "fixed"),
    (_edit("linewidth", 3, "(25.0, 25.0)", True), "bATP", "(25.0, 25.0)"),
    (_edit("g", 4, "(0, 1)", True), "Pi", "(0, 1)"),
    (_edit("g", 0, "0.3", False), "PCr", "0.3"),
    (BENCH_CSV.replace("\ng,fixed,fixed,fixed,fixed,fixed\n", "\n"), "PCr", ""),
], ids=["tie", "fixed_phase", "equal_bounds", "free_g", "g_fixed_off_0",
        "g_left_free"])
def test_the_reference_refuses_a_prior_it_cannot_judge(text, column, cell):
    with pytest.raises(ValueError) as err:
        rfit.parse_prior(text)
    msg = str(err.value)
    assert f"column {column!r}" in msg and f"cell {cell!r}" in msg, msg
    assert "untied Lorentzian priors (Eq. 6 with g = 0)" in msg


@pytest.mark.parametrize("text, row", [
    (BENCH_CSV + "Expressions,,,,,\namplitude,,x,,,\n", "Expressions"),
    (BENCH_CSV + "LessConstraints,,,,,\n", "LessConstraints"),
    (BENCH_CSV.replace("\nBounds,", "\nbounds,"), "bounds"),
], ids=["expressions", "less_constraints", "unknown_row"])
def test_the_reference_refuses_a_row_it_does_not_read(text, row):
    with pytest.raises(ValueError) as err:
        rfit.parse_prior(text)
    msg = str(err.value)
    assert f"row {row!r}" in msg and "untied Lorentzian priors" in msg, msg


def test_the_bench_prior_reads_as_before():
    """The bench prior's tensors, as the reference read it before it
    refused anything, value for value (float64, bit for bit)."""
    init, lower, upper = rfit.parse_prior(BENCH_CSV)
    inf = float("inf")
    assert torch.equal(init, torch.tensor(
        [[10.0, 0.0, 15.0, 0.0], [5.0, -2.5, 20.0, 0.0], [5.0, -7.5, 20.0, 0.0],
         [4.0, -16.1, 25.0, 0.0], [3.0, 4.8, 15.0, 0.0]], dtype=torch.float64))
    assert torch.equal(lower, torch.tensor(
        [[0.0, -0.5, 5.0, -180.0], [0.0, -3.0, 10.0, -180.0],
         [0.0, -8.0, 10.0, -180.0], [0.0, -16.6, 10.0, -180.0],
         [0.0, 4.3, 5.0, -180.0]], dtype=torch.float64))
    assert torch.equal(upper, torch.tensor(
        [[inf, 0.5, 30.0, 180.0], [inf, -2.0, 40.0, 180.0], [inf, -7.0, 40.0, 180.0],
         [inf, -15.6, 45.0, 180.0], [inf, 5.3, 30.0, 180.0]], dtype=torch.float64))


@pytest.fixture(scope="module")
def brain():
    """The 12-line configuration on the 4x4x2 grid at noise ``SIGMA``, one
    grid of it, the planted PCr amplitudes, and the reference's float64
    fit from its least-squares start."""
    conf = config_checks.fixture(GRID)
    seed = 2**31 + 71
    re, im = generator.fid_grid(conf, seed, "cpu", SIGMA / conf["noise_sigma"])
    lo, hi = conf["pcr_amplitude_range"]
    pcr = np.random.default_rng(seed).uniform(lo, hi, size=int(np.prod(GRID)))
    t = torch.as_tensor(generator.time_axis(conf))
    prior = rfit.parse_prior(conf["prior_csv"])
    x, c, conv = rfit.lm_fit(re, im, t, conf["mhz"], prior)
    return conf, re, im, pcr, t, x, c, conv


def test_the_reference_recovers_the_12_planted_lines(brain):
    conf, _, _, pcr, _, x, _, conv = brain
    assert x.shape == (int(np.prod(GRID)), 12, 4) and bool(conv.all())
    shifts = torch.tensor([p["shift_ppm"] for p in conf["peaks"]], dtype=torch.float64)
    assert float((x[..., 1] - shifts).abs().max()) < 1e-3
    amps = torch.tensor([[p["amplitude"] or 0.0 for p in conf["peaks"]]] * len(pcr),
                        dtype=torch.float64)
    k_pcr = [p["name"] for p in conf["peaks"]].index("PCr")
    amps[:, k_pcr] = torch.as_tensor(pcr)
    assert float(((x[..., 0] - amps) / amps).abs().max()) < 1e-2


def test_the_comparison_reads_the_references_own_fit_as_exact(brain):
    conf, re, im, _, t, x, c, conv = brain
    sds = rfit.crlb(x, re.double(), im.double(), t, conf["mhz"])
    rec = {"inputs": {"re": re, "im": im},
           "fit": {"x": x.numpy(), "cost": c.numpy(), "converged": conv.numpy(),
                   "sds": sds.numpy()}}
    params = dict(harness.load_cell("p31_grid.maps").workload["check"], sample_voxels=16)
    nums = check.judge(rec, conf, params, 2**31 + 73, 0)
    assert nums["fit_excess"] <= 1e-9 and nums["crlb_gap"] <= 1e-9, nums
    assert nums["cost_gap"] <= 1e-9 and nums["unconverged"] == 0.0, nums


def test_the_bfloat16_control_fails_the_maps_limits_at_12_lines():
    cell = tiny_cell("p31_grid.maps")
    cell.config = json.loads(json.dumps(config_checks.fixture(GRID)))
    limits = cell.workload["check"]["limits"]
    nums = control.control_readings(cell, 2**31 + 79, device="cpu")
    assert set(nums) == set(limits)
    failed = [k for k, v in nums.items() if not v <= limits[k]]
    assert failed, nums
