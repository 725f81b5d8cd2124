"""The comparison fails a broken timed path.  Each test skips the look
for a card, drives the rest of a run at a tiny size on the CPU with the
timed path broken underneath, and sees ``correct`` come out false: once
for each fault these cells can have (they run on one card, so there is no
exchange between chips to leave out)."""

from __future__ import annotations

import dataclasses

import pytest
import torch

from benchmark import harness
from benchmark import run as brun

from conftest import all_cells, tiny_cell

CELLS = all_cells()
FIT_CELLS = ["p31_grid.maps", "p31_kspace.maps"]


def _plain():
    from xmris_tpu_torch.ops.kernels import PLAIN

    return PLAIN


def _run(cell, kernels):
    return brun.run(tiny_cell(cell), 2**31 + 29, 1.5, False, device="cpu",
                    kernels=kernels)


def _failed_numbers(res):
    return sorted(k for k, c in res["checks"].items() if not c["value"] <= c["limit"])


@pytest.mark.parametrize("cell", FIT_CELLS)
def test_a_step_that_returns_its_state_unchanged(cell):
    """The LM's damped step returns zeros: every voxel keeps its seed."""
    k = _plain()
    stuck = dataclasses.replace(
        k, spd_solve_damped=lambda h, g, lam, *a, **kw: torch.zeros_like(g))
    res = _run(cell, stuck)
    assert not res["correct"], res["checks"]
    assert "fit_excess" in _failed_numbers(res)


@pytest.mark.parametrize("cell", CELLS)
def test_half_of_the_batch_left_out(cell):
    """The spectral kernel transforms the first half of the voxels only."""
    k = _plain()

    def half(xr, xi, n_out, *a, **kw):
        out = list(k.spectrum(xr, xi, n_out, *a, **kw))
        b = xr.shape[0]
        for j in range(2):
            out[j] = out[j].clone()
            out[j][b // 2:] = 0.0
        return tuple(out)

    res = _run(cell, dataclasses.replace(k, spectrum=half))
    assert not res["correct"], res["checks"]
    assert "spec_err" in _failed_numbers(res)


@pytest.mark.parametrize("cell", CELLS)
def test_an_answer_altered_where_it_is_produced(cell):
    """One voxel's spectrum is off by a thousandth of the grid's largest
    magnitude at one bin, as the kernel writes it."""
    k = _plain()

    def altered(xr, xi, n_out, *a, **kw):
        out = list(k.spectrum(xr, xi, n_out, *a, **kw))
        re = out[0].clone()
        flat = re.reshape(re.shape[0], -1)
        flat[1, 7] += 1e-3 * float(torch.sqrt(out[0] ** 2 + out[1] ** 2).max())
        out[0] = re
        return tuple(out)

    res = _run(cell, dataclasses.replace(k, spectrum=altered))
    assert not res["correct"], res["checks"]
    assert "spec_err" in _failed_numbers(res)


def test_a_phase_search_that_returns_its_start(monkeypatch):
    """The single-pivot search returns (45, 0) degrees without searching."""
    from xmris_tpu_torch.parallel import planar_pipeline

    def start(row_re, *a, **kw):
        p0 = torch.full((), 45.0, dtype=row_re.dtype, device=row_re.device)
        return p0, torch.zeros_like(p0)

    monkeypatch.setattr(planar_pipeline, "_solve_phase_on_row", start)
    res = _run("p31_grid.maps", _plain())
    assert not res["correct"], res["checks"]
    assert "acme_gap" in _failed_numbers(res)
