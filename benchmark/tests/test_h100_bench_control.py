"""The control: the plain reference in the program's place, computed in
bfloat16 (the precision below the configurations' float32), fails the
comparison of every cell.  Here at a tiny size on the CPU; on the card at
the cells' own size by ``benchmark/control.py --mode control``."""

from __future__ import annotations

import pytest

from benchmark import control, harness

from conftest import all_cells, tiny_cell

CELLS = all_cells()


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cell):
    c = tiny_cell(cell)
    limits = c.workload["check"]["limits"]
    nums = control.control_readings(c, 2**31 + 41, device="cpu")
    assert set(nums) == set(limits)
    failed = [k for k, v in nums.items() if not v <= limits[k]]
    assert failed, nums


def test_the_control_reads_the_program_in_float64_as_sound():
    """The same code at float64 (the reference itself in the program's
    place) passes: what fails the control is its precision."""
    import torch

    c = tiny_cell("p31_grid.maps")
    limits = c.workload["check"]["limits"]
    nums = control.control_readings(c, 2**31 + 43, device="cpu", dtype=torch.float64)
    assert all(v <= limits[k] for k, v in nums.items()), nums
