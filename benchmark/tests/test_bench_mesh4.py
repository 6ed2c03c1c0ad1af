"""The four-card sharded TACAW cell, ``hbn_1023_mesh4.stem16_tacaw_mesh4``,
cut by ``conftest.tiny_cell`` to two CPU ranks on a (frame 2, probe 1)
mesh, held to its own limits: a sound run is correct; a run with the
timed path broken underneath, once for each fault the cell can have, and
the control are not."""

import pytest

from conftest import BENCH, run_tiny, tiny_cell

CELL = "hbn_1023_mesh4.stem16_tacaw_mesh4"
FAULTS = BENCH / "tests" / "faults.py"


def test_cell_runs_on_two_ranks():
    cell = tiny_cell(CELL)
    assert cell.chips == 2 and cell.traffic["mesh"] == [2, 1]
    assert set(cell.limits) == {"spectrum", "diffraction"}


def test_sound_run_is_correct():
    res, lines = run_tiny(tiny_cell(CELL))
    assert res["correct"] is True, lines


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch",
                                   "answer_altered", "exchange_left_out"])
def test_fault_is_not_correct(fault):
    res, lines = run_tiny(tiny_cell(CELL), patch=f"{FAULTS}:{fault}")
    assert res["correct"] is False, lines


def test_control_is_not_correct():
    res, lines = run_tiny(tiny_cell(CELL), control=1)
    assert res["correct"] is False, lines
