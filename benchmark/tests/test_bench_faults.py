"""``correct`` against broken runs: the harness driven on the CPU at a
small size (its look for a card skipped), with the cell's own limits.

A sound run comes out correct; a run with the timed path broken
underneath, once for each fault the cell can have, and the control (the
reference in the precision below the configuration's, in the program's
place) come out not correct."""

import pytest

import harness
from conftest import BENCH, run_tiny, tiny_cell

FAULTS = BENCH / "tests" / "faults.py"
JOB_FAULTS = ["state_unchanged", "half_batch", "answer_altered"]
# (cell, traffic in place of its own): the sharded TACAW runs cell 1's
# traffic on a mesh of two CPU ranks, held to cell 1's limits
MESH = ("hbn_1023.stem16_tacaw", "stem16_tacaw_mesh4")
CASES = ([(("hbn_1023.stem16_tacaw", None), f) for f in JOB_FAULTS]
         + [(("hbn_1023.planewave_tacaw", None), f) for f in JOB_FAULTS]
         + [(("hbn_2048.stream64", None), f) for f in
            ("state_unchanged", "half_block", "fold_altered")]
         + [(MESH, f) for f in JOB_FAULTS + ["exchange_left_out"]])
CELLS = sorted({c for c, _ in CASES}, key=str)


@pytest.fixture(autouse=True)
def restore_program():
    """A one-card run patches this process: put back what faults.py
    replaces."""
    from pyslice_tpu_torch.engine import pipeline, streaming
    from pyslice_tpu_torch.parallel import sharded
    saved = [(pipeline, "multislice"), (pipeline, "frame_exit_waves"),
             (streaming, "fold"), (sharded, "all_to_all"),
             (streaming.StreamingTACAW, "_fold_frame")]
    saved = [(o, n, getattr(o, n)) for o, n in saved]
    yield
    for o, n, v in saved:
        setattr(o, n, v)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    res, lines = run_tiny(tiny_cell(*cell))
    assert res["correct"] is True, lines


@pytest.mark.parametrize("cell,fault", CASES)
def test_fault_is_not_correct(cell, fault):
    res, lines = run_tiny(tiny_cell(*cell), patch=f"{FAULTS}:{fault}")
    assert res["correct"] is False, lines


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    res, lines = run_tiny(tiny_cell(*cell), control=1)
    assert res["correct"] is False, lines


@pytest.mark.cuda
def test_a_sound_run_on_the_card_is_correct(cuda_card):
    cell = tiny_cell("hbn_1023.stem16_tacaw")
    opts = dict(seed=7, seconds=0.5, trace=0, control=0, device="cuda",
                patch=None)
    ranks = harness.run_ranks(cell, opts)
    res, lines = harness.result(cell, opts, ranks, 0.0,
                                harness.driver_module(cell))
    assert res["device"]["platform"] == "gpu"
    assert res["correct"] is True, lines
