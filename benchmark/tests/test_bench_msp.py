"""The multislice-ptychography cell, ``hbn_1023_msp.msp_b16_m4``, cut by
``conftest.tiny_cell`` to 4 scan positions at 128^2 (so a minibatch of 4
patterns x 4 probe modes), held to its own limits: a sound run is
correct, traced or not; a run with the step broken underneath, once for
each fault the cell can have, and the control are not; a frozen position
update is caught at this size, where complex64 determines the positions'
step. The driver, the reference and the program load no JAX."""

import json
import subprocess
import sys

import pytest

from conftest import BENCH, ROOT, run_tiny, tiny_cell

CELL = "hbn_1023_msp.msp_b16_m4"
FAULTS = BENCH / "tests" / "faults_msp.py"


@pytest.fixture(autouse=True)
def restore_program():
    """A one-card run patches this process: put back what faults_msp.py
    replaces."""
    from pyslice_tpu_torch.analysis import ptychography
    from pyslice_tpu_torch.physics import adjoint
    saved = [(ptychography._MspRun, "step"), (ptychography, "_msp_loss"),
             (ptychography, "_detector_amplitudes"),
             (ptychography, "_amplitudes_torch"), (adjoint, "_backward")]
    saved = [(o, n, getattr(o, n)) for o, n in saved]
    yield
    for o, n, v in saved:
        setattr(o, n, v)


def test_tiny_cell_and_its_shape():
    cell = tiny_cell(CELL)
    assert cell.chips == 1 and cell.traffic["driver"] == "msp_step"
    assert set(cell.limits) == {"grad_v", "grad_modes", "update_v",
                                "update_modes"}
    from harness import driver_module
    assert driver_module(cell).slice_loop_shape(cell) == (12, 128, 128, 14)


def test_sound_run_is_correct():
    res, lines = run_tiny(tiny_cell(CELL))
    assert res["correct"] is True, lines
    assert res["attempted"] >= tiny_cell(CELL).traffic["check_steps"]


def test_traced_run_is_correct_and_attributes_the_inverse_layer():
    res, lines = run_tiny(tiny_cell(CELL), trace=1)
    assert res["correct"] is True, lines
    layers = next(json.loads(line.split(": ", 1)[1]) for line in lines
                  if line.startswith("layer device seconds"))
    assert layers.get("inverse", 0.0) > 0.0, layers


@pytest.mark.parametrize("fault", ["update_not_applied", "half_minibatch",
                                   "last_mode_dropped",
                                   "adjoint_v_grad_high",
                                   "amplitudes_not_rooted"])
def test_fault_is_not_correct(fault):
    res, lines = run_tiny(tiny_cell(CELL), patch=f"{FAULTS}:{fault}")
    assert res["correct"] is False, lines


# At 128^2 complex64 determines the positions' step (the sound run's
# update_pos 2.1e-5 - 4.2e-4 over 10 seeds on the CPU, the control's 0.71 -
# 1.59), so a limit by the cell's rule, lower^(1/3) upper^(2/3), holds it
# here; at the cell's 1023^2 it does not (the plain reference in complex64
# reads as far from float64 as the program), and the cell only reads it.
TINY_POS_LIMIT = 0.06


@pytest.mark.parametrize("fault,correct", [(None, True),
                                           ("positions_not_updated", False)])
def test_positions_are_held_where_complex64_determines_them(fault, correct):
    cell = tiny_cell(CELL)
    cell.limits = dict(cell.limits, update_pos=TINY_POS_LIMIT)
    res, lines = run_tiny(cell, patch=fault and f"{FAULTS}:{fault}")
    assert res["correct"] is correct, lines


def test_control_is_not_correct():
    res, lines = run_tiny(tiny_cell(CELL), control=1)
    assert res["correct"] is False, lines


LOADS = r"""
import sys
sys.path[:0] = [sys.argv[1], sys.argv[2]]
import harness
mod = harness.driver_module(harness.load_cell(sys.argv[3]))
import reference.msp
import pyslice_tpu_torch.analysis.ptychography
print(harness.forbidden_modules())
"""


def test_driver_reference_and_program_load_no_jax():
    out = subprocess.run([sys.executable, "-c", LOADS, str(BENCH),
                          str(ROOT), CELL], capture_output=True, text=True,
                         check=True, cwd=ROOT).stdout
    assert out.strip().splitlines()[-1] == "[]"
