"""The fast-grid cell, ``hbn_1024.stem16_tacaw_fast_grid``, cut to a
12.65 A box (127 points a side snapped to 128), 2 x 2 probes and 4 frames
a job, held to its own limits: a sound run is correct, traced or not; a
run with the job broken underneath, once for each fault the cell can
have, and the control are not; a job run without ``fast_grid`` raises on
its grid. The driver, the reference and the program load no JAX."""

import subprocess
import sys

import numpy as np
import pytest

from conftest import BENCH, ROOT, run_tiny, tiny_cell

CELL = "hbn_1024.stem16_tacaw_fast_grid"
FAULTS = BENCH / "tests" / "faults_fast_grid.py"
BOX = 12.65                         # int(126.5) + 1 = 127 -> 128


@pytest.fixture(autouse=True)
def restore_program():
    """A one-card run patches this process: put back what
    faults_fast_grid.py replaces."""
    from pyslice_tpu_torch.core.grids import Grid
    from pyslice_tpu_torch.engine import calculator
    saved = [(calculator, "grid_from_trajectory"),
             (calculator, "simulate_frames_into"),
             (Grid, "kxs_nominal_shifted"), (Grid, "kys_nominal_shifted")]
    saved = [(o, n, getattr(o, n)) for o, n in saved]
    yield
    for o, n, v in saved:
        setattr(o, n, v)


def fast_tiny():
    cell = tiny_cell(CELL)
    cell.config["box_A"] = BOX
    cell.traffic["frames_per_job"] = 4
    return cell


def test_cell_files_are_found_and_give_its_shape():
    from harness import driver_module, load_cell
    cell = load_cell(CELL)
    assert cell.chips == 1 and cell.config["fast_grid"] is True
    assert cell.traffic["driver"] == "tacaw_job_fast_grid"
    assert set(cell.limits) == {"spectrum", "diffraction", "k_axes"}
    mod = driver_module(cell)
    assert mod.slice_loop_shape(cell) == (16, 1024, 1024, 14)
    assert tuple(cell.config["grid"]) == (1024, 1024, 14)
    assert mod.slice_loop_shape(fast_tiny()) == (4, 128, 128, 14)


def test_reference_grid_follows_the_published_rule():
    from reference import plain
    from reference.fast_grid import FastGrid, snapped
    g = FastGrid(102.25, 102.25, 6.784, 0.1, 0.5)
    assert (g.nx, g.ny, g.nz) == (1024, 1024, 14)
    assert g.dx == 102.25 / 1024
    np.testing.assert_array_equal(g.kx(), np.fft.fftfreq(1024, 102.25 / 1024))
    assert plain.Grid(102.25, 102.25, 6.784, 0.1, 0.5).nx == 1023
    assert [snapped(l, 0.1) for l in (12.65, 12.75, 12.85, 25.55)] \
        == [128, 128, 256, 256]
    # the detector's |k| on the snapped pitch, not on fftfreq(n, sampling)
    q = g.nominal_q()
    kx = np.fft.fftshift(np.fft.fftfreq(1024, 102.25 / 1024))
    np.testing.assert_allclose(q[:, 512], np.abs(kx), rtol=0, atol=0)


def test_sound_run_is_correct():
    res, lines = run_tiny(fast_tiny())
    assert res["correct"] is True, lines
    assert res["checks"]["k_axes"]["value"] < 1e-15, lines


def test_traced_run_is_correct_and_counts_one_loop_a_frame(capsys):
    res, lines = run_tiny(fast_tiny(), trace=1)
    assert res["correct"] is True, lines
    assert "multislice_roofline_pct" in res["metrics"]
    err = capsys.readouterr().err
    said = [line for line in err.splitlines()
            if line.startswith("fast grid:")]
    assert said and "'plain': 1.0" in said[-1], err


def test_frame_one_percent_high_is_not_correct():
    res, lines = run_tiny(fast_tiny(), patch=f"{FAULTS}:one_frame_high")
    assert res["correct"] is False, lines


def test_k_axes_at_the_requested_pitch_are_not_correct():
    res, lines = run_tiny(fast_tiny(),
                          patch=f"{FAULTS}:k_axes_at_requested_sampling")
    assert res["correct"] is False, lines
    # 128 points at 0.1 A against 128 at 12.65/128 A: 1 - 12.65/12.8
    assert res["checks"]["k_axes"]["value"] == pytest.approx(
        1 - BOX / 12.8, rel=1e-9), lines


def test_job_without_fast_grid_raises_on_its_grid():
    with pytest.raises(RuntimeError, match="127 x 127 x 14 is not the "
                                           "reference's 128 x 128 x 14"):
        run_tiny(fast_tiny(), patch=f"{FAULTS}:grid_not_snapped")


def test_control_is_not_correct():
    res, lines = run_tiny(fast_tiny(), control=1)
    assert res["correct"] is False, lines
    # float32 axes: a few float32 roundings off the float64 ones
    assert 1e-9 < res["checks"]["k_axes"]["value"] < 1e-6, lines


def test_a_program_without_the_family_counter_reads_none(monkeypatch):
    """The parent commit has no ``pipeline.families``: the driver's
    counters and its launch line read nothing there, and raise nothing."""
    from harness import driver_module
    from pyslice_tpu_torch.engine import pipeline
    mod = driver_module(fast_tiny())
    assert set(mod._families()) == {"resident", "aligned", "odd_resident",
                                    "odd", "plain"}
    monkeypatch.delattr(pipeline, "families")
    assert mod._families() == {}


LOADS = r"""
import sys
sys.path[:0] = [sys.argv[1], sys.argv[2]]
import harness
mod = harness.driver_module(harness.load_cell(sys.argv[3]))
import reference.fast_grid
import pyslice_tpu_torch.engine.calculator
print(harness.forbidden_modules())
"""


def test_driver_reference_and_program_load_no_jax():
    out = subprocess.run([sys.executable, "-c", LOADS, str(BENCH),
                          str(ROOT), CELL], capture_output=True, text=True,
                         check=True, cwd=ROOT).stdout
    assert out.strip().splitlines()[-1] == "[]"
