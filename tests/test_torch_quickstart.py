"""Port parity, end to end, for the README quick start: a LAMMPS dump
through TrajectoryLoader, a plane wave (aperture=0.0) through
MultisliceCalculator at the reference-natural grid, then the TACAW
spectrum and diffraction, in both packages on the same file."""

import numpy as np
import pytest
import torch

import pyslice_tpu as jt
import pyslice_tpu_torch as tt
from pyslice_tpu_torch.io.lammps import write_lammps_dump

from fixtures import hbn_thermal
from oracle import residual

torch.set_num_threads(2)

SETUP = dict(aperture=0.0, voltage_eV=100e3, sampling=0.1,
             slice_thickness=0.5, use_cache=False)


def _rel(got, want):
    return np.abs(got - want).max() / np.abs(want).max()


def _wave(wf):
    w = wf.wavefunction_data
    return w.numpy() if isinstance(w, torch.Tensor) else np.asarray(w)


def _quick_start(tmp_path, precision, **extra):
    j = hbn_thermal(n_frames=4)
    dump = tmp_path / "md_dump.lammpstrj"
    write_lammps_dump(dump, np.where(j.atom_types == 5, 1, 2), j.positions,
                      j.velocities, j.box_matrix)
    mapping = {1: "B", 2: "N"}
    ttraj = tt.TrajectoryLoader(dump, timestep=0.005,
                                atom_mapping=mapping).load()
    jtraj = jt.TrajectoryLoader(dump, timestep=0.005, atom_mapping=mapping,
                                use_cache=False).load()
    tcalc = tt.MultisliceCalculator(device="cpu", precision=precision)
    tcalc.setup(ttraj, **SETUP, **extra)
    jcalc = jt.MultisliceCalculator(precision=precision)
    jcalc.setup(jtraj, **SETUP, **extra)
    return tcalc, tcalc.run(progress=False), jcalc.run(progress=False)


@pytest.mark.parametrize("precision", ["single", "double"])
@pytest.mark.parametrize("fast_grid", [False, True])
def test_plane_wave_quick_start_matches_jax(tmp_path, precision, fast_grid):
    tcalc, twf, jwf = _quick_start(tmp_path, precision, fast_grid=fast_grid)
    grid = (128, 128) if fast_grid else (51, 87)   # int(l / 0.1) + 1
    assert (tcalc.nx, tcalc.ny) == grid and tcalc.n_probes == 1
    tw, jw = _wave(twf), _wave(jwf)
    assert tw.shape == jw.shape == (1, 4) + grid + (1,)
    single = precision == "single"
    assert residual(tw, jw) <= (1e-6 if single else 1e-12)
    tol = 1e-4 if single else 1e-10
    ttac, jtac = tt.TACAWData(twf), jt.TACAWData(jwf)
    np.testing.assert_array_equal(ttac.frequencies, jtac.frequencies)
    spec, diff = ttac.spectrum(), ttac.diffraction()
    assert spec.shape == (4,) and diff.shape == grid
    assert np.isfinite(spec).all() and np.isfinite(diff).all()
    assert _rel(spec, jtac.spectrum()) <= tol
    assert _rel(diff, jtac.diffraction()) <= tol
