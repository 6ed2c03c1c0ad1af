"""Port parity for the frozen-phonon facades (engine/thermal.py): the
port's configurations (drawn from a torch.Generator) fed to both packages'
frozen_phonon_haadf and frozen_phonon_diffraction, float64 to 1e-10 and
complex64 to the 1e-6 residual, plus tests/test_detectors.py's
TestFrozenPhonon mirrored on the port."""

import numpy as np
import pytest
import torch

import pyslice_tpu.core.dtypes as jdtypes
from pyslice_tpu.data.trajectory import Trajectory as JTrajectory
from pyslice_tpu.engine import thermal as jthermal

import pyslice_tpu_torch as tt
from pyslice_tpu_torch.core import dtypes as tdtypes
from pyslice_tpu_torch.engine import smatrix as ts
from pyslice_tpu_torch.engine import thermal as tthermal

from fixtures import hbn_thermal
from oracle import residual

torch.set_num_threads(2)

SAMPLING = 0.25
SLICE_T = 0.8
KW = dict(voltage_eV=100e3, sampling=SAMPLING, slice_thickness=SLICE_T)


def _port_traj(j):
    return tt.Trajectory(atom_types=j.atom_types, positions=j.positions,
                         velocities=j.velocities, box_matrix=j.box_matrix,
                         timestep=j.timestep)


def _jax_traj(t):
    return JTrajectory(atom_types=t.atom_types, positions=t.positions,
                       velocities=t.velocities, box_matrix=t.box_matrix,
                       timestep=t.timestep)


@pytest.fixture
def use_precision():
    """Run both packages' facades (which take the default precision) in a
    given precision, restored afterwards."""
    before = jdtypes.get_precision(), tdtypes.get_precision()

    def use(name):
        jdtypes.set_default_precision(name)
        tdtypes.set_default_precision(name)
    yield use
    jdtypes.set_default_precision(before[0])
    tdtypes.set_default_precision(before[1])


@pytest.fixture
def jax_configs(monkeypatch):
    """Make the JAX facades draw the port's configurations."""
    def use(configs):
        monkeypatch.setattr(jthermal, "thermal_configs",
                            lambda *a, **k: _jax_traj(configs))
    return use


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def test_thermal_configs():
    traj = _port_traj(hbn_thermal(n_frames=3, sigma=0.05))
    cfg = tthermal.thermal_configs(traj, 5, 0.08, generator=_gen(1))
    assert cfg.n_frames == 5
    d = cfg.positions - traj.get_mean_positions()[None]
    assert abs(d.mean()) < 0.05
    assert 0.04 < d.std() < 0.13              # gaussian by default
    again = tthermal.thermal_configs(traj, 5, 0.08, generator=_gen(1))
    np.testing.assert_array_equal(cfg.positions, again.positions)
    uni = tthermal.thermal_configs(traj, 5, 0.08, generator=_gen(1),
                                   distribution="uniform")
    du = uni.positions - traj.get_mean_positions()[None]
    assert du.min() >= 0.0 and du.max() < 0.08


@pytest.mark.parametrize("precision", ["double", "single"])
def test_frozen_phonon_haadf_matches_jax(precision, use_precision,
                                         jax_configs):
    use_precision(precision)
    jtraj = hbn_thermal(n_frames=2, sigma=0.05)
    traj = _port_traj(jtraj)
    pg = tt.probe_grid((1.0, 4.0), (1.0, 4.0), 2, 2)
    img, xs, ys = tthermal.frozen_phonon_haadf(
        traj, pg, n_configs=3, sigma=0.05, generator=_gen(2), aperture=25,
        device="cpu", **KW)
    assert img.shape == (2, 2) and len(xs) == 2 and len(ys) == 2
    assert np.all(np.isfinite(img)) and np.all(img >= 0)
    jax_configs(tthermal.thermal_configs(traj, 3, 0.05, generator=_gen(2)))
    jimg, jxs, jys = jthermal.frozen_phonon_haadf(
        jtraj, pg, n_configs=3, sigma=0.05, aperture=25, **KW)
    np.testing.assert_array_equal(xs, jxs)
    np.testing.assert_array_equal(ys, jys)
    if precision == "double":
        assert np.abs(img - jimg).max() / np.abs(jimg).max() <= 1e-10
    else:
        assert residual(img, np.asarray(jimg)) <= 1e-6


def test_frozen_phonon_haadf_smatrix_route(use_precision, jax_configs,
                                           monkeypatch):
    """Above the crossover each configuration goes through the S-matrix;
    the image equals the direct route's and JAX's."""
    use_precision("double")
    jtraj = hbn_thermal(n_frames=2, sigma=0.05)
    traj = _port_traj(jtraj)
    pg = tt.probe_grid((1.0, 4.0), (1.0, 4.0), 2, 2)
    kw = dict(n_configs=2, sigma=0.05, aperture=25, **KW)
    direct, _, _ = tthermal.frozen_phonon_haadf(
        traj, pg, generator=_gen(4), device="cpu", **kw)
    routes = []
    real = tt.StreamingHAADF.__init__

    def spy(self, *a, **k):
        real(self, *a, **k)
        routes.append(self.use_smatrix)

    monkeypatch.setattr(tt.StreamingHAADF, "__init__", spy)
    monkeypatch.setattr(ts, "SMATRIX_MIN_PROBES", 4)
    sm, _, _ = tthermal.frozen_phonon_haadf(
        traj, pg, generator=_gen(4), device="cpu", **kw)
    assert routes == [True]
    np.testing.assert_allclose(sm, direct, rtol=1e-10)
    jax_configs(tthermal.thermal_configs(traj, 2, 0.05, generator=_gen(4)))
    jimg, _, _ = jthermal.frozen_phonon_haadf(jtraj, pg, use_smatrix=True,
                                              **kw)
    assert np.abs(sm - jimg).max() / np.abs(jimg).max() <= 1e-10


@pytest.mark.parametrize("precision", ["double", "single"])
def test_frozen_phonon_diffraction_matches_jax(precision, use_precision):
    use_precision(precision)
    jtraj = hbn_thermal(n_frames=2, sigma=0.05)
    traj = _port_traj(jtraj)
    configs = tthermal.thermal_configs(traj, 3, 0.05, generator=_gen(3))
    patt = tthermal.frozen_phonon_diffraction(traj, configs=configs,
                                              device="cpu", **KW)
    assert patt.ndim == 2 and np.all(np.isfinite(patt)) and patt.sum() > 0
    assert patt.dtype == (np.float64 if precision == "double"
                          else np.float32)
    jpatt = jthermal.frozen_phonon_diffraction(
        jtraj, configs=_jax_traj(configs), **KW)
    if precision == "double":
        assert np.abs(patt - jpatt).max() / np.abs(jpatt).max() <= 1e-10
    else:
        assert residual(patt, np.asarray(jpatt)) <= 1e-6
    # drawn from a generator, the same seed gives the same pattern
    again = tthermal.frozen_phonon_diffraction(
        traj, n_configs=3, sigma=0.05, generator=_gen(3), device="cpu", **KW)
    np.testing.assert_array_equal(again, patt)
