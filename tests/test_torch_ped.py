"""Port parity for precession electron diffraction (engine/ped.py):
precession_diffraction on the port's configurations against
pyslice_tpu's, float64 to 1e-10 and complex64 to the 1e-6 residual, plus
tests/test_ped.py's behaviour tests mirrored on the port."""

import numpy as np
import pytest
import torch

from pyslice_tpu.engine import ped as jped

from pyslice_tpu_torch.engine import ped as tped
from pyslice_tpu_torch.engine import thermal as tthermal

from fixtures import hbn_stack
from oracle import residual
from test_torch_thermal import (_gen, _port_traj, jax_configs,  # noqa: F401
                                use_precision)

torch.set_num_threads(2)

KW = dict(voltage_eV=100e3, sampling=0.35, slice_thickness=1.5)


@pytest.fixture(scope="module")
def jtraj():
    # three layers in separate slices: a tilt is a pure k-space phase, so
    # only a multi-slice (dynamical) specimen responds to precession
    return hbn_stack(3, 2, 2)


@pytest.fixture(scope="module")
def traj(jtraj):
    return _port_traj(jtraj)


def _ped(traj, mrad, n_az, **kw):
    return tped.precession_diffraction(traj, mrad, n_azimuth=n_az,
                                       n_configs=2, sigma=0.05,
                                       generator=_gen(3), device="cpu",
                                       **KW, **kw)


def _axial(traj):
    return tthermal.frozen_phonon_diffraction(
        traj, n_configs=2, sigma=0.05, generator=_gen(3), device="cpu", **KW)


def test_precession_tilts_equal_jax():
    for mrad, n in ((20.0, 8), (0.0, 12), (15.0, 1), (7.5, 5)):
        np.testing.assert_array_equal(tped.precession_tilts(mrad, n),
                                      jped.precession_tilts(mrad, n))


@pytest.mark.parametrize("precision", ["double", "single"])
def test_precession_diffraction_matches_jax(precision, jtraj, traj,
                                            use_precision, jax_configs):
    use_precision(precision)
    kw = dict(n_azimuth=4, n_configs=2, sigma=0.05, aperture=10.0, **KW)
    pat = tped.precession_diffraction(traj, 30.0, generator=_gen(5),
                                      device="cpu", **kw)
    assert pat.ndim == 2 and np.isfinite(pat).all()
    jax_configs(tthermal.thermal_configs(traj, 2, 0.05, generator=_gen(5)))
    jpat = np.asarray(jped.precession_diffraction(jtraj, 30.0, **kw))
    if precision == "double":
        assert np.abs(pat - jpat).max() / np.abs(jpat).max() <= 1e-10
    else:
        assert residual(pat, jpat) <= 1e-6


class TestTilts:
    def test_ring_geometry(self):
        t = tped.precession_tilts(20.0, 8)
        assert t.shape == (8, 2)
        np.testing.assert_allclose(np.hypot(t[:, 0], t[:, 1]), 20.0)
        np.testing.assert_allclose(t.mean(axis=0), 0.0, atol=1e-12)
        np.testing.assert_allclose(t[0], [20.0, 0.0])

    def test_degenerate_and_validation(self):
        np.testing.assert_array_equal(tped.precession_tilts(0.0, 12),
                                      [[0.0, 0.0]])
        with pytest.raises(ValueError, match=">= 0"):
            tped.precession_tilts(-1.0)
        with pytest.raises(ValueError, match="azimuth"):
            tped.precession_tilts(10.0, 0)


class TestPED:
    def test_zero_angle_is_axial(self, traj):
        np.testing.assert_allclose(_ped(traj, 0.0, 6), _axial(traj),
                                   rtol=1e-6)

    def test_matches_manual_azimuth_average(self, traj):
        n_az = 4
        want = np.mean([
            tthermal.frozen_phonon_diffraction(
                traj, n_configs=2, sigma=0.05, generator=_gen(3),
                tilt=(float(tx), float(ty)), device="cpu", **KW)
            for tx, ty in tped.precession_tilts(15.0, n_az)], axis=0)
        np.testing.assert_allclose(_ped(traj, 15.0, n_az), want, rtol=1e-6)
        # precession changes the dynamical pattern at a cone angle whose
        # interlayer advection is ~a pixel
        axial = _axial(traj)
        big = _ped(traj, 150.0, 3)
        assert np.abs(big - axial).max() / axial.max() > 1e-4

    def test_intensity_conserved(self, traj):
        """The tilted propagator is unitary, so the total diffracted
        intensity is tilt-independent."""
        assert np.sum(_ped(traj, 15.0, 3)) == pytest.approx(
            np.sum(_axial(traj)), rel=1e-6)
