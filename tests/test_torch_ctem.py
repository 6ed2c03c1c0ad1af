"""Port parity for HRTEM/CTEM image formation (engine/ctem.py): the
transfer function, images and focal series from one exit wave, and
hrtem_image on the port's configurations against pyslice_tpu's, float64
to 1e-10 and complex64 to the 1e-6 residual, plus tests/test_ctem.py's
behaviour tests mirrored on the port."""

import dataclasses

import numpy as np
import pytest
import torch

from pyslice_tpu.core.dtypes import DOUBLE as JDOUBLE, SINGLE as JSINGLE
from pyslice_tpu.engine import ctem as jctem
from pyslice_tpu.physics.aberrations import Aberrations as JAberrations

import pyslice_tpu_torch as tt
from pyslice_tpu_torch.core.constants import wavelength
from pyslice_tpu_torch.core.dtypes import DOUBLE, SINGLE
from pyslice_tpu_torch.engine import ctem as tctem
from pyslice_tpu_torch.engine import thermal as tthermal
from pyslice_tpu_torch.engine.coherence import defocus_series
from pyslice_tpu_torch.physics.aberrations import Aberrations

from fixtures import hbn_thermal
from oracle import residual
from test_torch_thermal import (_gen, _port_traj, jax_configs,  # noqa: F401
                                use_precision)

torch.set_num_threads(2)

LAM = wavelength(100e3)
AB = dict(C1=-500.0, C3=1.2e7, A1=30.0, phi_A1=0.4, B2=40.0, A2=20.0,
          A3=1e3, C5=1e9)


def _axes(nx=64, ny=48, d=0.2):
    xs = np.linspace(0, nx * d, nx, endpoint=False)
    ys = np.linspace(0, ny * d, ny, endpoint=False)
    return xs, ys, np.fft.fftfreq(nx, d), np.fft.fftfreq(ny, d)


def _wave(seed, shape=(64, 48)):
    rng = np.random.default_rng(seed)
    return rng.normal(size=shape) + 1j * rng.normal(size=shape)


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("case", ["open", "isotropic", "anisotropic",
                                  "aperture", "ksq"])
@pytest.mark.parametrize("precision", ["double", "single"])
def test_objective_transfer_equals_jax(case, precision):
    _, _, kxs, kys = _axes()
    coeffs = {"open": {}, "isotropic": dict(C1=-300.0, C3=1e7, C5=1e9),
              "anisotropic": AB, "aperture": dict(C1=80.0),
              "ksq": dict(C1=-300.0, C3=1e7)}[case]
    kw = dict(lam=LAM, aperture=12.0 if case == "aperture" else None,
              ksq=(kxs[:, None] ** 2 + kys[None, :] ** 2 if case == "ksq"
                   else None))
    got = tctem.objective_transfer(kxs, kys, ab=Aberrations(**coeffs),
                                   precision=precision, **kw)
    want = jctem.objective_transfer(kxs, kys, ab=JAberrations(**coeffs),
                                    precision=precision, **kw)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("space", ["real", "k", "k_shifted"])
def test_image_from_exit_wave_equals_jax(space):
    _, _, kxs, kys = _axes()
    psi = _wave(5)
    wave = {"real": psi, "k": np.fft.fft2(psi),
            "k_shifted": np.fft.fftshift(np.fft.fft2(psi))}[space]
    kw = dict(lam=LAM, aperture=25.0, input_space=space)
    got = tctem.image_from_exit_wave(wave, kxs, kys, ab=Aberrations(**AB),
                                     precision=DOUBLE, device="cpu", **kw)
    want = jctem.image_from_exit_wave(wave, kxs, kys, ab=JAberrations(**AB),
                                      precision=JDOUBLE, **kw)
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float64
    assert _rel(got, want) <= 1e-10
    # a batch broadcasts, and complex64 meets the residual bar
    batch = np.stack([wave, 0.5 * wave])
    got32 = tctem.image_from_exit_wave(batch, kxs, kys, ab=Aberrations(**AB),
                                       precision=SINGLE, device="cpu", **kw)
    want32 = jctem.image_from_exit_wave(batch, kxs, kys,
                                        ab=JAberrations(**AB),
                                        precision=JSINGLE, **kw)
    assert got32.dtype == torch.float32 and got32.shape == (2, 64, 48)
    assert residual(got32.numpy(), np.asarray(want32)) <= 1e-6


def test_focal_series_equals_jax():
    _, _, kxs, kys = _axes()
    psi = _wave(6)
    defoci = [-200.0, 0.0, 150.0, 400.0]
    kw = dict(lam=LAM, aperture=30.0)
    got = tctem.focal_series(psi, defoci, kxs, kys,
                             ab=Aberrations(C1=-50.0, C3=1e7),
                             precision=DOUBLE, device="cpu", **kw)
    want = jctem.focal_series(psi, defoci, kxs, kys,
                              ab=JAberrations(C1=-50.0, C3=1e7),
                              precision=JDOUBLE, **kw)
    assert tuple(got.shape) == (4, 64, 48)
    assert _rel(got, want) <= 1e-10


def test_tilt_series_equals_jax():
    for semi, n in ((0.0, 5), (2.0, 5), (0.5, 3), (7.0, 2)):
        for a, b in zip(tctem._tilt_series(semi, n, LAM),
                        jctem._tilt_series(semi, n, LAM)):
            np.testing.assert_array_equal(a, b)


HR = dict(sampling=0.25, slice_thickness=0.5, voltage_eV=100e3)


@pytest.mark.parametrize("case", ["chromatic_tilts", "coherent",
                                  "frames", "single"])
def test_hrtem_image_equals_jax(case, use_precision, jax_configs):
    use_precision("single" if case == "single" else "double")
    jtraj = hbn_thermal(n_frames=2, sigma=0.03, nx=2, ny=2)
    traj = _port_traj(jtraj)
    kw = dict(defocus=-300.0, objective_aperture=25.0, **HR)
    c3 = 0.0
    if case in ("chromatic_tilts", "single"):
        kw.update(Cc=1.0e7, dE=0.6, n_nodes=3, beam_semiangle=20.0,
                  n_tilts=3)
        c3 = 1e7
    n_configs = 0 if case == "frames" else 2
    img, xs, ys = tctem.hrtem_image(
        traj, n_configs=n_configs, thermal_sigma=0.03, generator=_gen(7),
        aberrations=Aberrations(C3=c3), device="cpu", **kw)
    assert img.shape == (len(xs), len(ys)) and np.isfinite(img).all()
    jax_configs(tthermal.thermal_configs(traj, 2, 0.03, generator=_gen(7)))
    jimg, jxs, jys = jctem.hrtem_image(
        jtraj, n_configs=n_configs, thermal_sigma=0.03,
        aberrations=JAberrations(C3=c3), **kw)
    np.testing.assert_array_equal(xs, jxs)
    np.testing.assert_array_equal(ys, jys)
    if case == "single":
        assert img.dtype == np.float32
        assert residual(img, jimg) <= 1e-6
    else:
        assert img.dtype == np.float64
        assert _rel(img, jimg) <= 1e-10


def test_tilted_waves_are_float64_phases():
    """The tilted plane waves come from a float64 phase cast once: they
    equal exp(2 pi i k.r) formed in NumPy float64 to the complex64
    rounding, not to the error of a float32 phase."""
    xs = np.arange(1023) * 0.1
    tilts = tctem.snapped_tilts(np.array([[0.0132, -0.027], [0.03, 0.01]]),
                                102.25, 102.25)
    got = tctem._tilted_waves(tilts, xs, xs, SINGLE, "cpu").numpy()
    want = np.exp(2j * np.pi * (tilts[:, 0, None, None] * xs[None, :, None]
                                + tilts[:, 1, None, None] * xs[None, None]))
    assert np.abs(got - want).max() <= 2e-7
    np.testing.assert_allclose(tilts * 102.25, np.round(tilts * 102.25),
                               atol=1e-12)


# --- tests/test_ctem.py on the port ---------------------------------------

class TestImageFormation:
    def test_identity_lens(self):
        _, _, kxs, kys = _axes()
        psi = _wave(0)
        img = tctem.image_from_exit_wave(psi, kxs, kys, lam=LAM,
                                         precision=DOUBLE, device="cpu")
        np.testing.assert_allclose(img.numpy(), np.abs(psi) ** 2, rtol=1e-10)

    def test_power_conserved_phase_only_ctf(self):
        _, _, kxs, kys = _axes()
        psi = _wave(1)
        ab = Aberrations(C1=-500.0, C3=1.2e7, A1=30.0, phi_A1=0.4)
        img = tctem.image_from_exit_wave(psi, kxs, kys, lam=LAM, ab=ab,
                                         precision=DOUBLE, device="cpu")
        np.testing.assert_allclose(float(img.sum()),
                                   (np.abs(psi) ** 2).sum(), rtol=1e-10)

    def test_input_spaces_agree(self):
        _, _, kxs, kys = _axes()
        psi = _wave(2)
        ab = Aberrations(C1=200.0)
        kw = np.fft.fft2(psi)
        run = lambda w, s: tctem.image_from_exit_wave(
            w, kxs, kys, lam=LAM, ab=ab, input_space=s, precision=DOUBLE,
            device="cpu").numpy()
        a = run(psi, "real")
        np.testing.assert_allclose(a, run(kw, "k"), rtol=1e-12)
        np.testing.assert_allclose(a, run(np.fft.fftshift(kw), "k_shifted"),
                                   rtol=1e-12)
        with pytest.raises(ValueError, match="input_space"):
            tctem.image_from_exit_wave(psi, kxs, kys, lam=LAM,
                                       input_space="bad", device="cpu")

    def test_objective_aperture_mask(self):
        _, _, kxs, kys = _axes()
        h = tctem.objective_transfer(kxs, kys, lam=LAM, aperture=10.0)
        q = np.sqrt(kxs[:, None] ** 2 + kys[None, :] ** 2)
        k_max = 10e-3 / LAM
        np.testing.assert_array_equal(np.abs(h) > 0.5, q <= k_max)
        assert np.all(np.abs(h[q <= k_max]) == 1.0)

    def test_weak_phase_contrast_and_chromatic_envelope(self):
        """Weak phase grating: the contrast at g is 2 eps sin(chi(g)); the
        chromatic series damps it by exp(-(pi lam delta g^2)^2 / 4)."""
        nx, ny, d = 128, 16, 0.2
        xs, _, kxs, kys = _axes(nx, ny, d)
        g = 10 / (nx * d)
        eps, df = 1e-3, -400.0
        psi = np.exp(1j * eps * np.cos(2 * np.pi * g * xs))[:, None] \
            * np.ones((1, ny))
        cos_basis = np.cos(2 * np.pi * g * xs)
        image = lambda c1: tctem.image_from_exit_wave(
            psi, kxs, kys, lam=LAM, ab=Aberrations(C1=c1),
            precision=DOUBLE, device="cpu").numpy()
        c_coh = 2.0 * (image(df).mean(axis=1) * cos_basis).mean()
        expect_coh = 2.0 * eps * np.sin(np.pi * LAM * df * g * g)
        np.testing.assert_allclose(c_coh, expect_coh, rtol=2e-3)
        delta = 150.0
        nodes, w = defocus_series(delta, n=21, center=0.0)
        avg = sum(wi * image(df + node) for node, wi in zip(nodes, w))
        c_chrom = 2.0 * (avg.mean(axis=1) * cos_basis).mean()
        expect_sum = 2.0 * eps * np.sum(
            w * np.sin(np.pi * LAM * (df + nodes) * g * g))
        np.testing.assert_allclose(c_chrom, expect_sum, rtol=5e-3)
        envelope = np.exp(-(np.pi * LAM * delta * g * g) ** 2 / 4.0)
        assert envelope < 0.9
        np.testing.assert_allclose(c_chrom, expect_coh * envelope, rtol=2e-2)


class TestTiltSeries:
    def test_degenerate(self):
        t, w = tctem._tilt_series(0.0, 5, LAM)
        np.testing.assert_array_equal(t, [[0.0, 0.0]])
        np.testing.assert_array_equal(w, [1.0])
        with pytest.raises(ValueError, match="n_tilts"):
            tctem._tilt_series(1.0, 1, LAM)

    def test_weights_and_symmetry(self):
        t, w = tctem._tilt_series(2.0, 5, LAM)
        assert t.shape == (25, 2) and w.shape == (25,)
        assert abs(w.sum() - 1.0) < 1e-12
        np.testing.assert_allclose((w[:, None] * t).sum(axis=0), 0.0,
                                   atol=1e-15)
        var = (w * t[:, 0] ** 2).sum()
        np.testing.assert_allclose(var, (2.0e-3 / LAM) ** 2 / 2, rtol=1e-10)


class TestHRTEM:
    @pytest.fixture()
    def traj(self):
        return _port_traj(hbn_thermal(n_frames=2, sigma=0.03, nx=2, ny=2))

    def _img(self, traj, **kw):
        return tctem.hrtem_image(traj, thermal_sigma=0.0, sampling=0.25,
                                 defocus=-300.0, generator=_gen(0),
                                 device="cpu", **kw)[0]

    def test_smoke_and_shape(self, traj):
        img, xs, ys = tctem.hrtem_image(
            traj, n_configs=2, thermal_sigma=0.03, sampling=0.25,
            defocus=-300.0, Cc=1.0e7, dE=0.5, n_nodes=3, generator=_gen(0),
            device="cpu")
        assert img.shape == (len(xs), len(ys))
        assert np.all(np.isfinite(img)) and img.min() >= 0
        assert img.std() > 1e-4 * img.mean()

    def test_coherent_limit_matches_manual_path(self, traj):
        """n_configs=0, no spread: the mean over frames of
        image_from_exit_wave(multislice exit wave)."""
        from pyslice_tpu_torch.engine.pipeline import (SimSpec,
                                                       frame_exit_waves)
        from pyslice_tpu_torch.physics.potential import make_plan
        ab = Aberrations(C1=-200.0, C3=1.0e7)
        img, _, _ = tctem.hrtem_image(traj, n_configs=0, sampling=0.25,
                                      aberrations=ab, objective_aperture=25.0,
                                      device="cpu")
        grid = tt.grid_from_trajectory(traj, sampling=0.25,
                                       slice_thickness=0.5)
        plan = make_plan(grid.xs, grid.ys, grid.zs, traj.positions,
                         traj.atom_types)
        spec = SimSpec.create(grid, plan, 100e3)
        waves = torch.ones((1, grid.nx, grid.ny),
                           dtype=spec.precision.complex)
        manual = np.zeros((grid.nx, grid.ny))
        for c in range(traj.n_frames):
            kw = frame_exit_waves(traj.positions[c], waves, spec)[0, ..., -1]
            manual += tctem.image_from_exit_wave(
                kw, plan.kxs, plan.kys, lam=LAM, ab=ab, aperture=25.0,
                input_space="k_shifted", precision=spec.precision).numpy()
        manual /= traj.n_frames
        np.testing.assert_allclose(img, manual, rtol=1e-5, atol=1e-8)

    def test_tilt_batch_runs_and_blurs(self, traj):
        sharp = self._img(traj, n_configs=1)
        soft = self._img(traj, n_configs=1, beam_semiangle=20.0, n_tilts=3)
        assert sharp.shape == soft.shape
        assert soft.std() <= sharp.std() * 1.01

    def test_tiny_tilt_collapses_to_coherent(self, traj):
        a = self._img(traj, n_configs=1)
        b = self._img(traj, n_configs=1, beam_semiangle=0.5, n_tilts=3)
        np.testing.assert_allclose(a, b, rtol=1e-6)

    def test_oblique_tilt_rejected(self, traj):
        box = np.array(traj.box_matrix)
        box[0, 1] = 1.0
        tri = dataclasses.replace(traj, box_matrix=box)
        with pytest.raises(ValueError, match="beam_semiangle=0"):
            tctem.hrtem_image(tri, n_configs=1, sampling=0.25,
                              beam_semiangle=1.0, n_tilts=3, device="cpu")
