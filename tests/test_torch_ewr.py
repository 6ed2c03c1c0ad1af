"""Port parity for focal-series exit-wave reconstruction (analysis/ewr.py):
iwfr_reconstruct against pyslice_tpu's on the same focal series, float64
to 1e-8 after a few iterations (the solvers' bar) and complex64 to the
1e-6 residual, plus tests/test_ewr.py's behaviour tests mirrored on the
port."""

import numpy as np
import pytest
import torch

from pyslice_tpu.analysis import ewr as jewr
from pyslice_tpu.core.dtypes import DOUBLE as JDOUBLE, SINGLE as JSINGLE
from pyslice_tpu.physics.aberrations import Aberrations as JAberrations

import pyslice_tpu_torch as tt
from pyslice_tpu_torch.analysis import ewr as tewr
from pyslice_tpu_torch.analysis.detectors import apply_shot_noise
from pyslice_tpu_torch.core.constants import wavelength
from pyslice_tpu_torch.core.dtypes import DOUBLE, SINGLE
from pyslice_tpu_torch.engine.ctem import focal_series
from pyslice_tpu_torch.physics.aberrations import Aberrations

from fixtures import hbn_thermal
from oracle import residual
from test_torch_thermal import _port_traj

torch.set_num_threads(2)

LAM = wavelength(100e3)
DEFOCI = np.array([-320.0, -160.0, 0.0, 160.0, 320.0, 480.0])


def _axes(nx=64, ny=48, d=0.25):
    return np.fft.fftfreq(nx, d), np.fft.fftfreq(ny, d)


def _smooth_wave(nx=64, ny=48, d=0.25, seed=0, phase_rms=0.4, amp_mod=0.15):
    """A band-limited complex wave: smooth phase and mild amplitude
    modulation around 1, as a thin specimen's exit wave."""
    rng = np.random.default_rng(seed)
    kxs, kys = _axes(nx, ny, d)
    env = np.exp(-(kxs[:, None] ** 2 + kys[None, :] ** 2) / (2 * 0.5 ** 2))

    def field(scale):
        f = rng.normal(size=(nx, ny)) + 1j * rng.normal(size=(nx, ny))
        r = np.real(np.fft.ifft2(np.fft.fft2(f) * env))
        return scale * r / r.std()

    return (1.0 + field(amp_mod)) * np.exp(1j * field(phase_rms))


def _align(rec, ref):
    """Remove the unobservable global phase."""
    return rec * np.exp(1j * np.angle(np.vdot(rec.ravel(), ref.ravel())))


def _series(psi, defoci=DEFOCI, precision=DOUBLE, **kw):
    kxs, kys = _axes()
    return focal_series(psi, defoci, kxs, kys, lam=LAM, precision=precision,
                        device="cpu", **kw).numpy()


def _iwfr(imgs, precision=DOUBLE, defoci=DEFOCI, **kw):
    kxs, kys = _axes()
    return tewr.iwfr_reconstruct(imgs, defoci, kxs, kys, lam=LAM,
                                 precision=precision, device="cpu", **kw)


@pytest.mark.parametrize("case", ["open", "aperture_ab", "init"])
def test_iwfr_equals_jax_f64(case):
    psi = _smooth_wave(seed=21)
    kw = {"open": {}, "init": dict(init=0.9 * psi + 0.1),
          "aperture_ab": dict(aperture=15.0)}[case]
    ab = (Aberrations(C1=-40.0, C3=0.5e7), JAberrations(C1=-40.0, C3=0.5e7)) \
        if case == "aperture_ab" else (None, None)
    imgs = _series(psi, ab=ab[0], aperture=kw.get("aperture"))
    kxs, kys = _axes()
    rec, errs = _iwfr(imgs, n_iters=6, ab=ab[0], **kw)
    jrec, jerrs = jewr.iwfr_reconstruct(imgs, DEFOCI, kxs, kys, lam=LAM,
                                        n_iters=6, ab=ab[1],
                                        precision=JDOUBLE, **kw)
    assert rec.dtype == np.complex128 and errs.shape == (6,)
    assert np.abs(rec - jrec).max() / np.abs(jrec).max() <= 1e-8
    assert np.abs(errs - jerrs).max() / np.abs(jerrs).max() <= 1e-8


def test_iwfr_complex64_residual():
    psi = _smooth_wave(seed=22)
    imgs = _series(psi).astype(np.float32)
    kxs, kys = _axes()
    rec, errs = _iwfr(imgs, precision=SINGLE, n_iters=10)
    jrec, jerrs = jewr.iwfr_reconstruct(imgs, DEFOCI, kxs, kys, lam=LAM,
                                        n_iters=10, precision=JSINGLE)
    assert rec.dtype == np.complex64 and errs.dtype == np.float32
    assert residual(rec, jrec) <= 1e-6
    assert residual(errs, jerrs) <= 1e-6


class TestIWFR:
    def test_noiseless_roundtrip(self):
        psi = _smooth_wave()
        rec, errs = _iwfr(_series(psi), n_iters=300)
        rel = np.linalg.norm(_align(rec, psi) - psi) / np.linalg.norm(psi)
        assert rel < 1e-3, rel
        assert errs.shape == (300,)
        assert errs[-1] < errs[0] * 1e-6
        assert errs[-1] < 1e-10

    def test_reconstruction_reproduces_the_data(self):
        psi = _smooth_wave(seed=3)
        ab = Aberrations(C3=0.5e7)
        imgs = _series(psi, ab=ab)
        rec, _ = _iwfr(imgs, ab=ab, n_iters=400)
        np.testing.assert_allclose(_series(rec, ab=ab), imgs, rtol=0,
                                   atol=1e-8)

    def test_multislice_exit_wave_roundtrip(self):
        """Recover the multislice exit wave of a thermal hBN cell from its
        simulated focal series."""
        from pyslice_tpu_torch.engine.pipeline import (SimSpec,
                                                       frame_exit_waves)
        from pyslice_tpu_torch.physics.potential import make_plan
        traj = _port_traj(hbn_thermal(n_frames=1, sigma=0.03, nx=2, ny=2))
        grid = tt.grid_from_trajectory(traj, sampling=0.25,
                                       slice_thickness=0.5)
        plan = make_plan(grid.xs, grid.ys, grid.zs, traj.positions,
                         traj.atom_types)
        spec = SimSpec.create(grid, plan, 100e3)
        waves = torch.ones((1, grid.nx, grid.ny),
                           dtype=spec.precision.complex)
        kw = frame_exit_waves(traj.positions[0], waves, spec)[0, ..., -1]
        psi = np.fft.ifft2(np.fft.ifftshift(kw.numpy()))
        imgs = focal_series(psi, DEFOCI, plan.kxs, plan.kys, lam=LAM,
                            precision=DOUBLE, device="cpu")
        rec, _ = tewr.iwfr_reconstruct(imgs, DEFOCI, plan.kxs, plan.kys,
                                       lam=LAM, n_iters=400,
                                       precision=DOUBLE, device="cpu")
        rel = np.linalg.norm(_align(rec, psi) - psi) / np.linalg.norm(psi)
        assert rel < 5e-3, rel

    def test_aperture_recovers_bandlimited_wave(self):
        psi = _smooth_wave(seed=5)
        kxs, kys = _axes()
        ap = 15.0
        rec, _ = _iwfr(_series(psi, aperture=ap), aperture=ap, n_iters=300)
        inside = (kxs[:, None] ** 2 + kys[None, :] ** 2) \
            <= (ap * 1e-3 / LAM) ** 2
        psi_bl_k = np.fft.fft2(psi) * inside
        rec_k = np.fft.fft2(_align(rec, np.fft.ifft2(psi_bl_k)))
        assert np.max(np.abs(rec_k[~inside])) < 1e-8
        rel = np.linalg.norm(rec_k[inside] - psi_bl_k[inside]) \
            / np.linalg.norm(psi_bl_k[inside])
        assert rel < 2e-2, rel

    def test_finite_dose_degrades_gracefully(self):
        psi = _smooth_wave(seed=13)
        counts = apply_shot_noise(_series(psi), dose=2e4, pixel_area=0.0625,
                                  generator=torch.Generator().manual_seed(1))
        noisy = np.maximum(np.asarray(counts, np.float64), 0.0) \
            / (2e4 * 0.0625)
        rec, errs = _iwfr(noisy, n_iters=200)
        rel = np.linalg.norm(_align(rec, psi) - psi) / np.linalg.norm(psi)
        assert rel < 0.1, rel
        assert np.isfinite(errs).all() and errs[-1] < errs[0]

    def test_custom_init_and_validation(self):
        psi = _smooth_wave(seed=7)
        imgs = _series(psi)
        _, errs = _iwfr(imgs, n_iters=2, init=psi)
        assert errs[0] < 1e-12
        _, errs_t = _iwfr(torch.from_numpy(imgs), n_iters=2,
                          init=torch.from_numpy(psi))
        np.testing.assert_array_equal(errs_t, errs)
        with pytest.raises(ValueError, match="defoci"):
            _iwfr(imgs, defoci=DEFOCI[:-1])
        with pytest.raises(ValueError, match="n_planes"):
            _iwfr(imgs[0])
        with pytest.raises(ValueError, match=">= 0"):
            _iwfr(-imgs)
        with pytest.raises(ValueError, match="init shape"):
            _iwfr(imgs, init=psi[:-1])


class TestFocalSeries:
    def test_matches_single_plane_images(self):
        from pyslice_tpu_torch.engine.ctem import image_from_exit_wave
        psi = _smooth_wave(seed=9)
        kxs, kys = _axes()
        stack = _series(psi, ab=Aberrations(C1=-100.0, C3=1.0e7))
        for i, d in enumerate(DEFOCI):
            one = image_from_exit_wave(
                psi, kxs, kys, lam=LAM,
                ab=Aberrations(C1=-100.0 + d, C3=1.0e7), precision=DOUBLE,
                device="cpu").numpy()
            np.testing.assert_allclose(stack[i], one, rtol=1e-10)

    def test_input_space_and_shape_validation(self):
        psi = _smooth_wave(seed=11)
        kxs, kys = _axes()
        a = _series(psi, defoci=[0.0, 100.0])
        b = focal_series(np.fft.fft2(psi), [0.0, 100.0], kxs, kys, lam=LAM,
                         input_space="k", precision=DOUBLE,
                         device="cpu").numpy()
        np.testing.assert_allclose(a, b, rtol=1e-10)
        with pytest.raises(ValueError, match="input_space"):
            focal_series(psi, [0.0], kxs, kys, lam=LAM, input_space="bad",
                         device="cpu")
        with pytest.raises(ValueError, match="2-D"):
            focal_series(psi[None], [0.0], kxs, kys, lam=LAM, device="cpu")
