"""Port parity for the partial-coherence models (engine/coherence.py):
chromatic_stem and chromatic_diffraction on the port's configurations
against pyslice_tpu's, float64 to 1e-10 and complex64 to the 1e-6
residual, plus tests/test_coherence.py's behaviour tests mirrored on the
port."""

import numpy as np
import pytest
import torch

from pyslice_tpu.engine import coherence as jcoh

import pyslice_tpu_torch as tt
from pyslice_tpu_torch.core.constants import wavelength
from pyslice_tpu_torch.core.dtypes import DOUBLE, SINGLE
from pyslice_tpu_torch.engine import coherence as tcoh
from pyslice_tpu_torch.engine import smatrix as ts
from pyslice_tpu_torch.engine import thermal as tthermal

from fixtures import hbn_thermal
from oracle import residual
from test_torch_thermal import (_gen, _port_traj, jax_configs,  # noqa: F401
                                use_precision)

torch.set_num_threads(2)

STEM = dict(voltage_eV=100e3, aperture=30.0, sampling=0.25,
            slice_thickness=0.8, collection_angle=45.0)
DIFF = dict(voltage_eV=100e3, sampling=0.25, slice_thickness=0.8)


def _rel(got, want):
    return np.abs(got - want).max() / np.abs(want).max()


def test_host_models_equal_jax():
    rng = np.random.default_rng(3)
    img = rng.random((12, 9))
    np.testing.assert_array_equal(
        tcoh.source_size_blur(img, (0.3, 0.2), 0.9),
        jcoh.source_size_blur(img, (0.3, 0.2), 0.9))
    for delta, n, c in ((80.0, 9, -30.0), (0.0, 5, 12.0), (150.0, 1, 0.0)):
        for a, b in zip(tcoh.defocus_series(delta, n, c),
                        jcoh.defocus_series(delta, n, c)):
            np.testing.assert_array_equal(a, b)
    assert tcoh.defocus_spread(1.2e7, 0.3, 100e3) == \
        jcoh.defocus_spread(1.2e7, 0.3, 100e3)
    with pytest.raises(ValueError, match="at least one"):
        tcoh.defocus_series(10.0, n=0)


@pytest.mark.parametrize("precision", ["double", "single"])
def test_chromatic_stem_matches_jax(precision, use_precision, jax_configs):
    use_precision(precision)
    jtraj = hbn_thermal(n_frames=2, sigma=0.05, seed=5)
    traj = _port_traj(jtraj)
    pg = tt.probe_grid([1, 3], [1, 3], 3, 3)
    kw = dict(Cc=1.2e7, dE=1.0, n_nodes=3, n_configs=2, thermal_sigma=0.05,
              source_fwhm=1.5, defocus=-40.0,
              aberrations=tt.Aberrations(C3=2e6), **STEM)
    img, xs, ys = tcoh.chromatic_stem(traj, pg, generator=_gen(2),
                                      device="cpu", **kw)
    assert img.shape == (3, 3) and np.isfinite(img).all()
    jax_configs(tthermal.thermal_configs(traj, 2, 0.05, generator=_gen(2)))
    jimg, jxs, jys = jcoh.chromatic_stem(jtraj, pg, **kw)
    np.testing.assert_array_equal(xs, jxs)
    np.testing.assert_array_equal(ys, jys)
    if precision == "double":
        assert _rel(img, jimg) <= 1e-10
    else:
        assert residual(img, jimg) <= 1e-6


def test_chromatic_stem_smatrix_route(use_precision, jax_configs,
                                      monkeypatch):
    """Above the crossover every node goes through the S-matrix (the
    node's defocus imprinted on the basis); the image equals the direct
    route's and JAX's S-matrix image."""
    use_precision("double")
    jtraj = hbn_thermal(n_frames=2, sigma=0.05, seed=5)
    traj = _port_traj(jtraj)
    pg = tt.probe_grid([1, 3], [1, 3], 2, 2)
    kw = dict(Cc=1.2e7, dE=1.0, n_nodes=2, n_configs=2, thermal_sigma=0.05,
              **STEM)
    direct, _, _ = tcoh.chromatic_stem(traj, pg, generator=_gen(4),
                                       use_smatrix=False, device="cpu", **kw)
    routes = []
    real = tt.StreamingHAADF.__init__

    def spy(self, *a, **k):
        real(self, *a, **k)
        routes.append(self.use_smatrix)

    monkeypatch.setattr(tt.StreamingHAADF, "__init__", spy)
    monkeypatch.setattr(ts, "SMATRIX_MIN_PROBES", 4)
    sm, _, _ = tcoh.chromatic_stem(traj, pg, generator=_gen(4),
                                   device="cpu", **kw)
    assert routes == [True, True]
    assert _rel(sm, direct) <= 1e-10
    jax_configs(tthermal.thermal_configs(traj, 2, 0.05, generator=_gen(4)))
    jimg, _, _ = jcoh.chromatic_stem(jtraj, pg, use_smatrix=True, **kw)
    assert _rel(sm, jimg) <= 1e-10


@pytest.mark.parametrize("precision", ["double", "single"])
def test_chromatic_diffraction_matches_jax(precision, use_precision,
                                           jax_configs):
    use_precision(precision)
    jtraj = hbn_thermal(n_frames=2, sigma=0.05, seed=6)
    traj = _port_traj(jtraj)
    kw = dict(Cc=1.2e7, dE=0.8, n_nodes=3, n_configs=2, thermal_sigma=0.05,
              aperture=20.0, **DIFF)
    pat = tcoh.chromatic_diffraction(traj, generator=_gen(1), device="cpu",
                                     **kw)
    assert pat.ndim == 2 and np.isfinite(pat).all() and pat.sum() > 0
    jax_configs(tthermal.thermal_configs(traj, 2, 0.05, generator=_gen(1)))
    jpat = np.asarray(jcoh.chromatic_diffraction(jtraj, **kw))
    if precision == "double":
        assert _rel(pat, jpat) <= 1e-10
    else:
        assert residual(pat, jpat) <= 1e-6


# --- tests/test_coherence.py on the port ----------------------------------

def test_source_blur_conserves_and_spreads():
    img = np.zeros((64, 64))
    img[32, 32] = 1.0
    out = tcoh.source_size_blur(img, (0.2, 0.2), fwhm=1.0)
    assert abs(out.sum() - img.sum()) < 1e-12
    assert out[32, 32] < 1.0
    assert out[34, 32] > 0.0
    prof = out[:, 32]
    assert 3 <= np.sum(prof >= prof.max() / 2) <= 7
    np.testing.assert_array_equal(tcoh.source_size_blur(img, (0.2, 0.2), 0.0),
                                  img)
    with pytest.raises(ValueError, match="2-D"):
        tcoh.source_size_blur(np.zeros(5), (0.1, 0.1), 1.0)


def test_defocus_series_quadrature():
    delta = 80.0
    nodes, w = tcoh.defocus_series(delta, n=9, center=-30.0)
    assert abs(w.sum() - 1.0) < 1e-12
    assert abs((w * nodes).sum() + 30.0) < 1e-9
    var = (w * (nodes + 30.0) ** 2).sum()
    assert abs(var - delta ** 2 / 2) / (delta ** 2 / 2) < 1e-12
    n0, w0 = tcoh.defocus_series(0.0, n=5, center=12.0)
    assert n0.tolist() == [12.0] and w0.tolist() == [1.0]
    assert tcoh.defocus_spread(1.2e7, 0.3, 100e3) == pytest.approx(36.0)


def test_defocus_series_averages_probe_intensity():
    n = 64
    xs = np.linspace(0, n * 0.2, n, endpoint=False)
    base = tt.Probe(xs, xs, 25.0, 100e3, precision=SINGLE, device="cpu")
    nodes, w = tcoh.defocus_series(120.0, n=5)
    avg = np.zeros((n, n))
    for df, wi in zip(nodes, w):
        p = base.copy()
        if df:
            p.defocus(float(df))
        avg += wi * np.abs(p.to_cpu()) ** 2
    coh = np.abs(base.to_cpu()) ** 2
    assert abs(avg.sum() - coh.sum()) / coh.sum() < 1e-3
    assert avg.max() < coh.max()


def test_chromatic_envelope_matches_analytic():
    """The quadrature through Probe.defocus reproduces the analytic
    chromatic damping envelope exp(-(pi lam delta k^2)^2 / 4)."""
    n, d = 96, 0.25
    xs = np.linspace(0, n * d, n, endpoint=False)
    lam, delta = wavelength(100e3), 150.0
    base = tt.Probe(xs, xs, 20.0, 100e3, precision=DOUBLE, device="cpu")
    nodes, w = tcoh.defocus_series(delta, n=24)
    avg_k = np.zeros((n, n), complex)
    for df, wi in zip(nodes, w):
        p = base.copy()
        p.defocus(float(df))
        avg_k += wi * np.fft.fft2(p.to_cpu())
    base_k = np.fft.fft2(base.to_cpu())
    k = np.fft.fftfreq(n, d=d)
    ksq = k[:, None] ** 2 + k[None, :] ** 2
    inside = np.abs(base_k) > 0.5 * np.abs(base_k).max()
    got = np.abs(avg_k[inside]) / np.abs(base_k[inside])
    want = np.exp(-((np.pi * lam * delta * ksq[inside]) ** 2) / 4.0)
    sel = want > 1e-3
    assert np.abs(got[sel] - want[sel]).max() < 0.01


def test_chromatic_stem_one_call():
    """dE=0 is one node: the plain frozen-phonon facade; the chromatic
    series changes the image; the source blur conserves it."""
    traj = _port_traj(hbn_thermal(n_frames=2, sigma=0.05, seed=5))
    pg = tt.probe_grid([1, 3], [1, 3], 3, 3)
    img0, xs0, _ = tthermal.frozen_phonon_haadf(
        traj, pg, n_configs=3, sigma=0.05, generator=_gen(2),
        intensity=True, device="cpu", **STEM)
    kw = dict(Cc=1.2e7, n_nodes=5, n_configs=3, thermal_sigma=0.05,
              device="cpu", **STEM)
    img1, xs1, _ = tcoh.chromatic_stem(traj, pg, dE=0.0, generator=_gen(2),
                                       **kw)
    np.testing.assert_allclose(img1, img0, rtol=1e-10)
    np.testing.assert_array_equal(xs1, xs0)
    img2, _, _ = tcoh.chromatic_stem(traj, pg, dE=1.0, generator=_gen(2),
                                     **kw)
    assert not np.allclose(img2, img0, rtol=1e-6)
    img3, _, _ = tcoh.chromatic_stem(traj, pg, dE=1.0, generator=_gen(2),
                                     source_fwhm=1.5, **kw)
    assert abs(img3.sum() - img2.sum()) / abs(img2.sum()) < 1e-10
    assert not np.allclose(img3, img2)
    with pytest.raises(ValueError, match="2-D scan grid"):
        tcoh.chromatic_stem(traj, [(1.0, 1.0), (2.0, 1.0)], dE=1.0,
                            generator=_gen(2), source_fwhm=1.5, **kw)


def test_chromatic_diffraction_plane_wave_invariant():
    """aperture=0: a plane wave's intensity is defocus-invariant, so the
    chromatic average equals the single-defocus pattern."""
    traj = _port_traj(hbn_thermal(n_frames=2, sigma=0.05, seed=6))
    pat0 = tthermal.frozen_phonon_diffraction(
        traj, n_configs=2, sigma=0.05, generator=_gen(1), aperture=0.0,
        device="cpu", **DIFF)
    pat1 = tcoh.chromatic_diffraction(
        traj, Cc=1.2e7, dE=0.5, n_nodes=3, n_configs=2, thermal_sigma=0.05,
        generator=_gen(1), aperture=0.0, device="cpu", **DIFF)
    np.testing.assert_allclose(pat1, pat0, rtol=2e-3)
