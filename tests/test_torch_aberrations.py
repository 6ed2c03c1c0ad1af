"""Port parity: probe aberrations (pyslice_tpu_torch.physics.aberrations,
Probe.aberrate, MultisliceCalculator.setup(aberrations=)) against
pyslice_tpu's."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from pyslice_tpu.core.dtypes import DOUBLE as JDOUBLE, SINGLE as JSINGLE
from pyslice_tpu.physics import aberrations as jab
from pyslice_tpu.physics.probe import Probe as JProbe
from pyslice_tpu_torch.core.dtypes import DOUBLE, SINGLE
from pyslice_tpu_torch.physics import aberrations as tab
from pyslice_tpu_torch.physics.probe import Probe as TProbe

torch.set_num_threads(2)

XS = np.linspace(0.0, 12.0, 96, endpoint=False)
YS = np.linspace(0.0, 10.0, 80, endpoint=False)
KXS = np.fft.fftfreq(96, XS[1] - XS[0])
KYS = np.fft.fftfreq(80, YS[1] - YS[0])
LAM = 0.037

COEFFS = {
    "zero": {},
    "isotropic": dict(C1=40.0, C3=1.2e5, C5=3e7),
    "anisotropic": dict(C1=-20.0, A1=15.0, phi_A1=0.3, B2=300.0,
                        phi_B2=-0.8, A2=250.0, phi_A2=1.1, A3=2e4,
                        phi_A3=0.2),
}


def _rel(got, want):
    return np.abs(np.asarray(got) - np.asarray(want)).max() / \
        max(np.abs(np.asarray(want)).max(), 1e-300)


@pytest.mark.parametrize("name", list(COEFFS))
def test_chi_phase_equals_jax(name):
    kx, ky = np.broadcast_arrays(KXS[:, None], KYS[None, :])
    q2 = kx ** 2 + ky ** 2
    want = np.asarray(jab.chi_phase(q2, kx, ky, lam=LAM,
                                    ab=jab.Aberrations(**COEFFS[name])))
    ab = tab.Aberrations(**COEFFS[name])
    got_np = tab.chi_phase(q2, kx, ky, lam=LAM, ab=ab)
    got_t = tab.chi_phase(torch.from_numpy(q2), torch.from_numpy(kx),
                          torch.from_numpy(ky), lam=LAM, ab=ab)
    np.testing.assert_array_equal(got_np, want)
    assert _rel(got_t.numpy(), want) <= 1e-14


@pytest.mark.parametrize("name", list(COEFFS))
@pytest.mark.parametrize("prec", ["double", "single"])
def test_apply_aberrations_equals_jax(name, prec):
    tp, jp = (DOUBLE, JDOUBLE) if prec == "double" else (SINGLE, JSINGLE)
    rng = np.random.default_rng(3)
    arr = (rng.normal(size=(2, 96, 80))
           + 1j * rng.normal(size=(2, 96, 80))).astype(
               np.complex128 if prec == "double" else np.complex64)
    want = np.asarray(jab.apply_aberrations(
        jnp.asarray(arr), KXS, KYS, LAM, jab.Aberrations(**COEFFS[name]), jp))
    got = tab.apply_aberrations(torch.from_numpy(arr), KXS, KYS, LAM,
                                tab.Aberrations(**COEFFS[name]), tp)
    assert got.dtype == tp.complex
    assert _rel(got.numpy(), want) <= (1e-12 if prec == "double" else 2e-6)
    # |transfer| == 1: the norm is kept
    assert torch.sum(torch.abs(got) ** 2).item() == pytest.approx(
        float(np.sum(np.abs(arr) ** 2)), rel=1e-5)


def test_oblique_ksq_isotropic_only():
    ksq = (KXS[:, None] ** 2 + KYS[None, :] ** 2
           + 0.3 * KXS[:, None] * KYS[None, :])
    arr = np.ones((96, 80), np.complex128)
    ab = dict(C1=30.0, C3=5e4)
    want = np.asarray(jab.apply_aberrations(jnp.asarray(arr), KXS, KYS, LAM,
                                            jab.Aberrations(**ab), JDOUBLE,
                                            ksq=ksq))
    got = tab.apply_aberrations(torch.from_numpy(arr), KXS, KYS, LAM,
                                tab.Aberrations(**ab), DOUBLE, ksq=ksq)
    assert _rel(got.numpy(), want) <= 1e-12
    with pytest.raises(ValueError, match="anisotropic"):
        tab.apply_aberrations(torch.from_numpy(arr), KXS, KYS, LAM,
                              tab.Aberrations(A1=3.0), DOUBLE, ksq=ksq)


def test_probe_aberrate_equals_jax_and_defocus():
    tp = TProbe(XS, YS, 25.0, 100e3, precision=DOUBLE, device="cpu")
    jp = JProbe(XS, YS, 25.0, 100e3, precision=JDOUBLE)
    base = tp.array.clone()
    ab = COEFFS["anisotropic"]
    tp.aberrate(tab.Aberrations(**ab), C3=8e4)
    jp.aberrate(jab.Aberrations(**ab), C3=8e4)
    assert _rel(tp.to_cpu(), jp.to_cpu()) <= 1e-12
    # aberrate(C1=dz) is defocus(dz)
    a = TProbe(XS, YS, 25.0, 100e3, array=base, precision=DOUBLE,
               device="cpu")
    b = a.copy()
    a.aberrate(C1=35.0)
    b.defocus(35.0)
    assert _rel(a.to_cpu(), b.to_cpu()) <= 1e-12
    assert tab.Aberrations(C3=1e7).scherzer_defocus(LAM) == \
        jab.Aberrations(C3=1e7).scherzer_defocus(LAM)
    assert tab.Aberrations().is_zero() and not tab.Aberrations(
        B2=1.0).is_isotropic()


def test_calculator_setup_aberrations_equals_jax(tmp_path):
    from fixtures import hbn_thermal
    from pyslice_tpu.engine.calculator import MultisliceCalculator as JCalc
    from pyslice_tpu_torch import Trajectory
    from pyslice_tpu_torch.engine.calculator import MultisliceCalculator

    jtraj = hbn_thermal(n_frames=1)
    ttraj = Trajectory(atom_types=jtraj.atom_types, positions=jtraj.positions,
                       velocities=jtraj.velocities,
                       box_matrix=jtraj.box_matrix, timestep=jtraj.timestep)
    kw = dict(aperture=25.0, voltage_eV=100e3, sampling=0.2, defocus=10.0,
              use_cache=False, cache_root=str(tmp_path))
    ab = {"C3": 5e4, "A1": 8.0, "phi_A1": 0.5}
    tc = MultisliceCalculator(device="cpu", precision="double")
    tc.setup(ttraj, aberrations=ab, **kw)
    jc = JCalc(precision=JDOUBLE)
    jc.setup(jtraj, aberrations=ab, **kw)
    assert tc.aberrations == tab.Aberrations(**ab)
    assert _rel(tc.base_probe.to_cpu(), jc.base_probe.to_cpu()) <= 1e-12
    plain = MultisliceCalculator(device="cpu", precision="double")
    plain.setup(ttraj, **kw)
    assert plain.output_dir != tc.output_dir      # part of the cache key
