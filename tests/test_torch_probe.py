"""Port parity: probe construction, defocus and shifting of
pyslice_tpu_torch against pyslice_tpu (JAX on the CPU, x64)."""

import contextlib

import numpy as np
import pytest
import torch

from pyslice_tpu.core.dtypes import DOUBLE as JDOUBLE, SINGLE as JSINGLE
from pyslice_tpu.physics import probe as jprobe
from pyslice_tpu_torch.core.dtypes import DOUBLE, SINGLE
from pyslice_tpu_torch.physics import probe as tprobe

from oracle import oracle_probe, oracle_shift

torch.set_num_threads(2)

XS = np.linspace(0.0, 12.0, 96, endpoint=False)
YS = np.linspace(0.0, 10.0, 80, endpoint=False)
KXS = np.fft.fftfreq(96, XS[1] - XS[0])
KYS = np.fft.fftfreq(80, YS[1] - YS[0])


def _rel(got, want):
    return np.abs(np.asarray(got) - np.asarray(want)).max() / \
        np.abs(np.asarray(want)).max()


@pytest.mark.parametrize("mrad", [0.0, 5.0, 30.0])
@pytest.mark.parametrize("prec", ["double", "single"])
def test_probe_array_equals_jax(mrad, prec):
    tp, jp = (DOUBLE, JDOUBLE) if prec == "double" else (SINGLE, JSINGLE)
    got = tprobe.probe_array(XS, YS, mrad, 100e3, tp, device="cpu")
    want = np.asarray(jprobe.probe_array(XS, YS, mrad, 100e3, jp))
    assert got.dtype == tp.complex and got.shape == (96, 80)
    assert _rel(got.numpy(), want) <= (1e-12 if prec == "double" else 1e-6)
    np.testing.assert_allclose(got.numpy(), oracle_probe(XS, YS, mrad, 100e3),
                               atol=1e-6 * np.abs(want).max())


def test_shift_probes_equals_jax_and_oracle():
    base = tprobe.probe_array(XS, YS, 20.0, 100e3, DOUBLE, device="cpu")
    pos = tprobe.probe_grid([1.0, 9.0], [2.0, 7.0], 3, 2)
    got = tprobe.shift_probes(base, KXS, KYS, pos, DOUBLE).numpy()
    want = np.asarray(jprobe.shift_probes(base.numpy(), KXS, KYS, pos,
                                          JDOUBLE))
    assert got.shape == (6, 96, 80)
    assert _rel(got, want) <= 1e-12
    assert _rel(got, oracle_shift(base.numpy(), KXS, KYS, pos)) <= 1e-12


def test_shift_probes_oblique_equals_jax():
    cell = np.array([[12.0, 3.0], [0.0, 10.0]])
    base = tprobe.probe_array(XS, YS, 20.0, 100e3, DOUBLE, device="cpu")
    pos = np.array([[1.0, 2.0], [4.5, 3.25]])
    got = tprobe.shift_probes(base, KXS, KYS, pos, DOUBLE, cell2d=cell)
    want = jprobe.shift_probes(base.numpy(), KXS, KYS, pos, JDOUBLE,
                               cell2d=cell)
    assert _rel(got.numpy(), want) <= 1e-12


def test_probe_grid_equals_jax():
    np.testing.assert_array_equal(tprobe.probe_grid([10, 90], [10, 90], 4, 4),
                                  jprobe.probe_grid([10, 90], [10, 90], 4, 4))


@pytest.mark.parametrize("dz", [25.0, -25.0])
@pytest.mark.parametrize("compat", [False, True])
def test_defocus_equals_jax(dz, compat):
    base = tprobe.probe_array(XS, YS, 20.0, 100e3, DOUBLE, device="cpu")
    lam = 0.037
    warns = (pytest.warns(UserWarning) if dz < 0 and not compat
             else contextlib.nullcontext())
    with warns:
        got = tprobe.defocus(base, KXS, KYS, lam, dz, DOUBLE,
                             compat_reference=compat).numpy()
    want = np.asarray(jprobe.defocus(base.numpy(), KXS, KYS, lam, dz,
                                     JDOUBLE, compat_reference=compat))
    assert _rel(got, want) <= 1e-12
    if dz < 0 and not compat:          # back-propagation inverts +dz
        fwd = tprobe.defocus(torch.as_tensor(got), KXS, KYS, lam, -dz,
                             DOUBLE).numpy()
        assert _rel(fwd, base.numpy()) <= 1e-12


def test_probe_class_and_batch_equal_jax():
    tp = tprobe.Probe(XS, YS, 15.0, 80e3, precision=DOUBLE, device="cpu")
    jp = jprobe.Probe(XS, YS, 15.0, 80e3, precision=JDOUBLE)
    assert tp.wavelength == jp.wavelength
    np.testing.assert_array_equal(tp.kxs, jp.kxs)
    tp.defocus(12.0)
    jp.defocus(12.0)
    assert _rel(tp.to_cpu(), jp.to_cpu()) <= 1e-12
    pos = [(2.0, 3.0), (6.0, 5.5), (9.0, 1.0)]
    tb = tprobe.create_batched_probes(tp, pos)
    jb = jprobe.create_batched_probes(jp, pos)
    assert tb.n_probes == jb.n_probes == 3
    assert _rel(tb.to_cpu(), jb.to_cpu()) <= 1e-12
    c = tb.copy()
    assert c.array is not tb.array and torch.equal(c.array, tb.array)
    with pytest.raises(NotImplementedError, match="aberrations"):
        tp.aberrate(C1=10.0)
