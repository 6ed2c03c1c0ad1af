"""Port parity: the multislice loop of pyslice_tpu_torch.physics.propagate
against pyslice_tpu's, in complex128 (JAX x64 on the CPU), and its
dispatch seam."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from pyslice_tpu.core.dtypes import DOUBLE as JDOUBLE
from pyslice_tpu.physics import propagate as jprop
from pyslice_tpu_torch.core.dtypes import DOUBLE, SINGLE
from pyslice_tpu_torch.ops import config as tconfig
from pyslice_tpu_torch.physics import propagate as tprop

torch.set_num_threads(2)

EV = 100e3


def _inputs(P, NX, NY, NZ, seed=0):
    rng = np.random.default_rng(seed)
    psi = (rng.standard_normal((P, NX, NY))
           + 1j * rng.standard_normal((P, NX, NY)))
    v = rng.standard_normal((NZ, NX, NY)) * 50
    kxs = np.fft.fftfreq(NX, 0.1)
    kys = np.fft.fftfreq(NY, 0.1)
    return psi, v, kxs, kys


def _both(psi, v, kxs, kys, **kw):
    want = np.asarray(jprop.multislice(jnp.asarray(psi), jnp.asarray(v),
                                       kxs, kys, eV=EV, dz=0.5,
                                       precision=JDOUBLE, **kw))
    got = tprop.multislice(torch.from_numpy(psi), torch.from_numpy(v),
                           kxs, kys, eV=EV, dz=0.5, precision=DOUBLE,
                           **kw).numpy()
    return got, want


def _rel(got, want):
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("case", ["plain", "one_slice", "record", "record_end",
                                  "band_limit", "tilt", "band_and_tilt",
                                  "oblique"])
def test_multislice_complex128_equals_jax(case):
    psi, v, kxs, kys = _inputs(2, 48, 40, 5 if case != "one_slice" else 1)
    kw = {}
    if case == "record":
        kw = dict(record_layers=(0, 2, 3))
    elif case == "record_end":
        kw = dict(record_layers=(1, 4))
    elif case == "band_limit":
        kw = dict(bandwidth_limit=2.0 / 3.0)
    elif case == "tilt":
        kw = dict(tilt=(5.0, -3.0))
    elif case == "band_and_tilt":
        kw = dict(kmax2=12.0, tantilt=(0.004, 0.001))
    elif case == "oblique":
        kw = dict(ksq=(kxs[:, None] ** 2 + kys[None, :] ** 2
                       + 0.3 * kxs[:, None] * kys[None, :]))
    got, want = _both(psi, v, kxs, kys, **kw)
    assert got.shape == want.shape and got.dtype == np.complex128
    assert _rel(got, want) <= 1e-10


def test_single_probe_2d_equals_jax():
    psi, v, kxs, kys = _inputs(1, 32, 32, 3, seed=2)
    got, want = _both(psi[0], v, kxs, kys)
    assert got.shape == (32, 32)
    assert _rel(got, want) <= 1e-10


def test_complex64_equals_jax():
    psi, v, kxs, kys = _inputs(2, 64, 48, 4, seed=3)
    want = np.asarray(jprop.multislice(
        jnp.asarray(psi.astype(np.complex64)),
        jnp.asarray(v.astype(np.float32)), kxs, kys, eV=EV, dz=0.5))
    got = tprop.multislice(torch.from_numpy(psi.astype(np.complex64)),
                           torch.from_numpy(v.astype(np.float32)),
                           kxs, kys, eV=EV, dz=0.5).numpy()
    assert got.dtype == np.complex64
    assert _rel(got, want) <= 1e-5


def test_band_limit_and_tilt_helpers_equal_jax():
    kxs = np.fft.fftfreq(64, 0.1)
    kys = np.fft.fftfreq(48, 0.12)
    for bl in (None, 0.5, 2.0 / 3.0, 1.0):
        assert (tprop.bandwidth_kmax2(kxs, kys, bl)
                == jprop.bandwidth_kmax2(kxs, kys, bl))
    ksq = kxs[:, None] ** 2 + kys[None, :] ** 2
    assert (tprop.bandwidth_kmax2(kxs, kys, 0.5, ksq)
            == jprop.bandwidth_kmax2(kxs, kys, 0.5, ksq))
    with pytest.raises(ValueError):
        tprop.bandwidth_kmax2(kxs, kys, 1.5)
    for tilt in (None, (0.0, 0.0), (10.0, -4.0)):
        assert tprop.tilt_tangents(tilt) == jprop.tilt_tangents(tilt)


def test_transmission_is_unimodular_and_equals_jax():
    v = np.random.default_rng(4).standard_normal((16, 16)) * 30
    sigma = 7.3e-4
    got = tprop.transmission(torch.from_numpy(v), sigma, DOUBLE).numpy()
    want = np.asarray(jprop.transmission(jnp.asarray(v), sigma, JDOUBLE))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-14)
    np.testing.assert_allclose(np.abs(got), 1.0, atol=1e-14)


def test_dispatch_seam_on_cpu():
    psi, v, kxs, kys = _inputs(1, 128, 128, 2, seed=5)
    p = torch.from_numpy(psi.astype(np.complex64))
    assert tprop.pick_fused(p, SINGLE, 2) is None    # CPU: plain loop
    with pytest.raises(ValueError, match="fused kernel was required"):
        tprop.multislice(p, torch.from_numpy(v), kxs, kys, eV=EV, dz=0.5,
                         fused=True)
    old = tconfig.fused_multislice
    try:
        tconfig.fused_multislice = "on"
        with pytest.raises(ValueError, match="fused kernel was required"):
            tprop.multislice(p, torch.from_numpy(v), kxs, kys, eV=EV, dz=0.5)
    finally:
        tconfig.fused_multislice = old


def test_argument_errors():
    psi, v, kxs, kys = _inputs(1, 16, 16, 3)
    p, vt = torch.from_numpy(psi), torch.from_numpy(v)
    with pytest.raises(ValueError, match="strictly increasing"):
        tprop.multislice(p, vt, kxs, kys, eV=EV, dz=0.5, record_layers=(2, 1))
    with pytest.raises(ValueError, match="out of range"):
        tprop.multislice(p, vt, kxs, kys, eV=EV, dz=0.5, record_layers=(3,))
    with pytest.raises(ValueError, match="not both"):
        tprop.multislice(p, vt, kxs, kys, eV=EV, dz=0.5, kmax2=1.0,
                         bandwidth_limit=0.5)
    with pytest.raises(ValueError, match="orthogonal"):
        tprop.multislice(p, vt, kxs, kys, eV=EV, dz=0.5, tilt=(1.0, 0.0),
                         ksq=np.ones((16, 16)))
