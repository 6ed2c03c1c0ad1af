"""Port parity: the structure and aberration refinements of
pyslice_tpu_torch.engine.inverse against pyslice_tpu's, a few Adam steps
each on the same float64 data (JAX x64 on the CPU), and the rasterizer's
gradient with respect to the atom positions."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from pyslice_tpu.core.dtypes import DOUBLE as JDOUBLE
from pyslice_tpu.engine import inverse as jinv
from pyslice_tpu.physics import potential as jpot
from pyslice_tpu.physics.probe import Probe as JProbe
from pyslice_tpu_torch.core.dtypes import DOUBLE
from pyslice_tpu_torch.engine import inverse as tinv
from pyslice_tpu_torch.physics import potential as tpot
from pyslice_tpu_torch.physics.probe import Probe as TProbe, shift_probes
from pyslice_tpu_torch.physics.propagate import multislice

torch.set_num_threads(2)

NX = NY = 48
S, EV, MRAD, DZ = 0.15, 100e3, 22.0, 1.0
LX = NX * S
XS = np.linspace(0, LX, NX, endpoint=False)
SCAN = np.array([(1.5 + 1.4 * i, 1.3 + 1.5 * j)
                 for i in range(4) for j in range(4)])


def _rel(got, want):
    return np.abs(np.asarray(got) - np.asarray(want)).max() / \
        np.abs(np.asarray(want)).max()


def _soft_probe(seed=31):
    """Every k pixel lit (see tests/test_torch_ptychography.py: a hard
    aperture's dark pixels make the misfit's gradient roundoff-dependent)."""
    rng = np.random.default_rng(seed)
    k2 = (np.fft.fftfreq(NX, S)[:, None] ** 2
          + np.fft.fftfreq(NY, S)[None, :] ** 2)
    return np.fft.ifft2(np.exp(2j * np.pi * rng.random((NX, NY)))
                        / (1.0 + k2 / 0.6 ** 2))


def _probes(array):
    return (TProbe(XS, XS, MRAD, EV, array=array, precision=DOUBLE,
                   device="cpu"),
            JProbe(XS, XS, MRAD, EV, array=array, precision=JDOUBLE))


def _atoms(n_at, zmax, seed):
    rng = np.random.default_rng(seed)
    pos = np.column_stack([rng.uniform(0.2 * LX, 0.8 * LX, n_at),
                           rng.uniform(0.2 * LX, 0.8 * LX, n_at),
                           rng.uniform(0.2, zmax - 0.2, n_at)])
    return pos, rng.choice([5, 7], n_at).astype(np.int32), rng


def _data(pos, types, zs, probe_array):
    """fftshifted intensities of the port's plain multislice at SCAN."""
    plan = tpot.make_plan(XS, XS, zs, pos[None], types)
    v = tpot.rasterize(torch.from_numpy(pos), plan, DOUBLE)
    tp, _ = _probes(probe_array)
    ew = multislice(shift_probes(tp.array, tp.kxs, tp.kys, SCAN, DOUBLE), v,
                    tp.kxs, tp.kys, eV=EV, dz=DZ, precision=DOUBLE)
    return np.abs(np.fft.fftshift(np.fft.fft2(ew.numpy()),
                                  axes=(-2, -1))) ** 2


def _check(got, want, keys):
    for key in keys:
        g, w = np.asarray(got[key]), np.asarray(want[key])
        assert g.shape == w.shape and g.dtype == w.dtype, key
        assert _rel(g, w) <= 1e-8, key


def test_rasterize_position_grads_equal_jax():
    """The gradient reaches the positions through the rasterizer's torch
    ops, its bucket accumulation recip[s] += ... included."""
    pos, types, rng = _atoms(7, 2 * DZ, seed=32)
    zs = np.array([0.0, DZ])
    w = rng.normal(size=(2, NX, NY))
    jplan = jpot.make_plan(XS, XS, zs, pos[None], types)
    tplan = tpot.make_plan(XS, XS, zs, pos[None], types)
    want = jax.grad(lambda p: jnp.sum(w * jpot.rasterize(p, jplan, JDOUBLE)))(
        jnp.asarray(pos))
    tp = torch.from_numpy(pos).requires_grad_()
    got, = torch.autograd.grad(
        torch.sum(torch.from_numpy(w) * tpot.rasterize(tp, tplan, DOUBLE)),
        tp)
    assert float(got[:, :2].abs().max()) > 0
    assert _rel(got.numpy(), np.asarray(want)) <= 1e-10


def test_refine_structure_equals_jax_f64():
    pos, types, rng = _atoms(6, 2 * DZ, seed=33)
    zs = np.array([0.0, DZ])
    probe = _soft_probe()
    inten = _data(pos, types, zs, probe)
    start = pos.copy()
    start[:, :2] += rng.normal(0, 0.05, (6, 2))
    kw = dict(steps=4, batch=8, lr=5e-3, seed=1)
    tp, jp = _probes(probe)
    want = jinv.refine_structure(inten, SCAN, jp, start, types, zs, **kw)
    got = tinv.refine_structure(inten, SCAN, tp, start, types, zs, **kw)
    _check(got, want, ("positions", "displacement", "losses"))
    assert got["losses"][-1] < got["losses"][0]
    np.testing.assert_array_equal(got["positions"][:, 2], start[:, 2])


def test_refine_aberrations_equals_jax_f64():
    pos, types, _ = _atoms(5, 2 * DZ, seed=34)
    zs = np.array([0.0, DZ])
    probe = _soft_probe(35)
    true_probe, _ = _probes(probe)
    true_probe.aberrate(C1=30.0, C3=4e4, A1=12.0, phi_A1=0.4)
    inten = _data(pos, types, zs, true_probe.array.numpy())
    # A start away from V = 0, where the exit wave is the probe itself, its
    # intensity does not depend on chi, and the aberration gradient is pure
    # roundoff that later steps amplify.
    v0 = tpot.rasterize(torch.from_numpy(pos + 0.1), tpot.make_plan(
        XS, XS, zs, pos[None] + 0.1, types), DOUBLE).numpy()
    kw = dict(coefficients=("C1", "C3", "A1"), n_slices=2, v_init=v0,
              dz=DZ, steps=4, batch=8, seed=2)
    tp, jp = _probes(probe)
    want = jinv.refine_aberrations(inten, SCAN, jp, **kw)
    got = tinv.refine_aberrations(inten, SCAN, tp, **kw)
    _check(got, want, ("potential", "losses"))
    assert list(got["coefficients"]) == list(want["coefficients"])
    assert _rel(list(got["coefficients"].values()),
                list(want["coefficients"].values())) <= 1e-8
    for field in ("C1", "C3", "A1", "phi_A1"):
        assert getattr(got["aberrations"], field) == pytest.approx(
            getattr(want["aberrations"], field), rel=1e-8, abs=1e-12)
    with pytest.raises(ValueError, match="unknown aberration"):
        tinv.refine_aberrations(inten[:4], SCAN[:4], tp,
                                coefficients=("C9",), steps=1)


def test_refine_structure_tilt_series_equals_jax_f64():
    zs = np.arange(4) * DZ
    pos, types, rng = _atoms(5, 4 * DZ, seed=36)
    pos[:, 2] = rng.uniform(1.3, 2.7, 5)        # room to tilt in z
    probe = _soft_probe(37)
    tilts = (-8.0, 0.0, 8.0)
    ctr = pos.mean(axis=0)
    datasets = []
    for ang in tilts:
        r = tinv.rotation_about_x(np.deg2rad(ang))
        datasets.append(_data((pos - ctr) @ r.T + ctr, types, zs, probe))
    start = pos + rng.normal(0, 0.04, pos.shape)
    scans = [SCAN] * 3
    kw = dict(steps=4, batch=8, lr=5e-3, seed=3)
    tp, jp = _probes(probe)
    want = jinv.refine_structure_tilt_series(datasets, scans, jp, start,
                                             types, zs, tilts, **kw)
    got = tinv.refine_structure_tilt_series(datasets, scans, tp, start,
                                            types, zs, tilts, **kw)
    _check(got, want, ("positions", "displacement", "losses"))
    np.testing.assert_array_equal(tinv.rotation_about_x(0.3),
                                  jinv.rotation_about_x(0.3))
    with pytest.raises(ValueError, match="one dataset"):
        tinv.refine_structure_tilt_series(datasets[:2], scans, tp, start,
                                          types, zs, tilts, steps=1)


def test_aberration_basis_equals_jax():
    kxs = np.fft.fftfreq(NX, S)
    args = (kxs, kxs, 0.037, ("C1", "C3", "C5", "A1", "B2", "A2", "A3"), 0.6)
    for g, w in zip(tinv._aberration_basis(*args),
                    jinv._aberration_basis(*args)):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
