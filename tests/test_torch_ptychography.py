"""Port parity: multislice ptychography (pyslice_tpu_torch.analysis.
ptychography.msp_reconstruct) and its Adam against pyslice_tpu's, on the
same float64 data (JAX x64 on the CPU)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import optax
from pyslice_tpu.analysis import ptychography as jptycho
from pyslice_tpu.core.dtypes import DOUBLE as JDOUBLE
from pyslice_tpu.physics.probe import Probe as JProbe
from pyslice_tpu_torch.analysis import ptychography as tptycho
from pyslice_tpu_torch.core.dtypes import DOUBLE
from pyslice_tpu_torch.physics.probe import Probe as TProbe, shift_probes
from pyslice_tpu_torch.physics.propagate import multislice

torch.set_num_threads(2)

NX = NY = 48
SAMPLING, EV, MRAD, DZ, NZ = 0.15, 100e3, 20.0, 1.0, 2


def _rel(got, want):
    return np.abs(np.asarray(got) - np.asarray(want)).max() / \
        np.abs(np.asarray(want)).max()


@pytest.fixture(scope="module")
def problem():
    return _problem()


def _problem():
    """A smooth random two-slice potential, a 4 x 4 scan, and the
    fftshifted intensities the port's plain multislice gives for it.

    The probe is soft: every k pixel is lit (amplitude 1/(1 + k^2/k0^2),
    random phases). A hard aperture leaves dark pixels whose model values
    are FFT roundoff, and the amplitude misfit's gradient there, (1 -
    a/|F|) F, is roundoff-dependent: the two packages (or JAX with and
    without jit) then differ by ~1e-4 relative in the gradient, which Adam
    passes on to the potential. With every pixel lit both agree to ~1e-15.
    """
    xs = np.linspace(0, NX * SAMPLING, NX, endpoint=False)
    ys = np.linspace(0, NY * SAMPLING, NY, endpoint=False)
    rng = np.random.default_rng(21)
    kx = np.fft.fftfreq(NX, SAMPLING)[:, None]
    ky = np.fft.fftfreq(NY, SAMPLING)[None, :]
    smooth = np.exp(-(kx ** 2 + ky ** 2) / 0.5)
    v = np.real(np.fft.ifft2(np.fft.fft2(rng.normal(size=(NZ, NX, NY)))
                             * smooth)) * 400.0
    pk = (np.exp(2j * np.pi * rng.random((NX, NY)))
          / (1.0 + (kx ** 2 + ky ** 2) / 0.6 ** 2))
    probe = np.fft.ifft2(pk)
    scan = np.array([(1.0 + 1.5 * i, 1.2 + 1.4 * j)
                     for i in range(4) for j in range(4)])
    base = TProbe(xs, ys, MRAD, EV, array=probe, precision=DOUBLE,
                  device="cpu")
    probes = shift_probes(base.array, base.kxs, base.kys, scan, DOUBLE)
    ew = multislice(probes, torch.from_numpy(v), base.kxs, base.kys, eV=EV,
                    dz=DZ, precision=DOUBLE)
    inten = np.abs(np.fft.fftshift(np.fft.fft2(ew.numpy()),
                                   axes=(-2, -1))) ** 2
    return dict(xs=xs, ys=ys, scan=scan, inten=inten, probe=probe,
                rng_pos=rng.normal(0, 0.05, scan.shape))


CASES = {
    "amplitude": {},
    "update_probe": dict(update_probe=True, lr_probe=2e-5),
    "update_positions": dict(update_positions=True, lr_pos=0.02),
    "n_modes": dict(n_modes=2, update_probe=True, lr_probe=2e-5),
    "poisson": dict(loss="poisson", lr=5.0),
    "reg_tv": dict(reg_tv=1e-7),
}


@pytest.mark.parametrize("case", list(CASES))
def test_msp_reconstruct_equals_jax_f64(problem, case):
    p = problem
    kw = dict(CASES[case], n_slices=NZ, dz=DZ, steps=5, batch=6, seed=3)
    data = p["inten"] * (50.0 if case == "poisson" else 1.0)
    scan = p["scan"] + (p["rng_pos"] if case == "update_positions" else 0.0)
    jprobe = JProbe(p["xs"], p["ys"], MRAD, EV, array=p["probe"],
                    precision=JDOUBLE)
    tprobe = TProbe(p["xs"], p["ys"], MRAD, EV, array=p["probe"],
                    precision=DOUBLE, device="cpu")
    want = jptycho.msp_reconstruct(data, scan, jprobe, **kw)
    got = tptycho.msp_reconstruct(data, scan, tprobe, **kw)
    assert got["losses"].shape == (5,) and np.isfinite(got["losses"]).all()
    assert got["losses"][-1] < got["losses"][0]
    for key in ("losses", "potential", "probe", "probe_modes", "positions"):
        assert got[key].shape == np.asarray(want[key]).shape, key
        assert got[key].dtype == np.asarray(want[key]).dtype, key
        assert _rel(got[key], want[key]) <= 1e-8, key
    if kw.get("update_probe"):
        assert _rel(got["probe"], p["probe"]) > 1e-4     # refined
    if kw.get("update_positions"):
        assert _rel(got["positions"], scan) > 1e-4


@pytest.mark.parametrize("is_complex", [False, True])
def test_adam_equals_optax(is_complex):
    rng = np.random.default_rng(4 + is_complex)

    def draw(shape=(5, 7)):
        x = rng.normal(size=shape)
        return x + 1j * rng.normal(size=shape) if is_complex else x

    p0 = draw()
    grads = [draw() * 10.0 ** rng.integers(-3, 3) for _ in range(10)]
    opt = optax.adam(0.03)
    jp = jnp.asarray(p0)
    state = opt.init(jp)
    step = tptycho._adam(0.03)
    tp = torch.from_numpy(p0)
    for g in grads:
        upd, state = opt.update(jnp.asarray(g), state)
        jp = optax.apply_updates(jp, upd)
        tp = step(tp, torch.from_numpy(g))
        assert _rel(tp.numpy(), np.asarray(jp)) <= 1e-12


def test_helpers_equal_jax(problem):
    p = problem
    np.testing.assert_array_equal(tptycho._epoch_batches(37, 8, 12, 5),
                                  jptycho._epoch_batches(37, 8, 12, 5))
    np.testing.assert_array_equal(tptycho._detector_amplitudes(p["inten"]),
                                  jptycho._detector_amplitudes(p["inten"]))
    kx = np.fft.fftfreq(NX, SAMPLING)
    ky = np.fft.fftfreq(NY, SAMPLING)
    got = tptycho._shift_ramps(torch.from_numpy(kx), torch.from_numpy(ky),
                               torch.from_numpy(p["scan"]))
    want = jptycho._shift_ramps(jnp.asarray(kx), jnp.asarray(ky),
                                jnp.asarray(p["scan"]))
    assert _rel(got.numpy(), want) <= 1e-12
    for n in (48, 51):
        xs = np.linspace(0, n * 0.1, n, endpoint=False)
        assert (tptycho._probe_center(TProbe(xs, xs, 20.0, EV,
                                             device="cpu"))
                == jptycho._probe_center(JProbe(xs, xs, 20.0, EV)))
    assert tptycho._precision_of(torch.float64) is DOUBLE
    assert tptycho._precision_of(torch.float32).name == "single"


def test_msp_argument_errors(problem):
    p = problem
    tprobe = TProbe(p["xs"], p["ys"], MRAD, EV, device="cpu")
    with pytest.raises(NotImplementedError, match="item 11"):
        tptycho.msp_reconstruct(p["inten"], p["scan"], tprobe, NZ, DZ,
                                mesh=object())
    with pytest.raises(ValueError, match="patterns"):
        tptycho.msp_reconstruct(p["inten"][:3], p["scan"], tprobe, NZ, DZ)
    with pytest.raises(ValueError, match="loss"):
        tptycho.msp_reconstruct(p["inten"], p["scan"], tprobe, NZ, DZ,
                                loss="l1")
    with pytest.raises(ValueError, match="v_init"):
        tptycho.msp_reconstruct(p["inten"], p["scan"], tprobe, NZ, DZ,
                                v_init=np.zeros((1, NX, NY)))
