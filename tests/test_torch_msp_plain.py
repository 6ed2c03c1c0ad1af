"""msp_reconstruct's step against the benchmark's plain reference.

At 64^2 x 3 slices, 4 scan positions and 2 probe modes, with the probe and
the positions refined: one step of the port (``_msp_setup`` and
``_MspRun.step``, the loop body of ``msp_reconstruct``) taken from the
state after a first step, against ``benchmark/reference/msp.py``'s step
from the same state (loaded by path; it imports nothing of either
package): the loss, the three gradients and the three updates, in float64
and in complex64. Also: the ingest of a tensor equals the host's bit for
bit; the Adam moments kept as attributes leave ``msp_reconstruct`` as it
was, bit for bit; the counters and the spans.

The probe is soft (every k pixel lit), as in the msp parity tests: with a
hard aperture the misfit's gradient at dark pixels is roundoff.
"""

import importlib
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from pyslice_tpu_torch.analysis import ptychography as tp
from pyslice_tpu_torch.core.dtypes import DOUBLE, SINGLE
from pyslice_tpu_torch.physics.probe import Probe, shift_probes
from pyslice_tpu_torch.physics.propagate import multislice

torch.set_num_threads(2)

BENCH = Path(__file__).resolve().parents[1] / "benchmark"
EV, MRAD = 100e3, 20.0
KW = dict(steps=3, batch=4, n_modes=2, update_probe=True,
          update_positions=True, lr_probe=2e-5, lr_pos=0.02, seed=3)
LRS = {"v": 30.0, "modes": 2e-5, "pos": 0.02}
NAMES = ("v", "modes", "pos")


@pytest.fixture(scope="module")
def ref():
    """(reference.plain, reference.msp) of the benchmark, imported from
    its directory."""
    sys.path.insert(0, str(BENCH))
    try:
        return (importlib.import_module("reference.plain"),
                importlib.import_module("reference.msp"))
    finally:
        sys.path.remove(str(BENCH))


@pytest.fixture(scope="module")
def problem(ref):
    """The reference's grid (64^2 x 3 slices), a soft random probe, four
    positions, and the fftshifted intensities of a smooth random
    potential through the port's float64 multislice."""
    plain, _ = ref
    grid = plain.Grid(9.525, 9.525, 2.5, 0.15, 1.0)
    assert (grid.nx, grid.ny, grid.nz) == (64, 64, 3)
    xs = np.arange(grid.nx) * grid.dx
    rng = np.random.default_rng(24)
    kx, ky = grid.kx()[:, None], grid.ky()[None, :]
    smooth = np.exp(-(kx ** 2 + ky ** 2) / 0.5)
    v = np.real(np.fft.ifft2(np.fft.fft2(
        rng.normal(size=(grid.nz, grid.nx, grid.ny))) * smooth)) * 400.0
    probe = np.fft.ifft2(np.exp(2j * np.pi * rng.random((grid.nx, grid.ny)))
                         / (1.0 + (kx ** 2 + ky ** 2) / 0.6 ** 2))
    scan = np.array([(3.1, 3.3), (4.6, 3.2), (3.2, 4.7), (4.5, 4.6)])
    base = Probe(xs, xs, MRAD, EV, array=probe, precision=DOUBLE,
                 device="cpu")
    ew = multislice(shift_probes(base.array, base.kxs, base.kys, scan,
                                 DOUBLE),
                    torch.from_numpy(v), base.kxs, base.kys, eV=EV,
                    dz=grid.dz, precision=DOUBLE)
    inten = np.abs(np.fft.fftshift(np.fft.fft2(ew.numpy()),
                                   axes=(-2, -1))) ** 2
    return dict(grid=grid, xs=xs, probe=probe, scan=scan, inten=inten)


def _setup(p, prec, data=None):
    probe = Probe(p["xs"], p["xs"], MRAD, EV, array=p["probe"],
                  precision=prec, device="cpu")
    return tp._msp_setup(p["inten"] if data is None else data, p["scan"],
                         probe, p["grid"].nz, p["grid"].dz, **KW)


def _state(run, idx, inten):
    """The state before a step on ``idx``, as the benchmark's driver keeps
    it (the minibatch's rows of the data ``inten`` as they were given)."""
    return {"idx": np.asarray(idx), "inten": inten[np.asarray(idx)],
            **{k: getattr(run, k).detach().clone() for k in NAMES},
            "moments": {k: (a.mu.clone(), a.nu.clone(), a.count)
                        for k, a in run.adam.items()}}


def _rel(got, want):
    """The relative L2 error, as the benchmark's check reads it."""
    got, want = np.asarray(got), np.asarray(want)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _second_step(p, ref, prec):
    """{number: relative error} of the port's second step against the
    reference's from the state after the first."""
    plain, msp = ref
    run, batches = _setup(p, prec)
    run.step(batches[0])
    state = _state(run, batches[1], p["inten"])
    loss, grads = run.grads(batches[1])
    run.step(batches[1])
    want = msp.step(state, p["grid"], EV, LRS, plain.TRUTH, "cpu", block=3)
    wide = lambda t: t.detach().numpy().astype(
        np.complex128 if t.is_complex() else np.float64)
    out = {"loss": abs(float(loss) - want["loss"]) / abs(want["loss"])}
    for k in NAMES:
        out["grad_" + k] = _rel(wide(grads[k]), want["grad_" + k])
        out["update_" + k] = _rel(wide(getattr(run, k)) - wide(state[k]),
                                  want["update_" + k])
    return out


def test_step_equals_reference_f64(problem, ref):
    errs = _second_step(problem, ref, DOUBLE)
    assert set(errs) == {"loss"} | {f"{w}_{k}" for w in ("grad", "update")
                                    for k in NAMES}
    for name, e in errs.items():
        assert e <= 1e-10, (name, e)


# complex64 against float64, relative L2, each bar with its reason
# (measured: loss 3.0e-7, V 2.4e-6 / 1.2e-6, the modes 1.6e-5 / 1.4e-5,
# the positions 1.3e-4 / 2.9e-5, gradient / update)
C64_BARS = {
    # float32 roundoff of the misfit's mean over 4 x 64^2 pixels
    "loss": 1e-6,
    # float32 roundoff through 2 x 3 transforms each way and the adjoint
    "grad_v": 1e-5, "update_v": 1e-5,
    # the modes' gradient also sums four back-shifted fields whose float32
    # ramp phases reach 2 pi x 6.7 x 4.7 rad (an ulp of ~2e-5 rad)
    "grad_modes": 5e-5, "update_modes": 5e-5,
    # the position gradient is a sum over +-k that cancels to ~1e-3 of its
    # terms, so their float32 roundoff weighs ~1e3 times more
    "grad_pos": 1e-3,
    # and the new positions are float32: an ulp of 4.7 A (4.8e-7 A)
    # against a step of ~0.02 A
    "update_pos": 1e-4,
}


def test_step_equals_reference_c64(problem, ref):
    errs = _second_step(problem, ref, SINGLE)
    for name, e in errs.items():
        assert e <= C64_BARS[name], (name, e)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.int32])
def test_tensor_ingest_equals_host_ingest(dtype):
    """An array's and a CPU tensor's amplitudes, through the one chunked
    ingest, are the host formula's, bit for bit, at every chunk size; the
    PyTorch path the card takes agrees to one rounding of the type it
    computes in (PyTorch's CPU square root is within an ulp, the card's
    is correctly rounded)."""
    rng = np.random.default_rng(7)
    data = rng.normal(size=(7, 6, 5)) * 10.0
    data[0, 0, :3] = [0.0, -0.0, -1.0]
    data = data.astype(torch.empty((), dtype=dtype).numpy().dtype)
    for real in (torch.float32, torch.float64):
        host = tp._detector_amplitudes(data).astype(
            torch.empty((), dtype=real).numpy().dtype)
        for chunk in (1, 3, 64):
            for given in (data, torch.from_numpy(data)):
                got = tp._amplitudes_on(given, real, "cpu", chunk=chunk)
                assert got.dtype == real
                assert np.array_equal(got.numpy().view(np.uint8),
                                      host.view(np.uint8))
        card = tp._amplitudes_torch(torch.from_numpy(data)).to(real).numpy()
        ulp = max(np.finfo(host.dtype).eps, np.finfo(
            np.float32 if data.dtype == np.float32 else np.float64).eps)
        assert not np.signbit(card).any()
        assert np.abs(card - host).max() <= 2 * ulp * np.abs(host).max()


def test_msp_setup_takes_a_tensor_on_the_probes_device(problem):
    p = problem
    for prec in (SINGLE, DOUBLE):
        run_np, b_np = _setup(p, prec)
        run_t, b_t = _setup(p, prec, data=torch.from_numpy(p["inten"]))
        np.testing.assert_array_equal(b_np, b_t)
        assert run_t.amps.dtype == prec.real
        assert np.array_equal(run_t.amps.numpy().view(np.uint8),
                              run_np.amps.numpy().view(np.uint8))


def _closure_adam(lr, b1=0.9, b2=0.999, eps=1e-8):
    """Adam as ``msp_reconstruct`` kept it before its moments became
    attributes: the moments in a closure."""
    mu = nu = None
    count = 0

    def step(param, grad):
        nonlocal mu, nu, count
        if mu is None:
            mu = torch.zeros_like(grad)
            nu = torch.zeros_like(grad.real)
        count += 1
        mu = (1 - b1) * grad + b1 * mu
        g2 = (grad.conj() * grad).real if grad.is_complex() else grad ** 2
        nu = (1 - b2) * g2 + b2 * nu
        mu_hat = mu / (1 - b1 ** count)
        nu_hat = nu / (1 - b2 ** count)
        return param + (-lr) * (mu_hat / (torch.sqrt(nu_hat) + eps))

    return step


@pytest.mark.parametrize("prec", [SINGLE, DOUBLE], ids=["c64", "f64"])
def test_readable_moments_leave_msp_reconstruct_bitwise(problem, prec,
                                                        monkeypatch):
    p = problem
    probe = Probe(p["xs"], p["xs"], MRAD, EV, array=p["probe"],
                  precision=prec, device="cpu")
    args = (p["inten"], p["scan"], probe, p["grid"].nz, p["grid"].dz)
    got = tp.msp_reconstruct(*args, **KW)
    with monkeypatch.context() as m:
        m.setattr(tp, "_Adam", _closure_adam)
        want = tp.msp_reconstruct(*args, **KW)
    for key in ("potential", "probe_modes", "positions", "losses"):
        assert np.array_equal(np.asarray(got[key]).view(np.uint8),
                              np.asarray(want[key]).view(np.uint8)), key
    run, batches = _setup(p, prec)
    for idx in batches:
        run.step(idx)
    for k, a in run.adam.items():
        assert a.count == len(batches)
        assert a.mu.shape == getattr(run, k).shape
        assert a.nu.dtype == prec.real


def test_counters_and_spans(problem):
    p = problem
    before = dict(tp.STATS)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        run, batches = _setup(p, DOUBLE)
        run.step(batches[0])
    names = {e.name for e in prof.events()}
    for span in ("setup", "step", "forward", "backward", "update"):
        assert f"pyslice.msp.{span}" in names, span
    assert "pyslice.adjoint" in names
    run.step(batches[1])
    assert tp.STATS["msp_steps"] - before["msp_steps"] == 2
    assert tp.STATS["msp_patterns"] - before["msp_patterns"] == 2 * 4
    assert tp.STATS["msp_waves"] - before["msp_waves"] == 2 * 4 * 2


@pytest.mark.cuda
def test_card_ingest_is_the_host_ingest_within_rounding():
    """On the card a tensor's amplitudes (``_amplitudes_torch``, chunk by
    chunk) are the host path's to within one float32 rounding: the card's
    square root is correctly rounded, so most agree bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    g = torch.Generator(device="cuda").manual_seed(24)
    data = torch.randn((70, 1023, 1023), device="cuda", generator=g) ** 3
    data[0, 0, :3] = torch.tensor([0.0, -0.0, -1.0])
    got = tp._amplitudes_on(data, torch.float32, "cuda").cpu().numpy()
    want = tp._detector_amplitudes(data.cpu().numpy()).astype(np.float32)
    assert not np.signbit(got).any()
    assert np.abs(got - want).max() <= np.finfo(np.float32).eps * np.abs(
        want).max()
