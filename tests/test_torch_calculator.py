"""Port parity, end to end: the slice (trajectory -> MultisliceCalculator ->
WFData -> TACAW / HAADF) through pyslice_tpu_torch and pyslice_tpu on the
same hBN thermal trajectory, with the JAX plan and probe batch carried into
the port by interop."""

import dataclasses

import numpy as np
import pytest
import torch

import pyslice_tpu as jt
import pyslice_tpu_torch as tt
from pyslice_tpu_torch import interop

from fixtures import hbn_thermal
from oracle import residual

torch.set_num_threads(2)

SETUP = dict(aperture=30.0, voltage_eV=100e3, sampling=0.1,
             slice_thickness=0.5, use_cache=False,
             probe_positions=[(1.0, 2.0), (3.5, 2.0), (1.0, 6.0), (3.5, 6.0)])


def _traj():
    j = hbn_thermal(n_frames=4)
    t = tt.Trajectory(atom_types=j.atom_types, positions=j.positions,
                      velocities=j.velocities, box_matrix=j.box_matrix,
                      timestep=j.timestep)
    return t, j


def _carry_state(tcalc, jcalc):
    """Feed the port the JAX calculator's plan and probe batch."""
    fields = {f.name: getattr(jcalc.spec.plan, f.name)
              for f in dataclasses.fields(jcalc.spec.plan)}
    tcalc.spec = interop.spec_with_plan(tcalc.spec, fields)
    probes = interop.probes_from_numpy(np.asarray(jcalc._probes_array()),
                                       tcalc.device, tcalc.precision)
    tcalc._batched_probes = (tcalc.base_probe.array,
                             np.asarray(tcalc.probe_positions, np.float64),
                             probes)


def _run_both(precision, device_output=False, carry=True, **extra):
    ttraj, jtraj = _traj()
    jcalc = jt.MultisliceCalculator(precision=precision)
    jcalc.setup(jtraj, **SETUP, **extra)
    tcalc = tt.MultisliceCalculator(device="cpu", precision=precision)
    tcalc.setup(ttraj, device_output=device_output, **SETUP, **extra)
    if carry:
        _carry_state(tcalc, jcalc)
    return tcalc.run(progress=False), jcalc.run(progress=False)


def _wave(wf):
    w = wf.wavefunction_data
    return w.numpy() if isinstance(w, torch.Tensor) else np.asarray(w)


def _rel(got, want):
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("precision,device_output",
                         [("single", False), ("single", True),
                          ("double", False), ("double", True)])
def test_slice_end_to_end_matches_jax(precision, device_output):
    twf, jwf = _run_both(precision, device_output)
    tw, jw = _wave(twf), _wave(jwf)
    assert tw.shape == jw.shape == (4, 4, 51, 87, 1)
    assert tw.dtype == jw.dtype
    assert isinstance(twf.wavefunction_data, torch.Tensor) == device_output
    assert residual(tw, jw) <= (1e-6 if precision == "single" else 1e-12)
    for f in ("time", "kxs", "kys", "layer"):
        np.testing.assert_array_equal(getattr(twf, f), getattr(jwf, f))

    # complex64: the time mean is subtracted before the time FFT, so the
    # thermal signal is a small difference of complex64 waves and carries
    # their ~1e-6 disagreement amplified; the 1e-4 bar holds for the
    # probe-averaged outputs. complex128 checks every method at 1e-10.
    tol = 1e-4 if precision == "single" else 1e-10
    ttac, jtac = tt.TACAWData(twf), jt.TACAWData(jwf)
    np.testing.assert_array_equal(ttac.frequencies, jtac.frequencies)
    assert _rel(ttac.spectrum(), jtac.spectrum()) <= tol
    assert _rel(ttac.diffraction(), jtac.diffraction()) <= tol
    for intensity in (False, True):
        a = tt.HAADFData(twf).calculateADF(45, intensity=intensity)
        b = jt.HAADFData(jwf).calculateADF(45, intensity=intensity)
        assert a.shape == b.shape == (2, 2)
        assert _rel(a, b) <= tol
    if precision == "single":
        return
    assert _rel(ttac.spectrum(probe_index=2), jtac.spectrum(probe_index=2)) <= tol
    assert _rel(ttac.diffraction(1), jtac.diffraction(1)) <= tol
    f0 = float(jtac.frequencies[-1])
    assert _rel(ttac.spectrum_image(f0), jtac.spectrum_image(f0)) <= tol
    assert _rel(ttac.spectral_diffraction(f0),
                jtac.spectral_diffraction(f0)) <= tol
    assert _rel(ttac.spectral_diffraction(f0, 3),
                jtac.spectral_diffraction(f0, 3)) <= tol
    mask = np.zeros((51, 87))
    mask[10:40, 20:60] = 1.0
    assert _rel(ttac.masked_spectrum(mask), jtac.masked_spectrum(mask)) <= tol
    assert _rel(ttac.masked_spectrum(mask, 0),
                jtac.masked_spectrum(mask, 0)) <= tol
    kx, ky = ttac.kxs[::7][:8], ttac.kys[::11][:8]
    assert _rel(ttac.dispersion(kx, ky), jtac.dispersion(kx, ky)) <= tol
    assert _rel(ttac.dispersion(kx, ky, 1), jtac.dispersion(kx, ky, 1)) <= tol


def test_own_plan_and_probes_match_jax():
    """Without interop: the port's own make_plan and probe batch."""
    twf, jwf = _run_both("double", carry=False)
    assert residual(_wave(twf), _wave(jwf)) <= 1e-12


def test_record_layers_and_band_limit_match_jax():
    twf, jwf = _run_both("double", record_layers=[3, 9, 13],
                         bandwidth_limit=2.0 / 3.0)
    tw, jw = _wave(twf), _wave(jwf)
    assert tw.shape == jw.shape == (4, 4, 51, 87, 3)
    assert residual(tw, jw) <= 1e-12
    np.testing.assert_array_equal(twf.layer, jwf.layer)
    a = tt.TACAWData(twf, layer_index=1).spectrum()
    b = jt.TACAWData(jwf, layer_index=1).spectrum()
    assert _rel(a, b) <= 1e-6


def test_simulate_frames_equal_jax():
    from pyslice_tpu.engine.pipeline import simulate_frames as jsim
    from pyslice_tpu_torch.engine.pipeline import (simulate_frames,
                                                   simulate_frames_into)
    ttraj, jtraj = _traj()
    jcalc = jt.MultisliceCalculator(precision="double")
    jcalc.setup(jtraj, **SETUP)
    tcalc = tt.MultisliceCalculator(device="cpu", precision="double")
    tcalc.setup(ttraj, **SETUP)
    want = np.asarray(jsim(jtraj.positions[1:3], jcalc._probes_array(),
                           jcalc.spec))
    probes = tcalc._probes_array()
    got = simulate_frames(ttraj.positions[1:3], probes, tcalc.spec)
    assert got.shape == want.shape == (4, 2, 51, 87, 1)
    assert residual(got.numpy(), want) <= 1e-12
    out = torch.zeros((4, 4, 51, 87, 1), dtype=torch.complex128)
    simulate_frames_into(out, 2, ttraj.positions[1:3], probes, tcalc.spec)
    assert torch.equal(out[:, 2:], got) and not out[:, :2].any()


def test_frame_cache_resume_and_probe_positions_key(tmp_path):
    ttraj, _ = _traj()
    calc = tt.MultisliceCalculator(device="cpu")
    setup = dict(SETUP, use_cache=True, cache_root=str(tmp_path))
    calc.setup(ttraj, **setup)
    first = _wave(calc.run(progress=False))
    files = sorted(p.name for p in calc.output_dir.iterdir())
    assert files == [f"frame_{i}.npy" for i in range(4)]
    calc2 = tt.MultisliceCalculator(device="cpu")
    calc2.setup(ttraj, **setup)
    assert calc2.output_dir == calc.output_dir
    np.testing.assert_array_equal(_wave(calc2.run(progress=False)), first)
    # Rebinding probe_positions after setup rebuilds the probe batch.
    probes = calc2._probes_array()
    calc2.probe_positions = [(2.0, 4.0)] * 4
    assert not torch.equal(calc2._probes_array(), probes)
    calc3 = tt.MultisliceCalculator(device="cpu")
    calc3.setup(ttraj, **dict(setup, probe_positions=[(2.0, 4.0)] * 4))
    assert calc3.output_dir != calc.output_dir


def test_unported_options_raise():
    ttraj, _ = _traj()
    calc = tt.MultisliceCalculator(device="cpu")
    with pytest.raises(NotImplementedError, match="Multi-GPU"):
        calc.setup(ttraj, mesh=object())


def test_wfdata_save_load_roundtrip(tmp_path):
    twf, _ = _run_both("single", device_output=True, carry=False)
    twf.save(tmp_path / "wf.npz")
    back = tt.WFData.load(tmp_path / "wf.npz", device="cpu")
    np.testing.assert_array_equal(back.wavefunction_data, _wave(twf))
    assert back.probe.wavelength == twf.probe.wavelength
