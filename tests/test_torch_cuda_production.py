"""Production-scale parity of the port on the card (the counterpart of the
JAX package's tests/test_tpu.py::test_e2e_production_scale_parity_on_
hardware): 1024^2 x 16 probes x 14 slices through the kernels, and a
32-frame time FFT, against the port's complex128 plain path on the card,
which is independent of the kernels (the CPU tests hold that path to the
JAX package in x64 within 1e-10). Every test needs a CUDA device and
skips without one. The machine with the card has no JAX, so run this file
there without the JAX-side conftest, with -s for the measured numbers:

    python -m pytest --noconftest -p no:cacheprovider -s tests/test_torch_cuda_production.py
"""

import time

import numpy as np
import pytest
import torch

import pyslice_tpu_torch as pt
from pyslice_tpu_torch.ops import fused_step as fs

pytestmark = pytest.mark.cuda

N_FRAMES = 32
KW = dict(aperture=30, voltage_eV=100e3, sampling=0.1, slice_thickness=0.5,
          use_cache=False)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    fs.build()
    return torch.device("cuda")


def _hbn_box(lx, n_frames, seed):
    """hBN monolayer filling an lx x lx box (whole rectangular cells of
    a = 2.504 A) plus n_frames uniform thermal frames of 0.05 A from a
    seeded torch.Generator."""
    a = 2.504
    by = np.sqrt(3.0) * a
    z0 = 6.784 / 4.0
    base = np.array([[0.0, 0.0, z0], [a / 2, by / 6, z0],
                     [a / 2, by / 2, z0], [0.0, by / 2 + by / 6, z0]])
    ncx, ncy = int(lx // a), int(lx // by)
    pos = np.concatenate([base + np.array([i * a, j * by, 0.0])
                          for i in range(ncx) for j in range(ncy)])[None]
    types = np.tile(np.array([5, 7, 5, 7], dtype=np.int32), ncx * ncy)
    traj = pt.Trajectory(atom_types=types, positions=pos,
                         velocities=np.zeros_like(pos),
                         box_matrix=np.diag([lx, lx, 6.784]), timestep=0.005)
    return traj.generate_random_displacements(
        n_frames, 0.05, generator=torch.Generator().manual_seed(seed))


def _residual(result, expected):
    """The reference's magnitude residual, in float64."""
    f = result.abs().double()
    d = expected.abs().double()
    return float(((f - d) ** 2).sum() / (f ** 2).sum())


def _card():
    return (f"{torch.cuda.get_device_name(0)}, "
            f"{torch.cuda.get_device_properties(0).total_memory / 2 ** 30:.0f}"
            " GiB")


def test_production_scale_exit_waves(dev):
    """16 probes x 14 slices at 1024^2 through A, B, C on frames 0 and 17
    of 32, against the complex128 plain path on the card."""
    traj = _hbn_box(102.35, N_FRAMES, seed=5).slice_timesteps([0, 17])
    pg = pt.probe_grid([10.0, 90.0], [10.0, 90.0], 4, 4)
    calc = pt.MultisliceCalculator(device=dev)
    calc.setup(traj, device_output=True, probe_positions=pg, **KW)
    assert (calc.nx, calc.ny, calc.nz) == (1024, 1024, 14)
    for k in fs.launches:
        fs.launches[k] = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    wf = calc.run(progress=False)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    assert (fs.launches["a"], fs.launches["b"], fs.launches["c"]) == \
        (2 * 14, 2 * 13, 2)
    peak = torch.cuda.max_memory_allocated()
    ref_calc = pt.MultisliceCalculator(device=dev, precision="double")
    ref_calc.setup(traj, device_output=True, probe_positions=pg, **KW)
    ref = ref_calc.run(progress=False).wavefunction_data
    res = [_residual(wf.wavefunction_data[:, i, ..., -1], ref[:, i, ..., -1])
           for i in range(2)]
    print(f"\nproduction-scale exit waves (1024^2 x 16 probes x 14 slices, "
          f"frames 0 and 17 of 32) against the complex128 plain path: "
          f"residual {res[0]:.3e}, {res[1]:.3e}; {1e3 * run_s / 2:.2f} "
          f"ms/frame (first run), peak {peak / 2 ** 30:.2f} GiB; {_card()}")
    assert max(res) < 1e-6


def test_production_scale_time_fft(dev):
    """32 frames x 4 probes at 1024^2 on the card, TACAWData on the card;
    the mean-subtracted time FFT recomputed in float64 on the host from the
    card's own exit waves on two 96^2 k patches, and masked_spectrum on the
    central patch against its float64 value."""
    traj = _hbn_box(102.35, N_FRAMES, seed=5)
    pg4 = pt.probe_grid([20.0, 80.0], [20.0, 80.0], 2, 2)
    calc = pt.MultisliceCalculator(device=dev)
    calc.setup(traj, device_output=True, probe_positions=pg4, **KW)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    wf = calc.run(progress=False)
    tac = pt.TACAWData(wf)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    c = 1024 // 2
    patches = {"central": (c - 48, c - 48), "off-axis": (c + 150, c + 150)}
    res = {}
    ref_patch = {}
    for name, (x0, y0) in patches.items():
        waves = wf.wavefunction_data[:, :, x0:x0 + 96, y0:y0 + 96, -1]
        w = waves.cpu().numpy().astype(np.complex128)
        w = w - w.mean(axis=1, keepdims=True)
        ref = np.abs(np.fft.fftshift(np.fft.fft(w, axis=1), axes=1)) ** 2
        ref_patch[name] = ref
        chip = tac.intensity[:, :, x0:x0 + 96, y0:y0 + 96].cpu().numpy()
        res[name] = float(np.sum((chip - ref) ** 2) / np.sum(ref ** 2))
    x0, y0 = patches["central"]
    mask = np.zeros((1024, 1024), np.float32)
    mask[x0:x0 + 96, y0:y0 + 96] = 1.0
    spec = tac.masked_spectrum(mask)
    ref_spec = ref_patch["central"].sum(axis=(2, 3)).mean(axis=0)
    res_spec = float(np.sum((spec - ref_spec) ** 2) / np.sum(ref_spec ** 2))
    print(f"\nproduction-scale time FFT (1024^2 x 4 probes x {N_FRAMES} "
          f"frames) against float64 on the host: central "
          f"{res['central']:.3e}, off-axis {res['off-axis']:.3e}, "
          f"masked_spectrum {res_spec:.3e}; run + TACAW {run_s:.2f} s "
          f"({1e3 * run_s / N_FRAMES:.2f} ms/frame), peak "
          f"{peak / 2 ** 30:.2f} GiB; {_card()}")
    assert max(res.values()) < 1e-6
    assert res_spec < 1e-6
