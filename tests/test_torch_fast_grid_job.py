"""The north star's job on the fast grid against the benchmark's plain
reference.

A user's script (``MultisliceCalculator.setup(..., fast_grid=True)``,
``run``, ``TACAWData``, ``HAADFData``) on a 12.65 A box, whose 127 points
a side snap up to 128, through 3 slices, with 2 x 2 probes and 4 frames,
against ``benchmark/reference/fast_grid.py``'s grid under the plain
reference (loaded by path; it imports nothing of the port): the exit
waves, the spectrum, the diffraction, the ADF and the exported k axes,
in complex128 and in complex64. Also: the slice-loop family of the
north star's grid and of the reference's odd grid, the family counter
(one loop a frame) and the ``slice_loop.kspace`` span (one a frame). On
the card (``cuda``), the job at 1024^2 with 16 probes launches A 14, B 13
and C 1 a frame and counts one ``aligned`` loop a frame. Port-only: no
JAX.
"""

import importlib
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import pyslice_tpu_torch as pt
from pyslice_tpu_torch.engine import pipeline
from pyslice_tpu_torch.ops import fused_step as fs
from pyslice_tpu_torch.physics.propagate import fused_family

BENCH = Path(__file__).resolve().parents[1] / "benchmark"
BOX, LZ, LAYER = 12.65, 1.3, 0.55         # 127 -> 128 a side; 3 slices
EV, MRAD, ADF = 100e3, 30.0, 45.0
POS = [(x, y) for y in (3.0, 9.0) for x in (2.0, 10.0)]
N_FRAMES = 4
TRUTH_TOL = 1e-10
# complex64 against float64, by output. The port rounds the potential and
# 2 nz - 1 = 5 FFTs a frame to float32: the waves read 1.4e-6 and the ADF
# 8e-7 - 1e-6 over three seeds (2**31 + 26, 5, 99). The TACAW maps are of
# the mean-free signal, the thermal part that is small beside the mean
# wave, so they carry that roundoff ~10x larger: the spectrum 3.6e-6 -
# 7.9e-6, the diffraction 1.5e-5 - 2.4e-5. Each tolerance is 4x - 12x
# above its readings.
SINGLE_TOL = {"waves": 1e-5, "spectrum": 5e-5, "diffraction": 1e-4,
              "adf": 1e-5}
# On the card at 1024^2 x 14 slices the chain rounds 27 float32 FFTs a
# frame: the waves read 1.54e-5 against the complex128 plain path (H100,
# seed 7), as the benchmark cell's exit waves read against its float64
# reference (1.3e-5 - 1.5e-5); 5e-5 is 3x above.
CARD_TOL = 5e-5


@pytest.fixture(scope="module")
def ref():
    """(reference.plain, reference.fast_grid, inputs) of the benchmark,
    imported from its directory."""
    sys.path.insert(0, str(BENCH))
    try:
        return tuple(importlib.import_module(m) for m in
                     ("reference.plain", "reference.fast_grid", "inputs"))
    finally:
        sys.path.remove(str(BENCH))


@pytest.fixture(scope="module")
def frames(ref):
    inputs = ref[2]
    base, types = inputs.hbn_box(BOX, LAYER)
    return inputs.thermal_frames(base, N_FRAMES, 0.05, 2 ** 31 + 26,
                                 inputs.JOB, 0), types


def _job(frames, precision):
    """The user's script on the fast grid: (calculator, WFData, spectrum,
    diffraction, ADF image)."""
    pos, types = frames
    traj = pt.Trajectory(atom_types=types, positions=pos,
                         velocities=np.zeros_like(pos),
                         box_matrix=np.diag([BOX, BOX, LZ]), timestep=0.005)
    calc = pt.MultisliceCalculator(device="cpu", precision=precision)
    calc.setup(traj, aperture=MRAD, voltage_eV=EV, slice_thickness=0.5,
               sampling=0.1, probe_positions=POS, device_output=True,
               use_cache=False, fast_grid=True)
    wf = calc.run(progress=False)
    tac = pt.TACAWData(wf)
    return (calc, wf, tac.spectrum(), tac.diffraction(),
            pt.HAADFData(wf).calculateADF(ADF))


@pytest.fixture(scope="module")
def want(ref, frames):
    """The plain reference's float64 waves (probes, frames, nx, ny),
    spectrum, diffraction, ADF image and k axes on the snapped grid."""
    plain, fg, _ = ref
    pos, types = frames
    grid = fg.FastGrid(BOX, BOX, LZ, 0.1, 0.5)
    psi = plain.probes(grid, MRAD, EV, POS, plain.TRUTH, "cpu")
    waves = torch.stack([plain.exit_waves(
        psi, plain.potential(f, types, grid, plain.TRUTH, "cpu"), grid, EV,
        plain.TRUTH) for f in pos], dim=1)
    inten = torch.stack([plain.tacaw_intensity(w) for w in waves])
    mask = torch.as_tensor(plain.adf_mask(grid, ADF, EV))
    collected = (waves.abs() * mask).sum(dim=(2, 3)).mean(1)
    return {"grid": grid, "waves": waves,
            "spectrum": inten.sum(dim=(2, 3)).mean(0),
            "diffraction": inten.sum(dim=1).mean(0),
            "adf": plain.adf_image(collected.numpy(), POS),
            "k_axes": [a.numpy() for a in fg.k_axes(grid, torch.float64)]}


def rel(got, want):
    got = [np.asarray(g, dtype=np.complex128) for g in got]
    want = [np.asarray(w, dtype=np.complex128) for w in want]
    d = sum(np.sum(np.abs(g - w) ** 2) for g, w in zip(got, want))
    return float(np.sqrt(d / sum(np.sum(np.abs(w) ** 2) for w in want)))


@pytest.mark.parametrize("precision", ["double", "single"])
def test_job_on_the_fast_grid_equals_the_plain_reference(frames, want,
                                                         precision):
    calc, wf, spectrum, diffraction, adf = _job(frames, precision)
    grid = want["grid"]
    assert (calc.nx, calc.ny, calc.nz) == (grid.nx, grid.ny, grid.nz) \
        == (128, 128, 3)
    assert calc.dx == pytest.approx(BOX / 128, rel=1e-15)
    # the axes are made on the host in float64 in either precision
    assert rel([wf.kxs, wf.kys], want["k_axes"]) < 1e-15
    got = {"waves": wf.wavefunction_data[..., 0], "spectrum": spectrum,
           "diffraction": diffraction, "adf": adf}
    for name, value in got.items():
        tol = TRUTH_TOL if precision == "double" else SINGLE_TOL[name]
        assert rel([value], [want[name]]) < tol, name


def test_family_of_the_north_star_and_of_the_odd_grid():
    assert fused_family(16, 1024, 1024, 14) == "aligned"
    assert fused_family(16, 1023, 1023, 14) == "odd"
    assert fused_family(1, 1024, 1024, 14) == "resident"


def test_family_counter_and_kspace_span_once_a_frame(frames):
    before = dict(pipeline.families)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _job(frames, "single")
    after = dict(pipeline.families)
    assert {k: after[k] - before[k] for k in after} == {
        "resident": 0, "aligned": 0, "odd_resident": 0, "odd": 0,
        "plain": N_FRAMES}
    counts = {e.key: e.count for e in prof.key_averages()
              if e.key.startswith("pyslice.slice_loop")}
    assert counts == {"pyslice.slice_loop": N_FRAMES,
                      "pyslice.slice_loop.kspace": N_FRAMES}


def test_kernel_c_runs_in_the_kspace_span():
    """The aligned chain's conversion (kernel C; its plain version on the
    CPU) is the one launch inside ``slice_loop.kspace``."""
    g = torch.Generator().manual_seed(5)
    psi = torch.randn((2, 128, 128), dtype=torch.complex64, generator=g)
    v = torch.rand((3, 128, 128), generator=g)
    kx = np.fft.fftfreq(128, 0.1)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fs.fused_multislice_kspace_plain(psi, v, kx, kx, sigma=1e-3,
                                         lam=0.037, dz=0.5)
    keys = {e.key: e.count for e in prof.key_averages()}
    assert keys.get("pyslice.slice_loop.kspace") == 1


@pytest.mark.cuda
def test_north_star_job_on_the_card_takes_the_aligned_chain():
    """16 probes at 1024^2 (102.25 A snapped from 1023) x 14 slices, two
    frames: A 14, B 13, C 1 a frame, no K4, K5 or K6, one ``aligned``
    loop a frame; the waves against the complex128 plain path on the
    card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    fs.build()
    dev = torch.device("cuda")
    sys.path.insert(0, str(BENCH))
    try:
        inputs = importlib.import_module("inputs")
    finally:
        sys.path.remove(str(BENCH))
    base, types = inputs.hbn_box(102.25, 1.913)
    pos = inputs.thermal_frames(base, 2, 0.05, 7, inputs.JOB, 0)
    traj = pt.Trajectory(atom_types=types, positions=pos,
                         velocities=np.zeros_like(pos),
                         box_matrix=np.diag([102.25, 102.25, 6.784]),
                         timestep=0.005)
    probes = pt.probe_grid([10.0, 90.0], [10.0, 90.0], 4, 4)
    kw = dict(aperture=MRAD, voltage_eV=EV, slice_thickness=0.5,
              sampling=0.1, probe_positions=probes, device_output=True,
              use_cache=False, fast_grid=True)
    calc = pt.MultisliceCalculator(device=dev)
    calc.setup(traj, **kw)
    assert (calc.nx, calc.ny, calc.nz) == (1024, 1024, 14)
    launches0, families0 = dict(fs.launches), dict(pipeline.families)
    wf = calc.run(progress=False)
    torch.cuda.synchronize()
    ran = {k: fs.launches[k] - launches0[k]
           for k in ("a", "b", "c", "k4", "k5", "k6")}
    assert ran == {"a": 28, "b": 26, "c": 2, "k4": 0, "k5": 0, "k6": 0}
    assert pipeline.families["aligned"] - families0["aligned"] == 2
    ref = pt.MultisliceCalculator(device=dev, precision="double")
    ref.setup(traj, **kw)
    want = ref.run(progress=False).wavefunction_data
    got = wf.wavefunction_data
    assert rel([got.cpu().numpy()], [want.cpu().numpy()]) < CARD_TOL
