"""The plain reference against the program's plain path, in float64 on
the CPU at a small size: the same physics gives the same numbers. (The
test imports both; the reference itself imports nothing of the
program.)"""

import numpy as np
import pytest
import torch

import inputs
import pyslice_tpu_torch as pt
from conftest import TINY_BOX
from pyslice_tpu_torch.engine.pipeline import SimSpec, frame_exit_waves
from reference import plain

LZ, LAYER, EV, MRAD = 6.784, 1.913, 100e3, 30.0
TOL = 1e-10
BASE, TYPES = inputs.hbn_box(TINY_BOX, LAYER)
FRAMES = inputs.thermal_frames(BASE, 8, 0.05, 2 ** 31 + 7, inputs.JOB, 0)
POS = [(3.0, 4.0), (9.0, 4.5), (4.0, 10.0)]
REF_GRID = plain.Grid(TINY_BOX, TINY_BOX, LZ, 0.1, 0.5)
GRID = pt.grid_from_box(TINY_BOX, TINY_BOX, LZ, sampling=0.1,
                        slice_thickness=0.5)
PLAN = pt.make_plan(GRID.xs, GRID.ys, GRID.zs, FRAMES, TYPES)
SPEC = SimSpec.create(GRID, PLAN, EV, precision="double")


def rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def port_probes(mrad=MRAD, pos=POS):
    base = pt.Probe(GRID.xs, GRID.ys, mrad, EV, precision="double",
                    device="cpu")
    return pt.create_batched_probes(base, pos).array


def ref_waves(frame, mrad=MRAD, pos=POS):
    v = plain.potential(frame, TYPES, REF_GRID, plain.TRUTH, "cpu")
    psi = plain.probes(REF_GRID, mrad, EV, pos, plain.TRUTH, "cpu")
    return plain.exit_waves(psi, v, REF_GRID, EV, plain.TRUTH)


def test_grids_agree():
    assert (REF_GRID.nx, REF_GRID.nz) == (GRID.nx, GRID.nz)
    assert REF_GRID.dx == pytest.approx(GRID.dx, rel=1e-15)
    assert REF_GRID.dz == pytest.approx(GRID.dz, rel=1e-15)
    assert np.allclose(REF_GRID.edges(), PLAN.edges, rtol=0, atol=1e-15)


def test_potential():
    got = pt.rasterize(FRAMES[0], PLAN, "double", device="cpu")
    want = plain.potential(FRAMES[0], TYPES, REF_GRID, plain.TRUTH, "cpu")
    assert rel(got, want) < TOL


@pytest.mark.parametrize("mrad", [0.0, MRAD])
def test_probes_and_exit_waves(mrad):
    pos = POS if mrad else [(TINY_BOX / 2, TINY_BOX / 2)]
    assert rel(port_probes(mrad, pos),
               plain.probes(REF_GRID, mrad, EV, pos, plain.TRUTH,
                            "cpu")) < TOL
    got = frame_exit_waves(FRAMES[1], port_probes(mrad, pos), SPEC)[..., 0]
    assert rel(got, ref_waves(FRAMES[1], mrad, pos)) < TOL


def test_tacaw_maps_and_haadf():
    traj = pt.Trajectory(atom_types=TYPES, positions=FRAMES,
                         velocities=np.zeros_like(FRAMES),
                         box_matrix=np.diag([TINY_BOX, TINY_BOX, LZ]),
                         timestep=0.005)
    grid_pos = [(x, y) for y in (3.0, 9.0) for x in (2.0, 10.0)]
    calc = pt.MultisliceCalculator(device="cpu", precision="double")
    calc.setup(traj, aperture=MRAD, voltage_eV=EV, probe_positions=grid_pos,
               device_output=True, use_cache=False)
    wf = calc.run(progress=False)
    tac = pt.TACAWData(wf)
    adf = pt.HAADFData(wf).calculateADF(45)
    waves = torch.stack([ref_waves(f, MRAD, grid_pos) for f in FRAMES], 1)
    inten = torch.stack([plain.tacaw_intensity(w) for w in waves])
    assert rel(tac.spectrum(), inten.sum(dim=(2, 3)).mean(0)) < TOL
    assert rel(tac.diffraction(), inten.sum(dim=1).mean(0)) < TOL
    mask = torch.as_tensor(plain.adf_mask(REF_GRID, 45, EV))
    collected = (waves.abs() * mask).sum(dim=(2, 3)).mean(1)
    assert rel(adf, plain.adf_image(collected.numpy(), grid_pos)) < TOL


def test_stream_bins():
    n, freqs = 40, [10.0, 20.0, 40.0]
    frames = inputs.thermal_frames(BASE, n, 0.05, 5, inputs.STREAM_BLOCK)
    order = np.random.default_rng(3).permutation(n)
    st = pt.StreamingTACAW(SPEC, port_probes(), n, 0.005,
                           frequencies=freqs, probe_chunk=2)
    for b in range(0, n, 4):
        st.add_frame_block(order[b:b + 4].tolist(), frames[order[b:b + 4]])
    bins = plain.stream_bins(n, 0.005, freqs)
    assert list(bins) == list(st.bins)
    w = plain.phase_weights(np.arange(n), bins, n)
    waves = torch.stack([ref_waves(f) for f in frames])      # (t, P, ...)
    acc = torch.einsum("tf,tpxy->fpxy", torch.as_tensor(w), waves)
    want = torch.stack([plain.dft_intensity(
        acc[:, p], waves[:, p].sum(0), torch.as_tensor(w.sum(0)), n)
        for p in range(len(POS))], 1)
    assert rel(st.intensity(), want) < TOL
