"""Port parity: Kirkland form factors and the projected-potential
rasterizer of pyslice_tpu_torch against pyslice_tpu (JAX on the CPU, x64),
fed the same NumPy frames and the same plan (carried by interop)."""

import dataclasses

import numpy as np
import pytest
import torch

from pyslice_tpu.core.dtypes import DOUBLE as JDOUBLE, SINGLE as JSINGLE
from pyslice_tpu.core.grids import grid_from_box_matrix, grid_from_trajectory
from pyslice_tpu.physics import kirkland as jkirk
from pyslice_tpu.physics import potential as jpot
from pyslice_tpu_torch import interop
from pyslice_tpu_torch.core.dtypes import DOUBLE, SINGLE
from pyslice_tpu_torch.physics import kirkland as tkirk
from pyslice_tpu_torch.physics import potential as tpot

from fixtures import hbn_stack, hbn_thermal

torch.set_num_threads(2)


def _fields(plan):
    return {f.name: getattr(plan, f.name) for f in dataclasses.fields(plan)}


def _plans(traj, sampling=0.25, **kw):
    g = grid_from_trajectory(traj, sampling=sampling)
    args = (g.xs, g.ys, g.zs, traj.positions, traj.atom_types)
    return tpot.make_plan(*args, **kw), jpot.make_plan(*args, **kw)


def _assert_plans_equal(pt, pj):
    ft, fj = _fields(pt), _fields(pj)
    assert ft.keys() == fj.keys()
    for k in fj:
        if fj[k] is None:
            assert ft[k] is None, k
        else:
            np.testing.assert_array_equal(np.asarray(ft[k]),
                                          np.asarray(fj[k]), err_msg=k)


def test_kirkland_table_and_form_factor_equal_jax():
    np.testing.assert_array_equal(tkirk.load_parameters(),
                                  jkirk.load_parameters())
    assert tkirk.element_to_z("Tl") == jkirk.element_to_z("Tl") == 81
    with pytest.raises(ValueError):
        tkirk.element_to_z("Tl", compat_reference_tl=True)
    qsq = np.linspace(0.0, 30.0, 257).reshape(1, -1)
    for z in (5, 7, np.array([1, 14, 79])):
        got = tkirk.form_factor(torch.as_tensor(qsq), z).numpy()
        want = np.asarray(jkirk.form_factor(qsq, z))
        np.testing.assert_allclose(got, want, rtol=1e-13)


@pytest.mark.parametrize("case", ["thermal", "stack", "pad_dwf", "names"])
def test_make_plan_fields_equal_jax(case):
    if case == "thermal":
        pt, pj = _plans(hbn_thermal(n_frames=3))
    elif case == "stack":
        pt, pj = _plans(hbn_stack(n_layers=3))
    elif case == "pad_dwf":
        pt, pj = _plans(hbn_thermal(n_frames=2), pad_fraction=0.5,
                        debye_waller={"B": 0.4, 7: 0.3})
    else:
        traj = hbn_thermal(n_frames=2)
        traj.atom_types = np.where(traj.atom_types == 5, "B", "N")
        pt, pj = _plans(traj)
    _assert_plans_equal(pt, pj)


def test_oblique_make_plan_equal_jax():
    traj = hbn_thermal(n_frames=2)
    box = np.array([[5.008, 1.2, 0.0], [0.0, 8.67, 0.0], [0.0, 0.0, 6.784]])
    g = grid_from_box_matrix(box, sampling=0.25)
    args = (g.xs, g.ys, g.zs, traj.positions, traj.atom_types)
    _assert_plans_equal(tpot.make_plan(*args, cell2d=g.cell2d),
                        jpot.make_plan(*args, cell2d=g.cell2d))


def _rasterize_both(traj, frame, jprec, tprec, **kw):
    _, pj = _plans(traj, **kw)
    pt = interop.plan_from_numpy(_fields(pj))
    pos = traj.positions[frame]
    want = np.asarray(jpot.rasterize(pos, pj, jprec))
    got = tpot.rasterize(pos, pt, tprec, device="cpu").numpy()
    return got, want


@pytest.mark.parametrize("frame", [0, 2])
@pytest.mark.parametrize("case", ["thermal", "stack_dwf"])
def test_rasterize_complex128_equals_jax(frame, case):
    if case == "thermal":
        traj, kw = hbn_thermal(n_frames=3), {}
    else:
        traj, kw = hbn_stack(n_layers=3), {"debye_waller": {"N": 0.5}}
        traj = traj.generate_random_displacements(3, 0.05, seed=1)
    got, want = _rasterize_both(traj, frame, JDOUBLE, DOUBLE, **kw)
    assert got.dtype == np.float64 and got.shape == want.shape
    assert np.abs(got - want).max() / np.abs(want).max() <= 1e-10


def test_rasterize_complex64_equals_jax():
    got, want = _rasterize_both(hbn_thermal(n_frames=2), 1, JSINGLE, SINGLE)
    assert got.dtype == np.float32
    assert np.abs(got - want).max() / np.abs(want).max() <= 1e-5


def test_rasterize_oblique_equals_jax():
    traj = hbn_thermal(n_frames=1)
    box = np.array([[5.008, 1.2, 0.0], [0.0, 8.67, 0.0], [0.0, 0.0, 6.784]])
    g = grid_from_box_matrix(box, sampling=0.25)
    args = (g.xs, g.ys, g.zs, traj.positions, traj.atom_types)
    pj = jpot.make_plan(*args, cell2d=g.cell2d)
    pt = interop.plan_from_numpy(_fields(pj))
    want = np.asarray(jpot.rasterize(traj.positions[0], pj, JDOUBLE))
    got = tpot.rasterize(traj.positions[0], pt, DOUBLE, device="cpu").numpy()
    assert np.abs(got - want).max() / np.abs(want).max() <= 1e-10


def test_uncovered_frame_is_nan_poisoned():
    traj = hbn_thermal(n_frames=2)
    pt, pj = _plans(traj)
    moved = traj.positions[0].copy()
    moved[:3, 2] += 2.5               # into slices the plan never saw
    got = tpot.rasterize(moved, pt, DOUBLE, device="cpu").numpy()
    want = np.asarray(jpot.rasterize(moved, pj, JDOUBLE))
    assert np.isnan(got).all() and np.isnan(want).all()
    with pytest.raises(ValueError, match="not covered"):
        tpot.validate_frame(moved, pt)
    tpot.validate_frame(traj.positions[1], pt)     # covered: no error
    assert np.isfinite(tpot.rasterize(traj.positions[1], pt, DOUBLE,
                                      device="cpu").numpy()).all()


def test_overfull_bucket_is_nan_poisoned():
    traj = hbn_stack(n_layers=3)
    pt, pj = _plans(traj)
    crowded = traj.positions[0].copy()
    z = np.unique(np.round(crowded[:, 2], 6))
    crowded[np.isclose(crowded[:, 2], z[2]), 2] = z[1]   # layer 3 -> layer 2
    with pytest.raises(ValueError, match="overflows"):
        tpot.validate_frame(crowded, pt)
    got = tpot.rasterize(crowded, pt, DOUBLE, device="cpu").numpy()
    want = np.asarray(jpot.rasterize(crowded, pj, JDOUBLE))
    assert np.isnan(got).all() and np.isnan(want).all()


def test_plan_from_numpy_rejects_unknown_fields():
    _, pj = _plans(hbn_thermal(n_frames=1))
    f = _fields(pj)
    f["bogus"] = 1
    with pytest.raises(ValueError, match="bogus"):
        interop.plan_from_numpy(f)
