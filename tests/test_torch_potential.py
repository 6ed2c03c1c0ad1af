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
            assert np.asarray(ft[k]).dtype == np.asarray(fj[k]).dtype, k


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


def _near_edges(edges):
    """Coordinates on each float64 edge, its float64 neighbours, its float32
    value, one float32 ulp either side of that, and the float64 midpoints
    between those float32 values (which round to even)."""
    up, down = np.float32(np.inf), np.float32(-np.inf)
    out = []
    for e in edges:
        c = np.float32(e)
        lo, hi = np.nextafter(c, down), np.nextafter(c, up)
        out += [e, np.nextafter(e, -np.inf), np.nextafter(e, np.inf),
                c, lo, hi, (np.float64(lo) + np.float64(c)) / 2,
                (np.float64(c) + np.float64(hi)) / 2]
    return np.array(out, dtype=np.float64)


def _one_pass_inputs(case):
    """(xs, ys, zs, positions, atom types, make_plan keywords) of one case;
    the binned coordinates are set per case, the others drawn in the box."""
    g = grid_from_trajectory(hbn_thermal(n_frames=1), sampling=0.25)
    axis = {"axis0": 0, "axis1": 1}.get(case, 2)
    coords = [g.xs, g.ys, g.zs][axis]
    edges = tpot.slice_edges(coords, coords[1] - coords[0])
    top = edges[-1]
    values = {
        "outside": np.array([-1.0, -1e-3, -0.0, 0.0, top, top + 1e-9,
                             top + 1.0, edges[2] + 0.1, edges[-2]]),
        "empty": np.array([-2.0, -1e-12, top, top + 3.0]),
        "nonfinite": np.array([np.nan, np.inf, -np.inf, edges[1],
                               edges[3] + 0.2]),
    }.get(case, None)
    if values is None:
        values = _near_edges(edges)
    n_frames = {"2d": 1, "chunks": 7}.get(case, 3)
    rng = np.random.default_rng(len(case))
    box = np.array([g.lx, g.ly, g.lz])
    pos = rng.random((n_frames, len(values), 3)) * box
    pos[:, :, axis] = [rng.permutation(values) for _ in range(n_frames)]
    types = rng.choice([5, 7, 14], size=len(values))
    if case == "2d":
        pos = pos[0]
    return g.xs, g.ys, g.zs, pos, types, {"slice_axis": axis}


@pytest.mark.parametrize("search", ["compare", "binary"])
@pytest.mark.parametrize("case", ["edges", "outside", "2d", "axis0", "axis1",
                                  "empty", "chunks", "nonfinite"])
def test_one_pass_plan_equals_jax_loop(case, search, monkeypatch):
    """make_plan bins all frames in one pass per chunk; the JAX package's
    plan bins frame by frame, both casts, so every field must agree."""
    monkeypatch.setattr(tpot, "_COMPARE_BOUNDS",
                        10 ** 6 if search == "compare" else 0)
    if case == "chunks":
        monkeypatch.setattr(tpot, "PLAN_CHUNK_ATOMS", 300)
    *args, kw = _one_pass_inputs(case)
    pt, pj = tpot.make_plan(*args, **kw), jpot.make_plan(*args, **kw)
    _assert_plans_equal(pt, pj)
    if case in ("edges", "axis0", "axis1"):
        # Each atom beside one below the slab: the plan is that atom's
        # buckets in both casts, and the frame's range spans every bound
        # up to it.
        xs, ys, zs, pos, types = args
        below = pos[0, 0].copy()
        below[kw["slice_axis"]] = -1.0
        for atom in pos[0]:
            one = (xs, ys, zs, np.stack([below, atom]), types[:2])
            _assert_plans_equal(tpot.make_plan(*one, **kw),
                                jpot.make_plan(*one, **kw))
    if case == "empty":
        assert pt.a_max == 8 and pt.bucket_types[0] == 0


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
