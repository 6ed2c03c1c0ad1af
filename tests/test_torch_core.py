"""Port parity: core (constants, precision, grids) and the trajectory model
of pyslice_tpu_torch against pyslice_tpu, on the same NumPy inputs."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from pyslice_tpu.core import constants as jconst
from pyslice_tpu.core import grids as jgrids
from pyslice_tpu.data.trajectory import Trajectory as JTrajectory
from pyslice_tpu_torch.core import constants as tconst
from pyslice_tpu_torch.core import dtypes as tdtypes
from pyslice_tpu_torch.core import grids as tgrids
from pyslice_tpu_torch.data.trajectory import Trajectory as TTrajectory

from fixtures import hbn_thermal

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("eV", [60e3, 100e3, 300e3])
def test_constants_equal_jax(eV):
    assert tconst.wavelength(eV) == jconst.wavelength(eV)
    assert tconst.interaction_parameter(eV) == jconst.interaction_parameter(eV)
    assert tconst.m_effective(eV) == jconst.m_effective(eV)


def _grid_fields(g):
    return dict(xs=g.xs, ys=g.ys, zs=g.zs, lx=g.lx, ly=g.ly, lz=g.lz,
                dz=g.dz, kxs=g.kxs(), kys=g.kys(),
                kxn=g.kxs_nominal_shifted(), kyn=g.kys_nominal_shifted(),
                ksq=g.ksq2d(), area=g.pixel_area, fast=g.fast_grid,
                oblique=g.is_oblique)


def _assert_same_grid(gt, gj):
    ft, fj = _grid_fields(gt), _grid_fields(gj)
    for k in fj:
        np.testing.assert_array_equal(np.asarray(ft[k]), np.asarray(fj[k]),
                                      err_msg=k)


@pytest.mark.parametrize("box", [(10.0, 12.3, 6.784),
                                 (102.35, 102.35, 6.784),
                                 (5.0, 7.5, 0.4)])
@pytest.mark.parametrize("fast_grid", [False, True])
def test_grid_from_box_equals_jax(box, fast_grid):
    gt = tgrids.grid_from_box(*box, sampling=0.1, slice_thickness=0.5,
                              fast_grid=fast_grid)
    gj = jgrids.grid_from_box(*box, sampling=0.1, slice_thickness=0.5,
                              fast_grid=fast_grid)
    _assert_same_grid(gt, gj)
    # int(l/s)+1 and endpoint=False (quirk 15)
    assert gt.nx == (int(box[0] / 0.1) + 1 if not fast_grid
                     else -(-(int(box[0] / 0.1) + 1) // 128) * 128)
    assert gt.xs[-1] < box[0]


def test_oblique_grid_equals_jax():
    box = np.array([[8.0, 2.5, 0.0], [0.0, 7.0, 0.0], [0.0, 0.0, 5.0]])
    gt = tgrids.grid_from_box_matrix(box, sampling=0.2)
    gj = jgrids.grid_from_box_matrix(box, sampling=0.2)
    _assert_same_grid(gt, gj)
    np.testing.assert_array_equal(gt.recip2d(), gj.recip2d())
    with pytest.raises(ValueError, match="out-of-plane"):
        tgrids.grid_from_box_matrix(np.array([[8.0, 0, 1.0], [0, 7.0, 0],
                                              [0, 0, 5.0]]))


def test_grid_from_trajectory_equals_jax():
    traj = hbn_thermal(n_frames=2)
    gt = tgrids.grid_from_trajectory(traj, sampling=0.1)
    gj = jgrids.grid_from_trajectory(traj, sampling=0.1)
    _assert_same_grid(gt, gj)
    assert tgrids.gridFromTrajectory(traj)[3] == jgrids.gridFromTrajectory(traj)[3]


def test_precision_policy():
    assert tdtypes.get_precision() is tdtypes.SINGLE
    assert tdtypes.get_precision("double") is tdtypes.DOUBLE
    assert tdtypes.get_precision("complex64").complex == torch.complex64
    assert tdtypes.DOUBLE.name == "double" and tdtypes.SINGLE.name == "single"
    with pytest.raises(ValueError):
        tdtypes.get_precision("half")
    # TF32 is off once the package is imported
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    x = tdtypes.as_real(np.array([0.1], np.float64), tdtypes.SINGLE, "cpu")
    assert x.dtype == torch.float32 and x.item() == np.float32(0.1)


def test_port_imports_neither_jax_nor_pyslice_tpu():
    code = ("import sys, pyslice_tpu_torch; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'pyslice_tpu')]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)


def _both_trajectories(traj):
    kw = dict(atom_types=traj.atom_types, positions=traj.positions,
              velocities=traj.velocities, box_matrix=traj.box_matrix,
              timestep=traj.timestep)
    return TTrajectory(**kw), JTrajectory(**kw)


@pytest.mark.parametrize("op", ["tile", "slice_positions", "slice_timesteps",
                                "mean"])
def test_trajectory_transforms_equal_jax(op):
    tt, tj = _both_trajectories(hbn_thermal(n_frames=3))
    if op == "mean":
        np.testing.assert_array_equal(tt.get_mean_positions(),
                                      tj.get_mean_positions())
        return
    if op == "tile":
        a, b = tt.tile_positions((2, 1, 1)), tj.tile_positions((2, 1, 1))
    elif op == "slice_positions":
        a = tt.slice_positions(x_range=(0.0, 3.0), z_range=(0.0, 5.0))
        b = tj.slice_positions(x_range=(0.0, 3.0), z_range=(0.0, 5.0))
    else:
        a, b = tt.slice_timesteps([2, 0]), tj.slice_timesteps([2, 0])
    for f in ("atom_types", "positions", "velocities", "box_matrix"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert (a.n_frames, a.n_atoms) == (b.n_frames, b.n_atoms)


def test_trajectory_validation_messages():
    with pytest.raises(ValueError, match="Atom count mismatch"):
        TTrajectory(atom_types=[5, 7], positions=np.zeros((1, 3, 3)),
                    velocities=np.zeros((1, 3, 3)), box_matrix=np.eye(3),
                    timestep=1.0)
    tt, _ = _both_trajectories(hbn_thermal(n_frames=1))
    with pytest.raises(ValueError, match="out of range"):
        tt.slice_timesteps([5])


@pytest.mark.parametrize("distribution", ["uniform", "gaussian"])
def test_random_displacements_take_a_generator(distribution):
    tt, _ = _both_trajectories(hbn_thermal(n_frames=1))
    a = tt.generate_random_displacements(
        4, 0.05, distribution, generator=torch.Generator().manual_seed(3))
    b = tt.generate_random_displacements(
        4, 0.05, distribution, generator=torch.Generator().manual_seed(3))
    np.testing.assert_array_equal(a.positions, b.positions)
    d = a.positions - tt.positions[0]
    assert a.positions.shape == (4, tt.n_atoms, 3)
    if distribution == "uniform":      # the reference's [0, sigma) quirk
        assert d.min() >= 0.0 and d.max() < 0.05
    else:
        assert abs(d.mean()) < 0.01 and 0.03 < d.std() < 0.07
    np.testing.assert_array_equal(a.velocities[3], tt.velocities[0])
