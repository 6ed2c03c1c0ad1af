"""Port parity: trajectory ingest (pyslice_tpu_torch.io) against
pyslice_tpu.io on the same files. Every input is copied into tmp_path
first: the loader writes its .npy cache next to the input."""

import gzip
import shutil
from pathlib import Path

import numpy as np
import pytest

import pyslice_tpu as jt
import pyslice_tpu_torch as tt
from pyslice_tpu.io import cif as jcif
from pyslice_tpu.io import lammps as jlammps
from pyslice_tpu.io import loader as jloader
from pyslice_tpu.io import xyz as jxyz
from pyslice_tpu_torch.io import cif as tcif
from pyslice_tpu_torch.io import lammps as tlammps
from pyslice_tpu_torch.io import loader as tloader
from pyslice_tpu_torch.io import xyz as txyz

from fixtures import hbn_thermal

MONOLAYER = Path(__file__).resolve().parent.parent / "examples" / \
    "monolayer.lammpstrj"

CIF = """data_hbn
_cell_length_a 2.504
_cell_length_b 2.504
_cell_length_c 6.784
_cell_angle_alpha 90
_cell_angle_beta 90
_cell_angle_gamma 120
loop_
_symmetry_equiv_pos_as_xyz
'x, y, z'
'-x, -y, z+1/2'
loop_
_atom_site_label
_atom_site_type_symbol
_atom_site_fract_x
_atom_site_fract_y
_atom_site_fract_z
B1 B 0.3333 0.6667 0.25
N1 N 0.6667 0.3333 0.25
"""


def _same(got, want):
    """Byte-identical arrays (dtype, shape and values)."""
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def _thermal_dump(path, writer=jlammps.write_lammps_dump, n_frames=4):
    j = hbn_thermal(n_frames=n_frames)
    writer(path, j.atom_types, j.positions, j.velocities, j.box_matrix)
    return j


def _make(kind, tmp_path):
    """One input file of ``kind`` in tmp_path, written by the JAX package."""
    if kind == "monolayer":
        p = tmp_path / "monolayer.lammpstrj"
        shutil.copy(MONOLAYER, p)
    elif kind == "thermal":
        p = tmp_path / "thermal.lammpstrj"
        _thermal_dump(p)
    elif kind == "gzip":
        p = tmp_path / "monolayer.lammpstrj.gz"
        p.write_bytes(gzip.compress(MONOLAYER.read_bytes()))
    elif kind == "binary":
        p = tmp_path / "thermal.bin"
        j = hbn_thermal(n_frames=3)
        jlammps.write_lammps_dump_binary(p, j.atom_types, j.positions,
                                         j.velocities, j.box_matrix)
    elif kind == "xyz":
        p = tmp_path / "thermal.xyz"
        j = hbn_thermal(n_frames=3)
        jxyz.write_xyz(p, j.atom_types, j.positions, j.box_matrix,
                       j.velocities)
    else:
        p = tmp_path / "hbn.cif"
        p.write_text(CIF)
    return p


KINDS = ["monolayer", "thermal", "gzip", "binary", "xyz", "cif"]


@pytest.mark.parametrize("kind", KINDS)
def test_parse_any_equals_jax(kind, tmp_path):
    p = _make(kind, tmp_path)
    _same(tloader.parse_any(p), jloader.parse_any(p))


@pytest.mark.parametrize("kind", KINDS)
def test_loader_equals_jax(kind, tmp_path):
    p = _make(kind, tmp_path)
    # separate copies, so neither package reads the other's cache
    pj = tmp_path / "jax"
    pt = tmp_path / "port"
    pj.mkdir()
    pt.mkdir()
    shutil.copy(p, pj / p.name)
    shutil.copy(p, pt / p.name)
    mapping = None if kind in ("xyz", "cif") else {1: "B", 2: "N"}
    want = jt.TrajectoryLoader(pj / p.name, timestep=0.005,
                               atom_mapping=mapping).load()
    got = tt.TrajectoryLoader(pt / p.name, timestep=0.005,
                              atom_mapping=mapping).load()
    assert isinstance(got, tt.Trajectory)
    _same((got.atom_types, got.positions, got.velocities, got.box_matrix),
          (want.atom_types, want.positions, want.velocities, want.box_matrix))
    assert got.timestep == want.timestep
    # a second load comes from the cache, and equals the first
    again = tt.TrajectoryLoader(pt / p.name, timestep=0.005,
                                atom_mapping=mapping).load()
    _same((again.atom_types, again.positions), (got.atom_types, got.positions))


def test_parsers_equal_jax(tmp_path):
    p = _make("thermal", tmp_path)
    _same(tlammps.parse_lammps_dump(p), jlammps.parse_lammps_dump(p))
    b = _make("binary", tmp_path)
    _same(tlammps.parse_lammps_dump_binary(b),
          jlammps.parse_lammps_dump_binary(b))
    x = _make("xyz", tmp_path)
    _same(txyz.parse_xyz(x), jxyz.parse_xyz(x))
    c = _make("cif", tmp_path)
    _same(tcif.parse_cif(c), jcif.parse_cif(c))
    pos = np.cumsum(np.random.default_rng(0).uniform(-2, 2, (6, 5, 3)), 0)
    box = np.diag([4.0, 5.0, 6.0])
    wrapped = np.mod(pos, 4.0)
    _same([tlammps.unwrap_continuity(wrapped, box)],
          [jlammps.unwrap_continuity(wrapped, box)])
    _same([tlammps.stitch_continuity(pos[0], wrapped, box)],
          [jlammps.stitch_continuity(pos[0], wrapped, box)])


def test_write_lammps_dump_round_trip(tmp_path):
    j = _thermal_dump(tmp_path / "port.lammpstrj", tlammps.write_lammps_dump)
    _thermal_dump(tmp_path / "jax.lammpstrj")
    assert ((tmp_path / "port.lammpstrj").read_bytes()
            == (tmp_path / "jax.lammpstrj").read_bytes())
    got = tt.TrajectoryLoader(tmp_path / "port.lammpstrj", timestep=0.005,
                              atom_mapping={5: 5, 7: 7}).load()
    np.testing.assert_array_equal(got.atom_types, j.atom_types)
    np.testing.assert_allclose(got.positions, j.positions, rtol=1e-7,
                               atol=1e-7)      # the dump's %.8g
    np.testing.assert_allclose(got.box_matrix, j.box_matrix, rtol=1e-9)


def test_cache_keeps_raw_types(tmp_path):
    p = _make("monolayer", tmp_path)
    first = tt.TrajectoryLoader(p, atom_mapping={1: "B", 2: "N"}).load()
    cache = sorted(q.name for q in tmp_path.glob("*.npy"))
    assert cache == [f"monolayer.{k}.npy" for k in
                     ("atom_types", "box_matrix", "positions", "velocities")]
    np.testing.assert_array_equal(np.load(tmp_path / cache[0]) < 3, True)
    second = tt.TrajectoryLoader(p, atom_mapping={1: 6, 2: "O"}).load()
    assert set(first.atom_types) == {5, 7}
    assert set(second.atom_types) == {6, 8}
    np.testing.assert_array_equal(second.positions, first.positions)
    raw = tt.TrajectoryLoader(p).load()
    assert set(raw.atom_types) == {1, 2}


def test_multi_file_pattern_equals_jax(tmp_path):
    j = hbn_thermal(n_frames=6)
    for d in ("jax", "port"):
        (tmp_path / d).mkdir()
        for i, sl in enumerate((slice(0, 2), slice(2, 4), slice(4, 6))):
            jlammps.write_lammps_dump(
                tmp_path / d / f"dump.{i * 10}.lammpstrj", j.atom_types,
                j.positions[sl], j.velocities[sl], j.box_matrix)
    want = jt.TrajectoryLoader(str(tmp_path / "jax" / "dump.*.lammpstrj")
                               ).load()
    got = tt.TrajectoryLoader(str(tmp_path / "port" / "dump.*.lammpstrj")
                              ).load()
    assert got.positions.shape == (6, j.n_atoms, 3)
    _same((got.atom_types, got.positions, got.velocities),
          (want.atom_types, want.positions, want.velocities))


@pytest.mark.parametrize("name", ["POSCAR", "x.vasp", "x.nc", "x.gsd"])
def test_unported_formats_raise(name, tmp_path):
    p = tmp_path / name
    p.write_text("placeholder\n")
    with pytest.raises(NotImplementedError, match="queue 1, item 15"):
        tloader.parse_any(p)


def test_loader_argument_errors(tmp_path):
    with pytest.raises(FileNotFoundError):
        tt.TrajectoryLoader(tmp_path / "missing.lammpstrj")
    with pytest.raises(ValueError, match="timestep"):
        tt.TrajectoryLoader(_make("monolayer", tmp_path), timestep=-1.0)
    with pytest.raises(ValueError, match="Invalid atomic number"):
        tt.TrajectoryLoader(_make("monolayer", tmp_path),
                            atom_mapping={1: 200})
