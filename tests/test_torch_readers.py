"""Port parity: the VASP, AMBER NetCDF and GSD readers of pyslice_tpu_torch
(io/vasp.py, io/amber.py, io/gsd.py) against pyslice_tpu's on the cases of
tests/test_io.py's TestVASP, TestAmberNetCDF and TestGSD — every returned
array bit-equal, every rejection the same — and TrajectoryLoader on each
suffix those readers take."""

import numpy as np
import pytest

from pyslice_tpu.io import amber as jamber
from pyslice_tpu.io import gsd as jgsd
from pyslice_tpu.io import vasp as jvasp
from pyslice_tpu.io.loader import TrajectoryLoader as JLoader
from pyslice_tpu_torch.io import amber as tamber
from pyslice_tpu_torch.io import gsd as tgsd
from pyslice_tpu_torch.io import vasp as tvasp
from pyslice_tpu_torch.io.loader import TrajectoryLoader as TLoader

POSCAR5 = """hBN-ish test cell
1.0
4.0 0.0 0.0
0.0 5.0 0.0
0.0 0.0 6.0
B N
1 2
Direct
0.0 0.0 0.25
0.5 0.5 0.75
0.25 0.25 0.5
"""
CARTESIAN = """t
2.0
2.0 0.0 0.0
0.0 2.5 0.0
0.0 0.0 3.0
B N
1 1
Selective dynamics
Cartesian
0.1 0.2 0.3 T T T
0.4 0.5 0.6 F F F
"""
XDATCAR = """t
1.0
4.0 0.0 0.0
0.0 4.0 0.0
0.0 0.0 4.0
B
1
Direct configuration=     1
0.0 0.0 0.0
Direct configuration=     2
0.25 0.0 0.0
Direct configuration=     3
0.5 0.0 0.0
"""
VASP_CASES = {
    "vasp5_direct": ("POSCAR", POSCAR5),
    "negative_scale": ("POSCAR", POSCAR5.replace("1.0\n4.0", "-960.0\n4.0")),
    "vasp4_numeric_types": ("POSCAR", POSCAR5.replace("B N\n", "")),
    "cartesian_selective": ("test.vasp", CARTESIAN),
    "velocities": ("POSCAR", POSCAR5
                   + "\n0.1 0.0 0.0\n0.0 0.2 0.0\n0.0 0.0 0.3\n"),
    "xdatcar_multiframe": ("XDATCAR", XDATCAR),
}


def _same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def _same_error(path, port_fn, jax_fn, match):
    with pytest.raises(ValueError, match=match) as ge:
        port_fn(path)
    with pytest.raises(ValueError, match=match) as we:
        jax_fn(path)
    assert str(ge.value) == str(we.value)


# --- VASP --------------------------------------------------------------------


@pytest.mark.parametrize("case", list(VASP_CASES))
def test_vasp_matches_jax(case, tmp_path):
    name, text = VASP_CASES[case]
    p = tmp_path / name
    p.write_text(text)
    got = tvasp.parse_poscar(p)
    _same(got, jvasp.parse_poscar(p))
    types, pos, vel, box = got
    if case == "vasp5_direct":
        np.testing.assert_array_equal(types, [5, 7, 7])
        np.testing.assert_allclose(pos[0, 1], [2.0, 2.5, 4.5])
    elif case == "negative_scale":
        assert abs(np.linalg.det(box)) == pytest.approx(960.0)
    elif case == "vasp4_numeric_types":
        np.testing.assert_array_equal(types, [1, 2, 2])
    elif case == "cartesian_selective":
        np.testing.assert_allclose(pos[0, 0], [0.2, 0.4, 0.6])
    elif case == "velocities":
        np.testing.assert_allclose(vel[0, 1], [0.0, 0.2, 0.0])
    else:
        np.testing.assert_allclose(pos[:, 0, 0], [0.0, 1.0, 2.0])


def test_vasp_truncated_matches_jax(tmp_path):
    p = tmp_path / "POSCAR"
    p.write_text("\n".join(POSCAR5.splitlines()[:9]) + "\n")
    _same_error(p, tvasp.parse_poscar, jvasp.parse_poscar, "truncated")


# --- AMBER NetCDF -------------------------------------------------------------


def _write_nc(path, pos, vel=None, lengths=None, angles=None,
              conventions="AMBER", vel_scale=None):
    """tests/test_io.py's AMBER-convention NetCDF-3 fixture."""
    from scipy.io import netcdf_file
    n_f, n_a, _ = pos.shape
    with netcdf_file(str(path), "w") as f:
        f.Conventions = conventions
        f.ConventionVersion = "1.0"
        f.createDimension("frame", None)
        f.createDimension("atom", n_a)
        f.createDimension("spatial", 3)
        f.createDimension("cell_spatial", 3)
        f.createDimension("cell_angular", 3)
        v = f.createVariable("coordinates", "f", ("frame", "atom",
                                                  "spatial"))
        v[:] = pos.astype(np.float32)
        if vel is not None:
            w = f.createVariable("velocities", "f", ("frame", "atom",
                                                     "spatial"))
            w[:] = (vel if vel_scale is None else vel / vel_scale).astype(
                np.float32)
            if vel_scale is not None:
                w.scale_factor = np.float32(vel_scale)
        if lengths is not None:
            c = f.createVariable("cell_lengths", "d", ("frame",
                                                       "cell_spatial"))
            c[:] = np.asarray(lengths, np.float64)
            a = f.createVariable("cell_angles", "d", ("frame",
                                                      "cell_angular"))
            a[:] = (np.asarray(angles, np.float64) if angles is not None
                    else np.full((n_f, 3), 90.0))


def _amber_case(case, tmp_path):
    rng = np.random.default_rng(0)
    p = tmp_path / "t.nc"
    if case == "cell_and_velocities":
        pos = rng.random((5, 7, 3)) * 10.0
        _write_nc(p, pos, rng.standard_normal((5, 7, 3)),
                  lengths=np.tile([10.0, 12.0, 14.0], (5, 1)),
                  vel_scale=20.455)
    elif case == "triclinic_cell":
        _write_nc(p, rng.random((2, 3, 3)) * 8.0,
                  lengths=np.tile([8.0, 9.0, 10.0], (2, 1)),
                  angles=np.tile([80.0, 95.0, 110.0], (2, 1)))
    elif case == "no_cell":
        _write_nc(p, np.array([[[0.0, 0.0, 0.0], [4.0, 2.0, 3.0]]]))
    else:                                           # not AMBER-tagged
        _write_nc(p, rng.random((1, 2, 3)), conventions="OTHER",
                  lengths=np.tile([5.0, 5.0, 5.0], (1, 1)))
    return p


@pytest.mark.parametrize("case", ["cell_and_velocities", "triclinic_cell",
                                  "no_cell", "other_conventions"])
def test_amber_matches_jax(case, tmp_path):
    p = _amber_case(case, tmp_path)
    got = tamber.parse_amber_netcdf(p)
    _same(got, jamber.parse_amber_netcdf(p))
    if case == "no_cell":
        np.testing.assert_allclose(np.diag(got[3]), [4.0, 2.0, 3.0])


def test_amber_rejections_match_jax(tmp_path):
    from scipy.io import netcdf_file
    p = tmp_path / "npt.nc"
    _write_nc(p, np.zeros((2, 3, 3)),
              lengths=np.array([[10.0, 10.0, 10.0], [10.5, 10.0, 10.0]]))
    _same_error(p, tamber.parse_amber_netcdf, jamber.parse_amber_netcdf,
                "NPT")
    q = tmp_path / "x.nc"
    with netcdf_file(str(q), "w") as f:
        f.createDimension("n", 2)
        v = f.createVariable("other", "d", ("n",))
        v[:] = [1.0, 2.0]
    _same_error(q, tamber.parse_amber_netcdf, jamber.parse_amber_netcdf,
                "coordinates")


# --- GSD ---------------------------------------------------------------------

BOX = np.diag([10.0, 12.0, 14.0])


def _gsd_fixture(writer, path, n_f=3, n_a=5, seed=0, **kw):
    rng = np.random.default_rng(seed)
    pos = rng.random((n_f, n_a, 3)) * np.diag(BOX)
    vel = rng.standard_normal((n_f, n_a, 3))
    writer.write_gsd(path, pos, BOX, velocities=vel, **kw)
    return pos


@pytest.mark.parametrize("layer", [(1, 0), (2, 0)])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_gsd_roundtrip_both_layers_and_writers(layer, writer, tmp_path):
    """A file written by either package's write_gsd reads the same,
    bit for bit, through both readers."""
    p = tmp_path / "t.gsd"
    pos = _gsd_fixture(tgsd if writer == "port" else jgsd, p,
                       gsd_version=layer, type_names=["B", "N"],
                       typeid=np.array([0, 1, 1, 0, 1]))
    got = tgsd.parse_gsd(p)
    _same(got, jgsd.parse_gsd(p))
    np.testing.assert_array_equal(got[0], [5, 7, 7, 5, 7])
    np.testing.assert_allclose(got[1], pos, atol=1e-5)


@pytest.mark.parametrize("case", ["image_flags", "triclinic", "frame0"])
def test_gsd_cases_match_jax(case, tmp_path):
    p = tmp_path / f"{case}.gsd"
    if case == "image_flags":
        unwrapped = np.array([[[1.0, 2.0, 3.0], [9.5, -2.0, 19.0]]])
        image = np.floor(unwrapped / 8.0).astype(np.int32)
        tgsd.write_gsd(p, unwrapped - image * 8.0, np.diag([8.0] * 3),
                       image=image)
    elif case == "triclinic":
        box = np.array([[10.0, 1.5, 0.4], [0.0, 12.0, 0.8],
                        [0.0, 0.0, 14.0]])
        tgsd.write_gsd(p, np.array([[[1.0, 2.0, 3.0], [4.0, 5.0, 6.0]]]),
                       box)
    else:              # typeid/types/N at frame 0 only apply to all frames
        _gsd_fixture(tgsd, p, type_names=["Si"],
                     typeid=np.zeros(5, np.uint32))
        f = tgsd.GSDFile(p)
        assert f.n_frames == 3 and not f.chunk_exists(2, "particles/typeid")
    got = tgsd.parse_gsd(p)
    _same(got, jgsd.parse_gsd(p))
    if case == "image_flags":
        np.testing.assert_allclose(got[1], [[[1.0, 2.0, 3.0],
                                             [9.5, -2.0, 19.0]]], atol=1e-5)


@pytest.mark.parametrize("case", ["npt", "bad_magic", "truncated",
                                  "hostile_header", "2d"])
def test_gsd_rejections_match_jax(case, tmp_path):
    p = tmp_path / "x.gsd"
    match = {"npt": "NPT", "bad_magic": "magic", "truncated": "truncated|GSD",
             "hostile_header": "beyond", "2d": "2-D"}[case]
    if case == "npt":
        _gsd_fixture(tgsd, p, extra_chunks=[
            (1, "configuration/box",
             np.array([11.0, 12.0, 14.0, 0, 0, 0], np.float32))])
    elif case == "bad_magic":
        p.write_bytes(b"\x00" * 256)
    elif case == "truncated":
        _gsd_fixture(tgsd, p)
        loc, n, m, dt = tgsd.GSDFile(p).index[(2, "particles/position")]
        with open(p, "r+b") as fh:
            fh.truncate(loc + (n * m * dt.itemsize) // 2)
    elif case == "hostile_header":
        _gsd_fixture(tgsd, p)
        with open(p, "r+b") as fh:      # idx_n lives at header bytes 16:24
            fh.seek(16)
            fh.write((1 << 40).to_bytes(8, "little"))
    else:
        tgsd.write_gsd(p, np.zeros((1, 2, 3)), np.diag([8.0, 8.0, 0.0]),
                       extra_chunks=[(0, "configuration/dimensions",
                                      np.array([2], np.uint8))])
    _same_error(p, tgsd.parse_gsd, jgsd.parse_gsd, match)


# --- TrajectoryLoader on every suffix ----------------------------------------


@pytest.mark.parametrize("name", ["POSCAR", "CONTCAR", "XDATCAR_run",
                                  "cell.vasp", "cell.poscar", "run.nc",
                                  "run.ncdf", "run.netcdf", "run.gsd"])
def test_loader_dispatch_matches_jax(name, tmp_path):
    p = tmp_path / name
    mapping = None
    if name.endswith((".nc", ".ncdf", ".netcdf")):
        _write_nc(p, np.random.default_rng(1).random((3, 4, 3)) * 8.0,
                  lengths=np.tile([8.0, 8.0, 8.0], (3, 1)))
        mapping = {1: "Si"}
    elif name.endswith(".gsd"):
        _gsd_fixture(tgsd, p, type_names=["A", "B2"],
                     typeid=np.array([0, 1, 0, 1, 0]))
        mapping = {1: "Si", 2: "C"}
    else:
        p.write_text(XDATCAR if name.startswith("XDATCAR") else POSCAR5)
    got = TLoader(p, timestep=0.002, atom_mapping=mapping,
                  use_cache=False).load()
    want = JLoader(p, timestep=0.002, atom_mapping=mapping,
                   use_cache=False).load()
    for f in ("atom_types", "positions", "velocities", "box_matrix"):
        np.testing.assert_array_equal(np.asarray(getattr(got, f)),
                                      np.asarray(getattr(want, f)))
    if name.endswith(".gsd"):
        np.testing.assert_array_equal(got.atom_types, [14, 6, 14, 6, 14])
    elif mapping:
        np.testing.assert_array_equal(got.atom_types, [14] * 4)
