"""The port's native LAMMPS dump parser (io/native_loader.py and its own
copy of native/fast_dump.cpp): the build lands in the git-ignored
native/build/ under a content-hash name; native, Python and the JAX
package's native arrays are bit-equal; triclinic and scaled-coordinate
dumps and a failed build go to the Python parser, and ``last_parser`` says
so; image flags unwrap; TrajectoryLoader and TrajectoryStream take the
native path. (No timing bar here: chip_smoke.py phase 20 prints both
parsers' times.)"""

import gzip
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest

from pyslice_tpu.io import native_loader as jnative
from pyslice_tpu.io.stream import TrajectoryStream as JStream
from pyslice_tpu_torch.io import lammps as tlammps
from pyslice_tpu_torch.io import loader as tloader
from pyslice_tpu_torch.io import native_loader as tnative
from pyslice_tpu_torch.io.stream import TrajectoryStream
from tests.fixtures import hbn_thermal

REPO = Path(__file__).resolve().parent.parent
TRICLINIC = ("ITEM: TIMESTEP\n0\nITEM: NUMBER OF ATOMS\n1\n"
             "ITEM: BOX BOUNDS xy xz yz pp pp pp\n"
             "0.0 11.0 1.0\n0.0 5.0 0.0\n0.0 8.0 0.0\n"
             "ITEM: ATOMS id type x y z\n1 1 1.0 1.0 1.0\n")
SCALED = ("ITEM: TIMESTEP\n0\nITEM: NUMBER OF ATOMS\n1\n"
          "ITEM: BOX BOUNDS pp pp pp\n0 4.0\n0 5.0\n0 8.0\n"
          "ITEM: ATOMS id type xs ys zs\n1 1 0.25 0.5 0.125\n")
IMAGES = ("ITEM: TIMESTEP\n0\nITEM: NUMBER OF ATOMS\n1\n"
          "ITEM: BOX BOUNDS pp pp pp\n0 10.0\n0 10.0\n0 10.0\n"
          "ITEM: ATOMS id type x y z ix iy iz\n"
          "1 1 1.0 2.0 3.0 1 0 -1\n")


def _same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert np.asarray(g).dtype == np.asarray(w).dtype
        np.testing.assert_array_equal(g, w)


@pytest.fixture(scope="module")
def dump_file(tmp_path_factory):
    """A 10-frame hBN dump whose atoms drift through the boundary (the
    continuity unwrap runs), written by the port's writer."""
    traj = hbn_thermal(n_frames=10, sigma=0.05, nx=3, ny=3)
    pos = traj.positions.copy()
    pos[:, 0, 0] += np.linspace(0.0, 3.0, 10)
    wrapped = np.mod(pos, np.diag(traj.box_matrix))
    path = tmp_path_factory.mktemp("native") / "t.lammpstrj"
    tlammps.write_lammps_dump(path, traj.atom_types, wrapped,
                              traj.velocities, traj.box_matrix)
    return path


def test_build_lands_in_ignored_dir():
    lib = tnative.get_lib()
    assert lib is not None, "the native parser failed to build"
    path = tnative.library_path()
    assert path.exists()
    assert path.parent == REPO / "pyslice_tpu_torch/io/native/build"
    # named by the source's content hash and the flags
    assert path.name.startswith("libfast_dump_") and path.suffix == ".so"
    assert "build/" in (REPO / ".gitignore").read_text().splitlines()
    if (REPO / ".git").exists() and shutil.which("git"):
        rc = subprocess.run(["git", "check-ignore", "-q", str(path)],
                            cwd=REPO).returncode
        assert rc == 0, "the native build is not git-ignored"


def test_library_name_follows_source_and_flags(monkeypatch):
    base = tnative.library_path()
    monkeypatch.setattr(tnative, "CXX_FLAGS", tnative.CXX_FLAGS + ("-g",))
    assert tnative.library_path() != base


def test_native_python_and_jax_bit_equal(dump_file):
    native = tnative.parse_lammps_dump_native(dump_file)
    assert native is not None
    _same(native, tlammps.parse_lammps_dump(dump_file))
    _same(native, jnative.parse_lammps_dump_native(dump_file))
    got = tnative.parse_dump(dump_file)
    assert tnative.last_parser == "native"
    _same(got, native)


@pytest.mark.parametrize("text", [TRICLINIC, SCALED],
                         ids=["triclinic", "scaled"])
def test_unsupported_layouts_go_to_python(text, tmp_path):
    p = tmp_path / "d.lammpstrj"
    p.write_text(text)
    assert tnative.parse_lammps_dump_native(p) is None
    assert jnative.parse_lammps_dump_native(p) is None
    got = tloader.parse_any(p)
    assert tnative.last_parser == "python"
    _same(got, tlammps.parse_lammps_dump(p))


def test_image_flags(tmp_path):
    p = tmp_path / "i.lammpstrj"
    p.write_text(IMAGES)
    out = tnative.parse_lammps_dump_native(p)
    assert out is not None
    np.testing.assert_allclose(out[1][0, 0], [11.0, 2.0, -7.0])
    _same(out, jnative.parse_lammps_dump_native(p))
    _same(out, tlammps.parse_lammps_dump(p))


def test_failed_build_falls_back_to_python(dump_file, tmp_path,
                                           monkeypatch):
    """No g++: get_lib is None, the Python parser runs, the arrays are the
    same and last_parser says "python"."""
    def no_compiler(*args, **kwargs):
        raise FileNotFoundError("g++")
    monkeypatch.setattr(tnative, "_lib_handle", None)
    monkeypatch.setattr(tnative, "_build_failed", False)
    monkeypatch.setattr(tnative, "_BUILD_DIR", tmp_path)
    monkeypatch.setattr(tnative, "library_path",
                        lambda: tmp_path / "libfast_dump_missing.so")
    monkeypatch.setattr(tnative.subprocess, "run", no_compiler)
    assert tnative.get_lib() is None
    got = tnative.parse_dump(dump_file)
    assert tnative.last_parser == "python"
    _same(got, tlammps.parse_lammps_dump(dump_file))
    assert tnative.iter_frames_native(dump_file) is None


def test_loader_takes_native_path(dump_file):
    t = tloader.TrajectoryLoader(dump_file, use_cache=False).load()
    assert tnative.last_parser == "native"
    np.testing.assert_array_equal(
        t.positions, tlammps.parse_lammps_dump(dump_file)[1])


@pytest.mark.parametrize("gz", [False, True])
def test_stream_takes_native_path(dump_file, tmp_path, gz):
    """TrajectoryStream streams a plain-text dump through the native
    incremental parser (a gzipped one through the Python iterator), with
    the JAX package's stream's blocks, bit for bit."""
    path = dump_file
    if gz:
        path = tmp_path / "t.lammpstrj.gz"
        with open(dump_file, "rb") as src, gzip.open(path, "wb") as dst:
            shutil.copyfileobj(src, dst)
    kw = dict(timestep=0.005, block_frames=4, prefetch=0)
    stream = TrajectoryStream(path, **kw)
    assert stream.count_frames() == 10
    got = list(stream.blocks())
    assert tnative.last_parser == ("python" if gz else "native")
    want = list(JStream(path, **kw).blocks())
    assert len(got) == len(want) == 3
    for (gi, gb), (wi, wb) in zip(got, want):
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gb, wb)
