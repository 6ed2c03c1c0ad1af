"""Port parity for streaming ingest (io/stream.py): the port's
TrajectoryStream against pyslice_tpu's (with the JAX package's native
parser off, the Python iterator both share) and against the port's eager
TrajectoryLoader, over text, .gz, binary and multi-file dumps; the guards;
the prefetch thread's end when a consumer stops early; and a stream
feeding StreamingTACAW equal to the eager frames feeding it."""

import gzip
import shutil
import threading

import numpy as np
import pytest
import torch

from pyslice_tpu.io import native_loader
from pyslice_tpu.io.stream import TrajectoryStream as JStream

import pyslice_tpu_torch as tt
from pyslice_tpu_torch.engine.pipeline import SimSpec
from pyslice_tpu_torch.io.lammps import (write_lammps_dump,
                                         write_lammps_dump_binary)
from pyslice_tpu_torch.io.stream import TrajectoryStream

torch.set_num_threads(2)


def _traj(n_frames=10, n_atoms=6, seed=0, crossing=True):
    """Wrapped trajectory with atoms drifting through the boundary."""
    rng = np.random.default_rng(seed)
    box = np.array([8.0, 9.0, 10.0])
    base = rng.random((n_atoms, 3)) * box
    drift = rng.normal(0, 0.2, (n_atoms, 3))
    if crossing:
        drift[0] = (0.9, 0.0, 0.0)                # marches through x
    pos = np.stack([base + t * drift for t in range(n_frames)])
    wrapped = np.mod(pos, box)
    types = rng.integers(1, 3, n_atoms).astype(np.int32)
    vel = np.zeros_like(pos)
    return types, wrapped, vel, np.diag(box)


def _concat_blocks(stream):
    idx_all, blocks = [], []
    for idx, block in stream.blocks():
        idx_all.append(idx)
        blocks.append(block)
    return np.concatenate(idx_all), np.concatenate(blocks)


@pytest.fixture
def no_native(monkeypatch):
    """The JAX stream on its Python frame iterator, the port's only one."""
    monkeypatch.setattr(native_loader, "get_lib", lambda: None)


@pytest.mark.parametrize("prefetch", [0, 2])
def test_stream_matches_loader_and_jax_text(tmp_path, prefetch, no_native):
    types, wrapped, vel, box = _traj()
    f = tmp_path / "dump.lammpstrj"
    write_lammps_dump(f, types, wrapped, vel, box)
    eager = tt.TrajectoryLoader(str(f), use_cache=False).load()
    st = TrajectoryStream(str(f), block_frames=3, prefetch=prefetch)
    idx, pos = _concat_blocks(st)
    np.testing.assert_array_equal(idx, np.arange(10))
    # per-frame stitching sums deltas incrementally; the eager unwrap uses
    # one cumsum — identical math, f64 summation-order noise only
    np.testing.assert_allclose(pos, eager.positions, rtol=0, atol=1e-12)
    np.testing.assert_array_equal(st.atom_types, eager.atom_types)
    np.testing.assert_array_equal(st.box_matrix, eager.box_matrix)
    assert st.count_frames() == 10
    assert pos[-1, 0, 0] > 8.0        # the continuity unwrap engaged
    jidx, jpos = _concat_blocks(JStream(str(f), block_frames=3,
                                        prefetch=prefetch))
    np.testing.assert_array_equal(idx, jidx)
    np.testing.assert_array_equal(pos, jpos)


def test_stream_matches_loader_gz_and_multifile(tmp_path, no_native):
    types, wrapped, vel, box = _traj(n_frames=9)
    paths = []
    for k in range(3):
        f = tmp_path / f"dump.{k}.lammpstrj"
        write_lammps_dump(f, types, wrapped[3 * k:3 * k + 3], vel[:3], box)
        paths.append(f)
    gz = paths[1].with_suffix(".lammpstrj.gz")
    with open(paths[1], "rb") as src, gzip.open(gz, "wb") as dst:
        shutil.copyfileobj(src, dst)
    paths[1].unlink()
    files = [str(paths[0]), str(gz), str(paths[2])]
    eager = tt.TrajectoryLoader(files, use_cache=False).load()
    st = TrajectoryStream(files, block_frames=2)
    idx, pos = _concat_blocks(st)
    np.testing.assert_array_equal(idx, np.arange(9))
    np.testing.assert_allclose(pos, eager.positions, rtol=0, atol=1e-12)
    assert st.count_frames() == 9
    np.testing.assert_array_equal(
        pos, _concat_blocks(JStream(files, block_frames=2))[1])
    # a glob pattern resolves in natural order, as the loader does
    _, pat_pos = _concat_blocks(
        TrajectoryStream(str(tmp_path / "dump.*.lammpstrj*"),
                         block_frames=4))
    np.testing.assert_array_equal(pat_pos, pos)


def test_stream_binary_file(tmp_path):
    types, wrapped, vel, box = _traj(n_frames=5)
    f = tmp_path / "dump.bin"
    write_lammps_dump_binary(f, types, wrapped, vel, box)
    eager = tt.TrajectoryLoader(str(f), use_cache=False).load()
    st = TrajectoryStream(str(f), block_frames=2)
    idx, pos = _concat_blocks(st)
    np.testing.assert_allclose(pos, eager.positions, rtol=0, atol=1e-12)
    assert st.count_frames() == 5
    np.testing.assert_array_equal(
        pos, _concat_blocks(JStream(str(f), block_frames=2))[1])


@pytest.mark.parametrize("digits", [8, 17])
def test_dump_digits(tmp_path, digits):
    """The writer's 8 significant digits (the JAX package's format) round
    positions; 17 give them back exactly through the stream."""
    types, wrapped, vel, box = _traj(n_frames=2, crossing=False)
    wrapped = wrapped * 20.0                    # coordinates up to ~200 A
    f = tmp_path / "dump.lammpstrj"
    write_lammps_dump(f, types, wrapped, vel, box * 20.0, digits=digits)
    pos = _concat_blocks(TrajectoryStream(str(f), block_frames=2))[1]
    if digits == 17:
        np.testing.assert_array_equal(pos[0], wrapped[0])
    else:
        err = np.abs(pos[0] - wrapped[0]).max()
        assert 0 < err <= 5e-6
    np.testing.assert_allclose(pos, wrapped, rtol=0, atol=5e-6)


def test_stream_atom_mapping_and_errors(tmp_path):
    types, wrapped, vel, box = _traj(n_frames=4)
    f = tmp_path / "dump.lammpstrj"
    write_lammps_dump(f, types, wrapped, vel, box)
    st = TrajectoryStream(str(f), atom_mapping={1: "B", 2: 7},
                          block_frames=4)
    assert set(np.unique(st.atom_types)) <= {5, 7}
    np.testing.assert_array_equal(
        st.atom_types, JStream(str(f), atom_mapping={1: "B", 2: 7},
                               block_frames=4).atom_types)
    with pytest.raises(ValueError, match="block_frames"):
        TrajectoryStream(str(f), block_frames=0)
    with pytest.raises(FileNotFoundError):
        TrajectoryStream(str(tmp_path / "missing.lammpstrj"))


def test_stream_feeds_streaming_tacaw(tmp_path):
    """StreamingTACAW fed block by block from a TrajectoryStream equals the
    same engine fed from the eager loader's frames, bit for bit."""
    types, wrapped, vel, box = _traj(n_frames=8, n_atoms=5, crossing=False)
    f = tmp_path / "dump.lammpstrj.gz"
    plain = tmp_path / "dump.lammpstrj"
    write_lammps_dump(plain, types, wrapped, vel, box)
    with open(plain, "rb") as src, gzip.open(f, "wb") as dst:
        shutil.copyfileobj(src, dst)
    traj = tt.TrajectoryLoader(str(f), use_cache=False,
                               atom_mapping={1: 5, 2: 7}).load()
    grid = tt.grid_from_trajectory(traj, sampling=0.5, slice_thickness=2.0)
    plan = tt.make_plan(grid.xs, grid.ys, grid.zs, traj.positions,
                        traj.atom_types)
    spec = SimSpec.create(grid, plan, 100e3)
    probes = tt.Probe(grid.xs, grid.ys, 15.0, 100e3,
                      device="cpu").array[None]

    def run(frame_source):
        st = tt.StreamingTACAW(spec, probes, 8, timestep=0.005,
                               frequencies=[0.0, 25.0])
        for idx, pos in frame_source:
            st.add_frame_block(list(idx), pos)
        return st.spectrum()

    eager_blocks = [(np.arange(4 * k, 4 * k + 4),
                     traj.positions[4 * k:4 * k + 4]) for k in range(2)]
    stream = TrajectoryStream(str(f), atom_mapping={1: 5, 2: 7},
                              block_frames=4)
    np.testing.assert_array_equal(run(eager_blocks), run(stream.blocks()))


def _write_dump(path, types, wrapped, box, scales, flagged):
    """A text dump whose frame t has its box scaled by scales[t] and image
    flag columns when flagged[t]."""
    with open(path, "w") as fh:
        for t in range(len(scales)):
            fh.write("ITEM: TIMESTEP\n%d\n" % t)
            fh.write("ITEM: NUMBER OF ATOMS\n%d\n" % wrapped.shape[1])
            fh.write("ITEM: BOX BOUNDS pp pp pp\n")
            for d in range(3):
                fh.write("0.0 %.6f\n" % (box[d, d] * scales[t]))
            flags = " ix iy iz" if flagged[t] else ""
            fh.write("ITEM: ATOMS id type x y z%s\n" % flags)
            for a in range(wrapped.shape[1]):
                fh.write("%d %d %.6f %.6f %.6f%s\n"
                         % (a + 1, types[a], *wrapped[t, a],
                            " 0 0 0" if flagged[t] else ""))


def test_stream_guards(tmp_path):
    """Loud failures where parity with the eager loader is impossible:
    NPT, mixed flag layouts in one file, a multi-file type mismatch, a
    file without frames."""
    types, wrapped, vel, box = _traj(n_frames=4, crossing=False)
    npt = tmp_path / "npt.lammpstrj"
    _write_dump(npt, types, wrapped, box, [1.0 + 0.05 * t for t in range(4)],
                [False] * 4)
    with pytest.raises(ValueError, match="box changed"):
        _concat_blocks(TrajectoryStream(str(npt), block_frames=2))
    mixed = tmp_path / "mixed.lammpstrj"
    _write_dump(mixed, types, wrapped, box, [1.0] * 4,
                [t < 2 for t in range(4)])
    with pytest.raises(ValueError, match="mix image-flag"):
        _concat_blocks(TrajectoryStream(str(mixed), block_frames=2))

    fa, fb = tmp_path / "a.lammpstrj", tmp_path / "b.lammpstrj"
    write_lammps_dump(fa, types, wrapped[:2], vel[:2], box)
    types_b = types.copy()
    types_b[0] = 3 - types_b[0]       # swap a species
    write_lammps_dump(fb, types_b, wrapped[2:], vel[:2], box)
    with pytest.raises(ValueError, match="types differ"):
        _concat_blocks(TrajectoryStream([str(fa), str(fb)], block_frames=2))

    empty = tmp_path / "empty.lammpstrj"
    empty.write_text("# not a dump\n")
    with pytest.raises(ValueError, match="No frames found"):
        TrajectoryStream(str(empty))


def _prefetch_threads():
    return [t for t in threading.enumerate()
            if t.name == "pyslice-stream-prefetch"]


@pytest.mark.parametrize("how", ["break", "raise", "close"])
def test_prefetch_thread_ends_when_the_consumer_stops(tmp_path, how):
    """A consumer that stops early (a break, an exception, close()) ends
    the prefetch thread before the generator returns: no thread is left,
    with no waiting."""
    types, wrapped, vel, box = _traj(n_frames=20, crossing=False)
    f = tmp_path / "big.lammpstrj"
    write_lammps_dump(f, types, wrapped, vel, box)
    st = TrajectoryStream(str(f), block_frames=1, prefetch=1)
    if how == "break":
        for _ in st.blocks():
            break
    elif how == "raise":
        with pytest.raises(KeyError):
            for _ in st.blocks():
                raise KeyError("consumer failed")
    else:
        gen = st.blocks()
        next(gen)
        assert len(_prefetch_threads()) == 1
        gen.close()
    assert _prefetch_threads() == []
    # and a full pass afterwards still yields every frame
    assert len(_concat_blocks(st)[0]) == 20
    assert _prefetch_threads() == []
