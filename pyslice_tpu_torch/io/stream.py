"""Streaming trajectory ingest: frame blocks without loading everything.

Counterpart of ``pyslice_tpu/io/stream.py``. ``TrajectoryLoader``
materializes the whole trajectory ((n_frames, n_atoms, 3) float64) before
anything runs; the streaming engines (``engine/streaming.py``) consume it
in frame blocks anyway. ``TrajectoryStream`` iterates a LAMMPS dump (text,
.gz, binary, multi-file patterns: the surface the eager loader resolves)
one frame block at a time with O(block) memory, and a background prefetch
thread parses the next block while the card computes on the current one.

Unwrapping matches the eager loader (``io/loader.py``,
``io/lammps.py::_finalize_frames``) for the supported layouts:

* frames carrying image flags unwrap absolutely (pos + i @ box.T);
* frames without flags unwrap by frame-to-frame minimum-image continuity
  (per streamed frame, ``stitch_continuity(prev, frame)`` is the
  recursion ``unwrap_continuity`` applies to a stacked array);
* at every file seam the block is stitched against the previous file's
  last frame (the loader's multi-file rule).

Where streaming cannot reproduce the loader, it raises: a box that changes
between frames (NPT), and a single file mixing flagged and flagless
frames. Plain-text dumps of the common layout stream through the native
incremental parser (``io.native_loader.iter_frames_native``); gzipped or
other layouts through the Python frame iterator, which gives the same
arrays. ``native_loader.last_parser`` names the parser of the latest file.

Typical wiring with the streaming engines::

    stream = TrajectoryStream("dump.*.lammpstrj.gz", timestep=0.005,
                              atom_mapping={1: "B", 2: "N"},
                              block_frames=8)
    st = StreamingTACAW(spec, probes, stream.count_frames(), ...)
    for idx, pos in stream.blocks():
        st.add_frame_block(list(idx), pos)
"""

from __future__ import annotations

import gzip
import queue
import threading
from pathlib import Path
from typing import Iterator, Optional, Tuple

import numpy as np

from . import lammps as lammps_io
from . import native_loader
from .loader import TrajectoryLoader, parse_any


def _is_gz(path: Path) -> bool:
    with open(path, "rb") as fh:
        return fh.read(2) == b"\x1f\x8b"


def _is_binary_dump(path: Path) -> bool:
    opener = gzip.open if _is_gz(path) else open
    with opener(path, "rb") as fh:
        return b"\x00" in fh.read(256)


def _is_streamable_lammps(path: Path) -> bool:
    """Text LAMMPS dumps (plain or gzipped) stream frame by frame; every
    other format (binary dumps, xyz, cif) parses eagerly per file."""
    suffixes = [s.lower() for s in path.suffixes]
    kind = (suffixes[-2] if suffixes and suffixes[-1] == ".gz"
            and len(suffixes) > 1 else (suffixes[-1] if suffixes else ""))
    if kind in (".cif", ".xyz", ".bin", ".lammpsbin"):
        return False
    return not _is_binary_dump(path)


class _LineReader:
    def __init__(self, fh, path):
        self.fh = fh
        self.path = path
        self.no = 0                      # 1-based number of the last line

    def next(self) -> Optional[str]:
        line = self.fh.readline()
        if not line:
            return None
        self.no += 1
        return line.rstrip("\n")

    def need(self, what: str) -> str:
        line = self.next()
        if line is None:
            raise ValueError(f"{self.path}: line {self.no + 1}: expected "
                             f"{what} (unexpected EOF)")
        return line


def _open_text(path: Path):
    return (gzip.open(path, "rt") if _is_gz(path)
            else open(path, "r"))


def iter_lammps_text_frames(path):
    """Yield ``(pos, vel, images|None, types|None, box_matrix)`` per frame
    of a text dump, reading incrementally (the column and unwrap semantics
    of parse_lammps_dump; velocities zero when absent, positions wrapped —
    unwrapping is the caller's policy)."""
    path = Path(path)
    with _open_text(path) as fh:
        rd = _LineReader(fh, path)
        while True:
            line = rd.next()
            if line is None:
                return
            if not line.startswith("ITEM: TIMESTEP"):
                continue
            rd.need("a timestep value")
            hdr = rd.need("'ITEM: NUMBER OF ATOMS'")
            if not hdr.startswith("ITEM: NUMBER OF ATOMS"):
                raise ValueError(f"{path}: line {rd.no}: expected "
                                 f"'ITEM: NUMBER OF ATOMS' (got: {hdr!r})")
            try:
                n_atoms = int(rd.need("an atom count"))
            except ValueError:
                raise ValueError(f"{path}: line {rd.no}: expected an "
                                 "integer atom count") from None
            bhdr = rd.need("'ITEM: BOX BOUNDS'")
            if not bhdr.startswith("ITEM: BOX BOUNDS"):
                raise ValueError(f"{path}: line {rd.no}: expected "
                                 f"'ITEM: BOX BOUNDS' (got: {bhdr!r})")
            tilted = any(t in bhdr for t in ("xy", "xz", "yz"))
            bounds = [rd.need("box bounds") for _ in range(3)]
            try:
                box_matrix, origin = lammps_io._parse_box(bounds, tilted)
            except (ValueError, IndexError):
                raise ValueError(f"{path}: line {rd.no}: malformed BOX "
                                 "BOUNDS values") from None
            ahdr = rd.need("'ITEM: ATOMS'")
            if not ahdr.startswith("ITEM: ATOMS"):
                raise ValueError(f"{path}: line {rd.no}: expected "
                                 f"'ITEM: ATOMS' (got: {ahdr!r})")
            cols = ahdr.split()[2:]
            col = {c: j for j, c in enumerate(cols)}
            rows = [rd.need("an atom row").split() for _ in range(n_atoms)]

            def bad(msg, off, _base=rd.no - n_atoms):
                raise ValueError(f"{path}: line {_base + off + 1}: {msg}")

            block = lammps_io._build_atom_block(rows, cols, col, bad)
            pos, vel, images, types = lammps_io._frame_from_block(
                block, col, box_matrix, origin)
            yield pos, vel, images, types, box_matrix


def count_lammps_text_frames(path) -> int:
    n = 0
    with _open_text(Path(path)) as fh:
        for line in fh:
            if line.startswith("ITEM: TIMESTEP"):
                n += 1
    return n


class TrajectoryStream:
    """Iterate a trajectory in frame blocks with O(block) memory.

    Args:
        filename: one path, a glob pattern, or an explicit file list —
            the surface ``TrajectoryLoader`` resolves (natural file order).
        timestep: ps per frame (metadata, as the loader carries it).
        atom_mapping: {dump type: Z or element name}, as the loader.
        block_frames: frames per yielded block.
        prefetch: number of blocks the background parser may run ahead
            (0: no thread, fully synchronous).

    Construction reads the first frame for text dumps (eager formats parse
    their file once into a one-file cache shared with ``count_frames`` and
    ``blocks``); ``atom_types`` (mapped), ``box_matrix`` and ``n_atoms``
    are then available. Text frames are parsed again on every ``blocks()``
    or ``frames()`` iteration. Velocities are not carried (the streaming
    engines consume positions only).
    """

    def __init__(self, filename, timestep: float = 0.005,
                 atom_mapping=None, block_frames: int = 8,
                 prefetch: int = 2):
        self.filepaths = TrajectoryLoader._resolve_files(filename)
        self.timestep = float(timestep)
        self.block_frames = int(block_frames)
        if self.block_frames < 1:
            raise ValueError(f"block_frames must be >= 1, "
                             f"got {block_frames}")
        self.prefetch = int(prefetch)
        self._mapping = TrajectoryLoader._process_atom_mapping(atom_mapping)

        self._eager_cache = (None, None)   # (path, parse_any result)
        # count_frames() may run while the prefetch thread drives blocks();
        # both reach _parse_eager for eager-format files.
        self._eager_lock = threading.Lock()
        try:
            first = next(self._iter_raw_frames())
        except StopIteration:
            raise ValueError(
                f"No frames found in {self.filepaths[0]}") from None
        pos0, types0, box = first
        self.n_atoms = pos0.shape[0]
        self.box_matrix = np.asarray(box, dtype=np.float64)
        raw_types = (np.ones(self.n_atoms, np.int32) if types0 is None
                     else np.asarray(types0, np.int32))
        self.atom_types = self._map_types(raw_types)

    # -- internals ----------------------------------------------------------

    def _map_types(self, types: np.ndarray) -> np.ndarray:
        if self._mapping is None:
            return types
        mapped = types.copy()
        for t in np.unique(types):
            if int(t) in self._mapping:
                mapped[types == t] = self._mapping[int(t)]
        return mapped

    def _parse_eager(self, path):
        """parse_any with a one-file cache: at most one eager file is
        resident, and __init__ / count_frames / blocks() share its parse."""
        with self._eager_lock:
            cached_path, cached = self._eager_cache
            if cached_path == path:
                return cached
            parsed = parse_any(path)
            self._eager_cache = (path, parsed)
            return parsed

    def _check_types(self, types, path):
        if types is None:
            return
        if self._first_types is None:
            self._first_types = np.asarray(types, np.int32)
        elif not np.array_equal(np.asarray(types, np.int32),
                                self._first_types):
            raise ValueError(f"{path}: atom types differ from the first "
                             "file's — not one trajectory")

    def _check_box(self, box, path):
        box = np.asarray(box, np.float64)
        if self._first_box is None:
            self._first_box = box
        elif not np.allclose(box, self._first_box, rtol=1e-9, atol=1e-9):
            raise ValueError(
                f"{path}: the box changed between frames (NPT-style "
                "trajectory). The pipeline assumes one fixed cell "
                "(Trajectory carries a single box_matrix), and continuity "
                "unwrapping against a moving box is ill-defined — resample "
                "or rescale the trajectory to a fixed cell first.")

    def _iter_raw_frames(self):
        """Yield (unwrapped_pos, types|None, box) across all files, with
        the loader's unwrap and stitch rules applied frame by frame; a box
        that changes between frames and a file that mixes flagged and
        flagless frames raise."""
        self._first_types = getattr(self, "_first_types", None)
        self._first_box = getattr(self, "_first_box", None)
        prev_last = None
        for path in self.filepaths:
            if _is_streamable_lammps(path):
                frames = None if _is_gz(path) else \
                    native_loader.iter_frames_native(path)
                native_loader.last_parser = ("python" if frames is None
                                             else "native")
                if frames is None:
                    frames = iter_lammps_text_frames(path)
                # flag-unwrapped files get one constant per-atom seam shift
                # (the loader stitches whole file blocks), computed at the
                # file's first frame.
                file_shift = None
                file_has_flags = None
                for pos, vel, images, types, box in frames:
                    self._check_box(box, path)
                    self._check_types(types, path)
                    if file_has_flags is None:
                        file_has_flags = images is not None
                    elif file_has_flags != (images is not None):
                        raise ValueError(
                            f"{path}: frames mix image-flag and flagless "
                            "atom columns — unwrap policy is per file; "
                            "split the file or add flags everywhere")
                    if images is not None:
                        pos = pos + images @ np.asarray(box).T
                        if file_shift is None:
                            file_shift = (np.zeros_like(pos)
                                          if prev_last is None else
                                          lammps_io.stitch_continuity(
                                              prev_last, pos[None],
                                              np.asarray(box))[0] - pos)
                        pos = pos + file_shift
                    elif prev_last is not None:
                        pos = lammps_io.stitch_continuity(
                            prev_last, pos[None], np.asarray(box))[0]
                    prev_last = pos
                    yield pos, types, box
            else:
                types, pos_all, vel_all, box = self._parse_eager(path)
                self._check_box(box, path)
                self._check_types(types, path)
                # the eager parser already unwrapped within the file;
                # stitch its first frame against the running trajectory
                if prev_last is not None:
                    pos_all = lammps_io.stitch_continuity(
                        prev_last, pos_all, np.asarray(box))
                for f in range(pos_all.shape[0]):
                    prev_last = pos_all[f]
                    yield pos_all[f], types, box

    def _iter_blocks_sync(self):
        idx0 = 0
        buf = []
        for pos, types, box in self._iter_raw_frames():
            if pos.shape[0] != self.n_atoms:
                raise ValueError(
                    f"frame {idx0 + len(buf)} has {pos.shape[0]} atoms; "
                    f"the first frame had {self.n_atoms} — not one "
                    "trajectory")
            buf.append(pos)
            if len(buf) == self.block_frames:
                yield (np.arange(idx0, idx0 + len(buf)), np.stack(buf))
                idx0 += len(buf)
                buf = []
        if buf:
            yield (np.arange(idx0, idx0 + len(buf)), np.stack(buf))

    # -- public -------------------------------------------------------------

    def blocks(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """Yield ``(frame_indices (B,), positions (B, n_atoms, 3))`` —
        parsed ahead on a background thread when ``prefetch > 0``. A
        consumer that stops early (``break``, an exception, ``close()``)
        stops the thread, and the generator joins it before it returns."""
        if self.prefetch <= 0:
            yield from self._iter_blocks_sync()
            return
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        _END, _ERR = object(), object()

        def put_until_stopped(item):
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                for item in self._iter_blocks_sync():
                    if not put_until_stopped(item):
                        return
                put_until_stopped((_END, None))
            except BaseException as e:  # noqa: BLE001 — raised in blocks()
                put_until_stopped((_ERR, e))

        t = threading.Thread(target=worker, daemon=True,
                             name="pyslice-stream-prefetch")
        t.start()
        try:
            while True:
                item = q.get()
                if item[0] is _END:
                    return
                if item[0] is _ERR:
                    raise item[1]
                yield item
        finally:
            stop.set()
            t.join()

    def frames(self) -> Iterator[Tuple[int, np.ndarray]]:
        """Yield ``(frame_index, positions (n_atoms, 3))``."""
        for idx, block in self.blocks():
            for k in range(len(idx)):
                yield int(idx[k]), block[k]

    def count_frames(self) -> int:
        """Total frame count (a header scan for text dumps; eager formats
        parse their file once)."""
        total = 0
        for path in self.filepaths:
            if _is_streamable_lammps(path):
                scanned = None if _is_gz(path) else \
                    native_loader.scan_dump_native(path)
                total += (scanned[0] if scanned is not None
                          else count_lammps_text_frames(path))
            else:
                total += self._parse_eager(path)[1].shape[0]
        return total
