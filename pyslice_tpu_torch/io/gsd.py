"""HOOMD-blue GSD trajectory reader (.gsd), pure NumPy.

Counterpart of ``pyslice_tpu/io/gsd.py``, line for line (host NumPy;
the original PySlice reads GSD through OVITO); this reads the GSD binary
container (glotzerlab "GSD File Layer" specification, file layers 1.x and
2.0) and the HOOMD schema natively — no ``gsd`` package needed.

File layer (little-endian throughout):

* 256-byte header: magic ``0x65DF65DF65DF65DF``, index location/size,
  namelist location/size, schema version, file-layer version, and two
  64-byte application/schema strings.
* Index: packed 32-byte entries ``(frame u64, N u64, location i64,
  M u32, id u16, type u8, flags u8)``, sorted by (frame, id); allocated
  but unused entries have ``location == 0``.
* Namelist: layer 1.x stores fixed 64-byte zero-padded names; layer 2.0
  condenses it to concatenated NUL-terminated strings. ``id`` indexes
  the nth name in both layouts.

HOOMD schema chunks consumed (defaults per the HOOMD schema spec):
``configuration/box`` (lx ly lz xy xz yz; tilt factors are
DIMENSIONLESS — box column vectors are [lx,0,0], [xy*ly, ly, 0],
[xz*lz, yz*lz, lz]), ``particles/N``, ``particles/position`` (box frame
centered at the origin), ``particles/typeid`` + ``particles/types``
(fixed-width UTF-8 rows), ``particles/image`` (periodic image flags),
``particles/velocity``. A chunk absent from frame i falls back to its
frame-0 value, per the schema's convention.

Positions are unwrapped with the image flags (r + box @ image) when
present and shifted so the box origin is 0 — the convention every other
reader in this package emits (io/lammps.py). HOOMD atom counts and the
box must be constant across frames (same fixed-box policy as the AMBER
reader; NPT files raise).
"""

from __future__ import annotations

import logging
import os
import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

logger = logging.getLogger(__name__)

GSD_MAGIC = 0x65DF65DF65DF65DF
_HEADER = struct.Struct("<QQQQQII64s64s80s")
_ENTRY = struct.Struct("<QQqIHBB")

# GSD type enum -> NumPy dtype (spec section "Data types").
_TYPES = {1: np.uint8, 2: np.uint16, 3: np.uint32, 4: np.uint64,
          5: np.int8, 6: np.int16, 7: np.int32, 8: np.int64,
          9: np.float32, 10: np.float64}
_TYPE_IDS = {np.dtype(v): k for k, v in _TYPES.items()}


class GSDFile:
    """Minimal read-only view of one GSD file: header, index, namelist,
    and chunk reads with the HOOMD frame-0 fallback."""

    def __init__(self, path):
        self.path = str(path)
        with open(self.path, "rb") as fh:
            raw = fh.read(_HEADER.size)
            if len(raw) < _HEADER.size:
                raise ValueError(f"{path}: truncated GSD header")
            (magic, idx_loc, idx_n, nm_loc, nm_n, self.schema_version,
             self.gsd_version, app, schema, _) = _HEADER.unpack(raw)
            if magic != GSD_MAGIC:
                raise ValueError(f"{path}: bad GSD magic "
                                 f"{magic:#x} (not a GSD file)")
            self.application = app.split(b"\x00", 1)[0].decode("utf-8",
                                                               "replace")
            self.schema = schema.split(b"\x00", 1)[0].decode("utf-8",
                                                             "replace")
            # Header-declared counts drive allocations below; bound them
            # against the actual file size so a corrupt/hostile header
            # can't trigger a multi-GB read.
            fsize = os.path.getsize(self.path)
            if (nm_loc + nm_n * 64 > fsize
                    or idx_loc + idx_n * _ENTRY.size > fsize):
                raise ValueError(
                    f"{path}: GSD header declares namelist/index regions "
                    f"beyond the {fsize}-byte file (namelist {nm_loc}+"
                    f"{nm_n}*64, index {idx_loc}+{idx_n}*{_ENTRY.size})")
            fh.seek(nm_loc)
            nm_raw = fh.read(nm_n * 64)
            fh.seek(idx_loc)
            idx_raw = fh.read(idx_n * _ENTRY.size)
        self.names = self._parse_namelist(nm_raw)
        # (frame, name) -> (location, N, M, dtype); location==0 ends the
        # used prefix of the allocated index (spec: entries are packed).
        self.index: Dict[Tuple[int, str], Tuple[int, int, int, np.dtype]] = {}
        self.n_frames = 0
        for off in range(0, len(idx_raw) - _ENTRY.size + 1, _ENTRY.size):
            frame, n, loc, m, nid, typ, _ = _ENTRY.unpack_from(idx_raw, off)
            if loc == 0:
                break
            if nid >= len(self.names):
                raise ValueError(f"{path}: index id {nid} outside the "
                                 f"{len(self.names)}-entry namelist")
            if typ not in _TYPES:
                raise ValueError(f"{path}: unknown GSD data type {typ}")
            self.index[(frame, self.names[nid])] = (loc, n, m,
                                                    np.dtype(_TYPES[typ]))
            self.n_frames = max(self.n_frames, frame + 1)

    def _parse_namelist(self, raw: bytes) -> List[str]:
        if (self.gsd_version >> 16) >= 2:
            # Layer 2.0: concatenated NUL-terminated strings; the list
            # ends at the first empty name.
            names = []
            for part in raw.split(b"\x00"):
                if not part:
                    break
                names.append(part.decode("utf-8", "replace"))
            return names
        return [raw[i:i + 64].split(b"\x00", 1)[0].decode("utf-8", "replace")
                for i in range(0, len(raw), 64)
                if raw[i:i + 64].split(b"\x00", 1)[0]]

    def chunk_exists(self, frame: int, name: str) -> bool:
        return (frame, name) in self.index

    def read_chunk(self, frame: int, name: str) -> Optional[np.ndarray]:
        """Chunk data as (N, M) (or (N,) when M == 1); frame-0 fallback;
        None when the chunk exists nowhere."""
        key = (frame, name)
        if key not in self.index:
            key = (0, name)
            if key not in self.index:
                return None
        loc, n, m, dtype = self.index[key]
        with open(self.path, "rb") as fh:
            fh.seek(loc)
            raw = fh.read(n * m * dtype.itemsize)
        if len(raw) != n * m * dtype.itemsize:
            raise ValueError(f"{self.path}: chunk {name!r} frame {key[0]} "
                             "truncated")
        arr = np.frombuffer(raw, dtype=dtype)
        return arr.reshape(n, m) if m > 1 else arr


def _box_matrix(box6: np.ndarray) -> np.ndarray:
    lx, ly, lz, xy, xz, yz = [float(v) for v in box6]
    return np.array([[lx, xy * ly, xz * lz],
                     [0.0, ly, yz * lz],
                     [0.0, 0.0, lz]], dtype=np.float64)


def parse_gsd(path) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Returns (atom_types (n,), positions (n_frames, n, 3) Angstrom,
    velocities (n_frames, n, 3), box (3, 3)).

    atom_types are atomic numbers when every ``particles/types`` name is
    an element symbol; otherwise 1-based HOOMD type ids, to be remapped
    via ``TrajectoryLoader(atom_mapping=...)`` (same policy as type-only
    LAMMPS dumps)."""
    f = GSDFile(path)
    if f.n_frames == 0:
        raise ValueError(f"{path}: GSD file has no frames")
    if not f.schema.lower().startswith("hoomd"):
        logger.warning("%s: GSD schema %r is not 'hoomd'; reading with the "
                       "HOOMD layout anyway.", path, f.schema)

    box6 = f.read_chunk(0, "configuration/box")
    if box6 is None:
        raise ValueError(f"{path}: no configuration/box chunk")
    dims = f.read_chunk(0, "configuration/dimensions")
    if (dims is not None and int(np.asarray(dims).ravel()[0]) != 3) \
            or float(np.asarray(box6).ravel()[2]) <= 0.0:
        # A 2-D HOOMD box (dimensions=2, lz=0) is singular; failing here
        # beats the unrelated error it would cause in grid construction.
        raise ValueError(
            f"{path}: 2-D HOOMD trajectory (configuration/dimensions != 3 "
            "or lz <= 0); multislice needs a 3-D box — add a vacuum lz "
            "(e.g. rebuild with data.crystals helpers) before loading")
    box = _box_matrix(np.asarray(box6, np.float64).ravel()[:6])
    nchunk = f.read_chunk(0, "particles/N")
    if nchunk is None:
        raise ValueError(f"{path}: no particles/N chunk")
    n_atoms = int(np.asarray(nchunk).ravel()[0])

    pos_frames, vel_frames = [], []
    half = box @ np.array([0.5, 0.5, 0.5])   # origin shift: HOOMD centers
    for fr in range(f.n_frames):             # the box at 0; we use [0, L)
        if f.chunk_exists(fr, "configuration/box"):
            b = _box_matrix(np.asarray(
                f.read_chunk(fr, "configuration/box"), np.float64).ravel()[:6])
            if not np.allclose(b, box, rtol=1e-9, atol=1e-9):
                raise ValueError(
                    f"{path}: the box changes at frame {fr} (NPT "
                    "trajectory). The pipeline assumes one fixed box — "
                    "resample to a fixed cell first (same policy as the "
                    "AMBER reader).")
        if f.chunk_exists(fr, "particles/N"):
            nf = int(np.asarray(f.read_chunk(fr, "particles/N")).ravel()[0])
            if nf != n_atoms:
                raise ValueError(f"{path}: atom count changes at frame "
                                 f"{fr} ({nf} != {n_atoms})")
        pos = f.read_chunk(fr, "particles/position")
        if pos is None:
            raise ValueError(f"{path}: no particles/position chunk")
        pos = np.asarray(pos, np.float64).reshape(n_atoms, 3)
        img = f.read_chunk(fr, "particles/image")
        if img is not None:
            pos = pos + np.asarray(img, np.float64).reshape(n_atoms, 3) @ box.T
        pos_frames.append(pos + half)
        vel = f.read_chunk(fr, "particles/velocity")
        vel_frames.append(np.zeros((n_atoms, 3)) if vel is None
                          else np.asarray(vel, np.float64).reshape(n_atoms, 3))

    typeid = f.read_chunk(0, "particles/typeid")
    typeid = (np.zeros(n_atoms, np.int64) if typeid is None
              else np.asarray(typeid, np.int64).ravel())
    names_rows = f.read_chunk(0, "particles/types")
    types = typeid + 1                       # 1-based ids by default
    if names_rows is not None:
        from ..physics.kirkland import ELEMENTS
        names = ["".join(chr(c) for c in np.atleast_1d(row) if c)
                 for row in np.atleast_2d(np.asarray(names_rows, np.uint8))]
        if names and all(nm in ELEMENTS for nm in names):
            z_of = {i: ELEMENTS.index(nm) + 1 for i, nm in enumerate(names)}
            types = np.array([z_of[int(t)] for t in typeid], np.int64)
        else:
            logger.info("%s: particles/types %r are not element symbols; "
                        "returning 1-based type ids (use atom_mapping).",
                        path, names)
    return (types.astype(np.int32), np.stack(pos_frames),
            np.stack(vel_frames), box)


def write_gsd(path, positions: np.ndarray, box: np.ndarray,
              type_names: Optional[List[str]] = None,
              typeid: Optional[np.ndarray] = None,
              velocities: Optional[np.ndarray] = None,
              image: Optional[np.ndarray] = None,
              gsd_version: Tuple[int, int] = (1, 0),
              extra_chunks: Optional[List[Tuple[int, str,
                                                np.ndarray]]] = None) -> None:
    """Write a HOOMD-schema GSD file (test fixture / interchange writer).

    ``positions`` (F, N, 3) are in the origin-at-0 convention of this
    package; they are wrapped into HOOMD's centered box (plus ``image``
    flags if given, (F, N, 3) int). ``gsd_version`` picks the file-layer
    namelist layout ((1, 0) fixed 64-byte names, (2, 0) condensed)."""
    positions = np.asarray(positions, np.float32)
    if positions.ndim != 3 or positions.shape[-1] != 3:
        raise ValueError(f"positions must be (F, N, 3), got "
                         f"{positions.shape}")
    box = np.asarray(box, np.float64)
    n_frames, n_atoms = positions.shape[:2]
    half = (box @ np.array([0.5, 0.5, 0.5])).astype(np.float32)
    box6 = np.array([box[0, 0], box[1, 1], box[2, 2],
                     box[0, 1] / box[1, 1] if box[1, 1] else 0.0,
                     box[0, 2] / box[2, 2] if box[2, 2] else 0.0,
                     box[1, 2] / box[2, 2] if box[2, 2] else 0.0],
                    np.float32)
    if typeid is None:
        typeid = np.zeros(n_atoms, np.uint32)
    if type_names is None:
        type_names = ["A"]
    width = max(len(nm) for nm in type_names) + 1
    names_rows = np.zeros((len(type_names), width), np.int8)
    for i, nm in enumerate(type_names):
        enc = nm.encode("utf-8")
        names_rows[i, :len(enc)] = np.frombuffer(enc, np.int8)

    chunks: List[Tuple[int, str, np.ndarray]] = []   # (frame, name, data)
    for fr in range(n_frames):
        chunks.append((fr, "configuration/step",
                       np.array([fr], np.uint64)))
        if fr == 0:
            chunks.append((0, "configuration/box", box6))
            chunks.append((0, "particles/N",
                           np.array([n_atoms], np.uint32)))
            chunks.append((0, "particles/typeid",
                           np.asarray(typeid, np.uint32)))
            chunks.append((0, "particles/types", names_rows))
        chunks.append((fr, "particles/position", positions[fr] - half))
        if image is not None:
            chunks.append((fr, "particles/image",
                           np.asarray(image[fr], np.int32)))
        if velocities is not None:
            chunks.append((fr, "particles/velocity",
                           np.asarray(velocities[fr], np.float32)))

    if extra_chunks:
        chunks.extend((fr, nm, np.ascontiguousarray(arr))
                      for fr, nm, arr in extra_chunks)
    names = sorted({name for _, name, _ in chunks})
    name_id = {nm: i for i, nm in enumerate(names)}
    if gsd_version[0] >= 2:
        nm_blob = b"".join(nm.encode() + b"\x00" for nm in names)
        nm_blob += b"\x00" * (-len(nm_blob) % 64)
    else:
        nm_blob = b"".join(nm.encode().ljust(64, b"\x00") for nm in names)

    data_start = _HEADER.size
    entries, blobs, loc = [], [], data_start
    for frame, name, arr in sorted(chunks, key=lambda c: (c[0], c[1])):
        arr = np.ascontiguousarray(arr)
        n, m = (arr.shape if arr.ndim == 2 else (arr.shape[0], 1))
        entries.append(_ENTRY.pack(frame, n, loc, m, name_id[name],
                                   _TYPE_IDS[arr.dtype], 0))
        blobs.append(arr.tobytes())
        loc += len(blobs[-1])
    idx_loc, nm_loc = loc, loc + len(entries) * _ENTRY.size
    header = _HEADER.pack(
        GSD_MAGIC, idx_loc, len(entries), nm_loc, len(nm_blob) // 64,
        (1 << 16) | 4,                              # hoomd schema 1.4
        (gsd_version[0] << 16) | gsd_version[1],
        b"pyslice_tpu_torch", b"hoomd", b"\x00" * 80)
    with open(path, "wb") as fh:
        fh.write(header)
        for b in blobs:
            fh.write(b)
        fh.write(b"".join(entries))
        fh.write(nm_blob)
