"""ctypes binding, and the build, of the native LAMMPS dump parser.

Counterpart of ``pyslice_tpu/io/native_loader.py`` over the port's own copy
of ``native/fast_dump.cpp`` (host C++, not a device kernel).
``parse_lammps_dump_native`` mirrors ``io.lammps.parse_lammps_dump`` for the
common dump layout; when the library reports an unsupported layout
(triclinic box, scaled coordinates, exotic columns) or cannot be built, it
returns None and the caller runs the Python parser, which gives the same
arrays.

The shared library is compiled with ``g++ -O3`` at first use into
``native/build/`` (git-ignored), named by the content hash of the source
and the compiler flags, so an edited source or a changed flag builds anew
and a stale library is never loaded.

Which parser produced the last result is visible: ``last_parser`` is
``"native"`` or ``"python"``, set by ``parse_dump`` (the loader's entry)
and by the streaming reader as each file starts.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

logger = logging.getLogger(__name__)

_NATIVE_DIR = Path(__file__).parent / "native"
_SRC = _NATIVE_DIR / "fast_dump.cpp"
_BUILD_DIR = _NATIVE_DIR / "build"
CXX_FLAGS = ("-O3", "-shared", "-fPIC")

_FLAG_IMAGES = 2          # dump_scan's flag: the file has image flags

_lock = threading.Lock()
_lib_handle = None
_build_failed = False

# "native" or "python": the parser behind the latest parse_dump result or
# the latest file TrajectoryStream started.
last_parser: Optional[str] = None


def library_path() -> Path:
    """Where the library for this source and these flags lives."""
    h = hashlib.sha256(_SRC.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return _BUILD_DIR / f"libfast_dump_{h.hexdigest()[:16]}.so"


def _build(lib: Path) -> bool:
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    try:
        subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp), str(_SRC)],
                       check=True, capture_output=True, timeout=120)
    except (subprocess.CalledProcessError, subprocess.TimeoutExpired,
            FileNotFoundError) as e:
        logger.warning("native dump parser build failed: %s", e)
        tmp.unlink(missing_ok=True)
        return False
    os.replace(tmp, lib)
    return True


def get_lib() -> Optional[ctypes.CDLL]:
    """The bound library, built on first use; None when it cannot be
    built (no g++)."""
    global _lib_handle, _build_failed
    with _lock:
        if _lib_handle is not None:
            return _lib_handle
        if _build_failed:
            return None
        path = library_path()
        if not path.exists() and not _build(path):
            _build_failed = True
            return None
        lib = ctypes.CDLL(str(path))
        lib.dump_scan.restype = ctypes.c_int
        lib.dump_scan.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int32),
        ]
        lib.dump_read.restype = ctypes.c_int
        lib.dump_read.argtypes = [
            ctypes.c_char_p,
            np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
            ctypes.c_int64,
            ctypes.c_int64,
        ]
        lib.dump_open.restype = ctypes.c_void_p
        lib.dump_open.argtypes = [ctypes.c_char_p]
        lib.dump_close.restype = None
        lib.dump_close.argtypes = [ctypes.c_void_p]
        lib.dump_next_header.restype = ctypes.c_int
        lib.dump_next_header.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int32),
            np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
        ]
        lib.dump_next_body.restype = ctypes.c_int
        lib.dump_next_body.argtypes = [
            ctypes.c_void_p,
            np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
        ]
        _lib_handle = lib
        return lib


def scan_dump_native(path) -> Optional[Tuple[int, int, int]]:
    """(n_frames, n_atoms, flags) via one native pass, or None when the
    library is unavailable or the layout needs the Python parser."""
    lib = get_lib()
    if lib is None:
        return None
    n_frames = ctypes.c_int64()
    n_atoms = ctypes.c_int64()
    flags = ctypes.c_int32()
    rc = lib.dump_scan(str(path).encode(), ctypes.byref(n_frames),
                       ctypes.byref(n_atoms), ctypes.byref(flags))
    if rc != 0:
        if rc < 0:
            logger.warning("native dump scan I/O error %d on %s", rc, path)
        return None
    return n_frames.value, n_atoms.value, flags.value


def parse_lammps_dump_native(path) -> Optional[
        Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]]:
    """Native-parser result matching io.lammps.parse_lammps_dump, or None
    when the fast path does not apply."""
    scanned = scan_dump_native(path)
    if scanned is None:
        return None
    f, a, flags = scanned
    positions = np.empty((f, a, 3), dtype=np.float64)
    velocities = np.empty((f, a, 3), dtype=np.float64)
    types = np.zeros(a, dtype=np.int32)
    box = np.zeros(9, dtype=np.float64)
    images = np.zeros((f, a, 3), dtype=np.float64)
    rc = get_lib().dump_read(str(path).encode(), positions, velocities,
                             types, box, images, f, a)
    if rc != 0:
        logger.warning("native dump read failed (%d) on %s; falling back",
                       rc, path)
        return None
    box_matrix = box.reshape(3, 3)

    from .lammps import unwrap_continuity
    # The native parser accepts orthogonal boxes only (triclinic dumps go
    # to the Python parser), so the image unwrap by the diagonal is exact.
    if flags & _FLAG_IMAGES:
        positions = positions + images * np.diag(box_matrix)[None, None, :]
    else:
        positions = unwrap_continuity(positions, box_matrix)
    return types, positions, velocities, box_matrix


def parse_dump(path):
    """(types, positions, velocities, box) of a plain-text dump: the native
    parser where it applies, else ``io.lammps.parse_lammps_dump``. Sets
    ``last_parser``."""
    global last_parser
    native = parse_lammps_dump_native(path)
    if native is not None:
        last_parser = "native"
        return native
    from .lammps import parse_lammps_dump
    last_parser = "python"
    return parse_lammps_dump(path)


def iter_frames_native(path):
    """Generator of per-frame ``(pos, vel, images|None, types, box)`` (the
    io.stream frame contract) through the incremental native parser, or
    None when the fast path does not apply (library unavailable, or a
    layout that needs the Python parser; one dump_scan pass decides up
    front, so iteration never switches parsers mid-file)."""
    if scan_dump_native(path) is None:
        return None
    lib = get_lib()

    def gen():
        h = lib.dump_open(str(path).encode())
        if not h:
            raise ValueError(f"{path}: cannot open for native streaming")
        try:
            na = ctypes.c_int64()
            fl = ctypes.c_int32()
            while True:
                box9 = np.zeros(9, np.float64)
                rc = lib.dump_next_header(h, ctypes.byref(na),
                                          ctypes.byref(fl), box9)
                if rc == 1:
                    return
                if rc != 0:
                    raise ValueError(
                        f"{path}: native streaming parse failed mid-file "
                        f"(code {rc}) despite a clean pre-scan")
                a = na.value
                pos = np.empty((a, 3), np.float64)
                vel = np.empty((a, 3), np.float64)
                types = np.zeros(a, np.int32)
                images = np.zeros((a, 3), np.float64)
                rc = lib.dump_next_body(h, pos, vel, types, images)
                if rc != 0:
                    raise ValueError(
                        f"{path}: native streaming parse failed "
                        f"(code {rc})")
                has_img = bool(fl.value & _FLAG_IMAGES)
                yield (pos, vel, images if has_img else None, types,
                       box9.reshape(3, 3))
        finally:
            lib.dump_close(h)

    return gen()
