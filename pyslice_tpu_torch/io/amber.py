"""AMBER NetCDF trajectory reader (.nc / .ncdf / .netcdf).

Counterpart of ``pyslice_tpu/io/amber.py``, line for line (host NumPy;
the original PySlice reads AMBER through OVITO); this reads the AMBER NetCDF
trajectory convention (Case et al., "AMBER NetCDF Trajectory/Restart
Convention", version 1.0) natively through scipy's NetCDF-3 reader — the
convention mandates the 64-bit-offset NetCDF-3 classic format, which is
exactly what ``scipy.io.netcdf_file`` implements (no libnetcdf needed).

Layout read:
* ``coordinates``  (frame, atom, spatial) float32, Angstrom — required;
* ``velocities``   same shape, Angstrom/ps, scale_factor honored
  (the convention stores them with scale_factor 20.455) — optional;
* ``cell_lengths`` (frame, 3) Angstrom + ``cell_angles`` (frame, 3)
  degrees — optional (vacuum/non-periodic files carry none; the box then
  falls back to the coordinate extent, matching the XYZ reader's
  behavior). Only the FIRST frame's cell is used: the whole pipeline
  assumes one fixed box (Trajectory carries a single box_matrix), and a
  cell that drifts over frames (NPT) raises, matching io.stream's policy.

AMBER files carry no element identities — atom types default to 1 and are
remapped via ``TrajectoryLoader(atom_mapping=...)``, exactly like
type-only LAMMPS dumps. (Element inference needs the parm7 topology,
which is out of scope for a trajectory reader.)
"""

from __future__ import annotations

import logging
from typing import Tuple

import numpy as np

logger = logging.getLogger(__name__)


def parse_amber_netcdf(path) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                      np.ndarray]:
    """Returns (atom_types (n,), positions (n_frames, n, 3) Angstrom,
    velocities (n_frames, n, 3) Angstrom/ps, box (3, 3))."""
    from scipy.io import netcdf_file

    from .cif import cell_to_box

    with netcdf_file(str(path), "r", mmap=False) as f:
        conventions = getattr(f, "Conventions", b"")
        if isinstance(conventions, bytes):
            conventions = conventions.decode("ascii", "replace")
        if "AMBER" not in conventions:
            logger.warning("%s: NetCDF Conventions=%r is not 'AMBER'; "
                           "reading with the AMBER layout anyway.",
                           path, conventions)
        if "coordinates" not in f.variables:
            raise ValueError(f"{path}: no 'coordinates' variable — not an "
                             "AMBER NetCDF trajectory")
        var = f.variables["coordinates"]
        pos = np.array(var[:], dtype=np.float64)
        if pos.ndim == 2:                   # single-frame restart layout
            pos = pos[None]
        if pos.ndim != 3 or pos.shape[-1] != 3:
            raise ValueError(f"{path}: coordinates shape {pos.shape} is "
                             "not (frame, atom, spatial=3)")
        scale = getattr(var, "scale_factor", None)
        if scale is not None:
            pos = pos * float(scale)

        vel = None
        if "velocities" in f.variables:
            vvar = f.variables["velocities"]
            vel = np.array(vvar[:], dtype=np.float64)
            if vel.ndim == 2:
                vel = vel[None]
            vscale = getattr(vvar, "scale_factor", None)
            if vscale is not None:
                vel = vel * float(vscale)

        if "cell_lengths" in f.variables:
            lengths = np.array(f.variables["cell_lengths"][:], np.float64)
            if lengths.ndim == 1:
                lengths = lengths[None]
            if "cell_angles" in f.variables:
                angles = np.array(f.variables["cell_angles"][:], np.float64)
                if angles.ndim == 1:
                    angles = angles[None]
            else:
                angles = np.full_like(lengths, 90.0)
            if len(lengths) > 1 and not np.allclose(
                    lengths, lengths[:1], rtol=1e-9, atol=1e-9):
                raise ValueError(
                    f"{path}: the cell changes between frames (NPT "
                    "trajectory). The pipeline assumes one fixed box — "
                    "resample to a fixed cell first (same policy as the "
                    "streaming reader).")
            box = cell_to_box(lengths[0][0], lengths[0][1], lengths[0][2],
                              angles[0][0], angles[0][1], angles[0][2])
        else:
            logger.warning("%s: no cell_lengths — non-periodic AMBER file; "
                           "box set to the coordinate extent.", path)
            span = pos.reshape(-1, 3)
            box = np.diag(np.maximum(span.max(axis=0) - span.min(axis=0),
                                     1.0))

    n_atoms = pos.shape[1]
    types = np.ones(n_atoms, dtype=np.int32)
    if vel is None:
        vel = np.zeros_like(pos)
    return types, pos, vel, box
