"""(Extended) XYZ parser — pure NumPy.

Counterpart of ``pyslice_tpu/io/xyz.py``, line for line.

Handles multi-frame concatenated .xyz files; reads a ``Lattice="ax ay az bx
by bz cx cy cz"`` cell from the comment line when present (extended-XYZ
convention, row-major cell vectors), otherwise derives a bounding box.
Velocity columns (4-6 after x y z) are read when present.
"""

from __future__ import annotations

from pathlib import Path
from typing import Tuple

import numpy as np

from ..physics.kirkland import ELEMENTS, element_to_z


def parse_xyz(path) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Returns (atom_types Z (n_atoms,), positions (F, N, 3),
    velocities (F, N, 3), box_matrix (3, 3))."""
    from .lammps import read_text_auto
    lines = read_text_auto(path).splitlines()
    i = 0
    frames_pos, frames_vel = [], []
    types = None
    box = None
    known = set(ELEMENTS)

    while i < len(lines):
        if not lines[i].strip():
            i += 1
            continue
        n_atoms = int(lines[i].strip())
        comment = lines[i + 1]
        if box is None and "Lattice=" in comment:
            lat = comment.split('Lattice="', 1)[1].split('"', 1)[0]
            v = np.array(lat.split(), dtype=np.float64).reshape(3, 3)
            box = v.T.copy()   # rows are cell vectors -> columns-as-vectors
        i += 2
        rows = [lines[i + a].split() for a in range(n_atoms)]
        i += n_atoms

        if types is None:
            symbols = [r[0] for r in rows]
            if all(s in known for s in symbols):
                types = np.array([element_to_z(s) for s in symbols],
                                 dtype=np.int32)
            else:
                types = np.array([int(float(s)) for s in symbols],
                                 dtype=np.int32)
        data = np.array([r[1:] for r in rows], dtype=np.float64)
        frames_pos.append(data[:, 0:3])
        frames_vel.append(data[:, 3:6] if data.shape[1] >= 6
                          else np.zeros((n_atoms, 3)))

    positions = np.stack(frames_pos)
    velocities = np.stack(frames_vel)
    if box is None:
        span = positions.reshape(-1, 3).max(axis=0)
        box = np.diag(np.maximum(span, 1.0))
    return types, positions, velocities, box


def write_xyz(path, atom_types, positions, box_matrix=None,
              velocities=None) -> None:
    atom_types = np.asarray(atom_types)
    positions = np.asarray(positions)
    if positions.ndim == 2:
        positions = positions[None]
    if velocities is not None:
        velocities = np.asarray(velocities)
        if velocities.ndim == 2:
            velocities = velocities[None]
    with open(path, "w") as f:
        for t in range(positions.shape[0]):
            f.write(f"{positions.shape[1]}\n")
            if box_matrix is not None:
                v = np.asarray(box_matrix).T.reshape(-1)
                lat = " ".join("%.10g" % x for x in v)
                f.write(f'Lattice="{lat}" Properties=species:S:1:pos:R:3\n')
            else:
                f.write("\n")
            for a in range(positions.shape[1]):
                sym = (ELEMENTS[int(atom_types[a]) - 1]
                       if np.issubdtype(atom_types.dtype, np.integer)
                       else str(atom_types[a]))
                row = "%s %.8g %.8g %.8g" % (sym, *positions[t, a])
                if velocities is not None:
                    row += " %.8g %.8g %.8g" % tuple(velocities[t, a])
                f.write(row + "\n")
