"""POSCAR/CONTCAR (VASP) reader — pure Python/NumPy.

Counterpart of ``pyslice_tpu/io/vasp.py``, line for line (host NumPy;
the original PySlice reads VASP through OVITO); this implements the format
natively: comment, scale (negative = target cell volume), three lattice
vectors (rows), optional VASP-5 element-symbols line, per-species counts,
optional ``Selective dynamics``, ``Direct``/``Cartesian`` coordinates, and
an optional velocity block. Also reads XDATCAR multi-frame trajectories
(same header, ``Direct configuration= N`` frame markers).

Box convention: cell vectors as *columns* of the returned (3, 3) matrix,
matching the rest of the framework. POSCAR stores lattice vectors as rows,
so the returned box is the transposed, scaled lattice block.

VASP-4 files carry no element symbols — atom types are then reported as
1-based species indices in file order, to be remapped via
``TrajectoryLoader(atom_mapping=...)`` exactly like LAMMPS numeric types.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from ..physics.kirkland import ELEMENTS, element_to_z

logger = logging.getLogger(__name__)


def _is_symbol_line(tokens: List[str]) -> bool:
    return bool(tokens) and all(t[:1].isalpha() for t in tokens)


def _species_types(symbols: Optional[List[str]],
                   counts: List[int]) -> np.ndarray:
    """Per-atom type array: atomic numbers when symbols are known,
    1-based species indices otherwise (VASP 4)."""
    if symbols is not None:
        zs = []
        for sym, cnt in zip(symbols, counts):
            base = sym.split("/")[0].split("_")[0]  # e.g. "Ti_sv" POTCAR tag
            if base not in ELEMENTS:
                raise ValueError(f"Unknown element symbol in POSCAR: {sym!r}")
            zs.extend([element_to_z(base)] * cnt)
        return np.asarray(zs, dtype=np.int32)
    logger.warning("POSCAR has no element-symbols line (VASP 4); atom types "
                   "are 1-based species indices — pass atom_mapping to "
                   "TrajectoryLoader to assign elements.")
    return np.concatenate([np.full(c, i + 1, np.int32)
                           for i, c in enumerate(counts)])


def parse_poscar(path) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                np.ndarray]:
    """Returns (atom_types (n,), positions (n_frames, n, 3) Cartesian
    Angstrom, velocities (n_frames, n, 3), box (3, 3)).

    POSCAR/CONTCAR yield one frame; XDATCAR-style files (``Direct
    configuration=`` markers after the header) yield all frames.
    """
    from .lammps import read_text_auto
    lines = read_text_auto(path).splitlines()
    if len(lines) < 7:
        raise ValueError(f"{path}: too short to be a POSCAR")

    scale = float(lines[1].split()[0])
    lattice = np.array([[float(x) for x in lines[2 + i].split()[:3]]
                        for i in range(3)], dtype=np.float64)
    if scale < 0:  # negative scale = desired cell volume
        vol = abs(np.linalg.det(lattice))
        scale = (-scale / vol) ** (1.0 / 3.0)
    lattice = lattice * scale
    box = lattice.T.copy()  # rows (lattice vectors) -> columns

    i = 5
    tokens = lines[i].split()
    symbols: Optional[List[str]] = None
    if _is_symbol_line(tokens):
        symbols = tokens
        i += 1
        tokens = lines[i].split()
    try:
        counts = [int(t) for t in tokens]
    except ValueError:
        raise ValueError(f"{path}: expected per-species atom counts at line "
                         f"{i + 1}, got {lines[i]!r}") from None
    if symbols is not None and len(symbols) != len(counts):
        raise ValueError(f"{path}: {len(symbols)} element symbols but "
                         f"{len(counts)} species counts")
    n_atoms = sum(counts)
    types = _species_types(symbols, counts)
    i += 1

    if lines[i].strip()[:1].lower() == "s":  # Selective dynamics
        i += 1
    mode = lines[i].strip()[:1].lower()
    # 'd' = direct (fractional); 'c'/'k' = cartesian (scaled by `scale`)
    if mode not in ("d", "c", "k"):
        raise ValueError(f"{path}: expected Direct/Cartesian line, "
                         f"got {lines[i]!r}")
    direct = mode == "d"
    i += 1

    def read_block(start: int) -> Tuple[np.ndarray, int]:
        rows = []
        for j in range(start, start + n_atoms):
            if j >= len(lines):
                raise ValueError(f"{path}: truncated coordinate block "
                                 f"({len(rows)}/{n_atoms} atoms)")
            rows.append([float(x) for x in lines[j].split()[:3]])
        return np.asarray(rows, dtype=np.float64), start + n_atoms

    def to_cart(coords: np.ndarray, is_direct: bool) -> np.ndarray:
        return coords @ lattice if is_direct else coords * scale

    frac0, i = read_block(i)
    frames = [to_cart(frac0, direct)]

    # Optional velocity block (POSCAR) or XDATCAR frame markers.
    velocities = None
    while i < len(lines):
        s = lines[i].strip()
        if not s:
            i += 1
            # blank line then a block of n_atoms numbers = velocities
            if velocities is None and len(frames) == 1 and i < len(lines) \
                    and lines[i].strip() and not lines[i].strip()[0].isalpha():
                try:
                    velocities, i = read_block(i)
                except ValueError:
                    break
                # POSCAR velocities are Cartesian A/fs regardless of the
                # coordinate mode, per the VASP manual; pass through as-is.
            continue
        low = s.lower()
        if low.startswith("direct configuration") or \
                low.startswith("cartesian configuration"):
            i += 1
            f, i = read_block(i)
            frames.append(to_cart(f, low.startswith("direct")))
            continue
        break  # predictor-corrector block etc. — ignore

    positions = np.stack(frames)  # (n_frames, n, 3)
    if velocities is None:
        vel = np.zeros_like(positions)
    else:
        vel = np.broadcast_to(velocities, positions.shape).copy()
    return types, positions, vel, box
