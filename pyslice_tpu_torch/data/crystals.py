"""Crystal builders: specimens without an external structure package.

Counterpart of ``pyslice_tpu/data/crystals.py``, host NumPy only, on the
port's :class:`~pyslice_tpu_torch.data.trajectory.Trajectory`. Users coming
from other multislice codes build specimens with ASE; this module builds
the standard crystal structures directly as one-frame Trajectory objects
(chain ``generate_random_displacements`` for thermal ensembles or
``engine.thermal.thermal_configs`` for frozen phonons).

Conventions match the rest of the package: the box matrix is
upper-triangular with cell vectors as columns, positions are Cartesian
Angstroms with the origin at the box corner, and the beam travels along
+z (slice axis 2).

* ``crystal(...)`` — conventional cells of the common prototypes
  (sc/fcc/bcc/diamond/zincblende/rocksalt/cscl/fluorite/hcp/wurtzite)
  plus the 2-D sheets (graphene, hBN) with vacuum padding, tiled to any
  supercell size.
* ``orthogonal_supercell(...)`` — re-orient a CUBIC crystal so an
  arbitrary integer zone axis [hkl] lies along the beam, as an exactly
  periodic orthogonal supercell (integer lattice-vector search + exact
  fractional wrapping; atom count is volume-checked). This is how the
  classic Si [110] dumbbell specimen is set up.
* ``substitute(...)`` / ``vacancies(...)`` — random point defects, drawn
  from NumPy's ``default_rng(seed)`` as the JAX package draws them, so
  the same seed picks the same atoms.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np

from ..physics.kirkland import element_to_z
from .trajectory import Trajectory

__all__ = ["crystal", "orthogonal_supercell", "substitute", "vacancies",
           "PROTOTYPES"]


def _z(element: Union[int, str]) -> int:
    return int(element) if not isinstance(element, str) \
        else element_to_z(element)


# Prototype -> (n_species, fractional basis as (site -> species index)).
# Bases are in the CONVENTIONAL cell (cubic unless noted).
PROTOTYPES: Dict[str, dict] = {
    "sc": {"species": 1, "basis": [((0, 0, 0), 0)]},
    "fcc": {"species": 1, "basis": [((0, 0, 0), 0), ((0, .5, .5), 0),
                                    ((.5, 0, .5), 0), ((.5, .5, 0), 0)]},
    "bcc": {"species": 1, "basis": [((0, 0, 0), 0), ((.5, .5, .5), 0)]},
    "diamond": {"species": 1, "basis": [
        ((0, 0, 0), 0), ((0, .5, .5), 0), ((.5, 0, .5), 0),
        ((.5, .5, 0), 0), ((.25, .25, .25), 0), ((.25, .75, .75), 0),
        ((.75, .25, .75), 0), ((.75, .75, .25), 0)]},
    "zincblende": {"species": 2, "basis": [
        ((0, 0, 0), 0), ((0, .5, .5), 0), ((.5, 0, .5), 0),
        ((.5, .5, 0), 0), ((.25, .25, .25), 1), ((.25, .75, .75), 1),
        ((.75, .25, .75), 1), ((.75, .75, .25), 1)]},
    "rocksalt": {"species": 2, "basis": [
        ((0, 0, 0), 0), ((0, .5, .5), 0), ((.5, 0, .5), 0),
        ((.5, .5, 0), 0), ((.5, .5, .5), 1), ((.5, 0, 0), 1),
        ((0, .5, 0), 1), ((0, 0, .5), 1)]},
    "cscl": {"species": 2, "basis": [((0, 0, 0), 0), ((.5, .5, .5), 1)]},
    "fluorite": {"species": 2, "basis": [
        ((0, 0, 0), 0), ((0, .5, .5), 0), ((.5, 0, .5), 0),
        ((.5, .5, 0), 0),
        ((.25, .25, .25), 1), ((.25, .75, .75), 1), ((.75, .25, .75), 1),
        ((.75, .75, .25), 1), ((.75, .75, .75), 1), ((.75, .25, .25), 1),
        ((.25, .75, .25), 1), ((.25, .25, .75), 1)]},
    # hexagonal prototypes in the ORTHORHOMBIC (a, a*sqrt(3), c) setting so
    # the box stays rectangular (the engine's fast paths assume orthogonal
    # or xy-tilted cells; the orthorhombic setting avoids the tilt).
    "hcp": {"species": 1, "hex": True, "basis": [
        ((0, 0, 0), 0), ((.5, .5, 0), 0),
        ((.5, 1 / 6., .5), 0), ((0, 2 / 3., .5), 0)]},
    "wurtzite": {"species": 2, "u": 0.375, "hex": True, "basis": None},
    "graphene": {"species": 1, "hex": True, "sheet": True, "basis": [
        ((0, 0, 0), 0), ((.5, 1 / 6., 0), 0),
        ((.5, .5, 0), 0), ((0, 2 / 3., 0), 0)]},
    "hbn": {"species": 2, "hex": True, "sheet": True, "basis": [
        ((0, 0, 0), 0), ((.5, 1 / 6., 0), 1),
        ((.5, .5, 0), 0), ((0, 2 / 3., 0), 1)]},
}


def _wurtzite_basis(u: float):
    # orthorhombic setting of P6_3mc wurtzite: 4 cation + 4 anion sites
    return [((0, 0, 0), 0), ((.5, .5, 0), 0),
            ((.5, 1 / 6., .5), 0), ((0, 2 / 3., .5), 0),
            ((0, 0, u), 1), ((.5, .5, u), 1),
            ((.5, 1 / 6., .5 + u), 1), ((0, 2 / 3., .5 + u), 1)]


def crystal(elements: Union[str, int, Sequence[Union[str, int]]],
            kind: str, a: float, c: Optional[float] = None,
            size: Tuple[int, int, int] = (1, 1, 1),
            vacuum: float = 3.0, timestep: float = 1.0) -> Trajectory:
    """A conventional-cell crystal as a one-frame Trajectory.

    Args:
        elements: one element (symbol or Z) for single-species prototypes,
            a pair for two-species ones (e.g. ``("Ga", "As")``).
        kind: one of ``PROTOTYPES`` (sc, fcc, bcc, diamond, zincblende,
            rocksalt, cscl, fluorite, hcp, wurtzite, graphene, hbn).
        a: cubic / in-plane hexagonal lattice constant (Angstrom).
        c: hexagonal c axis; defaults to the ideal ratio
            ``a * sqrt(8/3)`` for hcp/wurtzite. Ignored for cubic kinds.
        size: (nx, ny, nz) supercell tiling of the conventional
            (orthorhombic, for hexagonal kinds) cell.
        vacuum: +-z padding for the 2-D sheets (graphene/hbn), Angstrom.
        timestep: Trajectory timestep metadata (ps).
    """
    kind = kind.lower()
    if kind not in PROTOTYPES:
        raise ValueError(f"unknown crystal kind {kind!r}; available: "
                         f"{sorted(PROTOTYPES)}")
    proto = PROTOTYPES[kind]
    if isinstance(elements, (str, int)):
        elements = [elements]
    zs = [_z(e) for e in elements]
    if len(zs) != proto["species"]:
        raise ValueError(f"{kind} needs {proto['species']} element(s), "
                         f"got {len(zs)}")

    basis = proto["basis"]
    if kind == "wurtzite":
        basis = _wurtzite_basis(proto["u"])
    if proto.get("hex"):
        if proto.get("sheet"):
            cell = np.diag([a, a * math.sqrt(3.0), 2.0 * vacuum])
        else:
            cc = c if c is not None else a * math.sqrt(8.0 / 3.0)
            cell = np.diag([a, a * math.sqrt(3.0), cc])
    else:
        cell = np.diag([a, a, a])

    frac = np.array([f for f, _ in basis], np.float64)
    spec = np.array([zs[s] for _, s in basis], np.int32)

    nx, ny, nz = (int(v) for v in size)
    if min(nx, ny, nz) < 1:
        raise ValueError(f"size must be positive, got {size}")
    shifts = np.stack(np.meshgrid(np.arange(nx), np.arange(ny),
                                  np.arange(nz), indexing="ij"),
                      axis=-1).reshape(-1, 3)
    if proto.get("sheet") and nz != 1:
        raise ValueError("2-D sheets tile in-plane only; use "
                         "size=(nx, ny, 1)")
    frac_all = (frac[None] + shifts[:, None]).reshape(-1, 3)
    types = np.tile(spec, len(shifts))
    pos = frac_all * np.diag(cell)                 # cells are diagonal here
    box = cell @ np.diag([nx, ny, nz]).astype(np.float64)
    if proto.get("sheet"):
        pos[:, 2] = vacuum                         # sheet centered in vacuum
    positions = pos[None]
    return Trajectory(types, positions, np.zeros_like(positions), box,
                      timestep)


def _integer_perp(w: np.ndarray, max_index: int = 6) -> np.ndarray:
    """Smallest integer vector orthogonal to integer vector ``w`` (cubic
    metric). Exists for every integer w; found by bounded search."""
    best = None
    rng = range(-max_index, max_index + 1)
    for i in rng:
        for j in rng:
            for k in rng:
                v = np.array([i, j, k])
                if not v.any() or v @ w != 0:
                    continue
                n = v @ v
                if best is None or n < best @ best:
                    best = v
    if best is None:
        raise ValueError(f"no integer vector orthogonal to {w} with "
                         f"indices <= {max_index}")
    return best


def _reduce(v: np.ndarray) -> np.ndarray:
    g = math.gcd(math.gcd(abs(int(v[0])), abs(int(v[1]))), abs(int(v[2])))
    return v // max(g, 1)


def orthogonal_supercell(traj: Trajectory, zone: Sequence[int],
                         min_size: Tuple[float, float, float] = (0, 0, 0),
                         tol: float = 1e-6) -> Trajectory:
    """Re-orient a CUBIC crystal so integer zone axis ``zone`` is the beam
    (z) direction, as an exactly periodic ORTHOGONAL supercell.

    The input must be a single conventional cubic cell (cubic box, one
    frame) — build it with ``crystal(..., size=(1, 1, 1))``. Integer
    lattice vectors u ⊥ v ⊥ w (w ∥ zone) span the new box; every
    conventional cell inside it is enumerated and atoms wrap by exact
    fractional arithmetic, then dedupe on the boundaries. The atom count
    is volume-checked (count == volume ratio x basis size) so a wrong
    construction cannot pass silently.

    ``min_size``: minimum box edge lengths (Angstrom); the supercell tiles
    each axis until it meets them (useful to reach a target field of
    view directly).

    Example — the classic Si [110] dumbbell specimen::

        si = crystal("Si", "diamond", a=5.431)
        si110 = orthogonal_supercell(si, (1, 1, 0), min_size=(20, 20, 0))
    """
    box = np.asarray(traj.box_matrix, np.float64)
    a = box[0, 0]
    if not np.allclose(box, np.diag([a, a, a]), atol=1e-9):
        raise ValueError("orthogonal_supercell needs a single conventional "
                         "CUBIC cell (cubic box); build with "
                         "crystal(..., size=(1, 1, 1))")
    if traj.n_frames != 1:
        raise ValueError("orient the static crystal first, then displace "
                         "(generate_random_displacements)")

    w = _reduce(np.asarray(zone, np.int64))
    if not w.any():
        raise ValueError("zone axis must be a nonzero integer triple")
    u = _integer_perp(w)
    v = _reduce(np.cross(w, u))
    # right-handed, mutually orthogonal by construction
    assert u @ w == 0 and v @ w == 0 and u @ v == 0

    M = np.stack([u, v, w], axis=1).astype(np.float64)   # columns u,v,w
    lengths = np.linalg.norm(M, axis=0) * a              # box edges
    reps = np.maximum(1, np.ceil(
        np.asarray(min_size, np.float64) / lengths - tol).astype(int))
    M = M * reps                                          # tile to min_size
    lengths = lengths * reps

    frac_basis = traj.positions[0] @ np.linalg.inv(box).T  # (m, 3) in cell
    det = abs(round(float(np.linalg.det(M))))             # cells per box
    n_expected = det * len(frac_basis)

    # enumerate candidate lattice translations covering the box
    Minv = np.linalg.inv(M)
    corners = np.array([[i, j, k] for i in (0, 1) for j in (0, 1)
                        for k in (0, 1)], np.float64) @ M.T
    lo = np.floor(corners.min(axis=0)).astype(int) - 1
    hi = np.ceil(corners.max(axis=0)).astype(int) + 1
    t = np.stack(np.meshgrid(*[np.arange(l, h + 1)
                               for l, h in zip(lo, hi)],
                             indexing="ij"), axis=-1).reshape(-1, 3)
    sites = (t[:, None] + frac_basis[None]).reshape(-1, 3)   # cubic frac
    types = np.tile(np.asarray(traj.atom_types), len(t))
    # fractional coordinates in the supercell; wrap exactly into [0, 1)
    f = sites @ Minv.T
    f -= np.floor(f + tol)
    keep = np.all((f > -tol) & (f < 1 - tol), axis=1)
    f, types = f[keep], types[keep]
    # dedupe boundary images (same wrapped fractional coordinate)
    key = np.round(f / (10 * tol)).astype(np.int64)
    _, first = np.unique(key, axis=0, return_index=True)
    f, types = f[np.sort(first)], types[np.sort(first)]
    if len(f) != n_expected:
        raise AssertionError(
            f"orthogonal_supercell self-check failed: {len(f)} atoms vs "
            f"{n_expected} expected (volume ratio {det} x basis "
            f"{len(frac_basis)}) for zone {tuple(int(x) for x in zone)}")
    pos = (f * lengths)[None]
    return Trajectory(types, pos, np.zeros_like(pos),
                      np.diag(lengths), traj.timestep)


def _pick(n_atoms: int, which, fraction, seed, mask=None) -> np.ndarray:
    if (which is None) == (fraction is None):
        raise ValueError("give exactly one of indices= or fraction=")
    if which is not None:
        idx = np.asarray(which, np.int64)
        if idx.size and (idx.min() < 0 or idx.max() >= n_atoms):
            raise ValueError(f"index out of range for {n_atoms} atoms")
        return idx
    if not 0.0 <= fraction <= 1.0:
        raise ValueError(f"fraction must be in [0, 1], got {fraction}")
    pool = np.arange(n_atoms) if mask is None else np.nonzero(mask)[0]
    n = int(round(fraction * len(pool)))
    return np.random.default_rng(seed).choice(pool, size=n, replace=False)


def substitute(traj: Trajectory, new_element: Union[str, int],
               indices=None, fraction: Optional[float] = None,
               of_element: Union[str, int, None] = None,
               seed: int = 0) -> Trajectory:
    """Replace atoms (chosen by ``indices`` or a random ``fraction``,
    optionally restricted to ``of_element``) with ``new_element``."""
    types = np.asarray(traj.atom_types).copy()
    mask = (types == _z(of_element)) if of_element is not None else None
    idx = _pick(traj.n_atoms, indices, fraction, seed, mask)
    types[idx] = _z(new_element)
    return Trajectory(types, traj.positions.copy(),
                      traj.velocities.copy(), traj.box_matrix.copy(),
                      traj.timestep)


def vacancies(traj: Trajectory, indices=None,
              fraction: Optional[float] = None,
              of_element: Union[str, int, None] = None,
              seed: int = 0) -> Trajectory:
    """Remove atoms (chosen like :func:`substitute`)."""
    types = np.asarray(traj.atom_types)
    mask = (types == _z(of_element)) if of_element is not None else None
    idx = _pick(traj.n_atoms, indices, fraction, seed, mask)
    keep = np.setdiff1d(np.arange(traj.n_atoms), idx)
    return Trajectory(types[keep], traj.positions[:, keep].copy(),
                      traj.velocities[:, keep].copy(),
                      traj.box_matrix.copy(), traj.timestep)
