"""Minimal CIF parser — pure Python/NumPy.

Counterpart of ``pyslice_tpu/io/cif.py``, line for line. The original
PySlice loads .cif through ASE; this implements the subset
the workflow needs: cell parameters, the ``_atom_site`` loop (fractional or
Cartesian coordinates), and symmetry expansion from explicit
``_symmetry_equiv_pos_as_xyz`` / ``_space_group_symop_operation_xyz`` loops.
Files that specify symmetry only by space-group name/number (no operator
loop) are treated as P1 over the listed sites, with a warning.

The cell -> Cartesian convention is the standard crystallographic one (a
along x, b in the xy plane); the returned box_matrix holds cell vectors as
*columns*, matching the rest of the framework (and OVITO's convention the
original consumes).
"""

from __future__ import annotations

import logging
import re
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np

from ..physics.kirkland import ELEMENTS, element_to_z

logger = logging.getLogger(__name__)

_NUM_RE = re.compile(r"[-+]?\d*\.?\d+(?:[eE][-+]?\d+)?")


def _parse_number(tok: str) -> float:
    """CIF numbers may carry uncertainties like 1.234(5)."""
    m = _NUM_RE.match(tok)
    if not m:
        raise ValueError(f"Not a number: {tok!r}")
    return float(m.group(0))


def _tokenize_line(line: str) -> List[str]:
    """Split a CIF data line, honoring quoted strings."""
    toks, i, n = [], 0, len(line)
    while i < n:
        while i < n and line[i] in " \t":
            i += 1
        if i >= n or line[i] == "#":
            break
        if line[i] in "'\"":
            q = line[i]
            j = line.find(q, i + 1)
            j = j if j != -1 else n
            toks.append(line[i + 1:j])
            i = j + 1
        else:
            j = i
            while j < n and line[j] not in " \t":
                j += 1
            toks.append(line[i:j])
            i = j
    return toks


def _apply_symop(op: str, frac: np.ndarray) -> np.ndarray:
    """Apply one 'x,y,z'-style operator to fractional coords (n, 3)."""
    out = np.zeros_like(frac)
    for axis, expr in enumerate(op.split(",")):
        expr = expr.strip().lower().replace(" ", "")
        # Parse terms like -x, +y, 1/2, 0.25, 2/3-x
        vec = np.zeros(3)
        const = 0.0
        for sign, term in re.findall(r"([+-]?)([xyz]|\d+/\d+|\d*\.?\d+)", expr):
            s = -1.0 if sign == "-" else 1.0
            if term in "xyz":
                vec["xyz".index(term)] += s
            elif "/" in term:
                p, q = term.split("/")
                const += s * float(p) / float(q)
            else:
                const += s * float(term)
        out[:, axis] = frac @ vec + const
    return out


def cell_to_box(a, b, c, alpha, beta, gamma) -> np.ndarray:
    """(3,3) box matrix, cell vectors as columns (a along x, b in xy)."""
    al, be, ga = np.radians([alpha, beta, gamma])
    bx, by = b * np.cos(ga), b * np.sin(ga)
    cx = c * np.cos(be)
    cy = c * (np.cos(al) - np.cos(be) * np.cos(ga)) / np.sin(ga)
    cz = np.sqrt(max(c ** 2 - cx ** 2 - cy ** 2, 0.0))
    return np.array([[a, bx, cx],
                     [0.0, by, cy],
                     [0.0, 0.0, cz]], dtype=np.float64)


def parse_cif(path, occupancy: str = "round",
              occupancy_seed: int = 0) -> Tuple[np.ndarray, np.ndarray,
                                                np.ndarray]:
    """Returns (atom_types Z (n,), positions (1, n, 3) Cartesian, box (3,3)).

    Uses the first data block that contains both a cell and an atom-site loop.

    Partial occupancy (``_atom_site_occupancy``) handling — a single static
    frame cannot represent fractional site populations, so one of three
    policies realizes the sites (ASE, which the original defers to at
    loader.py:273-287, keeps every partially-occupied site; abTEM realizes
    by random sampling):

    * ``"round"`` (default): keep sites with occupancy >= 0.5 —
      deterministic, exact for fully-ordered structures mislabeled with
      occupancies of 1.0/0.0, a warning is logged for anything fractional.
    * ``"sample"``: keep each site independently with probability equal to
      its occupancy, using ``numpy.random.default_rng(occupancy_seed)`` —
      the frozen-phonon-style ensemble answer; draw several seeds and
      average downstream for a configurational average.
    * ``"all"``: keep every listed site regardless of occupancy (ASE's
      behavior; overlapping split sites will double-count potential).
    """
    from .lammps import read_text_auto
    lines = read_text_auto(path).splitlines()

    cell: Dict[str, float] = {}
    sites: List[Tuple[str, float, float, float]] = []
    cartesian = False
    symops: List[str] = []

    i = 0
    while i < len(lines):
        line = lines[i].strip()
        if not line or line.startswith("#"):
            i += 1
            continue
        if line.startswith(";"):          # skip multi-line text fields
            i += 1
            while i < len(lines) and not lines[i].strip().startswith(";"):
                i += 1
            i += 1
            continue
        low = line.lower()
        if low.startswith("_cell_length_a"):
            cell["a"] = _parse_number(line.split()[1])
        elif low.startswith("_cell_length_b"):
            cell["b"] = _parse_number(line.split()[1])
        elif low.startswith("_cell_length_c"):
            cell["c"] = _parse_number(line.split()[1])
        elif low.startswith("_cell_angle_alpha"):
            cell["alpha"] = _parse_number(line.split()[1])
        elif low.startswith("_cell_angle_beta"):
            cell["beta"] = _parse_number(line.split()[1])
        elif low.startswith("_cell_angle_gamma"):
            cell["gamma"] = _parse_number(line.split()[1])
        elif low == "loop_":
            # Gather the header tags of this loop.
            tags = []
            j = i + 1
            while j < len(lines) and lines[j].strip().lower().startswith("_"):
                tags.append(lines[j].strip().split()[0].lower())
                j += 1
            body = []
            while j < len(lines):
                s = lines[j].strip()
                if (not s or s.lower() == "loop_" or s.startswith("_")
                        or s.startswith("data_") or s.startswith("#")):
                    break
                if s.startswith(";"):
                    j += 1
                    while j < len(lines) and not lines[j].strip().startswith(";"):
                        j += 1
                    j += 1
                    continue
                body.append(s)
                j += 1

            if any(t in ("_symmetry_equiv_pos_as_xyz",
                         "_space_group_symop_operation_xyz") for t in tags):
                op_col = next(k for k, t in enumerate(tags)
                              if t in ("_symmetry_equiv_pos_as_xyz",
                                       "_space_group_symop_operation_xyz"))
                for row in body:
                    toks = _tokenize_line(row)
                    if len(toks) > op_col:
                        symops.append(toks[op_col])

            if any(t.startswith("_atom_site_fract_x") for t in tags) or \
               any(t.startswith("_atom_site_cartn_x") for t in tags) or \
               any(t.startswith("_atom_site_cartesian") for t in tags):
                if not sites:   # first atom-site loop wins
                    cartesian = not any(
                        t.startswith("_atom_site_fract_x") for t in tags)
                    prefix = "_atom_site_cartn_" if cartesian else "_atom_site_fract_"
                    col = {}
                    for k, t in enumerate(tags):
                        col[t] = k
                    xcol = col.get(prefix + "x")
                    ycol = col.get(prefix + "y")
                    zcol = col.get(prefix + "z")
                    scol = col.get("_atom_site_type_symbol",
                                   col.get("_atom_site_label"))
                    ocol = col.get("_atom_site_occupancy")
                    for row in body:
                        toks = _tokenize_line(row)
                        if len(toks) < len(tags) or toks[0] == "?":
                            continue
                        try:
                            occ = 1.0
                            if ocol is not None and toks[ocol] not in (
                                    ".", "?"):
                                occ = _parse_number(toks[ocol])
                            sites.append((toks[scol],
                                          _parse_number(toks[xcol]),
                                          _parse_number(toks[ycol]),
                                          _parse_number(toks[zcol]),
                                          occ))
                        except (ValueError, IndexError):
                            continue
            i = j
            continue
        i += 1

    if not cell or not sites:
        raise ValueError(f"Could not parse cell/sites from CIF {path}")

    box = cell_to_box(cell["a"], cell["b"], cell["c"],
                      cell.get("alpha", 90.0), cell.get("beta", 90.0),
                      cell.get("gamma", 90.0))

    def symbol_to_z(s: str) -> int:
        m = re.match(r"([A-Z][a-z]?)", s)
        if not m or m.group(1) not in ELEMENTS:
            raise ValueError(f"Unknown element symbol in CIF: {s!r}")
        return element_to_z(m.group(1))

    if occupancy not in ("round", "sample", "all"):
        raise ValueError(f"occupancy must be 'round', 'sample' or 'all', "
                         f"got {occupancy!r}")

    zs = np.array([symbol_to_z(s[0]) for s in sites], dtype=np.int32)
    coords = np.array([[s[1], s[2], s[3]] for s in sites], dtype=np.float64)
    occs = np.array([s[4] for s in sites], dtype=np.float64)

    if cartesian:
        cart = coords
    else:
        frac = coords
        if symops:
            all_z, all_frac, all_occ = [], [], []
            for op in symops:
                f = _apply_symop(op, frac) % 1.0
                all_z.append(zs)
                all_frac.append(f)
                all_occ.append(occs)
            zs = np.concatenate(all_z)
            frac = np.concatenate(all_frac)
            occs = np.concatenate(all_occ)
            # Deduplicate overlapping images.
            key = np.round(frac, 6) % 1.0
            _, keep = np.unique(
                np.concatenate([zs[:, None], key], axis=1), axis=0,
                return_index=True)
            keep = np.sort(keep)
            zs, frac, occs = zs[keep], frac[keep], occs[keep]
        else:
            logger.warning("CIF %s: no symmetry-operator loop; treating listed "
                           "sites as P1.", path)
        cart = frac @ box.T

    if np.any(occs < 1.0 - 1e-9) and occupancy != "all":
        if occupancy == "round":
            keep = occs >= 0.5
            if np.any((occs > 1e-9) & (occs < 1.0 - 1e-9)):
                logger.warning(
                    "CIF %s: fractional occupancies present; 'round' keeps "
                    "sites with occupancy >= 0.5 (%d of %d kept). Use "
                    "occupancy='sample' for a stochastic realization.",
                    path, int(keep.sum()), len(occs))
        else:
            rng = np.random.default_rng(occupancy_seed)
            keep = rng.random(len(occs)) < occs
        zs, cart = zs[keep], cart[keep]

    return zs, cart[None], box
