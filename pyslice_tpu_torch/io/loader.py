"""TrajectoryLoader — file ingest with transparent caching.

Counterpart of ``pyslice_tpu/io/loader.py`` over the port's pure-NumPy
parsers (``io.lammps`` / ``io.xyz`` / ``io.cif``, copies of the JAX
package's), with the original PySlice loader's API:

* ``TrajectoryLoader(filename, timestep, atom_mapping).load() -> Trajectory``
* ``atom_mapping`` maps dump atom types to atomic numbers (int) or element
  names (str); deprecated ``atomic_numbers`` / ``element_names`` kwargs kept.
* Transparent 4-file ``.npy`` cache next to the input:
  <stem>.positions.npy / .velocities.npy / .atom_types.npy /
  .box_matrix.npy. The cached ``atom_types`` are the RAW dump types and
  ``atom_mapping`` is applied after every cache load, so a run with a
  different mapping never returns the previous mapping's atomic numbers.

Ingest: LAMMPS text dumps (through the native C++ parser of
``io.native_loader`` where the layout allows, else the Python parser; the
arrays are the same), gzipped dumps (.gz, sniffed by magic bytes), binary
dumps (.bin, sniffed by NUL words), element-name atom columns, (extended)
XYZ, CIF, VASP POSCAR/CONTCAR/XDATCAR (``io.vasp``), AMBER NetCDF
(``io.amber``), HOOMD GSD (``io.gsd``), and multi-file dump patterns —
``TrajectoryLoader("dump.*.lammpstrj")`` (glob) or an explicit list of
files, concatenated in natural (numeric-aware) order.
"""

from __future__ import annotations

import logging
import re
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Union

import numpy as np

from ..data.trajectory import Trajectory
from ..physics.kirkland import element_to_z
from . import cif as cif_io
from . import lammps as lammps_io
from . import xyz as xyz_io

logger = logging.getLogger(__name__)


def _natural_key(p: Path):
    """Numeric-aware sort key: dump.2 < dump.10 (lexical order would not)."""
    return [int(t) if t.isdigit() else t
            for t in re.split(r"(\d+)", p.name)]


def parse_any(path: Path):
    """(types, positions, velocities, box) for one file; dispatches by
    suffix with transparent .gz handling. Shared by the eager loader and
    the streaming reader (io.stream)."""
    path = Path(path)
    suffixes = [s.lower() for s in path.suffixes]
    gz = suffixes and suffixes[-1] == ".gz"
    kind = (suffixes[-2] if gz and len(suffixes) > 1
            else (suffixes[-1] if suffixes else ""))
    if kind == ".cif":
        types, pos, box = cif_io.parse_cif(path)
        return types, pos, np.zeros_like(pos), box
    if kind == ".xyz":
        return xyz_io.parse_xyz(path)
    stem_up = path.name.upper()
    if kind in (".poscar", ".vasp") or any(
            stem_up.startswith(n) for n in ("POSCAR", "CONTCAR", "XDATCAR")):
        from . import vasp as vasp_io
        return vasp_io.parse_poscar(path)
    if kind in (".nc", ".ncdf", ".netcdf"):
        from . import amber as amber_io
        return amber_io.parse_amber_netcdf(path)
    if kind == ".gsd":
        from . import gsd as gsd_io
        return gsd_io.parse_gsd(path)
    # LAMMPS dump (.lammpstrj, .dump, .bin ...). The native parser reads
    # raw text only: gzipped and binary dumps (LAMMPS writes binary for
    # filenames ending .bin) go straight to the Python parser, which sniffs
    # gzip magic bytes and binary NUL words.
    if kind in (".bin", ".lammpsbin"):
        return lammps_io.parse_lammps_dump_binary(path)
    if not gz:
        with open(path, "rb") as fh:
            head = fh.read(256)
        if b"\x00" not in head:
            from .native_loader import parse_dump
            return parse_dump(path)
    return lammps_io.parse_lammps_dump(path)


class TrajectoryLoader:
    def __init__(self,
                 filename: Union[str, Path, Sequence[Union[str, Path]]],
                 timestep: Optional[float] = None,
                 atom_mapping: Optional[Dict[int, Union[int, str]]] = None,
                 atomic_numbers: Optional[Dict[int, int]] = None,
                 element_names: Optional[Dict[int, str]] = None,
                 use_cache: bool = True):
        if timestep is not None and timestep <= 0:
            raise ValueError("timestep must be positive if specified.")
        self.filepaths = self._resolve_files(filename)
        self.filepath = self.filepaths[0]
        self.timestep = timestep if timestep is not None else 1.0
        self.use_cache = use_cache

        if atomic_numbers is not None:
            logger.warning("atomic_numbers is deprecated; use atom_mapping.")
            atom_mapping = atomic_numbers
        elif element_names is not None:
            logger.warning("element_names is deprecated; use atom_mapping.")
            atom_mapping = element_names
        self.atomic_numbers = self._process_atom_mapping(atom_mapping)

    @staticmethod
    def _resolve_files(filename) -> List[Path]:
        """One Path, a glob pattern, or an explicit sequence -> ordered
        file list (natural sort, so dump.2 precedes dump.10)."""
        if isinstance(filename, (list, tuple)):
            paths = [Path(f) for f in filename]
            missing = [str(p) for p in paths if not p.exists()]
            if missing:
                raise FileNotFoundError(
                    f"Trajectory files not found: {missing}")
            if not paths:
                raise FileNotFoundError("empty trajectory file list")
            return paths
        p = Path(filename)
        if p.exists():
            return [p]
        if any(c in p.name for c in "*?["):
            matches = sorted(p.parent.glob(p.name), key=_natural_key)
            if matches:
                return matches
            raise FileNotFoundError(
                f"No files match trajectory pattern: {filename}")
        raise FileNotFoundError(f"Trajectory file not found: {filename}")

    @staticmethod
    def _process_atom_mapping(mapping) -> Optional[Dict[int, int]]:
        if mapping is None:
            return None
        result = {}
        for atom_type, value in mapping.items():
            if isinstance(value, str):
                result[atom_type] = element_to_z(value)
            elif isinstance(value, (int, np.integer)):
                if not (1 <= value <= 118):
                    raise ValueError(
                        f"Invalid atomic number {value} for type {atom_type}. "
                        "Must be between 1 and 118.")
                result[atom_type] = int(value)
            else:
                raise ValueError(
                    f"Invalid mapping value {value} for type {atom_type}. "
                    "Must be int (atomic number) or str (element name).")
        return result

    def _apply_atomic_mapping(self, atom_types: np.ndarray) -> np.ndarray:
        if self.atomic_numbers is None:
            return atom_types
        mapped = atom_types.copy()
        unmapped = []
        for t in np.unique(atom_types):
            if int(t) in self.atomic_numbers:
                mapped[atom_types == t] = self.atomic_numbers[int(t)]
            else:
                unmapped.append(int(t))
        if unmapped:
            logger.warning("No mapping provided for atom types %s.", unmapped)
        return mapped

    # --- cache ---------------------------------------------------------------

    def _get_cache_files(self) -> Dict[str, Path]:
        name = self.filepath.stem
        if name.endswith((".lammpstrj", ".dump", ".xyz")):
            name = Path(name).stem      # foo.lammpstrj.gz -> foo
        if len(self.filepaths) > 1:
            # Multi-file ingest: one combined cache keyed by the FULL ordered
            # file set (first-name+count alone would serve f1+f2's cache for
            # a later f1+f3 load).
            import hashlib
            digest = hashlib.md5("\n".join(
                str(p.resolve()) for p in self.filepaths).encode()
            ).hexdigest()[:10]
            name = f"{name}.x{len(self.filepaths)}.{digest}"
        parent = self.filepath.parent
        # plain concatenation, NOT with_suffix: the name may carry dots
        # (the .xN multi-file marker) that with_suffix would eat
        return {kind: parent / f"{name}.{kind}.npy"
                for kind in ("positions", "velocities", "atom_types",
                             "box_matrix")}

    def _load_from_cache(self):
        """Returns raw (atom_types, positions, velocities, box) or None.
        Types are the RAW dump types — the mapping is applied by load()."""
        files = self._get_cache_files()
        if not all(f.exists() for f in files.values()):
            return None
        try:
            logger.info("Loading from cache for %s", self.filepath.name)
            box = np.load(files["box_matrix"])
            if box.shape != (3, 3):
                raise ValueError(f"Invalid box_matrix shape: {box.shape}")
            return (np.load(files["atom_types"]), np.load(files["positions"]),
                    np.load(files["velocities"]), box)
        except Exception as e:   # stale/corrupt cache falls through to re-parse
            logger.warning("Cache loading failed: %s", e)
            return None

    def _save_to_cache(self, types, pos, vel, box) -> None:
        files = self._get_cache_files()
        files["positions"].parent.mkdir(parents=True, exist_ok=True)
        np.save(files["positions"], pos)
        np.save(files["velocities"], vel)
        np.save(files["atom_types"], types)
        np.save(files["box_matrix"], box)

    # --- load ------------------------------------------------------------------

    def load(self) -> Trajectory:
        cached = self._load_from_cache() if self.use_cache else None
        if cached is not None:
            types, pos, vel, box = cached
        else:
            parsed = [parse_any(p) for p in self.filepaths]
            types, pos, vel, box = parsed[0]
            if len(parsed) > 1:
                # Multi-file pattern: concatenate frames in file order
                # (each file carries one or more frames of the SAME system).
                for k, (t2, p2, v2, b2) in enumerate(parsed[1:], start=2):
                    if p2.shape[1:] != pos.shape[1:]:
                        raise ValueError(
                            f"{self.filepaths[k - 1]}: atom count "
                            f"{p2.shape[1]} differs from the first file's "
                            f"{pos.shape[1]} — not one trajectory")
                    if not np.array_equal(np.asarray(t2), np.asarray(types)):
                        raise ValueError(
                            f"{self.filepaths[k - 1]}: atom types differ "
                            "from the first file's — not one trajectory")
                # Stitch PBC continuity at each file seam: every file was
                # unwrapped independently (re-based on its own first frame),
                # so an atom that crossed a boundary inside an earlier file
                # would teleport by a box length at the seam without this.
                blocks = [parsed[0][1]]
                for t2, p2, v2, b2 in parsed[1:]:
                    blocks.append(lammps_io.stitch_continuity(
                        blocks[-1][-1], p2, np.asarray(box)))
                pos = np.concatenate(blocks, axis=0)
                vel = np.concatenate([p[2] for p in parsed], axis=0)
            if self.use_cache:
                # Cache RAW types: a later load with a different atom_mapping
                # must not inherit this run's mapping (a quirk of the
                # original loader).
                self._save_to_cache(np.asarray(types), pos, vel, box)

        types = self._apply_atomic_mapping(np.asarray(types))
        trajectory = Trajectory(atom_types=types, positions=pos,
                                velocities=vel, box_matrix=np.asarray(box),
                                timestep=self.timestep)
        logger.info("Loaded %d frames with %d atoms",
                    trajectory.n_frames, trajectory.n_atoms)
        return trajectory
