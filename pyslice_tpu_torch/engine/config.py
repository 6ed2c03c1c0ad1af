"""Typed simulation configuration.

Counterpart of ``pyslice_tpu/engine/config.py``: the same fields, defaults
and JSON form, so a ``config.json`` written by either package loads in the
other. It is the single source of truth for a run, JSON-(de)serializable
for the command line (``python -m pyslice_tpu_torch``) and for provenance
(a copy is written next to the results). The device is not a field: the
JSON form is shared with the JAX package, whose loader rejects unknown
keys; the command line takes it as ``--device``.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Dict, List, Optional, Tuple, Union


@dataclasses.dataclass
class SimulationConfig:
    # --- input -------------------------------------------------------------
    trajectory: str = ""                    # path to dump/.xyz/.cif
    timestep: float = 1.0                   # ps
    atom_mapping: Optional[Dict[int, Union[int, str]]] = None
    max_frames: Optional[int] = None        # truncate trajectory
    # --- beam / grid ----------------------------------------------------------
    aperture: float = 0.0                   # mrad (0 = plane wave)
    voltage_eV: float = 100e3
    defocus: float = 0.0                    # Angstrom
    aberrations: Optional[Dict[str, float]] = None
    #   physics.aberrations coefficient dict, e.g. {"C3": 1e7, "A1": 40}
    slice_thickness: float = 0.5            # Angstrom
    sampling: float = 0.1                   # Angstrom / px
    slice_axis: int = 2
    bandwidth_limit: Optional[float] = None  # antialias band (fraction of
    #   Nyquist; 2/3 standard). None = reference parity (no limit)
    tilt: Optional[Tuple[float, float]] = None  # beam tilt (mrad, mrad)
    debye_waller: Optional[Dict[str, float]] = None  # {element: B (A^2)}
    # --- probes ---------------------------------------------------------------
    probe_positions: Optional[List[Tuple[float, float]]] = None
    probe_grid: Optional[Tuple[float, float, float, float, int, int]] = None
    #   (x0, x1, y0, y1, n, m) -> probe_grid() scan
    # --- execution --------------------------------------------------------------
    precision: str = "single"               # "single" | "double"
    fast_grid: bool = False                 # snap grid to 128-multiples
    batch_size: Optional[int] = None        # probes per propagation call
    record_layers: Optional[List[int]] = None
    use_cache: bool = True
    cache_root: str = "psi_data"
    # --- analysis / output ---------------------------------------------------
    mode: str = "tacaw"                     # "tacaw" | "haadf" | "wf"
    collection_angle: float = 45.0          # mrad (haadf)
    output_dir: str = "results"
    save_wf: bool = False                   # write wf_data.npz

    def resolve_probe_positions(self):
        if self.probe_positions is not None:
            return self.probe_positions
        if self.probe_grid is not None:
            from ..physics.probe import probe_grid as pg
            x0, x1, y0, y1, n, m = self.probe_grid
            return pg([x0, x1], [y0, y1], int(n), int(m))
        return None                          # calculator default: box center

    # --- (de)serialization ----------------------------------------------------

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        if d["atom_mapping"] is not None:
            d["atom_mapping"] = {str(k): v for k, v in d["atom_mapping"].items()}
        return json.dumps(d, indent=2)

    @classmethod
    def from_json(cls, text: str) -> "SimulationConfig":
        d = json.loads(text)
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(f"Unknown config keys: {sorted(unknown)}")
        if d.get("atom_mapping"):
            d["atom_mapping"] = {int(k): v for k, v in d["atom_mapping"].items()}
        if d.get("probe_positions"):
            d["probe_positions"] = [tuple(p) for p in d["probe_positions"]]
        if d.get("probe_grid"):
            d["probe_grid"] = tuple(d["probe_grid"])
        if d.get("tilt"):
            d["tilt"] = tuple(d["tilt"])
        return cls(**d)

    @classmethod
    def load(cls, path) -> "SimulationConfig":
        return cls.from_json(Path(path).read_text())

    def save(self, path) -> None:
        Path(path).write_text(self.to_json())
