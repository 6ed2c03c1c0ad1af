"""Wavefunction data container.

Counterpart of ``pyslice_tpu/analysis/wf_data.py`` (reference
``wf_data.py:9-28``): complex k-space exit waves with layout (probe, time,
kx, ky, layer), already fftshifted, plus the coordinate axes and the base
probe. ``wavefunction_data`` is a NumPy array (host run), a tensor on
the device that computed it (``device_output=True``), or a ``DTensor``
sharded over a (frame, probe) mesh (``setup(mesh=...)``; the frame axis
shards dim 1, the probe axis dim 0, as JAX's P('probe', 'frame')).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np
import torch


def to_numpy(a) -> np.ndarray:
    """A host array of ``a``. A sharded DTensor is gathered first: every
    rank of its mesh must call this."""
    if isinstance(a, torch.Tensor):
        from ..parallel.sharded import gather_full
        return gather_full(a.detach()).cpu().numpy()
    return np.asarray(a)


@dataclasses.dataclass
class WFData:
    probe_positions: np.ndarray   # (n_probes, 2) or list of (x, y), Angstrom
    time: np.ndarray              # (n_frames,) picoseconds
    kxs: np.ndarray               # (nx,) 1/Angstrom, fftshifted
    kys: np.ndarray               # (ny,) 1/Angstrom, fftshifted
    layer: np.ndarray             # (n_layers,) recorded layer indices
    wavefunction_data: object     # complex (probes, time, kx, ky, layer)
    probe: object                 # base Probe (for wavelength etc.)
    # Oblique cells: fftshifted (nx, ny) |k|^2 grid; None for orthogonal.
    ksq_shifted: np.ndarray = None

    @property
    def n_probes(self) -> int:
        return self.wavefunction_data.shape[0]

    @property
    def n_frames(self) -> int:
        return self.wavefunction_data.shape[1]

    def save(self, path) -> None:
        """Persist to a single .npz (the probe by its parameters). Sharded
        wave data is gathered on every rank of its mesh (each must call
        this) and written by global rank 0 alone."""
        import torch.distributed as dist
        from ..parallel.sharded import is_sharded
        waves = to_numpy(self.wavefunction_data)
        if is_sharded(self.wavefunction_data) and dist.get_rank() != 0:
            return
        np.savez_compressed(
            Path(path),
            probe_positions=np.asarray(self.probe_positions),
            time=np.asarray(self.time),
            kxs=np.asarray(self.kxs),
            kys=np.asarray(self.kys),
            layer=np.asarray(self.layer),
            wavefunction_data=waves,
            probe_xs=np.asarray(self.probe.xs),
            probe_ys=np.asarray(self.probe.ys),
            probe_mrad=np.asarray(self.probe.mrad),
            probe_eV=np.asarray(self.probe.eV),
            **({"ksq_shifted": np.asarray(self.ksq_shifted)}
               if self.ksq_shifted is not None else {}),
        )

    @classmethod
    def load(cls, path, device="cuda") -> "WFData":
        """Load a saved WFData; its probe is rebuilt on ``device`` (the
        card unless ``device="cpu"``) and the wave data stays a host
        array."""
        from ..physics.probe import Probe
        with np.load(Path(path)) as z:
            probe = Probe(z["probe_xs"], z["probe_ys"],
                          float(z["probe_mrad"]), float(z["probe_eV"]),
                          device=device)
            return cls(
                probe_positions=z["probe_positions"],
                time=z["time"],
                kxs=z["kxs"],
                kys=z["kys"],
                layer=z["layer"],
                wavefunction_data=z["wavefunction_data"],
                probe=probe,
                ksq_shifted=(z["ksq_shifted"] if "ksq_shifted" in z.files
                             else None),
            )
