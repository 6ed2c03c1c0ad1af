"""HAADF-STEM image formation from WFData.

Counterpart of ``pyslice_tpu/analysis/haadf.py`` (reference
``haadf_data.py:35-73``):

* scan grid reconstructed from the unique probe x/y coordinates;
* annular dark-field mask q > (collection_angle mrad)/lambda;
* per scan point: nearest probe, then mean over frames of the sum over k
  of |psi_hat * mask|.

Quirk 11, kept as the default: the signal sums the *amplitude* |psi_hat|,
not the intensity; ``intensity=True`` gives the |psi_hat|^2 detector.
Device-resident WFData reduce on their device; only the (n_probes,)
signal crosses to the host (``preview=True`` also reads back the first
scan point's frame-mean |psi_hat|). The sum is
``detectors.detector_sums`` with the ADF mask and the scan grid is
``detectors._scan_grid``: the image is ``virtual_image``'s. A WFData
sharded over a (frame, probe) mesh runs the same code, with an all_reduce
over frames and an all-gather over probes (every rank of the mesh calls
it).
"""

from __future__ import annotations

import numpy as np

from ..parallel import sharded
from ..utils.plotting import pyplot
from ..utils.profiling import span
from .detectors import _local_waves, _scan_grid, detector_sums
from .wf_data import WFData


class HAADFData:
    def __init__(self, wf_data: WFData):
        self.probe_positions = np.asarray(wf_data.probe_positions, dtype=np.float64)
        self.time = wf_data.time
        self.kxs = np.asarray(wf_data.kxs)
        self.kys = np.asarray(wf_data.kys)
        self.layer = wf_data.layer
        self.wavefunction_data = wf_data.wavefunction_data
        self.probe = wf_data.probe
        self.ksq_shifted = wf_data.ksq_shifted

    def calculateADF(self, collection_angle: float = 45,
                     preview: bool = False, intensity: bool = False) -> np.ndarray:
        """Annular dark-field image over the reconstructed scan grid.
        Returns (n_x, n_y); also stored as self.adf."""
        if self.ksq_shifted is not None:      # oblique cell: true |k|
            q = np.sqrt(np.asarray(self.ksq_shifted))
        else:
            q = np.sqrt(self.kxs[:, None] ** 2 + self.kys[None, :] ** 2)
        radius = (collection_angle * 1e-3) / self.probe.wavelength
        mask = q > radius

        wf = self.wavefunction_data
        with span("analysis.adf"):
            collected = detector_sums(wf, mask, intensity=intensity)[:, 0] \
                .cpu().numpy()
        self.xs, self.ys, nearest = _scan_grid(self.probe_positions)
        self.adf = collected[nearest].reshape(len(self.xs), len(self.ys))

        if preview:
            if sharded.sharded_mesh_of(wf) is not None:
                raise ValueError("preview draws one probe's exit wave; a "
                                 "mesh-sharded WFData has no single copy")
            plt = pyplot("calculateADF(preview=True)")
            # the frame mean of the first scan point's |psi| on the wave's
            # device, read back once
            amp = _local_waves(wf)[nearest[0], :, :, :, -1].abs() \
                .mean(dim=0).cpu().numpy()
            fig, ax = plt.subplots()
            ax.imshow(amp ** 0.1 * (1 - mask), cmap="inferno")
            plt.show()
        return self.adf

    def ADF(self, collection_angle: float = 45, preview: bool = False,
            intensity: bool = False) -> np.ndarray:
        """Alias: the reference demo calls ``.ADF`` (bug #1)."""
        return self.calculateADF(collection_angle, preview, intensity)

    def plot(self):
        """Draw the last ``calculateADF`` image over the scan extent."""
        plt = pyplot("HAADFData.plot")
        fig, ax = plt.subplots()
        extent = (self.xs.min(), self.xs.max(), self.ys.min(), self.ys.max())
        ax.imshow(self.adf.T, cmap="inferno", extent=extent)
        plt.show()
