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
scan point's frame-mean |psi_hat|). A WFData sharded over a (frame, probe)
mesh reduces through ``parallel.sharded.collected_sharded`` (an all_reduce
over frames, an all-gather over probes; every rank of the mesh calls it).
"""

from __future__ import annotations

import numpy as np
import torch

from ..parallel import sharded
from ..utils.plotting import pyplot
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
        positions = self.probe_positions
        self.xs = np.array(sorted(set(positions[:, 0].tolist())))
        self.ys = np.array(sorted(set(positions[:, 1].tolist())))

        if self.ksq_shifted is not None:      # oblique cell: true |k|
            q = np.sqrt(np.asarray(self.ksq_shifted))
        else:
            q = np.sqrt(self.kxs[:, None] ** 2 + self.kys[None, :] ** 2)
        radius = (collection_angle * 1e-3) / self.probe.wavelength
        mask = q > radius

        # Nearest probe for every (x, y) scan point.
        gx, gy = np.meshgrid(self.xs, self.ys, indexing="ij")
        grid_pts = np.stack([gx.ravel(), gy.ravel()], axis=1)
        d2 = (np.sum(grid_pts ** 2, axis=1)[:, None]
              - 2.0 * grid_pts @ positions.T
              + np.sum(positions ** 2, axis=1)[None, :])
        nearest = np.argmin(d2, axis=1)

        wf = self.wavefunction_data
        mesh = sharded.sharded_mesh_of(wf)
        if mesh is not None:
            collected = sharded.collected_sharded(
                wf, mesh, mask, intensity=intensity)[:, 0].cpu().numpy()
        else:
            wf = sharded.local_of(wf)
            if not isinstance(wf, torch.Tensor):
                wf = torch.from_numpy(np.asarray(wf))
            exits = wf[:, :, :, :, -1].abs()
            if intensity:
                exits = exits ** 2
            m = torch.as_tensor(mask, device=exits.device).to(exits.dtype)
            collected = (exits * m).sum(dim=(2, 3)).mean(dim=1) \
                .cpu().numpy()
        self.adf = collected[nearest].reshape(len(self.xs), len(self.ys))

        if preview:
            if mesh is not None:
                raise ValueError("preview draws one probe's exit wave; a "
                                 "mesh-sharded WFData has no single copy")
            plt = pyplot("calculateADF(preview=True)")
            # the frame mean of the first scan point's |psi| on the wave's
            # device, read back once
            amp = wf[nearest[0], :, :, :, -1].abs().mean(dim=0).cpu().numpy()
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
