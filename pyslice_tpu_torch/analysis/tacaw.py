"""TACAW frequency-domain analysis.

Counterpart of ``pyslice_tpu/analysis/tacaw.py`` (reference
``tacaw_data.py:36-353``). The exit waves are FFT'd along time
(``torch.fft`` on the device they lie on, chunked over probes, with the
time mean subtracted first to suppress the zero-frequency peak); the six
analysis methods reduce |Psi(omega, q)|^2 and return NumPy arrays:

* ``spectrum(probe_index=None)`` — sum over k; None averages probes.
* ``spectrum_image(frequency, probe_indices=None)`` — one value per probe.
* ``diffraction(probe_index=None)`` — sum over frequency.
* ``spectral_diffraction(frequency, probe_index=None)`` — nearest frequency.
* ``masked_spectrum(mask, probe_index=None)`` — k mask, then sum.
* ``dispersion(kx_path, ky_path, probe_index=None)`` — nearest-neighbour
  k lookups -> (n_freq, n_k).

``intensity`` is a tensor for device-resident WFData and a NumPy array for
host WFData, as in the JAX package. The mesh-sharded branch is not ported
yet (ROADMAP queue 1, item 11: Multi-GPU).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from .wf_data import WFData


def _time_fft_block(blk: torch.Tensor) -> torch.Tensor:
    blk = blk - blk.mean(dim=1, keepdim=True)
    return torch.fft.fftshift(torch.fft.fft(blk, dim=1), dim=1).abs() ** 2


def time_fft_intensity(wf_layer, chunk_elems: int = 1 << 26):
    """|fftshift_t(fft_t(wf - mean_t(wf)))|^2 along axis 1 of a (probes,
    time, kx, ky) tensor or array, in probe chunks. A tensor stays on its
    device; a NumPy array is computed on the CPU and returned as NumPy."""
    host = not isinstance(wf_layer, torch.Tensor)
    wf = torch.from_numpy(np.ascontiguousarray(wf_layer)) if host \
        else wf_layer
    n_probes = wf.shape[0]
    per_probe = int(np.prod(wf.shape[1:]))
    chunk = max(1, int(chunk_elems // max(per_probe, 1)))
    out = torch.cat([_time_fft_block(wf[i:i + chunk])
                     for i in range(0, n_probes, chunk)], dim=0)
    return out.numpy() if host else out


class TACAWData:
    """Frequency-domain TACAW dataset built from a WFData."""

    def __init__(self, wf_data: WFData, layer_index: Optional[int] = None):
        self.probe_positions = wf_data.probe_positions
        self.time = wf_data.time
        self.kxs = np.asarray(wf_data.kxs)
        self.kys = np.asarray(wf_data.kys)
        self.layer = wf_data.layer
        self.wavefunction_data = wf_data.wavefunction_data
        self.probe = wf_data.probe
        self.fft_from_wf_data(layer_index)

    @property
    def kx(self) -> np.ndarray:
        return self.kxs

    @property
    def ky(self) -> np.ndarray:
        return self.kys

    def fft_from_wf_data(self, layer_index: Optional[int] = None) -> None:
        """Time -> frequency conversion (tacaw_data.py:61-106). Frequencies
        are fftshift(fftfreq(n_t, dt)) in THz (time in ps); intensity is
        (probes, frequency, kx, ky)."""
        if layer_index is None:
            layer_index = len(self.layer) - 1
        if layer_index < 0 or layer_index >= len(self.layer):
            raise ValueError(
                f"layer_index {layer_index} out of range [0, {len(self.layer) - 1}]")
        n_freq = len(self.time)
        dt = self.time[1] - self.time[0]
        self.frequencies = np.fft.fftshift(np.fft.fftfreq(n_freq, d=dt))
        self.intensity = time_fft_intensity(
            self.wavefunction_data[:, :, :, :, layer_index])

    def _t(self) -> torch.Tensor:
        """The intensity as a tensor (zero-copy for host arrays)."""
        i = self.intensity
        return i if isinstance(i, torch.Tensor) else torch.from_numpy(i)

    def _check_probe(self, probe_index: int) -> None:
        if probe_index >= len(self.probe_positions):
            raise ValueError(f"Probe index {probe_index} out of range")

    def spectrum(self, probe_index: Optional[int] = None) -> np.ndarray:
        """Sum over k-space -> (n_freq,); None averages probes."""
        it = self._t()
        if probe_index is None:
            return it.sum(dim=(2, 3)).mean(dim=0).cpu().numpy()
        self._check_probe(probe_index)
        return it[probe_index].sum(dim=(1, 2)).cpu().numpy()

    def spectrum_image(self, frequency: float,
                       probe_indices: Optional[List[int]] = None) -> np.ndarray:
        """Summed k intensity at the nearest frequency, one value per
        selected probe."""
        freq_idx = int(np.argmin(np.abs(self.frequencies - frequency)))
        if probe_indices is None:
            probe_indices = list(range(len(self.probe_positions)))
        it = self._t()
        sel = it[torch.as_tensor(probe_indices, device=it.device), freq_idx]
        return sel.sum(dim=(1, 2)).cpu().numpy()

    def diffraction(self, probe_index: Optional[int] = None) -> np.ndarray:
        """Sum over frequency -> (kx, ky)."""
        it = self._t()
        if probe_index is None:
            return it.sum(dim=1).mean(dim=0).cpu().numpy()
        self._check_probe(probe_index)
        return it[probe_index].sum(dim=0).cpu().numpy()

    def spectral_diffraction(self, frequency: float,
                             probe_index: Optional[int] = None) -> np.ndarray:
        """Nearest-frequency (kx, ky) slice."""
        freq_idx = int(np.argmin(np.abs(self.frequencies - frequency)))
        it = self._t()
        if probe_index is None:
            return it[:, freq_idx].mean(dim=0).cpu().numpy()
        self._check_probe(probe_index)
        return it[probe_index, freq_idx].cpu().numpy()

    def masked_spectrum(self, mask: np.ndarray,
                        probe_index: Optional[int] = None) -> np.ndarray:
        """Apply a (kx, ky) mask, then sum over k."""
        mask = np.asarray(mask)
        if mask.shape != (len(self.kxs), len(self.kys)):
            raise ValueError(
                f"Mask shape {mask.shape} doesn't match k-space shape "
                f"({len(self.kxs)}, {len(self.kys)})")
        it = self._t()
        m = torch.as_tensor(mask, device=it.device).to(it.dtype)
        if probe_index is None:
            return (it * m).sum(dim=(2, 3)).mean(dim=0).cpu().numpy()
        self._check_probe(probe_index)
        return (it[probe_index] * m).sum(dim=(1, 2)).cpu().numpy()

    def dispersion(self, kx_path: np.ndarray, ky_path: np.ndarray,
                   probe_index: Optional[int] = None) -> np.ndarray:
        """Intensity along a k path -> (n_freq, n_k), nearest-neighbour k."""
        kx_idx = np.argmin(
            np.abs(self.kxs[None, :] - np.asarray(kx_path)[:, None]), axis=1)
        ky_idx = np.argmin(
            np.abs(self.kys[None, :] - np.asarray(ky_path)[:, None]), axis=1)
        it = self._t()
        ix = torch.as_tensor(kx_idx, device=it.device)
        iy = torch.as_tensor(ky_idx, device=it.device)
        if probe_index is None:
            return it[:, :, ix, iy].mean(dim=0).cpu().numpy()
        self._check_probe(probe_index)
        return it[probe_index][:, ix, iy].cpu().numpy()
