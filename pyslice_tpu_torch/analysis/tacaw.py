"""TACAW frequency-domain analysis.

Counterpart of ``pyslice_tpu/analysis/tacaw.py`` (reference
``tacaw_data.py:36-353``). The exit waves are FFT'd along time, with
the time mean subtracted first to suppress the zero-frequency peak: on the
card in one kernel (``analysis.time_fft``) where it takes the block's frame
count, otherwise by the plain ``torch.fft`` chain on the device the waves
lie on, chunked over probes; the six analysis methods reduce
|Psi(omega, q)|^2 and return NumPy arrays:

* ``spectrum(probe_index=None)`` — sum over k; None averages probes.
* ``spectrum_image(frequency, probe_indices=None)`` — one value per probe.
* ``diffraction(probe_index=None)`` — sum over frequency.
* ``spectral_diffraction(frequency, probe_index=None)`` — nearest frequency.
* ``masked_spectrum(mask, probe_index=None)`` — k mask, then sum.
* ``dispersion(kx_path, ky_path, probe_index=None)`` — nearest-neighbour
  k lookups -> (n_freq, n_k).

``intensity`` is a tensor for device-resident WFData and a NumPy array for
host WFData, as in the JAX package. A WFData sharded over a (frame, probe)
mesh (``setup(mesh=...)``) takes the sharded branch: the exit waves are
traded from frame shards to kx stripes by all_to_alls on the frame group,
one a probe chunk (``parallel.sharded.tacaw_intensity_sharded``, through
the unsharded path's chunk loop, ``time_fft_chunks``), the intensity stays a
k-sharded DTensor with kx zero-padded to the frame extent, and every
method reduces it with collectives and returns the replicated result
(every rank of the mesh must call it). ``intensity`` crops the pad on
access. On a mesh of size 1 the local tensor takes the unsharded path.
"""

from __future__ import annotations

import functools
from typing import Callable, List, Optional

import numpy as np
import torch

from ..ops.fused_step import launches
from ..parallel import sharded
from ..utils.profiling import span
from . import time_fft as time_fft_kernel
from .wf_data import WFData


def _time_fft_block(blk: torch.Tensor, out=None) -> torch.Tensor:
    """The time FFT's plain version: |fftshift_t(fft_t(blk - mean_t
    blk))|^2 along axis 1, into ``out`` if given."""
    blk = blk - blk.mean(dim=1, keepdim=True)
    res = torch.fft.fftshift(torch.fft.fft(blk, dim=1), dim=1).abs() ** 2
    return res if out is None else out.copy_(res)


def _kernel_route(blk: torch.Tensor) -> bool:
    """Whether a block goes to the kernel (``analysis.time_fft``): a CUDA
    complex64 block whose frame count the kernel takes. Every other block
    takes the plain chain."""
    return (blk.is_cuda and blk.dtype == torch.complex64
            and time_fft_kernel.kernel_takes(blk.shape[1]))


def time_fft_block(blk: torch.Tensor, out=None) -> torch.Tensor:
    """The time FFT of one (probes, time, kx, ky) block, by the kernel or
    the plain chain (``_kernel_route``), into ``out`` if given. A CUDA
    block that the rule sends to the plain chain is counted in
    ``launches["time_fft_plain"]``."""
    if _kernel_route(blk):
        return time_fft_kernel.time_fft(blk, out)
    if blk.is_cuda:
        launches["time_fft_plain"] += 1
    return _time_fft_block(blk, out)


# Elements of a probe chunk's block in the plain time FFT, sharded or not.
CHUNK_ELEMS = 1 << 26


def probe_chunk(per_probe: int, chunk_elems: Optional[int] = None) -> int:
    """Probes a chunk of the time FFT: as many blocks of ``per_probe``
    elements as ``chunk_elems`` (``CHUNK_ELEMS`` if None) holds, at least
    one."""
    limit = CHUNK_ELEMS if chunk_elems is None else chunk_elems
    return max(1, int(limit // max(per_probe, 1)))


def time_fft_chunks(n_probes: int, step: int,
                    block: Callable[[int, int], torch.Tensor]
                    ) -> torch.Tensor:
    """The time FFT's probe-chunk loop: ``time_fft_block`` of ``block(i,
    j)``, the (j - i, time, kx, ky) waves of probes i:j, for chunks of
    ``step`` probes. The output is allocated once, before the first chunk
    is transformed, and each chunk writes its rows of it (the kernel
    writes them itself). The one exception is a single chunk on the plain
    chain, which returns its own result, so that no output is allocated
    beside the chain's temporaries."""
    out = res = None
    for i in range(0, n_probes, step):
        blk = block(i, min(i + step, n_probes))
        if out is None and (step < n_probes or _kernel_route(blk)):
            out = blk.new_empty((n_probes,) + tuple(blk.shape[1:]),
                                dtype=blk.real.dtype)
        res = time_fft_block(
            blk, None if out is None else out[i:i + blk.shape[0]])
    return res if out is None else out


def time_fft_intensity(wf_layer, chunk_elems: int = CHUNK_ELEMS):
    """|fftshift_t(fft_t(wf - mean_t(wf)))|^2 along axis 1 of a (probes,
    time, kx, ky) tensor or array. A tensor stays on its device; a NumPy
    array is computed on the CPU and returned as NumPy. The kernel takes
    the whole block in one launch; the plain chain runs in probe chunks of
    ``chunk_elems``, which bound its temporaries."""
    host = not isinstance(wf_layer, torch.Tensor)
    with span("analysis.time_fft"):
        wf = torch.from_numpy(np.ascontiguousarray(wf_layer)) if host \
            else wf_layer
        n = wf.shape[0]
        step = n if _kernel_route(wf) else probe_chunk(
            int(np.prod(wf.shape[1:])), chunk_elems)
        out = time_fft_chunks(n, step, lambda i, j: wf[i:j])
    return out.numpy() if host else out


def _reduction(method):
    """A TACAWData reduction under the ``analysis.reduce`` span, through
    its copy to the host."""
    @functools.wraps(method)
    def traced(self, *args, **kwargs):
        with span("analysis.reduce"):
            return method(self, *args, **kwargs)
    return traced


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
        wf = self.wavefunction_data
        self._mesh = sharded.sharded_mesh_of(wf)
        if self._mesh is not None:
            self._nx = wf.shape[2]
            self._intensity_full = sharded.tacaw_intensity_sharded(
                wf, self._mesh, layer_index=layer_index, crop=False)
            return
        self._intensity = time_fft_intensity(
            sharded.local_of(wf)[:, :, :, :, layer_index])

    @property
    def intensity(self):
        """(probes, frequency, kx, ky), the reference attribute. Sharded:
        the k-sharded DTensor with the kx pad cropped (each rank keeps its
        stripe's rows)."""
        if self._mesh is None:
            return self._intensity
        return sharded.crop_kx(self._intensity_full, self._mesh, self._nx)

    @intensity.setter
    def intensity(self, value):
        self._mesh = None
        self._intensity = value

    def _probe_weights(self, probe_index: Optional[int]) -> np.ndarray:
        n = self._intensity_full.shape[0]
        if probe_index is None:
            return np.full(n, 1.0 / n)
        w = np.zeros(n)
        w[probe_index] = 1.0
        return w

    def _per_probe(self, mask=None) -> np.ndarray:
        return sharded.tacaw_probe_spectra_sharded(
            self._intensity_full, self._mesh, mask=mask).cpu().numpy()

    def _kplane(self, probe_index, freq_index=None) -> np.ndarray:
        if probe_index is not None:
            self._check_probe(probe_index)
        return sharded.tacaw_kplane_sharded(
            self._intensity_full, self._mesh,
            self._probe_weights(probe_index),
            freq_index=freq_index).cpu().numpy()[:self._nx]

    def _t(self) -> torch.Tensor:
        """The intensity as a tensor (zero-copy for host arrays)."""
        i = self.intensity
        return i if isinstance(i, torch.Tensor) else torch.from_numpy(i)

    def _check_probe(self, probe_index: int) -> None:
        if probe_index >= len(self.probe_positions):
            raise ValueError(f"Probe index {probe_index} out of range")

    @_reduction
    def spectrum(self, probe_index: Optional[int] = None) -> np.ndarray:
        """Sum over k-space -> (n_freq,); None averages probes."""
        if self._mesh is not None:
            per = self._per_probe()
            if probe_index is None:
                return per.mean(axis=0)
            self._check_probe(probe_index)
            return per[probe_index]
        it = self._t()
        if probe_index is None:
            return it.sum(dim=(2, 3)).mean(dim=0).cpu().numpy()
        self._check_probe(probe_index)
        return it[probe_index].sum(dim=(1, 2)).cpu().numpy()

    @_reduction
    def spectrum_image(self, frequency: float,
                       probe_indices: Optional[List[int]] = None) -> np.ndarray:
        """Summed k intensity at the nearest frequency, one value per
        selected probe."""
        freq_idx = int(np.argmin(np.abs(self.frequencies - frequency)))
        if probe_indices is None:
            probe_indices = list(range(len(self.probe_positions)))
        if self._mesh is not None:
            return self._per_probe()[np.asarray(probe_indices), freq_idx]
        it = self._t()
        sel = it[torch.as_tensor(probe_indices, device=it.device), freq_idx]
        return sel.sum(dim=(1, 2)).cpu().numpy()

    @_reduction
    def diffraction(self, probe_index: Optional[int] = None) -> np.ndarray:
        """Sum over frequency -> (kx, ky)."""
        if self._mesh is not None:
            return self._kplane(probe_index)
        it = self._t()
        if probe_index is None:
            return it.sum(dim=1).mean(dim=0).cpu().numpy()
        self._check_probe(probe_index)
        return it[probe_index].sum(dim=0).cpu().numpy()

    @_reduction
    def spectral_diffraction(self, frequency: float,
                             probe_index: Optional[int] = None) -> np.ndarray:
        """Nearest-frequency (kx, ky) slice."""
        freq_idx = int(np.argmin(np.abs(self.frequencies - frequency)))
        if self._mesh is not None:
            return self._kplane(probe_index, freq_idx)
        it = self._t()
        if probe_index is None:
            return it[:, freq_idx].mean(dim=0).cpu().numpy()
        self._check_probe(probe_index)
        return it[probe_index, freq_idx].cpu().numpy()

    @_reduction
    def masked_spectrum(self, mask: np.ndarray,
                        probe_index: Optional[int] = None) -> np.ndarray:
        """Apply a (kx, ky) mask, then sum over k."""
        mask = np.asarray(mask)
        if mask.shape != (len(self.kxs), len(self.kys)):
            raise ValueError(
                f"Mask shape {mask.shape} doesn't match k-space shape "
                f"({len(self.kxs)}, {len(self.kys)})")
        if self._mesh is not None:
            pad = self._intensity_full.shape[2] - self._nx
            per = self._per_probe(np.pad(mask.astype(np.float64),
                                         ((0, pad), (0, 0))))
            if probe_index is None:
                return per.mean(axis=0)
            self._check_probe(probe_index)
            return per[probe_index]
        it = self._t()
        m = torch.as_tensor(mask, device=it.device).to(it.dtype)
        if probe_index is None:
            return (it * m).sum(dim=(2, 3)).mean(dim=0).cpu().numpy()
        self._check_probe(probe_index)
        return (it[probe_index] * m).sum(dim=(1, 2)).cpu().numpy()

    @_reduction
    def dispersion(self, kx_path: np.ndarray, ky_path: np.ndarray,
                   probe_index: Optional[int] = None) -> np.ndarray:
        """Intensity along a k path -> (n_freq, n_k), nearest-neighbour k."""
        kx_idx = np.argmin(
            np.abs(self.kxs[None, :] - np.asarray(kx_path)[:, None]), axis=1)
        ky_idx = np.argmin(
            np.abs(self.kys[None, :] - np.asarray(ky_path)[:, None]), axis=1)
        if self._mesh is not None:
            if probe_index is not None:
                self._check_probe(probe_index)
            return sharded.tacaw_dispersion_sharded(
                self._intensity_full, self._mesh,
                self._probe_weights(probe_index), kx_idx,
                ky_idx).cpu().numpy()
        it = self._t()
        ix = torch.as_tensor(kx_idx, device=it.device)
        iy = torch.as_tensor(ky_idx, device=it.device)
        if probe_index is None:
            return it[:, :, ix, iy].mean(dim=0).cpu().numpy()
        self._check_probe(probe_index)
        return it[probe_index][:, ix, iy].cpu().numpy()
