"""Streaming (online, per-frame) analysis engines.

Counterpart of ``pyslice_tpu/engine/streaming.py``. The batch path keeps
the whole (probes, frames, nx, ny) exit-wave array — 2.1 TB at 2048^2 x
1000 frames x 64 probes (``BASELINE.json`` config 5). These engines hold
one probe chunk's exit waves at a time plus O(selected outputs) of state,
so the frame axis streams indefinitely:

* ``StreamingTACAW`` — partial time-DFT at selected frequency bins: for
  the fftfreq integer bins, acc_f += psi_t * exp(-2 pi i f t / n). Mean
  subtraction only affects the f=0 bin for integer bins
  (sum_t exp(-2 pi i f t / n) == 0 for f != 0), so it is applied as a
  closed-form end correction. Memory: n_selected x probes x nx x ny.
* ``StreamingHAADF`` — running sum over frames of the masked k-space
  amplitude (or intensity) per probe; O(probes) state. Large scans route
  through the S-matrix (``engine.smatrix``).

Both consume frames in any order (each frame index enters once) and give
the batch path's results at the selected outputs. Each frame rasterizes its
potential once and pushes every probe chunk through
``pipeline.exit_waves_from_potential`` (the slice kernels on the card);
each chunk is folded into its accumulators in place (``fold``) before the
next chunk runs. The fold order within an accumulator is the feed order,
so block feeding equals per-frame feeding bit for bit, and a restored
checkpoint fed the remaining frames equals an uninterrupted stream.

Everything runs on the device of the probe batch. ``mesh=`` raises:
multi-GPU runs are not ported yet.
"""

from __future__ import annotations

import hashlib
import json
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

from ..core.constants import wavelength as _wavelength
from ..physics.potential import rasterize
from .pipeline import SimSpec, exit_waves_from_potential


def _no_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(
            "mesh= (multi-GPU runs) is not ported yet (ROADMAP queue 1, "
            "item 8: Multi-GPU)")


def _positions(block, device) -> torch.Tensor:
    """A (B, n_atoms, 3) frame block as a tensor on ``device``, copied
    once for the whole block."""
    pos = block if isinstance(block, torch.Tensor) else \
        torch.as_tensor(np.asarray(block))
    return pos.to(device)


def phase_factors(frame_indices, bins, n_frames: int,
                  np_real) -> np.ndarray:
    """exp(-2 pi i f t / n) for frames t and bins f, (B, n_bins) complex on
    the host: the angle in float64, then its cos and sin rounded to the
    run's real type. The one construction for every feed, so that block
    and per-frame feeding fold the same factors."""
    angle = (-2.0 * np.pi / n_frames) * np.outer(
        np.asarray(frame_indices, dtype=np.float64),
        np.asarray(bins, dtype=np.float64))
    return (np.cos(angle).astype(np_real).astype(np.float64)
            + 1j * np.sin(angle).astype(np_real).astype(np.float64))


def fold(acc: torch.Tensor, mean: Optional[torch.Tensor], psi: torch.Tensor,
         phases) -> None:
    """acc[f] += phases[f] * psi for every bin f, and mean += psi, in place.

    ``acc``: (n_bins, chunk, nx, ny); ``psi``: (chunk, nx, ny) k-space exit
    waves; ``phases``: n_bins host complex numbers. Each bin is one fused
    multiply-add over the chunk (``add_`` with the factor as ``alpha``), so
    the fold allocates nothing: the (n_bins, chunk, nx, ny) product a
    broadcast would make is 1.6 GB at 2048^2 x 16 probes x 3 bins."""
    for f, ph in enumerate(phases):
        acc[f].add_(psi, alpha=complex(ph))
    if mean is not None:
        mean.add_(psi)


def _digest(t) -> str:
    a = t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)
    return hashlib.md5(np.ascontiguousarray(a).tobytes()).hexdigest()


def _save_array(d: Path, name: str, t: torch.Tensor) -> None:
    """``t`` as <name>.npy, written to a temporary name and renamed."""
    tmp = d / f"{name}.tmp.npy"
    np.save(tmp, t.detach().cpu().numpy())
    tmp.replace(d / f"{name}.npy")


def _load_array(d: Path, name: str, like: torch.Tensor) -> torch.Tensor:
    arr = np.load(d / f"{name}.npy")
    if arr.shape != tuple(like.shape):
        raise ValueError(f"checkpoint array {name} has shape {arr.shape}, "
                         f"the stream's is {tuple(like.shape)}")
    return torch.from_numpy(arr).to(device=like.device, dtype=like.dtype)


def _write_manifest(d: Path, manifest: dict) -> None:
    """The manifest, last, so that a checkpoint without one is incomplete."""
    tmp = d / "manifest.json.tmp"
    tmp.write_text(json.dumps(manifest))
    tmp.replace(d / "manifest.json")


def _read_manifest(d: Path, key: str) -> dict:
    manifest = json.loads((Path(d) / "manifest.json").read_text())
    if manifest["key"] != key:
        raise ValueError(
            "checkpoint config mismatch: the stream's parameters "
            f"(key {key}) differ from the checkpoint's "
            f"(key {manifest['key']})")
    return manifest


class StreamingTACAW:
    """Accumulate |Psi(omega, q)|^2 at selected frequencies, frame by frame.

    Args:
        spec: the SimSpec.
        probes: (n_probes, nx, ny) complex probe batch; its device runs the
            stream and holds the accumulators.
        n_frames: total number of frames that will be streamed.
        timestep: MD timestep in ps (frequencies are THz).
        frequencies: target frequencies in THz; each maps to its nearest
            fftfreq bin (the nearest-bin rule of
            TACAWData.spectral_diffraction). None -> all n_frames bins.
        layer_index: recorded layer to analyze (default: the last).
        probe_chunk: at most this many probes' exit waves live at once;
            each chunk has its own accumulators. None = all at once.
    """

    def __init__(self, spec: SimSpec, probes: torch.Tensor, n_frames: int,
                 timestep: float,
                 frequencies: Optional[Sequence[float]] = None,
                 layer_index: int = -1, probe_chunk: Optional[int] = None,
                 mesh=None):
        _no_mesh(mesh)
        self.spec = spec
        self.probes = probes
        self.n_frames = int(n_frames)
        self.timestep = float(timestep)
        n_layers = len(spec.record_layers) if spec.record_layers else 1
        self.layer_index = layer_index % n_layers

        all_freqs = np.fft.fftfreq(self.n_frames, d=self.timestep)
        if frequencies is None:
            self.bins = np.arange(self.n_frames)
        else:
            self.bins = np.array([int(np.argmin(np.abs(all_freqs - f)))
                                  for f in frequencies])
        self.frequencies = all_freqs[self.bins]
        # The mean tracker only matters for the f=0 bin.
        self._track_mean = bool(np.any(self.bins == 0))

        n_probes, nx, ny = probes.shape
        self.probe_chunk = min(probe_chunk or n_probes, n_probes)
        self._chunk_slices = [slice(c, min(c + self.probe_chunk, n_probes))
                              for c in range(0, n_probes, self.probe_chunk)]
        nb = len(self.bins)
        cdt = spec.precision.complex
        zeros = lambda *shape: torch.zeros(shape, dtype=cdt,
                                           device=probes.device)
        self._acc_chunks = [zeros(nb, sl.stop - sl.start, nx, ny)
                            for sl in self._chunk_slices]
        self._mean_chunks = ([zeros(sl.stop - sl.start, nx, ny)
                              for sl in self._chunk_slices]
                             if self._track_mean else None)
        self._seen = set()

    def _phases(self, frame_indices) -> np.ndarray:
        return phase_factors(frame_indices, self.bins, self.n_frames,
                             self.spec.precision.np_real)

    def _fold_frame(self, positions: torch.Tensor, phases) -> None:
        """One frame: rasterize once, then each probe chunk's exit waves
        folded into its accumulators before the next chunk runs."""
        v = rasterize(positions, self.spec.plan, self.spec.precision)
        for i, sl in enumerate(self._chunk_slices):
            psi = exit_waves_from_potential(
                v, self.probes[sl], self.spec)[..., self.layer_index]
            fold(self._acc_chunks[i],
                 self._mean_chunks[i] if self._track_mean else None,
                 psi, phases)
            del psi

    def add_frame(self, frame_index: int, positions) -> None:
        """Feed one MD frame (each index exactly once, any order)."""
        t = int(frame_index)
        if t in self._seen:
            raise ValueError(f"frame {t} already streamed")
        pos = _positions(positions, self.probes.device)
        self._fold_frame(pos, self._phases([t])[0])
        self._seen.add(t)

    def add_frame_block(self, frame_indices, positions_block) -> None:
        """Feed a block of frames: ``frame_indices`` (B,) and
        ``positions_block`` (B, n_atoms, 3). The whole block is checked
        before any state changes; its frames fold in order, exactly as B
        calls of ``add_frame`` would."""
        idx = [int(t) for t in frame_indices]
        dup = self._seen.intersection(idx)
        if dup or len(set(idx)) != len(idx):
            raise ValueError(f"frame indices fed more than once: "
                             f"{sorted(dup) or idx}")
        pos = _positions(positions_block, self.probes.device)
        if pos.dim() != 3 or pos.shape[0] != len(idx):
            raise ValueError(
                f"positions_block must be ({len(idx)}, n_atoms, 3), "
                f"got {tuple(pos.shape)}")
        phases = self._phases(idx)
        for k in range(len(idx)):
            self._fold_frame(pos[k], phases[k])
        self._seen.update(idx)

    def intensity(self) -> torch.Tensor:
        """(n_selected, n_probes, nx, ny) real intensity, on the stream's
        device. The f=0 bin gets the mean-subtraction correction (for
        integer bins X0 - n*mean is the only term it changes)."""
        if len(self._seen) != self.n_frames:
            raise ValueError(
                f"streamed {len(self._seen)} of {self.n_frames} frames")
        nb = len(self.bins)
        n_probes, nx, ny = self.probes.shape
        out = torch.empty((nb, n_probes, nx, ny),
                          dtype=self.spec.precision.real,
                          device=self.probes.device)
        for i, sl in enumerate(self._chunk_slices):
            acc = self._acc_chunks[i]
            for f in range(nb):
                x = acc[f]
                if self._track_mean and self.bins[f] == 0:
                    x = x - self._mean_chunks[i]
                torch.abs(x, out=out[f, sl])
        return out.square_()

    def spectrum(self, probe_index: Optional[int] = None) -> np.ndarray:
        """k-summed spectrum at the selected bins (host array): the mean over
        probes, or one probe's."""
        s = self.intensity().sum(dim=(2, 3)).cpu().numpy()  # (n_sel, P)
        if probe_index is None:
            return s.mean(axis=1)
        return s[:, probe_index]

    # --- checkpoint / resume ---------------------------------------------
    #
    # Resume = build an identically configured stream, restore(), and feed
    # only the remaining frames; the result is bit-identical because the
    # fold order within each accumulator is the feed order.

    def checkpoint_key(self) -> str:
        """md5-12 over everything that must match for a restore to be
        valid (the JAX package's key tuple without its mesh entries)."""
        g = self.spec.grid
        params = str((g.nx, g.ny, g.nz, self.spec.eV, self.spec.dz,
                      self.spec.record_layers, self.layer_index,
                      self.n_frames, self.timestep,
                      tuple(int(b) for b in self.bins), _digest(self.probes),
                      tuple(s.start for s in self._chunk_slices)))
        return hashlib.md5(params.encode()).hexdigest()[:12]

    def _arrays(self) -> dict:
        out = {f"acc_{i}": a for i, a in enumerate(self._acc_chunks)}
        if self._track_mean:
            out.update({f"mean_{i}": m
                        for i, m in enumerate(self._mean_chunks)})
        return out

    def save_checkpoint(self, directory) -> None:
        """Write the accumulators (one .npy each) and then the manifest
        (key, frames seen) to ``directory``; every file is written to a
        temporary name and renamed."""
        d = Path(directory)
        d.mkdir(parents=True, exist_ok=True)
        for name, arr in self._arrays().items():
            _save_array(d, name, arr)
        _write_manifest(d, {"key": self.checkpoint_key(),
                            "seen": sorted(int(t) for t in self._seen),
                            "n_frames": self.n_frames})

    def restore(self, directory) -> set:
        """Load a checkpoint written by an identically configured stream.
        Returns the set of frame indices already folded in (feed the rest).
        Raises ValueError on a config mismatch."""
        d = Path(directory)
        manifest = _read_manifest(d, self.checkpoint_key())
        self._acc_chunks = [_load_array(d, f"acc_{i}", a)
                            for i, a in enumerate(self._acc_chunks)]
        if self._track_mean:
            self._mean_chunks = [_load_array(d, f"mean_{i}", m)
                                 for i, m in enumerate(self._mean_chunks)]
        self._seen = set(int(t) for t in manifest["seen"])
        return set(self._seen)


def _haadf_mask(spec: SimSpec, collection_angle: float,
               eV: Optional[float] = None) -> np.ndarray:
    """The annular detector of HAADFData on the fftshifted k grid:
    q > (collection_angle mrad) / lambda, strict, on the nominal k axes
    (quirk 12) or, on an oblique cell, the true |k| from the metric."""
    lam = _wavelength(eV if eV is not None else spec.eV)
    if spec.ksq2d is not None:
        q = np.sqrt(np.fft.fftshift(np.asarray(spec.ksq2d)))
    else:
        kxs = spec.grid.kxs_nominal_shifted()
        kys = spec.grid.kys_nominal_shifted()
        q = np.sqrt(kxs[:, None] ** 2 + kys[None, :] ** 2)
    return q > (collection_angle * 1e-3) / lam


class StreamingHAADF:
    """Running ADF accumulation: the mean over frames of the annular-masked
    k-space amplitude sum per probe (haadf_data.py:43-65 semantics).

    ``mrad`` / ``use_smatrix`` / ``prism_f``: large scans route each frame
    through the S-matrix (``engine.smatrix``) instead of propagating every
    probe. use_smatrix=None routes automatically above
    ``smatrix.SMATRIX_MIN_PROBES`` when ``mrad`` (the aperture) is given.
    ``aberrations`` / ``defocus`` describe the base probe for the
    coefficient synthesis (they must match how ``probes`` was built). f=1
    is exact; f>1 is the PRISM approximation. ``beam_chunk`` bounds the
    basis build's beams at once, ``synth_chunk`` the synthesis product's
    probe rows. ``probes=None`` (S-matrix only) needs ``device``.

    ``probe_chunk``: direct path — at most this many probes' exit waves
    live at once. None = all at once.
    """

    def __init__(self, spec: SimSpec, probes, probe_positions,
                 collection_angle: float = 45, eV: Optional[float] = None,
                 intensity: bool = False, layer_index: int = -1,
                 mesh=None, mrad: Optional[float] = None,
                 use_smatrix: Optional[bool] = None, prism_f: int = 1,
                 aberrations=None, defocus: float = 0.0,
                 beam_chunk: int = 64, probe_chunk: Optional[int] = None,
                 synth_chunk: int = 128, device="cuda"):
        _no_mesh(mesh)
        self.spec = spec
        if probes is None and not use_smatrix:
            raise ValueError("probes=None requires use_smatrix=True")
        self.probes = probes
        self.device = probes.device if probes is not None \
            else torch.device(device)
        self.probe_positions = np.asarray(probe_positions, dtype=np.float64)
        self.intensity = bool(intensity)
        n_layers = len(spec.record_layers) if spec.record_layers else 1
        self.layer_index = layer_index % n_layers
        prec = spec.precision
        self._mask = torch.as_tensor(
            _haadf_mask(spec, collection_angle, eV),
            device=self.device).to(prec.real)
        n_probes = (probes.shape[0] if probes is not None
                    else len(self.probe_positions))
        if probes is not None and probes.shape[0] != \
                len(self.probe_positions):
            raise ValueError(
                f"probes ({probes.shape[0]}) and probe_positions "
                f"({len(self.probe_positions)}) disagree")
        self._n = 0
        self._seen = set()      # frame indices, when callers give them

        from .smatrix import build_beams, smatrix_auto
        g = spec.grid
        if use_smatrix is None:
            use_smatrix = (mrad is not None
                           and smatrix_auto(n_probes, mrad, spec.ksq2d,
                                            g.nx, g.ny, prism_f))
        if use_smatrix:
            if mrad is None:
                raise ValueError("use_smatrix=True needs the probe "
                                 "aperture (mrad=...)")
            beam_eV = eV if eV is not None else spec.eV
            self._beams = build_beams(g.xs, g.ys, mrad, beam_eV, f=prism_f)
            if prism_f == 1:
                self._sm_weights = self._mask      # exact detector parity
            else:
                wx, wy = g.nx // prism_f, g.ny // prism_f
                kxs_w = np.fft.fftshift(np.fft.fftfreq(wx, d=g.dx))
                kys_w = np.fft.fftshift(np.fft.fftfreq(wy, d=g.dy))
                qw = np.sqrt(kxs_w[:, None] ** 2 + kys_w[None, :] ** 2)
                self._sm_weights = torch.as_tensor(
                    qw > (collection_angle * 1e-3) / _wavelength(beam_eV),
                    device=self.device).to(prec.real)
            self._sm_kwargs = dict(aberrations=aberrations,
                                   defocus=defocus,
                                   probe_chunk=synth_chunk)
            self._beam_chunk = beam_chunk
        self.use_smatrix = bool(use_smatrix)
        self._acc = torch.zeros((n_probes,), dtype=prec.real,
                                device=self.device)
        self.probe_chunk = probe_chunk

    def _track(self, frame_indices) -> None:
        """Record the frame indices, refusing a repeat before any state
        changes."""
        if frame_indices is None:
            return
        idx = ([int(frame_indices)]
               if np.ndim(frame_indices) == 0 else
               [int(t) for t in frame_indices])
        dup = self._seen.intersection(idx)
        if dup or len(set(idx)) != len(idx):
            raise ValueError(
                f"frame indices fed more than once: {sorted(dup) or idx}")
        self._seen.update(idx)

    def _detect(self, psi: torch.Tensor) -> torch.Tensor:
        """(chunk,) masked k sums of |psi| (or |psi|^2)."""
        amp = psi.abs()
        if self.intensity:
            amp = amp * amp
        return (amp * self._mask).sum(dim=(1, 2))

    def _fold_frame(self, positions: torch.Tensor) -> None:
        if self.use_smatrix:
            self._fold_frame_smatrix(positions)
            return
        v = rasterize(positions, self.spec.plan, self.spec.precision)
        n = self.probes.shape[0]
        chunk = self.probe_chunk if self.probe_chunk is not None else n
        vals = torch.cat([
            self._detect(exit_waves_from_potential(
                v, self.probes[a:a + chunk], self.spec)[..., self.layer_index])
            for a in range(0, n, chunk)])
        self._acc += vals

    def _fold_frame_smatrix(self, positions: torch.Tensor) -> None:
        """One frame through the S-matrix: the basis build, then the
        synthesis and detector reduction per probe chunk; no per-probe
        exit waves are kept."""
        from .smatrix import _synth_chunks, compute_smatrix
        g = self.spec.grid
        sm = compute_smatrix(positions, self.spec.plan, self._beams,
                             xs=g.xs, ys=g.ys, dz=self.spec.dz,
                             precision=self.spec.precision,
                             beam_chunk=self._beam_chunk,
                             kmax2=self.spec.kmax2)
        kw = self._sm_kwargs
        vals = _synth_chunks(sm, self.probe_positions, self.spec.precision,
                             kw["probe_chunk"],
                             "int" if self.intensity else "amp",
                             weights=self._sm_weights,
                             aberrations=kw["aberrations"],
                             defocus=kw["defocus"])
        self._acc += vals * float(self._beams.f ** 2)

    def add_frame(self, positions, frame_index=None) -> None:
        """Feed one frame. ``frame_index`` (optional) records which frames
        were folded in, for checkpoint/resume; without it, resume relies on
        the frame count alone."""
        self._track(frame_index)
        self._fold_frame(_positions(positions, self.device))
        self._n += 1

    def add_frame_block(self, positions_block, frame_indices=None) -> None:
        """Feed (B, n_atoms, 3) frames, in order. The whole block is checked
        before any state changes, and it equals B calls of ``add_frame``
        bit for bit. ``frame_indices``: optional B indices for resume
        bookkeeping."""
        pos = _positions(positions_block, self.device)
        if pos.dim() != 3:
            raise ValueError(
                f"positions_block must be (B, n_atoms, 3), "
                f"got {tuple(pos.shape)}")
        B = pos.shape[0]
        if frame_indices is not None and len(frame_indices) != B:
            raise ValueError(
                f"frame_indices has {len(frame_indices)} entries for "
                f"a {B}-frame block")
        self._track(frame_indices)
        for k in range(B):
            self._fold_frame(pos[k])
        self._n += B

    # --- checkpoint / resume ---------------------------------------------

    def checkpoint_key(self) -> str:
        """md5-12 over everything that must match for a restore (the JAX
        package's key tuple without its mesh entries)."""
        g = self.spec.grid
        sm_cfg = ((self._beams.f, self._beams.mrad, self._beams.n_beams,
                   repr(self._sm_kwargs)) if self.use_smatrix else None)
        params = str((g.nx, g.ny, g.nz, self.spec.eV, self.spec.dz,
                      self.spec.record_layers, self.layer_index,
                      self.intensity,
                      (_digest(self.probes) if self.probes is not None
                       else "smatrix-only"),
                      _digest(self._mask), _digest(self.probe_positions),
                      sm_cfg))
        return hashlib.md5(params.encode()).hexdigest()[:12]

    def save_checkpoint(self, directory) -> None:
        """The accumulator (acc.npy) and then the manifest (key, frame
        count, frames seen), each written to a temporary name and renamed."""
        d = Path(directory)
        d.mkdir(parents=True, exist_ok=True)
        _save_array(d, "acc", self._acc)
        _write_manifest(d, {"key": self.checkpoint_key(),
                            "n": int(self._n),
                            "seen": sorted(int(t) for t in self._seen)})

    def restore(self, directory) -> set:
        """Load a checkpoint from an identically configured stream; returns
        the frame indices already folded in (empty if the writer never
        passed ``frame_index``: resume by count via ``n_streamed`` then).
        Raises ValueError on a mismatch."""
        d = Path(directory)
        manifest = _read_manifest(d, self.checkpoint_key())
        self._acc = _load_array(d, "acc", self._acc)
        self._n = int(manifest["n"])
        self._seen = set(int(t) for t in manifest.get("seen", []))
        return set(self._seen)

    @property
    def n_streamed(self) -> int:
        """Frames folded in so far (restored counts included)."""
        return self._n

    def image(self) -> np.ndarray:
        """(n_x, n_y) ADF image over the reconstructed scan grid (the
        nearest probe to each point of the unique-x by unique-y grid)."""
        if self._n == 0:
            raise ValueError("no frames streamed")
        from ..analysis.detectors import _scan_grid
        collected = self._acc.cpu().numpy() / self._n
        xs, ys, nearest = _scan_grid(self.probe_positions)
        return collected[nearest].reshape(len(xs), len(ys))
