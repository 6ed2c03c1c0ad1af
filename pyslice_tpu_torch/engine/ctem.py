"""HRTEM / conventional-TEM image formation.

Counterpart of ``pyslice_tpu/engine/ctem.py``. In CTEM the illumination
is a plane wave and the objective lens after the specimen forms a
real-space image; aberrations act on the exit wave, not on the probe,

    psi_img = ifft2( fft2(psi_exit) * A(k) * exp(-i chi(k)) ),
    I(r)    = |psi_img|^2,

with chi the aberration phase of ``physics.aberrations.chi_phase`` and
A(k) the objective aperture.

Partial coherence (every mechanism averages image intensities):

* temporal (chromatic): Gauss-Hermite quadrature over the defocus spread
  delta = Cc dE/E (``engine.coherence.defocus_series``). The lens acts
  after propagation, so each node costs one FFT pair on the exit wave.
* spatial (illumination convergence): an incoherent average over beam
  tilts, Gaussian with 1/e half-angle ``beam_semiangle`` (mrad), sampled
  by a tensor Gauss-Hermite grid. Each tilt is an exact multislice run
  with a tilted plane wave exp(2 pi i k_t . r); the tilts ride the probe
  axis of the slice-step kernels as one batch.
* thermal: frozen-phonon configurations (``engine.thermal``), or the MD
  trajectory's own frames with ``n_configs=0``.

The transfer function H(k) is computed in NumPy in the run precision, as
the JAX package computes it; the images are ``torch.fft`` on the device
(XLA FFTs in the JAX package, no Pallas kernel). Entry points run on
``device`` (the card unless ``device="cpu"``); a tensor input stays on
its own device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..core.dtypes import get_precision
from ..data.trajectory import Trajectory
from ..physics.aberrations import Aberrations, chi_phase


def objective_transfer(kxs, kys, *, lam: float,
                       ab: Optional[Aberrations] = None,
                       aperture: Optional[float] = None,
                       ksq=None, precision=None) -> np.ndarray:
    """Objective-lens transfer function H(k) = A(k) exp(-i chi(k)) on the
    fftfreq-ordered (nx, ny) grid, a host array of the run's complex type.

    ``aperture``: objective aperture semi-angle in mrad (None = open).
    ``ksq``: optional |k|^2 grid for oblique cells (isotropic aberrations
    only).
    """
    prec = get_precision(precision)
    rdt = prec.np_real
    ab = ab if ab is not None else Aberrations()
    if ksq is not None:
        q2 = np.asarray(ksq, dtype=rdt)
        chi = chi_phase(q2, lam=lam, ab=ab) if not ab.is_zero() else \
            np.zeros_like(q2)
    else:
        kx = np.asarray(kxs, dtype=rdt)[:, None]
        ky = np.asarray(kys, dtype=rdt)[None, :]
        q2 = kx * kx + ky * ky
        if ab.is_zero():
            chi = np.zeros(q2.shape, dtype=rdt)
        elif ab.is_isotropic():
            chi = chi_phase(q2, lam=lam, ab=ab)
        else:
            kxg, kyg = np.broadcast_arrays(kx, ky)
            chi = np.asarray(chi_phase(q2, kxg, kyg, lam=lam, ab=ab))
    cdt = np.complex128 if rdt == np.float64 else np.complex64
    transfer = np.exp(-1j * chi.astype(np.float64)).astype(cdt)
    if aperture is not None:
        k_max = (float(aperture) * 1e-3) / lam
        transfer = transfer * (q2 <= k_max * k_max).astype(cdt)
    return transfer


def _ctf_images(kwaves: torch.Tensor, transfer: torch.Tensor
                ) -> torch.Tensor:
    """|ifft2(kwaves * H)|^2; kwaves (..., nx, ny) unshifted k space."""
    return torch.fft.ifft2(kwaves * transfer).abs() ** 2


def _as_wave(wave, prec, device) -> torch.Tensor:
    """A complex wave as a tensor of the run's complex type; a tensor
    stays on its own device, an array goes to ``device``."""
    if not isinstance(wave, torch.Tensor):
        wave = torch.as_tensor(np.asarray(wave), device=device)
    return wave.to(prec.complex)


def _k_wave(wave: torch.Tensor, input_space: str) -> torch.Tensor:
    if input_space == "real":
        return torch.fft.fft2(wave)
    if input_space == "k":
        return wave
    if input_space == "k_shifted":
        return torch.fft.ifftshift(wave, dim=(-2, -1))
    raise ValueError(f"input_space must be 'real', 'k' or 'k_shifted', "
                     f"got {input_space!r}")


def image_from_exit_wave(exit_wave, kxs, kys, *, lam: float,
                         ab: Optional[Aberrations] = None,
                         aperture: Optional[float] = None,
                         input_space: str = "real",
                         ksq=None, precision=None,
                         device="cuda") -> torch.Tensor:
    """HRTEM image intensity from an exit wave (batch dims broadcast), a
    real tensor on the wave's device.

    ``input_space``: "real" (default, real-space psi), "k" (fftfreq-order
    k space), or "k_shifted" (fftshifted k space, the WFData and
    ``frame_exit_waves`` layout)."""
    prec = get_precision(precision)
    kw = _k_wave(_as_wave(exit_wave, prec, device), input_space)
    transfer = objective_transfer(kxs, kys, lam=lam, ab=ab,
                                  aperture=aperture, ksq=ksq,
                                  precision=prec)
    return _ctf_images(kw, torch.as_tensor(transfer, device=kw.device))


def focal_series(exit_wave, defoci, kxs, kys, *, lam: float,
                 ab: Optional[Aberrations] = None,
                 aperture: Optional[float] = None,
                 input_space: str = "real",
                 ksq=None, precision=None, device="cuda") -> torch.Tensor:
    """Through-focal series of HRTEM images from one exit wave.

    ``defoci`` (N,) are added to ``ab.C1`` a plane; all N lens states act
    on the same (nx, ny) exit wave as one batched FFT. Returns (N, nx, ny)
    image intensities, a tensor on the wave's device. This is the forward
    model that ``analysis.ewr.iwfr_reconstruct`` inverts.
    """
    prec = get_precision(precision)
    wave = _as_wave(exit_wave, prec, device)
    if wave.dim() != 2:
        raise ValueError(f"exit_wave must be 2-D, got {tuple(wave.shape)}")
    kw = _k_wave(wave, input_space)
    transfer = np.stack(_defocus_transfers(kxs, kys, lam, ab, defoci,
                                           aperture, ksq, prec))
    return _ctf_images(kw[None], torch.as_tensor(transfer, device=kw.device))


def _defocus_transfers(kxs, kys, lam, ab, defoci, aperture, ksq, prec):
    """objective_transfer at each defocus added to ab.C1."""
    base = ab if ab is not None else Aberrations()
    return [objective_transfer(
        kxs, kys, lam=lam, ab=dataclasses.replace(base, C1=base.C1 + float(d)),
        aperture=aperture, ksq=ksq, precision=prec)
        for d in np.asarray(defoci, dtype=np.float64).ravel()]


def _tilt_series(beam_semiangle: float, n_tilts: int, lam: float
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """(tilts (m, 2) in 1/Angstrom, weights (m,)) for a Gaussian
    illumination-convergence distribution with 1/e half-angle
    ``beam_semiangle`` (mrad), tensor Gauss-Hermite sampling."""
    if beam_semiangle <= 0:
        return np.zeros((1, 2)), np.ones(1)
    if n_tilts <= 1:
        raise ValueError(
            f"beam_semiangle={beam_semiangle} mrad requests partial "
            f"spatial coherence but n_tilts={n_tilts} collapses the "
            "illumination cone to a single axial plane wave — the result "
            "would be the fully coherent image. Use n_tilts >= 2 (5-9 is "
            "typical), or beam_semiangle=0 for a coherent simulation.")
    x, w = np.polynomial.hermite.hermgauss(int(n_tilts))
    theta = (beam_semiangle * 1e-3) * x          # radians
    w = w / np.sqrt(np.pi)
    kt = theta / lam                              # 1/Angstrom
    tx, ty = np.meshgrid(kt, kt, indexing="ij")
    wx, wy = np.meshgrid(w, w, indexing="ij")
    return (np.stack([tx.ravel(), ty.ravel()], axis=1),
            (wx * wy).ravel())


def snapped_tilts(tilts: np.ndarray, lx: float, ly: float) -> np.ndarray:
    """Tilts (m, 2) in 1/Angstrom snapped to the supercell's reciprocal
    lattice (multiples of 1/lx, 1/ly). An off-lattice exp(2 pi i k_t . r)
    is discontinuous across the periodic boundary, and the wrap artifacts
    swamp the image; a cell much smaller than lam/beta therefore collapses
    all tilts to zero."""
    out = np.array(tilts, dtype=np.float64)
    out[:, 0] = np.round(out[:, 0] * lx) / lx
    out[:, 1] = np.round(out[:, 1] * ly) / ly
    return out


def _tilted_waves(tilts: np.ndarray, xs, ys, prec, device) -> torch.Tensor:
    """(m, nx, ny) plane waves exp(2 pi i k_t . r): the phase formed in
    float64 on ``device`` and cast once to the run's complex type."""
    t = torch.as_tensor(tilts, dtype=torch.float64, device=device)
    x = torch.as_tensor(np.asarray(xs, np.float64), device=device)
    y = torch.as_tensor(np.asarray(ys, np.float64), device=device)
    phase = (2.0 * np.pi) * (t[:, 0, None, None] * x[None, :, None]
                             + t[:, 1, None, None] * y[None, None, :])
    return torch.polar(torch.ones_like(phase), phase).to(prec.complex)


def hrtem_image(trajectory: Trajectory,
                *,
                voltage_eV: float = 100e3,
                aberrations: Optional[Aberrations] = None,
                defocus: float = 0.0,
                objective_aperture: Optional[float] = None,
                Cc: float = 0.0,
                dE: float = 0.0,
                n_nodes: int = 7,
                beam_semiangle: float = 0.0,
                n_tilts: int = 5,
                n_configs: int = 8,
                thermal_sigma: float = 0.1,
                generator: Optional[torch.Generator] = None,
                sampling: float = 0.1,
                slice_thickness: float = 0.5,
                fast_grid: bool = False,
                distribution: str = "gaussian",
                bandwidth_limit: Optional[float] = None,
                device="cuda"
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Partially coherent HRTEM image in one call.

    Plane-wave (optionally tilt-sampled) multislice exit waves a thermal
    configuration -> the objective CTF at each chromatic defocus node ->
    weighted incoherent intensity average. Returns (image (nx, ny) real,
    xs, ys), the real-space axes in Angstrom.

    * ``aberrations`` + ``defocus``: the lens state; ``defocus`` adds to
      C1 (Scherzer: ``Aberrations(C3=Cs).scherzer_defocus(lam)``).
    * ``objective_aperture``: semi-angle in mrad (None = open lens).
    * ``Cc``/``dE``: chromatic aberration (Angstrom) and energy spread
      (eV, FWHM) -> defocus quadrature over delta = Cc dE/E.
    * ``beam_semiangle``/``n_tilts``: spatial coherence, a Gaussian
      illumination cone (1/e half-angle, mrad) sampled by an
      n_tilts x n_tilts Gauss-Hermite tilt grid run as one probe batch.
    * ``n_configs``: frozen-phonon ensemble size, drawn from
      ``generator``; ``0`` uses the MD trajectory's own frames.
    """
    from ..core.constants import wavelength
    from ..core.grids import grid_from_trajectory
    from ..physics.potential import make_plan
    from .coherence import defocus_series, defocus_spread
    from .pipeline import SimSpec, frame_exit_waves
    from .thermal import thermal_configs

    ab = aberrations if aberrations is not None else Aberrations()
    if defocus:
        ab = dataclasses.replace(ab, C1=ab.C1 + float(defocus))
    lam = wavelength(voltage_eV)

    if n_configs and n_configs > 0:
        configs = thermal_configs(trajectory, n_configs, thermal_sigma,
                                  generator, distribution)
    else:
        configs = trajectory
    n_cfg = configs.n_frames

    grid = grid_from_trajectory(trajectory, sampling=sampling,
                                slice_thickness=slice_thickness,
                                fast_grid=fast_grid)
    oblique = grid.is_oblique
    if oblique and beam_semiangle > 0:
        raise ValueError(
            "beam-tilt sampling needs a Cartesian real-space grid; on "
            "oblique cells run with beam_semiangle=0")
    plan = make_plan(grid.xs, grid.ys, grid.zs, configs.positions,
                     configs.atom_types,
                     cell2d=grid.cell2d if oblique else None)
    spec = SimSpec.create(grid, plan, voltage_eV,
                          bandwidth_limit=bandwidth_limit)
    prec = spec.precision

    tilts, tilt_w = _tilt_series(beam_semiangle, n_tilts, lam)
    if tilts.shape[0] == 1:
        waves = torch.ones((1, grid.nx, grid.ny), dtype=prec.complex,
                           device=device)
    else:
        waves = _tilted_waves(snapped_tilts(tilts, grid.lx, grid.ly),
                              grid.xs, grid.ys, prec, device)

    delta = defocus_spread(Cc, dE, voltage_eV) if (Cc and dE) else 0.0
    nodes, node_w = defocus_series(delta, n=n_nodes, center=0.0)
    transfers = [torch.as_tensor(h, device=device) for h in _defocus_transfers(
        spec.plan.kxs, spec.plan.kys, lam, ab, nodes, objective_aperture,
        spec.ksq2d, prec)]
    tilt_w_dev = torch.as_tensor(tilt_w.astype(prec.np_real), device=device)

    acc = torch.zeros((grid.nx, grid.ny), dtype=prec.real, device=device)
    positions = torch.as_tensor(configs.positions, device=device)
    for c in range(n_cfg):
        kw = frame_exit_waves(positions[c], waves, spec)[..., -1]
        kw = torch.fft.ifftshift(kw, dim=(-2, -1))
        for h, w in zip(transfers, node_w):
            imgs = _ctf_images(kw, h)                  # (tilts, nx, ny)
            acc = acc + (float(w) / n_cfg) * torch.einsum(
                "p,pxy->xy", tilt_w_dev, imgs)
    return acc.cpu().numpy(), np.asarray(grid.xs), np.asarray(grid.ys)
