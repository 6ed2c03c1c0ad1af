"""Electron probe wavefunctions.

Counterpart of ``pyslice_tpu/physics/probe.py``: plain functions on tensors
(``probe_array``, ``fresnel_kernel``, ``defocus``, ``shift_probes``,
``probe_grid``) and the ``Probe`` class facade of the reference API.

Physics:
* plane wave (mrad == 0): uniform unit amplitude;
* convergent beam: circular aperture of radius (mrad*1e-3)/lambda in k
  space, probe = ifftshift(ifft2(mask)) — an Airy disk;
* defocus: one signed multiply by the Fresnel kernel in k space (dz < 0
  back-propagates; ``compat_reference=True`` keeps the reference's double
  negation, quirk 13); ``Probe.aberrate`` applies the full aberration
  surface (``physics.aberrations``);
* positioning: k-space phase ramp exp(+2 pi i k . p) per position, which
  displaces the probe by -p (quirk 14, kept for parity).
"""

from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import torch

from ..core.constants import wavelength as _wavelength
from ..core.dtypes import as_real, get_precision
from ..utils.plotting import pyplot
from .aberrations import Aberrations, apply_aberrations


def _phase_to_complex(phase: torch.Tensor) -> torch.Tensor:
    return torch.complex(torch.cos(phase), torch.sin(phase))


def probe_array(xs, ys, mrad: float, eV: float, precision=None, ksq=None,
                *, device) -> torch.Tensor:
    """Base probe, (nx, ny) complex on ``device``. ``ksq``: optional
    (nx, ny) |k|^2 (fftfreq order) for oblique cells."""
    prec = get_precision(precision)
    xs = np.asarray(xs)
    ys = np.asarray(ys)
    nx, ny = len(xs), len(ys)
    if mrad == 0:
        return torch.ones((nx, ny), dtype=prec.complex, device=device)
    radius = (mrad * 1e-3) / _wavelength(eV)
    if ksq is not None:
        radii = np.sqrt(np.asarray(ksq))
    else:
        kxs = np.fft.fftfreq(nx, d=xs[1] - xs[0])
        kys = np.fft.fftfreq(ny, d=ys[1] - ys[0])
        radii = np.sqrt(kxs[:, None] ** 2 + kys[None, :] ** 2)
    mask = torch.as_tensor(radii < radius, device=device).to(prec.complex)
    return torch.fft.ifftshift(torch.fft.ifft2(mask))


def fresnel_kernel(kxs, kys, lam: float, dz: float, precision=None, *,
                   device) -> torch.Tensor:
    """P(kx, ky, dz) = exp(-i pi lambda dz (kx^2 + ky^2)) (Kirkland 6.65),
    computed in the precision's real type as the JAX package does."""
    prec = get_precision(precision)
    kx = as_real(kxs, prec, device)
    ky = as_real(kys, prec, device)
    ksq = kx[:, None] ** 2 + ky[None, :] ** 2
    return _phase_to_complex((-np.pi * lam * dz) * ksq)


def defocus(array: torch.Tensor, kxs, kys, lam: float, dz: float,
            precision=None, compat_reference: bool = False,
            ksq=None) -> torch.Tensor:
    """Defocus by dz Angstrom: positive dz forward-propagates, negative
    back-propagates (defocus(-d) inverts defocus(+d)); dz == 0 is the
    identity. ``compat_reference=True`` replicates quirk 13, where the
    reference's dz < 0 branch behaves like defocus(+|dz|)."""
    if dz == 0:
        return array
    if dz < 0:
        if compat_reference:
            dz = -dz
        else:
            warnings.warn(
                "defocus(dz<0) back-propagates here; the reference's "
                "dz<0 branch double-negates and behaves like defocus(+dz). "
                "Pass compat_reference=True to replicate the reference.",
                stacklevel=2)
    prec = get_precision(precision)
    if ksq is not None:
        phase = torch.as_tensor((-np.pi * lam * dz) * np.asarray(ksq),
                                device=array.device).to(prec.real)
        P = _phase_to_complex(phase)
    else:
        P = fresnel_kernel(kxs, kys, lam, dz, prec, device=array.device)
    return torch.fft.ifft2(torch.fft.fft2(array) * P)


def shift_probes(base_array: torch.Tensor, kxs, kys, positions,
                 precision=None, cell2d=None) -> torch.Tensor:
    """(n_probes, nx, ny) sub-pixel-shifted probes via k-space phase ramps
    exp(2 pi i (kx px + ky py)); the base probe is transformed once."""
    prec = get_precision(precision)
    dev = base_array.device
    base_array = base_array.to(prec.complex)
    positions = np.asarray(positions, dtype=np.float64).reshape(-1, 2)
    if cell2d is not None:
        # Oblique cells: integer frequencies against FRACTIONAL shifts.
        nx, ny = base_array.shape[-2:]
        positions = positions @ np.linalg.inv(
            np.asarray(cell2d, dtype=np.float64)).T
        kxs = np.rint(np.fft.fftfreq(nx) * nx)
        kys = np.rint(np.fft.fftfreq(ny) * ny)
    kx = as_real(kxs, prec, dev)
    ky = as_real(kys, prec, dev)
    pos = as_real(positions, prec, dev)
    base_k = torch.fft.fft2(base_array)
    phase = (2.0 * np.pi) * (kx[None, :, None] * pos[:, 0, None, None]
                             + ky[None, None, :] * pos[:, 1, None, None])
    return torch.fft.ifft2(base_k[None] * _phase_to_complex(phase))


def probe_grid(xlims, ylims, n: int, m: int) -> np.ndarray:
    """(n*m, 2) scan positions in the reference's order: meshgrid('xy') of
    n x-values by m y-values, flattened row-major (x fastest)."""
    x, y = np.meshgrid(np.linspace(*xlims, n), np.linspace(*ylims, m))
    return np.reshape([x, y], (2, x.size)).T


class Probe:
    """Reference-compatible probe object.

    ``array`` is a tensor on ``device``: (nx, ny) for one probe or
    (n_probes, nx, ny) for a batch (``create_batched_probes``).
    """

    def __init__(self, xs, ys, mrad: float, eV: float, array=None,
                 precision=None, *, device, cell2d=None, ksq=None):
        self.precision = get_precision(precision)
        self.device = torch.device(device)
        self.xs = np.asarray(xs)
        self.ys = np.asarray(ys)
        self.mrad = mrad
        self.eV = eV
        self.wavelength = _wavelength(eV)
        self.cell2d = (np.asarray(cell2d, dtype=np.float64)
                       if cell2d is not None else None)
        self.ksq = np.asarray(ksq) if ksq is not None else None
        self.kxs = np.fft.fftfreq(len(self.xs), d=float(self.xs[1] - self.xs[0]))
        self.kys = np.fft.fftfreq(len(self.ys), d=float(self.ys[1] - self.ys[0]))
        if array is not None:
            self.array = torch.as_tensor(array, device=self.device).to(
                self.precision.complex)
        else:
            self.array = probe_array(self.xs, self.ys, mrad, eV,
                                     self.precision, ksq=self.ksq,
                                     device=self.device)

    @property
    def n_probes(self) -> int:
        return 1 if self.array.dim() == 2 else int(self.array.shape[0])

    def copy(self) -> "Probe":
        return Probe(self.xs, self.ys, self.mrad, self.eV,
                     array=self.array.clone(), precision=self.precision,
                     device=self.device, cell2d=self.cell2d, ksq=self.ksq)

    def to_cpu(self) -> np.ndarray:
        return self.array.cpu().numpy()

    def defocus(self, dz: float, compat_reference: bool = False) -> None:
        """In-place defocus (the reference mutates the probe)."""
        self.array = defocus(self.array, self.kxs, self.kys,
                             self.wavelength, dz, self.precision,
                             compat_reference=compat_reference, ksq=self.ksq)

    def aberrate(self, aberrations=None, **coeffs) -> None:
        """In-place aberration surface: an ``aberrations.Aberrations`` or
        its coefficients as keywords (C1/A1/phi_A1/B2/phi_B2/A2/phi_A2/C3/
        A3/phi_A3/C5, Angstrom / radians). ``aberrate(C1=dz)`` is
        ``defocus(dz)``."""
        if aberrations is None:
            aberrations = Aberrations(**coeffs)
        elif coeffs:
            aberrations = dataclasses.replace(aberrations, **coeffs)
        self.array = apply_aberrations(self.array, self.kxs, self.kys,
                                       self.wavelength, aberrations,
                                       self.precision, ksq=self.ksq)

    def shifted_batch(self, positions) -> "Probe":
        """New Probe whose array is the (n_probes, nx, ny) shifted batch."""
        base = self.array if self.array.dim() == 2 else self.array[0]
        batch = shift_probes(base, self.kxs, self.kys, positions,
                             self.precision, cell2d=self.cell2d)
        return Probe(self.xs, self.ys, self.mrad, self.eV, array=batch,
                     precision=self.precision, device=self.device,
                     cell2d=self.cell2d, ksq=self.ksq)


    def plot(self):
        """Draw |probe|^0.25 (the first of a batch) over the grid."""
        plt = pyplot("Probe.plot")
        fig, ax = plt.subplots()
        arr = np.abs(self.to_cpu()) ** 0.25
        if arr.ndim == 3:
            arr = arr[0]
        extent = (self.xs.min(), self.xs.max(), self.ys.min(), self.ys.max())
        ax.imshow(arr.T, cmap="inferno", extent=extent)
        plt.show()


def create_batched_probes(base_probe: Probe, probe_positions) -> Probe:
    """Probe whose array is (n_probes, nx, ny), each shifted to its
    position (reference multislice.py:198-235)."""
    return base_probe.shifted_batch(np.asarray(probe_positions))
