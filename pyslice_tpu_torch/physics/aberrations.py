"""Probe aberrations: the low-order aberration surface.

Counterpart of ``pyslice_tpu/physics/aberrations.py`` (Krivanek notation,
Kirkland Eq. 5.45 form):

    chi(q, phi) = (2 pi / lam) * [
        (lam^2 q^2 / 2) * (C1 + A1 cos 2(phi - phi_A1))
      + (lam^3 q^3 / 3) * (B2 cos  (phi - phi_B2) + A2 cos 3(phi - phi_A2))
      + (lam^4 q^4 / 4) * (C3 + A3 cos 4(phi - phi_A3))
      + (lam^6 q^6 / 6) *  C5 ]

    transfer(q, phi) = exp(-i chi)

q = |k| in 1/Angstrom, coefficients in Angstrom, azimuths in radians.
``aberrate(C1=dz)`` is exactly ``defocus(dz)``. Oblique cells carry |k|^2
through ``ksq`` for the isotropic terms; the azimuthal terms need Cartesian
k and raise there. The phase is computed in NumPy in the run precision, as
the JAX package computes it, and applied with ``torch.fft``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.dtypes import get_precision


@dataclasses.dataclass(frozen=True)
class Aberrations:
    """Aberration coefficients, Krivanek notation, lengths in Angstrom,
    azimuths (phi_*) in radians.

    C1: defocus (== Probe.defocus dz). A1: twofold astigmatism. B2: axial
    coma. A2: threefold astigmatism. C3: spherical aberration (Cs).
    A3: fourfold astigmatism. C5: fifth-order spherical aberration.
    """
    C1: float = 0.0
    A1: float = 0.0
    phi_A1: float = 0.0
    B2: float = 0.0
    phi_B2: float = 0.0
    A2: float = 0.0
    phi_A2: float = 0.0
    C3: float = 0.0
    A3: float = 0.0
    phi_A3: float = 0.0
    C5: float = 0.0

    def is_isotropic(self) -> bool:
        return self.A1 == 0.0 and self.B2 == 0.0 and self.A2 == 0.0 \
            and self.A3 == 0.0

    def is_zero(self) -> bool:
        return self.is_isotropic() and self.C1 == 0.0 and self.C3 == 0.0 \
            and self.C5 == 0.0

    def scherzer_defocus(self, lam: float) -> float:
        """Scherzer defocus -sqrt(1.5 C3 lam) (Kirkland Eq. 5.31)."""
        if self.C3 <= 0:
            raise ValueError("Scherzer defocus needs C3 > 0")
        return -float(np.sqrt(1.5 * self.C3 * lam))


def chi_phase(ksq, kx=None, ky=None, *, lam: float, ab: Aberrations):
    """The aberration phase chi on a k grid (radians). ``ksq``: |k|^2
    (1/A^2); ``kx``/``ky``: Cartesian k grids, needed only for nonzero
    anisotropic coefficients. NumPy arrays or tensors."""
    q2 = ksq
    l2 = lam * lam
    chi = (np.pi * lam) * ab.C1 * q2
    if ab.C3 != 0.0:
        chi = chi + (0.5 * np.pi * lam * l2) * ab.C3 * (q2 * q2)
    if ab.C5 != 0.0:
        chi = chi + (np.pi / 3.0 * lam * l2 * l2) * ab.C5 * (q2 * q2 * q2)
    if ab.is_isotropic():
        return chi
    if kx is None or ky is None:
        raise ValueError(
            "anisotropic aberrations (A1/B2/A2/A3) need Cartesian kx/ky "
            "grids — unavailable on oblique cells")
    xp = torch if isinstance(q2, torch.Tensor) else np
    phi = xp.arctan2(ky, kx)
    q = xp.sqrt(q2)
    if ab.A1 != 0.0:
        chi = chi + (np.pi * lam) * ab.A1 * q2 * xp.cos(2 * (phi - ab.phi_A1))
    q3 = q2 * q
    if ab.B2 != 0.0:
        chi = chi + (2 * np.pi / 3 * l2) * ab.B2 * q3 * xp.cos(phi - ab.phi_B2)
    if ab.A2 != 0.0:
        chi = chi + (2 * np.pi / 3 * l2) * ab.A2 * q3 \
            * xp.cos(3 * (phi - ab.phi_A2))
    if ab.A3 != 0.0:
        chi = chi + (0.5 * np.pi * lam * l2) * ab.A3 * (q2 * q2) \
            * xp.cos(4 * (phi - ab.phi_A3))
    return chi


def apply_aberrations(array: torch.Tensor, kxs, kys, lam: float,
                      ab: Aberrations, precision=None,
                      ksq=None) -> torch.Tensor:
    """``array`` (real-space probe, (..., nx, ny) complex tensor) times the
    transfer function exp(-i chi) in k space. ``ksq``: optional (nx, ny)
    |k|^2 for oblique cells (isotropic coefficients only)."""
    prec = get_precision(precision)
    if ab.is_zero():
        return array
    rdt = prec.np_real
    if ksq is not None:
        chi = chi_phase(np.asarray(ksq, dtype=rdt), lam=lam, ab=ab)
    else:
        kx = np.asarray(kxs, dtype=rdt)[:, None]
        ky = np.asarray(kys, dtype=rdt)[None, :]
        kxg, kyg = np.broadcast_arrays(kx, ky)
        chi = chi_phase(kx * kx + ky * ky, kxg, kyg, lam=lam, ab=ab)
    chi = torch.as_tensor(np.asarray(chi, dtype=rdt), device=array.device)
    transfer = torch.complex(torch.cos(chi), -torch.sin(chi))
    return torch.fft.ifft2(torch.fft.fft2(array) * transfer)
