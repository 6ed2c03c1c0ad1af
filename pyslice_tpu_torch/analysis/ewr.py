"""Focal-series exit-wave reconstruction.

Counterpart of ``pyslice_tpu/analysis/ewr.py``. An experiment records
only intensities; recovering the complex exit wave from a through-focal
series of HRTEM images is the classic imaging-side inverse problem. This
module implements IWFR (iterative wave-function reconstruction: Allen,
McBride, O'Leary & Oxley, Ultramicroscopy 100 (2004) 91-104) against the
objective-lens model of the forward CTEM path
(``engine.ctem.objective_transfer``):

    phi_n = ifft2( fft2(psi) * H_n ),   H_n = A(k) exp(-i chi_n(k)),
    I_n   = |phi_n|^2.

Each iteration projects the estimate onto every measured plane (replace
|phi_n| with sqrt(I_n), keep the phase), back-propagates with conj(H_n)
and averages. Noiseless, aperture-free data makes the true wave a fixed
point; with an aperture the result is the band-limited wave.

The solve is an eager loop of ``torch.fft`` on the device (the JAX
package's is one compiled ``lax.scan`` of XLA FFTs): the focal stack
stays on the device, the planes are one batched FFT, and the residuals
are kept there and read once, at the end.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.dtypes import get_precision
from ..physics.aberrations import Aberrations


def _iwfr(amps: torch.Tensor, transfer: torch.Tensor, psi: torch.Tensor,
          n_iters: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """amps (N, nx, ny) = sqrt(I_n); transfer (N, nx, ny) complex.
    Returns the wave and the (n_iters,) residuals, both on the device."""
    transfer_c = transfer.conj()
    norm = (amps * amps).sum()
    errs = torch.empty(n_iters, dtype=amps.dtype, device=amps.device)
    for i in range(n_iters):
        phi = torch.fft.ifft2(torch.fft.fft2(psi)[None] * transfer)
        mag = phi.abs()
        # relative intensity-domain residual before the modulus projection
        errs[i] = ((mag - amps) ** 2).sum() / norm
        unit = phi / torch.where(mag > 0, mag, torch.ones_like(mag))
        back = torch.fft.ifft2(torch.fft.fft2(amps * unit) * transfer_c)
        psi = back.mean(dim=0)
    return psi, errs


def iwfr_reconstruct(images, defoci: Sequence[float], kxs, kys, *,
                     lam: float,
                     ab: Optional[Aberrations] = None,
                     aperture: Optional[float] = None,
                     ksq=None,
                     n_iters: int = 100,
                     init=None,
                     precision=None,
                     device="cuda") -> Tuple[np.ndarray, np.ndarray]:
    """Reconstruct the exit wave from a through-focal series.

    images: (N, nx, ny) measured image intensities (a tensor runs on its
        own device, an array on ``device``).
    defoci: N defocus values (Angstrom) added to ``ab.C1`` a plane, the
        convention of ``engine.ctem.hrtem_image``'s chromatic nodes.
    ab / aperture / ksq: the objective-lens state shared by all planes
        (``engine.ctem.objective_transfer``; ksq for oblique cells).
    init: optional complex starting wave (nx, ny); default a plane wave
        with the series' mean amplitude.

    Returns (psi (nx, ny) complex host array, residuals (n_iters,)):
    ``residuals[i]`` is sum_n (|phi_n| - sqrt(I_n))^2 / sum_n I_n before
    iteration i's projection. The global phase is unobservable: compare
    reconstructions up to one overall phase factor.
    """
    from ..engine.ctem import _defocus_transfers

    prec = get_precision(precision)
    if isinstance(images, torch.Tensor):
        device = images.device
        imgs = images.to(prec.real)
    else:
        imgs = torch.as_tensor(np.asarray(images, dtype=prec.np_real),
                               device=device)
    if imgs.dim() != 3:
        raise ValueError(f"images must be (n_planes, nx, ny), "
                         f"got {tuple(imgs.shape)}")
    defoci = np.asarray(defoci, dtype=np.float64).ravel()
    if defoci.shape[0] != imgs.shape[0]:
        raise ValueError(f"{imgs.shape[0]} images but {defoci.shape[0]} "
                         f"defoci")
    if bool((imgs < 0).any()):
        raise ValueError("images are intensities and must be >= 0")

    transfer = torch.as_tensor(np.stack(_defocus_transfers(
        kxs, kys, lam, ab, defoci, aperture, ksq, prec)), device=device)
    amps = torch.sqrt(imgs)
    if init is None:
        mean_amp = float(torch.sqrt(imgs.mean()))
        psi0 = torch.full(tuple(imgs.shape[1:]), mean_amp,
                          dtype=prec.complex, device=device)
    else:
        psi0 = (init if isinstance(init, torch.Tensor)
                else torch.as_tensor(np.asarray(init))).to(
            device=device, dtype=prec.complex)
        if tuple(psi0.shape) != tuple(imgs.shape[1:]):
            raise ValueError(f"init shape {tuple(psi0.shape)} != image "
                             f"shape {tuple(imgs.shape[1:])}")
    psi, errs = _iwfr(amps, transfer, psi0, int(n_iters))
    return psi.cpu().numpy(), errs.cpu().numpy()
