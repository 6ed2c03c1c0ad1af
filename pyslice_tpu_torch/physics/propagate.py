"""The multislice propagation loop.

Counterpart of ``pyslice_tpu/physics/propagate.py`` (Kirkland Eq. 6.66):
per slice z,

    psi <- t_z * psi,            t_z = exp(i sigma V(x, y, z))
    psi <- ifft2(P * fft2(psi)), P   = exp(-i pi lambda dz (kx^2 + ky^2))

with the Fresnel step skipped after the last slice. ``record_layers``
snapshots the post-transmission wave at the given slice indices.

``multislice`` dispatches through ``pick_fused``: one of the hand-written
CUDA families (``fused_family``: the one-launch loop K6 or the two-pass
chains, on power-of-two or mixed-radix grids) for an eligible problem — a
CUDA complex64 (n_probes, nx, ny) batch whose axes the kernels take — and
otherwise the plain ``torch.fft`` loop below. ``ops.config`` is read at
every call ("off" forces the plain loop).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..core.constants import interaction_parameter, wavelength as _wavelength
from ..core.dtypes import Precision, as_real, get_precision
from ..ops import config as ops_config
from ..ops import (fused_step, fused_step_odd, fused_step_odd_resident,
                   fused_step_resident)
from .probe import fresnel_kernel


def fused_family(n_probes: int, nx: int, ny: int, nz: int,
                 precision: str = "single",
                 resident: bool = True) -> Optional[str]:
    """The fused kernel family for a (n_probes, nx, ny) batch through nz
    slices, in the JAX package's order (``physics/propagate.py``'s
    ``pick_fused``): "resident" (K6, power-of-two grid), "aligned" (A/B/C),
    "odd_resident" (K6, mixed-radix grid), "odd" (K4/K5), or None for the
    plain loop. The resident families need ``resident``, nz >= 2 and the
    probe-pixel crossover ``resident_preferred``. A pure function of its
    arguments; ``pick_fused`` adds the device and the flags.

    Differences from the JAX package: the n1*128 sizes that are not powers
    of two go to the mixed-radix families (JAX: aligned); axes above 4096
    go to the plain loop, and so do axes with a stage prime above 31
    (``fused_step_odd.kernel_preferred_mr``: the kernels run such a stage
    as a direct sum, which loses to the plain passes; JAX ran it as an MXU
    matrix product); the JAX VMEM gates (resident grids up to 2^20 pixels
    and 2048 a side; the odd resident kernel's estimate, which at 1023^2
    admits one probe only) are not applied."""
    if precision != "single":
        return None
    preferred = (resident and nz >= 2
                 and fused_step_resident.resident_preferred(n_probes, nx, ny))
    if fused_step.supported_size(nx) and fused_step.supported_size(ny):
        return "resident" if preferred else "aligned"
    if all(fused_step_odd.supported_size_mr(n, n_probes)
           and fused_step_odd.kernel_preferred_mr(n) for n in (nx, ny)):
        return "odd_resident" if preferred else "odd"
    return None


def pick_fused(psi: torch.Tensor, prec: Precision,
               nz: int) -> Optional[str]:
    """``fused_family`` for this batch on its device: a CUDA complex64
    (n_probes, nx, ny) batch, with ``ops.config`` read at every call
    ("off" flags give None or no resident family)."""
    if ops_config.fused_multislice == "off" or psi.dim() != 3:
        return None
    if not psi.is_cuda or psi.dtype != torch.complex64:
        return None
    n_probes, nx, ny = psi.shape
    return fused_family(n_probes, nx, ny, nz, prec.name,
                        resident=ops_config.resident_multislice != "off")


# Each family's exit-wave entry point.
FUSED_ENTRIES = {
    "resident": fused_step_resident.fused_multislice_resident,
    "aligned": fused_step.fused_multislice,
    "odd_resident": fused_step_odd_resident.fused_multislice_odd_resident,
    "odd": fused_step_odd.fused_multislice_odd,
}


def bandwidth_kmax2(kxs, kys, bandwidth_limit: Optional[float],
                    ksq=None) -> Optional[float]:
    """Squared k cutoff for antialiasing bandwidth limiting, as a fraction
    of the tightest axis Nyquist frequency (2/3 is Kirkland's choice). For
    oblique cells the per-axis Nyquist comes from ``ksq``. Returns kmax^2
    in 1/Angstrom^2, or None."""
    if bandwidth_limit is None:
        return None
    if not 0.0 < bandwidth_limit <= 1.0:
        raise ValueError(
            f"bandwidth_limit must be in (0, 1], got {bandwidth_limit}")
    if ksq is not None:
        k2 = np.asarray(ksq)
        nyq_x = float(np.sqrt(k2[k2.shape[0] // 2, 0]))
        nyq_y = float(np.sqrt(k2[0, k2.shape[1] // 2]))
    else:
        nyq_x = float(np.max(np.abs(np.asarray(kxs))))
        nyq_y = float(np.max(np.abs(np.asarray(kys))))
    return (float(bandwidth_limit) * min(nyq_x, nyq_y)) ** 2


def tilt_tangents(tilt_mrad) -> Optional[Tuple[float, float]]:
    """(tan theta_x, tan theta_y) for a beam tilt in mrad, or None. Each
    Fresnel step then gains exp(2 pi i dz (kx tan tx + ky tan ty))."""
    if tilt_mrad is None:
        return None
    tx, ty = (float(t) for t in tilt_mrad)
    if tx == 0.0 and ty == 0.0:
        return None
    return (float(np.tan(tx * 1e-3)), float(np.tan(ty * 1e-3)))


def transmission(potential_slice: torch.Tensor, sigma: float,
                 precision=None) -> torch.Tensor:
    """t = exp(i sigma V); |t| == 1. sigma is cast to the real type first,
    as the JAX package does."""
    prec = get_precision(precision)
    sig = torch.tensor(sigma, dtype=prec.real, device=potential_slice.device)
    phase = sig * potential_slice.to(prec.real)
    return torch.complex(torch.cos(phase), torch.sin(phase))


def multislice(psi, potential_szy, kxs, kys, *, eV: float,
               lam: Optional[float] = None, dz: float,
               record_layers: Optional[Tuple[int, ...]] = None,
               precision: Optional[Precision] = None,
               fused: Optional[bool] = None,
               ksq=None,
               bandwidth_limit: Optional[float] = None,
               kmax2: Optional[float] = None,
               tilt: Optional[Tuple[float, float]] = None,
               tantilt: Optional[Tuple[float, float]] = None
               ) -> torch.Tensor:
    """Propagate the probe batch ``psi`` (..., nx, ny) through a slice-major
    (nz, nx, ny) potential.

    ``fused``: None picks through ``pick_fused`` (and raises when
    ``ops.config.fused_multislice == "on"`` finds no kernel), True
    requires the fused chain, False forces the plain loop. ``ksq``: the
    oblique |k|^2 grid; ``bandwidth_limit``/``kmax2``: antialiasing band
    limit; ``tilt`` (mrad)/``tantilt``: beam tilt. Returns the exit wave,
    or (n_layers, *psi.shape) when ``record_layers`` is given.
    """
    prec = get_precision(precision)
    if kmax2 is None:
        kmax2 = bandwidth_kmax2(kxs, kys, bandwidth_limit, ksq)
    elif bandwidth_limit is not None:
        raise ValueError("pass bandwidth_limit OR kmax2, not both")
    if tantilt is None:
        tantilt = tilt_tangents(tilt)
    elif tilt is not None:
        raise ValueError("pass tilt (mrad) OR tantilt (tangents), not both")
    if tantilt is not None and ksq is not None:
        raise ValueError(
            "beam tilt needs an orthogonal cell (the tilt phase is "
            "separable in physical kx/ky)")
    lam = lam if lam is not None else _wavelength(eV)
    sigma = interaction_parameter(eV)
    nz = potential_szy.shape[0]
    if record_layers is not None:
        layers = tuple(int(l) for l in record_layers)
        if any(b <= a for a, b in zip(layers, layers[1:])):
            raise ValueError("record_layers must be strictly increasing")
        if layers and (layers[0] < 0 or layers[-1] >= nz):
            raise ValueError(f"record_layers out of range [0, {nz - 1}]")
        record_layers = layers

    kernel = pick_fused(psi, prec, nz) if fused is not False else None
    if kernel is None and (fused or ops_config.fused_multislice == "on"):
        raise ValueError(
            f"a fused kernel was required but none fits this problem "
            f"(shape {tuple(psi.shape)}, device {psi.device}, dtype "
            f"{psi.dtype}; needs a CUDA complex64 (probes, nx, ny) batch "
            "in single precision whose axes are powers of two from 128 to "
            "4096 or sizes the JAX kernels take, up to 4096)")
    if kernel is not None:
        return FUSED_ENTRIES[kernel](
            psi, potential_szy, kxs, kys, sigma=sigma, lam=lam, dz=dz,
            record_layers=record_layers, ksq=ksq, kmax2=kmax2,
            tantilt=tantilt)
    return _multislice_plain(psi, potential_szy, kxs, kys, sigma=sigma,
                             lam=lam, dz=dz, record_layers=record_layers,
                             prec=prec, ksq=ksq, kmax2=kmax2,
                             tantilt=tantilt)


def propagator(kxs, kys, lam: float, dz: float, prec: Precision, device,
               ksq=None, tantilt=None, kmax2=None) -> torch.Tensor:
    """The (nx, ny) Fresnel multiplier of one slice step in the precision's
    types: exp(-i pi lam dz k^2), ``ksq`` replacing kx^2 + ky^2 on oblique
    cells, times the beam-tilt phase (``tantilt``), band-limited to
    k^2 <= ``kmax2``."""
    if ksq is not None:
        k2 = as_real(ksq, prec, device)
        phase = (-np.pi * lam * dz) * k2
        P = torch.complex(torch.cos(phase), torch.sin(phase))
    else:
        kx = as_real(kxs, prec, device)
        ky = as_real(kys, prec, device)
        k2 = kx[:, None] ** 2 + ky[None, :] ** 2
        P = fresnel_kernel(kx, ky, lam, dz, prec, device=device)
        if tantilt is not None:
            tph = (2.0 * np.pi * dz) * (kx[:, None] * tantilt[0]
                                        + ky[None, :] * tantilt[1])
            P = P * torch.complex(torch.cos(tph), torch.sin(tph))
    if kmax2 is not None:
        P = P * (k2 <= kmax2).to(prec.real)
    return P


def _multislice_plain(psi, potential_szy, kxs, kys, *, sigma, lam, dz,
                      record_layers, prec: Precision, ksq, kmax2, tantilt
                      ) -> torch.Tensor:
    """The plain torch.fft slice loop with skip-last-propagation."""
    dev = psi.device
    psi = psi.to(prec.complex)
    potential_szy = potential_szy.to(device=dev, dtype=prec.real)
    nz = potential_szy.shape[0]
    P = propagator(kxs, kys, lam, dz, prec, dev, ksq, tantilt, kmax2)

    def transmit(p, v_slice):
        return transmission(v_slice, sigma, prec) * p

    def fresnel(p):
        return torch.fft.ifft2(P * torch.fft.fft2(p))

    if record_layers is None:
        for s in range(nz - 1):
            psi = fresnel(transmit(psi, potential_szy[s]))
        return transmit(psi, potential_szy[nz - 1])

    snapshots = []
    z = 0
    for layer in record_layers:
        for s in range(z, layer):
            psi = fresnel(transmit(psi, potential_szy[s]))
        snap = transmit(psi, potential_szy[layer])
        snapshots.append(snap)
        if layer < nz - 1:
            psi = fresnel(snap)
        z = layer + 1
    return torch.stack(snapshots, dim=0)


def Propagate(probe, potential, device=None):
    """Reference-compatible facade (reference multislice.py:237-299), the
    JAX package's ``Propagate``: the exit wave of ``probe`` through
    ``potential`` with the reference's squeeze semantics (a 2-D probe gives
    a 2-D exit wave, a batch (n_probes, nx, ny)). It runs on the probe's
    device, or on ``device`` when given, and does not change
    ``probe.array`` (reference bug 7). The Fresnel dz is always the
    spacing of ``potential.zs``, whatever the slice axis (reference
    multislice.py:266)."""
    prec = probe.precision
    psi = probe.array
    if device is not None:
        psi = psi.to(device)
    squeeze = psi.dim() == 2
    if squeeze:
        psi = psi[None]
    zs = np.asarray(potential.zs)
    dz = float(zs[1] - zs[0]) if len(zs) > 1 else 0.5
    out = multislice(psi, potential.array_szy.to(psi.device),
                     potential.kxs, potential.kys, eV=probe.eV,
                     lam=probe.wavelength, dz=dz, precision=prec)
    return out[0] if squeeze else out
