"""The resident slice loop on odd and mixed-radix grids (K6 on the
persistent mixed-radix tiles).

Counterpart of ``pyslice_tpu/ops/fused_step_odd_resident.py``: the
reference's own production shape, one plane-wave probe on an
``int(l/s) + 1`` grid, in one launch per frame. The kernel is
``ops.fused_step_resident.resident_loop``, which picks the mixed-radix
instantiation of K6 for any grid that is not a power of two on both axes;
see that module for the design and the limits.

The JAX kernel's VMEM gates (``_vmem_estimate``, ``KSPACE_BUDGET``,
``_pre_t_choice``) are TPU limits and are not ported: the port takes the
same sizes as ``ops.fused_step_odd`` (``supported_size_mr``) with
``nz >= 2``, fuses the k-space conversion at every such size, and keeps
the transmission choice of ``fused_step.transmission_stack``. In the k
space the fftshift is the store form (k + n//2) mod n, right for odd n.
"""

from __future__ import annotations

import torch

from .fused_step import record_layers_chain
from .fused_step_odd import fused_multislice_odd, supported_size_mr
from .fused_step_resident import resident_multislice


def resident_odd_supported(nx: int, ny: int, nz: int,
                           n_probes: int = 1) -> bool:
    """Grids K6's mixed-radix instantiation takes."""
    return (supported_size_mr(nx, n_probes) and supported_size_mr(ny, n_probes)
            and nz >= 2)


def _check_grid(psi, nz) -> None:
    n_probes, nx, ny = psi.shape
    if not resident_odd_supported(nx, ny, nz, n_probes):
        raise ValueError(f"unsupported grid {nx}x{ny} for odd resident path")


def fused_multislice_odd_resident(psi, potential_szy, kxs, kys, *,
                                  sigma: float, lam: float, dz: float,
                                  record_layers=None, ksq=None, kmax2=None,
                                  tantilt=None) -> torch.Tensor:
    """One-launch counterpart of ``fused_step_odd.fused_multislice_odd``
    (same contract, depth recording by segment chaining included). Stacks
    of one slice go to the K4/K5 chain."""
    if record_layers is not None:
        return record_layers_chain(fused_multislice_odd_resident, psi,
                                   potential_szy, kxs, kys, sigma, lam, dz,
                                   ksq, record_layers, kmax2=kmax2,
                                   tantilt=tantilt)
    kw = dict(sigma=sigma, lam=lam, dz=dz, ksq=ksq, kmax2=kmax2,
              tantilt=tantilt)
    if potential_szy.shape[0] < 2:
        return fused_multislice_odd(psi, potential_szy, kxs, kys, **kw)
    _check_grid(psi, potential_szy.shape[0])
    return resident_multislice(psi, potential_szy, kxs, kys, **kw)


def fused_multislice_kspace_odd_resident(psi, potential_szy, kxs, kys, *,
                                         sigma: float, lam: float, dz: float,
                                         ksq=None, kmax2=None, tantilt=None
                                         ) -> torch.Tensor:
    """fftshift(fft2(fused_multislice_odd_resident(...))) with the
    conversion in the same launch. A stack of one slice runs the K4/K5
    chain and converts with torch.fft, as the JAX package does with XLA."""
    kw = dict(sigma=sigma, lam=lam, dz=dz, ksq=ksq, kmax2=kmax2,
              tantilt=tantilt)
    if potential_szy.shape[0] < 2:
        out = fused_multislice_odd(psi, potential_szy, kxs, kys, **kw)
        return torch.fft.fftshift(torch.fft.fft2(out), dim=(-2, -1))
    _check_grid(psi, potential_szy.shape[0])
    return resident_multislice(psi, potential_szy, kxs, kys, kspace=True,
                               **kw)
