"""O(1)-memory adjoint for the multislice chain (differentiable multislice).

Counterpart of ``pyslice_tpu/physics/adjoint.py``. ``multislice_diff`` is
``physics.propagate.multislice`` as a ``torch.autograd.Function``: the
forward is the port's own ``multislice`` (the CUDA kernels where
``pick_fused`` finds one), and the backward rebuilds each slice's wave from
the exit wave instead of storing it, so a gradient needs O(1) wave state at
any depth. The multislice step is unitary (|t| = 1, |P| = 1 without a band
limit), which is what the reconstruction rests on; ``bandwidth_limit`` and
``record_layers`` are therefore not offered, as in the JAX package.

Derivation, in PyTorch's convention. Forward, per slice z:

    a_z = t_z psi_z,   t_z = exp(i sigma V_z),
    psi_{z+1} = ifft2(P fft2(a_z))              (skipped after the last)

For a real loss L PyTorch's grad of a complex tensor z is the conjugate
Wirtinger derivative 2 dL/dconj(z); JAX's cotangent for the same loss is
its conjugate. Write lambda_z for PyTorch's grad of a_z, so lambda_{nz-1}
is ``grad_output``. Backpropagating through the linear step takes its
adjoint (conjugate transpose): ifft2(P fft2(.)) has adjoint
ifft2(conj(P) fft2(.)), and x t has adjoint x conj(t), so

    lambda_z = ifft2(conj(P) fft2(conj(t_{z+1}) lambda_{z+1})).

Inverting the forward step (unitary) gives the same recurrence for the
waves, a_z = ifft2(conj(P) fft2(conj(t_{z+1}) a_{z+1})), so one stream of
pairs w = (a, lambda) carries both, with no conjugation at all (JAX's
stream is (a, conj(lambda_JAX)): the same numbers). This is the slice step
with conj(t) and conj(P), which the kernels run (``ops.fused_step_adjoint``).

Per slice, dL/dV_z = 2 Re(dL/da_z . i sigma a_z) = -sigma Im(conj(lambda_z)
a_z), summed over the batch:

    vbar_z = -sigma sum_batch Im(conj(lambda_z) a_z)

which is JAX's -sigma sum Im(lambda_JAX a) with lambda_JAX = conj(lambda):
the same formula as the kernels' -sigma Im(conj(w1) w0) and the same value
in both packages. At the entrance, psi_0's grad is conj(t_0) lambda_0
(JAX's: t_0 lambda0_JAX, its conjugate). ``tests/test_torch_adjoint.py``
pins each of these against ``jax.vjp``.

Dispatch of the backward (``_bwd_family``), as JAX's ``_bwd_fused_kind``:
``fused_family(P, nx, ny, nz, precision, resident=False)`` on a CUDA
complex64 problem gives "aligned" (A, B, K7) or "odd" (K4, K5, K8), None
the plain ``torch.fft`` recurrence below; ``fused=False`` and
``ops.config.fused_multislice == "off"`` force the plain recurrence. An
eligible problem launches its kernels or raises: nothing falls back.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ..core.constants import interaction_parameter, wavelength as _wavelength
from ..core.dtypes import Precision, get_precision
from ..ops import config as ops_config
from ..ops import fused_step_adjoint
from ..utils.profiling import span
from .propagate import (fused_family, multislice, propagator, tilt_tangents,
                        transmission)

# Each backward family's chain.
ADJOINT_CHAINS = {"aligned": fused_step_adjoint.fused_adjoint_chain,
                  "odd": fused_step_adjoint.fused_adjoint_chain_odd}


@dataclasses.dataclass(frozen=True)
class _Config:
    eV: float
    lam: float
    dz: float
    prec: Precision
    tantilt: Optional[Tuple[float, float]]
    fused: Optional[bool]


def multislice_diff(psi, potential_szy, kxs, kys, *, eV: float,
                    lam: Optional[float] = None, dz: float,
                    precision: Optional[Precision] = None,
                    fused: Optional[bool] = None, ksq=None,
                    tilt: Optional[Tuple[float, float]] = None,
                    tantilt: Optional[Tuple[float, float]] = None
                    ) -> torch.Tensor:
    """Differentiable multislice: the result of ``propagate.multislice``,
    with an O(1)-memory backward for ``psi`` and ``potential_szy``.

    psi: (..., nx, ny) complex (one or a batch of probes); potential_szy:
    (nz, nx, ny) real. kxs/kys/ksq are geometry and get no gradient.
    """
    prec = get_precision(precision)
    lam_f = float(lam) if lam is not None else _wavelength(eV)
    if tantilt is None:
        tantilt = tilt_tangents(tilt)
    elif tilt is not None:
        raise ValueError("pass tilt (mrad) OR tantilt (tangents), not both")
    if tantilt is not None and ksq is not None:
        raise ValueError("beam tilt needs an orthogonal cell")
    cfg = _Config(float(eV), lam_f, float(dz), prec, tantilt, fused)
    psi = torch.as_tensor(psi).to(prec.complex)
    potential_szy = torch.as_tensor(potential_szy).to(prec.real)
    return _MultisliceDiff.apply(psi, potential_szy, cfg, kxs, kys, ksq)


class _MultisliceDiff(torch.autograd.Function):

    @staticmethod
    def forward(ctx, psi, potential_szy, cfg, kxs, kys, ksq):
        exit_wave = multislice(psi, potential_szy, kxs, kys, eV=cfg.eV,
                               lam=cfg.lam, dz=cfg.dz, precision=cfg.prec,
                               fused=cfg.fused, ksq=ksq,
                               tantilt=cfg.tantilt)
        # The exit wave (the output itself) and the inputs: no per-slice
        # state.
        ctx.save_for_backward(exit_wave, potential_szy)
        ctx.cfg, ctx.kxs, ctx.kys, ctx.ksq = cfg, kxs, kys, ksq
        return exit_wave

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad_exit):
        exit_wave, potential_szy = ctx.saved_tensors
        with span("adjoint"):
            psi_grad, v_grad = _backward(ctx.cfg, exit_wave, potential_szy,
                                         ctx.kxs, ctx.kys, ctx.ksq,
                                         grad_exit)
        return (psi_grad if ctx.needs_input_grad[0] else None,
                v_grad if ctx.needs_input_grad[1] else None,
                None, None, None, None)


def _bwd_family(cfg: _Config, a: torch.Tensor, nz: int) -> Optional[str]:
    """The kernel family of the backward chain: "aligned", "odd", or None
    for the plain recurrence (JAX: ``_bwd_fused_kind``)."""
    if cfg.fused is False or nz < 2 or a.dim() not in (2, 3):
        return None
    if (ops_config.fused_multislice == "off" or not a.is_cuda
            or a.dtype != torch.complex64):
        return None
    n_probes, nx, ny = a.shape if a.dim() == 3 else (1,) + tuple(a.shape)
    return fused_family(n_probes, nx, ny, nz, cfg.prec.name, resident=False)


def _backward(cfg: _Config, a, potential_szy, kxs, kys, ksq, grad_exit):
    """(grad of psi, grad of the potential) from the exit wave ``a`` and
    its grad."""
    prec = cfg.prec
    sigma = interaction_parameter(cfg.eV)
    nz = potential_szy.shape[0]
    lam_ct = grad_exit.to(prec.complex)
    batch = tuple(range(a.dim() - 2))

    def vbar_of(lam_z, a_z):
        prod = torch.imag(torch.conj(lam_z) * a_z)
        return (-sigma) * (prod.sum(dim=batch) if batch else prod)

    vbar_last = vbar_of(lam_ct, a)
    family = _bwd_family(cfg, a, nz)
    if family is not None:
        squeeze = a.dim() == 2
        lam0, vbar_chain = ADJOINT_CHAINS[family](
            a[None] if squeeze else a, lam_ct[None] if squeeze else lam_ct,
            potential_szy, kxs, kys, sigma=sigma, lam=cfg.lam, dz=cfg.dz,
            ksq=ksq, tantilt=cfg.tantilt)
        lam0 = lam0[0] if squeeze else lam0
        vbar = torch.cat([vbar_chain, vbar_last[None]], dim=0)
    elif nz > 1:
        P = torch.conj(propagator(kxs, kys, cfg.lam, cfg.dz, prec,
                                  a.device, ksq, cfg.tantilt))
        w = torch.stack([a, lam_ct])
        vbars = [None] * (nz - 1)
        for z in range(nz - 1, 0, -1):
            t = transmission(potential_szy[z], sigma, prec)
            w = torch.fft.ifft2(P * torch.fft.fft2(torch.conj(t) * w))
            vbars[z - 1] = vbar_of(w[1], w[0])
        lam0 = w[1]
        vbar = torch.stack(vbars + [vbar_last], dim=0)
    else:
        lam0 = lam_ct
        vbar = vbar_last[None]
    psi_grad = torch.conj(transmission(potential_szy[0], sigma, prec)) * lam0
    return psi_grad, vbar.to(prec.real)
