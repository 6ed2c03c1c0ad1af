"""Per-frame simulation pipeline.

Counterpart of ``pyslice_tpu/engine/pipeline.py``: rasterize one frame's
potential, propagate the probe batch through it, and convert the exit
waves to fftshifted k space. The frame runs on the device its probe batch
lies on; PyTorch runs eagerly, so frames are a Python loop.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..core.constants import interaction_parameter, wavelength as _wavelength
from ..core.dtypes import Precision, get_precision
from ..core.grids import Grid
from ..ops import fused_step
from ..physics.potential import RasterizerPlan, plan_tensors, rasterize
from ..physics.propagate import (bandwidth_kmax2, multislice, pick_fused,
                                 tilt_tangents)


@dataclasses.dataclass(frozen=True, eq=False)
class SimSpec:
    """Simulation description: grid, rasterization plan, beam parameters."""
    grid: Grid
    plan: RasterizerPlan
    eV: float
    lam: float
    dz: float
    record_layers: Optional[Tuple[int, ...]]  # None -> exit wave only
    precision: Precision
    ksq2d: Optional[np.ndarray] = None   # oblique |k|^2 grid (fftfreq order)
    kmax2: Optional[float] = None        # antialiasing band limit, 1/A^2
    tantilt: Optional[Tuple[float, float]] = None  # beam tilt tangents

    @classmethod
    def create(cls, grid: Grid, plan: RasterizerPlan, eV: float,
               record_layers=None, precision=None,
               bandwidth_limit: Optional[float] = None,
               tilt: Optional[Tuple[float, float]] = None) -> "SimSpec":
        """``bandwidth_limit``: optional band limit as a fraction of the
        tightest-axis Nyquist; ``tilt``: optional (theta_x, theta_y) beam
        tilt in mrad (orthogonal cells only)."""
        prec = get_precision(precision)
        rl = (tuple(int(x) for x in record_layers)
              if record_layers is not None else None)
        ksq2d = grid.ksq2d() if grid.is_oblique else None
        tantilt = tilt_tangents(tilt)
        if tantilt is not None and ksq2d is not None:
            raise ValueError("beam tilt needs an orthogonal cell")
        return cls(grid=grid, plan=plan, eV=float(eV), lam=_wavelength(eV),
                   dz=grid.dz, record_layers=rl, precision=prec,
                   ksq2d=ksq2d,
                   kmax2=bandwidth_kmax2(grid.kxs(), grid.kys(),
                                         bandwidth_limit, ksq2d),
                   tantilt=tantilt)


def frame_exit_waves(positions, probes: torch.Tensor,
                     spec: SimSpec) -> torch.Tensor:
    """k-space exit waves for one MD frame.

    Args:
        positions: (n_atoms, 3) frame positions (array or tensor).
        probes: (n_probes, nx, ny) complex probe batch; its device runs the
            frame.

    Returns:
        (n_probes, nx, ny, n_layers) complex, fftshifted k space;
        n_layers == 1 when spec.record_layers is None.
    """
    if not isinstance(positions, torch.Tensor):
        positions = torch.as_tensor(np.asarray(positions))
    v = rasterize(positions.to(probes.device), spec.plan, spec.precision)
    return exit_waves_from_potential(v, probes, spec)


def exit_waves_from_potential(v: torch.Tensor, probes: torch.Tensor,
                              spec: SimSpec) -> torch.Tensor:
    """frame_exit_waves given the rasterized (nz, nx, ny) potential ``v``.

    An eligible batch (see ``physics.propagate``) without depth recording
    takes the fused chain with the k-space conversion in its last kernels
    (``ops.fused_step.fused_multislice_kspace``); otherwise ``multislice``
    then fftshift(fft2(.)). The k axes come from the plan's device
    constants, so a frame makes no host-to-device copy here."""
    c = plan_tensors(spec.plan, spec.precision, probes.device)
    kxs, kys = c["kxs"], c["kys"]
    if (spec.record_layers is None
            and pick_fused(probes, spec.precision) == "aligned"):
        k = fused_step.fused_multislice_kspace(
            probes, v, kxs, kys,
            sigma=interaction_parameter(spec.eV), lam=spec.lam, dz=spec.dz,
            ksq=spec.ksq2d, kmax2=spec.kmax2, tantilt=spec.tantilt)
        return k[..., None]                   # (probes, nx, ny, 1)
    psi = multislice(probes, v, kxs, kys, eV=spec.eV,
                     lam=spec.lam, dz=spec.dz,
                     record_layers=spec.record_layers,
                     precision=spec.precision, ksq=spec.ksq2d,
                     kmax2=spec.kmax2, tantilt=spec.tantilt)
    if spec.record_layers is None:
        psi = psi[None]                       # (1, n_probes, nx, ny)
    k = torch.fft.fftshift(torch.fft.fft2(psi), dim=(-2, -1))
    return k.permute(1, 2, 3, 0)              # (probes, nx, ny, layers)


def simulate_frames(positions_frames, probes: torch.Tensor,
                    spec: SimSpec) -> torch.Tensor:
    """(n_probes, n_frames, nx, ny, n_layers) for a (n_frames, n_atoms, 3)
    block — the WFData layout."""
    return torch.stack([frame_exit_waves(p, probes, spec)
                        for p in positions_frames], dim=1)


def simulate_frames_into(out: torch.Tensor, i0: int, positions_frames,
                         probes: torch.Tensor, spec: SimSpec) -> torch.Tensor:
    """simulate_frames written in place into ``out`` (probes, n_frames, nx,
    ny, layers) at frame offset ``i0``, one frame at a time; returns
    ``out``."""
    for j, p in enumerate(positions_frames):
        out[:, i0 + j] = frame_exit_waves(p, probes, spec)
    return out
