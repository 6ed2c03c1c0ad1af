"""Precession electron diffraction (PED).

Counterpart of ``pyslice_tpu/engine/ped.py``. PED rocks the incident beam
around the optic axis on a cone of half-angle phi (the precession angle,
typically 5-40 mrad) while counter-rocking below the specimen so the
pattern stays centred. Averaging the diffraction intensity over the ring
integrates each reflection through its rocking curve and quenches
dynamical artifacts.

The rocking is exact to first order through the tilted propagator
(``physics.propagate.tilt_tangents``): the incident wave stays axial and
the specimen effectively tilts, so the pattern is natively descanned.
Each azimuth runs the same frozen-phonon ensemble, drawn once (the product
measure is separable, so this is unbiased).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..data.trajectory import Trajectory


def precession_tilts(precession_mrad: float, n_azimuth: int = 12
                     ) -> np.ndarray:
    """(n_azimuth, 2) beam tilts (mrad) equally spaced on the precession
    ring; uniform azimuths carry uniform weights."""
    if precession_mrad < 0:
        raise ValueError(f"precession angle must be >= 0, got "
                         f"{precession_mrad}")
    if n_azimuth < 1:
        raise ValueError(f"need at least one azimuth, got {n_azimuth}")
    if precession_mrad == 0:
        return np.zeros((1, 2))
    phi = 2.0 * np.pi * np.arange(n_azimuth) / n_azimuth
    return precession_mrad * np.stack([np.cos(phi), np.sin(phi)], axis=1)


def precession_diffraction(trajectory: Trajectory,
                           precession_mrad: float,
                           n_azimuth: int = 12,
                           n_configs: int = 8,
                           sigma: float = 0.1,
                           generator: Optional[torch.Generator] = None,
                           aperture: float = 0.0,
                           voltage_eV: float = 100e3,
                           sampling: float = 0.1,
                           slice_thickness: float = 0.5,
                           probe_positions: Optional[Sequence] = None,
                           fast_grid: bool = False,
                           distribution: str = "gaussian",
                           bandwidth_limit: Optional[float] = None,
                           device="cuda") -> np.ndarray:
    """Precession-averaged frozen-phonon diffraction pattern in one call.

    Runs ``frozen_phonon_diffraction`` at each of ``n_azimuth`` beam tilts
    on the ``precession_mrad`` cone and averages the intensities
    (fftshifted (nx, ny)). ``precession_mrad=0`` is the axial pattern. The
    thermal ensemble is drawn once from ``generator`` and reused at every
    azimuth. A plane wave (``aperture=0``) is the standard PED geometry; a
    convergent probe gives precession 4D-STEM.
    """
    from .thermal import frozen_phonon_diffraction, thermal_configs

    tilts = precession_tilts(precession_mrad, n_azimuth)
    configs = thermal_configs(trajectory, n_configs, sigma, generator,
                              distribution)
    out = None
    for tx, ty in tilts:
        pat = frozen_phonon_diffraction(
            trajectory, aperture=aperture, voltage_eV=voltage_eV,
            sampling=sampling, slice_thickness=slice_thickness,
            probe_positions=probe_positions, fast_grid=fast_grid,
            bandwidth_limit=bandwidth_limit,
            tilt=(float(tx), float(ty)) if (tx or ty) else None,
            configs=configs, device=device)
        out = pat if out is None else out + pat
    return out / len(tilts)
