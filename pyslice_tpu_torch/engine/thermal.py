"""Frozen-phonon (thermal-configuration-averaged) conveniences.

Counterpart of ``pyslice_tpu/engine/thermal.py``. Averaging incoherently
over thermally displaced configurations is expressible with the streaming
engines (each configuration is a "frame"); these one-call facades wrap
that. Memory stays O(accumulators) whatever n_configs.

True frozen-phonon sampling wants zero-mean Gaussian displacements with
std = sqrt(<u^2>), so these facades default to distribution="gaussian",
unlike Trajectory.generate_random_displacements, whose uniform default
keeps reference quirk 10. The configurations are drawn from a CPU
``torch.Generator`` (``generator=``; the JAX package seeds NumPy). The
facades run on ``device``, the card unless ``device="cpu"``, in the
default precision (``core.dtypes.set_default_precision``).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.grids import grid_from_trajectory
from ..data.trajectory import Trajectory
from ..physics.potential import make_plan
from ..physics.probe import Probe, create_batched_probes
from .pipeline import SimSpec, frame_exit_waves
from .streaming import StreamingHAADF

# Configurations fed to the stream a block at a time.
_BLOCK = 8


def thermal_configs(trajectory: Trajectory, n_configs: int, sigma: float,
                    generator: Optional[torch.Generator] = None,
                    distribution: str = "gaussian") -> Trajectory:
    """n_configs thermally displaced copies of the trajectory's mean
    structure (frozen-phonon ensemble)."""
    mean = trajectory.get_mean_positions()
    base = Trajectory(
        atom_types=np.asarray(trajectory.atom_types),
        positions=mean[None],
        velocities=np.zeros((1,) + mean.shape),
        box_matrix=np.asarray(trajectory.box_matrix),
        timestep=trajectory.timestep,
    )
    return base.generate_random_displacements(
        n_configs, sigma, distribution=distribution, generator=generator)


def _setup(trajectory, aperture, voltage_eV, sampling, slice_thickness,
           probe_positions, fast_grid, configs, device, defocus=0.0,
           bandwidth_limit=None, tilt=None):
    grid = grid_from_trajectory(trajectory, sampling=sampling,
                                slice_thickness=slice_thickness,
                                fast_grid=fast_grid)
    oblique = grid.is_oblique
    plan = make_plan(grid.xs, grid.ys, grid.zs, configs.positions,
                     configs.atom_types,
                     cell2d=grid.cell2d if oblique else None)
    spec = SimSpec.create(grid, plan, voltage_eV,
                          bandwidth_limit=bandwidth_limit, tilt=tilt)
    base = Probe(grid.xs, grid.ys, aperture, voltage_eV,
                 precision=spec.precision, device=device,
                 cell2d=grid.cell2d if oblique else None,
                 ksq=grid.ksq2d() if oblique else None)
    if defocus:
        base.defocus(float(defocus))
    if probe_positions is None:
        probe_positions = [(grid.lx / 2, grid.ly / 2)]
    probes = create_batched_probes(base, probe_positions).array
    return grid, spec, probes, probe_positions


def frozen_phonon_haadf(trajectory: Trajectory,
                        probe_positions,
                        n_configs: int = 8,
                        sigma: float = 0.1,
                        generator: Optional[torch.Generator] = None,
                        aperture: float = 30.0,
                        voltage_eV: float = 100e3,
                        sampling: float = 0.1,
                        slice_thickness: float = 0.5,
                        collection_angle: float = 45.0,
                        intensity: bool = True,
                        fast_grid: bool = False,
                        distribution: str = "gaussian",
                        use_smatrix: Optional[bool] = None,
                        prism_f: int = 1,
                        probe_chunk: Optional[int] = None,
                        bandwidth_limit: Optional[float] = None,
                        device="cuda"
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Frozen-phonon HAADF image in one call.

    Averages the annular-detector signal over ``n_configs`` displaced
    configurations of the trajectory's mean structure. Returns
    (image (n_x, n_y), scan_xs, scan_ys). ``intensity`` defaults to True (|psi|^2, the physical
    detector; HAADFData's amplitude default is reference parity, quirk 11).

    Large scans route each configuration through the S-matrix
    (``engine.smatrix``; use_smatrix=None = automatic above
    ``smatrix.SMATRIX_MIN_PROBES``, True/False forces; prism_f > 1 trades
    accuracy for an f^2-smaller basis).
    """
    configs = thermal_configs(trajectory, n_configs, sigma, generator,
                              distribution)
    grid, spec, probes, probe_positions = _setup(
        trajectory, aperture, voltage_eV, sampling, slice_thickness,
        probe_positions, fast_grid, configs, device,
        bandwidth_limit=bandwidth_limit)
    stream = StreamingHAADF(spec, probes, probe_positions,
                            collection_angle=collection_angle,
                            intensity=intensity, mrad=aperture,
                            use_smatrix=use_smatrix, prism_f=prism_f,
                            probe_chunk=probe_chunk)
    for c0 in range(0, configs.n_frames, _BLOCK):
        stream.add_frame_block(configs.positions[c0:c0 + _BLOCK])
    image = stream.image()
    from ..analysis.detectors import _scan_axes
    _, xs, ys = _scan_axes(probe_positions)
    return image, xs, ys


def frozen_phonon_diffraction(trajectory: Trajectory,
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
                              defocus: float = 0.0,
                              bandwidth_limit: Optional[float] = None,
                              tilt: Optional[Tuple[float, float]] = None,
                              configs: Optional[Trajectory] = None,
                              device="cuda") -> np.ndarray:
    """Thermally averaged diffraction pattern (mean |psi_k|^2 over configs
    and probes), (nx, ny) fftshifted — the frozen-phonon CBED/SAED result.
    The average is incoherent (mean of intensities per configuration);
    configurations stream one at a time into an (nx, ny) accumulator.
    """
    if configs is None:
        configs = thermal_configs(trajectory, n_configs, sigma, generator,
                                  distribution)
    grid, spec, probes, probe_positions = _setup(
        trajectory, aperture, voltage_eV, sampling, slice_thickness,
        probe_positions, fast_grid, configs, device,
        defocus=defocus, bandwidth_limit=bandwidth_limit, tilt=tilt)
    positions = torch.as_tensor(configs.positions, device=probes.device)
    acc = torch.zeros((grid.nx, grid.ny), dtype=spec.precision.real,
                      device=probes.device)
    for c in range(configs.n_frames):
        psi = frame_exit_waves(positions[c], probes, spec)[..., -1]
        acc += (psi.abs() ** 2).mean(dim=0)
    return acc.cpu().numpy() / configs.n_frames
