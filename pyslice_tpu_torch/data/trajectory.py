"""Molecular-dynamics trajectory data model.

Host-side NumPy container, the counterpart of
``pyslice_tpu/data/trajectory.py`` (reference ``trajectory.py:8-237``):
``n_frames``/``n_atoms``/``box_tilts``, ``get_mean_positions``,
``tile_positions``, ``slice_positions``, ``slice_timesteps`` and
``generate_random_displacements``. Positions move to the device one frame at
a time, in the engine.

Randomness comes from an explicit ``torch.Generator``: the same seed gives
other numbers than the JAX package's NumPy generator, so tests build their
trajectories with NumPy and hand the arrays to both packages.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch


@dataclasses.dataclass
class Trajectory:
    atom_types: np.ndarray    # (n_atoms,) int atomic numbers (or str symbols)
    positions: np.ndarray     # (n_frames, n_atoms, 3) Angstrom
    velocities: np.ndarray    # (n_frames, n_atoms, 3)
    box_matrix: np.ndarray    # (3, 3) Angstrom
    timestep: float           # picoseconds

    def __post_init__(self):
        self.atom_types = np.asarray(self.atom_types)
        self.positions = np.asarray(self.positions)
        self.velocities = np.asarray(self.velocities)
        self.box_matrix = np.asarray(self.box_matrix)
        self._validate_shapes()

    def _validate_shapes(self):
        if self.positions.ndim != 3 or self.positions.shape[2] != 3:
            raise ValueError(
                f"positions must be (frames, atoms, 3), got {self.positions.shape}")
        if self.velocities.ndim != 3 or self.velocities.shape[2] != 3:
            raise ValueError(
                f"velocities must be (frames, atoms, 3), got {self.velocities.shape}")
        if self.atom_types.ndim != 1:
            raise ValueError(
                f"atom_types must be 1D, got {self.atom_types.ndim}D")
        if self.box_matrix.shape != (3, 3):
            raise ValueError(
                f"box_matrix must be (3, 3), got {self.box_matrix.shape}")

        n_frames_pos, n_atoms_pos = self.positions.shape[:2]
        n_frames_vel, n_atoms_vel = self.velocities.shape[:2]
        n_atoms_types = len(self.atom_types)
        if n_frames_pos != n_frames_vel:
            raise ValueError(
                f"Frame count mismatch: {n_frames_pos} vs {n_frames_vel}")
        if not (n_atoms_pos == n_atoms_vel == n_atoms_types):
            raise ValueError(
                f"Atom count mismatch: {n_atoms_pos}, {n_atoms_vel}, {n_atoms_types}")

    @property
    def n_frames(self) -> int:
        return self.positions.shape[0]

    @property
    def n_atoms(self) -> int:
        return len(self.atom_types)

    @property
    def box_tilts(self) -> np.ndarray:
        return np.array([self.box_matrix[0, 1], self.box_matrix[0, 2],
                         self.box_matrix[1, 2]])

    def get_mean_positions(self) -> np.ndarray:
        if self.n_frames == 0:
            return np.empty((0, 3), dtype=self.positions.dtype)
        return np.mean(self.positions, axis=0)

    def tile_positions(self, repeats: Tuple[int, int, int]) -> "Trajectory":
        """Supercell tiling: tile (i, j, k) is offset by box_matrix @ (i, j,
        k) and appended along the atom axis; the box columns scale by the
        repeat counts."""
        nx, ny, nz = repeats
        ijk = np.array([(i, j, k)
                        for i in range(nx) for j in range(ny) for k in range(nz)],
                       dtype=np.float64)
        offsets = ijk @ np.asarray(self.box_matrix, dtype=np.float64).T
        t = len(offsets)
        pos = (self.positions[:, None, :, :] + offsets[None, :, None, :])
        pos = pos.reshape(self.n_frames, t * self.n_atoms, 3)
        vel = np.tile(self.velocities, (1, t, 1))
        types = np.tile(self.atom_types, t)
        new_box = self.box_matrix.copy()
        new_box = new_box.astype(np.result_type(new_box.dtype, np.float64))
        new_box[:, 0] *= nx
        new_box[:, 1] *= ny
        new_box[:, 2] *= nz
        return Trajectory(atom_types=types, positions=pos, velocities=vel,
                          box_matrix=new_box, timestep=self.timestep)

    @staticmethod
    def _validate_range(range_val, axis_name: str):
        if range_val is None:
            return None
        min_val, max_val = range_val
        if min_val > max_val:
            raise ValueError(
                f"{axis_name} range invalid: min={min_val} > max={max_val}")
        return range_val

    def slice_positions(self,
                        x_range: Optional[Tuple[float, float]] = None,
                        y_range: Optional[Tuple[float, float]] = None,
                        z_range: Optional[Tuple[float, float]] = None
                        ) -> "Trajectory":
        """Spatial crop by *mean* position (inclusive bounds), shrinking the
        box diagonal to the range extents."""
        if self.n_atoms == 0:
            return self
        x_range = self._validate_range(x_range, "X")
        y_range = self._validate_range(y_range, "Y")
        z_range = self._validate_range(z_range, "Z")
        if all(r is None for r in (x_range, y_range, z_range)):
            return self
        mean_pos = self.get_mean_positions()
        mask = np.ones(self.n_atoms, dtype=bool)
        new_box = self.box_matrix.copy().astype(np.float64)
        for axis, rng in enumerate((x_range, y_range, z_range)):
            if rng is None:
                continue
            lo, hi = rng
            mask &= (mean_pos[:, axis] >= lo) & (mean_pos[:, axis] <= hi)
            new_box[axis, axis] = hi - lo
        n_kept = int(np.sum(mask))
        if n_kept == 0:
            raise ValueError("Spatial filter resulted in 0 atoms")
        if n_kept == self.n_atoms:
            return self
        return Trajectory(atom_types=self.atom_types[mask],
                          positions=self.positions[:, mask, :],
                          velocities=self.velocities[:, mask, :],
                          box_matrix=new_box, timestep=self.timestep)

    def slice_timesteps(self, frame_indices: List[int]) -> "Trajectory":
        """Keep only the given frames."""
        frame_indices = np.asarray(frame_indices)
        if frame_indices.size == 0:
            raise ValueError("frame_indices cannot be empty")
        max_idx = int(np.max(frame_indices))
        if max_idx >= self.n_frames:
            raise ValueError(
                f"Frame index {max_idx} out of range [0, {self.n_frames - 1}]")
        return Trajectory(atom_types=self.atom_types,
                          positions=self.positions[frame_indices, :, :],
                          velocities=self.velocities[frame_indices, :, :],
                          box_matrix=self.box_matrix, timestep=self.timestep)

    def generate_random_displacements(
            self, n_displacements: int, sigma: float,
            distribution: str = "uniform",
            generator: Optional[torch.Generator] = None) -> "Trajectory":
        """Synthetic thermal frames from frame 0.

        The default keeps the reference's quirk: *uniform* noise in
        [0, sigma), uncentered. ``distribution="gaussian"`` gives zero-mean
        Gaussian displacements of std ``sigma``. Velocities are frame 0's,
        broadcast to every new frame. ``generator`` is a CPU
        ``torch.Generator``; None uses torch's default generator.
        """
        na = self.positions.shape[1]
        size = (n_displacements, na, 3)
        if distribution == "uniform":
            dxyz = torch.rand(size, generator=generator,
                              dtype=torch.float64) * sigma
        elif distribution == "gaussian":
            dxyz = torch.randn(size, generator=generator,
                               dtype=torch.float64) * sigma
        else:
            raise ValueError(f"Unknown distribution {distribution!r}")
        positions = self.positions[0] + dxyz.numpy()
        velocities = np.broadcast_to(
            self.velocities[0], (n_displacements, na, 3)).copy()
        return Trajectory(atom_types=self.atom_types, positions=positions,
                          velocities=velocities, box_matrix=self.box_matrix,
                          timestep=self.timestep)
