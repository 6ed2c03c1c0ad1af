"""What the examples share: the device flag and the hBN specimens.

The specimens are a NumPy copy of the test fixtures (a = 2.504 A,
c = 6.784 A; the orthorhombic 4-atom cell of the honeycomb), on the port's
``Trajectory``. Thermal frames are drawn with ``np.random.default_rng``,
as the JAX package draws them, so that a demo here and its JAX counterpart
see the same atoms for the same seed.
"""

from __future__ import annotations

import argparse
from typing import Optional

import numpy as np
import torch

from ..data.trajectory import Trajectory

HBN_A = 2.504      # hexagonal lattice parameter, Angstrom
HBN_C = 6.784      # out-of-plane repeat (bulk), Angstrom


def add_device_flag(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="cuda (default) or cpu; without a card cuda "
                         "stops, it never falls back to the CPU")


def device(name: str) -> torch.device:
    """The torch device of a ``--device`` value; ``cuda`` without a card
    raises."""
    if name == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device; pass --device "
                           "cpu to run on the CPU")
    return torch.device(name)


def generator(seed: int, dev="cpu") -> torch.Generator:
    """A seeded generator on ``dev`` for the port's random draws (thermal
    ensembles draw on the CPU, shot noise on the image's device)."""
    return torch.Generator(device=dev).manual_seed(seed)


def displaced(traj: Trajectory, n_frames: int, sigma: float,
              seed: Optional[int] = 0,
              distribution: str = "uniform") -> Trajectory:
    """``n_frames`` thermal frames from frame 0, drawn with NumPy's
    ``default_rng(seed)`` as the JAX package's
    ``generate_random_displacements`` draws them (uniform in [0, sigma),
    uncentered; or zero-mean Gaussian of std ``sigma``)."""
    rng = np.random.default_rng(seed)
    na = traj.positions.shape[1]
    if distribution == "uniform":
        dxyz = rng.random(size=(n_frames, na, 3)) * sigma
    elif distribution == "gaussian":
        dxyz = rng.normal(0.0, sigma, size=(n_frames, na, 3))
    else:
        raise ValueError(f"Unknown distribution {distribution!r}")
    velocities = np.broadcast_to(traj.velocities[0], (n_frames, na, 3))
    return Trajectory(atom_types=traj.atom_types,
                      positions=traj.positions[0] + dxyz,
                      velocities=velocities.copy(),
                      box_matrix=traj.box_matrix, timestep=traj.timestep)


def _cell(z0: float) -> np.ndarray:
    a, by = HBN_A, np.sqrt(3.0) * HBN_A
    return np.array([[0.0, 0.0, z0], [a / 2, by / 6, z0],
                     [a / 2, by / 2, z0], [0.0, by / 2 + by / 6, z0]])


def hbn_monolayer(nx: int = 2, ny: int = 2, lz: float = HBN_C,
                  timestep: float = 0.005) -> Trajectory:
    """Orthorhombic hBN monolayer supercell of nx x ny rectangular cells
    (2 B + 2 N each) at z = lz / 4."""
    a, by = HBN_A, np.sqrt(3.0) * HBN_A
    base = _cell(lz / 4.0)
    pos = np.concatenate([base + np.array([i * a, j * by, 0.0])
                          for i in range(nx) for j in range(ny)])[None]
    types = np.tile(np.array([5, 7, 5, 7], dtype=np.int32), nx * ny)
    return Trajectory(atom_types=types, positions=pos,
                      velocities=np.zeros_like(pos),
                      box_matrix=np.diag([nx * a, ny * by, lz]),
                      timestep=timestep)


def hbn_stack(n_layers: int = 3, nx: int = 2, ny: int = 2,
              timestep: float = 0.005) -> Trajectory:
    """AA'-stacked multilayer hBN at the bulk spacing c / 2, B and N
    exchanged on alternate layers."""
    a, by = HBN_A, np.sqrt(3.0) * HBN_A
    dzl = HBN_C / 2.0
    base = _cell(0.0)
    cell_b = np.array([5, 7, 5, 7], dtype=np.int32)
    cell_n = np.array([7, 5, 7, 5], dtype=np.int32)
    cells, types = [], []
    for layer in range(n_layers):
        z = dzl / 2.0 + layer * dzl
        for i in range(nx):
            for j in range(ny):
                cells.append(base + np.array([i * a, j * by, z]))
                types.append(cell_b if layer % 2 == 0 else cell_n)
    pos = np.concatenate(cells)[None]
    return Trajectory(atom_types=np.concatenate(types), positions=pos,
                      velocities=np.zeros_like(pos),
                      box_matrix=np.diag([nx * a, ny * by,
                                          (n_layers + 1) * dzl]),
                      timestep=timestep)


def hbn_thermal(n_frames: int = 8, sigma: float = 0.05, nx: int = 2,
                ny: int = 2, seed: int = 0,
                timestep: float = 0.005) -> Trajectory:
    """Monolayer plus ``n_frames`` uniform thermal frames."""
    return displaced(hbn_monolayer(nx, ny, timestep=timestep), n_frames,
                     sigma, seed)
