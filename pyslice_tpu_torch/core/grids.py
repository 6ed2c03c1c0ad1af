"""Real-space / reciprocal-space grid construction.

Host-side NumPy, the counterpart of ``pyslice_tpu/core/grids.py``, with the
reference grid semantics every downstream array depends on (reference
``potentials.py:113-131``):

* ``n = int(length / sampling) + 1`` points per axis,
* ``linspace(0, length, n, endpoint=False)`` so the actual pixel pitch is
  ``length / n`` (slightly *smaller* than the requested sampling),
* the slice axis handled identically with ``slice_thickness``.

Quirk 12, kept for parity: the exported k axes use
``fftfreq(n, requested_sampling)`` while the physics uses
``fftfreq(n, actual_pitch)`` — see ``kxs`` vs ``kxs_nominal_shifted``.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class Grid:
    """Host grid description for one simulation config."""

    xs: np.ndarray          # (nx,) real-space x coordinates, Angstrom
    ys: np.ndarray          # (ny,)
    zs: np.ndarray          # (nz,) slice coordinates along the slice axis
    lx: float
    ly: float
    lz: float
    sampling: float         # requested in-plane sampling (Angstrom/px)
    slice_thickness: float  # requested slice thickness (Angstrom)
    fast_grid: bool = False  # point counts snapped up to multiples of 128
    # In-plane cell vectors as COLUMNS of a 2x2 matrix for oblique
    # (xy-tilted) cells; None = orthogonal. When set, xs/ys are arc lengths
    # along a1/a2.
    cell2d: np.ndarray = None

    @property
    def nx(self) -> int:
        return len(self.xs)

    @property
    def ny(self) -> int:
        return len(self.ys)

    @property
    def nz(self) -> int:
        return len(self.zs)

    @property
    def dx(self) -> float:
        return float(self.xs[1] - self.xs[0])

    @property
    def dy(self) -> float:
        return float(self.ys[1] - self.ys[0])

    @property
    def dz(self) -> float:
        # Reference fallback of 0.5 A for single-slice grids.
        return float(self.zs[1] - self.zs[0]) if self.nz > 1 else 0.5

    def kxs(self) -> np.ndarray:
        """Physical k axis (cycles/Angstrom), fftfreq order, actual pitch."""
        return np.fft.fftfreq(self.nx, d=self.dx)

    def kys(self) -> np.ndarray:
        return np.fft.fftfreq(self.ny, d=self.dy)

    def kxs_nominal_shifted(self) -> np.ndarray:
        """The k axis exported in WFData: fftshift(fftfreq(n, requested
        sampling)) (quirk 12). With ``fast_grid`` the actual pitch is used,
        since the snapped count moves it by up to ~15%."""
        if self.fast_grid:
            return np.fft.fftshift(self.kxs())
        return np.fft.fftshift(np.fft.fftfreq(self.nx, d=self.sampling))

    def kys_nominal_shifted(self) -> np.ndarray:
        if self.fast_grid:
            return np.fft.fftshift(self.kys())
        return np.fft.fftshift(np.fft.fftfreq(self.ny, d=self.sampling))

    @property
    def is_oblique(self) -> bool:
        return self.cell2d is not None

    def recip2d(self) -> np.ndarray:
        """2x2 reciprocal basis (columns b1, b2 with b_i . a_j = delta_ij)."""
        if self.cell2d is None:
            return np.diag([1.0 / self.lx, 1.0 / self.ly])
        return np.linalg.inv(np.asarray(self.cell2d, dtype=np.float64)).T

    def ksq2d(self) -> np.ndarray:
        """(nx, ny) |k_mn|^2 over integer frequencies (fftfreq order),
        k_mn = m b1 + n b2, with the oblique 2 m n (b1 . b2) cross term."""
        B = self.recip2d()
        m = np.rint(np.fft.fftfreq(self.nx) * self.nx)
        n = np.rint(np.fft.fftfreq(self.ny) * self.ny)
        g11 = float(B[:, 0] @ B[:, 0])
        g22 = float(B[:, 1] @ B[:, 1])
        g12 = float(B[:, 0] @ B[:, 1])
        return (g11 * m[:, None] ** 2 + g22 * n[None, :] ** 2
                + 2.0 * g12 * m[:, None] * n[None, :])

    @property
    def pixel_area(self) -> float:
        """In-plane area per sample point (dx*dy for orthogonal cells)."""
        if self.cell2d is None:
            return self.dx * self.dy
        return abs(float(np.linalg.det(np.asarray(self.cell2d)))) / (
            self.nx * self.ny)

    def sample_points_2d(self) -> np.ndarray:
        """(nx, ny, 2) Cartesian in-plane sample positions, float64."""
        fi = np.arange(self.nx) / self.nx
        fj = np.arange(self.ny) / self.ny
        A = (np.asarray(self.cell2d, dtype=np.float64)
             if self.cell2d is not None else np.diag([self.lx, self.ly]))
        return (fi[:, None, None] * A[:, 0][None, None, :]
                + fj[None, :, None] * A[:, 1][None, None, :])


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def grid_from_box(lx: float, ly: float, lz: float,
                  sampling: float = 0.1,
                  slice_thickness: float = 0.5,
                  fast_grid: bool = False) -> Grid:
    """Grid from orthogonal box lengths (reference potentials.py:113-131).
    ``fast_grid=True`` rounds the in-plane counts UP to multiples of 128."""
    nx = int(lx / sampling) + 1
    ny = int(ly / sampling) + 1
    nz = int(lz / slice_thickness) + 1
    snapped = False
    if fast_grid:
        nx2, ny2 = _round_up(nx, 128), _round_up(ny, 128)
        snapped = (nx2, ny2) != (nx, ny)
        nx, ny = nx2, ny2
    xs = np.linspace(0.0, lx, nx, endpoint=False)
    ys = np.linspace(0.0, ly, ny, endpoint=False)
    zs = np.linspace(0.0, lz, nz, endpoint=False)
    return Grid(xs=xs, ys=ys, zs=zs, lx=float(lx), ly=float(ly), lz=float(lz),
                sampling=float(sampling), slice_thickness=float(slice_thickness),
                fast_grid=snapped)


def grid_from_box_matrix(box_matrix, sampling: float = 0.1,
                         slice_thickness: float = 0.5,
                         fast_grid: bool = False) -> Grid:
    """Grid honoring an in-plane (xy) tilt. The slice axis must be
    orthogonal to the plane (xz = yz = 0)."""
    box = np.asarray(box_matrix, dtype=np.float64)
    if abs(box[0, 2]) > 1e-12 or abs(box[1, 2]) > 1e-12:
        raise ValueError(
            "out-of-plane tilts (xz/yz) are unsupported: the slice axis "
            "must be orthogonal to the in-plane cell "
            f"(got xz={box[0, 2]}, yz={box[1, 2]})")
    if abs(box[0, 1]) < 1e-12 and abs(box[1, 0]) < 1e-12:
        return grid_from_box(float(box[0, 0]), float(box[1, 1]),
                             float(box[2, 2]), sampling=sampling,
                             slice_thickness=slice_thickness,
                             fast_grid=fast_grid)
    a1 = box[:2, 0]
    a2 = box[:2, 1]
    l1 = float(np.linalg.norm(a1))
    l2 = float(np.linalg.norm(a2))
    lz = float(box[2, 2])
    nx = int(l1 / sampling) + 1
    ny = int(l2 / sampling) + 1
    nz = int(lz / slice_thickness) + 1
    if fast_grid:
        nx = _round_up(nx, 128)
        ny = _round_up(ny, 128)
    xs = np.linspace(0.0, l1, nx, endpoint=False)
    ys = np.linspace(0.0, l2, ny, endpoint=False)
    zs = np.linspace(0.0, lz, nz, endpoint=False)
    return Grid(xs=xs, ys=ys, zs=zs, lx=l1, ly=l2, lz=lz,
                sampling=float(sampling),
                slice_thickness=float(slice_thickness),
                fast_grid=fast_grid,
                cell2d=np.stack([a1, a2], axis=1))


def grid_from_trajectory(trajectory, sampling: float = 0.1,
                         slice_thickness: float = 0.5,
                         fast_grid: bool = False) -> Grid:
    """Grid from a trajectory's box matrix; xy-tilted boxes get the oblique
    grid."""
    box = np.asarray(trajectory.box_matrix)
    if abs(box[0, 1]) > 1e-12 or abs(box[1, 0]) > 1e-12:
        return grid_from_box_matrix(box, sampling=sampling,
                                    slice_thickness=slice_thickness,
                                    fast_grid=fast_grid)
    return grid_from_box(float(box[0, 0]), float(box[1, 1]), float(box[2, 2]),
                         sampling=sampling, slice_thickness=slice_thickness,
                         fast_grid=fast_grid)


def gridFromTrajectory(trajectory, sampling: float = 0.1,
                       slice_thickness: float = 0.5
                       ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                  float, float, float]:
    """Reference-compatible facade: (xs, ys, zs, lx, ly, lz)."""
    g = grid_from_trajectory(trajectory, sampling, slice_thickness)
    return g.xs, g.ys, g.zs, g.lx, g.ly, g.lz
