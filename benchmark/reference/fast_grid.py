"""The reference's grid with the fast-grid rule, for ``plain``'s functions.

The published rule (the program's ``fast_grid`` option, the command
line's ``--fast-grid``): the in-plane counts of the reference's own rule,
``int(l / sampling) + 1``, rounded up to a multiple of 128, so that each
axis is a power of two or a multiple of 128; the pitch is then ``l / n``
(below the requested sampling), and every k axis, the exported and the
detector's among them, is ``fftfreq(n, l / n)`` at that pitch. The slices
keep the reference's rule.

``FastGrid`` is a ``plain.Grid`` with those counts and axes, so the
potential, the probes, the multislice, the TACAW intensity and the ADF
of ``plain`` run on it as they are.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import plain

MULTIPLE = 128


def snapped(l: float, sampling: float) -> int:
    """int(l / sampling) + 1 rounded up to a multiple of 128."""
    n = int(l / sampling) + 1
    return -(-n // MULTIPLE) * MULTIPLE


@dataclasses.dataclass(frozen=True)
class FastGrid(plain.Grid):

    @property
    def nx(self) -> int:
        return snapped(self.lx, self.sampling)

    @property
    def ny(self) -> int:
        return snapped(self.ly, self.sampling)

    def nominal_q(self) -> np.ndarray:
        """|k| on the fftshifted axes at the actual pitch: with the snapped
        count the requested sampling is no longer the pitch."""
        kx, ky = np.fft.fftshift(self.kx()), np.fft.fftshift(self.ky())
        return np.sqrt(kx[:, None] ** 2 + ky[None, :] ** 2)


def k_axes(grid: FastGrid, real) -> tuple:
    """The fftshifted (kx, ky) axes the job exports, fftfreq(n, l / n), in
    the real type ``real`` (torch; on the host)."""
    return tuple(torch.fft.fftshift(torch.fft.fftfreq(n, d=l / n,
                                                      dtype=real))
                 for n, l in ((grid.nx, grid.lx), (grid.ny, grid.ly)))
