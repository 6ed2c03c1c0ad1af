"""The benchmark's inputs, made from ``--seed``.

An hBN monolayer filling a square box (the rectangular cell of a = 2.504
A, four atoms, whole cells along each axis, at the height the
configuration gives), and thermal frames displaced from it by uniform noise in
[0, sigma) on each coordinate, the reference PySlice's
``generate_random_displacements``. Every frame is drawn from the seed and
the index of the job or block that uses it, so the same seed gives the
same inputs, and no two jobs share a frame.
"""

from __future__ import annotations

import numpy as np

HBN_A = 2.504
BORON, NITROGEN = 5, 7


def hbn_box(lx: float, z0: float):
    """(positions (n_atoms, 3) float64, atomic numbers (n_atoms,)) of the
    layer at height ``z0``."""
    by = np.sqrt(3.0) * HBN_A
    cell = np.array([[0.0, 0.0, z0], [HBN_A / 2, by / 6, z0],
                     [HBN_A / 2, by / 2, z0], [0.0, by / 2 + by / 6, z0]])
    ncx, ncy = max(1, int(lx // HBN_A)), max(1, int(lx // by))
    pos = np.concatenate([cell + np.array([i * HBN_A, j * by, 0.0])
                          for i in range(ncx) for j in range(ncy)])
    types = np.tile(np.array([BORON, NITROGEN, BORON, NITROGEN]),
                    ncx * ncy)
    return pos, types


def generator(seed: int, *index: int) -> np.random.Generator:
    """A generator for one (seed, stream of use, index) triple; any whole
    seed, negative or above 64 bits, is taken modulo 2**64."""
    return np.random.default_rng(
        np.random.SeedSequence([seed % 2 ** 64, *index]))


def thermal_frames(base: np.ndarray, n_frames: int, sigma: float,
                   seed: int, *index: int) -> np.ndarray:
    """(n_frames, n_atoms, 3) float64 frames for one job or block."""
    noise = generator(seed, *index).random((n_frames,) + base.shape)
    return base[None] + sigma * noise


# Uses of the generator, so that no two draw from one sequence.
JOB, STREAM_ORDER, STREAM_BLOCK, SAMPLE = 1, 2, 3, 4
