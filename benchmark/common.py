"""Pieces the drivers share: the reference's grid of a configuration,
the scan grid of a probe grid, the comparison, the copy to the host."""

from __future__ import annotations

import numpy as np

from reference import plain


def ref_grid(cfg: dict) -> plain.Grid:
    return plain.Grid(cfg["box_A"], cfg["box_A"], cfg["box_height_A"],
                      cfg["sampling_A"], cfg["slice_thickness_A"])


def scan(g: dict) -> np.ndarray:
    """(n m, 2) positions of an n x m grid over g["x"] by g["y"] (A), in
    the reference's order (x fastest)."""
    x, y = np.meshgrid(np.linspace(*g["x"], g["n"]),
                       np.linspace(*g["y"], g["m"]))
    return np.reshape([x, y], (2, x.size)).T


def rel_l2(got, want) -> float:
    """||got - want|| / ||want|| over the arrays given (float64)."""
    def wide(a):
        a = np.asarray(a)
        return a.astype(np.complex128 if np.iscomplexobj(a) else np.float64)
    got, want = [wide(g) for g in got], [wide(w) for w in want]
    d = sum(float(np.sum(np.abs(g - w) ** 2)) for g, w in zip(got, want))
    n = sum(float(np.sum(np.abs(w) ** 2)) for w in want)
    return float(np.sqrt(d / n)) if n else float(d > 0)


def host(t) -> np.ndarray:
    return t.detach().cpu().numpy()
