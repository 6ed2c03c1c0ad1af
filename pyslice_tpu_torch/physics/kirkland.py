"""Kirkland atomic form factors.

Counterpart of ``pyslice_tpu/physics/kirkland.py``: parses Kirkland's
published parameterization (``kirkland_data.txt``, a copy of the JAX
package's table) into a ``(103, 3, 4)`` float64 array of (a, b, c, d) rows
and evaluates

    f(q^2) = sum_i a_i / (q^2 + b_i) + sum_i c_i * exp(-d_i * q^2)

on torch tensors. The reference's "Tl" table bug is fixed here as in the
JAX package; ``compat_reference_tl=True`` replicates it.
"""

from __future__ import annotations

import functools
from pathlib import Path

import numpy as np
import torch

_DATA_FILE = Path(__file__).parent / "kirkland_data.txt"

N_ELEMENTS = 103

ELEMENTS = [
    "H", "He",
    "Li", "Be", "B", "C", "N", "O", "F", "Ne",
    "Na", "Mg", "Al", "Si", "P", "S", "Cl", "Ar",
    "K", "Ca", "Sc", "Ti", "V", "Cr", "Mn", "Fe", "Co", "Ni", "Cu", "Zn",
    "Ga", "Ge", "As", "Se", "Br", "Kr",
    "Rb", "Sr", "Y", "Zr", "Nb", "Mo", "Tc", "Ru", "Rh", "Pd", "Ag", "Cd",
    "In", "Sn", "Sb", "Te", "I", "Xe",
    "Cs", "Ba",
    "La", "Ce", "Pr", "Nd", "Pm", "Sm", "Eu", "Gd", "Tb", "Dy", "Ho", "Er",
    "Tm", "Yb",
    "Lu", "Hf", "Ta", "W", "Re", "Os", "Ir", "Pt", "Au", "Hg", "Tl", "Pb",
    "Bi", "Po", "At", "Rn",
    "Fr", "Ra",
    "Ac", "Th", "Pa", "U", "Np", "Pu", "Am", "Cm", "Bk", "Cf", "Es", "Fm",
    "Md", "No",
    "Lr", "Rf", "Db", "Sg", "Bh", "Hs", "Mt", "Ds", "Rg", "Cn", "Nh", "Fl",
    "Mc", "Lv", "Ts", "Og",
]


def element_to_z(element: str, compat_reference_tl: bool = False) -> int:
    """Atomic number from element symbol (1-based)."""
    if compat_reference_tl and element == "Tl":
        raise ValueError('"Tl" is unreachable in reference-compat mode '
                         "(reference table bug: index 80 holds a duplicate "
                         '"Ti")')
    return ELEMENTS.index(element) + 1


def z_to_element(z: int) -> str:
    return ELEMENTS[int(z) - 1]


@functools.lru_cache(maxsize=1)
def load_parameters() -> np.ndarray:
    """(103, 3, 4) float64 array of (a, b, c, d) Lorentzian+Gaussian params.

    File layout: one header line per element ("Z= n, chisq= ...") followed
    by 3 lines x 4 numbers in the order a1 b1 a2 b2 / a3 b3 c1 d1 /
    c2 d2 c3 d3 (Kirkland p. 291).
    """
    raw = _DATA_FILE.read_text().strip().splitlines()
    if len(raw) != 4 * N_ELEMENTS:
        raise ValueError(f"kirkland_data.txt: expected {4 * N_ELEMENTS} lines, "
                         f"got {len(raw)}")
    params = np.zeros((N_ELEMENTS, 3, 4), dtype=np.float64)
    for i in range(N_ELEMENTS):
        block = raw[4 * i: 4 * i + 4]
        if not block[0].startswith("Z="):
            raise ValueError(f"kirkland_data.txt: bad header at element {i+1}: "
                             f"{block[0]!r}")
        flat = np.array(" ".join(block[1:]).split(), dtype=np.float64)
        a1, b1, a2, b2, a3, b3, c1, d1, c2, d2, c3, d3 = flat
        params[i] = [[a1, b1, c1, d1], [a2, b2, c2, d2], [a3, b3, c3, d3]]
    return params


def form_factor(qsq: torch.Tensor, z, dtype=None) -> torch.Tensor:
    """f(q^2) for atomic number(s) ``z`` on a q^2 tensor.

    ``z`` is a scalar or a 1-D sequence of atomic numbers; the result has
    shape ``qsq.shape`` or ``(len(z),) + qsq.shape``, in ``dtype`` (default
    ``qsq.dtype``) on ``qsq``'s device.
    """
    out_dtype = dtype or qsq.dtype
    scalar = np.ndim(z) == 0
    z_arr = np.atleast_1d(np.asarray(z, dtype=np.int64))
    abcd = torch.as_tensor(load_parameters()[z_arr - 1], dtype=out_dtype,
                           device=qsq.device)                 # (nz, 3, 4)
    expand = (...,) + (None,) * qsq.dim()
    q = qsq.to(out_dtype)[(None, None) + (slice(None),) * qsq.dim()]
    a, b, c, d = (abcd[..., i][expand] for i in range(4))
    out = (torch.sum(a / (q + b), dim=1)
           + torch.sum(c * torch.exp(-d * q), dim=1))          # (nz, *qsq)
    return out[0] if scalar else out


def form_factor_np(qsq: np.ndarray, z: int) -> np.ndarray:
    """f(q^2) in NumPy float64 for one atomic number: the oracle the tests
    hold ``form_factor`` to."""
    abcd = load_parameters()[int(z) - 1]
    a, b, c, d = abcd[:, 0], abcd[:, 1], abcd[:, 2], abcd[:, 3]
    qsq = np.asarray(qsq, dtype=np.float64)
    expand = (...,) + (None,) * qsq.ndim
    lorentz = np.sum(a[expand] / (qsq[None] + b[expand]), axis=0)
    gauss = np.sum(c[expand] * np.exp(-d[expand] * qsq[None]), axis=0)
    return lorentz + gauss
