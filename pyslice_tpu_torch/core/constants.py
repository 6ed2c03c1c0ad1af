"""Physical constants and electron-optics scalar formulas.

Counterpart of ``pyslice_tpu/core/constants.py``: the same values and
formulas (reference ``multislice.py:31-42`` for constants and wavelength,
``:257-260`` for the interaction parameter sigma), evaluated as Python
floats (float64). Callers cast to the run precision at the point of use.
"""

from __future__ import annotations

import math

# CODATA-ish values used by the reference (multislice.py:31-34).
M_ELECTRON = 9.109383e-31   # electron mass, kg
Q_ELECTRON = 1.602177e-19   # elementary charge, C (J/eV)
C_LIGHT = 299792458.0       # speed of light, m/s
H_PLANCK = 6.62607015e-34   # Planck constant, J*s


def m_effective(eV: float) -> float:
    """Relativistic electron mass in kg at accelerating voltage ``eV``."""
    return M_ELECTRON + eV * Q_ELECTRON / C_LIGHT**2


def wavelength(eV: float) -> float:
    """Relativistic electron wavelength in Angstrom (multislice.py:41-42)."""
    p_c = ((eV * Q_ELECTRON) ** 2
           + 2.0 * eV * Q_ELECTRON * M_ELECTRON * C_LIGHT**2) ** 0.5
    return H_PLANCK * C_LIGHT / p_c * 1e10


def interaction_parameter(eV: float) -> float:
    """Beam-sample interaction parameter sigma (Kirkland Eq. 5.6):
    sigma = 2*pi/(lambda*V) * (E0+V)/(2*E0+V), E0 the rest energy in eV."""
    e0_eV = M_ELECTRON * C_LIGHT**2 / Q_ELECTRON
    return (2.0 * math.pi) / (wavelength(eV) * eV) * (e0_eV + eV) / (2.0 * e0_eV + eV)
