"""pyslice_tpu_torch — the PyTorch / CUDA port of pyslice_tpu.

The TACAW workflow (time-resolved electron scattering from MD
trajectories): trajectory -> Kirkland projected potentials -> multislice
probe propagation -> k-space exit waves per (probe, frame) -> time-axis FFT
-> phonon-resolved spectra and diffraction, HAADF-STEM. Each module mirrors
its counterpart in ``pyslice_tpu``; the slice step's hot loop runs through
hand-written CUDA kernels (``ops/csrc/*.cu``) on an NVIDIA card. Ingest:
``TrajectoryLoader`` (LAMMPS, XYZ, CIF). The differentiable path:
``multislice_diff`` (an O(1)-memory adjoint whose backward runs the adjoint
kernels), ``msp_reconstruct`` (multislice ptychography) and the structure
and aberration refinements of ``engine.inverse``.

The device is always explicit (``MultisliceCalculator(device="cuda")``).
Importing the package switches TF32 off for float32 matrix products
(``core.dtypes``).
"""

from .core.constants import (C_LIGHT, H_PLANCK, M_ELECTRON, Q_ELECTRON,
                             interaction_parameter, m_effective, wavelength)
from .core.dtypes import DOUBLE, SINGLE, Precision, get_precision
from .core.grids import (Grid, grid_from_box, grid_from_box_matrix,
                         grid_from_trajectory, gridFromTrajectory)
from .data.trajectory import Trajectory
from .io.loader import TrajectoryLoader
from .physics.kirkland import element_to_z, form_factor, z_to_element
from .physics.potential import RasterizerPlan, make_plan, rasterize
from .physics.aberrations import Aberrations
from .physics.probe import Probe, create_batched_probes, probe_grid, shift_probes
from .physics.propagate import multislice
from .physics.adjoint import multislice_diff
from .engine.calculator import MultisliceCalculator
from .engine.inverse import (refine_aberrations, refine_structure,
                             refine_structure_tilt_series)
from .analysis.wf_data import WFData
from .analysis.tacaw import TACAWData
from .analysis.haadf import HAADFData
from .analysis.ptychography import msp_reconstruct

__all__ = [
    "C_LIGHT", "H_PLANCK", "M_ELECTRON", "Q_ELECTRON",
    "interaction_parameter", "m_effective", "wavelength",
    "DOUBLE", "SINGLE", "Precision", "get_precision",
    "Grid", "grid_from_box", "grid_from_box_matrix", "grid_from_trajectory",
    "gridFromTrajectory", "Trajectory", "TrajectoryLoader", "element_to_z", "form_factor",
    "z_to_element", "RasterizerPlan", "make_plan", "rasterize", "Probe",
    "create_batched_probes", "probe_grid", "shift_probes", "multislice",
    "MultisliceCalculator", "WFData", "TACAWData", "HAADFData",
    "Aberrations", "multislice_diff", "msp_reconstruct", "refine_structure",
    "refine_aberrations", "refine_structure_tilt_series",
]
