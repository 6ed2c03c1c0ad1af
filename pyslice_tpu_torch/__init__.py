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

Config 5's streaming path: ``StreamingTACAW`` / ``StreamingHAADF``
(``engine.streaming``, O(selected bins) of state) fed by
``TrajectoryStream`` (``io.stream``), the S-matrix (``engine.smatrix``),
the frozen-phonon facades (``engine.thermal``) and the detectors
(``analysis.detectors``). The reference's direct surface: ``Potential``
-> ``Propagate``, ``kirkland``, ``loadKirkland``, ``getZfromElementName``.

The imaging toolkit: HRTEM/CTEM (``hrtem_image``, ``image_from_exit_wave``,
``objective_transfer``, ``focal_series``; ``engine.ctem``), partial
coherence (``engine.coherence``), precession diffraction
(``precession_diffraction``), phase retrieval (``ssb_reconstruct``,
``icom_reconstruct``, ``epie_reconstruct``, ``scan_grid_data``,
``iwfr_reconstruct``) and the crystal builders (``crystal``,
``orthogonal_supercell``, ``substitute``, ``vacancies``).

Entry points run on the card unless the caller passes ``device="cpu"``;
the device is explicit wherever a tensor is made.
Importing the package switches TF32 off for float32 matrix products
(``core.dtypes``).
"""

from .core.constants import (C_LIGHT, H_PLANCK, M_ELECTRON, Q_ELECTRON,
                             interaction_parameter, m_effective, wavelength)
from .core.dtypes import (DOUBLE, SINGLE, Precision, get_precision,
                          set_default_precision)
from .core.grids import (Grid, grid_from_box, grid_from_box_matrix,
                         grid_from_trajectory, gridFromTrajectory)
from .data.trajectory import Trajectory
from .data.crystals import (crystal, orthogonal_supercell, substitute,
                            vacancies)
from .io.loader import TrajectoryLoader
from .io.stream import TrajectoryStream
from .physics.kirkland import element_to_z, form_factor, z_to_element
from .physics.potential import Potential, RasterizerPlan, make_plan, rasterize
from .physics.aberrations import Aberrations
from .physics.probe import Probe, create_batched_probes, probe_grid, shift_probes
from .physics.propagate import Propagate, multislice
from .physics.adjoint import multislice_diff
from .engine.calculator import MultisliceCalculator
from .engine.smatrix import (BeamSet, SMatrix, build_beams, compute_smatrix,
                             smatrix_exit_kspace, smatrix_reduce)
from .engine.streaming import StreamingHAADF, StreamingTACAW
from .engine.inverse import (refine_aberrations, refine_structure,
                             refine_structure_tilt_series)
from .analysis.wf_data import WFData
from .analysis.tacaw import TACAWData
from .analysis.haadf import HAADFData
from .analysis.ptychography import (epie_reconstruct, icom_reconstruct,
                                    msp_reconstruct, scan_grid_data,
                                    ssb_reconstruct)
from .analysis.ewr import iwfr_reconstruct
from .engine.ctem import (focal_series, hrtem_image, image_from_exit_wave,
                          objective_transfer)
from .engine.ped import precession_diffraction, precession_tilts


def getZfromElementName(element: str) -> int:
    """Reference-compatible name (potentials.py:98-111), with the Tl bug
    fixed."""
    return element_to_z(element)


def kirkland(qsq, Z, device="cuda"):
    """Reference-compatible form-factor entry point (potentials.py:50-96):
    f(q^2) on ``qsq`` for an atomic number or element name ``Z``. A tensor
    stays on its own device; an array goes to ``device`` (the card unless
    ``device="cpu"``)."""
    import numpy as np
    import torch
    if isinstance(Z, str):
        Z = element_to_z(Z)
    if not isinstance(qsq, torch.Tensor):
        qsq = torch.as_tensor(np.asarray(qsq), device=device)
    return form_factor(qsq, Z)


def loadKirkland(device=None):
    """Reference-compatible parameter loader (potentials.py:134-185): the
    (103, 3, 4) host table, parsed once and cached."""
    del device
    from .physics.kirkland import load_parameters
    return load_parameters()


__all__ = [
    "C_LIGHT", "H_PLANCK", "M_ELECTRON", "Q_ELECTRON",
    "interaction_parameter", "m_effective", "wavelength",
    "DOUBLE", "SINGLE", "Precision", "get_precision",
    "set_default_precision",
    "Grid", "grid_from_box", "grid_from_box_matrix", "grid_from_trajectory",
    "gridFromTrajectory", "Trajectory", "TrajectoryLoader", "element_to_z", "form_factor",
    "z_to_element", "RasterizerPlan", "make_plan", "rasterize", "Probe",
    "create_batched_probes", "probe_grid", "shift_probes", "multislice",
    "MultisliceCalculator", "WFData", "TACAWData", "HAADFData",
    "Aberrations", "multislice_diff", "msp_reconstruct", "refine_structure",
    "refine_aberrations", "refine_structure_tilt_series",
    "TrajectoryStream", "Potential", "Propagate", "BeamSet", "SMatrix",
    "build_beams", "compute_smatrix", "smatrix_exit_kspace",
    "smatrix_reduce", "StreamingTACAW", "StreamingHAADF", "kirkland",
    "loadKirkland", "getZfromElementName",
    "crystal", "orthogonal_supercell", "substitute", "vacancies",
    "ssb_reconstruct", "icom_reconstruct", "epie_reconstruct",
    "scan_grid_data", "iwfr_reconstruct", "hrtem_image",
    "image_from_exit_wave", "objective_transfer", "focal_series",
    "precession_diffraction", "precession_tilts",
]
