"""Partial coherence models.

Counterpart of ``pyslice_tpu/engine/coherence.py``. The reference
simulates a perfectly coherent point source. Real guns have a finite
source size (spatial coherence) and an energy spread that defocuses
chromatically (temporal coherence). Both act incoherently (they average
intensities, not amplitudes), so they compose with any detector reduction:

* ``source_size_blur`` — convolve a scan-space image (HAADF, virtual
  image, spectrum image) with the effective source Gaussian; exact for
  STEM images because a shifted incoherent source is a shifted probe.
* ``defocus_series`` — the chromatic envelope: Gauss-Hermite defocus
  nodes and weights over the defocus spread delta = Cc * (dE/E).
* ``chromatic_stem`` — frozen-phonon HAADF averaged over the chromatic
  defocus series, with an optional source-size blur: each node streams the
  thermal ensemble through ``StreamingHAADF`` (the slice-step kernels on
  the card; the S-matrix above ``smatrix.SMATRIX_MIN_PROBES``).
* ``chromatic_diffraction`` — the thermally averaged CBED/diffraction
  pattern averaged over the defocus series.

The quadrature and the source blur are host NumPy in float64, as in the
JAX package. The drivers run on ``device`` (the card unless
``device="cpu"``) in the default precision, and draw the thermal ensemble
once from ``generator`` (a CPU ``torch.Generator``); every node reuses it.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch


def source_size_blur(image, scan_step: Tuple[float, float], fwhm: float):
    """Blur a scan-grid image by the effective source (FWHM in Angstrom).

    image: (nx_scan, ny_scan) real array on a regular scan grid with
    spacing ``scan_step`` = (dx, dy) Angstrom. Gaussian convolution with
    periodic edges, by FFT.
    """
    img = np.asarray(image, dtype=np.float64)
    if img.ndim != 2:
        raise ValueError(f"expected a 2-D scan image, got {img.shape}")
    if fwhm <= 0:
        return img
    sigma = fwhm / (2.0 * np.sqrt(2.0 * np.log(2.0)))
    nx, ny = img.shape
    fx = np.fft.fftfreq(nx, d=scan_step[0])
    fy = np.fft.fftfreq(ny, d=scan_step[1])
    # the Gaussian's Fourier transform: exp(-2 pi^2 sigma^2 f^2)
    env = np.exp(-2.0 * np.pi ** 2 * sigma ** 2
                 * (fx[:, None] ** 2 + fy[None, :] ** 2))
    return np.real(np.fft.ifft2(np.fft.fft2(img) * env))


def defocus_spread(Cc: float, dE: float, eV: float) -> float:
    """1/e half-width of the chromatic defocus distribution,
    delta = Cc * dE/E (Kirkland Eq. 5.39 form). Cc and the result in
    Angstrom; dE and eV in eV (dE the FWHM energy spread)."""
    return float(Cc) * float(dE) / float(eV)


def defocus_series(delta: float, n: int = 7,
                   center: float = 0.0) -> Tuple[np.ndarray, np.ndarray]:
    """Gauss-Hermite quadrature (defocus nodes, weights) over the
    chromatic defocus distribution p(df) ~ exp(-(df - center)^2 / delta^2).
    Run the simulation at each node and average the intensities with the
    weights (they sum to 1)."""
    if n < 1:
        raise ValueError("need at least one quadrature node")
    if delta <= 0:
        return np.array([center]), np.array([1.0])
    x, w = np.polynomial.hermite.hermgauss(n)   # weight exp(-x^2)
    return center + delta * x, w / np.sqrt(np.pi)


def chromatic_stem(trajectory,
                   probe_positions,
                   *,
                   Cc: float,
                   dE: float,
                   voltage_eV: float = 100e3,
                   aperture: float = 30.0,
                   defocus: float = 0.0,
                   aberrations=None,
                   n_nodes: int = 7,
                   n_configs: int = 8,
                   thermal_sigma: float = 0.1,
                   generator: Optional[torch.Generator] = None,
                   sampling: float = 0.1,
                   slice_thickness: float = 0.5,
                   collection_angle: float = 45.0,
                   intensity: bool = True,
                   source_fwhm: float = 0.0,
                   fast_grid: bool = False,
                   distribution: str = "gaussian",
                   use_smatrix: Optional[bool] = None,
                   prism_f: int = 1,
                   bandwidth_limit: Optional[float] = None,
                   device="cuda"
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Partially coherent frozen-phonon HAADF in one call: the chromatic
    defocus series (Gauss-Hermite over delta = Cc dE/E, centred on
    ``defocus``) as an outer loop, each node's thermal ensemble streamed
    through ``StreamingHAADF``, the intensities weight-averaged, and the
    scan image optionally blurred by the effective source
    (``source_fwhm``, Angstrom). Returns (image (n_x, n_y), scan_xs,
    scan_ys).

    The same thermal configurations serve every node (the product measure
    is separable, so this is unbiased). The S-matrix route is decided
    before any probe is built (``use_smatrix=None``: automatic above
    ``smatrix.SMATRIX_MIN_PROBES``), since that route never reads the
    probe batch.
    """
    from ..analysis.detectors import _scan_axes
    from ..core.grids import grid_from_trajectory
    from ..physics.potential import make_plan
    from ..physics.probe import Probe, create_batched_probes
    from .pipeline import SimSpec
    from .smatrix import smatrix_auto
    from .streaming import StreamingHAADF
    from .thermal import thermal_configs

    delta = defocus_spread(Cc, dE, voltage_eV)
    nodes, weights = defocus_series(delta, n=n_nodes, center=defocus)
    configs = thermal_configs(trajectory, n_configs, thermal_sigma,
                              generator, distribution)
    grid = grid_from_trajectory(trajectory, sampling=sampling,
                                slice_thickness=slice_thickness,
                                fast_grid=fast_grid)
    oblique = grid.is_oblique
    plan = make_plan(grid.xs, grid.ys, grid.zs, configs.positions,
                     configs.atom_types,
                     cell2d=grid.cell2d if oblique else None)
    spec = SimSpec.create(grid, plan, voltage_eV,
                          bandwidth_limit=bandwidth_limit)
    positions, xs, ys = _scan_axes(probe_positions)
    if use_smatrix is None:
        use_smatrix = smatrix_auto(len(positions), aperture, spec.ksq2d,
                                   grid.nx, grid.ny, prism_f)

    image = None
    for node, w in zip(nodes, weights):
        if use_smatrix:
            probes = None
        else:
            base = Probe(grid.xs, grid.ys, aperture, voltage_eV,
                         precision=spec.precision, device=device,
                         cell2d=grid.cell2d if oblique else None,
                         ksq=grid.ksq2d() if oblique else None)
            if node:
                base.defocus(float(node))
            if aberrations is not None:
                # geometric aberrations on top of the node's defocus
                base.aberrate(aberrations)
            probes = create_batched_probes(base, positions).array
        stream = StreamingHAADF(spec, probes, positions,
                                collection_angle=collection_angle,
                                intensity=intensity, mrad=aperture,
                                defocus=float(node), aberrations=aberrations,
                                use_smatrix=use_smatrix, prism_f=prism_f,
                                device=device)
        for c in range(configs.n_frames):
            stream.add_frame(configs.positions[c])
        node_img = stream.image()
        image = w * node_img if image is None else image + w * node_img

    if source_fwhm > 0:
        if len(xs) < 2 or len(ys) < 2:
            raise ValueError(
                "source_size_blur needs a 2-D scan grid (>= 2 distinct "
                "probe x and y positions)")
        image = source_size_blur(image, (xs[1] - xs[0], ys[1] - ys[0]),
                                 source_fwhm)
    return image, xs, ys


def chromatic_diffraction(trajectory,
                          *,
                          Cc: float,
                          dE: float,
                          voltage_eV: float = 100e3,
                          aperture: float = 0.0,
                          defocus: float = 0.0,
                          n_nodes: int = 7,
                          n_configs: int = 8,
                          thermal_sigma: float = 0.1,
                          generator: Optional[torch.Generator] = None,
                          sampling: float = 0.1,
                          slice_thickness: float = 0.5,
                          probe_positions: Optional[Sequence] = None,
                          fast_grid: bool = False,
                          distribution: str = "gaussian",
                          device="cuda") -> np.ndarray:
    """The chromatically averaged frozen-phonon diffraction/CBED pattern:
    mean |psi_k|^2 over the thermal configurations and the chromatic
    defocus series, (nx, ny) fftshifted. A plane wave (``aperture=0``) is
    defocus-invariant in intensity, so the average matters for
    convergent-beam patterns. The ensemble is drawn once and every node
    runs it (the JAX package reseeds each node with the same seed)."""
    from .thermal import frozen_phonon_diffraction, thermal_configs

    delta = defocus_spread(Cc, dE, voltage_eV)
    nodes, weights = defocus_series(delta, n=n_nodes, center=defocus)
    configs = thermal_configs(trajectory, n_configs, thermal_sigma,
                              generator, distribution)
    out = None
    for node, w in zip(nodes, weights):
        pat = frozen_phonon_diffraction(
            trajectory, aperture=aperture, voltage_eV=voltage_eV,
            sampling=sampling, slice_thickness=slice_thickness,
            probe_positions=probe_positions, fast_grid=fast_grid,
            defocus=float(node), configs=configs, device=device)
        out = w * pat if out is None else out + w * pat
    return out
