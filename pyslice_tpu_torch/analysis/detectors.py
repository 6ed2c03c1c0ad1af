"""Detector geometries and virtual imaging for 4D-STEM / CBED data.

Counterpart of ``pyslice_tpu/analysis/detectors.py``. The WFData layout
(probes, time, kx, ky, layer) is a 4D-STEM dataset; these helpers add the
standard detector geometries over it:

* ``annular_mask``    — bright field / ABF / ADF by (inner, outer) angles;
* ``segmented_mask``  — quadrant / DPC-style azimuthal segments;
* ``virtual_image``   — scan-grid image for any mask (generalizes
  HAADFData.calculateADF, sharing its nearest-probe reconstruction);
* ``center_of_mass``  — DPC center-of-mass deflection per scan point;
* ``bin_k``           — pixelated-detector downsampling of k-space;
* ``apply_shot_noise`` / ``apply_detector_mtf`` — the detector model;
* ``pacbed``          — position-averaged CBED (thickness fingerprint);
* ``radial_profile``  — azimuthal average of a diffraction pattern.

The reductions over a WFData run on the device its wave data lies on (a
tensor from ``device_output=True``; a host array reduces on the CPU) and
return host arrays. Masks, binning, the radial profile and the MTF are
host NumPy, as in the JAX package. Two reductions read the waves,
``detector_sums`` and ``frame_mean_intensity``, one code for host, device
and mesh-sharded wave data: a WFData sharded over a (frame, probe) mesh (a
``DTensor``) runs the same arithmetic on each rank's block and
``parallel.sharded.frame_total``'s collectives; every rank of the mesh
calls the function and gets the replicated result.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..parallel import sharded


def _k_grids(kxs, kys):
    kxs = np.asarray(kxs)
    kys = np.asarray(kys)
    return kxs[:, None], kys[None, :]


def _angle_to_k(mrad: float, lam: float) -> float:
    """Scattering semi-angle (mrad) -> |k| (1/Angstrom), as the reference
    converts its collection angle (haadf_data.py:49)."""
    return (mrad * 1e-3) / lam


def annular_mask(kxs, kys, lam: float, inner_mrad: float = 0.0,
                 outer_mrad: Optional[float] = None,
                 ksq=None) -> np.ndarray:
    """(nx, ny) float mask for inner <= theta < outer (mrad).

    inner=0 gives a disk (bright field); outer=None extends to the grid
    corner (the reference's ADF is inner_mrad=collection_angle, outer=None).
    ``ksq``: optional |k|^2 grid (e.g. WFData.ksq_shifted for oblique
    cells) overriding the separable kxs^2 + kys^2.
    """
    if ksq is not None:
        q = np.sqrt(np.asarray(ksq))
    else:
        kx, ky = _k_grids(kxs, kys)
        q = np.sqrt(kx ** 2 + ky ** 2)
    if inner_mrad > 0:
        mask = q > _angle_to_k(inner_mrad, lam)   # strict >, haadf_data.py:50
    else:
        mask = np.ones_like(q, dtype=bool)
    if outer_mrad is not None:
        mask = mask & (q <= _angle_to_k(outer_mrad, lam))
    return mask.astype(np.float64)


def segmented_mask(kxs, kys, lam: float, inner_mrad: float,
                   outer_mrad: float, n_segments: int = 4,
                   rotation_deg: float = 0.0) -> np.ndarray:
    """(n_segments, nx, ny) azimuthal segments of an annulus (DPC / first-
    moment detectors). Segment s covers azimuth [s, s+1) * 2pi/n (+rotation)."""
    kx, ky = _k_grids(kxs, kys)
    ring = annular_mask(kxs, kys, lam, inner_mrad, outer_mrad)
    phi = (np.arctan2(ky, kx) - np.deg2rad(rotation_deg)) % (2 * np.pi)
    edges = np.linspace(0.0, 2 * np.pi, n_segments + 1)
    segs = [(ring * ((phi >= edges[s]) & (phi < edges[s + 1])))
            for s in range(n_segments)]
    return np.stack(segs, axis=0)


def _local_waves(wave_data) -> torch.Tensor:
    """The rank's wave data as a tensor: a DTensor's local tensor, a host
    array without a copy."""
    wf = sharded.local_of(wave_data)
    return wf if isinstance(wf, torch.Tensor) else \
        torch.from_numpy(np.asarray(wf))


def detector_sums(wave_data, planes, intensity: bool = False,
                  layer_index: int = -1) -> torch.Tensor:
    """Mean over frames of the k sums of |psi| (|psi|^2 with
    ``intensity``) against real weight planes: (n_probes, n_planes), on
    the waves' device. ``wave_data``: a (probes, frames, kx, ky, layers)
    host array, tensor or mesh-sharded DTensor; ``planes``: (nx, ny) or
    (n_planes, nx, ny). The rank's block is contracted here and
    ``sharded.frame_total`` adds a mesh's collectives (every rank of the
    mesh calls this and gets the replicated result). The core of
    calculateADF, virtual_image, center_of_mass and collected_sharded."""
    x = _local_waves(wave_data)[..., layer_index].abs()
    if intensity:
        x = x * x
    m = planes if isinstance(planes, torch.Tensor) else \
        torch.as_tensor(np.asarray(planes, np.float64))
    m = m.to(device=x.device, dtype=x.dtype)
    if m.dim() == 2:
        m = m[None]
    # Contract k per plane without materializing the (P, T, S, nx, ny)
    # broadcast.
    s = torch.einsum("ptxy,sxy->ps", x, m)
    return sharded.frame_total(s, wave_data) / wave_data.shape[1]


def frame_mean_intensity(wave_data, layer_index: int = -1) -> torch.Tensor:
    """(n_probes, nx, ny) mean over frames of |psi|^2, on the waves'
    device, for the wave data ``detector_sums`` takes (a mesh's
    collectives in ``sharded.frame_total``). The core of pacbed,
    scan_grid_data and frame_mean_intensity_sharded."""
    x = _local_waves(wave_data)[..., layer_index]
    s = (x.abs() ** 2).sum(dim=1)
    return sharded.frame_total(s, wave_data) / wave_data.shape[1]


def _scan_axes(probe_positions):
    """Unique sorted scan axes (the HAADFData.calculateADF reconstruction
    convention); shared by the detectors, engine.smatrix and engine.thermal."""
    positions = np.asarray(probe_positions, dtype=np.float64)
    xs = np.array(sorted(set(positions[:, 0].tolist())))
    ys = np.array(sorted(set(positions[:, 1].tolist())))
    return positions, xs, ys


def _scan_grid(probe_positions):
    """(xs, ys, nearest): the scan axes and, for each point of their grid,
    the index of the nearest probe."""
    positions, xs, ys = _scan_axes(probe_positions)
    gx, gy = np.meshgrid(xs, ys, indexing="ij")
    pts = np.stack([gx.ravel(), gy.ravel()], axis=1)
    d2 = (np.sum(pts ** 2, axis=1)[:, None] - 2.0 * pts @ positions.T
          + np.sum(positions ** 2, axis=1)[None, :])
    nearest = np.argmin(d2, axis=1)
    return xs, ys, nearest


def virtual_image(wf_data, mask, intensity: bool = True,
                  layer_index: int = -1) -> np.ndarray:
    """Scan-grid image(s) for an arbitrary detector mask.

    mask: (nx, ny) -> returns (n_x, n_y); (n_seg, nx, ny) -> returns
    (n_seg, n_x, n_y). Scan-grid reconstruction matches
    HAADFData.calculateADF (nearest probe per unique-x/unique-y point).
    """
    mask = np.asarray(mask)
    squeeze = mask.ndim == 2
    collected = detector_sums(wf_data.wavefunction_data, mask, intensity,
                              layer_index).cpu().numpy()
    xs, ys, nearest = _scan_grid(wf_data.probe_positions)
    img = collected[nearest].reshape(len(xs), len(ys), -1)
    img = np.moveaxis(img, -1, 0)
    return img[0] if squeeze else img


def center_of_mass(wf_data, layer_index: int = -1) -> np.ndarray:
    """DPC center-of-mass deflection <k> per scan point: (2, n_x, n_y)
    (kx and ky first moments of the frame-averaged intensity)."""
    kx1 = np.asarray(wf_data.kxs, dtype=np.float64)
    ky1 = np.asarray(wf_data.kys, dtype=np.float64)
    wf = wf_data.wavefunction_data
    # three weight planes (1, kx, ky): the zeroth and first moments in one
    # reduction
    nx, ny = wf.shape[2], wf.shape[3]
    weights = np.stack([np.ones((nx, ny)),
                        np.broadcast_to(kx1[:, None], (nx, ny)),
                        np.broadcast_to(ky1[None, :], (nx, ny))])
    col = detector_sums(wf, weights, intensity=True,
                        layer_index=layer_index).cpu().numpy()
    com = np.stack([col[:, 1] / col[:, 0], col[:, 2] / col[:, 0]])
    xs, ys, nearest = _scan_grid(wf_data.probe_positions)
    return com[:, nearest].reshape(2, len(xs), len(ys))


def bin_k(array, factor: int):
    """Pixelated-detector binning: sum k-space in (factor x factor) blocks
    over the last two axes (trailing remainders are cropped, as real
    detectors crop to their pixel grid)."""
    array = np.asarray(array)
    nx, ny = array.shape[-2:]
    bx, by = nx // factor, ny // factor
    a = array[..., :bx * factor, :by * factor]
    a = a.reshape(*array.shape[:-2], bx, factor, by, factor)
    return a.sum(axis=(-3, -1))


def apply_shot_noise(image, dose: float, pixel_area: float = 1.0,
                     generator: Optional[torch.Generator] = None,
                     device="cuda"):
    """Finite-dose (shot-noise) detector model.

    The noiseless simulation corresponds to infinite dose; real detectors
    count electrons. Each pixel is Poisson-sampled with expectation

        lam = image * dose * pixel_area

    where ``image`` is a detected-fraction-of-beam intensity map (e.g. a
    ``virtual_image(..., intensity=True)`` of a unit-norm probe), ``dose``
    is incident electrons per A^2 and ``pixel_area`` the scan-pixel area
    in A^2. Returns electron counts as a float32 NumPy array. The draws
    come from ``generator`` and run on its device; without one, from
    torch's default generator of ``device`` (the card unless
    ``device="cpu"``). The JAX package draws from ``jax.random`` with a
    seed, so the two packages agree in distribution, not draw for draw.
    """
    dev = generator.device if generator is not None else torch.device(device)
    img = torch.as_tensor(np.asarray(image, np.float64),
                          device=dev).to(torch.float32)
    lam = img * (dose * pixel_area)
    return torch.poisson(lam, generator=generator).cpu().numpy()


def pacbed(wf_data, layer_index: int = -1, probe_indices=None
           ) -> np.ndarray:
    """Position-averaged CBED: the mean diffraction intensity over scan
    positions (and frames) — (nx, ny) fftshifted. PACBED patterns are the
    standard fingerprint for thickness/tilt determination (LeBeau et al.,
    Ultramicroscopy 110, 2010). ``probe_indices`` restricts the average
    to a subset of scan positions (e.g. one unit cell)."""
    per = frame_mean_intensity(wf_data.wavefunction_data, layer_index)
    if probe_indices is not None:
        per = per[torch.as_tensor(np.asarray(probe_indices, np.int64),
                                  device=per.device)]
    return per.mean(dim=0).cpu().numpy()


def radial_profile(pattern, kxs, kys, n_bins: int = 128,
                   kmax: Optional[float] = None
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Azimuthal average of a diffraction pattern.

    pattern: (..., nx, ny) on the fftshifted detector grid (kxs, kys in
    1/Angstrom, monotonic). Returns (k_centers (n_bins,), profile
    (..., n_bins)) where profile[b] is the MEAN intensity over pixels
    with k in bin b (empty bins give 0). ``kmax`` bounds the profiled
    radius (default: the largest inscribed circle, min-axis Nyquist —
    beyond it rings are incomplete and the mean biases)."""
    pattern = np.asarray(pattern)
    kx, ky = _k_grids(kxs, kys)
    q = np.sqrt(kx ** 2 + ky ** 2)
    if kmax is None:
        kmax = min(float(np.max(np.abs(np.asarray(kxs)))),
                   float(np.max(np.abs(np.asarray(kys)))))
    if kmax <= 0:
        raise ValueError(f"kmax must be positive, got {kmax}")
    idx = np.floor(q / kmax * n_bins).astype(np.int64)
    inside = (idx < n_bins).ravel()
    idx = np.clip(idx.ravel(), 0, n_bins - 1)
    counts = np.bincount(idx[inside], minlength=n_bins)
    flat = pattern.reshape(-1, pattern.shape[-2] * pattern.shape[-1])
    sums = np.stack([np.bincount(idx[inside], weights=row[inside],
                                 minlength=n_bins) for row in flat])
    prof = sums / np.maximum(counts, 1)[None, :]
    centers = (np.arange(n_bins) + 0.5) * (kmax / n_bins)
    return centers, prof.reshape(*pattern.shape[:-2], n_bins)


def apply_detector_mtf(pattern, *, a: float = 0.1, c: float = 0.5,
                       order: float = 2.0, mtf=None):
    """Detector modulation-transfer-function blur on recorded pattern(s).

    The recorded pattern is the true one convolved with the pixel
    point-spread function — a multiplication by the MTF in the pattern's
    Fourier domain. The default parametric form is the soft Lorentzian
    used for direct detectors (Kirkland App. A; abTEM's detector model):

        MTF(w) = (1 - a) / (1 + (w / c)**order) + a

    with ``w`` the spatial frequency in units of the detector Nyquist,
    ``c`` the half-falloff frequency and ``a`` the high-frequency floor.
    Pass ``mtf`` (a callable w -> response, vectorized) to override the
    form. Apply after shot noise. Works on any (..., nkx, nky) stack and
    returns float64 NumPy; the pattern sum is conserved (MTF(0) = 1).
    """
    pat = np.asarray(pattern, dtype=np.float64)
    nkx, nky = pat.shape[-2:]
    wx = np.abs(np.fft.fftfreq(nkx)) * 2.0        # 1.0 at Nyquist
    wy = np.abs(np.fft.fftfreq(nky)) * 2.0
    w = np.sqrt(wx[:, None] ** 2 + wy[None, :] ** 2)
    if mtf is None:
        if not 0.0 <= a < 1.0:
            raise ValueError(f"MTF floor a must be in [0, 1), got {a}")
        if c <= 0.0:
            raise ValueError(f"MTF falloff c must be > 0, got {c}")
        if order <= 0.0:
            raise ValueError(f"MTF order must be > 0, got {order} "
                             "(non-positive orders break MTF(0) = 1, the "
                             "energy-conservation guarantee)")
        resp = (1.0 - a) / (1.0 + (w / c) ** order) + a
    else:
        resp = np.asarray(mtf(w), dtype=np.float64)
        if resp.shape != w.shape:
            raise ValueError("mtf(w) must return an array of w's shape")
    return np.fft.ifft2(np.fft.fft2(pat, axes=(-2, -1)) * resp,
                        axes=(-2, -1)).real
