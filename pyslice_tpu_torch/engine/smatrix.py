"""PRISM-style scattering-matrix STEM.

Counterpart of ``pyslice_tpu/engine/smatrix.py``. Multislice is linear in
the incident wave, and every aperture-limited probe is a small set of
plane waves:

    probe(r; r0) = (1/Npix) sum_{kappa in aperture} e^{2pi i kappa.(s + r0)}
                   * e^{2pi i kappa.r}

(s is the ifftshift centering offset: exactly ``physics.probe``'s
probe_array + shift_probes). So:

  1. Propagate the plane-wave basis through the potential once per frame:
     S[kappa] = multislice(e^{2pi i kappa.r}), the scattering matrix, in
     beam chunks through the port's ``multislice`` (its kernels on the
     card).
  2. Synthesize any probe's exit wave as one (P, Nb) @ (Nb, npix) complex
     matrix product (``torch.matmul``; TF32 stays off, ``core.dtypes``).

At f=1 (all aperture beams) the synthesis is exact; the PRISM
interpolation factor ``f`` keeps every f-th beam index per axis (n_beams /
f^2), making the incident probe periodic with period (lx/f, ly/f) —
accurate while the probe stays compact inside that window (Ophus, Adv
Struct Chem Imaging 3:13, 2017).

Every function runs on the device of its inputs: ``compute_smatrix`` on
``device`` (the card unless ``device="cpu"``), the synthesis on the
device of ``sm.s``. ``compute_smatrix(mesh=...)`` shards the beams over
the ranks of a (frame, probe) mesh (or of one of its axes): each rank
propagates its beam chunks, ``sm.s`` keeps only its rows, and the
synthesis is a local partial product over the rank's beams followed by
one all_reduce.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..core.constants import wavelength as _wavelength
from ..core.dtypes import Precision, get_precision
from ..physics.potential import RasterizerPlan, rasterize
from ..physics.propagate import multislice


@dataclasses.dataclass(frozen=True)
class BeamSet:
    """Aperture plane-wave basis: physical k values and the synthesis
    phase offset (the probe-centering ifftshift translation)."""
    kxb: np.ndarray          # (Nb,) 1/Angstrom
    kyb: np.ndarray          # (Nb,)
    shift: Tuple[float, float]   # s = (nx//2 * dx, ny//2 * dy)
    f: int
    mrad: float
    eV: float

    @property
    def n_beams(self) -> int:
        return len(self.kxb)


def build_beams(xs, ys, mrad: float, eV: float, f: int = 1) -> BeamSet:
    """Plane-wave k-points inside the aperture, every f-th fftfreq index
    per axis (PRISM interpolation factor; f=1 keeps all -> exact).

    Subsampling k by f periodizes the incident probe with period
    (lx/f, ly/f) at amplitude 1/f^2 per replica (Poisson summation); the
    synthesis stage crops one replica's window and rescales by f^2, so f
    must divide both grid extents."""
    xs = np.asarray(xs)
    ys = np.asarray(ys)
    nx, ny = len(xs), len(ys)
    if nx % f or ny % f:
        raise ValueError(f"PRISM factor f={f} must divide the grid "
                         f"({nx}x{ny}) for clean probe windows")
    if mrad <= 0:
        raise ValueError(
            "the S-matrix path needs a convergent probe (mrad > 0); "
            "plane-wave workloads have one incident wave — use the direct "
            "pipeline")
    dx, dy = float(xs[1] - xs[0]), float(ys[1] - ys[0])
    lam = _wavelength(eV)
    q_ap = (mrad * 1e-3) / lam
    kxs = np.fft.fftfreq(nx, d=dx)
    kys = np.fft.fftfreq(ny, d=dy)
    ix = np.arange(nx) % f == 0
    iy = np.arange(ny) % f == 0
    kxg, kyg = np.meshgrid(kxs[ix], kys[iy], indexing="ij")
    inside = (kxg ** 2 + kyg ** 2) < q_ap ** 2
    return BeamSet(kxb=kxg[inside].ravel(), kyb=kyg[inside].ravel(),
                   shift=((nx // 2) * dx, (ny // 2) * dy),
                   f=int(f), mrad=float(mrad), eV=float(eV))


@dataclasses.dataclass(frozen=True, eq=False)
class SMatrix:
    """Scattering matrix for one frame (eq=False: identity-hashed).

    f == 1: ``s`` holds k-space rows fftshift(fft2(multislice(wave_b))),
    synthesis is a plain matrix product, detector axes = the full k grid.
    f > 1 (PRISM): ``s`` holds real-space exit rows; synthesis crops the
    (nx/f, ny/f) window around each probe (replicas are lx/f apart) and
    rescales by f^2; detector axes = the window's (coarser) k grid."""
    beams: BeamSet
    s: torch.Tensor          # (Nb, nx, ny) complex (space depends on f)
    kxs: np.ndarray          # fftshifted detector axes (window axes if f>1)
    kys: np.ndarray
    npix: int
    nx: int
    ny: int
    dx: float
    dy: float
    # Beam-sharded (compute_smatrix(mesh=)): ``s`` holds beams
    # [beam_range[0], beam_range[1]) and the synthesis sums over ``group``.
    beam_range: Optional[Tuple[int, int]] = None
    group: object = None

    @property
    def window(self) -> Tuple[int, int]:
        return self.nx // self.beams.f, self.ny // self.beams.f


def _plane_waves(kxb, kyb, xs, ys, cdtype):
    """(n, nx, ny) plane waves exp(2 pi i (kx x + ky y)) from real tensors,
    the phase in their precision."""
    phase = (2.0 * np.pi) * (kxb[:, None, None] * xs[None, :, None]
                             + kyb[:, None, None] * ys[None, None, :])
    return torch.complex(torch.cos(phase), torch.sin(phase)).to(cdtype)


# The JAX package's crossover, kept for dispatch parity with it: there the
# f=1 basis build amortized against direct propagation at ~2,000 probes a
# frame (measured on a TPU). Scan production (StreamingHAADF,
# frozen_phonon_haadf) routes through the S-matrix above it.
SMATRIX_MIN_PROBES = 2000


def smatrix_auto(n_probes: int, mrad: float, ksq2d, nx: int, ny: int,
                 f: int = 1) -> bool:
    """Should a scan of ``n_probes`` positions route through the S-matrix?
    Needs a convergent probe, an orthogonal cell, f-divisible grid axes,
    and enough probes to amortize the basis build."""
    return (mrad > 0 and ksq2d is None
            and nx % f == 0 and ny % f == 0
            and n_probes >= SMATRIX_MIN_PROBES)


def compute_smatrix(positions, plan: RasterizerPlan, beams: BeamSet,
                    *, xs, ys, dz: float, precision: Optional[Precision] = None,
                    beam_chunk: int = 64, ksq=None, mesh=None,
                    kmax2: Optional[float] = None,
                    device="cuda", axis: Optional[str] = None) -> SMatrix:
    """Propagate the beam basis through one frame's potential.

    positions: (n_atoms, 3) frame positions (rasterized with ``plan``), a
    tensor (its device runs the build) or an array placed on ``device``.
    ``beam_chunk`` bounds device memory: beams propagate in chunks of at
    most this many, split into the fewest near-equal chunks.

    ``mesh``: a ('frame', 'probe') DeviceMesh; the chunk count is padded to
    a multiple of the rank count and each rank propagates its block of
    chunks (in the mesh's row-major order), keeping only its beams' rows.
    ``axis`` shards over one mesh axis instead of all ranks (the
    frame-sharded HAADF stream: each frame row builds its own frame's
    basis over its probe axis).
    """
    if ksq is not None:
        raise ValueError(
            "oblique cells are not supported by the S-matrix path: beam "
            "selection, probe coefficients, and window cropping assume an "
            "orthogonal cell (use the direct pipeline, which handles "
            "oblique metrics end-to-end)")
    prec = get_precision(precision)
    if isinstance(positions, torch.Tensor):
        device = positions.device
    dev = torch.device(device)
    v = rasterize(positions, plan, prec, device=dev)
    nb = beams.n_beams
    f = beams.f
    xs = np.asarray(xs)
    ys = np.asarray(ys)
    nx, ny = len(xs), len(ys)
    dx, dy = float(xs[1] - xs[0]), float(ys[1] - ys[0])
    # The fewest <= beam_chunk chunks, balanced, so at most n_chunks - 1
    # dummy beams are propagated.
    n_chunks = -(-nb // max(1, min(beam_chunk, nb)))
    group, first, n_mine = None, 0, n_chunks
    if mesh is not None:
        group, n_ranks, index = _beam_group(mesh, axis)
        n_chunks = -(-n_chunks // n_ranks) * n_ranks
        n_mine = n_chunks // n_ranks
        first = index * n_mine
    chunk = -(-nb // n_chunks)
    pad = n_chunks * chunk - nb
    real = lambda a: torch.as_tensor(np.asarray(a, np.float64),
                                     device=dev).to(prec.real)
    kxb = real(np.concatenate([beams.kxb, np.zeros(pad)]))
    kyb = real(np.concatenate([beams.kyb, np.zeros(pad)]))
    xs_r, ys_r = real(xs), real(ys)
    kxs = np.fft.fftfreq(nx, d=dx)
    kys = np.fft.fftfreq(ny, d=dy)
    lo = min(first * chunk, nb)
    hi = min((first + n_mine) * chunk, nb)
    s = torch.empty((hi - lo, nx, ny), dtype=prec.complex, device=dev)
    for c in range(first, first + n_mine):
        a, b = c * chunk, min((c + 1) * chunk, nb)
        if a >= b:
            continue
        waves = _plane_waves(kxb[c * chunk:(c + 1) * chunk],
                             kyb[c * chunk:(c + 1) * chunk], xs_r, ys_r,
                             prec.complex)
        out = multislice(waves, v, kxs, kys, eV=beams.eV, dz=dz,
                         precision=prec, ksq=ksq, kmax2=kmax2)
        if f == 1:
            out = torch.fft.fftshift(torch.fft.fft2(out), dim=(-2, -1))
        s[a - lo:b - lo] = out[:b - a]
        del waves, out
    if f == 1:
        det_kxs, det_kys = np.fft.fftshift(kxs), np.fft.fftshift(kys)
    else:
        det_kxs = np.fft.fftshift(np.fft.fftfreq(nx // f, d=dx))
        det_kys = np.fft.fftshift(np.fft.fftfreq(ny // f, d=dy))
    return SMatrix(beams=beams, s=s, kxs=det_kxs, kys=det_kys,
                   npix=nx * ny, nx=nx, ny=ny, dx=dx, dy=dy,
                   beam_range=(lo, hi) if mesh is not None else None,
                   group=group)


def _beam_group(mesh, axis: Optional[str]):
    """(process group, rank count, this rank's index) over which the beams
    shard: one mesh axis, or every rank of a mesh that spans the job."""
    from ..parallel.mesh import coord, extent, flat_index, world_group
    if axis is not None:
        return mesh.get_group(axis), extent(mesh, axis), coord(mesh, axis)
    return world_group(mesh), mesh.size(), flat_index(mesh)


def probe_coefficients(beams: BeamSet, probe_positions, npix: int,
                       precision: Optional[Precision] = None,
                       aberrations=None, defocus: float = 0.0,
                       device="cuda") -> torch.Tensor:
    """(P, Nb) complex synthesis coefficients on ``device``: probe(r0) =
    C @ basis. c_b(r0) = exp(2 pi i kappa_b . (s + r0)) / Npix — exactly
    probe_array + shift_probes (the 1/Npix is ifft2's normalization).

    ``aberrations`` (physics.aberrations.Aberrations or coefficient dict)
    and/or ``defocus`` (Angstrom, added to C1) imprint the aberration
    surface exp(-i chi(kappa_b)) on each coefficient; the basis is
    k-diagonal, so this is exact."""
    prec = get_precision(precision)
    phase = coefficient_phase(beams, probe_positions,
                              aberrations=aberrations, defocus=defocus)
    phase = torch.as_tensor(phase, device=torch.device(device)).to(prec.real)
    c = torch.complex(torch.cos(phase), torch.sin(phase))
    return (c / npix).to(prec.complex)


def coefficient_phase(beams: BeamSet, probe_positions, aberrations=None,
                      defocus: float = 0.0) -> np.ndarray:
    """Host-side (P, Nb) float64 coefficient phases — the argument of
    probe_coefficients' complex exponential."""
    pos = np.asarray(probe_positions, np.float64).reshape(-1, 2)
    sx, sy = beams.shift
    phase = (2.0 * np.pi) * ((pos[:, 0] + sx)[:, None] * beams.kxb[None, :]
                             + (pos[:, 1] + sy)[:, None] * beams.kyb[None, :])
    ab = _normalize_aberrations(aberrations, defocus)
    if ab is not None:
        from ..physics.aberrations import chi_phase
        lam = _wavelength(beams.eV)
        chi = chi_phase(beams.kxb ** 2 + beams.kyb ** 2,
                        beams.kxb, beams.kyb, lam=lam, ab=ab)
        phase = phase - np.asarray(chi, np.float64)[None, :]
    return phase


def _normalize_aberrations(aberrations, defocus: float):
    """Canonical Aberrations with ``defocus`` folded into C1; None if the
    combined surface is zero."""
    from ..physics.aberrations import Aberrations
    if isinstance(aberrations, dict):
        aberrations = Aberrations(**aberrations)
    if defocus:
        aberrations = dataclasses.replace(
            aberrations or Aberrations(),
            C1=(aberrations.C1 if aberrations else 0.0) + float(defocus))
    if aberrations is None or aberrations.is_zero():
        return None
    return aberrations


def _window_starts(sm: SMatrix, probe_positions) -> Tuple[np.ndarray,
                                                          np.ndarray]:
    """Top-left pixel of each probe's (nx/f, ny/f) replica window."""
    return window_starts_geom(sm.nx, sm.ny, sm.dx, sm.dy, sm.beams.f,
                              probe_positions)


def window_starts_geom(nx: int, ny: int, dx: float, dy: float, f: int,
                       probe_positions) -> Tuple[np.ndarray, np.ndarray]:
    """_window_starts from bare grid geometry. The shifted probe for
    position (px, py) peaks at grid point (x_c - px, y_c - py) mod L (the
    reference's mirrored shift ramp, quirk 14); the unshifted peak x_c
    sits at ceil(n/2), which differs from n//2 on odd grids."""
    pos = np.asarray(probe_positions, np.float64).reshape(-1, 2)
    wx, wy = nx // f, ny // f
    cx = ((nx + 1) // 2 - np.rint(pos[:, 0] / dx).astype(int)) % nx
    cy = ((ny + 1) // 2 - np.rint(pos[:, 1] / dy).astype(int)) % ny
    return (cx - wx // 2) % nx, (cy - wy // 2) % ny


def _synth_chunks(sm: SMatrix, probe_positions, precision, probe_chunk,
                  mode, weights=None, aberrations=None,
                  defocus: float = 0.0) -> torch.Tensor:
    """The chunked synthesis on the device of ``sm.s``. mode "exit" gives
    the synthesized k-space planes (P, nx, ny) (the window's (P, wx, wy) if
    f > 1); "amp" / "int" reduce each chunk against the detector weights,
    (P,)."""
    prec = get_precision(precision)
    dev = sm.s.device
    coeffs = probe_coefficients(sm.beams, probe_positions, sm.npix, prec,
                                aberrations=aberrations, defocus=defocus,
                                device=dev)
    p = coeffs.shape[0]
    f = sm.beams.f
    chunk = max(1, min(probe_chunk, p))
    wx, wy = sm.window
    s_flat = sm.s.reshape(sm.s.shape[0], -1)
    if sm.group is not None:
        coeffs = coeffs[:, sm.beam_range[0]:sm.beam_range[1]]
    if f > 1:
        sxa, sya = _window_starts(sm, probe_positions)
        ix = torch.as_tensor((sxa[:, None] + np.arange(wx)[None]) % sm.nx,
                             device=dev)
        iy = torch.as_tensor((sya[:, None] + np.arange(wy)[None]) % sm.ny,
                             device=dev)
    if weights is not None:
        w = (weights if isinstance(weights, torch.Tensor)
             else torch.as_tensor(np.asarray(weights, np.float64)))
        w = w.reshape(-1).to(device=dev, dtype=prec.real)
    out = []
    for a in range(0, p, chunk):
        b = min(a + chunk, p)
        e = torch.matmul(coeffs[a:b], s_flat)
        if sm.group is not None:
            # the rank's beams' partial product, summed over the ranks
            from ..parallel.sharded import all_reduce
            e = all_reduce(e, sm.group)
        e = e.reshape(b - a, sm.nx, sm.ny)
        if f > 1:
            # each probe's replica window, gathered straight from the plane
            rows = torch.arange(b - a, device=dev)[:, None, None]
            e = e[rows, ix[a:b, :, None], iy[a:b, None, :]] * (f * f)
            e = torch.fft.fftshift(torch.fft.fft2(e), dim=(-2, -1))
        if mode == "exit":
            out.append(e)
            continue
        amp = e.reshape(b - a, -1).abs()
        if mode == "int":
            amp = amp * amp
        out.append(amp @ w)
    return torch.cat(out)


def smatrix_exit_kspace(sm: SMatrix, probe_positions,
                        precision: Optional[Precision] = None,
                        probe_chunk: int = 128, aberrations=None,
                        defocus: float = 0.0) -> torch.Tensor:
    """Synthesize fftshifted k-space exit waves for arbitrary probe
    positions, on the device of ``sm.s``. f=1: (P, nx, ny), identical to
    the direct pipeline's fftshift(fft2(multislice(shifted probes))). f>1:
    (P, nx/f, ny/f) probe-window diffraction patterns on the sm.kxs/kys
    axes; each window's crop origin is rint-quantized per probe, so
    magnitudes are position-consistent and complex phases are not (use
    f=1 for phase-sensitive work)."""
    return _synth_chunks(sm, probe_positions, precision, probe_chunk,
                         "exit", aberrations=aberrations, defocus=defocus)


def smatrix_reduce(sm: SMatrix, probe_positions, weights,
                   intensity: bool = False,
                   precision: Optional[Precision] = None,
                   probe_chunk: int = 128, aberrations=None,
                   defocus: float = 0.0) -> np.ndarray:
    """Detector reduction without materializing all per-probe exit waves:
    value(p) = sum_k w(k) |exit(p, k)| (amplitude, the reference HAADF
    convention — quirk 11; ``intensity=True`` squares). ``weights`` is a
    mask/weight array on the fftshifted detector grid sm.kxs/kys (the
    window grid when f > 1). One (probe_chunk, npix) plane at a time; f > 1
    values are calibrated to full-grid pixel sums (rescaled by f^2), so
    they compare directly with HAADFData.calculateADF. Returns a host
    array."""
    vals = _synth_chunks(sm, probe_positions, precision, probe_chunk,
                         "int" if intensity else "amp", weights=weights,
                         aberrations=aberrations, defocus=defocus)
    return vals.cpu().numpy() * float(sm.beams.f ** 2)


def smatrix_virtual_image(sm: SMatrix, probe_positions, weights,
                          intensity: bool = True,
                          precision: Optional[Precision] = None,
                          probe_chunk: int = 128, aberrations=None,
                          defocus: float = 0.0):
    """4D-STEM virtual image through the S-matrix: the detector-weighted
    reduction of every scan position's diffraction pattern, assembled on
    the reconstructed scan grid (``analysis.detectors.virtual_image``'s
    semantics without materializing per-probe exit waves).

    Returns (image (n_x, n_y), scan_xs, scan_ys). ``weights`` lives on the
    fftshifted detector grid sm.kxs/kys; ``intensity=True`` gives the
    physical |psi|^2 detector (False: the reference HAADF amplitude
    convention, quirk 11)."""
    vals = smatrix_reduce(sm, probe_positions, weights, intensity=intensity,
                          precision=precision, probe_chunk=probe_chunk,
                          aberrations=aberrations, defocus=defocus)
    from ..analysis.detectors import _scan_grid
    xs, ys, nearest = _scan_grid(
        np.asarray(probe_positions, np.float64).reshape(-1, 2))
    return vals[nearest].reshape(len(xs), len(ys)), xs, ys
