"""Plain multislice, TACAW and HAADF, in one precision or another.

``TRUTH`` computes in float64 / complex128. ``CONTROL`` is the nearest
precision below the configuration's (complex64 with TF32 off): complex64
throughout, with the inputs of the potential's matrix products rounded to
TF32 (10 mantissa bits, as the tensor cores round them), so that it reads
the same on a card and on a CPU.

Conventions (those of the reference PySlice, which define the outputs):

* grid: ``n = int(l / sampling) + 1`` points an axis, ``x = l i / n``;
  ``nz = int(lz / thickness) + 1`` slices at ``z = lz s / nz``;
* slice binning: slice s holds ``edges[s] <= z < edges[s + 1]`` with
  ``edges = [0, z_1 - dz/2, ..., z_last - dz/2, z_last + dz]``;
* potential: for each slice, sum over its atoms of
  ``f_Z(k^2) exp(-2 pi i (kx x + ky y))``, the real part of its inverse
  FFT, divided by the square of the pixel area;
* probe: a plane wave of ones, or ``ifftshift(ifft2(|k| < alpha /
  lambda))`` shifted to each position by ``exp(+2 pi i k . p)``;
* multislice: ``psi <- ifft2(P fft2(t_s psi))`` for all but the last
  slice, then ``t_last psi``; ``t = exp(i sigma V)``, ``P = exp(-i pi
  lambda dz k^2)``; the exit wave goes out as ``fftshift(fft2(psi))``;
* TACAW: ``|fftshift_t(fft_t(psi - mean_t psi))|^2`` a probe; the
  spectrum sums over k, the diffraction over frequency, both averaged
  over probes;
* HAADF: per probe the frame mean of ``sum_k |psi_hat| [q > beta /
  lambda]`` on the nominal axes ``fftfreq(n, sampling)``.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from pathlib import Path

import numpy as np
import torch

# CODATA values of the reference (multislice.py:31-34).
M_ELECTRON = 9.109383e-31
Q_ELECTRON = 1.602177e-19
C_LIGHT = 299792458.0
H_PLANCK = 6.62607015e-34


@dataclasses.dataclass(frozen=True)
class Precision:
    name: str
    real: torch.dtype
    complex: torch.dtype
    tf32_products: bool


TRUTH = Precision("float64", torch.float64, torch.complex128, False)
CONTROL = Precision("tf32", torch.float32, torch.complex64, True)
PRECISIONS = {p.name: p for p in (TRUTH, CONTROL)}


def wavelength(eV: float) -> float:
    """Relativistic electron wavelength in Angstrom."""
    p_c = math.sqrt((eV * Q_ELECTRON) ** 2
                    + 2.0 * eV * Q_ELECTRON * M_ELECTRON * C_LIGHT ** 2)
    return H_PLANCK * C_LIGHT / p_c * 1e10


def sigma(eV: float) -> float:
    """Interaction parameter (Kirkland Eq. 5.6), 1/(V Angstrom)."""
    e0 = M_ELECTRON * C_LIGHT ** 2 / Q_ELECTRON
    return 2.0 * math.pi / (wavelength(eV) * eV) * (e0 + eV) / (2.0 * e0 + eV)


@functools.lru_cache(maxsize=1)
def kirkland_table() -> np.ndarray:
    """(103, 12) rows a1 b1 a2 b2 a3 b3 c1 d1 c2 d2 c3 d3 (Kirkland,
    Advanced Computing in Electron Microscopy, p. 291), from the frozen
    copy beside this file."""
    lines = (Path(__file__).parent / "kirkland_data.txt").read_text().split(
        "\n")
    rows = [" ".join(lines[4 * i + 1:4 * i + 4]).split() for i in range(103)]
    return np.array(rows, dtype=np.float64)


def form_factor(qsq: np.ndarray, z: int) -> np.ndarray:
    """f(q^2) = sum a/(q^2 + b) + sum c exp(-d q^2), float64."""
    a1, b1, a2, b2, a3, b3, c1, d1, c2, d2, c3, d3 = kirkland_table()[z - 1]
    return (a1 / (qsq + b1) + a2 / (qsq + b2) + a3 / (qsq + b3)
            + c1 * np.exp(-d1 * qsq) + c2 * np.exp(-d2 * qsq)
            + c3 * np.exp(-d3 * qsq))


@dataclasses.dataclass(frozen=True)
class Grid:
    lx: float
    ly: float
    lz: float
    sampling: float
    thickness: float

    @property
    def nx(self) -> int:
        return int(self.lx / self.sampling) + 1

    @property
    def ny(self) -> int:
        return int(self.ly / self.sampling) + 1

    @property
    def nz(self) -> int:
        return int(self.lz / self.thickness) + 1

    @property
    def dx(self) -> float:
        return self.lx / self.nx

    @property
    def dy(self) -> float:
        return self.ly / self.ny

    @property
    def dz(self) -> float:
        return self.lz / self.nz

    def edges(self) -> np.ndarray:
        z = self.lz * np.arange(self.nz) / self.nz
        return np.concatenate([[0.0], z[1:] - self.dz / 2, [z[-1] + self.dz]])

    def kx(self) -> np.ndarray:
        return np.fft.fftfreq(self.nx, d=self.dx)

    def ky(self) -> np.ndarray:
        return np.fft.fftfreq(self.ny, d=self.dy)

    def nominal_q(self) -> np.ndarray:
        """|k| on the fftshifted nominal axes fftfreq(n, sampling)."""
        kx = np.fft.fftshift(np.fft.fftfreq(self.nx, d=self.sampling))
        ky = np.fft.fftshift(np.fft.fftfreq(self.ny, d=self.sampling))
        return np.sqrt(kx[:, None] ** 2 + ky[None, :] ** 2)


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10 mantissa bits (to nearest)."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & -0x2000).view(torch.float32)


@functools.lru_cache(maxsize=8)
def _form_factor_on(grid: Grid, z: int, real: torch.dtype,
                    device: str) -> torch.Tensor:
    kx, ky = grid.kx(), grid.ky()
    qsq = kx[:, None] ** 2 + ky[None, :] ** 2
    return torch.as_tensor(form_factor(qsq, z), device=device).to(real)


def potential(frame, types: np.ndarray, grid: Grid, prec: Precision,
              device) -> torch.Tensor:
    """(nz, nx, ny) projected potential of one frame ((n_atoms, 3)
    Angstrom), real in ``prec``."""
    pos = np.asarray(frame, dtype=np.float64)
    types = np.asarray(types)
    s_of = np.searchsorted(grid.edges(), pos[:, 2], side="right") - 1
    kx, ky = grid.kx(), grid.ky()
    dev_real = lambda a: torch.as_tensor(a, device=device).to(prec.real)
    kx_t, ky_t = dev_real(kx), dev_real(ky)
    recip = torch.zeros((grid.nz, grid.nx, grid.ny), dtype=prec.complex,
                        device=device)
    for z in np.unique(types):
        ff = _form_factor_on(grid, int(z), prec.real, str(device))
        for s in range(grid.nz):
            sel = (types == z) & (s_of == s)
            if not sel.any():
                continue
            xy = dev_real(pos[sel, :2])
            px = (-2.0 * math.pi) * (xy[:, 0, None] * kx_t[None, :])
            py = (-2.0 * math.pi) * (xy[:, 1, None] * ky_t[None, :])
            cx, sx, cy, sy = px.cos(), px.sin(), py.cos(), py.sin()
            if prec.tf32_products:
                cx, sx, cy, sy = (_tf32(a) for a in (cx, sx, cy, sy))
            re = cx.T @ cy - sx.T @ sy
            im = cx.T @ sy + sx.T @ cy
            recip[s] += torch.complex(re, im) * ff
    return torch.fft.ifft2(recip).real / (grid.dx * grid.dy) ** 2


def probes(grid: Grid, mrad: float, eV: float, positions, prec: Precision,
           device) -> torch.Tensor:
    """(P, nx, ny) probes at ``positions`` ((P, 2) Angstrom)."""
    kx, ky = grid.kx(), grid.ky()
    if mrad == 0:
        base = torch.ones((grid.nx, grid.ny), dtype=prec.complex,
                          device=device)
    else:
        aperture = np.sqrt(kx[:, None] ** 2 + ky[None, :] ** 2) < (
            mrad * 1e-3 / wavelength(eV))
        base = torch.fft.ifftshift(torch.fft.ifft2(
            torch.as_tensor(aperture, device=device).to(prec.complex)))
    pos = np.asarray(positions, dtype=np.float64).reshape(-1, 2)
    ramp = 2.0 * math.pi * (kx[None, :, None] * pos[:, 0, None, None]
                            + ky[None, None, :] * pos[:, 1, None, None])
    ramp = torch.as_tensor(ramp, device=device).to(prec.real)
    return torch.fft.ifft2(torch.fft.fft2(base)[None]
                           * torch.polar(torch.ones_like(ramp), ramp))


def exit_waves(psi: torch.Tensor, v: torch.Tensor, grid: Grid, eV: float,
               prec: Precision) -> torch.Tensor:
    """(P, nx, ny) fftshifted k-space exit waves of ``psi`` through the
    (nz, nx, ny) potential ``v``."""
    dev = psi.device
    kx = torch.as_tensor(grid.kx(), device=dev).to(prec.real)
    ky = torch.as_tensor(grid.ky(), device=dev).to(prec.real)
    chi = (-math.pi * wavelength(eV) * grid.dz) * (kx[:, None] ** 2
                                                   + ky[None, :] ** 2)
    prop = torch.polar(torch.ones_like(chi), chi)
    phase = torch.tensor(sigma(eV), dtype=prec.real, device=dev) * v.to(
        prec.real)
    t = torch.polar(torch.ones_like(phase), phase)
    for s in range(v.shape[0] - 1):
        psi = torch.fft.ifft2(prop * torch.fft.fft2(t[s] * psi))
    return torch.fft.fftshift(torch.fft.fft2(t[-1] * psi), dim=(-2, -1))


def tacaw_intensity(waves: torch.Tensor) -> torch.Tensor:
    """(T, nx, ny) exit waves of one probe -> (T, nx, ny) intensity."""
    w = waves - waves.mean(dim=0, keepdim=True)
    return torch.fft.fftshift(torch.fft.fft(w, dim=0), dim=0).abs() ** 2


def adf_mask(grid: Grid, mrad: float, eV: float) -> np.ndarray:
    return grid.nominal_q() > mrad * 1e-3 / wavelength(eV)


def adf_image(collected: np.ndarray, positions) -> np.ndarray:
    """Per-probe signals onto the scan grid of the unique probe x and y
    (each scan point takes its nearest probe)."""
    pos = np.asarray(positions, dtype=np.float64)
    xs, ys = np.unique(pos[:, 0]), np.unique(pos[:, 1])
    gx, gy = np.meshgrid(xs, ys, indexing="ij")
    pts = np.stack([gx.ravel(), gy.ravel()], axis=1)
    d2 = ((pts[:, None, :] - pos[None, :, :]) ** 2).sum(axis=2)
    return np.asarray(collected)[np.argmin(d2, axis=1)].reshape(
        len(xs), len(ys))


def stream_bins(n_frames: int, timestep: float, frequencies) -> np.ndarray:
    """The fftfreq bins nearest to ``frequencies`` (THz)."""
    f = np.fft.fftfreq(n_frames, d=timestep)
    return np.array([int(np.argmin(np.abs(f - x))) for x in frequencies])


def dft_intensity(acc: torch.Tensor, total: torch.Tensor,
                  weights: torch.Tensor, n_frames: int) -> torch.Tensor:
    """|DFT of the mean-free signal|^2 at a stream's bins, from ``acc[f] =
    sum_t psi_t w_f(t)``, ``total = sum_t psi_t`` and ``weights[f] =
    sum_t w_f(t)`` over the whole stream."""
    mean = total / n_frames
    return (acc - weights[:, None, None] * mean[None]).abs() ** 2


def phase_weights(frames, bins, n_frames: int) -> np.ndarray:
    """exp(-2 pi i f t / n), (len(frames), len(bins)), complex128."""
    return np.exp((-2j * math.pi / n_frames) * np.outer(
        np.asarray(frames, dtype=np.float64),
        np.asarray(bins, dtype=np.float64)))
