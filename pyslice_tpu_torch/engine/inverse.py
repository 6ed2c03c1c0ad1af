"""Inverse problems at the structure level: refine atomic coordinates (and
probe aberrations) against measured 4D-STEM data.

Counterpart of ``pyslice_tpu/engine/inverse.py``. The forward model is
differentiable end to end:

    atom positions -> rasterize (structure-factor phase ramps, smooth in
    position; physics/potential.py) -> multislice_diff (the O(1)-memory
    adjoint; the CUDA chains on the card) -> detector amplitudes

so the gradient of the misfit with respect to the coordinates is exact,
and an Adam loop (``analysis.ptychography._Adam``, optax's update) refines
a perturbed model to the data. The gradient reaches the positions through
the rasterizer's torch ops, ``recip[s] += ...`` included. The JAX package
compiles each solve; here the steps run as an eager loop.

Limitations, as in the JAX package: gradients are in-plane only for one
projection (the slice binning of z is piecewise constant; the tilt series
constrains z), and atoms must stay within their planned (type, slice)
buckets (``pad_fraction`` gives the static plan headroom; an uncovered
frame is NaN-poisoned by the rasterizer).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..analysis.ptychography import (_Adam, _amplitudes_on,
                                     _epoch_batches, _shift_ramps)
from ..core.constants import wavelength
from ..physics.aberrations import Aberrations
from ..physics.adjoint import multislice_diff
from ..physics.potential import make_plan, rasterize


def _amplitude_misfit(psi_b, v, a_b, kx, ky, *, eV, dz, prec):
    """Detector-amplitude MSE of a probe batch through the multislice
    adjoint (the epsilon keeps the amplitude's gradient finite at exact
    zeros, as in the JAX package)."""
    exit_b = multislice_diff(psi_b, v, kx, ky, eV=eV, dz=dz, precision=prec)
    amp = torch.sqrt(torch.abs(torch.fft.fft2(exit_b)) ** 2 + 1e-24)
    return torch.mean((amp - a_b) ** 2)


def _host_setup(data4d, scan_positions, probe):
    """Validated (data, scan) NumPy arrays of a single-probe refinement."""
    data = np.asarray(data4d)
    scan = np.asarray(scan_positions, np.float64)
    if scan.shape[0] != data.shape[0]:
        raise ValueError(f"data4d has {data.shape[0]} patterns but "
                         f"scan_positions has {scan.shape[0]}")
    if probe.array.dim() != 2:
        raise ValueError("probe must be a single (nx, ny) Probe")
    return data, scan


def _shifted(probe0, kx, ky, scan_b):
    """The probe shifted to each scan position of the batch."""
    return torch.fft.ifft2(torch.fft.fft2(probe0)[None]
                           * _shift_ramps(kx, ky, scan_b))


def _step(params: dict, adams: dict, loss_fn, mask=None) -> torch.Tensor:
    """One Adam step of ``loss_fn(**params)`` on every parameter in
    ``adams``; ``mask`` multiplies the positions' gradient. Updates
    ``params`` in place; returns the loss."""
    leaves = {k: params[k].detach().requires_grad_() for k in adams}
    val = loss_fn(**leaves)
    grads = torch.autograd.grad(val, list(leaves.values()))
    with torch.no_grad():
        for (k, g) in zip(leaves, grads):
            if mask is not None:
                g = g * mask
            params[k] = adams[k](params[k], g)
    return val.detach()


def refine_structure(data4d, scan_positions, probe, positions0, types,
                     zs, *, steps: int = 200,
                     batch: Optional[int] = None, lr: float = 5e-3,
                     seed: int = 0, pad_fraction: float = 0.5,
                     debye_waller=None) -> dict:
    """Refine atomic coordinates against intensity-only 4D-STEM data.

    data4d: (npos, nkx, nky) fftshifted intensities; scan_positions
    (npos, 2) Angstrom; probe the illumination ``Probe`` (its device is the
    run's); positions0 (n_atoms, 3) the starting model; types (n_atoms,)
    atomic numbers; zs the slice coordinates. steps/batch/lr/seed: the Adam
    schedule (lr in Angstrom); pad_fraction: bucket headroom of the static
    plan; debye_waller: optional {element: B}.

    Returns dict with ``positions`` ((n_atoms, 3); z unchanged),
    ``displacement`` ((n_atoms,) in-plane |r - r0|) and ``losses``
    (steps,).
    """
    prec = probe.precision
    rd = prec.np_real
    dev = probe.device
    data, scan = _host_setup(data4d, scan_positions, probe)
    pos0 = np.asarray(positions0, np.float64)
    plan = make_plan(probe.xs, probe.ys, zs, pos0[None],
                     np.asarray(types, np.int32),
                     pad_fraction=pad_fraction, debye_waller=debye_waller)
    dz = float(zs[1] - zs[0]) if len(np.asarray(zs)) > 1 else 1.0
    nb = data.shape[0] if batch is None else int(min(batch, data.shape[0]))
    batches = _epoch_batches(data.shape[0], nb, steps, seed)

    as_dev = lambda a: torch.as_tensor(np.asarray(a).astype(rd), device=dev)
    amps, scan_t = _amplitudes_on(data, prec.real, dev), as_dev(scan)
    kx, ky = as_dev(probe.kxs), as_dev(probe.kys)
    p0 = probe.array
    eV = float(probe.eV)
    # z gradients are exactly zero through the slice binning; masking keeps
    # Adam's moments from accumulating noise there.
    mask = torch.tensor([1.0, 1.0, 0.0], dtype=prec.real, device=dev)
    params = {"pos": as_dev(pos0)}
    adams = {"pos": _Adam(lr)}
    losses = []
    for idx in batches:
        idx = torch.as_tensor(idx, device=dev).long()

        def loss_fn(pos):
            v = rasterize(pos, plan, prec)
            return _amplitude_misfit(_shifted(p0, kx, ky, scan_t[idx]), v,
                                     amps[idx], kx, ky, eV=eV, dz=dz,
                                     prec=prec)

        losses.append(_step(params, adams, loss_fn, mask))
    pos = params["pos"].cpu().numpy().astype(np.float64)
    disp = np.hypot(pos[:, 0] - pos0[:, 0], pos[:, 1] - pos0[:, 1])
    return dict(positions=pos, displacement=disp,
                losses=np.asarray([float(l) for l in losses], rd))


# --- aberration-coefficient refinement ---------------------------------------

# anisotropic harmonics: name -> azimuthal order m
_ANISO_ORDER = {"A1": 2, "B2": 1, "A2": 3, "A3": 4}


def _aberration_basis(kxs, kys, lam: float, names, k_ap: float):
    """chi = sum_k c_k * term_k, each term as ``physics.aberrations.
    chi_phase`` builds it; anisotropic names expand to Cartesian (a, b)
    pairs. Terms are normalized to unit centred RMS inside the aperture so
    one Adam rate fits coefficients of very different physical scales;
    ``scales`` converts back (phys = fitted / scale). Host NumPy, float64,
    as the JAX package's."""
    kx2d = np.asarray(kxs, np.float64)[:, None] * np.ones(len(kys))[None, :]
    ky2d = np.ones(len(kxs))[:, None] * np.asarray(kys, np.float64)[None, :]
    q2 = kx2d ** 2 + ky2d ** 2
    phi = np.arctan2(ky2d, kx2d)
    l2 = lam * lam
    radial = {
        "C1": np.pi * lam * q2,
        "C3": 0.5 * np.pi * lam * l2 * q2 * q2,
        "C5": np.pi / 3.0 * lam * l2 * l2 * q2 ** 3,
        "A1": np.pi * lam * q2,
        "B2": (2 * np.pi / 3 * l2) * q2 ** 1.5,
        "A2": (2 * np.pi / 3 * l2) * q2 ** 1.5,
        "A3": 0.5 * np.pi * lam * l2 * q2 * q2,
    }
    ap = q2 <= k_ap ** 2
    labels, terms, scales = [], [], []

    def add(label, term):
        t_ap = term[ap]
        s = float(np.sqrt(np.mean((t_ap - t_ap.mean()) ** 2)))
        if s <= 0:
            raise ValueError(f"aberration term {label} has no variation "
                             "inside the aperture — unidentifiable")
        labels.append(label)
        terms.append(term / s)
        scales.append(s)

    for name in names:
        if name not in radial:
            raise ValueError(f"unknown aberration {name!r}; supported: "
                             f"{sorted(radial)}")
        if name in _ANISO_ORDER:
            m = _ANISO_ORDER[name]
            add(f"{name}a", radial[name] * np.cos(m * phi))
            add(f"{name}b", radial[name] * np.sin(m * phi))
        else:
            add(name, radial[name])
    return labels, np.stack(terms), np.asarray(scales)


def refine_aberrations(data4d, scan_positions, probe,
                       coefficients=("C1", "C3"), *, n_slices: int = 1,
                       dz: float = 1.0, steps: int = 400,
                       batch: Optional[int] = None, lr: float = 8.0,
                       lr_ab: float = 0.05, v_init=None,
                       seed: int = 0) -> dict:
    """Fit residual probe aberrations (relative to ``probe``) jointly with
    the specimen potential, from intensity-only 4D-STEM data.

    Arguments as ``msp_reconstruct``; ``coefficients``: Krivanek names to
    fit (isotropic C1/C3/C5, anisotropic A1/B2/A2/A3 as Cartesian (a, b)
    pairs); ``lr_ab``: Adam rate of the RMS-normalized coefficients.

    Returns dict with ``aberrations`` (an ``Aberrations`` of the fitted
    residuals), ``coefficients`` ({label: Angstrom}), ``potential`` and
    ``losses``.
    """
    prec = probe.precision
    rd = prec.np_real
    dev = probe.device
    data, scan = _host_setup(data4d, scan_positions, probe)
    p0 = probe.array
    lam = wavelength(probe.eV)
    k_ap = (probe.mrad * 1e-3) / lam if probe.mrad else float(
        np.max(np.abs(np.asarray(probe.kxs))))
    labels, terms, scales = _aberration_basis(probe.kxs, probe.kys, lam,
                                              tuple(coefficients), k_ap)
    nb = data.shape[0] if batch is None else int(min(batch, data.shape[0]))
    batches = _epoch_batches(data.shape[0], nb, steps, seed)

    as_dev = lambda a: torch.as_tensor(np.asarray(a).astype(rd), device=dev)
    amps, scan_t = _amplitudes_on(data, prec.real, dev), as_dev(scan)
    kx, ky = as_dev(probe.kxs), as_dev(probe.kys)
    basis = as_dev(terms)
    p0k = torch.fft.fft2(p0)
    eV = float(probe.eV)
    params = {"v": (torch.zeros((n_slices,) + tuple(p0.shape),
                                dtype=prec.real, device=dev)
                    if v_init is None else as_dev(v_init)),
              "c": torch.zeros(len(labels), dtype=prec.real, device=dev)}
    adams = {"v": _Adam(lr), "c": _Adam(lr_ab)}
    losses = []
    for idx in batches:
        idx = torch.as_tensor(idx, device=dev).long()

        def loss_fn(v, c):
            chi = torch.tensordot(c, basis, dims=1)
            pk = p0k * torch.complex(torch.cos(chi), -torch.sin(chi))
            psi_b = torch.fft.ifft2(pk[None]
                                    * _shift_ramps(kx, ky, scan_t[idx]))
            return _amplitude_misfit(psi_b, v, amps[idx], kx, ky, eV=eV,
                                     dz=float(dz), prec=prec)

        losses.append(_step(params, adams, loss_fn))
    phys = params["c"].cpu().numpy().astype(np.float64) / scales
    coeffs = dict(zip(labels, phys.tolist()))
    ab_kw = {}
    for name in coefficients:
        if name in _ANISO_ORDER:
            m = _ANISO_ORDER[name]
            a_v, b_v = coeffs[f"{name}a"], coeffs[f"{name}b"]
            ab_kw[name] = float(np.hypot(a_v, b_v))
            ab_kw[f"phi_{name}"] = float(np.arctan2(b_v, a_v) / m)
        else:
            ab_kw[name] = float(coeffs[name])
    return dict(aberrations=Aberrations(**ab_kw), coefficients=coeffs,
                potential=params["v"].cpu().numpy(),
                losses=np.asarray([float(l) for l in losses], rd))


# --- tilt-series (tomographic) structure refinement ---------------------------


def rotation_about_x(theta_rad: float) -> np.ndarray:
    """Right-handed rotation about the x (tilt) axis."""
    c, s = np.cos(theta_rad), np.sin(theta_rad)
    return np.array([[1.0, 0.0, 0.0], [0.0, c, -s], [0.0, s, c]])


def refine_structure_tilt_series(datasets, scan_positions, probe,
                                 positions0, types, zs, tilt_angles_deg, *,
                                 steps: int = 300,
                                 batch: Optional[int] = None,
                                 lr: float = 5e-3, seed: int = 0,
                                 pad_fraction: float = 0.5,
                                 center=None) -> dict:
    """Atomic-coordinate refinement against a tilt series of 4D-STEM
    datasets: per tilt t the model is rasterize(R_t (r - c) + c) ->
    multislice -> detector, with the same coordinates r; Adam steps cycle
    round-robin over the tilts, each on one tilt's minibatch, so a few
    tilts constrain all three coordinates. Rotations are about the x axis
    (positive angles right-handed) about ``center`` (default: the centroid
    of ``positions0``); each tilt has its own static plan from the rotated
    starting model.

    datasets / scan_positions: one (npos_t, nkx, nky) stack and one
    (npos_t, 2) scan per tilt; the rest as ``refine_structure``.

    Returns dict with ``positions`` ((n_atoms, 3), all three refined),
    ``displacement`` ((n_atoms,) 3-D |r - r0|) and ``losses`` ((steps,),
    the stepped tilt's minibatch loss).
    """
    prec = probe.precision
    rd = prec.np_real
    dev = probe.device
    n_tilts = len(tilt_angles_deg)
    if len(datasets) != n_tilts or len(scan_positions) != n_tilts:
        raise ValueError(
            f"need one dataset + scan set per tilt: {len(datasets)} "
            f"datasets / {len(scan_positions)} scans / {n_tilts} tilts")
    pos0 = np.asarray(positions0, np.float64)
    p0 = probe.array
    if p0.dim() != 2:
        raise ValueError("probe must be a single (nx, ny) Probe")
    ctr = (pos0.mean(axis=0) if center is None
           else np.asarray(center, np.float64))

    as_dev = lambda a: torch.as_tensor(np.asarray(a).astype(rd), device=dev)
    rots, plans, amps_t, scans_t, batches_t = [], [], [], [], []
    for t, ang in enumerate(tilt_angles_deg):
        r_mat = rotation_about_x(np.deg2rad(float(ang)))
        rots.append(as_dev(r_mat.T))                 # row-vector form
        rot0 = (pos0 - ctr) @ r_mat.T + ctr
        plans.append(make_plan(probe.xs, probe.ys, zs, rot0[None],
                               np.asarray(types, np.int32),
                               pad_fraction=pad_fraction))
        data = np.asarray(datasets[t])
        scan = np.asarray(scan_positions[t], np.float64)
        if scan.shape[0] != data.shape[0]:
            raise ValueError(f"tilt {t}: {data.shape[0]} patterns but "
                             f"{scan.shape[0]} scan positions")
        amps_t.append(_amplitudes_on(data, prec.real, dev))
        scans_t.append(as_dev(scan))
        nb = data.shape[0] if batch is None else int(min(batch,
                                                         data.shape[0]))
        n_steps_t = (steps + n_tilts - 1 - t) // n_tilts
        batches_t.append(_epoch_batches(data.shape[0], nb,
                                        max(n_steps_t, 1), seed + t))

    dz = float(zs[1] - zs[0]) if len(np.asarray(zs)) > 1 else 1.0
    eV = float(probe.eV)
    ctr_t = as_dev(ctr)
    kx, ky = as_dev(probe.kxs), as_dev(probe.kys)
    params = {"pos": as_dev(pos0)}
    adams = {"pos": _Adam(lr)}
    losses = []
    counters = [0] * n_tilts
    for s in range(steps):
        t = s % n_tilts
        idx = torch.as_tensor(batches_t[t][counters[t]], device=dev).long()
        counters[t] += 1

        def loss_fn(pos):
            v = rasterize((pos - ctr_t) @ rots[t] + ctr_t, plans[t], prec)
            return _amplitude_misfit(_shifted(p0, kx, ky, scans_t[t][idx]),
                                     v, amps_t[t][idx], kx, ky, eV=eV,
                                     dz=dz, prec=prec)

        losses.append(_step(params, adams, loss_fn))
    pos = params["pos"].cpu().numpy().astype(np.float64)
    disp = np.linalg.norm(pos - pos0, axis=1)
    return dict(positions=pos, displacement=disp,
                losses=np.asarray([float(l) for l in losses], rd))
