"""Multislice electron ptychography from 4D-STEM data.

Counterpart of ``pyslice_tpu/analysis/ptychography.py``, for now its
gradient solver ``msp_reconstruct`` and the helpers the structure
refinements of ``engine.inverse`` share with it. The forward model of a
minibatch is the production multislice through the O(1)-memory adjoint
(``physics.adjoint.multislice_diff``): on the card the forward runs the
slice-step kernels and the backward the adjoint chain (A, B, K7 on
power-of-two grids; K4, K5, K8 on mixed-radix grids). The JAX package's
solve is one compiled ``lax.scan``; here the steps run as an eager loop.

Conventions: detector axes arrive fftshifted (the WFData layout); the
solver runs in natural FFT order. Probe shifts are exact k-space phase
ramps exp(2 pi i k . pos) (quirk 14, as ``physics.probe.shift_probes``).

Not ported yet: ``scan_grid_data``, ``ssb_reconstruct``,
``icom_reconstruct`` and ``epie_reconstruct``; ``msp_reconstruct(mesh=)``
(ROADMAP queue 1, item 11).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..core.dtypes import DOUBLE, SINGLE
from ..physics.adjoint import multislice_diff


def _precision_of(rdtype: torch.dtype):
    """Precision policy matching a real dtype (f64 -> DOUBLE else SINGLE)."""
    return DOUBLE if rdtype == torch.float64 else SINGLE


def _detector_amplitudes(data4d) -> np.ndarray:
    """(N, nkx, nky) fftshifted intensities -> natural-order amplitudes."""
    return np.sqrt(np.maximum(
        np.fft.ifftshift(np.asarray(data4d), axes=(-2, -1)), 0.0))


def _epoch_batches(npos: int, nb: int, steps: int, seed: int) -> np.ndarray:
    """(steps, nb) minibatch indices: shuffled epochs, every position
    visited once per ceil(npos/nb) steps (NumPy's generator, so the
    batches are the JAX package's)."""
    rng = np.random.default_rng(seed)
    batches = np.empty((steps, nb), np.int32)
    perm, used = rng.permutation(npos), 0
    for s in range(steps):
        if used + nb > npos:
            perm, used = rng.permutation(npos), 0
        batches[s] = perm[used:used + nb]
        used += nb
    return batches


def _shift_ramps(kx, ky, pos_b) -> torch.Tensor:
    """exp(2 pi i k.pos) k-space shift ramps, (nb, nx, ny), the sign of
    ``physics.probe.shift_probes``."""
    ph = (2.0 * np.pi) * (kx[:, None] * pos_b[:, 0, None, None]
                          + ky[None, :] * pos_b[:, 1, None, None])
    return torch.complex(torch.cos(ph), torch.sin(ph))


def _probe_center(probe) -> Tuple[float, float]:
    """Real-space peak of the unshifted base probe: probe_array's
    ifftshift puts it at index (n + 1) // 2."""
    nx, ny = len(probe.xs), len(probe.ys)
    return (float(probe.xs[(nx + 1) // 2]), float(probe.ys[(ny + 1) // 2]))


def _adam(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
    """``optax.adam(lr)`` for one tensor: returns ``step(param, grad)``,
    which gives the updated parameter. As optax, the second moment of a
    complex gradient is |g|^2, one value an element (``torch.optim.Adam``
    keeps one for each of the real and imaginary parts), the bias
    corrections divide the moments, and the update is
    -lr * mu_hat / (sqrt(nu_hat) + eps). For a complex parameter, pass
    PyTorch's ``grad`` as it is: it is the conjugate of JAX's, which is
    what the JAX package feeds optax."""
    mu = nu = None
    count = 0

    def step(param: torch.Tensor, grad: torch.Tensor) -> torch.Tensor:
        nonlocal mu, nu, count
        if mu is None:
            mu = torch.zeros_like(grad)
            nu = torch.zeros_like(grad.real)
        count += 1
        mu = (1 - b1) * grad + b1 * mu
        g2 = (grad.conj() * grad).real if grad.is_complex() else grad ** 2
        nu = (1 - b2) * g2 + b2 * nu
        mu_hat = mu / (1 - b1 ** count)
        nu_hat = nu / (1 - b2 ** count)
        return param + (-lr) * (mu_hat / (torch.sqrt(nu_hat) + eps))

    return step


def _msp_loss(v, modes, pos_b, a_b, kx, ky, *, eV: float, dz: float, prec,
              loss: str, reg_tv: float) -> torch.Tensor:
    """One minibatch's data misfit (plus the TV prior): the probe modes
    shifted to ``pos_b``, through ``multislice_diff``, to detector
    intensities; mutually incoherent modes add on the detector."""
    ramp = _shift_ramps(kx, ky, pos_b)
    psi_b = torch.fft.ifft2(torch.fft.fft2(modes)[None] * ramp[:, None])
    nb, k_modes = psi_b.shape[:2]
    exit_b = multislice_diff(psi_b.reshape(nb * k_modes, *psi_b.shape[2:]),
                             v, kx, ky, eV=eV, dz=dz, precision=prec)
    inten = torch.abs(torch.fft.fft2(exit_b)) ** 2
    inten = inten.reshape(nb, k_modes, *inten.shape[1:]).sum(dim=1)
    if loss == "poisson":
        # Poisson NLL up to the model-free log I! term, with the log floor
        # on the count scale.
        i_meas = a_b ** 2
        floor = 1e-3 * torch.mean(i_meas)
        fit = torch.mean(inten - i_meas * torch.log(inten + floor))
    else:
        mag = torch.sqrt(inten + 1e-24)
        fit = torch.mean((mag - a_b) ** 2)
    if reg_tv > 0.0:
        # isotropic smoothed total variation over each slice of V
        dvx = torch.diff(v, dim=-2)
        dvy = torch.diff(v, dim=-1)
        tv = torch.mean(torch.sqrt(dvx[..., :, :-1] ** 2
                                   + dvy[..., :-1, :] ** 2 + 1e-12))
        fit = fit + reg_tv * tv
    return fit


class _MspRun:
    """The state of one ``msp_reconstruct`` solve: the parameters (V, the
    probe modes, the scan positions), their Adam steps, and the data on
    the device. ``step(idx)`` takes one Adam step on minibatch ``idx``."""

    def __init__(self, amps, positions, v0, modes0, kx, ky, *, lr_v,
                 lr_probe, lr_pos, eV, dz, update_probe, update_positions,
                 loss, reg_tv):
        self.amps, self.kx, self.ky = amps, kx, ky
        self.v, self.modes, self.pos = v0, modes0, positions
        self.prec = _precision_of(v0.dtype)
        self.kw = dict(eV=eV, dz=dz, prec=self.prec, loss=loss,
                       reg_tv=reg_tv)
        self.adam = {"v": _adam(lr_v)}
        if update_probe:
            self.adam["modes"] = _adam(lr_probe)
        if update_positions:
            self.adam["pos"] = _adam(lr_pos)

    def step(self, idx) -> torch.Tensor:
        """One Adam step on the parameters being refined; returns the
        minibatch loss."""
        params = {k: getattr(self, k).detach().requires_grad_()
                  for k in self.adam}
        get = lambda k: params.get(k, getattr(self, k))
        idx = torch.as_tensor(idx, device=self.amps.device).long()
        val = _msp_loss(get("v"), get("modes"), get("pos")[idx],
                        self.amps[idx], self.kx, self.ky, **self.kw)
        grads = torch.autograd.grad(val, list(params.values()))
        with torch.no_grad():
            for k, g in zip(params, grads):
                setattr(self, k, self.adam[k](getattr(self, k), g))
        return val.detach()


def msp_reconstruct(data4d, probe_positions, probe, n_slices: int,
                    dz: float, steps: int = 300, batch: Optional[int] = None,
                    lr: float = 30.0, lr_probe: float = 2e-3,
                    lr_pos: float = 0.01, update_probe: bool = False,
                    update_positions: bool = False, v_init=None,
                    seed: int = 0, mesh=None, n_modes: int = 1,
                    probe_modes=None, loss: str = "amplitude",
                    reg_tv: float = 0.0) -> dict:
    """Multislice electron ptychography: recover a depth-resolved potential
    (and optionally the probe and the scan positions) from intensity-only
    4D-STEM data by Adam descent through the multislice adjoint.

    Arguments and results as the JAX package's ``msp_reconstruct``:
    data4d (npos, nkx, nky) fftshifted intensities; probe_positions
    (npos, 2) Angstrom; probe the illumination ``Probe`` (initial guess,
    grid, energy; its device is the run's); n_slices x dz the specimen;
    steps/batch/lr/lr_probe/lr_pos/seed the Adam schedule over shuffled
    minibatches; update_probe / update_positions what else is refined;
    v_init the initial (n_slices, nx, ny) potential (default 0); n_modes /
    probe_modes a mixed-state probe of mutually incoherent modes; loss
    "amplitude" (detector-amplitude MSE) or "poisson" (counts); reg_tv a
    total-variation prior weight. ``mesh`` (data parallelism over several
    cards) is not ported yet.

    Returns dict with ``potential`` (n_slices, nx, ny), ``probe`` (nx, ny,
    the dominant mode), ``probe_modes`` (K, nx, ny), ``positions``
    (npos, 2) and ``losses`` (steps,), as NumPy arrays.
    """
    if mesh is not None:
        raise NotImplementedError(
            "msp_reconstruct(mesh=) (data parallelism over several cards) is "
            "not ported yet (ROADMAP queue 1, item 11: Multi-GPU)")
    prec = probe.precision
    dev = probe.device
    data = np.asarray(data4d)
    npos = data.shape[0]
    positions = np.asarray(probe_positions, np.float64)
    if positions.shape[0] != npos:
        raise ValueError(
            f"data4d has {npos} patterns but probe_positions has "
            f"{positions.shape[0]} entries")
    if n_slices < 1:
        raise ValueError(f"n_slices must be >= 1, got {n_slices}")
    if loss not in ("amplitude", "poisson"):
        raise ValueError(f"loss must be 'amplitude' or 'poisson', "
                         f"got {loss!r}")
    p0 = probe.array
    if p0.dim() != 2:
        raise ValueError("probe must be a single (nx, ny) Probe, "
                         "not a batch")
    rd = prec.np_real
    if probe_modes is not None:
        modes0 = torch.as_tensor(np.asarray(probe_modes),
                                 device=dev).to(prec.complex)
        if modes0.dim() != 3 or tuple(modes0.shape[1:]) != tuple(p0.shape):
            raise ValueError(
                f"probe_modes must be (K, {p0.shape[0]}, {p0.shape[1]})")
    elif n_modes > 1:
        # mode 0 = the probe; mode j = the probe times a centred x/y
        # gradient envelope at 10% amplitude
        xs_c = np.asarray(probe.xs) - np.mean(probe.xs)
        ys_c = np.asarray(probe.ys) - np.mean(probe.ys)
        envs = []
        for j in range(1, n_modes):
            axis = (xs_c[:, None] if j % 2 else ys_c[None, :])
            axis = axis / (np.abs(axis).max() + 1e-30)
            env = 0.1 * axis ** ((j + 1) // 2) * np.ones(tuple(p0.shape))
            envs.append(torch.as_tensor(env.astype(rd), device=dev))
        modes0 = torch.cat([p0[None]] + [p0[None] * e for e in envs], dim=0)
    else:
        modes0 = p0[None]
    amps = _detector_amplitudes(data)

    nb = npos if batch is None else int(min(batch, npos))
    batches = _epoch_batches(npos, nb, steps, seed)
    if v_init is None:
        v0 = torch.zeros((n_slices,) + tuple(p0.shape), dtype=prec.real,
                         device=dev)
    else:
        v0 = torch.as_tensor(np.asarray(v_init).astype(rd), device=dev)
        if tuple(v0.shape) != (n_slices,) + tuple(p0.shape):
            raise ValueError(f"v_init shape {tuple(v0.shape)} != "
                             f"{(n_slices,) + tuple(p0.shape)}")

    as_dev = lambda a: torch.as_tensor(np.asarray(a).astype(rd), device=dev)
    run = _MspRun(as_dev(amps), as_dev(positions), v0, modes0,
                  as_dev(probe.kxs), as_dev(probe.kys), lr_v=float(lr),
                  lr_probe=float(lr_probe), lr_pos=float(lr_pos),
                  eV=float(probe.eV), dz=float(dz),
                  update_probe=bool(update_probe),
                  update_positions=bool(update_positions), loss=str(loss),
                  reg_tv=float(reg_tv))
    losses = [run.step(idx) for idx in batches]
    pr = run.modes.cpu().numpy()
    return dict(potential=run.v.cpu().numpy(), probe=pr[0], probe_modes=pr,
                positions=run.pos.cpu().numpy(),
                losses=np.asarray([float(l) for l in losses], rd))
