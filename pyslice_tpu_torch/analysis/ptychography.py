"""Ptychographic phase reconstruction from 4D-STEM data.

Counterpart of ``pyslice_tpu/analysis/ptychography.py``. The (probes, kx,
ky) exit-wave intensities the pipeline produces are a 4D-STEM dataset, and
these routines invert them for the specimen:

* ``scan_grid_data`` — WFData -> (scan_xs, scan_ys, I(sx, sy, kx, ky)),
  the frame-averaged CBED stack on the rectangular scan grid;
* ``ssb_reconstruct`` — single-sideband ptychography (Rodenburg & Bates
  1992; Pennycook et al., Ultramicroscopy 151 (2015) 160): the direct
  weak-phase reconstruction from the trotter overlaps of
  G(Q, kf) = FFT_scan[I];
* ``icom_reconstruct`` — integrated centre of mass (Lazic et al.,
  Ultramicroscopy 160 (2016) 265): Fourier integration of the first-moment
  deflection field;
* ``epie_reconstruct`` — ePIE (Maiden & Rodenburg, Ultramicroscopy 109
  (2009) 1256): iterative object (and optionally probe) retrieval;
* ``msp_reconstruct`` — multislice ptychography by Adam descent through
  the O(1)-memory adjoint (``physics.adjoint.multislice_diff``): on the
  card the forward runs the slice-step kernels and the backward the
  adjoint chain (A, B, K7 on power-of-two grids; K4, K5, K8 on mixed-radix
  grids). The JAX package's solve is one compiled ``lax.scan``; here the
  steps run as an eager loop, and so do ePIE's positions.

SSB, iCoM and ePIE use no Pallas kernel in the JAX package (XLA FFTs), so
they run on ``torch.fft``. A tensor input runs on its own device, an array
on ``device`` (the card unless ``device="cpu"``); ePIE and
``msp_reconstruct`` run on the probe's device.

Conventions: detector axes arrive fftshifted (the WFData layout); the
solvers run in natural FFT order. Probe shifts are exact k-space phase
ramps exp(2 pi i k . pos) (quirk 14, as ``physics.probe.shift_probes``),
so the probe listed at R sits physically at c - R (c the base probe's
centre). ``scan_grid_data`` takes a WFData sharded over a (frame, probe)
mesh as it takes any other, and ``msp_reconstruct(mesh=)``
splits every minibatch over the mesh's ranks (data parallelism; one
all_reduce of the loss and the gradients a step). ``msp_reconstruct``
takes its data as a host array or as a tensor; a tensor is converted to
amplitudes on the probe's device, a chunk of patterns at a time, so that
a scan too large for a second copy stays where it is.

Tracing (``utils.profiling.span``): ``msp.setup`` (the data's ingest and
the solve's state), ``msp.step`` (one Adam step), inside it
``msp.forward`` (the shift through the misfit), ``msp.backward`` (the
gradients; the adjoint's own span, ``adjoint``, lies inside it on
autograd's thread) and ``msp.update``. ``STATS`` counts the steps, the
patterns and the waves (patterns x probe modes) the steps fitted, in this
process.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..core.dtypes import DOUBLE, SINGLE
from ..physics.adjoint import multislice_diff
from ..parallel import sharded
from ..utils.profiling import span
from .detectors import _scan_grid, frame_mean_intensity

# msp_reconstruct's work in this process: Adam steps, and the patterns
# and waves (patterns x probe modes) their minibatches put through the
# multislice (a rank's share on a mesh)
STATS = {"msp_steps": 0, "msp_patterns": 0, "msp_waves": 0}

# patterns a chunk when a tensor's intensities become amplitudes
INGEST_CHUNK = 64


def scan_grid_data(wf_data, layer_index: int = -1):
    """Arrange a WFData as a 4D-STEM dataset on its rectangular scan grid.

    Returns ``(scan_xs, scan_ys, data4d)`` with ``data4d`` of shape
    (n_sx, n_sy, nkx, nky), a host array: the frame-averaged detector
    intensity a scan point (the nearest probe to each point of the
    unique-x by unique-y grid, as ``HAADFData.calculateADF``). A WFData on
    the card reduces there; a sharded one reduces each rank's block, then
    sums it over the mesh (``detectors.frame_mean_intensity``; every rank
    of its mesh calls this).
    """
    inten = frame_mean_intensity(wf_data.wavefunction_data, layer_index)
    xs, ys, nearest = _scan_grid(wf_data.probe_positions)
    data4d = inten[torch.as_tensor(nearest, device=inten.device)]
    return xs, ys, data4d.reshape(len(xs), len(ys), *inten.shape[-2:]) \
        .cpu().numpy()


def _precision_of(rdtype: torch.dtype):
    """Precision policy matching a real dtype (f64 -> DOUBLE else SINGLE)."""
    return DOUBLE if rdtype == torch.float64 else SINGLE


def _detector_amplitudes(data4d) -> np.ndarray:
    """(N, nkx, nky) fftshifted intensities -> natural-order amplitudes."""
    return np.sqrt(np.maximum(
        np.fft.ifftshift(np.asarray(data4d), axes=(-2, -1)), 0.0))


def _amplitudes_on(data, real: torch.dtype, device,
                   chunk: int = INGEST_CHUNK) -> torch.Tensor:
    """``_detector_amplitudes`` of ``data`` (an array or a tensor) on
    ``device`` as ``real``, ``chunk`` patterns at a time, so that neither
    the host nor the device makes a second copy of the whole scan. A
    chunk that lives on the host takes ``_detector_amplitudes`` (NumPy,
    the JAX package's bits: PyTorch's vectorised CPU square root is not
    correctly rounded), a chunk on a card ``_amplitudes_torch`` there."""
    if not isinstance(data, torch.Tensor):
        data = np.asarray(data)
    out = torch.empty(tuple(data.shape), dtype=real, device=device)
    for i in range(0, data.shape[0], chunk):
        blk = data[i:i + chunk]
        if isinstance(blk, torch.Tensor) and blk.device.type != "cpu":
            amp = _amplitudes_torch(blk)
        else:
            amp = torch.from_numpy(_detector_amplitudes(
                blk.detach().numpy() if isinstance(blk, torch.Tensor)
                else blk))
        out[i:i + chunk] = amp.to(device=device, dtype=real)
    return out


def _amplitudes_torch(blk: torch.Tensor) -> torch.Tensor:
    """``_detector_amplitudes`` in PyTorch on the tensor's device, in the
    host path's types (an integer count becomes float64, as NumPy
    promotes it; NumPy's ``maximum(x, 0)`` is ``where(x <= 0, 0, x)``,
    which makes -0 into +0 and keeps a NaN)."""
    if not blk.is_floating_point():
        blk = blk.to(torch.float64)
    blk = torch.fft.ifftshift(blk, dim=(-2, -1))
    return torch.sqrt(torch.where(
        blk <= 0, torch.zeros((), dtype=blk.dtype, device=blk.device), blk))


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


class _Adam:
    """``optax.adam(lr)`` for one tensor: ``adam(param, grad)`` gives the
    updated parameter. As optax, the second moment of a complex gradient
    is |g|^2, one value an element (``torch.optim.Adam`` keeps one for
    each of the real and imaginary parts), the bias corrections divide the
    moments, and the update is -lr * mu_hat / (sqrt(nu_hat) + eps). For a
    complex parameter, pass PyTorch's ``grad`` as it is: it is the
    conjugate of JAX's, which is what the JAX package feeds optax. The
    moments ``mu``, ``nu`` (None before the first step) and the step
    ``count`` are attributes, so one step can be recomputed from the
    state before it."""

    def __init__(self, lr: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.mu = self.nu = None
        self.count = 0

    def __call__(self, param: torch.Tensor,
                 grad: torch.Tensor) -> torch.Tensor:
        b1, b2 = self.b1, self.b2
        if self.mu is None:
            self.mu = torch.zeros_like(grad)
            self.nu = torch.zeros_like(grad.real)
        self.count += 1
        self.mu = (1 - b1) * grad + b1 * self.mu
        g2 = (grad.conj() * grad).real if grad.is_complex() else grad ** 2
        self.nu = (1 - b2) * g2 + b2 * self.nu
        mu_hat = self.mu / (1 - b1 ** self.count)
        nu_hat = self.nu / (1 - b2 ** self.count)
        return param + (-self.lr) * (mu_hat / (torch.sqrt(nu_hat)
                                               + self.eps))


def _msp_loss(v, modes, pos_b, a_b, kx, ky, *, eV: float, dz: float, prec,
              loss: str, reg_tv: float) -> torch.Tensor:
    """One minibatch's data misfit (plus the TV prior): the probe modes
    shifted to ``pos_b``, through ``multislice_diff``, to detector
    intensities; mutually incoherent modes add on the detector."""
    with span("msp.forward"):
        ramp = _shift_ramps(kx, ky, pos_b)
        psi_b = torch.fft.ifft2(torch.fft.fft2(modes)[None] * ramp[:, None])
        nb, k_modes = psi_b.shape[:2]
        exit_b = multislice_diff(
            psi_b.reshape(nb * k_modes, *psi_b.shape[2:]), v, kx, ky, eV=eV,
            dz=dz, precision=prec)
        inten = torch.abs(torch.fft.fft2(exit_b)) ** 2
        inten = inten.reshape(nb, k_modes, *inten.shape[1:]).sum(dim=1)
        if loss == "poisson":
            # Poisson NLL up to the model-free log I! term, with the log
            # floor on the count scale.
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


def _rank_share(idx, mesh) -> np.ndarray:
    """This rank's block of minibatch ``idx`` (all of it off a mesh), in
    the mesh's row-major order, as JAX shards over all mesh devices."""
    idx = np.asarray(idx)
    if mesh is None:
        return idx
    from ..parallel.mesh import flat_index
    n_loc = len(idx) // mesh.size()
    r = flat_index(mesh)
    return idx[r * n_loc:(r + 1) * n_loc]


class _MspRun:
    """The state of one ``msp_reconstruct`` solve: the parameters (V, the
    probe modes, the scan positions), their Adam steps, and the data on
    the device. ``step(idx)`` takes one Adam step on minibatch ``idx``.

    With a ``mesh`` each rank takes its block of every minibatch (in the
    mesh's row-major order, as JAX shards over all mesh devices); the
    loss and the gradients are averaged over the ranks with one
    all_reduce each, so the parameters and the Adam state stay the same on
    every rank (equal local batches make the mean of local-mean gradients
    the global-mean gradient)."""

    def __init__(self, amps, positions, v0, modes0, kx, ky, *, lr_v,
                 lr_probe, lr_pos, eV, dz, update_probe, update_positions,
                 loss, reg_tv, mesh=None):
        self.amps, self.kx, self.ky = amps, kx, ky
        self.v, self.modes, self.pos = v0, modes0, positions
        self.prec = _precision_of(v0.dtype)
        self.kw = dict(eV=eV, dz=dz, prec=self.prec, loss=loss,
                       reg_tv=reg_tv)
        self.mesh = mesh
        self.adam = {"v": _Adam(lr_v)}
        if update_probe:
            self.adam["modes"] = _Adam(lr_probe)
        if update_positions:
            self.adam["pos"] = _Adam(lr_pos)

    def grads(self, idx, reduce: bool = True):
        """(loss, {name: gradient}) of minibatch ``idx`` for the parameters
        being refined, averaged over the mesh's ranks (``reduce=False``:
        this rank's own, of its block of ``idx``)."""
        params = {k: getattr(self, k).detach().requires_grad_()
                  for k in self.adam}
        get = lambda k: params.get(k, getattr(self, k))
        idx = _rank_share(idx, self.mesh)
        STATS["msp_patterns"] += len(idx)
        STATS["msp_waves"] += len(idx) * self.modes.shape[0]
        idx = torch.as_tensor(idx, device=self.amps.device).long()
        val = _msp_loss(get("v"), get("modes"), get("pos")[idx],
                        self.amps[idx], self.kx, self.ky, **self.kw)
        with span("msp.backward"):
            grads = dict(zip(params, torch.autograd.grad(
                val, list(params.values()))))
        val = val.detach()
        if self.mesh is not None and reduce:
            from ..parallel.mesh import world_group
            w = self.mesh.size()
            group = world_group(self.mesh)
            val = sharded.all_reduce(val.clone(), group) / w
            grads = {k: sharded.all_reduce(g, group) / w
                     for k, g in grads.items()}
        return val, grads

    def step(self, idx) -> torch.Tensor:
        """One Adam step on the parameters being refined; returns the
        minibatch loss."""
        with span("msp.step"):
            val, grads = self.grads(idx)
            with span("msp.update"), torch.no_grad():
                for k, g in grads.items():
                    setattr(self, k, self.adam[k](getattr(self, k), g))
        STATS["msp_steps"] += 1
        return val


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
    data4d (npos, nkx, nky) fftshifted intensities, an array or a tensor
    (a tensor is made into amplitudes on the probe's device, chunk by
    chunk, with no host copy); probe_positions
    (npos, 2) Angstrom; probe the illumination ``Probe`` (initial guess,
    grid, energy; its device is the run's); n_slices x dz the specimen;
    steps/batch/lr/lr_probe/lr_pos/seed the Adam schedule over shuffled
    minibatches; update_probe / update_positions what else is refined;
    v_init the initial (n_slices, nx, ny) potential (default 0); n_modes /
    probe_modes a mixed-state probe of mutually incoherent modes; loss
    "amplitude" (detector-amplitude MSE) or "poisson" (counts); reg_tv a
    total-variation prior weight. ``mesh``: a ('frame', 'probe')
    DeviceMesh spanning the job; every minibatch is split over all its
    ranks (each rank calls this with the same arguments), and the
    minibatch size must divide by the rank count.

    Returns dict with ``potential`` (n_slices, nx, ny), ``probe`` (nx, ny,
    the dominant mode), ``probe_modes`` (K, nx, ny), ``positions``
    (npos, 2) and ``losses`` (steps,), as NumPy arrays.
    """
    run, batches = _msp_setup(
        data4d, probe_positions, probe, n_slices, dz, steps=steps,
        batch=batch, lr=lr, lr_probe=lr_probe, lr_pos=lr_pos,
        update_probe=update_probe, update_positions=update_positions,
        v_init=v_init, seed=seed, mesh=mesh, n_modes=n_modes,
        probe_modes=probe_modes, loss=loss, reg_tv=reg_tv)
    rd = probe.precision.np_real
    losses = [run.step(idx) for idx in batches]
    pr = run.modes.cpu().numpy()
    return dict(potential=run.v.cpu().numpy(), probe=pr[0], probe_modes=pr,
                positions=run.pos.cpu().numpy(),
                losses=np.asarray([float(l) for l in losses], rd))


def _msp_setup(data4d, probe_positions, probe, n_slices: int, dz: float,
               steps: int = 300, batch: Optional[int] = None,
               lr: float = 30.0, lr_probe: float = 2e-3, lr_pos: float = 0.01,
               update_probe: bool = False, update_positions: bool = False,
               v_init=None, seed: int = 0, mesh=None, n_modes: int = 1,
               probe_modes=None, loss: str = "amplitude",
               reg_tv: float = 0.0):
    """The checked inputs of ``msp_reconstruct`` as an ``_MspRun`` and its
    (steps, batch) minibatch indices. ``data4d``, an array or a tensor,
    becomes amplitudes on the probe's device a chunk at a time
    (``_amplitudes_on``); the host makes no copy of a tensor."""
    with span("msp.setup"):
        prec = probe.precision
        dev = probe.device
        data = data4d if isinstance(data4d, torch.Tensor) else \
            np.asarray(data4d)
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
            modes0 = torch.cat([p0[None]] + [p0[None] * e for e in envs],
                               dim=0)
        else:
            modes0 = p0[None]
        as_dev = lambda a: torch.as_tensor(np.asarray(a).astype(rd),
                                           device=dev)
        amps = _amplitudes_on(data, prec.real, dev)

        nb = npos if batch is None else int(min(batch, npos))
        if mesh is not None and nb % mesh.size() != 0:
            raise ValueError(
                f"minibatch size {nb} must divide by the mesh's "
                f"{mesh.size()} devices (pass batch=...)")
        batches = _epoch_batches(npos, nb, steps, seed)
        if v_init is None:
            v0 = torch.zeros((n_slices,) + tuple(p0.shape), dtype=prec.real,
                             device=dev)
        else:
            v0 = torch.as_tensor(np.asarray(v_init).astype(rd), device=dev)
            if tuple(v0.shape) != (n_slices,) + tuple(p0.shape):
                raise ValueError(f"v_init shape {tuple(v0.shape)} != "
                                 f"{(n_slices,) + tuple(p0.shape)}")

        run = _MspRun(amps, as_dev(positions), v0, modes0,
                      as_dev(probe.kxs), as_dev(probe.kys), lr_v=float(lr),
                      lr_probe=float(lr_probe), lr_pos=float(lr_pos),
                      eV=float(probe.eV), dz=float(dz),
                      update_probe=bool(update_probe),
                      update_positions=bool(update_positions), loss=str(loss),
                      reg_tv=float(reg_tv), mesh=mesh)
        return run, batches


def _uniform_step(axis, name: str) -> float:
    axis = np.asarray(axis, dtype=np.float64)
    if len(axis) < 2:
        raise ValueError(f"{name} needs >= 2 scan points")
    steps = np.diff(axis)
    if not np.allclose(steps, steps[0], rtol=1e-6, atol=1e-9):
        raise ValueError(f"{name} must be uniformly spaced for the scan FFT")
    return float(steps[0])


def _real_data(data, device) -> torch.Tensor:
    """A real 4D-STEM stack as a float tensor (float64 stays float64,
    anything else becomes float32); a tensor stays on its own device."""
    t = data if isinstance(data, torch.Tensor) else \
        torch.as_tensor(np.asarray(data), device=device)
    return t.to(torch.float64 if t.dtype == torch.float64 else torch.float32)


def _ssb_trotters(g_chunk, q_chunk, kx2d, ky2d, kmax: float):
    """Single-sideband trotter sums for a chunk of scan frequencies.

    g_chunk: (c, nkx, nky) complex G(Q, kf); q_chunk: (c, 2) scan
    frequencies (1/A). Returns ((c,) complex means over the double-overlap
    region A(kf) & A(kf + Q) & ~A(kf - Q), (c,) pixel counts).

    Under this package's scan convention (the probe listed at R sits at
    c - R) the scan FFT reverses the position axis, so the weak-phase
    expansion of |FT psi_exit|^2 puts the conjugated object spectrum on
    the A(kf + Q) sideband: G(Q, kf) = i conj(Phi)(Q) e^{-2 pi i Q.c}
    N_scan there. The caller removes the probe-centre phase.
    """
    k2 = kmax * kmax
    qx = q_chunk[:, 0, None, None]
    qy = q_chunk[:, 1, None, None]
    a0 = (kx2d ** 2 + ky2d ** 2) <= k2
    am = ((kx2d - qx) ** 2 + (ky2d - qy) ** 2) <= k2
    ap = ((kx2d + qx) ** 2 + (ky2d + qy) ** 2) <= k2
    band = a0 & ap & ~am
    cnt = band.sum(dim=(-2, -1))
    val = torch.where(band, g_chunk, torch.zeros((), dtype=g_chunk.dtype,
                                                 device=g_chunk.device)) \
        .sum(dim=(-2, -1))
    return val / cnt.clamp(min=1).to(kx2d.dtype), cnt


def ssb_reconstruct(data4d, scan_xs, scan_ys, kxs, kys,
                    mrad: Optional[float] = None,
                    eV: Optional[float] = None, probe=None,
                    probe_center: Optional[Tuple[float, float]] = None,
                    q_chunk: int = 1024, device="cuda") -> dict:
    """Single-sideband ptychography: direct weak-phase reconstruction.

    Args:
        data4d: (n_sx, n_sy, nkx, nky) detector intensities on the scan
            grid (``scan_grid_data`` output; detector axes fftshifted), a
            tensor (it runs on its own device) or an array (on
            ``device``).
        scan_xs/scan_ys: uniform scan-point coordinates (Angstrom).
        kxs/kys: detector axes, 1/Angstrom, fftshifted monotonic.
        mrad/eV: probe aperture semi-angle and beam energy (the trotter
            geometry is the aperture's); default from ``probe``.
        probe: optional ``Probe``, supplies mrad/eV/probe_center.
        probe_center: real-space centre (Angstrom) of the unshifted base
            probe; its e^{-2 pi i Q.c} phase is removed, or the
            reconstruction is circularly translated by c. Default: from
            ``probe``, else (0, 0).
        q_chunk: scan-frequency bins a batch of trotter sums, which bounds
            the (q_chunk, nkx, nky) band masks.

    The scan FFT runs on the device in the data's precision (float64 data
    in complex128, else complex64); the trotter sums in the same
    precision, with the scan frequencies rounded to float32 as the JAX
    package rounds them.

    Returns dict with ``phase`` (n_sx, n_sy float64, the object phase at
    the scan coordinates, in radians within the weak-phase approximation,
    mean-free), ``qxs``/``qys`` (scan-frequency axes) and
    ``trotter_pixels`` (n_sx, n_sy int; 0 marks frequencies outside the
    double-overlap band |Q| in (0, 2 k_ap)). The scan Nyquist 1/(2*step)
    should exceed 2 k_ap or the band is clipped.
    """
    from ..core.constants import wavelength
    if probe is not None:
        mrad = probe.mrad if mrad is None else mrad
        eV = probe.eV if eV is None else eV
        if probe_center is None:
            probe_center = _probe_center(probe)
    if mrad is None or eV is None:
        raise ValueError("pass mrad and eV (or a probe)")
    if probe_center is None:
        probe_center = (0.0, 0.0)
    data = _real_data(data4d, device)
    n_sx, n_sy = data.shape[:2]
    dx = _uniform_step(scan_xs, "scan_xs")
    dy = _uniform_step(scan_ys, "scan_ys")
    qxs = np.fft.fftfreq(n_sx, d=dx)
    qys = np.fft.fftfreq(n_sy, d=dy)
    kmax = (mrad * 1e-3) / wavelength(eV)
    # G(Q, kf): the FFT over the scan axes only
    g = torch.fft.fft2(data, dim=(0, 1)).reshape(n_sx * n_sy,
                                                 *data.shape[2:])
    qgrid = np.stack(np.meshgrid(qxs, qys, indexing="ij"),
                     axis=-1).reshape(-1, 2)
    rdt, dev = data.dtype, data.device
    kx2d = torch.as_tensor(np.asarray(kxs, np.float64)[:, None],
                           device=dev).to(rdt)
    ky2d = torch.as_tensor(np.asarray(kys, np.float64)[None, :],
                           device=dev).to(rdt)
    q_all = torch.as_tensor(qgrid.astype(np.float32), device=dev).to(rdt)
    vals, cnts = [], []
    for i in range(0, len(qgrid), q_chunk):
        v, c = _ssb_trotters(g[i:i + q_chunk], q_all[i:i + q_chunk],
                             kx2d, ky2d, float(kmax))
        vals.append(v)
        cnts.append(c)
    vals = torch.cat(vals).cpu().numpy().astype(np.complex128)
    cnts = torch.cat(cnts).cpu().numpy().astype(np.int64)
    # est(Q) = i conj(Phi)(Q) e^{-2 pi i Q.c}
    #   =>  Phi(Q) = conj(est / i) e^{-2 pi i Q.c}
    qdotc = (qgrid[:, 0] * probe_center[0]
             + qgrid[:, 1] * probe_center[1])
    phi_q = (np.conj(vals / 1j)
             * np.exp(-2j * np.pi * qdotc)).reshape(n_sx, n_sy)
    phase = np.real(np.fft.ifft2(phi_q))
    return dict(phase=phase, qxs=qxs, qys=qys,
                trotter_pixels=cnts.reshape(n_sx, n_sy))


def icom_reconstruct(data4d, scan_xs, scan_ys, kxs, kys, probe=None,
                     probe_center: Optional[Tuple[float, float]] = None,
                     com=None, device="cuda") -> dict:
    """Integrated centre of mass (iCoM / iDPC) phase reconstruction.

    For a weak phase object the diffraction pattern's first moment is the
    probe-intensity-blurred phase gradient at the physical probe position
    (the CoM theorem). Under this package's scan convention (listed R ->
    physical c - R) the measured field is M(R) = (1/2pi)(grad
    phi_blur)(c - R); Fourier integration recovers h(R) = phi_blur(c - R),
    and a conjugate with the probe-centre phase ramp folds the reflection
    back, so the output is phi_blur at the listed scan coordinates (the
    frame ``ssb_reconstruct`` reports).

    Args:
        data4d: (n_sx, n_sy, nkx, nky) detector intensities on the scan
            grid; the first moments are float64 sums on the data's device
            (a tensor) or on ``device`` (an array).
        scan_xs/scan_ys: uniform scan coordinates (Angstrom).
        kxs/kys: detector axes, 1/Angstrom, fftshifted monotonic.
        probe / probe_center: as ``ssb_reconstruct``.
        com: optional calibrated (2, n_sx, n_sy) deflection field in
            1/Angstrom (an array, or a tensor on any device such as
            ``calibrate_datacube``'s ``com``); overrides the moments of
            ``data4d`` (which may then be None).

    Returns dict with ``phase`` (n_sx, n_sy, radians, the probe-blurred
    phase), ``com`` (2, n_sx, n_sy, 1/Angstrom) and ``curl_rms`` (RMS of
    the field's discrete curl over its RMS gradient: large values mean the
    weak-phase / thin-object assumptions fail). The DC phase is set to 0.
    """
    if probe is not None and probe_center is None:
        probe_center = _probe_center(probe)
    if probe_center is None:
        probe_center = (0.0, 0.0)
    dx = _uniform_step(scan_xs, "scan_xs")
    dy = _uniform_step(scan_ys, "scan_ys")
    if com is not None:
        if isinstance(com, torch.Tensor):      # calibrate_datacube's field
            com = com.detach().cpu().numpy()
        com = np.asarray(com, np.float64)
        comx, comy = com[0], com[1]
        n_sx, n_sy = comx.shape
    else:
        data = _real_data(data4d, device).to(torch.float64)
        n_sx, n_sy = data.shape[:2]
        kx = torch.as_tensor(np.asarray(kxs, np.float64), device=data.device)
        ky = torch.as_tensor(np.asarray(kys, np.float64), device=data.device)
        # a zero-total frame (a scan point that caught no counts) has
        # deflection 0, not NaN
        total = data.sum(dim=(-2, -1))
        safe = torch.where(total > 0, total, torch.ones_like(total))
        zero = torch.zeros_like(total)
        comx = torch.where(total > 0,
                           torch.einsum("abxy,x->ab", data, kx) / safe, zero)
        comy = torch.where(total > 0,
                           torch.einsum("abxy,y->ab", data, ky) / safe, zero)
        comx, comy = comx.cpu().numpy(), comy.cpu().numpy()
    qx = np.fft.fftfreq(n_sx, d=dx)[:, None]
    qy = np.fft.fftfreq(n_sy, d=dy)[None, :]
    q2 = qx ** 2 + qy ** 2
    mx = np.fft.fft2(comx)
    my = np.fft.fft2(comy)
    # h(R) = phi_blur(c - R): grad_R h = -2 pi M  =>  M^ = -i Q h^
    #   =>  h^ = i (Q . M^) / |Q|^2  (DC unrecoverable)
    with np.errstate(divide="ignore", invalid="ignore"):
        h_hat = 1j * (qx * mx + qy * my) / q2
    h_hat[0, 0] = 0.0
    # undo the scan reflection: phase^(Q) = e^{-2 pi i Q.c} conj(h^(Q))
    qdotc = qx * probe_center[0] + qy * probe_center[1]
    phase_hat = np.exp(-2j * np.pi * qdotc) * np.conj(h_hat)
    phase = np.real(np.fft.ifft2(phase_hat))
    # curl diagnostic: d(comy)/dx - d(comx)/dy vanishes for a gradient
    curl = np.real(np.fft.ifft2(2j * np.pi * (qx * my - qy * mx)))
    grad_mag = np.sqrt(np.mean(
        np.real(np.fft.ifft2(2j * np.pi * qx * mx)) ** 2
        + np.real(np.fft.ifft2(2j * np.pi * qy * my)) ** 2))
    curl_rms = float(np.sqrt(np.mean(curl ** 2)) / (grad_mag + 1e-30))
    return dict(phase=phase, com=np.stack([comx, comy], axis=0),
                curl_rms=curl_rms)


def _epie_run(amps, positions, obj, probe, kx, ky, alpha: float,
              beta: float, n_iters: int, update_probe: bool):
    """The ePIE solve as an eager loop: ``n_iters`` sweeps, each over the
    positions in order.

    amps: (npos, nx, ny) measured detector amplitudes, natural FFT order;
    positions (npos, 2) Angstrom; kx/ky natural-order axes (1/A), all on
    the device. Probe shifts are exact k-space phase ramps with the sign
    of ``physics.probe.shift_probes``. Both updates of a position take the
    object and probe from before it (the probe's update uses the old
    object). The per-position errors and the sweep losses stay on the
    device: the loop never waits for the card.
    """
    two_pi = 2.0 * np.pi
    errs = torch.empty(amps.shape[0], dtype=amps.dtype, device=amps.device)
    losses = torch.empty(n_iters, dtype=amps.dtype, device=amps.device)
    for it in range(n_iters):
        for j in range(amps.shape[0]):
            a_j, pos = amps[j], positions[j]
            ph = two_pi * (kx[:, None] * pos[0] + ky[None, :] * pos[1])
            ramp = torch.complex(torch.cos(ph), torch.sin(ph))
            p_j = torch.fft.ifft2(torch.fft.fft2(probe) * ramp)
            psi = p_j * obj
            big = torch.fft.fft2(psi)
            mag = big.abs()
            errs[j] = ((mag - a_j) ** 2).mean()
            d = torch.fft.ifft2(big * (a_j / (mag + 1e-12))) - psi
            obj_new = obj + alpha * p_j.conj() * d / (p_j.abs() ** 2).max()
            if update_probe:
                p_new = p_j + beta * obj.conj() * d / (obj.abs() ** 2).max()
                probe = torch.fft.ifft2(torch.fft.fft2(p_new) * ramp.conj())
            obj = obj_new
        losses[it] = errs.mean()
    return obj, probe, losses


def epie_reconstruct(data4d, probe_positions, probe, n_iters: int = 50,
                     alpha: float = 0.2, beta: float = 0.2,
                     update_probe: bool = True, obj_init=None) -> dict:
    """ePIE object (and probe) retrieval from intensity-only 4D-STEM data,
    on the probe's device.

    Args:
        data4d: (npos, nkx, nky) detector intensities, fftshifted (the
            WFData k layout).
        probe_positions: (npos, 2) scan coordinates, Angstrom.
        probe: the illumination ``Probe`` (its array is the real-space
            initial guess; its kxs/kys give the shift ramps).
        n_iters: full sweeps over the scan.
        alpha/beta: object/probe update strengths (Maiden & Rodenburg).
        update_probe: False freezes the probe (PIE), as when the
            illumination is known exactly.
        obj_init: optional (nx, ny) complex initial object (default 1).

    Returns dict with ``object`` (nx, ny complex), ``probe`` (nx, ny
    complex, the refined illumination) and ``losses`` (n_iters, the
    detector-amplitude MSE a sweep), as NumPy arrays. The usual
    ambiguities apply: a global phase, and with update_probe a complex
    scale split between object and probe.
    """
    prec = probe.precision
    dev = probe.device
    data = np.asarray(data4d)
    npos = data.shape[0]
    positions = np.asarray(probe_positions, np.float64)
    if positions.shape[0] != npos:
        raise ValueError(
            f"data4d has {npos} patterns but probe_positions has "
            f"{positions.shape[0]} entries")
    p0 = probe.array
    if p0.dim() != 2:
        raise ValueError("probe must be a single (nx, ny) Probe, "
                         "not a batch")
    rd = prec.np_real
    as_dev = lambda a: torch.as_tensor(np.asarray(a).astype(rd), device=dev)
    obj0 = (torch.ones(tuple(p0.shape), dtype=prec.complex, device=dev)
            if obj_init is None else
            torch.as_tensor(np.asarray(obj_init), device=dev).to(
                prec.complex))
    obj, pr, losses = _epie_run(
        _amplitudes_on(data, prec.real, dev), as_dev(positions), obj0, p0,
        as_dev(probe.kxs), as_dev(probe.kys), float(alpha), float(beta),
        int(n_iters), bool(update_probe))
    return dict(object=obj.cpu().numpy(), probe=pr.cpu().numpy(),
                losses=losses.cpu().numpy())
