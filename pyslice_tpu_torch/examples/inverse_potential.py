#!/usr/bin/env python
"""Inverse multislice on the port: recover a projected potential from
diffraction data.

The whole forward model (probe -> multislice propagation -> k-space
intensity) is differentiable through ``pt.multislice_diff``, a
``torch.autograd.Function`` whose backward is the O(1)-memory unitary
adjoint (on the card, the adjoint kernels), so an optimizer can invert it.
This is the computational core of ptychography / exit-wave reconstruction,
here as a compact self-contained demo:

  1. Build a ground-truth potential V* (hBN-like atoms via the production
     rasterizer).
  2. Record simulated measurements: diffraction intensities
     |FFT2 psi_exit|^2 for a grid of convergent-probe positions at three
     defocus values (intensity only — phases are discarded, as on a real
     detector).
  3. Start from V = 0 and minimize the intensity MSE with Adam,
     differentiating through the full multislice loop. The optimizer is
     PyTorch's ``torch.optim.Adam`` (the JAX demo uses ``optax.adam``;
     the same update rule, learning rate and step count).
  4. Report the loss drop and the correlation of the recovered V with V*.

Intensities are invariant to a constant offset per slice (a global phase),
so recovery is judged mean-free per slice (Pearson correlation).

    python -m pyslice_tpu_torch.examples.inverse_potential [--steps 300]
        [--nx 64] [--nz 3] [--device cuda|cpu] [--plot out.png]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ._fixtures import add_device_flag, device


def build_problem(nx=64, ny=64, nz=3, seed=0, precision="single",
                  dev="cuda"):
    """Ground-truth potential + probe stack + the k axes, on ``dev``."""
    from ..core.dtypes import get_precision
    from ..physics.potential import make_plan, rasterize
    from ..physics.probe import Probe, create_batched_probes, probe_grid

    prec = get_precision(precision)
    lx, ly, lz = nx * 0.15, ny * 0.15, nz * 1.0
    xs = np.linspace(0, lx, nx, endpoint=False)
    ys = np.linspace(0, ly, ny, endpoint=False)
    zs = np.linspace(0, lz, nz, endpoint=False)

    rng = np.random.default_rng(seed)
    n_atoms = 24
    pos = rng.random((1, n_atoms, 3)) * np.array([lx, ly, lz - 0.05])
    types = rng.choice([5, 7], n_atoms).astype(np.int32)   # B / N
    plan = make_plan(xs, ys, zs, pos, types)
    v_true = rasterize(pos[0], plan, prec, device=dev)

    base = Probe(xs, ys, 25.0, 100e3, precision=prec, device=dev)
    scan = probe_grid([lx * 0.15, lx * 0.85], [ly * 0.15, ly * 0.85], 3, 3)
    probes = []
    for dz in (0.0, 60.0, 120.0):               # three defocus states
        p = base.copy()
        if dz:
            p.defocus(dz)
        probes.append(create_batched_probes(p, scan).array)
    probe_stack = torch.cat(probes, dim=0)      # (27, nx, ny)

    kxs = np.fft.fftfreq(nx, d=xs[1] - xs[0]).astype(np.float64)
    kys = np.fft.fftfreq(ny, d=ys[1] - ys[0]).astype(np.float64)
    return dict(v_true=v_true, probes=probe_stack, kxs=kxs, kys=kys,
                dz=float(zs[1] - zs[0]) if nz > 1 else 1.0, prec=prec)


def recover(problem, steps=300, lr=30.0, log_every=50, log=print):
    """Adam descent on the intensity MSE; returns (v_rec, history)."""
    from ..physics.adjoint import multislice_diff

    prec = problem["prec"]
    probes = problem["probes"]
    kxs, kys, dz = problem["kxs"], problem["kys"], problem["dz"]

    def forward(v):
        # multislice_diff: the backward reconstructs the wavefield through
        # the unitary chain instead of storing nz residuals
        out = multislice_diff(probes, v, kxs, kys, eV=100e3, dz=dz,
                              precision=prec)
        return torch.fft.fft2(out).abs() ** 2           # detector intensity

    v_true = problem["v_true"]
    with torch.no_grad():
        target = forward(v_true)
    scale = target.mean()

    v = torch.zeros_like(v_true, requires_grad=True)
    opt = torch.optim.Adam([v], lr=lr)

    history = []
    for i in range(steps):
        opt.zero_grad()
        loss = ((forward(v) - target) ** 2).mean() / scale ** 2
        loss.backward()
        opt.step()
        val = float(loss.detach())
        history.append(val)
        if log_every and (i % log_every == 0 or i == steps - 1):
            log(f"  step {i:4d}  loss {val:.3e}")
    return v.detach(), history


def correlation(v_rec, v_true, kxs=None, kys=None, q_max=None) -> float:
    """Mean-free per-slice Pearson correlation (intensity data cannot fix a
    per-slice constant — it is a global phase).

    With ``q_max`` (and the k axes), both fields are low-passed to |k| <
    q_max first: a probe with aperture semi-angle alpha only carries
    information out to q = 2 alpha / lambda, so spatial frequencies beyond
    that are in the measurement null space and not recoverable by any
    method."""
    a = torch.as_tensor(v_rec).detach().cpu().numpy().astype(np.float64)
    b = torch.as_tensor(v_true).detach().cpu().numpy().astype(np.float64)
    if q_max is not None:
        mask = (np.asarray(kxs)[:, None] ** 2
                + np.asarray(kys)[None, :] ** 2) < q_max ** 2
        a = np.real(np.fft.ifft2(np.fft.fft2(a, axes=(1, 2)) * mask[None],
                                 axes=(1, 2)))
        b = np.real(np.fft.ifft2(np.fft.fft2(b, axes=(1, 2)) * mask[None],
                                 axes=(1, 2)))
    a = a - a.mean(axis=(1, 2), keepdims=True)
    b = b - b.mean(axis=(1, 2), keepdims=True)
    return float((a * b).sum()
                 / np.sqrt((a ** 2).sum() * (b ** 2).sum() + 1e-30))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--nx", type=int, default=64)
    ap.add_argument("--nz", type=int, default=3)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--lr", type=float, default=30.0)
    ap.add_argument("--plot", type=str, default=None,
                    help="save a true/recovered comparison PNG")
    add_device_flag(ap)
    args = ap.parse_args(argv)
    dev = device(args.device)

    print(f"building {args.nx}^2 x {args.nz} problem ...")
    prob = build_problem(nx=args.nx, ny=args.nx, nz=args.nz, dev=dev)
    t0 = time.time()
    v_rec, hist = recover(prob, steps=args.steps, lr=args.lr)
    from ..core.constants import wavelength
    q_max = 2 * 25.0e-3 / wavelength(100e3)     # probe information limit
    c_raw = correlation(v_rec, prob["v_true"])
    c_band = correlation(v_rec, prob["v_true"], prob["kxs"], prob["kys"],
                         q_max)
    print(f"loss {hist[0]:.3e} -> {hist[-1]:.3e} "
          f"({hist[0] / max(hist[-1], 1e-30):.0f}x) in {time.time()-t0:.1f} s")
    print(f"correlation(recovered, true) = {c_raw:.3f} raw, "
          f"{c_band:.3f} within the probe bandwidth (|k| < 2 alpha/lambda)")

    if args.plot:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        fig, axes = plt.subplots(1, 2, figsize=(9, 4))
        for ax, (title, v) in zip(
                axes, [("true V (slice 0)", prob["v_true"]),
                       ("recovered V (slice 0)", v_rec)]):
            im = ax.imshow(v[0].cpu().numpy().T, cmap="inferno",
                           origin="lower")
            ax.set_title(title)
            fig.colorbar(im, ax=ax, shrink=0.8)
        fig.tight_layout()
        fig.savefig(args.plot, dpi=120)
        print(f"wrote {args.plot}")


if __name__ == "__main__":
    main()
