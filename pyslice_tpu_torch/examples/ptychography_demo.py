#!/usr/bin/env python
"""Ptychography demo on the port: phase imaging from intensity-only
4D-STEM data.

The standard user flow — Trajectory -> MultisliceCalculator (dense
convergent-beam scan) -> WFData — already records a 4D-STEM dataset; this
script inverts it four ways and compares each against the ground-truth
projected potential the simulation used:

  1. SSB (single-sideband): direct, non-iterative, aperture-band-limited
     phase on the scan grid.
  2. iCoM/iDPC: Fourier integration of the center-of-mass deflection
     field — the cheapest method (two scan-grid FFTs).
  3. ePIE: iterative object+probe retrieval at full grid resolution, on
     the probe's device.
  4. MSP (multislice ptychography): Adam descent on a depth-resolved
     potential through the multislice forward, via the O(1)-memory
     adjoint (``physics/adjoint.py``, its backward on the adjoint
     kernels).

    python -m pyslice_tpu_torch.examples.ptychography_demo [--scan 32]
        [--iters 40] [--msp-steps 300] [--out DIR] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np

import pyslice_tpu_torch as pt
from ..analysis.ptychography import (epie_reconstruct, icom_reconstruct,
                                     msp_reconstruct, scan_grid_data,
                                     ssb_reconstruct)
from ..core.constants import interaction_parameter, wavelength
from ._fixtures import add_device_flag, device


def synthetic_trajectory():
    """One static frame of a 4x3 hBN supercell (ptychography images a
    single configuration; thermal averaging would blur the phases)."""
    a, by, lz = 2.504, 2.504 * np.sqrt(3.0), 2.0
    base = np.array([[0.0, 0.0, lz / 2], [a / 2, by / 6, lz / 2],
                     [a / 2, by / 2, lz / 2], [0.0, by / 2 + by / 6, lz / 2]])
    cells = [base + np.array([i * a, j * by, 0.0])
             for i in range(4) for j in range(3)]
    pos = np.concatenate(cells)[None]
    types = np.tile(np.array([5, 7, 5, 7], np.int32), 12)
    return pt.Trajectory(types, pos, np.zeros_like(pos),
                         np.diag([4 * a, 3 * by, lz]), 0.005)


def pearson(a, b):
    a = np.asarray(a, np.float64) - np.mean(a)
    b = np.asarray(b, np.float64) - np.mean(b)
    return float((a * b).sum()
                 / np.sqrt((a ** 2).sum() * (b ** 2).sum() + 1e-30))


def band_limit(img, kxs, kys, q_max):
    mask = (np.asarray(kxs)[:, None] ** 2
            + np.asarray(kys)[None, :] ** 2) < q_max ** 2
    return np.real(np.fft.ifft2(np.fft.fft2(img) * mask))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--scan", type=int, default=32,
                    help="scan points per axis (dense, full-cell)")
    ap.add_argument("--iters", type=int, default=40)
    ap.add_argument("--msp-steps", type=int, default=300)
    ap.add_argument("--mrad", type=float, default=20.0)
    ap.add_argument("--out", default="ptycho_results")
    add_device_flag(ap)
    args = ap.parse_args(argv)
    dev = device(args.device)
    out = Path(args.out)
    out.mkdir(exist_ok=True)

    traj = synthetic_trajectory()
    lx, ly = traj.box_matrix[0, 0], traj.box_matrix[1, 1]
    n_s = args.scan
    scan = [(i * lx / n_s, j * ly / n_s)
            for i in range(n_s) for j in range(n_s)]

    print(f"Simulating {n_s}x{n_s} scan ...")
    t0 = time.time()
    calc = pt.MultisliceCalculator(device=dev)
    calc.setup(traj, aperture=args.mrad, voltage_eV=100e3,
               sampling=0.15, slice_thickness=1.0,
               probe_positions=scan, use_cache=False, device_output=True)
    wf = calc.run(progress=False)
    print(f"  {time.time() - t0:.1f}s  (grid {calc.nx}x{calc.ny}x{calc.nz},"
          f" {len(scan)} probes)")

    # Ground truth for comparison: the projected potential's phase.
    v = pt.rasterize(traj.positions[0], calc.spec.plan, calc.spec.precision,
                     device=dev).cpu().numpy()
    phi_true = interaction_parameter(100e3) * v.sum(axis=0)
    q_band = 2 * (args.mrad * 1e-3) / wavelength(100e3)
    kxs = np.fft.ifftshift(np.asarray(wf.kxs))
    kys = np.fft.ifftshift(np.asarray(wf.kys))

    # --- SSB -----------------------------------------------------------------
    t0 = time.time()
    scan_xs, scan_ys, data4d = scan_grid_data(wf)
    rec = ssb_reconstruct(data4d, scan_xs, scan_ys, wf.kxs, wf.kys,
                          probe=wf.probe, device=dev)
    # Truth AT the scan coordinates (they need not land on grid pixels):
    # band-limited Fourier interpolation, separable in x and y.
    phi_q = np.fft.fft2(phi_true)
    phi_q *= (kxs[:, None] ** 2 + kys[None, :] ** 2) < q_band ** 2
    ex = np.exp(2j * np.pi * np.asarray(scan_xs)[:, None] * kxs[None, :])
    ey = np.exp(2j * np.pi * np.asarray(scan_ys)[:, None] * kys[None, :])
    truth_scan = np.real(ex @ phi_q @ ey.T) / phi_true.size
    c_ssb = pearson(rec["phase"], truth_scan)
    print(f"SSB: {time.time() - t0:.1f}s, phase vs truth r = {c_ssb:.3f}")
    np.save(out / "ssb_phase.npy", rec["phase"])

    # --- iCoM / iDPC ---------------------------------------------------------
    t0 = time.time()
    r_icom = icom_reconstruct(data4d, scan_xs, scan_ys, wf.kxs, wf.kys,
                              probe=wf.probe, device=dev)
    # iCoM's exact expectation is the PROBE-INTENSITY-blurred phase.
    a2 = np.fft.ifftshift(np.abs(wf.probe.to_cpu()) ** 2)
    a2_hat = np.fft.fft2(a2)
    phi_b = np.fft.fft2(phi_true) * np.conj(a2_hat) / a2_hat[0, 0].real
    truth_icom = np.real(ex @ phi_b @ ey.T) / phi_true.size
    c_icom = pearson(r_icom["phase"], truth_icom)
    print(f"iCoM: {time.time() - t0:.1f}s, phase vs blurred truth "
          f"r = {c_icom:.3f}, curl_rms = {r_icom['curl_rms']:.3f}")
    np.save(out / "icom_phase.npy", r_icom["phase"])

    # --- ePIE ----------------------------------------------------------------
    t0 = time.time()
    inten = data4d.reshape(-1, *data4d.shape[2:])
    positions = np.array([(sx, sy) for sx in scan_xs for sy in scan_ys])
    r2 = epie_reconstruct(inten, positions, wf.probe, n_iters=args.iters,
                          alpha=0.9, update_probe=False)
    phase = band_limit(np.angle(r2["object"]), kxs, kys, q_band)
    c_epie = pearson(phase, band_limit(phi_true, kxs, kys, q_band))
    print(f"ePIE: {time.time() - t0:.1f}s, loss {r2['losses'][0]:.2e} -> "
          f"{r2['losses'][-1]:.2e}, phase vs truth r = {c_epie:.3f}")
    np.save(out / "epie_object.npy", r2["object"])

    # --- Multislice ptychography (gradient through the slice loop) -----------
    t0 = time.time()
    r3 = msp_reconstruct(inten, positions, wf.probe, n_slices=calc.nz,
                         dz=1.0, steps=args.msp_steps, batch=128, lr=30.0)
    phase_msp = band_limit(
        interaction_parameter(100e3) * r3["potential"].sum(axis=0),
        kxs, kys, q_band)
    c_msp = pearson(phase_msp, band_limit(phi_true, kxs, kys, q_band))
    print(f"MSP ({args.msp_steps} Adam steps through the multislice "
          f"adjoint): {time.time() - t0:.1f}s, loss {r3['losses'][0]:.2e} "
          f"-> {r3['losses'][-1]:.2e}, phase vs truth r = {c_msp:.3f}")
    np.save(out / "msp_potential.npy", r3["potential"])

    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        fig, axes = plt.subplots(1, 5, figsize=(25, 5))
        for ax, img, title in [
                (axes[0], phi_true, "true projected phase"),
                (axes[1], rec["phase"], "SSB (scan-grid)"),
                (axes[2], r_icom["phase"], "iCoM (scan-grid)"),
                (axes[3], np.angle(r2["object"]), "ePIE (full grid)"),
                (axes[4], phase_msp, "MSP (multislice adjoint)")]:
            im = ax.imshow(np.asarray(img).T, origin="lower", cmap="magma")
            ax.set_title(title)
            fig.colorbar(im, ax=ax, shrink=0.8)
        fig.savefig(out / "ptychography.png", dpi=150)
        print(f"  wrote {out / 'ptychography.png'}")
    except ImportError:
        print("  (matplotlib unavailable; arrays saved)")


if __name__ == "__main__":
    main()
