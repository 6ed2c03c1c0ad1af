#!/usr/bin/env python
"""Realistic-instrument STEM image: the full imperfection chain, on the
port.

Composes the instrument models into one HAADF simulation (the reference
models an ideal coherent point-source probe with no aberrations beyond
defocus, infinite dose):

  1. aberrated probe      — 1 mm spherical aberration at Scherzer defocus
                            plus a touch of twofold astigmatism
                            (physics.aberrations);
  2. frozen phonons       — thermal configurations averaged incoherently
                            (NumPy displacements, seed 0, as the JAX demo);
  3. chromatic spread     — Gauss-Hermite defocus series over Cc * dE/E
                            (engine.coherence.defocus_series);
  4. finite source        — effective-source Gaussian blur of the scan
                            image (engine.coherence.source_size_blur);
  5. finite dose          — Poisson electron counting
                            (analysis.detectors.apply_shot_noise, drawn
                            from a seeded torch.Generator on the device:
                            the JAX demo's jax.random draws differ, their
                            distribution is the same).

Prints per-stage wall-clock and summary statistics; --plot writes a
3-panel PNG (ideal vs realistic).

    python -m pyslice_tpu_torch.examples.realistic_stem [--scan N]
        [--dose E_PER_A2] [--device cuda|cpu] [--plot PNG]
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from ._fixtures import add_device_flag, device, displaced, generator


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--scan", type=int, default=8, help="scan points/axis")
    ap.add_argument("--dose", type=float, default=5e3,
                    help="electrons per A^2")
    ap.add_argument("--plot", type=str, default=None)
    add_device_flag(ap)
    args = ap.parse_args(argv)
    dev = device(args.device)

    from ..analysis.detectors import apply_shot_noise
    from ..analysis.haadf import HAADFData
    from ..core.constants import wavelength
    from ..data.trajectory import Trajectory
    from ..engine.calculator import MultisliceCalculator
    from ..engine.coherence import (defocus_series, defocus_spread,
                                    source_size_blur)
    from ..physics.aberrations import Aberrations
    from ..physics.probe import probe_grid

    # --- specimen: hBN monolayer + thermal frames --------------------------
    a, by = 2.504, 2.504 * np.sqrt(3.0)
    ncx, ncy = 5, 3
    base = np.array([[0.0, 0.0, 1.0], [a / 2, by / 6, 1.0],
                     [a / 2, by / 2, 1.0], [0.0, by / 2 + by / 6, 1.0]])
    pos = np.concatenate([base + np.array([i * a, j * by, 0.0])
                          for i in range(ncx) for j in range(ncy)])[None]
    types = np.tile(np.array([5, 7, 5, 7], np.int32), ncx * ncy)
    traj = Trajectory(types, pos, np.zeros_like(pos),
                      np.diag([ncx * a, ncy * by, 2.0]), 0.005)
    thermal = displaced(traj, 3, 0.05, seed=0)

    eV = 100e3
    lam = wavelength(eV)
    ab = Aberrations(C3=1.0e7, A1=25.0, phi_A1=0.4)    # 1 mm Cs
    scherzer = ab.scherzer_defocus(lam)
    delta = defocus_spread(Cc=1.2e7, dE=0.35, eV=eV)   # 1.2 mm Cc
    nodes, weights = defocus_series(delta, n=3, center=scherzer)
    print(f"Scherzer defocus {scherzer:.0f} A; chromatic spread "
          f"{delta:.0f} A -> defocus nodes {np.round(nodes, 1)}")

    n = args.scan
    scan = probe_grid([2.0, traj.box_matrix[0, 0] - 2.0],
                      [2.0, traj.box_matrix[1, 1] - 2.0], n, n)
    scan_step = ((traj.box_matrix[0, 0] - 4.0) / max(n - 1, 1),
                 (traj.box_matrix[1, 1] - 4.0) / max(n - 1, 1))

    def haadf_image(defocus=0.0, aberrations=None):
        calc = MultisliceCalculator(device=dev)
        calc.setup(thermal, aperture=25.0, voltage_eV=eV,
                   slice_thickness=1.0, sampling=0.25,
                   probe_positions=scan, use_cache=False,
                   aberrations=aberrations, defocus=float(defocus),
                   device_output=True)
        wf = calc.run()
        img = HAADFData(wf).calculateADF(collection_angle=45,
                                         intensity=True)
        return np.asarray(img)

    # --- ideal: coherent, aberration-corrected, infinite dose --------------
    t0 = time.time()
    ideal = haadf_image()
    print(f"ideal image:     {time.time() - t0:.1f} s")

    # --- realistic: aberrations + chromatic series -------------------------
    t0 = time.time()
    real = np.zeros_like(ideal)
    for df, w in zip(nodes, weights):
        # nodes are centered at Scherzer; ab carries no C1, so the node IS
        # the probe defocus for this series member
        real += w * haadf_image(defocus=df, aberrations=ab)
    print(f"chromatic series ({len(nodes)} nodes): {time.time() - t0:.1f} s")

    # --- source size + dose ------------------------------------------------
    real = source_size_blur(real, scan_step, fwhm=0.8)
    counts = apply_shot_noise(real, args.dose,
                              scan_step[0] * scan_step[1],
                              generator=generator(1, dev))
    print(f"contrast ideal {ideal.std() / ideal.mean():.3f} -> realistic "
          f"{counts.std() / max(counts.mean(), 1e-9):.3f} "
          f"(mean {counts.mean():.0f} e-/px)")

    if args.plot:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        fig, axes = plt.subplots(1, 3, figsize=(12, 4))
        for ax, (t, im) in zip(axes, [("ideal", ideal),
                                      ("aberrated+chromatic+source", real),
                                      (f"+shot noise ({args.dose:g} e/A^2)",
                                       counts)]):
            h = ax.imshow(im.T, cmap="inferno", origin="lower")
            ax.set_title(t, fontsize=9)
            fig.colorbar(h, ax=ax, shrink=0.8)
        fig.tight_layout()
        fig.savefig(args.plot, dpi=120)
        print(f"wrote {args.plot}")


if __name__ == "__main__":
    main()
