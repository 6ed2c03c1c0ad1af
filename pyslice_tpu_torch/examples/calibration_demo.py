#!/usr/bin/env python
"""Instrument + structure self-calibration from 4D-STEM data, on the port.

Three inverse problems, all gradient descent through the production
multislice forward via the O(1)-memory adjoint (``physics/adjoint.py``;
on the card its backward runs the adjoint kernels):

  1. Aberration self-calibration (``pt.refine_aberrations``): data
     recorded with an unknown aberrated probe; fit residual C1/C3/A1
     jointly with the unknown specimen, starting from the clean probe
     model.
  2. Atomic-coordinate refinement (``pt.refine_structure``): recover
     sub-pixel in-plane displacements of a structure model.
  3. Tomographic tilt-series refinement
     (``pt.refine_structure_tilt_series``): a 3-angle tilt series recovers
     all three coordinates — including z, invisible to any single
     projection.

    python -m pyslice_tpu_torch.examples.calibration_demo
        [--steps-scale 1.0] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ._fixtures import add_device_flag, device


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps-scale", type=float, default=1.0,
                    help="multiply every refinement's step count (use e.g. "
                         "0.02 for a smoke run)")
    add_device_flag(ap)
    args = ap.parse_args(argv)
    dev = device(args.device)

    def steps(n):
        return max(2, int(round(n * args.steps_scale)))

    import pyslice_tpu_torch as pt
    from ..core.constants import wavelength
    from ..core.dtypes import get_precision
    from ..engine.inverse import rotation_about_x
    from ..physics.aberrations import Aberrations, apply_aberrations
    from ..physics.potential import make_plan, rasterize
    from ..physics.probe import Probe, shift_probes
    from ..physics.propagate import multislice

    prec = get_precision("single")
    NX = NY = 64
    S, EV, MRAD, DZ = 0.15, 100e3, 20.0, 1.0
    lx, ly = NX * S, NY * S
    xs = np.linspace(0, lx, NX, endpoint=False)
    ys = np.linspace(0, ly, NY, endpoint=False)
    rng = np.random.default_rng(3)

    def record(probe_array, v, positions, kxs, kys):
        probes = shift_probes(probe_array, kxs, kys, positions,
                              precision=prec)
        ew = multislice(probes, v, kxs, kys, eV=EV, dz=DZ, precision=prec)
        k = torch.fft.fftshift(torch.fft.fft2(ew), dim=(-2, -1))
        return (k.abs() ** 2).cpu().numpy()

    # ---- 1. aberration self-calibration -----------------------------------
    zs = np.array([0.0, DZ])
    pos = rng.random((1, 10, 3)) * np.array([lx, ly, 2 * DZ - 0.1])
    types = rng.choice([5, 7], 10).astype(np.int32)
    plan = make_plan(xs, ys, zs, pos, types)
    v_true = rasterize(pos[0], plan, prec, device=dev)
    base = Probe(xs, ys, MRAD, EV, precision=prec, device=dev)
    ab_true = Aberrations(C1=60.0, C3=1.0e5, A1=25.0, phi_A1=0.5)
    p_true = apply_aberrations(base.array, base.kxs, base.kys,
                               wavelength(EV), ab_true, precision=prec)
    n_s = 16
    positions = np.array([(i * lx / n_s, j * ly / n_s)
                          for i in range(n_s) for j in range(n_s)])
    inten = record(p_true, v_true, positions, base.kxs, base.kys)

    t0 = time.time()
    rec = pt.refine_aberrations(inten, positions, base,
                                coefficients=("C1", "C3", "A1"),
                                n_slices=2, dz=DZ, steps=steps(800), batch=64)
    ab = rec["aberrations"]
    print(f"1. aberrations ({time.time() - t0:.0f} s): "
          f"C1 {ab.C1:.1f} A (true 60), C3 {ab.C3:.3g} A (true 1e5), "
          f"A1 {ab.A1:.1f} A @ {ab.phi_A1:.2f} rad (true 25 @ 0.50)")

    # ---- 2. in-plane coordinate refinement --------------------------------
    n_at = 8
    pos_true = np.column_stack([rng.uniform(.15 * lx, .85 * lx, n_at),
                                rng.uniform(.15 * ly, .85 * ly, n_at),
                                rng.uniform(0.2, 2 * DZ - 0.2, n_at)])
    types2 = rng.choice([5, 7], n_at).astype(np.int32)
    plan2 = make_plan(xs, ys, zs, pos_true[None], types2)
    v2 = rasterize(pos_true, plan2, prec, device=dev)
    base2 = Probe(xs, ys, 22.0, EV, precision=prec, device=dev)
    inten2 = record(base2.array, v2, positions, base2.kxs, base2.kys)
    start = pos_true.copy()
    start[:, :2] += rng.normal(0, 0.06, (n_at, 2))
    err0 = float(np.sqrt(np.mean((start[:, :2] - pos_true[:, :2]) ** 2)))
    t0 = time.time()
    r2 = pt.refine_structure(inten2, positions, base2, start, types2, zs,
                             steps=steps(300), batch=64)
    err1 = float(np.sqrt(np.mean(
        (r2["positions"][:, :2] - pos_true[:, :2]) ** 2)))
    print(f"2. coordinates ({time.time() - t0:.0f} s): xy rms "
          f"{err0:.4f} -> {err1:.5f} A")

    # ---- 3. tomographic tilt series (recovers z) ---------------------------
    zs3 = np.arange(4) * DZ
    pos3 = np.column_stack([rng.uniform(.3 * lx, .7 * lx, 6),
                            rng.uniform(.35 * ly, .65 * ly, 6),
                            rng.uniform(1.2, 2.8, 6)])
    types3 = rng.choice([5, 7], 6).astype(np.int32)
    ctr = pos3.mean(axis=0)
    tilts = [-30.0, 0.0, 30.0]
    scan3 = np.array([(0.25 * lx + i * lx / 16, 0.25 * ly + j * ly / 16)
                      for i in range(8) for j in range(8)])
    datasets = []
    for ang in tilts:
        rot = (pos3 - ctr) @ rotation_about_x(np.deg2rad(ang)).T + ctr
        plan3 = make_plan(xs, ys, zs3, rot[None], types3, pad_fraction=0.5)
        v3 = rasterize(rot, plan3, prec, device=dev)
        datasets.append(record(base2.array, v3, scan3,
                               base2.kxs, base2.kys))
    start3 = pos3 + rng.normal(0, 0.05, (6, 3))        # 3-D jitter incl. z
    ez0 = float(np.sqrt(np.mean((start3[:, 2] - pos3[:, 2]) ** 2)))
    t0 = time.time()
    r3 = pt.refine_structure_tilt_series(
        datasets, [scan3] * 3, base2, start3, types3, zs3, tilts,
        steps=steps(450), batch=32, center=ctr)
    ez1 = float(np.sqrt(np.mean((r3["positions"][:, 2] - pos3[:, 2]) ** 2)))
    print(f"3. tilt series ({time.time() - t0:.0f} s): z rms "
          f"{ez0:.4f} -> {ez1:.5f} A (z is invisible to a single "
          "projection — the tilts recover it)")


if __name__ == "__main__":
    main()
