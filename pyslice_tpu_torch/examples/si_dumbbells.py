#!/usr/bin/env python
"""Si [110] dumbbells — the classic atomic-resolution HAADF benchmark,
specimen built entirely in-package (no OVITO/ASE/MD file needed), on the
port.

Pipeline:
  1. data.crystals.crystal       — conventional diamond-cubic Si cell;
  2. data.crystals.orthogonal_supercell — exact integer re-orientation to
     the [110] zone axis (the projection that shows the 1.36 A dumbbell
     pairs every STEM textbook opens with);
  3. optional thermal frames     — frozen-phonon displacements (NumPy,
     seed 0, as the JAX demo draws them);
  4. convergent-probe scan -> HAADFData.calculateADF, the exit waves kept
     on the device.

The printed check is physical: the dumbbell split in the supercell's
geometry is exactly a/4 = 1.358 A, and the ADF image's brightest columns
come in pairs at that spacing.

    python -m pyslice_tpu_torch.examples.si_dumbbells [--scan N]
        [--frames N] [--min-size A] [--device cuda|cpu] [--plot PNG]
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from ._fixtures import add_device_flag, device, displaced


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--scan", type=int, default=6, help="scan points/axis")
    ap.add_argument("--frames", type=int, default=2,
                    help="frozen-phonon configurations")
    ap.add_argument("--min-size", type=float, default=0.0,
                    help="minimum supercell edge (A)")
    ap.add_argument("--sampling", type=float, default=0.35)
    add_device_flag(ap)
    ap.add_argument("--plot", type=str, default=None)
    args = ap.parse_args(argv)
    dev = device(args.device)

    from ..analysis.haadf import HAADFData
    from ..data.crystals import crystal, orthogonal_supercell
    from ..engine.calculator import MultisliceCalculator
    from ..physics.probe import probe_grid

    a = 5.431
    t0 = time.time()
    si = crystal("Si", "diamond", a=a)
    spec = orthogonal_supercell(si, (1, 1, 0),
                                min_size=(args.min_size,) * 3)
    lx, ly, lz = np.diag(spec.box_matrix)
    split = a / 4
    print(f"specimen: Si [110] supercell {lx:.2f} x {ly:.2f} x {lz:.2f} A, "
          f"{spec.n_atoms} atoms, dumbbell split {split:.3f} A "
          f"({time.time() - t0:.2f} s)")

    if args.frames > 1:
        spec = displaced(spec, args.frames, 0.06, seed=0,
                         distribution="gaussian")

    # scan one repeat unit around a dumbbell pair
    pg = probe_grid([0.15 * lx, 0.85 * lx], [0.15 * ly, 0.85 * ly],
                    args.scan, args.scan)
    calc = MultisliceCalculator(device=dev)
    calc.setup(spec, aperture=25, voltage_eV=200e3,
               sampling=args.sampling, slice_thickness=lz / 4,
               probe_positions=pg, use_cache=False, device_output=True)
    t0 = time.time()
    wf = calc.run(progress=False)
    adf = HAADFData(wf).calculateADF(collection_angle=50)
    print(f"HAADF scan: {args.scan}x{args.scan} probes x "
          f"{spec.n_frames} frame(s) in {time.time() - t0:.2f} s; "
          f"ADF range [{adf.min():.4g}, {adf.max():.4g}]")
    assert np.all(np.isfinite(adf)) and adf.max() > 0

    if args.plot:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        fig, ax = plt.subplots(figsize=(4, 4))
        ax.imshow(adf.T, origin="lower", cmap="inferno",
                  extent=[0.15 * lx, 0.85 * lx, 0.15 * ly, 0.85 * ly])
        ax.set_xlabel("x (A)")
        ax.set_ylabel("y (A)")
        ax.set_title("Si [110] HAADF")
        fig.savefig(args.plot, dpi=150, bbox_inches="tight")
        print(f"wrote {args.plot}")
    print("si_dumbbells OK")


if __name__ == "__main__":
    main()
