#!/usr/bin/env python
"""Generate an example LAMMPS trajectory (synthetic thermal hBN monolayer).

Writes a drop-in ``monolayer.lammpstrj`` (into the current directory
unless ``--out`` says otherwise) so the CLI and the demos run out of the
box:

    python -m pyslice_tpu_torch.examples.make_fixture --cells 8 6 --frames 100
    python -m pyslice_tpu_torch run --trajectory monolayer.lammpstrj \\
        --timestep 0.005 --atom-mapping 1=B,2=N --mode tacaw

The thermal frames are drawn with NumPy from seed 0, so the file is the
one ``examples/make_fixture.py`` writes.
"""

import argparse

import numpy as np

from ..io.lammps import write_lammps_dump
from ._fixtures import displaced, hbn_monolayer


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cells", nargs=2, type=int, default=[8, 6],
                    metavar=("NX", "NY"))
    ap.add_argument("--frames", type=int, default=100)
    ap.add_argument("--sigma", type=float, default=0.05,
                    help="thermal displacement scale (Angstrom)")
    ap.add_argument("--out", default="monolayer.lammpstrj")
    args = ap.parse_args(argv)

    nx, ny = args.cells
    traj = displaced(hbn_monolayer(nx, ny), args.frames, args.sigma, seed=0)
    # LAMMPS type ids: 1 = B, 2 = N
    write_lammps_dump(args.out, np.where(traj.atom_types == 5, 1, 2),
                      traj.positions, traj.velocities, traj.box_matrix)
    print(f"wrote {args.out}: {traj.n_frames} frames, {traj.n_atoms} atoms, "
          f"box {np.diag(traj.box_matrix).round(2)}")


if __name__ == "__main__":
    main()
