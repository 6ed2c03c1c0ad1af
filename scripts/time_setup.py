#!/usr/bin/env python3
"""Time a TACAW job's host set-up, without a card: ``make_plan``'s binning
of every frame, the md5 digest of the positions that names the frame
cache, and the whole ``MultisliceCalculator.setup`` as the benchmark's
STEM job calls it (``device_output=True, use_cache=False``).

    python3 scripts/time_setup.py [--frames 1 100 400] [--reps 15]
        [--device cpu]

The frames are the ``hbn_1023.stem16_tacaw`` job's: the 102.25 A hBN box
of ``benchmark/inputs.py`` (3,680 atoms) with thermal frames drawn from
seed 0. The yardstick is the per-frame binning loop that ``make_plan``
used before its one pass (``per_frame_occupancy`` below, both casts a
frame), timed through the same ``make_plan`` in the same rounds, the two
in alternating order; then the set-up likewise, where
``setup_per_frame_and_digest`` is the set-up as it was: the loop's plan
and the digest taken. Each figure is the median over the rounds, in ms;
one JSON line per frame count.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "benchmark"))

import numpy as np

import inputs
import pyslice_tpu_torch as pt
from common import scan
from pyslice_tpu_torch.engine import calculator
from pyslice_tpu_torch.physics import potential


def per_frame_occupancy(pos, slice_axis, edges, type_ids, n_types):
    """The binning loop ``make_plan`` ran before its one pass: a
    ``searchsorted`` and a ``bincount`` a frame, in float64 and float32."""
    nz = len(edges) - 1
    n_bins = n_types * nz
    occupied = np.zeros(n_bins, dtype=bool)
    max_count = 0
    for f in range(pos.shape[0]):
        for cast in (np.float64, np.float32):
            sl, valid = potential.bin_atoms_np(
                pos[f, :, slice_axis].astype(cast), edges.astype(cast))
            bins = type_ids[valid] * nz + sl[valid]
            if bins.size:
                counts = np.bincount(bins, minlength=n_bins)
                occupied |= counts > 0
                max_count = max(max_count, int(counts.max()))
    return occupied, max_count


def median_ms(times):
    return round(float(np.median(times)) * 1e3, 3)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, nargs="+", default=[1, 100, 400])
    ap.add_argument("--reps", type=int, default=15)
    ap.add_argument("--device", default="cpu")
    args = ap.parse_args()

    cfg = json.loads((ROOT / "benchmark/configs/hbn_1023.json").read_text())
    tr = json.loads((ROOT / "benchmark/traffic/stem16_tacaw.json")
                    .read_text())
    base, types = inputs.hbn_box(cfg["box_A"], cfg["layer_z_A"])
    probes = [tuple(p) for p in scan(tr["probe_grid"])]
    one_pass = potential._occupancy

    for n in args.frames:
        frames = inputs.thermal_frames(base, n, cfg["thermal_sigma_A"], 0,
                                       inputs.JOB, 0)
        traj = pt.Trajectory(
            atom_types=types, positions=frames,
            velocities=np.zeros_like(frames),
            box_matrix=np.diag([cfg["box_A"], cfg["box_A"],
                                cfg["box_height_A"]]),
            timestep=cfg["timestep_ps"])
        calc = pt.MultisliceCalculator(device=args.device)

        def setup():
            calc.setup(traj, aperture=tr["aperture_mrad"],
                       voltage_eV=cfg["voltage_eV"],
                       slice_thickness=cfg["slice_thickness_A"],
                       sampling=cfg["sampling_A"], probe_positions=probes,
                       device_output=True, use_cache=False)

        setup()
        grid = calc.grid
        plan_args = (grid.xs, grid.ys, grid.zs, frames, types)
        t = {k: [] for k in ("plan_one_pass", "plan_per_frame", "digest",
                             "setup", "setup_per_frame_and_digest")}
        digests = calculator.STATS["cache_key_digests"]
        for r in range(args.reps):
            for loop in ((False, True) if r % 2 else (True, False)):
                potential._occupancy = (per_frame_occupancy if loop
                                        else one_pass)
                t0 = time.perf_counter()
                potential.make_plan(*plan_args)
                t["plan_per_frame" if loop else "plan_one_pass"].append(
                    time.perf_counter() - t0)
            t0 = time.perf_counter()
            hashlib.md5(np.ascontiguousarray(frames).tobytes()).hexdigest()
            t["digest"].append(time.perf_counter() - t0)
        for r in range(args.reps):
            for loop in ((False, True) if r % 2 else (True, False)):
                potential._occupancy = (per_frame_occupancy if loop
                                        else one_pass)
                t0 = time.perf_counter()
                setup()
                if loop:
                    calc._generate_cache_key()
                t["setup_per_frame_and_digest" if loop else "setup"].append(
                    time.perf_counter() - t0)
        potential._occupancy = one_pass
        out = {"frames": n, "atoms": len(base), "device": args.device,
               "reps": args.reps}
        out.update({f"{k}_ms": median_ms(v) for k, v in t.items()})
        out["plan_share_of_loop"] = round(
            out["plan_one_pass_ms"] / out["plan_per_frame_ms"], 3)
        out["setup_digests"] = (calculator.STATS["cache_key_digests"]
                                - digests - args.reps)
        print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
