#!/usr/bin/env python
"""How far complex64 itself determines the multislice-ptychography cell's
numbers: the plain reference (``benchmark/reference/msp.py``) taken in
complex64 with TF32 off against float64, from the state the program's
check step kept, beside the program's own numbers and the TF32 control.

    python3 scripts/msp_precision_witness.py --seeds 11 12 13
        [--workload hbn_1023_msp.msp_b16_m4] [--tiny] [--check-step N]

For each seed the cell's driver sets up (its ``warm``), takes its steps
up to the check step (``--check-step``: that one, later in the solve)
and keeps the state before it, as a benchmark run does. Then the
reference takes that step in float64 (the truth), in complex64, in
complex64 with the minibatch in one block (its float32 sums in another
order) and under the TF32 control, and once more in float64 on the grid
whose frequencies are rounded to float32 as the program holds them
(``grid32``). One JSON line a seed: each number of the driver's
``compare`` for the program, ``float32``, ``float32_one_block`` and
``control`` against the truth, for the program against ``float32``, and
for the program, ``float32`` and ``control`` against ``grid32``. ``--tiny`` cuts the cell as the harness's
CPU tests do (128^2, 4 positions).
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "benchmark"), str(ROOT)]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", default="hbn_1023_msp.msp_b16_m4")
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--check-step", type=int, default=None,
                    help="the step kept (default: the driver's draw)")
    args = ap.parse_args()

    import torch

    import harness
    from reference import plain

    if args.tiny:
        sys.path.insert(0, str(ROOT / "benchmark" / "tests"))
        from conftest import tiny_cell
        cell = tiny_cell(args.workload)
    else:
        cell = harness.load_cell(args.workload)
    dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    harness._build_kernels(dev)
    mod = harness.driver_module(cell)
    f32 = plain.Precision("float32", torch.float32, torch.complex64, False)
    cfg, tr = cell.config, cell.traffic
    lrs = {"v": cfg["lr_v"], "modes": cfg["lr_probe"], "pos": cfg["lr_pos"]}
    grid = mod.ref_grid(cfg)

    class Grid32(type(grid)):
        """The grid with its frequencies rounded to float32, as the
        program holds them."""

        def kx(self):
            return super().kx().astype(np.float32).astype(np.float64)

        def ky(self):
            return super().ky().astype(np.float32).astype(np.float64)

    grid32 = Grid32(grid.lx, grid.ly, grid.lz, grid.sampling, grid.thickness)

    def ref(d, prec, block, g=grid):
        return mod.ref_msp.step(d.kept, g, cfg["voltage_eV"], lrs, prec,
                                dev, block)

    for seed in args.seeds:
        d = mod.Driver(harness.RankRun(cell=cell, seed=seed, device=dev))
        if args.check_step:
            d.check_step = args.check_step
        d.warm()
        while d.steps < d.check_step:
            d.step(d.prepare())
        got = d.outputs()
        d.release()
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        truth = ref(d, plain.TRUTH, tr["check_block"])
        truth32 = ref(d, plain.TRUTH, tr["check_block"], grid32)
        single = ref(d, f32, tr["check_block"])
        control = ref(d, plain.CONTROL, tr["check_block"])
        reads = {
            "program": mod.compare(got, truth),
            "float32": mod.compare(single, truth),
            "float32_one_block": mod.compare(
                ref(d, f32, len(d.kept["idx"])), truth),
            "control": mod.compare(control, truth),
            "program_vs_float32": mod.compare(got, single),
            "program_vs_grid32": mod.compare(got, truth32),
            "float32_vs_grid32": mod.compare(single, truth32),
            "control_vs_grid32": mod.compare(control, truth32)}
        print(json.dumps({"seed": seed, "check_step": d.check_step,
                          **reads}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
