#!/usr/bin/env python3
"""Profile warm multislice-ptychography steps, or warm STEM or quick-start
frames, of a checkout's pyslice_tpu_torch on one CUDA card: device time by
kernel (torch.profiler, kernel rows), launches a step or frame, and the
device's idle share of the wall time.

    python3 scripts/profile_msp_step.py [--root DIR] [--grid 1023]
        [--stem | --quick]

--root is the checkout whose package is imported and built (by default the
one around this script); two checkouts compare in one call by running the
script on each root in turn. The workload is chip_smoke.py's phase 10:
frame 0 of an hBN monolayer filling the box (102.25 A at 1023^2, 102.35 A
at 1024^2), 64 probe positions on an 8 x 8 scan of 0.5 A, data from the
kernel forward, ``msp_reconstruct`` with batch 16 (16 positions x 14
slices a step). One call of one step warms up; then a call of STEPS
steps runs with the profiler on from the start of its first step to the
end of its last (each step ends in a synchronize, as chip_smoke.py times
them; the call's set-up and its copies back lie outside). With --stem the
workload is chip_smoke.py's phase 5 (at 1023^2 its phase 8) instead: 16
probes on a 4 x 4 grid over the box, 14 slices, k-space exit waves of one
frame through ``frame_exit_waves`` (rasterizer included), one frame to
warm up and STEPS frames profiled, each ending in a synchronize. With
--quick it is the README quick start's frame (chip_smoke.py's phases 6
and 7): one plane wave (aperture 0) on the 102.25 A box, k-space exit
waves of one frame through ``frame_exit_waves``, at 1023^2 (K6's
mixed-radix instantiation) or with --grid 1024 through ``fast_grid``
(its power-of-two one). Prints a row per kernel (ms and launches a step
or frame), the totals, and, last, one JSON object.
"""

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

STEPS = 5

# kernel name fragment -> the port's label
LABELS = (("row_pass_bwd_mr_kernel", "K8"), ("row_pass_bwd_kernel", "K7"),
          ("row_pass_mr_kernel", "K4"), ("col_pass_mr_kernel", "K5"),
          ("row_pass_kernel", "A"), ("col_pass_kernel", "B"),
          ("kconvert_kernel", "C"), ("resident", "K6"))


def label(name):
    for frag, lab in LABELS:
        if frag in name:
            return lab
    return name[:70]


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path,
                    default=Path(__file__).resolve().parent.parent)
    ap.add_argument("--grid", type=int, default=1023, choices=[1023, 1024])
    form = ap.add_mutually_exclusive_group()
    form.add_argument("--stem", action="store_true")
    form.add_argument("--quick", action="store_true")
    args = ap.parse_args()
    root = args.root.resolve()
    sys.path.insert(0, str(root))

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("profile_msp_step: no CUDA device", file=sys.stderr)
        return 2
    import pyslice_tpu_torch as pt
    from chip_smoke import hbn_box
    from pyslice_tpu_torch.analysis import ptychography as ptycho
    from pyslice_tpu_torch.ops import fused_step as fs

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    fs.build()
    lx = 102.25 if args.grid == 1023 else 102.35
    if args.stem or args.quick:
        return profile_frames(args, root, card, dev, lx)
    traj = hbn_box(lx, 1)
    calc = pt.MultisliceCalculator(device=dev)
    half = 0.5 * 0.5 * 7
    span = [0.5 * lx - half, 0.5 * lx + half]
    calc.setup(traj, aperture=30.0, voltage_eV=100e3, sampling=0.1,
               slice_thickness=0.5,
               probe_positions=pt.probe_grid(span, span, 8, 8),
               device_output=True, use_cache=False)
    if (calc.nx, calc.ny) != (args.grid, args.grid):
        print(f"expected {args.grid}^2, got {calc.nx}x{calc.ny}",
              file=sys.stderr)
        return 1
    wf = calc.run(progress=False)
    data = (wf.wavefunction_data[:, 0, :, :, 0].abs() ** 2).cpu().numpy()
    positions = np.asarray(calc.probe_positions, np.float64)
    kw = dict(n_slices=calc.nz, dz=0.5, batch=16)
    pt.msp_reconstruct(data, positions, calc.base_probe, steps=1, **kw)
    torch.cuda.synchronize()
    prof = torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA])
    window = {"steps": 0, "t0": 0.0, "s": 0.0}
    step = ptycho._MspRun.step

    def profiled_step(self, *a, **k):
        if window["steps"] == 0:
            torch.cuda.synchronize()
            for key in fs.launches:
                fs.launches[key] = 0
            prof.start()
            window["t0"] = time.perf_counter()
        out = step(self, *a, **k)
        torch.cuda.synchronize()
        window["steps"] += 1
        if window["steps"] == STEPS:
            window["s"] = time.perf_counter() - window["t0"]
            prof.stop()
        return out

    ptycho._MspRun.step = profiled_step
    try:
        pt.msp_reconstruct(data, positions, calc.base_probe,
                           steps=STEPS, **kw)
    finally:
        ptycho._MspRun.step = step
    return report(prof, window["s"], root, card,
                  f"msp step at {args.grid}^2 (16 positions x {calc.nz} "
                  f"slices)", "step", {"grid": args.grid})


def profile_frames(args, root, card, dev, lx):
    """Profile STEPS warm frames, k-space exit waves: STEM (16 probes) or
    the quick start's plane wave."""
    import torch
    import pyslice_tpu_torch as pt
    from chip_smoke import hbn_box
    from pyslice_tpu_torch.engine.pipeline import frame_exit_waves
    from pyslice_tpu_torch.ops import fused_step as fs

    calc = pt.MultisliceCalculator(device=dev)
    if args.quick:
        traj = hbn_box(102.25, STEPS + 1)
        calc.setup(traj, aperture=0.0, voltage_eV=100e3, sampling=0.1,
                   slice_thickness=0.5, device_output=True, use_cache=False,
                   fast_grid=args.grid == 1024)
    else:
        traj = hbn_box(lx, STEPS + 1)
        calc.setup(traj, aperture=30.0, voltage_eV=100e3, sampling=0.1,
                   slice_thickness=0.5,
                   probe_positions=pt.probe_grid([10, 90], [10, 90], 4, 4),
                   device_output=True, use_cache=False)
    if (calc.nx, calc.ny) != (args.grid, args.grid):
        print(f"expected {args.grid}^2, got {calc.nx}x{calc.ny}",
              file=sys.stderr)
        return 1
    probes = calc._probes_array()
    frame_exit_waves(traj.positions[0], probes, calc.spec)
    torch.cuda.synchronize()
    for key in fs.launches:
        fs.launches[key] = 0
    prof = torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA])
    prof.start()
    t0 = time.perf_counter()
    for f in range(1, STEPS + 1):
        frame_exit_waves(traj.positions[f], probes, calc.spec)
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    prof.stop()
    what = "quick-start frame" if args.quick else "STEM frame"
    return report(prof, seconds, root, card,
                  f"{what} at {calc.nx}x{calc.ny} ({calc.n_probes} "
                  f"probes x {calc.nz} slices)", "frame",
                  {"grid": args.grid, "stem": args.stem,
                   "quick": args.quick})


def report(prof, seconds, root, card, what, unit, extra):
    """Print the kernel rows of STEPS profiled steps or frames; 0."""
    import torch
    from pyslice_tpu_torch.ops import fused_step as fs
    wall_ms = 1e3 * seconds / STEPS
    launches = {k: v / STEPS for k, v in fs.launches.items() if v}
    rows = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        lab = label(e.key)
        ms, n = rows.get(lab, (0.0, 0))
        rows[lab] = (ms + 1e-3 * us / STEPS, n + e.count / STEPS)
    device_ms = sum(ms for ms, _ in rows.values())
    print(f"{what}, {STEPS} warm {unit}s; root {root}; card {card}")
    for lab, (ms, n) in sorted(rows.items(), key=lambda r: -r[1][0]):
        print(f"  {lab:70s} {ms:8.3f} ms/{unit}  {n:6.1f} launches/{unit}")
    idle = 1.0 - device_ms / wall_ms if device_ms else None
    print(f"  wall {wall_ms:.3f} ms/{unit}, device {device_ms:.3f} ms/{unit}, "
          f"idle {'not measured' if idle is None else f'{100 * idle:.1f}%'}; "
          f"kernel launches/{unit} {launches}")
    print(json.dumps({"root": str(root), "card": card, **extra,
                      "wall_ms": wall_ms, "device_ms": device_ms,
                      "idle": idle, "launches": launches,
                      "kernels": {k: {"ms": ms, "launches": n}
                                  for k, (ms, n) in rows.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
