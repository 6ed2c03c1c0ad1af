#!/usr/bin/env python3
"""Time the slice-step kernels of a checkout's pyslice_tpu_torch on one CUDA
card, each after holding it to its plain torch.fft version: A and B (the
power-of-two row and column passes ``row_pass``, ``col_pass``), K4 (the
mixed-radix row pass ``row_pass_mr``), K5 (the column pass
``col_pass_mr``), K6 (the resident slice loop ``resident_loop``), K7 and
K8 (the adjoint's backward row passes ``row_pass_bwd`` on power-of-two
axes and ``row_pass_mr_bwd``).

    python3 scripts/time_col_pass_mr.py [--root DIR]
        [--kernels a b k4 k5 k6 k7 k8]
        [--mode mid] [--phase] [--shapes 16x1023 32x1023] [--plain]
        [--shift] [--nz 14] [--kspace] [--reps 20] [--rounds 5]

--root is the checkout whose package is imported and built (by default the
one around this script). Each kernel runs through that checkout's own
wrapper, so two versions compare whatever their C interface. To compare
with another commit, unpack it into a git-ignored directory
(``git archive <commit> | tar -x -C build/parent``) and run the script on
each root in turn: parent, this, this, parent.

A shape PxN is P planes of N^2 for A, B, K4 and K5, P probes of N^2
through --nz slices for K6, and P pairs (2P planes) of N^2 for K7 and
K8; PxNxM has N rows of M instead of N^2. --mode is A's and K4's mode and
K7's and K8's (``mid`` or ``last``); in ``mid`` mode A, K4, K7 and K8 run
in place, in the others they write a second buffer (B and K5 always run
in place). --phase hands A, K4, K6, K7 and K8 the transmission as the
float32 phase sigma*V (cos/sin taken in the kernel) instead of the complex
plane; --kspace has K6 end in k space. Where the checkout's K6 has a
barrier floor (``fused_step_resident.barrier_floor``: the launch's grid
barriers alone), it is timed in the same rounds as K6.
--plain times the plain version too, in the same rounds (the order
reversed every other round), for the routing rule of
``fused_step_odd.kernel_preferred_mr``. --shift places the wave one
complex64 element (8 bytes) past a 16-byte boundary (the 8-byte copy path
of B and K5 on an even N). Each timing is --rounds rounds of --reps
launches (CUDA events), and the median round is reported. Prints a line
per (kernel, shape) and, last, one JSON object.
"""

import argparse
import json
import math
import subprocess
import sys
from pathlib import Path

MAX_REL, MAX_RESIDUAL = 1e-4, 1e-6     # the bars of chip_smoke.py


def errors(got, want):
    """(max|d|/max|ref|, magnitude residual)."""
    rel = ((got - want).abs().max() / want.abs().max()).item()
    f, r = got.abs().double(), want.abs().double()
    return rel, (((f - r) ** 2).sum() / (r ** 2).sum()).item()


def case(kernel, mode, phase_t, P, n, nz, shift, dev, g, kspace=False):
    """(run the kernel, run the plain version, [(got, want, vbar?)...]) of
    one kernel at one shape: the checks compare a kernel call that writes
    a new buffer with its plain version on the same inputs."""
    import torch
    from pyslice_tpu_torch.core.constants import interaction_parameter
    from pyslice_tpu_torch.ops import fused_step as fs
    from pyslice_tpu_torch.ops import fused_step_odd as fo

    nx, ny = n
    planes = 2 * P if kernel in ("k7", "k8") else P
    store = torch.empty(planes * nx * ny + 1, dtype=torch.complex64,
                        device=dev)
    psi = (store[1:] if shift else store[:-1]).view(planes, nx, ny)
    psi.copy_(torch.randn((planes, nx, ny), dtype=torch.complex64,
                          device=dev, generator=g))
    phase = torch.rand((nx, ny), device=dev, generator=g) * (2 * math.pi)
    plane = torch.polar(torch.ones_like(phase), phase)
    t = phase if phase_t else plane
    out = psi if mode == "mid" else torch.empty_like(psi)
    if kernel == "a":
        return (lambda: fs.row_pass(mode, psi, t, out=out),
                lambda: fs._plain_row_pass(mode, psi, t),
                [(fs.row_pass(mode, psi, t),
                  fs._plain_row_pass(mode, psi, t), False)])
    if kernel == "b":
        return (lambda: fs.col_pass(psi, plane, out=psi),
                lambda: fs._plain_col_pass(psi, plane),
                [(fs.col_pass(psi, plane),
                  fs._plain_col_pass(psi, plane), False)])
    if kernel == "k4":
        return (lambda: fo.row_pass_mr(mode, psi, t, out=out),
                lambda: fs._plain_row_pass(mode, psi, t),
                [(fo.row_pass_mr(mode, psi, t),
                  fs._plain_row_pass(mode, psi, t), False)])
    if kernel == "k5":
        return (lambda: fo.col_pass_mr(psi, plane, out=psi),
                lambda: fs._plain_col_pass(psi, plane),
                [(fo.col_pass_mr(psi, plane),
                  fs._plain_col_pass(psi, plane), False)])
    if kernel == "k6":
        from pyslice_tpu_torch.ops import fused_step_resident as fr
        v = torch.randn((nz, nx, ny), device=dev, generator=g) * 20.0
        t = v if phase_t else torch.polar(torch.ones_like(v), v)
        return (lambda: fr.resident_loop(psi, t, plane, kspace),
                lambda: fr._plain_resident_loop(psi, t, plane, kspace),
                [(fr.resident_loop(psi, t, plane, kspace),
                  fr._plain_resident_loop(psi, t, plane, kspace), False)])
    from pyslice_tpu_torch.ops import fused_step_adjoint as fa
    sigma = interaction_parameter(100e3)
    if mode not in fa.BWD_MODES:
        raise SystemExit(f"K7 and K8 take --mode "
                         f"{' or '.join(fa.BWD_MODES)}")
    row_bwd = fa.row_pass_bwd if kernel == "k7" else fa.row_pass_mr_bwd
    t = None if mode == "last" else t
    vb = torch.empty((nx, ny), device=dev)
    got = row_bwd(mode, psi, t, sigma)
    want = fa._plain_row_pass_bwd(mode, psi, t, sigma)
    return (lambda: row_bwd(mode, psi, t, sigma, out=out, vbar=vb),
            lambda: fa._plain_row_pass_bwd(mode, psi, t, sigma),
            [(got[0], want[0], False), (got[1], want[1], True)])


def timed(fns, reps, rounds):
    """Median ms a call of each function, over rounds of reps calls, the
    functions in turns (order reversed every other round)."""
    import torch
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    times = [[] for _ in fns]
    for r in range(rounds):
        order = range(len(fns)) if r % 2 == 0 else reversed(range(len(fns)))
        for i in order:
            start.record()
            for _ in range(reps):
                fns[i]()
            end.record()
            end.synchronize()
            times[i].append(start.elapsed_time(end) / reps)
    return [(sorted(ts)[len(ts) // 2], ts) for ts in times]


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path,
                    default=Path(__file__).resolve().parent.parent)
    ap.add_argument("--kernels", nargs="+", default=["k5"],
                    choices=["a", "b", "k4", "k5", "k6", "k7", "k8"])
    ap.add_argument("--mode", default="mid",
                    choices=["first", "mid", "last", "only"])
    ap.add_argument("--shapes", nargs="+", default=["16x1023", "32x1023"])
    ap.add_argument("--phase", action="store_true")
    ap.add_argument("--plain", action="store_true")
    ap.add_argument("--shift", action="store_true")
    ap.add_argument("--nz", type=int, default=14)
    ap.add_argument("--kspace", action="store_true")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=5)
    args = ap.parse_args()
    root = args.root.resolve()
    sys.path.insert(0, str(root))

    import torch
    if not torch.cuda.is_available():
        print("time_col_pass_mr: no CUDA device", file=sys.stderr)
        return 2
    from pyslice_tpu_torch.ops import fused_step as fs
    from pyslice_tpu_torch.ops import fused_step_odd as fo

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    result = {"root": str(root), "card": card, "shift": args.shift,
              "mode": args.mode, "phase": args.phase, "nz": args.nz}
    for kernel in args.kernels:
        result[kernel] = {}
        for spec in args.shapes:
            P, *n = (int(x) for x in spec.split("x"))
            n = (n * 2)[:2]
            run, plain, checks = case(kernel, args.mode, args.phase, P, n,
                                      args.nz, args.shift, dev, g,
                                      args.kspace)
            torch.cuda.synchronize()
            errs = []
            for got, want, rel_only in checks:
                rel, res = errors(got, want)
                errs.append((rel, res))
                if not (rel <= MAX_REL and (rel_only or res <= MAX_RESIDUAL)):
                    print(f"{kernel} at {spec}: max|d|/max|ref| {rel:.3e}, "
                          f"residual {res:.3e}, over the bars",
                          file=sys.stderr)
                    return 1
            del checks
            n0 = fs.launches[kernel]
            fns = [run, plain] if args.plain else [run]
            floor = None
            if kernel == "k6":
                from pyslice_tpu_torch.ops import fused_step_resident as fr
                floor = getattr(fr, "barrier_floor", None)
                run()
                plan = dict(fr.last_launch)
                if floor is not None:
                    fns.append(floor)
            else:
                plan = None
            (ms, ts), *rest = timed(fns, args.reps, args.rounds)
            want = args.rounds * args.reps + 1 + (kernel == "k6")
            if fs.launches[kernel] - n0 != want:
                print(f"{kernel} at {spec}: the kernel was not launched",
                      file=sys.stderr)
                return 1
            if plan is None:
                plan = dict(getattr(fs, "last_launch", getattr(
                    fo, "last_launch", {})).get(kernel, {}))
            entry = {"ms": ms, "rounds_ms": ts, "max_rel": errs[0][0],
                     "residual": errs[0][1], "plan": plan}
            form = (f"{args.mode}{' phase' if args.phase else ''} "
                    if kernel in ("a", "k4", "k7", "k8") else
                    f"{'phase ' if args.phase else ''}"
                    f"{'kspace ' if args.kspace else ''}"
                    if kernel == "k6" else "")
            line = (f"{kernel} {form}at {spec}"
                    f"{'^2' if spec.count('x') == 1 else ''}"
                    f"{' shifted' if args.shift else ''}: {ms:.4f} ms")
            if floor is not None:
                entry["barrier_ms"], entry["barrier_rounds_ms"] = rest.pop()
                line += f", barrier floor {entry['barrier_ms']:.4f} ms"
            if rest:
                entry["plain_ms"], entry["plain_rounds_ms"] = rest[0]
                line += f", plain {entry['plain_ms']:.4f} ms"
            print(f"{line} (median of {args.rounds} rounds of {args.reps}, "
                  f"{min(ts):.4f}..{max(ts):.4f}); max|d|/max|ref| "
                  f"{errs[0][0]:.2e}, residual {errs[0][1]:.2e}; plan {plan}; "
                  f"root {root}; card {card}")
            result[kernel][spec] = entry
            del run, plain
            torch.cuda.empty_cache()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
