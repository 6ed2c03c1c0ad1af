#!/usr/bin/env python3
"""Time kernel K5 of a checkout's pyslice_tpu_torch on one CUDA card: the
mixed-radix column pass ``col_pass_mr`` (ops/fused_step_odd.py), in place,
after holding it to its plain torch.fft version.

    python3 scripts/time_col_pass_mr.py [--root DIR] [--shapes 16x1023 32x1023]
        [--shift] [--reps 20] [--rounds 5]

--root is the checkout whose package is imported and built (by default the
one around this script). The kernel runs through that checkout's own
wrapper, so two versions of K5 compare whatever their C interface. To
compare with another commit, unpack it into a git-ignored directory
(``git archive <commit> | tar -x -C build/parent``) and run the script on
each root in turn: parent, this, this, parent. --shift places the wave one
complex64 element (8 bytes) past a 16-byte boundary. A shape PxN is P
planes of N^2; it is timed over --rounds rounds of --reps launches (CUDA
events), and the median round is reported. Prints a line per shape and,
last, one JSON object.
"""

import argparse
import json
import math
import subprocess
import sys
from pathlib import Path

MAX_REL, MAX_RESIDUAL = 1e-4, 1e-6     # the bars of chip_smoke.py


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path,
                    default=Path(__file__).resolve().parent.parent)
    ap.add_argument("--shapes", nargs="+", default=["16x1023", "32x1023"])
    ap.add_argument("--shift", action="store_true")
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
    result = {"root": str(root), "card": card, "shift": args.shift, "k5": {}}
    for spec in args.shapes:
        P, n = (int(x) for x in spec.split("x"))
        store = torch.empty(P * n * n + 1, dtype=torch.complex64, device=dev)
        psi = (store[1:] if args.shift else store[:-1]).view(P, n, n)
        psi.copy_(torch.randn((P, n, n), dtype=torch.complex64, device=dev,
                              generator=g))
        phase = torch.rand((n, n), device=dev, generator=g) * (2 * math.pi)
        prop = torch.polar(torch.ones_like(phase), phase)
        want = fs._plain_col_pass(psi, prop)
        fo.col_pass_mr(psi, prop, out=psi)
        rel = ((psi - want).abs().max() / want.abs().max()).item()
        res = (((psi.abs() - want.abs()) ** 2).sum()
               / (want.abs() ** 2).sum()).item()
        del want
        if not (rel <= MAX_REL and res <= MAX_RESIDUAL):
            print(f"K5 at {spec}: max|d|/max|ref| {rel:.3e}, residual "
                  f"{res:.3e}, over the bars", file=sys.stderr)
            return 1

        def run():
            fo.col_pass_mr(psi, prop, out=psi)

        run()
        n0 = fs.launches["k5"]
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        times = []
        for _ in range(args.rounds):
            start.record()
            for _ in range(args.reps):
                run()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / args.reps)
        if fs.launches["k5"] - n0 != args.rounds * args.reps:
            print(f"K5 at {spec}: the kernel was not launched",
                  file=sys.stderr)
            return 1
        ms = sorted(times)[len(times) // 2]
        plan = dict(getattr(fo, "last_launch", {}))
        print(f"K5 at {P}x{n}^2{' shifted' if args.shift else ''}: "
              f"{ms:.4f} ms (median of {args.rounds} rounds of {args.reps}, "
              f"{min(times):.4f}..{max(times):.4f}); max|d|/max|ref| "
              f"{rel:.2e}, residual {res:.2e}; plan {plan}; root {root}; "
              f"card {card}")
        result["k5"][spec] = {"ms": ms, "rounds_ms": times,
                              "max_rel": rel, "residual": res, "plan": plan}
        del psi, store
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
