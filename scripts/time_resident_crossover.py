#!/usr/bin/env python3
"""Time the resident slice loop K6 against the two-pass chain on one CUDA
card, at the probe counts where the dispatch's crossover
(``fused_step_resident.resident_preferred``) decides between them.

    python3 scripts/time_resident_crossover.py [--root DIR]
        [--grids 1024 1023] [--probes 1 2 4 8] [--nz 14] [--reps 10]
        [--rounds 5]

--root is the checkout whose package is imported and built (by default the
one around this script). At each grid and probe count the two k-space
entry points that ``physics.propagate`` dispatches to run on the same
seeded inputs: K6 (``fused_multislice_kspace_resident`` on a power-of-two
grid, ``fused_multislice_kspace_odd_resident`` otherwise) and the chain
(A/B/C ``fused_multislice_kspace``, or K4/K5 ``fused_multislice_odd`` and
a torch.fft conversion, as ``engine.pipeline`` runs it), each call taking
its transmission stack and Fresnel plane as the pipeline's does. The two
outputs are held to each other (max|d|/max|ref| <= 1e-4), then timed in
turns: --rounds rounds of --reps calls each (CUDA events), the order
reversed every other round. Prints a line per (grid, probes) with both
medians and every round, and, last, one JSON object.
"""

import argparse
import json
import subprocess
import sys
from pathlib import Path


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path,
                    default=Path(__file__).resolve().parent.parent)
    ap.add_argument("--grids", nargs="+", type=int, default=[1024, 1023])
    ap.add_argument("--probes", nargs="+", type=int, default=[1, 2, 4, 8])
    ap.add_argument("--nz", type=int, default=14)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--rounds", type=int, default=5)
    args = ap.parse_args()
    root = args.root.resolve()
    sys.path.insert(0, str(root))

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("time_resident_crossover: no CUDA device", file=sys.stderr)
        return 2
    from pyslice_tpu_torch.core.constants import (interaction_parameter,
                                                  wavelength)
    from pyslice_tpu_torch.ops import fused_step as fs
    from pyslice_tpu_torch.ops import fused_step_odd as fo
    from pyslice_tpu_torch.ops import fused_step_odd_resident as fodr
    from pyslice_tpu_torch.ops import fused_step_resident as fr

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    fs.build()
    kw = dict(sigma=interaction_parameter(100e3), lam=wavelength(100e3),
              dz=0.5)
    g = torch.Generator(device=dev).manual_seed(0)

    def odd_chain(psi, v, kxs, kys, **k):
        out = fo.fused_multislice_odd(psi, v, kxs, kys, **k)
        return torch.fft.fftshift(torch.fft.fft2(out), dim=(-2, -1))

    result = {"root": str(root), "card": card, "nz": args.nz}
    for n in args.grids:
        pow2 = fs.supported_size(n)
        k6 = (fr.fused_multislice_kspace_resident if pow2
              else fodr.fused_multislice_kspace_odd_resident)
        chain = fs.fused_multislice_kspace if pow2 else odd_chain
        kxs = np.fft.fftfreq(n, 0.1)
        v = torch.rand((args.nz, n, n), device=dev, generator=g) * 30.0
        for P in args.probes:
            psi = torch.randn((P, n, n), dtype=torch.complex64, device=dev,
                              generator=g)
            fns = [lambda: k6(psi, v, kxs, kxs, **kw),
                   lambda: chain(psi, v, kxs, kxs, **kw)]
            a, b = fns[0](), fns[1]()
            torch.cuda.synchronize()
            rel = ((a - b).abs().max() / b.abs().max()).item()
            if rel > 1e-4:
                print(f"{n}^2 x {P}: K6 and the chain disagree ({rel:.2e})",
                      file=sys.stderr)
                return 1
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            times = [[], []]
            for r in range(args.rounds):
                for i in ((0, 1) if r % 2 == 0 else (1, 0)):
                    start.record()
                    for _ in range(args.reps):
                        fns[i]()
                    end.record()
                    end.synchronize()
                    times[i].append(start.elapsed_time(end) / args.reps)
            med = [sorted(t)[len(t) // 2] for t in times]
            wins = sum(x < y for x, y in zip(*times))
            print(f"{n}^2 x {P} probes x {args.nz} slices: K6 {med[0]:.4f} "
                  f"ms, chain {med[1]:.4f} ms (K6 faster in {wins} of "
                  f"{args.rounds} rounds; K6 {[round(x, 4) for x in times[0]]}"
                  f", chain {[round(x, 4) for x in times[1]]}); "
                  f"resident_preferred {fr.resident_preferred(P, n, n)}; "
                  f"card {card}")
            result[f"{n}x{P}"] = {"k6_ms": med[0], "chain_ms": med[1],
                                  "k6_rounds_ms": times[0],
                                  "chain_rounds_ms": times[1],
                                  "max_rel": rel}
            del psi, a, b
            torch.cuda.empty_cache()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
