#!/usr/bin/env python3
"""Time the TACAW time FFT kernel (``analysis.time_fft``) on one CUDA card at
each tile width it can take, beside the plain chain and the bound, after
holding each width's output to the plain chain.

    python3 scripts/time_time_fft.py [--shapes 16x100x1023x1023 ...]
        [--logc 2 3 4 5] [--reps 10] [--rounds 5]

A shape is probes x frames x kx x ky. --logc lists the tile widths
(2^logc columns) to time; the plan's own width is marked. The plain chain
is the probe-chunked torch.fft chain with its copies into the output (the
main path before the kernel). Each timing is --rounds rounds of --reps
calls (CUDA events), the order reversed every other round, and the median
round is reported. Prints a line per (shape, width) and, last, one JSON
object.
"""

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from pyslice_tpu_torch.analysis import tacaw  # noqa: E402
from pyslice_tpu_torch.analysis import time_fft as tf  # noqa: E402

SHAPES = ["16x100x1023x1023", "1x100x1023x1023", "1x400x256x1023"]
HBM_BYTES_S = 3.35e12   # H100 SXM, HBM3 (data sheet)


def timed(fn, reps):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--shapes", nargs="+", default=SHAPES)
    ap.add_argument("--logc", nargs="+", type=int, default=[2, 3, 4, 5])
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--rounds", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("time_time_fft: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    result = {"card": card, "shapes": {}}
    for label in args.shapes:
        shape = tuple(int(v) for v in label.split("x"))
        P, T, nx, ny = shape
        x = torch.randn(shape, dtype=torch.complex64, device=dev,
                        generator=g) * 0.1 + (0.6 + 0.3j)
        out = torch.empty(shape, dtype=torch.float32, device=dev)
        want = tacaw._time_fft_block(x[:1])
        step = tacaw.probe_chunk(T * nx * ny)

        def plain():
            if step >= P:
                return tacaw._time_fft_block(x)
            for i in range(0, P, step):
                out[i:i + step] = tacaw._time_fft_block(x[i:i + step])

        ways = {"plain": plain}
        own = tf.plan(T).logc
        for logc in sorted(set(args.logc) | {own}):
            if tf.smem(T, logc) > 232448 or not 0 <= logc <= tf.MAX_LOGC:
                continue
            info = tf._launch(x, out, logc)
            torch.cuda.synchronize()
            rel = ((out[:1] - want).abs().max() / want.abs().max()).item()
            print(f"  {label} logc {logc}{' (plan)' if logc == own else ''}: "
                  f"info {info}, max|d|/max|ref| against plain {rel:.2e}")
            if rel > 1e-4:
                raise SystemExit(f"{label} logc {logc} disagrees: {rel}")
            ways[f"logc{logc}"] = (lambda c=logc: tf._launch(x, out, c))
        for fn in ways.values():
            fn()
        torch.cuda.synchronize()
        rounds = {k: [] for k in ways}
        for r in range(args.rounds):
            order = list(ways) if r % 2 == 0 else list(ways)[::-1]
            for k in order:
                rounds[k].append(timed(ways[k], args.reps))
        bound = 1e3 * P * T * nx * ny * 12 / HBM_BYTES_S
        rec = {k: statistics.median(v) for k, v in rounds.items()}
        rec["bound_ms"] = bound
        rec["plan_logc"] = own
        for k, ms in rec.items():
            if k.startswith("logc") or k == "plain":
                print(f"  {label} {k}: {ms:.4f} ms "
                      f"({100 * bound / ms:.1f}% of the {bound:.4f} ms "
                      "bound)")
        result["shapes"][label] = rec
        del x, out, want
        torch.cuda.empty_cache()
    print(card)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
