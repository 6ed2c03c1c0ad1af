#!/usr/bin/env python3
"""The benchmark of pyslice_tpu_torch on NVIDIA cards.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Runs one cell of ``BENCHMARK.json`` from the root of a checkout: makes the
inputs from ``--seed``, sets up and warms the cell's own shapes, measures
whole steps for ``--seconds`` (``--trace 0``: the end-to-end metrics) or
traces a few steps (``--trace 1``: the per-layer metrics), checks what
the timed path produced against the plain reference, and prints the
result as the last line of standard output, with the numbers compared and
their limits as the last lines of standard error.

``--control 1`` puts the reference, computed in the precision below the
configuration's, in the program's place and checks it the same way: it
has to come out not correct.

Exits non-zero, printing no result, without the cards the cell asks for,
without the program beside it, or when the process has loaded JAX or the
JAX package.
"""

import argparse
import json
import os
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def process_age() -> float:
    """Seconds since this process started (from /proc, 10 ms ticks)."""
    with open("/proc/self/stat") as f:
        start = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        up = float(f.read().split()[0])
    return up - start / os.sysconf("SC_CLK_TCK")


def fixed_caches() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths,
    so that only a cell's first run there builds."""
    cache = ROOT / ".bench_cache"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(cache / sub)


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    t_start = time.time() - process_age()
    args = parse(argv)
    fixed_caches()
    os.environ["USE_FLAX"] = "0"
    sys.path[:0] = [str(BENCH), str(ROOT)]
    import harness
    cell = harness.load_cell(args.workload)
    stamps = [("interpreter", time.time())]
    import torch
    stamps.append(("torch", time.time()))
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell.chips:
        print(f"benchmark: {cell.name} needs {cell.chips} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    stamps.append(("cards", time.time()))
    try:
        import pyslice_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"benchmark: the program is missing: {e}", file=sys.stderr)
        return 2
    stamps.append(("program", time.time()))
    print("process: " + ", ".join(f"{k} {t - t_start:.2f} s"
                                  for k, t in stamps), file=sys.stderr)
    opts = {"seed": args.seed, "seconds": args.seconds, "trace": args.trace,
            "control": args.control, "device": "cuda"}
    return report(cell, opts, harness.run_ranks(cell, opts), t_start)


def report(cell, opts, ranks, t_start) -> int:
    import harness
    found = sorted(set(harness.forbidden_modules()).union(
        *(r["forbidden"] for r in ranks)))
    if found:
        print(f"benchmark: JAX or the JAX package was loaded: {found}",
              file=sys.stderr)
        return 3
    res, lines = harness.result(cell, opts, ranks, t_start,
                                harness.driver_module(cell))
    sys.stderr.write("\n".join(lines) + "\n")
    sys.stderr.flush()
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
