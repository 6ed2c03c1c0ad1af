#!/usr/bin/env python3
"""The program's own spans in a trace, and the per-layer readings they give.

The program (``pyslice_tpu_torch.utils.profiling.span``) opens a
``record_function`` range named ``pyslice.<span>`` at each layer boundary
while a profiler records: ``setup``, ``setup.plan``, ``setup.probe``,
``run``, ``rasterize``, ``slice_loop``, ``slice_loop.kspace``,
``stream.block``, ``stream.fold``, ``stream.readout``,
``analysis.time_fft``, ``analysis.reduce``, ``analysis.adf``,
``collective.*``, ``msp.*``, ``adjoint``.

* ``by_span(events, lo, hi)``: per span name, inside the window [lo, hi]
  (microseconds), its instances (``count``) and inclusive host seconds
  (``host_s``); the device operations whose launch (followed by its
  ``correlation``) lies innermost in it on the launching thread
  (``device_s``, ``device_ops``), and those that lie anywhere inside it
  (``ops_inclusive``); and the window's idle gaps split by the innermost
  span the main thread was in (``idle_s``). Work and idle outside every
  program span go under ``""``. On a CPU-only trace the outermost CPU
  operators stand in for the device operations, as in
  ``attribution.attribute``.
* ``gap_labels(events, gaps, lo, hi)``: each idle gap named by what the
  host did during it, on the split ``by_span`` makes.
* ``METRICS``: the per-layer readings of a ``SpanReadings``, each None
  where its spans hold nothing. The harness reads the window's spans
  through ``by_span`` in every traced run, and the readers of
  ``metrics/*.py`` that ``BENCHMARK.json`` names take theirs from here.

    python3 benchmark/program_spans.py --workload <cell> --seed <n> \\
        [--rounds 2] [--out FILE]

runs one cell as ``run.py --trace 1`` does (set-up, the warm step), then
in turns (``--rounds`` times each) the stack-off traced pass with the
spans live and with every span replaced by the program's no-op, and once
the pass with the Python stack on. It prints, as one JSON line, each
pass's window, busy time, operations and readings (``passes``; the first
live pass whole under ``first``), the stack pass's readings
(``stack_pass``: the span readings on the trace that ``metrics/*.py``'s
twins read), those twins as the harness reads them (``twins``), and the
stack pass's device time by layer and span (``crosstab``).
"""

from __future__ import annotations

import argparse
import bisect
import collections
import dataclasses
import json
import sys
from pathlib import Path

import attribution as at

PREFIX = "pyslice."
BENCH_PREFIX = "bench."
OUTSIDE = ""


def program_spans(events) -> dict:
    """{thread: [(start, end, name)]} of the ``pyslice.*`` spans, sorted
    by start, outer first."""
    out = collections.defaultdict(list)
    for e in events:
        if e.get("cat") == "user_annotation" \
                and e.get("name", "").startswith(PREFIX):
            a, b = at._span(e)
            out[e["tid"]].append((a, b, e["name"][len(PREFIX):]))
    for spans in out.values():
        spans.sort(key=lambda s: (s[0], -s[1]))
    return dict(out)


def _work(events) -> list:
    """[(launch ts, launch thread, device start, device end, name)] of
    the device operations, or on a CPU-only trace of the outermost CPU
    operators (launched where they run)."""
    launches = {}
    for e in events:
        if e.get("cat") in at.LAUNCH_CATS \
                and "correlation" in e.get("args", {}):
            launches[e["args"]["correlation"]] = (float(e["ts"]), e["tid"])
    dev = at.device_events(events)
    if dev:
        return [launches.get(e.get("args", {}).get("correlation"),
                             (None, None)) + at._span(e) + (e["name"],)
                for e in dev]
    ops = sorted((e for e in events if e.get("cat") == "cpu_op"),
                 key=lambda e: (e["tid"], float(e["ts"]),
                                -float(e.get("dur", 0.0))))
    items, end = [], {}
    for e in ops:
        a, b = at._span(e)
        if a >= end.get(e["tid"], -1.0):
            items.append((a, e["tid"], a, b, e["name"]))
            end[e["tid"]] = b
    return items


def _stacks(spans, times) -> list:
    """For each of the sorted ``times``, the names of the spans around it,
    outermost first."""
    out, stack, i = [], [], 0
    for t in times:
        while i < len(spans) and spans[i][0] <= t:
            stack.append(spans[i])
            i += 1
        stack = [s for s in stack if s[1] > t]
        out.append([s[2] for s in stack])
    return out


def _segments(spans, lo: float, hi: float) -> list:
    """[(start, end, innermost span name or OUTSIDE)] covering [lo, hi]."""
    points = sorted({lo, hi} | {min(max(p, lo), hi)
                                for a, b, _ in spans for p in (a, b)})
    mids = [(p + q) / 2 for p, q in zip(points, points[1:])]
    names = [s[-1] if s else OUTSIDE for s in _stacks(spans, mids)]
    return [(p, q, n) for (p, q), n in zip(zip(points, points[1:]), names)]


def _parts(segs, starts, g0: float, g1: float):
    """(start, end, span name) of the pieces of [g0, g1] that the segments
    ``segs`` (``_segments``; ``starts`` their starts) cover."""
    j = max(0, bisect.bisect_right(starts, g0) - 1)
    while j < len(segs) and segs[j][0] < g1:
        a, b = max(segs[j][0], g0), min(segs[j][1], g1)
        if b > a:
            yield a, b, segs[j][2]
        j += 1


def _main_thread(events, spans: dict):
    """The thread of the benchmark's window span, else the one with the
    most program spans."""
    win = [e["tid"] for e in events if e.get("name") == at.WINDOW_SPAN
           and e.get("cat") == "user_annotation"]
    if win:
        return win[-1]
    return max(spans, key=lambda t: len(spans[t])) if spans else None


def by_span(events, lo: float, hi: float) -> dict:
    """{span name: {"count", "host_s", "device_s", "device_ops",
    "ops_inclusive", "idle_s", "top_ops"}} over the window [lo, hi]
    (microseconds); ``OUTSIDE`` holds the work and idle outside every
    program span. ``top_ops``: the span's own five longest operations by
    name, [name, seconds]."""
    spans = program_spans(events)
    out = collections.defaultdict(lambda: dict(
        count=0, host_s=0.0, device_s=0.0, device_ops=0, ops_inclusive=0,
        idle_s=0.0))
    ops = collections.defaultdict(collections.Counter)
    out[OUTSIDE]
    for thread in spans.values():
        for a, b, name in thread:
            a, b = max(a, lo), min(b, hi)
            if b > a:
                out[name]["count"] += 1
                out[name]["host_s"] += 1e-6 * (b - a)
    by_thread = collections.defaultdict(list)
    for ts, tid, a, b, op in _work(events):
        a, b = max(a, lo), min(b, hi)
        if b > a:
            by_thread[tid].append((ts, b - a, op))
    for tid, work in by_thread.items():
        work.sort(key=lambda w: (w[0] is None, w[0] or 0.0))
        timed = [w for w in work if w[0] is not None]
        stacks = _stacks(spans.get(tid, []), [w[0] for w in timed])
        stacks += [[]] * (len(work) - len(timed))
        for (_, dur, op), names in zip(work, stacks):
            own = names[-1] if names else OUTSIDE
            out[own]["device_s"] += 1e-6 * dur
            out[own]["device_ops"] += 1
            ops[own][at.short_name(op)] += 1e-6 * dur
            for name in set(names):
                out[name]["ops_inclusive"] += 1
    segs = _segments(spans.get(_main_thread(events, spans), []), lo, hi)
    starts = [s[0] for s in segs]
    for g0, g1 in at.idle_gaps(at.device_events(events), lo, hi):
        for a, b, name in _parts(segs, starts, g0, g1):
            out[name]["idle_s"] += 1e-6 * (b - a)
    return {k: dict(v, top_ops=[list(o) for o in ops[k].most_common(5)])
            for k, v in out.items()}


def _innermost(ranges, t: float):
    """The name of the range (start, end, name) around ``t`` that started
    last, or None."""
    best = None
    for a, b, name in ranges:
        if a <= t < b and (best is None or a >= best[0]):
            best = (a, name)
    return best[1] if best else None


def gap_labels(events, gaps, lo: float, hi: float) -> list:
    """A label for each idle gap (start, end) in microseconds: the
    innermost program span (``pyslice.<name>``) that held the largest part
    of the gap on the main thread, by ``by_span``'s split; where that part
    lies outside every program span, the innermost benchmark span
    (``bench.*``) at its middle; then `` / `` and the innermost CPU
    operator at the middle of the longest piece of that part."""
    spans = program_spans(events)
    segs = _segments(spans.get(_main_thread(events, spans), []), lo, hi)
    starts = [s[0] for s in segs]
    bench, ops = [], []
    for e in events:
        if e.get("cat") == "cpu_op":
            ops.append(at._span(e) + (e["name"],))
        elif e.get("cat") == "user_annotation" \
                and e.get("name", "").startswith(BENCH_PREFIX):
            bench.append(at._span(e) + (e["name"],))
    out = []
    for g0, g1 in gaps:
        held = collections.Counter()
        piece = {}
        for a, b, name in _parts(segs, starts, g0, g1):
            held[name] += b - a
            if b - a > piece.get(name, (0.0,))[0]:
                piece[name] = (b - a, (a + b) / 2)
        name = max(held, key=held.get)
        t = piece[name][1]
        head = PREFIX + name if name != OUTSIDE else _innermost(bench, t)
        parts = [p for p in (head, _innermost(ops, t)) if p]
        out.append(" / ".join(parts) if parts else "host (no operator)")
    return out


def crosstab(events, layers) -> list:
    """[[layer, span, seconds, top operations]] of the device work, each
    operation under the layer ``attribution.attribute`` gives it and under
    its innermost program span: where a layer's reading and its span
    twin part, the operations that make the difference. Largest first."""
    py = collections.defaultdict(list)
    for e in events:
        if e.get("cat") == "python_function":
            path = at.module_file(e["name"])
            a, b = at._span(e)
            py[e["tid"]].append((a, b, at.layer_of(path, layers)
                                 if path else None))
    main = max(py, key=lambda t: len(py[t])) if py else None
    spans = program_spans(events)
    work = collections.defaultdict(list)
    for ts, tid, a, b, op in _work(events):
        if ts is not None:
            work[tid].append((ts, b - a, op))
    cells = collections.defaultdict(collections.Counter)
    for tid, items in work.items():
        items.sort()
        times = [w[0] for w in items]
        frames = sorted(py.get(tid if tid in py else main, []),
                        key=lambda f: (f[0], -f[1]))
        for (_, dur, op), stack, names in zip(
                items, _stacks(frames, times),
                _stacks(spans.get(tid, []), times)):
            layer = next((x for x in reversed(stack) if x), None)
            cells[(layer, names[-1] if names else OUTSIDE)][
                at.short_name(op)] += 1e-6 * dur
    return sorted(([lay, sp, sum(c.values()), c.most_common(3)]
                   for (lay, sp), c in cells.items()),
                  key=lambda row: -row[2])


# --- the readings -----------------------------------------------------


@dataclasses.dataclass
class SpanReadings:
    """What the span readers see: the traced pass's frames, steps and
    window, the slice loop's least time a frame, and ``by_span``."""
    frames: int
    steps: int
    window_s: float
    slice_loop_least_s: float
    program: dict


def of_readings(r) -> SpanReadings:
    """The ``SpanReadings`` of the harness's ``Readings``."""
    return SpanReadings(r.frames, r.steps, r.window_s, r.slice_loop_least_s,
                        r.program)


def _sum(r: SpanReadings, names, key: str) -> float:
    return sum(r.program.get(n, {}).get(key, 0) for n in names)


def _family(r: SpanReadings, *roots) -> list:
    """The spans of ``r`` that are one of ``roots`` or lie under one
    (``<root>.*``)."""
    return [n for n in r.program
            if any(n == x or n.startswith(x + ".") for x in roots)]


def _idle_pct(r: SpanReadings, names):
    """The window's device idle under ``names``, as a share of the window;
    None where none of them is in the window."""
    if not names or r.window_s <= 0:
        return None
    return 100.0 * _sum(r, names, "idle_s") / r.window_s


def span_rasterize_ms(r):
    """Device time under ``rasterize``, a frame."""
    s = _sum(r, ["rasterize"], "device_s")
    return 1e3 * s / r.frames if s > 0 else None


def span_roofline_pct(r):
    """The slice loop's least time (``roofline.slice_loop_work``) over
    the device time under ``slice_loop`` and ``slice_loop.*``."""
    s = _sum(r, _family(r, "slice_loop"), "device_s")
    return 100.0 * r.slice_loop_least_s * r.frames / s if s > 0 else None


def span_fold_ms(r):
    """Device time under the streaming spans' own (``stream.block``: the
    block to the card; ``stream.fold``; ``stream.readout``), a frame."""
    s = _sum(r, ["stream.block", "stream.fold", "stream.readout"],
             "device_s")
    return 1e3 * s / r.frames if s > 0 else None


def span_analysis_ms(r):
    """Device time under ``analysis.*``, a job."""
    s = _sum(r, [n for n in r.program if n.startswith("analysis.")],
             "device_s")
    return 1e3 * s / r.steps if s > 0 else None


def plan_ms(r):
    """Host time in ``setup.plan`` (make_plan's binning), a job."""
    s = _sum(r, ["setup.plan"], "host_s")
    return 1e3 * s / r.steps if s > 0 else None


def setup_idle_pct(r):
    """The window's device idle under ``setup`` and ``setup.*``, as a
    share of the window."""
    return _idle_pct(r, _family(r, "setup"))


def loop_idle_pct(r):
    """The window's device idle under the frame loop (``run``,
    ``rasterize``, ``slice_loop`` and theirs), as a share of the window:
    the host's dispatch trailing the device."""
    return _idle_pct(r, _family(r, "run", "rasterize", "slice_loop"))


def analysis_idle_pct(r):
    """The window's device idle under ``analysis.*`` and
    ``collective.*``, as a share of the window."""
    return _idle_pct(r, _family(r, "analysis", "collective"))


def unspanned_idle_pct(r):
    """The window's device idle outside every program span, as a share of
    the window: the program's code that opens none (``Trajectory``, the
    calculator's constructor) and the benchmark's own work."""
    return _idle_pct(r, [OUTSIDE] if OUTSIDE in r.program else [])


def kspace_ms(r):
    """Device time under ``slice_loop.kspace`` (kernel C, or the odd and
    plain loops' ``fftshift(fft2)``), a frame."""
    s = _sum(r, _family(r, "slice_loop.kspace"), "device_s")
    return 1e3 * s / r.frames if s > 0 else None


def msp_backward_ms(r):
    """Device time under ``adjoint`` (multislice_diff's backward, on
    autograd's device thread), a step."""
    s = _sum(r, _family(r, "adjoint"), "device_s")
    return 1e3 * s / r.steps if s > 0 else None


def frame_ops_per_frame(r):
    """Device operations launched inside ``run`` or ``stream.block`` (at
    any depth), a frame."""
    n = _sum(r, ["run", "stream.block"], "ops_inclusive")
    return n / r.frames if n > 0 else None


METRICS = {f.__name__: f for f in (
    span_rasterize_ms, span_roofline_pct, span_fold_ms, span_analysis_ms,
    plan_ms, setup_idle_pct, loop_idle_pct, analysis_idle_pct,
    unspanned_idle_pct, kspace_ms, msp_backward_ms, frame_ops_per_frame)}


# --- the report -------------------------------------------------------


def spans_off() -> list:
    """Every ``span`` the program's modules imported, replaced by one that
    returns the no-op always; returns what to restore."""
    from pyslice_tpu_torch.utils import profiling
    off = lambda name: profiling._OFF  # noqa: E731
    swapped = [(m, m.span) for name, m in list(sys.modules.items())
               if name.startswith("pyslice_tpu_torch") and m is not None
               and getattr(m, "span", None) is profiling.span]
    for m, _ in swapped:
        m.span = off
    return swapped


def readings(events, frames: int, steps: int, least_s: float) -> dict:
    """A pass's window, busy time and operations, ``by_span`` and the
    readings of ``METRICS``."""
    lo, hi = at.window(events)
    dev = at.device_events(events)
    busy = at.busy_seconds(dev, lo, hi)
    prog = by_span(events, lo, hi)
    gaps = sorted(at.idle_gaps(dev, lo, hi), key=lambda g: g[0] - g[1])[:10]
    r = SpanReadings(frames, steps, 1e-6 * (hi - lo), least_s, prog)
    return {"frames": frames, "window_s": r.window_s, "busy_s": busy,
            "device_ops": len(dev),
            "metrics": {k: f(r) for k, f in METRICS.items()},
            "outside_share_of_busy": (prog[OUTSIDE]["device_s"] / busy
                                      if busy > 0 else None),
            "idle_split_s": sum(v["idle_s"] for v in prog.values()),
            "idle_s": r.window_s - busy, "program": prog,
            "idle_gaps": [[label, 1e-6 * (b - a)] for label, (a, b)
                          in zip(gap_labels(events, gaps, lo, hi), gaps)]}


def report(cell, opts: dict, rounds: int) -> dict:
    """The report of ``main`` for ``cell`` on ``opts["device"]``."""
    import harness
    from roofline import least_seconds, slice_loop_work
    import torch
    device = torch.device(opts["device"])
    run = harness.RankRun(cell=cell, seed=opts["seed"], device=device)
    harness._build_kernels(device)
    mod = harness.driver_module(cell)
    driver = mod.Driver(run)
    driver.warm()
    harness._sync(device)
    least, _ = least_seconds(*slice_loop_work(*mod.slice_loop_shape(cell)))
    tr = cell.traffic
    out = {"cell": cell.name, "seed": opts["seed"], "passes": []}
    for _ in range(rounds):
        for live in (True, False):
            swapped = [] if live else spans_off()
            try:
                events, frames = harness._profile(run, driver,
                                                  tr["trace_steps"], False)
            finally:
                for m, fn in swapped:
                    m.span = fn
            p = readings(events, frames, tr["trace_steps"], least)
            del events
            if live and "first" not in out:
                out["first"] = p
            out["passes"].append(dict(
                {k: v for k, v in p.items()
                 if k not in ("program", "idle_gaps")}, live=live))
    events, frames2 = harness._profile(run, driver, tr["stack_steps"], True)
    layers = at.load_layers(harness.BENCH / "layers")
    layer_s, lost, _ = at.attribute(events, layers)
    out["stack_pass"] = readings(events, frames2, tr["stack_steps"], least)
    out["crosstab"] = crosstab(events, layers)
    del events
    first = out["first"]
    rd = harness.Readings(
        frames=first["frames"], steps=tr["trace_steps"],
        window_s=first["window_s"], busy_s=first["busy_s"],
        device_ops=first["device_ops"], layer_s=layer_s, frames2=frames2,
        steps2=tr["stack_steps"], spans={}, counters={},
        slice_loop_least_s=least, program=first["program"])
    out["twins"] = {m["name"]: v for m in cell.per_layer
                    for v in [harness.load_module(
                        harness.BENCH / "metrics"
                        / f"{harness.base_name(m['name'])}.py",
                        "twin").read(rd)] if v is not None}
    out["layer_s"], out["unattributed_s"] = layer_s, lost
    driver.drain()
    driver.release()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    bench = Path(__file__).resolve().parent
    sys.path[:0] = [str(bench), str(bench.parent)]
    import harness
    import run as bench_run
    bench_run.fixed_caches()
    res = report(harness.load_cell(args.workload),
                 {"seed": args.seed, "device": args.device}, args.rounds)
    line = json.dumps(res)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
