"""Readings from a ``torch.profiler`` trace (its Chrome-trace export).

* ``window`` / ``busy_seconds`` / ``idle_gaps``: the device's busy time
  inside the benchmark's window span (``WINDOW_SPAN``), and its idle gaps
  (``program_spans.gap_labels`` names them).
* ``attribute``: device time per layer. Each device operation is
  followed to the call that launched it (its ``correlation`` id), and
  the launch to the innermost Python frame (``python_function`` events
  of a ``with_stack=True`` trace) whose file lies in a layer's module
  list. On a CPU-only trace the outermost CPU operators stand in for the
  device operations. The layers come from ``benchmark/layers/*.json``.
"""

from __future__ import annotations

import bisect
import collections
import json
from pathlib import Path

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
WINDOW_SPAN = "bench.window"


def load(path) -> list:
    with open(path) as f:
        data = json.load(f)
    return [e for e in data.get("traceEvents", [])
            if e.get("ph") == "X" and "ts" in e]


def _span(e):
    return float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))


def window(events):
    """(start, end) in microseconds of the last ``WINDOW_SPAN`` span."""
    spans = [_span(e) for e in events if e.get("name") == WINDOW_SPAN
             and e.get("cat") == "user_annotation"]
    if not spans:
        raise ValueError(f"trace has no {WINDOW_SPAN} span")
    return spans[-1]


def device_events(events) -> list:
    return [e for e in events if e.get("cat") in DEVICE_CATS]


def merged(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def busy_seconds(dev_events, lo: float, hi: float) -> float:
    """Seconds in [lo, hi] (microseconds) with a device operation."""
    clipped = [(max(a, lo), min(b, hi)) for a, b in map(_span, dev_events)]
    return 1e-6 * sum(b - a for a, b in merged(
        [(a, b) for a, b in clipped if b > a]))


def idle_gaps(dev_events, lo: float, hi: float) -> list:
    """[(start, end)] microseconds of [lo, hi] with no device operation."""
    gaps, t = [], lo
    for a, b in merged([_span(e) for e in dev_events]):
        if b <= lo or a >= hi:
            continue
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if hi > t:
        gaps.append((t, hi))
    return gaps


def top_device_ops(dev_events, n: int = 10) -> list:
    total = collections.Counter()
    for e in dev_events:
        total[short_name(e["name"])] += 1e-6 * float(e.get("dur", 0.0))
    return [[k, v] for k, v in total.most_common(n)]


def short_name(name: str) -> str:
    """A kernel's name without ``void`` and its argument list, at most
    120 characters."""
    s = name[5:] if name.startswith("void ") else name
    depth = 0
    for i in range(len(s) - 1, -1, -1) if s.endswith(")") else ():
        depth += {")": 1, "(": -1}.get(s[i], 0)
        if depth == 0:
            s = s[:i]
            break
    return (s or name)[:120]


def module_file(py_name: str):
    """The file of a ``python_function`` event name, ``file.py(line):
    function``; None for built-ins."""
    head = py_name.split("(", 1)[0]
    return head.replace("\\", "/") if head.endswith(".py") else None


def layer_of(path: str, layers) -> str | None:
    """The layer whose module list holds ``path``: an entry ending in
    ``/`` is a directory, any other a file, both relative to the repo."""
    p = "/" + path
    for name, modules in layers:
        for m in modules:
            if (m.endswith("/") and "/" + m in p) or p.endswith("/" + m):
                return name
    return None


def load_layers(directory) -> list:
    """[(layer name, [module entries])] of the layers that take device
    time (``"device_time": true``), from ``<directory>/*.json``."""
    out = []
    for f in sorted(Path(directory).glob("*.json")):
        spec = json.loads(f.read_text())
        if spec.get("device_time"):
            out.append((spec["name"], list(spec["modules"])))
    return out


def _work_items(events):
    """[(launch ts, launch tid, seconds, name)] of the device work: device
    operations at their launches, or on a CPU-only trace the outermost CPU
    operators."""
    launches = {}
    for e in events:
        if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {}):
            launches[e["args"]["correlation"]] = (float(e["ts"]), e["tid"])
    dev = device_events(events)
    if dev:
        items = []
        for e in dev:
            ts, tid = launches.get(e.get("args", {}).get("correlation"),
                                   (None, None))
            items.append((ts, tid, 1e-6 * float(e.get("dur", 0.0)),
                          e["name"]))
        return items
    ops = sorted((e for e in events if e.get("cat") == "cpu_op"),
                 key=lambda e: (e["tid"], float(e["ts"]),
                                -float(e.get("dur", 0.0))))
    items, end = [], {}
    for e in ops:
        a, b = _span(e)
        if a >= end.get(e["tid"], -1.0):
            items.append((a, e["tid"], 1e-6 * (b - a), e["name"]))
            end[e["tid"]] = b
    return items


def attribute(events, layers):
    """({layer: device seconds}, unattributed seconds, {name: seconds} of
    the unattributed operations)."""
    py = collections.defaultdict(list)
    for e in events:
        if e.get("cat") == "python_function":
            path = module_file(e["name"])
            a, b = _span(e)
            py[e["tid"]].append((a, -b, b, layer_of(path, layers)
                                 if path else None))
    main_tid = max(py, key=lambda t: len(py[t])) if py else None
    items = collections.defaultdict(list)
    per_layer = collections.Counter()
    lost = collections.Counter()
    for ts, tid, sec, name in _work_items(events):
        if ts is None or main_tid is None:
            lost[short_name(name)] += sec
            continue
        items[tid if tid in py else main_tid].append((ts, sec, name))
    for tid, work in items.items():
        frames = sorted(py[tid])
        starts = [f[0] for f in frames]
        stack, i = [], 0
        for ts, sec, name in sorted(work):
            j = bisect.bisect_right(starts, ts)
            for a, _, b, layer in frames[i:j]:
                while stack and stack[-1][0] <= a:
                    stack.pop()
                stack.append((b, layer))
            i = max(i, j)
            while stack and stack[-1][0] < ts:
                stack.pop()
            layer = next((lay for _, lay in reversed(stack) if lay), None)
            if layer is None:
                lost[short_name(name)] += sec
            else:
                per_layer[layer] += sec
    return dict(per_layer), sum(lost.values()), dict(lost.most_common(10))
