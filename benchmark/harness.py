"""One run of one cell: set-up, the measured window, the check.

Everything a cell needs is found by name: its entry in ``BENCHMARK.json``
names the configuration (``configs/<config>.json``) and the traffic
(``traffic/<traffic>.json``, whose ``driver`` names
``drivers/<driver>.py``); ``limits/<cell>.json`` holds the limits of the
numbers that decide ``correct``; each per-layer metric is read by
``metrics/<metric>.py``; the layers are ``layers/*.json``.

A cell on several cards runs one process a card (``spawn``), each
joining the process group at ``tcp://localhost:<port>``; the parent
builds the kernels first, gathers the ranks' readings and prints the
result. A one-card cell runs in the parent.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib.util
import json
import os
import socket
import sys
import tempfile
import time
import traceback
from pathlib import Path

import numpy as np

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "pyslice_tpu")
RANK_TIMEOUT_S = 330


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int
    limits: dict
    end_to_end: list
    per_layer: list


def _reports(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    entry = next((w for w in manifest["workloads"] if w["name"] == name),
                 None)
    if entry is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    cfg_entry = next(c for c in manifest["configs"]
                     if c["name"] == entry["config"])
    bench = root / "benchmark"
    limits = bench / "limits" / f"{name}.json"
    return Cell(
        name=name,
        config=json.loads((root / cfg_entry["file"]).read_text()),
        traffic=json.loads(
            (bench / "traffic" / f"{entry['traffic']}.json").read_text()),
        chips=int(entry["chips"]),
        limits=json.loads(limits.read_text()) if limits.exists() else {},
        end_to_end=[m for m in manifest["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in manifest["per_layer"] if _reports(m, name)])


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name, the part before the first dot,
    is one of ``FORBIDDEN`` as a whole name."""
    modules = sys.modules if modules is None else modules
    return sorted(m for m in modules if m.split(".")[0] in FORBIDDEN)


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver_module(cell: Cell):
    return load_module(BENCH / "drivers" / f"{cell.traffic['driver']}.py",
                       f"bench_driver_{cell.traffic['driver']}")


class Spans:
    """Benchmark spans around calls into the program's layers: a
    ``record_function`` range for the profiler, and the host seconds of
    each call (``seconds[name]``)."""

    def __init__(self):
        self.seconds = {}

    @contextlib.contextmanager
    def __call__(self, name: str):
        import torch
        t0 = time.perf_counter()
        with torch.profiler.record_function(f"bench.{name}"):
            yield
        self.seconds.setdefault(name, []).append(time.perf_counter() - t0)


@dataclasses.dataclass
class RankRun:
    """What a driver gets: the cell, the seed, this rank's place."""
    cell: Cell
    seed: int
    device: object
    rank: int = 0
    world: int = 1
    mesh: object = None
    spans: Spans = dataclasses.field(default_factory=Spans)

    @property
    def config(self) -> dict:
        return self.cell.config

    @property
    def traffic(self) -> dict:
        return self.cell.traffic


def _sync(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _join_group(run: RankRun, port: int) -> None:
    import torch
    import torch.distributed as dist
    from pyslice_tpu_torch.parallel.mesh import make_mesh
    os.environ.update(LOCAL_RANK=str(run.rank),
                      LOCAL_WORLD_SIZE=str(run.world))
    cuda = run.device.type == "cuda"
    dist.init_process_group(
        backend="nccl" if cuda else "gloo",
        init_method=f"tcp://localhost:{port}", rank=run.rank,
        world_size=run.world, device_id=run.device if cuda else None)
    f, p = run.traffic["mesh"]
    run.mesh = make_mesh(f, p, device=run.device.type)


def _agree(run: RankRun, done: bool) -> bool:
    """Rank 0's decision, on every rank."""
    if run.world == 1:
        return done
    import torch
    import torch.distributed as dist
    flag = torch.tensor([1 if done else 0], device=run.device)
    dist.broadcast(flag, 0)
    return bool(flag.item())


def _window(run: RankRun, driver, seconds: float) -> dict:
    """Whole steps back to back until ``seconds`` of them have run (and at
    least ``check_steps``), then a synchronize, which the time includes.
    ``prepare`` draws a step's inputs before its clock starts: a driver
    whose steps leave work queued on the device draws inside ``step``."""
    import torch
    if run.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(run.device)
    steps = frames = 0
    elapsed = 0.0
    while True:
        x = driver.prepare()
        t0 = time.perf_counter()
        frames += driver.step(x)
        elapsed += time.perf_counter() - t0
        steps += 1
        if _agree(run, elapsed >= seconds
                  and steps >= run.traffic["check_steps"]):
            break
    t0 = time.perf_counter()
    _sync(run.device)
    elapsed += time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated(run.device)
            if run.device.type == "cuda" else 0)
    return {"steps": steps, "frames": frames, "seconds": elapsed,
            "peak_bytes": int(peak)}


def _profile(run: RankRun, driver, steps: int, with_stack: bool) -> tuple:
    """Trace ``steps`` whole steps (inputs drawn before the trace starts);
    (the trace's events, the frames the steps completed). The trace file
    lives in TMPDIR only while it is read."""
    import torch
    from attribution import WINDOW_SPAN, load
    acts = [torch.profiler.ProfilerActivity.CPU]
    if run.device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    inputs = [driver.prepare() for _ in range(steps)]
    frames = 0
    with torch.profiler.profile(activities=acts, with_stack=with_stack) as p:
        with torch.profiler.record_function(WINDOW_SPAN):
            for x in inputs:
                frames += driver.step(x)
            _sync(run.device)
    fd, path = tempfile.mkstemp(prefix="bench_trace_", suffix=".json")
    os.close(fd)
    try:
        p.export_chrome_trace(path)
        print(f"trace (stack {with_stack}): {os.path.getsize(path)} bytes",
              file=sys.stderr)
        return load(path), frames
    finally:
        os.unlink(path)


def _traced(run: RankRun, driver) -> dict:
    """The traced run's two passes: the device's busy time, operations,
    idle gaps and the program's spans (``program_spans.by_span``) with the
    Python tracer off; the layer attribution with it on (it slows the
    host, which would inflate the idle time)."""
    import attribution as at
    import program_spans
    tr = run.traffic
    counters0 = driver.counters()
    spans0 = {k: len(v) for k, v in run.spans.seconds.items()}
    events, frames = _profile(run, driver, tr["trace_steps"], False)
    lo, hi = at.window(events)
    dev = at.device_events(events)
    gaps = sorted(at.idle_gaps(dev, lo, hi), key=lambda g: g[0] - g[1])[:10]
    t0 = time.perf_counter()
    program = program_spans.by_span(events, lo, hi)
    labels = program_spans.gap_labels(events, gaps, lo, hi)
    out = {
        "frames": frames, "steps": tr["trace_steps"],
        "window_s": 1e-6 * (hi - lo), "busy_s": at.busy_seconds(dev, lo, hi),
        "device_ops": len(dev), "top_ops": at.top_device_ops(dev),
        "idle_gaps": [[label, 1e-6 * (b - a)]
                      for label, (a, b) in zip(labels, gaps)],
        "program": program, "program_read_s": time.perf_counter() - t0,
        "spans": {k: v[spans0.get(k, 0):]
                  for k, v in run.spans.seconds.items()},
        "counters": {k: v - counters0.get(k, 0.0)
                     for k, v in driver.counters().items()}}
    del events
    events, frames2 = _profile(run, driver, tr["stack_steps"], True)
    layers = at.load_layers(BENCH / "layers")
    per_layer, lost, lost_ops = at.attribute(events, layers)
    out.update(layer_s=per_layer, unattributed_s=lost,
               unattributed_ops=lost_ops, frames2=frames2,
               steps2=tr["stack_steps"])
    return out


def _build_kernels(device) -> tuple:
    """(seconds, compiled here) of the program's kernel build; the build
    lands in the checkout's ``pyslice_tpu_torch/ops/build/`` and later
    runs load it."""
    if device.type != "cuda":
        return 0.0, False
    from pyslice_tpu_torch.ops import fused_step
    b = fused_step.build()
    return b.seconds, bool(b.log)


def rank_main(cell: Cell, opts: dict, rank: int = 0, world: int = 1,
              port: int = 0) -> dict:
    """One rank's run; returns its readings, its outputs of the timed
    path and its share of the reference (numpy)."""
    import torch
    device = torch.device(opts["device"], rank) if opts["device"] == "cuda" \
        else torch.device("cpu")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if opts.get("patch"):
        # "<file.py>:<function>", called first in every rank: how the
        # harness's tests break the timed path underneath a run
        path, fn = opts["patch"].rsplit(":", 1)
        getattr(load_module(Path(path), "bench_patch"), fn)()
    run = RankRun(cell=cell, seed=opts["seed"], device=device, rank=rank,
                  world=world)
    stamps = [("start", time.time())]
    if world > 1:
        _join_group(run, port)
        stamps.append(("group", time.time()))
    build_s, cold = _build_kernels(device)
    stamps.append(("build", time.time()))
    driver = driver_module(cell).Driver(run)
    stamps.append(("inputs", time.time()))
    driver.warm()
    _sync(device)
    stamps.append(("warm", time.time()))
    out = {"rank": rank, "build_s": build_s, "cold_build": cold,
           "setup_end": stamps[-1][1], "stamps": stamps}
    if opts["control"]:
        from reference.plain import CONTROL
        out["outputs"] = driver.reference(CONTROL)
    else:
        if opts["trace"]:
            out["trace"] = _traced(run, driver)
            if device.type == "cuda":
                out["peak_bytes"] = int(torch.cuda.max_memory_allocated(
                    device))
        else:
            out["window"] = _window(run, driver, opts["seconds"])
        driver.drain()
        _sync(device)
        out["outputs"] = driver.outputs()
    out["forbidden"] = forbidden_modules()
    driver.release()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    from reference.plain import TRUTH
    t0 = time.perf_counter()
    out["reference"] = driver.reference(TRUTH)
    out["reference_s"] = time.perf_counter() - t0
    if world > 1:
        import torch.distributed as dist
        dist.destroy_process_group()
    return out


def _rank_entry(cell, opts, rank, world, port, queue):
    try:
        queue.put(rank_main(cell, opts, rank, world, port))
    except BaseException:
        queue.put({"rank": rank, "error": traceback.format_exc()})
        raise


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_ranks(cell: Cell, opts: dict) -> list:
    """Every rank's readings, rank order. One card: in this process."""
    if cell.chips == 1:
        return [rank_main(cell, opts)]
    import multiprocessing as mp
    import queue as queue_mod
    import torch
    _build_kernels(torch.device(opts["device"]))
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_rank_entry,
                         args=(cell, opts, r, cell.chips, port, q))
             for r in range(cell.chips)]
    for p in procs:
        p.start()
    results = []
    try:
        deadline = time.time() + RANK_TIMEOUT_S
        while len(results) < len(procs):
            try:
                results.append(q.get(timeout=max(1.0,
                                                 deadline - time.time())))
            except queue_mod.Empty:
                raise SystemExit("ranks did not report in time")
            if "error" in results[-1]:
                raise SystemExit(f"rank {results[-1]['rank']} failed:\n"
                                 f"{results[-1]['error']}")
    finally:
        for p in procs:
            p.join(timeout=30)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    return sorted(results, key=lambda r: r["rank"])


# --- the result -------------------------------------------------------


SPAN_SUMS = ("count", "host_s", "device_s", "device_ops", "ops_inclusive")


@dataclasses.dataclass
class Readings:
    """What the per-layer readers see, summed or averaged over ranks.
    ``program``: ``program_spans.by_span`` of the stack-off pass, each
    span's ``SPAN_SUMS`` summed and its ``idle_s`` averaged."""
    frames: int
    steps: int
    window_s: float
    busy_s: float
    device_ops: int
    layer_s: dict
    frames2: int
    steps2: int
    spans: dict
    counters: dict
    slice_loop_least_s: float
    program: dict = dataclasses.field(default_factory=dict)


def readings(ranks: list, least_s: float) -> Readings:
    tr = [r["trace"] for r in ranks]
    layer_s = {}
    for t in tr:
        for k, v in t["layer_s"].items():
            layer_s[k] = layer_s.get(k, 0.0) + v
    counters = {}
    for t in tr:
        for k, v in t["counters"].items():
            counters[k] = max(counters.get(k, 0.0), v)
    program = {}
    for t in tr:
        for name, v in t["program"].items():
            p = program.setdefault(name,
                                   dict.fromkeys(SPAN_SUMS + ("idle_s",), 0))
            for k in SPAN_SUMS:
                p[k] += v[k]
            p["idle_s"] += v["idle_s"] / len(tr)
    return Readings(
        frames=tr[0]["frames"], steps=tr[0]["steps"],
        window_s=float(np.mean([t["window_s"] for t in tr])),
        busy_s=float(np.mean([t["busy_s"] for t in tr])),
        device_ops=sum(t["device_ops"] for t in tr),
        layer_s=layer_s, frames2=tr[0]["frames2"], steps2=tr[0]["steps2"],
        spans=tr[0]["spans"], counters=counters,
        slice_loop_least_s=least_s, program=program)


def base_name(metric: str) -> str:
    """A metric's quantity: its name up to the first dot. Cells whose
    noise asks for another bound report the quantity under a name of its
    own (``frames_per_s.planewave``), read the same way."""
    return metric.split(".")[0]


def per_layer_metrics(cell: Cell, r: Readings) -> dict:
    out = {}
    for m in cell.per_layer:
        name = base_name(m["name"])
        value = load_module(BENCH / "metrics" / f"{name}.py",
                            f"bench_metric_{name}").read(r)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def checks_line(values: dict, limits: dict) -> tuple:
    """(correct, {name: {"value", "limit"}}) over the numbers the cell's
    limits name; a run compares at least one, and a number they name that
    the run did not read fails."""
    out = {name: {"value": values.get(name, float("nan")), "limit": limit}
           for name, limit in limits.items()}
    ok = all(np.isfinite(c["value"]) and c["value"] <= c["limit"]
             for c in out.values())
    return ok and bool(out), out


def device_info(opts: dict, chips: int) -> dict:
    import torch
    if opts["device"] != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": chips}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips}


def result(cell: Cell, opts: dict, ranks: list, t_start: float,
           mod) -> tuple:
    """(result line dict, stderr lines)."""
    from roofline import least_seconds, slice_loop_work
    lines = []
    r0 = ranks[0]
    lines.append(f"build: {r0['build_s']:.2f} s "
                 f"({'compiled' if r0['cold_build'] else 'loaded'})")
    setup_s = max(r["setup_end"] for r in ranks) - t_start
    lines.append("set-up: " + ", ".join(
        f"{k} {t - t_start:.2f} s" for k, t in r0["stamps"]))
    parts = [r["outputs"] for r in ranks]
    outputs = (mod.combine_reference(parts, cell) if opts["control"]
               else mod.combine_outputs(parts))
    ref = mod.combine_reference([r["reference"] for r in ranks], cell)
    values = mod.compare(outputs, ref)
    correct, checks = checks_line(values, cell.limits)
    lines.append("reference: " + ", ".join(
        f"rank {r['rank']} {r['reference_s']:.2f} s" for r in ranks))
    info = device_info(opts, cell.chips)
    metrics = {}
    attempted = 0
    if opts["trace"]:
        least, _ = least_seconds(*slice_loop_work(
            *mod.slice_loop_shape(cell)))
        rd = readings(ranks, least)
        metrics = per_layer_metrics(cell, rd)
        tr0 = ranks[0]["trace"]
        info.update(busy_s=rd.busy_s, window_s=rd.window_s)
        attempted = tr0["steps"] + tr0["steps2"]
        lines.append("unattributed device time: " + ", ".join(
            f"rank {r['rank']} {r['trace']['unattributed_s']:.6f} s "
            f"{json.dumps(r['trace']['unattributed_ops'])}" for r in ranks))
        lines.append("layer device seconds: " + json.dumps(rd.layer_s))
        lines.append("program spans: " + json.dumps(
            {k: {"device_s": v["device_s"], "idle_s": v["idle_s"]}
             for k, v in sorted(rd.program.items())}))
        lines.append("program spans read in: " + ", ".join(
            f"rank {r['rank']} {r['trace']['program_read_s']:.3f} s"
            for r in ranks))
        breakdown = {"device_ops": tr0["top_ops"],
                     "idle_gaps": tr0["idle_gaps"]}
        peak = max(r.get("peak_bytes", 0) for r in ranks)
    elif opts["control"]:
        peak = 0
    else:
        w0 = ranks[0]["window"]
        attempted = w0["steps"]
        peak = max(r["window"]["peak_bytes"] for r in ranks)
        e2e = {"frames_per_s": w0["frames"] / w0["seconds"],
               "peak_mem_gib": peak / 2 ** 30, "setup_s": setup_s}
        metrics = {m["name"]: {"value": e2e[base_name(m["name"])],
                               "unit": m["unit"]}
                   for m in cell.end_to_end if base_name(m["name"]) in e2e}
        lines.append(f"window: {w0['steps']} steps, {w0['frames']} frames "
                     f"in {w0['seconds']:.3f} s; setup {setup_s:.3f} s")
    info["memory_peak_bytes"] = int(peak)
    res = {"correct": correct, "attempted": attempted, "failed": 0,
           "metrics": metrics, "device": info}
    if opts["trace"]:
        res["breakdown"] = breakdown
    res["checks"] = checks
    lines += [f"reading {k} (not compared): {v!r}"
              for k, v in values.items() if k not in checks]
    lines += [f"check {k}: {v['value']!r} limit {v['limit']!r}"
              for k, v in checks.items()]
    return res, lines
