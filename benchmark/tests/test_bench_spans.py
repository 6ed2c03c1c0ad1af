"""The program's spans in a trace (``program_spans.by_span``), the readings
they give, and the old readers, which they must not move."""

import json

import numpy as np
import pytest
import torch

import attribution as at
import harness
import program_spans as ps
from conftest import BENCH, tiny_cell

LAYERS = at.load_layers(BENCH / "layers")


def _x(name, cat, ts, dur, tid=1, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "tid": tid, "pid": 1, "args": args}


def _annotation(name, ts, dur, tid=1):
    return _x(ps.PREFIX + name, "user_annotation", ts, dur, tid)


BASE = [
    _x(at.WINDOW_SPAN, "user_annotation", 0, 200),
    _x("pyslice_tpu_torch/engine/calculator.py(300): run",
       "python_function", 10, 100),
    _x("pyslice_tpu_torch/physics/potential.py(300): rasterize",
       "python_function", 12, 8),
    _x("pyslice_tpu_torch/engine/pipeline.py(80): exit_waves",
       "python_function", 20, 30),
    _x("cudaLaunchKernel", "cuda_runtime", 14, 1, correlation=1),
    _x("cudaLaunchKernel", "cuda_runtime", 22, 1, correlation=2),
    _x("cudaLaunchKernel", "cuda_runtime", 55, 1, correlation=3),
    _x("cudaMemcpyAsync", "cuda_runtime", 120, 1, correlation=4),
    _x("cudaLaunchKernel", "cuda_runtime", 125, 1, correlation=5, tid=2),
    _x("gemm", "kernel", 15, 10, tid=7, correlation=1),
    _x("k4_pass", "kernel", 30, 40, tid=7, correlation=2),
    _x("copy", "gpu_memcpy", 75, 5, tid=7, correlation=3),
    _x("h2d", "gpu_memcpy", 121, 2, tid=7, correlation=4),
    _x("other", "kernel", 126, 4, tid=7, correlation=5),
]
SPANS = [_annotation("run", 10, 100), _annotation("rasterize", 12, 8),
         _annotation("slice_loop", 20, 30), _annotation("setup", 115, 60),
         _annotation("setup.plan", 118, 40)]


def test_by_span_follows_launches_to_the_innermost_span():
    got = ps.by_span(BASE + SPANS, 0, 200)
    assert got["rasterize"]["device_s"] == pytest.approx(10e-6)
    assert got["slice_loop"]["device_s"] == pytest.approx(40e-6)
    # the copy launched in run after the slice loop is run's own
    assert got["run"]["device_s"] == pytest.approx(5e-6)
    assert got["run"]["device_ops"] == 1
    assert got["run"]["ops_inclusive"] == 3
    # a launch inside setup.plan, and one on a thread with no spans
    assert got["setup.plan"]["device_ops"] == 1
    assert got[ps.OUTSIDE]["device_s"] == pytest.approx(4e-6)
    assert got["setup"]["device_ops"] == 0
    assert got["setup"]["ops_inclusive"] == 1
    assert got["run"]["host_s"] == pytest.approx(100e-6)
    assert got["setup.plan"]["count"] == 1


def test_by_span_splits_the_idle_gaps_by_the_main_threads_span():
    events = BASE + SPANS
    got = ps.by_span(events, 0, 200)
    # gaps [0, 15) [25, 30) [70, 75) [80, 121) [123, 126) [130, 200)
    # against run [10, 110) rasterize [12, 20) slice_loop [20, 50)
    # setup [115, 175) setup.plan [118, 158) on the window's thread
    want = {ps.OUTSIDE: 10 + 5 + 25, "run": 2 + 5 + 30, "rasterize": 3,
            "slice_loop": 5, "setup": 3 + 17, "setup.plan": 3 + 3 + 28}
    assert {k: v["idle_s"] for k, v in got.items()} == pytest.approx(
        {k: 1e-6 * v for k, v in want.items()}, abs=1e-12)
    lo, hi = at.window(events)
    total = 1e-6 * (hi - lo) - at.busy_seconds(at.device_events(events),
                                                lo, hi)
    assert sum(v["idle_s"] for v in got.values()) == pytest.approx(
        total, abs=1e-9)


def test_by_span_idle_parts_sum_to_the_windows_idle():
    rng = np.random.default_rng(5)
    events = [_x(at.WINDOW_SPAN, "user_annotation", 0, 1000)]
    t = 0.0
    for i in range(40):
        a = t + rng.uniform(0, 10)
        b = a + rng.uniform(1, 20)
        events.append(_annotation(["run", "setup", "analysis.reduce"][i % 3],
                                  a, b - a))
        events.append(_annotation("rasterize", a + 0.5, (b - a) / 3))
        events.append(_x("cudaLaunchKernel", "cuda_runtime", a + 0.6, 0.1,
                         correlation=i))
        events.append(_x("k", "kernel", a + rng.uniform(0, 30),
                         rng.uniform(0.5, 15), tid=7, correlation=i))
        t = b
    got = ps.by_span(events, 0, 1000)
    dev = at.device_events(events)
    idle = 1e-3 - at.busy_seconds(dev, 0, 1000)
    assert sum(v["idle_s"] for v in got.values()) == pytest.approx(
        idle, abs=1e-9)
    assert sum(v["device_ops"] for v in got.values()) == 40


def _readings(events):
    """Every old reader's value on ``events`` (the layer attribution
    standing in for the stack pass as well)."""
    lo, hi = at.window(events)
    dev = at.device_events(events)
    layer_s, _, _ = at.attribute(events, LAYERS)
    r = harness.Readings(
        frames=10, steps=2, window_s=1e-6 * (hi - lo),
        busy_s=at.busy_seconds(dev, lo, hi), device_ops=len(dev),
        layer_s=layer_s, frames2=10, steps2=2, spans={"calc_setup": [0.1]},
        counters={"all_to_all_s": 0.2}, slice_loop_least_s=1e-6)
    out = {}
    for f in sorted((BENCH / "metrics").glob("*.py")):
        out[f.stem] = harness.load_module(f, f.stem).read(r)
    out["idle_gaps"] = at.idle_gaps(dev, lo, hi)
    return out


def _cpu_trace(tmp_path, live: bool):
    """A rasterize and a slice loop profiled on the CPU, with the spans
    live or off."""
    import pyslice_tpu_torch as pt
    g = pt.grid_from_box(12.75, 12.75, 6.784, sampling=0.1)
    pos = np.array([[3.0, 4.0, 1.9], [6.0, 7.0, 1.95], [8.0, 2.0, 1.93]])
    plan = pt.make_plan(g.xs, g.ys, g.zs, pos, np.array([5, 7, 5]))
    spec = pt.engine.pipeline.SimSpec.create(g, plan, 100e3)
    probes = torch.ones((1, g.nx, g.ny), dtype=torch.complex64)
    swapped = [] if live else ps.spans_off()
    try:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU],
                with_stack=True) as prof:
            with torch.profiler.record_function(at.WINDOW_SPAN):
                pt.engine.pipeline.frame_exit_waves(pos, probes, spec)
    finally:
        for m, fn in swapped:
            m.span = fn
    path = tmp_path / f"trace_{live}.json"
    prof.export_chrome_trace(str(path))
    return at.load(path)


def test_old_readers_read_the_same_without_the_program_spans(tmp_path):
    synthetic = _readings(BASE + SPANS)
    assert synthetic == _readings(BASE)
    events = _cpu_trace(tmp_path, True)
    assert ps.by_span(events, *at.window(events)).keys() \
        >= {"rasterize", "slice_loop"}
    stripped = [e for e in events
                if not e["name"].startswith(ps.PREFIX)]
    assert len(stripped) < len(events)
    assert _readings(events) == _readings(stripped)


def test_spans_off_leaves_no_program_span(tmp_path):
    events = _cpu_trace(tmp_path, False)
    assert not any(e["name"].startswith(ps.PREFIX) for e in events)
    from pyslice_tpu_torch.engine import pipeline
    from pyslice_tpu_torch.utils import profiling
    assert pipeline.span is profiling.span


# the readings each cell gives (``.planewave`` names in the plane wave)
# (on the CPU every cell takes the plain loop, which opens
# ``slice_loop.kspace``; the idle readers split the whole window there)
LOOP = {"span_rasterize_ms", "span_roofline_pct", "loop_idle_pct",
        "unspanned_idle_pct", "kspace_ms", "frame_ops_per_frame"}
JOB = LOOP | {"span_analysis_ms", "plan_ms", "setup_idle_pct",
              "analysis_idle_pct"}
CELL_METRICS = {
    "hbn_1023.stem16_tacaw": JOB,
    "hbn_2048.stream64": LOOP | {"span_fold_ms"},
    "hbn_1023.planewave_tacaw": JOB,
}


@pytest.mark.parametrize("name", sorted(CELL_METRICS))
def test_cpu_run_of_each_cell_reads_its_span_metrics(name):
    cell = tiny_cell(name)
    res = ps.report(cell, {"seed": 2 ** 31 + 19, "device": "cpu"}, 1)
    json.dumps(res)
    for reading in (res["first"], res["stack_pass"]):
        got = {k for k, v in reading["metrics"].items() if v is not None}
        assert got == CELL_METRICS[name]
        assert reading["idle_split_s"] == pytest.approx(reading["idle_s"],
                                                        abs=1e-9)
    assert [p["live"] for p in res["passes"]] == [True, False]
    assert all(ops["top_ops"] or not ops["device_ops"]
               for ops in res["first"]["program"].values())
    assert "rasterize_ms" in res["twins"] \
        or "rasterize_ms.planewave" in res["twins"]
    by_layer = {}
    for layer, _, seconds, _ in res["crosstab"]:
        if layer is not None:
            by_layer[layer] = by_layer.get(layer, 0.0) + seconds
    assert by_layer == pytest.approx(res["layer_s"], abs=1e-9)
