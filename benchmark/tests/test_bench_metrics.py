"""Each per-layer reader: nothing to read gives nothing, and a reading
gives the number worked by hand; the program's spans as the harness
gathers them over the ranks, and the idle readers' partition of the
device's idle share."""

import numpy as np
import pytest

import attribution as at
import harness
import program_spans as ps
from conftest import BENCH

EMPTY = harness.Readings(frames=0, steps=0, window_s=0.0, busy_s=0.0,
                         device_ops=0, layer_s={}, frames2=0, steps2=0,
                         spans={}, counters={}, slice_loop_least_s=0.0)
FULL = harness.Readings(
    frames=200, steps=2, window_s=3.0, busy_s=2.7, device_ops=28670,
    layer_s={"slice loop": 1.0, "potential": 0.165, "analysis": 0.153,
             "streaming": 0.05, "inverse": 0.04},
    frames2=100, steps2=1, spans={"calc_setup": [0.04, 0.06]},
    counters={"all_to_all_s": 5.0}, slice_loop_least_s=0.000715,
    # the window's 0.3 s of idle: 0.03 outside every span, 0.03 in set-up,
    # 0.15 in the frame loop, 0.09 in the analysis and its collectives
    program={"": {"idle_s": 0.03, "device_s": 0.002},
             "setup": {"idle_s": 0.02}, "setup.plan": {"idle_s": 0.01},
             "run": {"idle_s": 0.05, "device_s": 0.03},
             "rasterize": {"idle_s": 0.07, "device_s": 0.33},
             "slice_loop": {"idle_s": 0.02, "device_s": 1.2},
             "slice_loop.kspace": {"idle_s": 0.01, "device_s": 0.16},
             "analysis.reduce": {"idle_s": 0.06, "device_s": 0.05},
             "collective.all_to_all": {"idle_s": 0.03, "device_s": 0.1},
             "adjoint": {"idle_s": 0.0, "device_s": 0.11}})
WANT = {"device_idle_pct": 10.0, "device_ops_per_frame": 143.35,
        "multislice_roofline_pct": 7.15, "rasterize_ms": 1.65,
        "fold_ms": 0.5, "analysis_ms": 153.0, "calc_setup_ms": 50.0,
        "all_to_all_ms": 2500.0,
        "setup_idle_pct": 1.0, "loop_idle_pct": 5.0,
        "analysis_idle_pct": 3.0, "unspanned_idle_pct": 1.0,
        "kspace_ms": 0.8, "msp_backward_ms": 55.0, "inverse_ms": 40.0}
IDLE = ("setup_idle_pct", "loop_idle_pct", "analysis_idle_pct",
        "unspanned_idle_pct")


def reader(name):
    return harness.load_module(BENCH / "metrics" / f"{name}.py", name)


def test_every_reader_is_checked():
    assert {f.stem for f in (BENCH / "metrics").glob("*.py")} == set(WANT)


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader(name):
    assert reader(name).read(EMPTY) is None
    assert reader(name).read(FULL) == pytest.approx(WANT[name])


def test_idle_readers_read_nothing_where_the_device_ran_nothing():
    import dataclasses
    idle = dataclasses.replace(FULL, busy_s=0.0)
    assert all(reader(name).read(idle) is None for name in IDLE)


def _x(name, cat, ts, dur, tid=1, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "tid": tid, "pid": 1, "args": args}


SPANS = ("setup", "setup.plan", "setup.probe", "run", "rasterize",
         "slice_loop", "slice_loop.kspace", "analysis.time_fft",
         "analysis.reduce", "analysis.adf", "collective.all_to_all")


def _job_trace(seed: int, length: float = 2000.0) -> list:
    """A job cell's traced window: nested program spans of every family a
    job opens, host time outside them, and kernels launched from inside
    them that leave gaps on the device."""
    rng = np.random.default_rng(seed)
    events = [_x(at.WINDOW_SPAN, "user_annotation", 0, length)]
    t, i = rng.uniform(0, 20), 0
    while t < length - 60:
        outer = SPANS[rng.integers(len(SPANS))]
        dur = rng.uniform(5, 50)
        events.append(_x(ps.PREFIX + outer, "user_annotation", t, dur))
        if "." in outer:
            root = outer.split(".")[0]
            if root in SPANS:
                events.append(_x(ps.PREFIX + root, "user_annotation",
                                 t - 1, dur + 2))
        for _ in range(rng.integers(1, 4)):
            a = t + rng.uniform(0, dur)
            events.append(_x("cudaLaunchKernel", "cuda_runtime", a, 0.5,
                             correlation=i))
            events.append(_x("k", "kernel", a + rng.uniform(1, 8),
                             rng.uniform(0.5, 12), tid=7, correlation=i))
            i += 1
        t += dur + rng.uniform(2, 30)
    return events


def _rank(events, frames: int = 100, steps: int = 1) -> dict:
    """A rank's traced readings as ``harness._traced`` gathers them."""
    lo, hi = at.window(events)
    dev = at.device_events(events)
    return {"rank": 0, "trace": {
        "frames": frames, "steps": steps, "window_s": 1e-6 * (hi - lo),
        "busy_s": at.busy_seconds(dev, lo, hi), "device_ops": len(dev),
        "layer_s": {}, "frames2": frames, "steps2": steps, "spans": {},
        "counters": {}, "program": ps.by_span(events, lo, hi)}}


def test_readings_sum_the_ranks_span_work_and_average_their_idle():
    ranks = [_rank(_job_trace(11)), _rank(_job_trace(12, 2400.0))]
    got = harness.readings(ranks, 1e-6).program
    parts = [r["trace"]["program"] for r in ranks]
    assert set(got) == set(parts[0]) | set(parts[1])
    for name, v in got.items():
        each = [p.get(name, {}) for p in parts]
        for key in harness.SPAN_SUMS:
            assert v[key] == pytest.approx(sum(e.get(key, 0) for e in each),
                                           abs=1e-12)
        assert v["idle_s"] == pytest.approx(
            sum(e.get("idle_s", 0.0) for e in each) / 2, abs=1e-12)
    assert got["slice_loop.kspace"]["device_s"] > 0
    assert got[ps.OUTSIDE]["idle_s"] > 0


@pytest.mark.parametrize("seeds", [(21,), (22, 23), (24, 25, 26, 27)])
def test_idle_readers_partition_the_device_idle_share(seeds):
    ranks = [_rank(_job_trace(s, 1500.0 + 300 * k))
             for k, s in enumerate(seeds)]
    r = harness.readings(ranks, 1e-6)
    parts = [reader(name).read(r) for name in IDLE]
    assert all(p is not None and p > 0 for p in parts)
    assert sum(parts) == pytest.approx(
        reader("device_idle_pct").read(r), abs=1e-9)
