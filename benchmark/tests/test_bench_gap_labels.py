"""The breakdown's idle gaps, named by what the host did during them
(``program_spans.gap_labels``): the program span that held most of a gap
on the main thread, else the benchmark span, then the CPU operator; and
the traced runs that carry them and the program's spans, on one rank and
on two."""

import json

import pytest

import attribution as at
import program_spans as ps
from conftest import run_tiny, tiny_cell


def _x(name, cat, ts, dur, tid=1, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "tid": tid, "pid": 1, "args": args}


# A job's window: the host builds the trajectory and the calculator (no
# program span, [0, 6)), then set-up ([6, 40), the plan [10, 30)), whose
# first launch at 38 ends the window's first gap [0, 40); later a check
# read-back in the benchmark's own span ([80, 95)) and a gap [60, 100)
# that the main thread spends mostly there.
EVENTS = [
    _x(at.WINDOW_SPAN, "user_annotation", 0, 200),
    _x("aten::zeros", "cpu_op", 1, 3),
    _x("bench.calc_setup", "user_annotation", 5, 36),
    _x(ps.PREFIX + "setup", "user_annotation", 6, 34),
    _x(ps.PREFIX + "setup.plan", "user_annotation", 10, 20),
    _x("aten::searchsorted", "cpu_op", 14, 10),
    _x("aten::roll", "cpu_op", 36, 3),
    _x("cudaLaunchKernel", "cuda_runtime", 38, 1, correlation=1),
    _x("k", "kernel", 40, 20, tid=7, correlation=1),
    _x(ps.PREFIX + "analysis.reduce", "user_annotation", 55, 12),
    _x("bench.check", "user_annotation", 70, 30),
    _x("aten::copy_", "cpu_op", 80, 15),
    _x("cudaMemcpyAsync", "cuda_runtime", 99, 1, correlation=2),
    _x("h2d", "gpu_memcpy", 100, 100, tid=7, correlation=2),
]


def test_a_gap_mostly_in_a_program_span_is_named_by_it():
    lo, hi = at.window(EVENTS)
    gaps = at.idle_gaps(at.device_events(EVENTS), lo, hi)
    assert gaps == [(0, 40), (60, 100)]
    first, second = ps.gap_labels(EVENTS, gaps, lo, hi)
    # [0, 6) outside every span, [6, 10) and [30, 40) in setup (14),
    # [10, 30) in setup.plan (20): the plan holds most of it
    assert first == "pyslice.setup.plan / aten::searchsorted"
    # [60, 67) in analysis.reduce, [67, 100) in no program span: the
    # benchmark's own read-back
    assert second == "bench.check / aten::copy_"


def test_a_gap_with_no_program_span_keeps_its_benchmark_label():
    events = [e for e in EVENTS if not e["name"].startswith(ps.PREFIX)]
    lo, hi = at.window(events)
    gaps = at.idle_gaps(at.device_events(events), lo, hi)
    assert ps.gap_labels(events, gaps, lo, hi) == [
        "bench.calc_setup / aten::searchsorted", "bench.check / aten::copy_"]
    assert ps.gap_labels(events, [(0, 4)], lo, hi) == [
        at.WINDOW_SPAN + " / aten::zeros"]


def test_labels_follow_the_idle_split():
    """The labels read ``by_span``'s split of the same gaps: the idle
    each name holds there."""
    lo, hi = at.window(EVENTS)
    got = ps.by_span(EVENTS, lo, hi)
    assert got["setup.plan"]["idle_s"] == pytest.approx(20e-6)
    assert got["setup"]["idle_s"] == pytest.approx(14e-6)
    assert got[ps.OUTSIDE]["idle_s"] == pytest.approx(6e-6 + 33e-6)
    assert got["analysis.reduce"]["idle_s"] == pytest.approx(7e-6)


def test_traced_run_labels_its_gaps_and_reads_the_spans():
    cell = tiny_cell("hbn_1023.stem16_tacaw")
    res, lines = run_tiny(cell, trace=1)
    assert res["correct"] is True, lines
    gaps = res["breakdown"]["idle_gaps"]
    assert gaps and all(isinstance(g[0], str) and g[1] > 0 for g in gaps)
    assert any(line.startswith("program spans: ") for line in lines)
    assert any(line.startswith("program spans read in: rank 0 ")
               for line in lines)
    # the CPU trace has no device operation: the span readers that read
    # device time read the CPU operators, the idle readers nothing
    assert "kspace_ms" in res["metrics"]
    assert not {"setup_idle_pct", "loop_idle_pct", "analysis_idle_pct",
                "unspanned_idle_pct"} & set(res["metrics"])
    assert {m["name"] for m in cell.per_layer} >= {
        "setup_idle_pct", "loop_idle_pct", "analysis_idle_pct",
        "unspanned_idle_pct", "kspace_ms"}


def test_traced_mesh_run_gathers_every_ranks_spans():
    res, lines = run_tiny(tiny_cell("hbn_1023_mesh4.stem16_tacaw_mesh4"),
                          trace=1)
    assert res["correct"] is True, lines
    spans = next(json.loads(line.split(": ", 1)[1]) for line in lines
                 if line.startswith("program spans: "))
    assert {"setup", "run", "slice_loop.kspace", "analysis.time_fft",
            "collective.all_to_all"} <= set(spans)
    read = next(line for line in lines
                if line.startswith("program spans read in: "))
    assert "rank 0 " in read and "rank 1 " in read
    assert res["metrics"]["kspace_ms"]["value"] > 0
