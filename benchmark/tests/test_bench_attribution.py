"""Layer attribution and the device readings of a trace."""

import json

import numpy as np
import pytest
import torch

import attribution as at
import program_spans as ps
from conftest import BENCH

LAYERS = at.load_layers(BENCH / "layers")


def test_layers_of_files():
    assert at.layer_of("pyslice_tpu_torch/physics/potential.py", LAYERS) \
        == "potential"
    assert at.layer_of("/x/y/pyslice_tpu_torch/ops/fused_step.py",
                       LAYERS) == "slice loop"
    assert at.layer_of("pyslice_tpu_torch/engine/calculator.py",
                       LAYERS) == "facade"
    assert at.layer_of("benchmark/harness.py", LAYERS) is None
    assert at.module_file("<built-in method cos>") is None
    assert at.module_file("a/b.py(12): f") == "a/b.py"


def _rasterize_under_profile(tmp_path):
    import pyslice_tpu_torch as pt
    g = pt.grid_from_box(12.75, 12.75, 6.784, sampling=0.1)
    pos = np.array([[3.0, 4.0, 1.9], [6.0, 7.0, 1.95], [8.0, 2.0, 1.93]])
    plan = pt.make_plan(g.xs, g.ys, g.zs, pos, np.array([5, 7, 5]))
    spec = pt.engine.pipeline.SimSpec.create(g, plan, 100e3)
    probes = torch.ones((1, g.nx, g.ny), dtype=torch.complex64)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU],
            with_stack=True) as prof:
        with torch.profiler.record_function(at.WINDOW_SPAN):
            pt.engine.pipeline.frame_exit_waves(pos, probes, spec)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    return at.load(path)


def test_cpu_profile_puts_the_rasterizer_in_potential(tmp_path):
    per_layer, lost, _ = at.attribute(_rasterize_under_profile(tmp_path),
                                      LAYERS)
    assert per_layer.get("potential", 0) > 0
    assert per_layer.get("slice loop", 0) > 0
    assert set(per_layer) <= {"potential", "slice loop"}


def _x(name, cat, ts, dur, tid=1, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "tid": tid, "pid": 1, "args": args}


def test_launches_follow_their_correlation_to_the_innermost_layer(
        tmp_path):
    events = [
        _x(at.WINDOW_SPAN, "user_annotation", 0, 100),
        _x("pyslice_tpu_torch/engine/pipeline.py(60): frame_exit_waves",
           "python_function", 1, 60),
        _x("pyslice_tpu_torch/physics/potential.py(300): rasterize",
           "python_function", 2, 10),
        _x("<built-in method matmul>", "python_function", 3, 2),
        _x("cudaLaunchKernel", "cuda_runtime", 4, 1, correlation=7),
        _x("cudaLaunchKernel", "cuda_runtime", 20, 1, correlation=8),
        _x("cuLaunchKernel", "cuda_driver", 70, 1, correlation=9),
        _x("gemm", "kernel", 30, 5, tid=7, correlation=7),
        _x("void k4_pass<1>(float2*)", "kernel", 40, 20, tid=7,
           correlation=8),
        _x("mean", "kernel", 80, 4, tid=7, correlation=9),
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    ev = at.load(path)
    per_layer, lost, lost_ops = at.attribute(ev, LAYERS)
    assert per_layer == pytest.approx({"potential": 5e-6,
                                       "slice loop": 20e-6})
    assert lost == pytest.approx(4e-6) and list(lost_ops) == ["mean"]
    lo, hi = at.window(ev)
    dev = at.device_events(ev)
    assert at.busy_seconds(dev, lo, hi) == pytest.approx(29e-6)
    assert at.idle_gaps(dev, lo, hi) == [(0, 30), (35, 40), (60, 80),
                                         (84, 100)]
    assert at.top_device_ops(dev)[0] == ["k4_pass<1>", pytest.approx(20e-6)]
    assert ps.gap_labels(ev, [(0, 30)], lo, hi) == [at.WINDOW_SPAN]
