"""Each per-layer reader: nothing to read gives nothing, and a reading
gives the number worked by hand."""

import pytest

import harness
from conftest import BENCH

EMPTY = harness.Readings(frames=0, steps=0, window_s=0.0, busy_s=0.0,
                         device_ops=0, layer_s={}, frames2=0, steps2=0,
                         spans={}, counters={}, slice_loop_least_s=0.0)
FULL = harness.Readings(
    frames=200, steps=2, window_s=3.0, busy_s=2.7, device_ops=28670,
    layer_s={"slice loop": 1.0, "potential": 0.165, "analysis": 0.153,
             "streaming": 0.05},
    frames2=100, steps2=1, spans={"calc_setup": [0.04, 0.06]},
    counters={"all_to_all_s": 5.0}, slice_loop_least_s=0.000715)
WANT = {"device_idle_pct": 10.0, "device_ops_per_frame": 143.35,
        "multislice_roofline_pct": 7.15, "rasterize_ms": 1.65,
        "fold_ms": 0.5, "analysis_ms": 153.0, "calc_setup_ms": 50.0,
        "all_to_all_ms": 2500.0}


def reader(name):
    return harness.load_module(BENCH / "metrics" / f"{name}.py", name)


def test_every_reader_is_checked():
    assert {f.stem for f in (BENCH / "metrics").glob("*.py")} == set(WANT)


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader(name):
    assert reader(name).read(EMPTY) is None
    assert reader(name).read(FULL) == pytest.approx(WANT[name])
