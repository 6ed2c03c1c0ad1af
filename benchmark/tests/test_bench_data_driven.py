"""A configuration, a cell, a layer and a per-layer metric are added as
new files (and entries of BENCHMARK.json) to a scratch copy of the
benchmark, and its harness finds and runs them without an edit."""

import json
import shutil
import subprocess
import sys

from conftest import BENCH, ROOT

PROBE = r"""
import json, sys, time
sys.path[:0] = [sys.argv[1] + "/benchmark", sys.argv[2]]
import harness, attribution
cell = harness.load_cell("hbn_0511.stem4_tacaw", root=harness.ROOT)
cell.traffic["frames_per_job"] = 4
opts = {"seed": 5, "seconds": 0.1, "trace": 1, "control": 0,
        "device": "cpu", "patch": None}
ranks = harness.run_ranks(cell, opts)
res, lines = harness.result(cell, opts, ranks, time.time(),
                            harness.driver_module(cell))
layers = [n for n, _ in attribution.load_layers(harness.BENCH / "layers")]
print(json.dumps({"res": res, "layers": layers,
                  "per_layer": [m["name"] for m in cell.per_layer]}))
"""


def test_new_files_are_found_without_an_edit(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    b = tmp_path / "benchmark"
    cfg = json.loads((b / "configs" / "hbn_1023.json").read_text())
    cfg.update(name="hbn_0511", box_A=12.75)
    (b / "configs" / "hbn_0511.json").write_text(json.dumps(cfg))
    tr = json.loads((b / "traffic" / "stem16_tacaw.json").read_text())
    tr.update(probe_grid={"x": [2.0, 10.0], "y": [2.0, 10.0], "n": 2,
                          "m": 2}, check_probe_block=4)
    (b / "traffic" / "stem4_tacaw.json").write_text(json.dumps(tr))
    (b / "limits" / "hbn_0511.stem4_tacaw.json").write_text(json.dumps(
        {"spectrum": 1.5e-4, "diffraction": 6.1e-5}))
    (b / "layers" / "ingest.json").write_text(json.dumps(
        {"name": "ingest", "device_time": True,
         "modules": ["pyslice_tpu_torch/io/"], "why": "readers"}))
    (b / "metrics" / "probe_frames_per_s.py").write_text(
        "def read(r):\n    return 4 * r.frames / r.window_s\n")
    m = json.loads((tmp_path / "BENCHMARK.json").read_text())
    m["configs"].append({"name": "hbn_0511", "source": cfg["source"],
                         "file": "benchmark/configs/hbn_0511.json",
                         "reduced": [], "why": "a scratch configuration"})
    m["workloads"].append({"name": "hbn_0511.stem4_tacaw",
                           "config": "hbn_0511", "traffic": "stem4_tacaw",
                           "chips": 1, "why": "a scratch cell"})
    m["per_layer"].append({"name": "probe_frames_per_s",
                           "unit": "frames/s", "better": "higher",
                           "source": "host_clock", "layer": "ingest",
                           "moves": "frames_per_s",
                           "workloads": ["hbn_0511.stem4_tacaw"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(m))
    out = subprocess.run([sys.executable, "-c", PROBE, str(tmp_path),
                          str(ROOT)], capture_output=True, text=True,
                         check=True, cwd=tmp_path).stdout
    got = json.loads(out.strip().splitlines()[-1])
    assert "ingest" in got["layers"]
    assert "probe_frames_per_s" in got["per_layer"]
    assert "probe_frames_per_s" in got["res"]["metrics"]
    assert set(got["res"]["checks"]) == {"spectrum", "diffraction"}
    assert got["res"]["correct"] is True
