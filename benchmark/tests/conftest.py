"""Shared set-up of the harness's tests: the benchmark's modules on the
path, the ``cuda`` marker, and cells cut to a size the CPU runs in
seconds (the harness's own runs never take these sizes).

    python -m pytest benchmark/tests -q
"""

import copy
import json
import sys
import time
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
sys.path[:0] = [str(BENCH), str(ROOT)]

import harness  # noqa: E402

TINY_BOX = 12.75                  # 128^2 at 0.1 A, 14 slices
TINY_SCAN = {"x": [2.0, 10.0], "y": [2.0, 10.0], "n": 2, "m": 2}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card; skips without one")


@pytest.fixture
def cuda_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (run on the chip)")
    return torch.device("cuda")


def tiny_cell(name: str, traffic: str = None) -> harness.Cell:
    """The cell ``name`` (with the traffic file ``traffic`` in place of
    its own, if given) with its box cut to 12.75 A, 2 x 2 probes, 8
    frames a job (4 a rank on a mesh of 2) or 40-frame streams in chunks
    of 2 probes."""
    cell = copy.deepcopy(harness.load_cell(name))
    if traffic:
        cell.traffic = json.loads(
            (BENCH / "traffic" / f"{traffic}.json").read_text())
    cfg, tr = cell.config, cell.traffic
    cfg["box_A"] = TINY_BOX
    if tr["driver"] == "stream":
        cfg.update(probe_grid=TINY_SCAN, probe_chunk=2, stream_frames=40)
        tr.update(trace_steps=2, stack_steps=1)
    else:
        tr["frames_per_job"] = 8
        tr["check_probe_block"] = 2
        if tr.get("probe_grid"):
            tr["probe_grid"] = TINY_SCAN
        if tr.get("mesh"):
            tr["mesh"] = [2, 1]
            cell.chips = 2
    return cell


def run_tiny(cell, seed=2 ** 31 + 11, seconds=0.2, trace=0, control=0,
             patch=None):
    """(result dict, stderr lines) of a run of ``cell`` on the CPU."""
    opts = {"seed": seed, "seconds": seconds, "trace": trace,
            "control": control, "device": "cpu", "patch": patch}
    t0 = time.time()
    ranks = harness.run_ranks(cell, opts)
    return harness.result(cell, opts, ranks, t0,
                          harness.driver_module(cell))
