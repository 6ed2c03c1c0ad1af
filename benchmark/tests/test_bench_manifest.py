"""BENCHMARK.json against the benchmark's contract, and the files it
names."""

import json
import re

import pytest

from conftest import BENCH, ROOT

M = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"configs": {"name", "source", "file", "reduced", "why"},
        "workloads": {"name", "config", "traffic", "chips", "why"},
        "end_to_end": {"name", "unit", "better", "bound", "source"},
        "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}
CELLS = [w["name"] for w in M["workloads"]]


def reported(metric, cell):
    return "workloads" not in metric or cell in metric["workloads"]


def test_top_level_keys():
    assert set(M) == {"command", "paths", "run_seconds", *KEYS}
    assert M["command"] == ["python3", "benchmark/run.py"]
    assert M["paths"] == ["benchmark"]


@pytest.mark.parametrize("section", sorted(KEYS))
def test_entries_keys_names_and_units(section):
    names = [e["name"] for e in M[section]]
    assert len(names) == len(set(names))
    for e in M[section]:
        extra = {"workloads"} if section in ("end_to_end", "per_layer") \
            else set()
        assert KEYS[section] <= set(e) <= KEYS[section] | extra, e["name"]
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower",
                                                             "higher")
        for k in ("why", "source", "layer"):
            if k in e:
                assert 1 <= len(e[k]) <= 200 and "\n" not in e[k] \
                    and "\t" not in e[k], (e["name"], k)
        for cell in e.get("workloads", []):
            assert cell in CELLS


def test_metric_sources_and_bounds():
    assert "setup_s" in [m["name"] for m in M["end_to_end"]]
    for m in M["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in M["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_reports_enough(cell):
    e2e = [m["name"] for m in M["end_to_end"] if reported(m, cell)]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert any(reported(m, cell) for m in M["per_layer"])


@pytest.mark.parametrize("metric", [m["name"] for m in M["per_layer"]])
def test_moves_an_end_to_end_metric_of_every_cell_it_reads(metric):
    m = next(x for x in M["per_layer"] if x["name"] == metric)
    e2e = next(x for x in M["end_to_end"] if x["name"] == m["moves"])
    for cell in m.get("workloads", CELLS):
        assert reported(e2e, cell), (metric, cell)
    assert (BENCH / "metrics" / f"{metric.split('.')[0]}.py").exists()


def test_layers_are_named_by_layer_files():
    names = {json.loads(f.read_text())["name"]
             for f in (BENCH / "layers").glob("*.json")}
    assert {m["layer"] for m in M["per_layer"]} <= names


def test_cells_configs_and_files():
    configs = {c["name"]: c for c in M["configs"]}
    used = {w["config"] for w in M["workloads"]}
    assert used == set(configs)
    fours = sum(w["chips"] == 4 for w in M["workloads"])
    assert fours <= max(1, len(M["workloads"]) // 4)
    pairs = {(w["config"], w["traffic"]) for w in M["workloads"]}
    assert len(pairs) == len(M["workloads"])
    for w in M["workloads"]:
        assert w["chips"] in (1, 4)
        assert (BENCH / "traffic" / f"{w['traffic']}.json").exists()
    for c in configs.values():
        assert c["file"].startswith("benchmark/configs/")
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"]
        assert all(k in cfg for k in c["reduced"])
        assert cfg["source"] == c["source"]


def test_run_seconds_fits_a_full_check_of_24_cells():
    rs = M["run_seconds"]
    assert 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_manifest_is_small():
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_has_limits(cell):
    limits = json.loads((BENCH / "limits" / f"{cell}.json").read_text())
    assert limits and all(0 < v < 1 for v in limits.values())
