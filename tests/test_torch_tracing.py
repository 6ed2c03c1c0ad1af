"""The port's tracing (utils/profiling.py): spans that cost nothing while
no profiler records, that nest as the calls nest while one does, and that
change no output; and parallel.sharded's all_to_all clock, which runs
only under a profiler. Port-only: no JAX."""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import pyslice_tpu_torch as tt
from pyslice_tpu_torch.parallel.dryrun import hbn_box
from pyslice_tpu_torch.utils import profiling

ROOT = Path(__file__).resolve().parent.parent
LX = 6.35                     # 64^2 at 0.1 A
PROBES = [(2.0, 2.0), (4.0, 4.0)]

# span -> the span it sits in (None: outside every program span)
JOB_NESTING = {"setup": None, "setup.plan": "setup", "setup.probe": "setup",
               "run": None, "rasterize": "run", "slice_loop": "run",
               "slice_loop.kspace": "slice_loop",
               "analysis.time_fft": None, "analysis.reduce": None,
               "analysis.adf": None}
STREAM_NESTING = {"setup.plan": None, "stream.block": None,
                  "rasterize": "stream.block", "slice_loop": "stream.block",
                  "slice_loop.kspace": "slice_loop",
                  "stream.fold": "stream.block", "stream.readout": None}
COLLECTIVES = {"collective.all_to_all", "collective.all_reduce",
               "collective.all_gather"}


def _job(device_output: bool = True) -> dict:
    """setup -> run -> TACAWData -> HAADFData on two 64^2 frames."""
    traj = hbn_box(LX, 2, seed=3)
    calc = tt.MultisliceCalculator(device="cpu")
    calc.setup(traj, aperture=20.0, voltage_eV=100e3, sampling=0.1,
               slice_thickness=0.5, probe_positions=PROBES,
               device_output=device_output, use_cache=False)
    wf = calc.run(progress=False)
    tac = tt.TACAWData(wf)
    return {"waves": np.asarray(tt.analysis.wf_data.to_numpy(
                wf.wavefunction_data)),
            "spectrum": tac.spectrum(), "diffraction": tac.diffraction(),
            "adf": tt.HAADFData(wf).calculateADF(45)}


def _stream() -> dict:
    """A StreamingTACAW fed two blocks of two frames, then read out."""
    traj = hbn_box(LX, 4, seed=4)
    g = tt.grid_from_box(LX, LX, 6.784, sampling=0.1, slice_thickness=0.5)
    plan = tt.make_plan(g.xs, g.ys, g.zs, traj.positions, traj.atom_types)
    spec = tt.engine.pipeline.SimSpec.create(g, plan, 100e3)
    base = tt.Probe(g.xs, g.ys, 20.0, 100e3, device="cpu")
    probes = tt.create_batched_probes(base, np.array(PROBES)).array
    st = tt.StreamingTACAW(spec, probes, 4, 0.005, frequencies=[10.0, 20.0],
                           probe_chunk=1)
    for b in range(2):
        st.add_frame_block([2 * b, 2 * b + 1], traj.positions[2 * b:2 * b + 2])
    return {"intensity": st.intensity().numpy(), "spectrum": st.spectrum()}


def _profiled(fn, tmp_path: Path):
    """(fn's result, the pyslice.* spans of its Chrome trace as
    [(name, start, end, thread)])."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    spans = [(e["name"][len("pyslice."):], float(e["ts"]),
              float(e["ts"]) + float(e["dur"]), e["tid"]) for e in events
             if e.get("ph") == "X" and e.get("cat") == "user_annotation"
             and e["name"].startswith("pyslice.")]
    return out, spans


def _parents(spans) -> dict:
    """{span name: the set of names of the innermost spans around it}."""
    out = {}
    for name, a, b, tid in spans:
        around = [(a2, n2) for n2, a2, b2, t2 in spans
                  if t2 == tid and a2 <= a and b <= b2
                  and (a2, b2) != (a, b)]
        out.setdefault(name, set()).add(max(around)[1] if around else None)
    return out


def test_span_without_a_profiler_is_the_shared_noop(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered with no profiler")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    first = profiling.span("setup")
    assert first is profiling.span("stream.fold")
    with first as traced:
        assert traced is None
    _job()
    _stream()


def test_span_under_a_profiler_is_a_record_function():
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with profiling.span("slice_loop") as traced:
            torch.ones(4).sum()
        assert traced is not None
        assert profiling.span("x") is not profiling.span("x")
    assert "pyslice.slice_loop" in {e.key for e in prof.key_averages()}


@pytest.mark.parametrize("device_output", [True, False])
def test_job_exports_its_spans_nested_as_called(tmp_path, device_output):
    _, spans = _profiled(lambda: _job(device_output), tmp_path)
    parents = _parents(spans)
    assert set(parents) == set(JOB_NESTING)
    for name, parent in JOB_NESTING.items():
        assert parents[name] == {parent}, name
    count = lambda n: sum(s[0] == n for s in spans)
    assert count("rasterize") == count("slice_loop") == 2
    assert count("analysis.reduce") == 2 and count("setup.plan") == 1


def test_stream_exports_its_spans_nested_as_called(tmp_path):
    _, spans = _profiled(_stream, tmp_path)
    parents = _parents(spans)
    assert set(parents) == set(STREAM_NESTING)
    for name, parent in STREAM_NESTING.items():
        assert parents[name] == {parent}, name
    count = lambda n: sum(s[0] == n for s in spans)
    assert count("stream.block") == 2 and count("rasterize") == 4
    # one slice loop and one fold a (frame, probe chunk of one)
    assert count("slice_loop") == count("stream.fold") == 8
    # spectrum() reads the intensity out again, inside its own read-out
    assert count("stream.readout") == 2


@pytest.mark.parametrize("fn", [_job, _stream], ids=["job", "stream"])
def test_outputs_are_the_same_bits_under_a_profiler(tmp_path, fn):
    plain = fn()
    traced, spans = _profiled(fn, tmp_path)
    assert spans
    assert plain.keys() == traced.keys()
    for k in plain:
        np.testing.assert_array_equal(traced[k], plain[k], err_msg=k)


RANK = r"""
import json, sys
import torch
import torch.distributed as dist
rank, port = int(sys.argv[1]), int(sys.argv[2])
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                        rank=rank, world_size=2)
from pyslice_tpu_torch.parallel import sharded as sh
from pyslice_tpu_torch.parallel.mesh import make_mesh
mesh = make_mesh(2, 1, device="cpu")
syncs = []
sh._sync = lambda t: syncs.append(1)
g = torch.Generator().manual_seed(11 + rank)
local = torch.randn((2, 3, 5, 4, 1), dtype=torch.complex128, generator=g)
wf = sh._wrap(local, mesh, 1, 0, shape=(2, 6, 5, 4, 1))
ring = torch.zeros((5, 4), dtype=torch.float64)
ring[1:4, 1:3] = 1.0
def analysis():
    inten = sh.tacaw_intensity_sharded(wf, mesh, crop=False)
    return [sh.local_of(inten), sh.tacaw_spectrum_sharded(inten, mesh),
            sh.collected_sharded(wf, mesh, ring)]
plain = analysis()
untraced = {"syncs": len(syncs), "stats": sh.STATS["all_to_all_s"]}
with torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
    traced_out = analysis()
traced = {"syncs": len(syncs), "stats": sh.STATS["all_to_all_s"]}
names = sorted(e.key for e in prof.key_averages()
               if e.key.startswith("pyslice."))
same = all(torch.equal(a, b) for a, b in zip(plain, traced_out))
print(json.dumps({"untraced": untraced, "traced": traced, "names": names,
                  "same": same}))
dist.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_sharded_all_to_all_clock_runs_only_under_a_profiler():
    """tacaw_intensity_sharded on two Gloo ranks on the CPU: no _sync and
    no STATS while no profiler records; two _syncs and a positive STATS
    under one, the collectives' spans in its trace, the same bits."""
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", RANK, str(r),
                               str(port)], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=env,
                              cwd=ROOT) for r in range(2)]
    results = []
    for p in procs:
        out, err = p.communicate(timeout=240)
        assert p.returncode == 0, err[-3000:]
        results.append(json.loads(out.strip().splitlines()[-1]))
    for r in results:
        assert r["untraced"] == {"syncs": 0, "stats": 0.0}
        assert r["traced"]["syncs"] == 2 and r["traced"]["stats"] > 0
        assert r["same"]
        assert {"pyslice." + n for n in COLLECTIVES} \
            | {"pyslice.analysis.time_fft"} <= set(r["names"])
