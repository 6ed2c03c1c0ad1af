"""The sharded time FFT in probe chunks (parallel/sharded.py
``tacaw_intensity_sharded``): on four Gloo ranks on the CPU, meshes 4 x 1
and 2 x 2, with an odd kx extent (17) so that the kx pad is exercised, the
intensity computed in several probe chunks, the last one short, equals
the one-chunk result and the plain reference's time FFT
(``benchmark/reference/plain.py``) of the same exit waves, in float64; and
the exchange counters count one all_to_all a chunk and the bytes of the
rank's padded block. Port-only: no JAX. The four ranks are launched once
for both meshes."""

import importlib.util
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from pyslice_tpu_torch.analysis import tacaw
from pyslice_tpu_torch.analysis.tacaw import (CHUNK_ELEMS, probe_chunk,
                                              time_fft_intensity)

ROOT = Path(__file__).resolve().parent.parent
WORLD = 4
P, T, NX, NY = 10, 8, 17, 6             # probes, frames, kx (odd), ky
# mesh -> (frame extent, probe extent, probes a chunk): 10 local probes in
# 3 + 3 + 3 + 1 on 4 x 1, 5 in 2 + 2 + 1 on 2 x 2
MESHES = {"4x1": (4, 1, 3), "2x2": (2, 2, 2)}
LAUNCH_S = 120.0

RANK = r"""
import json, sys
from pathlib import Path
import numpy as np
import torch
import torch.distributed as dist
rank, port, out = int(sys.argv[1]), int(sys.argv[2]), Path(sys.argv[3])
meshes = json.loads(sys.argv[4])
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                        rank=rank, world_size=int(sys.argv[5]))
from pyslice_tpu_torch.parallel import sharded as sh
from pyslice_tpu_torch.parallel.mesh import make_mesh
waves = torch.from_numpy(np.load(out / "waves.npy"))
n_probes, n_frames, nx = waves.shape[0], waves.shape[1], waves.shape[2]
for name, (f, p, chunk_elems) in meshes.items():
    mesh = make_mesh(f, p, device="cpu")
    ps = sh.block_of(n_probes, mesh, "probe")
    fs = sh.block_of(n_frames, mesh, "frame")
    wf = sh._wrap(waves[ps, fs].contiguous(), mesh, 1, 0,
                  shape=tuple(waves.shape))
    one = sh.tacaw_intensity_sharded(wf, mesh, crop=False)
    calls = sh.STATS["all_to_all_calls"]
    nbytes = sh.STATS["all_to_all_bytes"]
    many = sh.tacaw_intensity_sharded(wf, mesh, crop=False,
                                      chunk_elems=chunk_elems)
    whole = sh.gather_full(many)[:, :, :nx]
    np.savez(out / f"{name}.rank{rank}.npz", one=sh.local_of(one).numpy(),
             many=sh.local_of(many).numpy(), whole=whole.numpy(),
             calls=sh.STATS["all_to_all_calls"] - calls,
             nbytes=sh.STATS["all_to_all_bytes"] - nbytes,
             p_loc=ps.stop - ps.start, f_loc=fs.stop - fs.start)
dist.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _plain():
    """benchmark/reference/plain.py, loaded by path (it imports neither
    JAX nor the port)."""
    path = ROOT / "benchmark" / "reference" / "plain.py"
    spec = importlib.util.spec_from_file_location("bench_plain", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod          # its dataclasses look it up
    spec.loader.exec_module(mod)
    return mod


def _stripe(f_ext: int) -> int:
    return -(-NX // f_ext)


def _chunk_elems(f_ext: int, probes: int) -> int:
    """Elements that hold ``probes`` chunks' received blocks and half of
    one more."""
    per = T * _stripe(f_ext) * NY
    return probes * per + per // 2


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """{mesh: [rank's arrays]}, and the global exit waves."""
    out = tmp_path_factory.mktemp("chunks")
    rng = np.random.default_rng(20)
    waves = (rng.standard_normal((P, T, NX, NY, 1))
             + 1j * rng.standard_normal((P, T, NX, NY, 1)))
    np.save(out / "waves.npy", waves)
    meshes = {k: (f, p, _chunk_elems(f, c))
              for k, (f, p, c) in MESHES.items()}
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", RANK, str(r), str(port), str(out),
         json.dumps(meshes), str(WORLD)], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=env, cwd=ROOT)
        for r in range(WORLD)]
    try:
        for p in procs:
            _, err = p.communicate(timeout=LAUNCH_S)
            assert p.returncode == 0, err[-3000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    res = {k: [dict(np.load(out / f"{k}.rank{r}.npz"))
               for r in range(WORLD)] for k in MESHES}
    return res, waves


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_chunks_are_several_and_the_last_short(ranks, mesh):
    f, _, c = MESHES[mesh]
    for r in ranks[0][mesh]:
        p_loc = int(r["p_loc"])
        assert probe_chunk(T * _stripe(f) * NY, _chunk_elems(f, c)) == c
        assert -(-p_loc // c) >= 3 and p_loc % c


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_chunked_equals_one_chunk(ranks, mesh):
    for r in ranks[0][mesh]:
        assert r["many"].shape == r["one"].shape
        scale = np.abs(r["one"]).max()
        assert np.abs(r["many"] - r["one"]).max() <= 1e-12 * scale


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_chunked_matches_plain_reference(ranks, mesh):
    res, waves = ranks
    plain = _plain()
    want = np.stack([plain.tacaw_intensity(
        torch.from_numpy(waves[p, :, :, :, 0])).numpy() for p in range(P)])
    for r in res[mesh]:
        got = r["whole"]
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= 1e-10 * np.abs(want).max()


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_counters_count_exchanges_and_bytes(ranks, mesh):
    f, _, c = MESHES[mesh]
    for r in ranks[0][mesh]:
        p_loc, f_loc = int(r["p_loc"]), int(r["f_loc"])
        assert int(r["calls"]) == -(-p_loc // c)
        nx_pad = f * _stripe(f)
        assert int(r["nbytes"]) == p_loc * f_loc * nx_pad * NY * 16


@pytest.mark.parametrize("per_probe,chunk_elems,want", [
    (100, 1000, 10), (100, 1050, 10), (100, 99, 1), (0, 10, 10),
    (CHUNK_ELEMS + 1, None, 1), (1 << 20, None, 64)])
def test_probe_chunk(per_probe, chunk_elems, want):
    assert probe_chunk(per_probe, chunk_elems) == want


def test_time_fft_intensity_chunks_agree():
    """The unsharded path: probe chunks of 1, 2 and all give one result."""
    rng = np.random.default_rng(3)
    wf = torch.from_numpy(rng.standard_normal((5, T, NX, NY))
                          + 1j * rng.standard_normal((5, T, NX, NY)))
    whole = time_fft_intensity(wf)
    for probes in (1, 2):
        got = time_fft_intensity(wf, chunk_elems=probes * T * NX * NY)
        assert np.abs((got - whole).numpy()).max() \
            <= 1e-12 * whole.abs().max().item()


def test_one_chunk_returns_its_own_block(monkeypatch):
    """One chunk on the plain chain is returned as the block computed it:
    no output is allocated beside it and nothing copies it. Several chunks
    fill one output, allocated once, in probe order: each chunk is handed
    its rows of it."""
    made, allocs = [], []

    def tagged(blk, out=None):
        res = torch.full(blk.shape, float(len(made)), dtype=torch.float64)
        made.append(res)
        return res if out is None else out.copy_(res)

    new_empty = torch.Tensor.new_empty

    def counted(self, *args, **kwargs):
        allocs.append(args)
        return new_empty(self, *args, **kwargs)

    monkeypatch.setattr(tacaw, "_time_fft_block", tagged)
    monkeypatch.setattr(torch.Tensor, "new_empty", counted)
    wf = torch.zeros((3, T, NX, NY), dtype=torch.complex128)
    assert probe_chunk(T * NX * NY) >= 3
    got = time_fft_intensity(wf)
    assert len(made) == 1 and got is made[0] and not allocs
    made.clear()
    got = time_fft_intensity(wf, chunk_elems=T * NX * NY)
    assert len(made) == 3 and len(allocs) == 1
    assert all(got is not m for m in made)
    assert got[:, 0, 0, 0].tolist() == [0.0, 1.0, 2.0]
