"""Port parity for pyslice_tpu_torch.parallel: the (frame, probe) mesh on
torch.distributed and every function of parallel/sharded.py, in real Gloo
ranks on the CPU.

The ranks run ``pyslice_tpu_torch.parallel.dryrun`` (launched once a mesh
shape, 2 x 1 and 1 x 2, with a time limit of its own) on
tests/test_sharding.py's problem (hbn_thermal(n_frames=8, nx=2, ny=2),
sampling 0.3, 4 probes, float64; the 2 x 1 mesh pads kx 17 -> 18). The
functions' outputs (run_sharded's exit waves, tacaw_intensity_sharded with
and without the crop, tacaw_spectrum_sharded, collected_sharded,
frame_mean_intensity_sharded, tacaw_probe_spectra_sharded with and without
a mask, tacaw_kplane_sharded, tacaw_dispersion_sharded) are held to 1e-10
max-relative against pyslice_tpu.parallel.sharded on a mesh of the same
shape over the virtual CPU devices, one complex64 launch to the 1e-6
residual. The mesh's extent rules, the multi-node layout, the backend
choice and the error messages are checked against the JAX package's.
"""

import re

import numpy as np
import pytest
import torch

import jax
from pyslice_tpu.engine.calculator import MultisliceCalculator as JCalc
from pyslice_tpu.core.dtypes import DOUBLE as JDOUBLE
from pyslice_tpu.parallel import sharded as jsh
from pyslice_tpu.parallel.mesh import make_mesh as jmake_mesh

import pyslice_tpu_torch as tt
from pyslice_tpu_torch.analysis import ptychography as tptycho
from pyslice_tpu_torch.parallel import dryrun, mesh as tmesh
from pyslice_tpu_torch.parallel import sharded as tsh

from fixtures import hbn_thermal
from oracle import residual

torch.set_num_threads(2)

LAUNCH_S = 240.0        # each launch of the ranks: its own time limit
MESHES = {"2x1": (2, 1), "1x2": (1, 2)}
PG = tt.probe_grid([1, 3], [1, 3], 2, 2)
SETUP = dict(aperture=20.0, voltage_eV=100e3, sampling=0.3,
             slice_thickness=0.8, probe_positions=PG.tolist())


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.abs(got - want).max() / np.abs(want).max()


def _traj():
    return hbn_thermal(n_frames=8, sigma=0.05, nx=2, ny=2, seed=7)


def _launch(out, mesh, precision="double"):
    dryrun.save_trajectory(out / "problem.npz", _traj())
    cfg = {"precision": precision, "problem": "problem.npz",
           "setup": SETUP, "parts": ["stem"]}
    f, p = (int(v) for v in mesh.split("x"))
    return dryrun.launch(out, f * p, device="cpu", mesh=mesh, config=cfg,
                         timeout=LAUNCH_S)


def _whole(res, key, frame_dim, probe_dim):
    """A sharded output put back together from the ranks' coordinates."""
    blocks = {(r["coords"]["frame"], r["coords"]["probe"]): a[key]
              for a, r in res}
    nf = 1 + max(f for f, _ in blocks)
    npb = 1 + max(p for _, p in blocks)
    return np.concatenate(
        [np.concatenate([blocks[(f, p)] for f in range(nf)], axis=frame_dim)
         for p in range(npb)], axis=probe_dim)


@pytest.fixture(scope="module", params=list(MESHES))
def ranks(request, tmp_path_factory):
    out = tmp_path_factory.mktemp(f"ranks{request.param}")
    return request.param, _launch(out, request.param)


@pytest.fixture(scope="module")
def refs(ranks):
    """pyslice_tpu.parallel.sharded's functions on a mesh of the same
    shape, given the arguments the ranks used."""
    name, res = ranks
    f, p = MESHES[name]
    jm = jmake_mesh(f, p, jax.devices()[:f * p])
    calc = JCalc(precision=JDOUBLE)
    calc.setup(_traj(), use_cache=False, **SETUP)
    wf = jsh.run_sharded(calc.trajectory.positions, calc._probes_array(),
                         calc.spec, jm)
    a = res[0][0]
    mask, ring = a["arg_mask"], a["arg_ring"]
    last = int(a["arg_last"])
    inten = jsh.tacaw_intensity_sharded(wf, jm, crop=False)
    nx, ny = wf.shape[2], wf.shape[3]
    pad = inten.shape[2] - nx
    onehot = np.eye(wf.shape[0])[last]
    out = {
        "wf": wf,
        "fn_intensity_pad": inten,
        "fn_intensity_crop": jsh.tacaw_intensity_sharded(wf, jm),
        "fn_spectrum": jsh.tacaw_spectrum_sharded(inten, jm),
        "fn_probe_spectra": jsh.tacaw_probe_spectra_sharded(inten, jm),
        "fn_probe_spectra_mask": jsh.tacaw_probe_spectra_sharded(
            inten, jm, mask=np.pad(mask, ((0, pad), (0, 0)))),
        "fn_kplane": jsh.tacaw_kplane_sharded(
            inten, jm, np.full(wf.shape[0], 1.0 / wf.shape[0])),
        "fn_kplane_f": jsh.tacaw_kplane_sharded(inten, jm, onehot,
                                                freq_index=1),
        "fn_dispersion": jsh.tacaw_dispersion_sharded(
            inten, jm, onehot, [0, 1, nx - 1], [0, ny // 2, 2]),
        "fn_collected": jsh.collected_sharded(wf, jm,
                                              np.stack([ring, 1.0 - ring])),
        "fn_collected_int": jsh.collected_sharded(wf, jm, ring,
                                                  intensity=True),
        "fn_frame_mean": jsh.frame_mean_intensity_sharded(wf, jm),
    }
    return {k: np.asarray(v) for k, v in out.items()}


SHARDED = {"wf": (1, 0), "fn_intensity_pad": (2, 0),
           "fn_intensity_crop": (2, 0)}
FUNCTIONS = ["wf", "fn_intensity_pad", "fn_intensity_crop", "fn_spectrum",
             "fn_probe_spectra", "fn_probe_spectra_mask", "fn_kplane",
             "fn_kplane_f", "fn_dispersion", "fn_collected",
             "fn_collected_int", "fn_frame_mean"]


@pytest.mark.parametrize("key", FUNCTIONS)
def test_sharded_function_matches_jax(ranks, refs, key):
    _, res = ranks
    got = (_whole(res, key, *SHARDED[key]) if key in SHARDED
           else res[0][0][key])
    assert _rel(got, refs[key]) <= 1e-10, key


@pytest.mark.parametrize("key", [k for k in FUNCTIONS if k not in SHARDED])
def test_replicated_results_are_the_same_bits_on_every_rank(ranks, key):
    _, res = ranks
    for a, _ in res[1:]:
        np.testing.assert_array_equal(a[key], res[0][0][key])


def test_crop_keeps_torch_chunk_stripes(ranks):
    """crop=True leaves each rank its stripe's rows below nx: the shard
    sizes torch.chunk gives an uneven kx axis."""
    name, res = ranks
    f, _ = MESHES[name]
    nx = res[0][0]["wf"].shape[2]
    sizes = [c.shape[0] for c in torch.arange(nx).chunk(f)]
    got = [a["fn_intensity_crop"].shape[2] for a, r in res
           if r["coords"]["probe"] == 0]
    assert got == sizes + [0] * (f - len(sizes))


def test_complex64_sharded_functions_residual(tmp_path):
    res = _launch(tmp_path, "2x1", precision="single")
    calc = tt.MultisliceCalculator(device="cpu", precision="single")
    calc.setup(tt.Trajectory(**{k: getattr(_traj(), k) for k in (
        "atom_types", "positions", "velocities", "box_matrix", "timestep")}),
        device_output=True, use_cache=False,
        **dict(SETUP, probe_positions=[tuple(q) for q in PG]))
    wf = calc.run(progress=False).wavefunction_data
    got = _whole(res, "wf", 1, 0)
    assert got.dtype == np.complex64
    assert residual(got, wf.numpy()) <= 1e-6
    want = tt.TACAWData(calc._wf_data(wf)).intensity
    assert residual(_whole(res, "fn_intensity_crop", 2, 0), want) <= 1e-6


# --- the mesh itself ----------------------------------------------------------

class StubMesh:
    """The parts of a DeviceMesh that the shape checks read."""
    mesh_dim_names = ("frame", "probe")

    def __init__(self, f, p):
        self.shape = (f, p)

    def size(self, dim=None):
        return self.shape[0] * self.shape[1] if dim is None \
            else self.shape[dim]

    def get_local_rank(self, axis):
        return 0


def _message(fn):
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


@pytest.mark.parametrize("f,p,frames,probes", [(3, 1, 8, None),
                                               (1, 3, None, 4),
                                               (4, 2, 6, 8)])
def test_check_divisible_messages_match_jax(f, p, frames, probes):
    jm = jmake_mesh(f, p, jax.devices()[:f * p])
    assert _message(lambda: tsh._check_divisible(
        StubMesh(f, p), n_frames=frames, n_probes=probes)) == _message(
        lambda: jsh._check_divisible(jm, n_frames=frames, n_probes=probes))


def test_kx_divisibility_message_matches_jax():
    class Arr:
        shape = (4, 8, 17, 29)
    jm = jmake_mesh(2, 1, jax.devices()[:2])
    for tfn, jfn in ((tsh.tacaw_spectrum_sharded, jsh.tacaw_spectrum_sharded),
                     (tsh.tacaw_probe_spectra_sharded,
                      jsh.tacaw_probe_spectra_sharded)):
        assert _message(lambda: tfn(Arr(), StubMesh(2, 1))) == \
            _message(lambda: jfn(Arr(), jm))


@pytest.mark.parametrize("n,f,p", [(8, None, None), (8, 2, None),
                                   (8, None, 4), (6, 3, 2), (4, 3, None)])
def test_mesh_extents_match_jax(n, f, p):
    try:
        want = tuple(jmake_mesh(f, p, jax.devices()[:n]).devices.shape)
    except ValueError as e:
        with pytest.raises(ValueError, match=re.escape(str(e))):
            tmesh._extents(n, f, p)
        return
    assert tmesh._extents(n, f, p) == want


@pytest.mark.parametrize("world,local,p", [(4, 2, 1), (4, 2, 2), (4, 4, 2),
                                           (8, 4, 4), (4, 4, 1)])
def test_multihost_layout(world, local, p):
    """Probe shards stay inside a node; the frame axis crosses nodes."""
    grid = tmesh.multihost_layout(world, local, p)
    assert grid.shape == (world // p, p)
    np.testing.assert_array_equal(np.sort(grid.ravel()), np.arange(world))
    for row in grid:
        assert len({int(r) // local for r in row}) == 1


def test_multihost_layout_refuses_probe_shards_across_nodes():
    assert "per-host device count" in _message(
        lambda: tmesh.multihost_layout(4, 2, 4))
    assert "whole number of nodes" in _message(
        lambda: tmesh.multihost_layout(6, 4, 1))


@pytest.mark.parametrize("dtype,backend,ranks,cards,want", [
    ("cpu", None, 4, 0, "gloo"), ("cpu", "gloo", 2, 0, "gloo"),
    ("cuda", None, 1, 1, "nccl"), ("cuda", None, 4, 4, "nccl"),
    ("cuda", "gloo", 4, 1, "gloo"), ("cuda", "nccl", 2, 8, "nccl")])
def test_backend_choice(dtype, backend, ranks, cards, want):
    assert tmesh.pick_backend(dtype, backend, ranks, cards) == want


@pytest.mark.parametrize("dtype,backend,ranks,cards,match", [
    ("cuda", None, 4, 1, "pass backend='gloo'"),
    ("cuda", "nccl", 4, 1, "NCCL needs a card a rank"),
    ("cpu", "nccl", 1, 0, "gloo backend"),
    ("cuda", "mpi", 1, 1, "unknown backend")])
def test_backend_refusals(dtype, backend, ranks, cards, match):
    with pytest.raises(ValueError, match=match):
        tmesh.pick_backend(dtype, backend, ranks, cards)


def test_world_of_one_takes_the_unsharded_path(tmp_path):
    """make_mesh in a single process forms a world of one: a 1 x 1 mesh
    whose DTensors take the analysis facades' unsharded paths, equal to
    the device_output run bit for bit; make_multihost_mesh degrades to
    it."""
    import torch.distributed as dist
    mesh = tmesh.make_mesh(device="cpu")
    try:
        assert tuple(mesh.shape) == (1, 1)
        assert mesh.mesh_dim_names == ("frame", "probe")
        assert tuple(tmesh.make_multihost_mesh(device="cpu").shape) == (1, 1)
        traj = tt.Trajectory(**{k: getattr(_traj(), k) for k in (
            "atom_types", "positions", "velocities", "box_matrix",
            "timestep")})
        kw = dict(SETUP, probe_positions=[tuple(q) for q in PG],
                  use_cache=False)
        calc = tt.MultisliceCalculator(device="cpu", precision="double")
        calc.setup(traj, mesh=mesh, **kw)
        wf = calc.run(progress=False)
        assert tsh.is_sharded(wf.wavefunction_data)
        assert tsh.sharded_mesh_of(wf.wavefunction_data) is None
        ref = tt.MultisliceCalculator(device="cpu", precision="double")
        ref.setup(traj, device_output=True, **kw)
        wf0 = ref.run(progress=False)
        assert torch.equal(wf.wavefunction_data.to_local(),
                           wf0.wavefunction_data)
        np.testing.assert_array_equal(tt.TACAWData(wf).spectrum(),
                                      tt.TACAWData(wf0).spectrum())
        wf.save(tmp_path / "wf.npz")
        back = tt.WFData.load(tmp_path / "wf.npz", device="cpu")
        np.testing.assert_array_equal(back.wavefunction_data,
                                      wf0.wavefunction_data.numpy())
        x, y, d = tptycho.scan_grid_data(wf)
        np.testing.assert_array_equal(d, tptycho.scan_grid_data(wf0)[2])
    finally:
        dist.destroy_process_group()


def test_devices_prints_the_torchrun_world(monkeypatch, capsys):
    """``python -m pyslice_tpu_torch devices`` under torchrun prints the
    world and make_mesh()'s layout (factor_mesh over the world size)."""
    from pyslice_tpu_torch.__main__ import main as tmain
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i: "card")
    for k, v in dict(WORLD_SIZE="4", RANK="2", LOCAL_RANK="2",
                     LOCAL_WORLD_SIZE="4").items():
        monkeypatch.setenv(k, v)
    assert tmain(["devices"]) == 0
    out = capsys.readouterr().out
    assert "torchrun world: 4 rank(s), this is rank 2" in out
    assert "make_mesh(): frame=4 x probe=1, ranks [[0], [1], [2], [3]]" \
        in out
