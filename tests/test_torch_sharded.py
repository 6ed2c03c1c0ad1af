"""Port parity for multi-GPU runs, end to end: the facades that take a
(frame, probe) mesh, run in real Gloo ranks on the CPU.

``pyslice_tpu_torch.parallel.dryrun`` runs in 2 x 2 and 4 x 1 ranks (the
4 x 1 mesh pads the odd kx extent 17 to 20 before the all_to_all) on
tests/test_sharding.py's problem: hbn_thermal(n_frames=8, nx=2, ny=2),
sampling 0.3, 4 probes, float64. Its outputs are held to 1e-10 max-
relative against the JAX package on a mesh of the same shape (the 8
virtual CPU devices of tests/conftest.py; MultisliceCalculator(mesh=), the
six TACAW methods, HAADF, the detectors, scan_grid_data) or, where the
JAX package gives the same numbers unsharded, against its unsharded run
(the streams, the S-matrix, msp_reconstruct), and
against the single-process port (the same dry run in a world of one, where
every facade takes its unsharded path). Checkpoint/resume on the mesh is
bit-identical, and msp_reconstruct's parameters are bit-identical across
ranks. One complex64 launch is held to the 1e-6 residual. Each mesh's
ranks are launched once (module fixtures) with a time limit of their own.
"""

import numpy as np
import pytest
import torch

import jax
from pyslice_tpu.analysis import detectors as jdet
from pyslice_tpu.analysis import ptychography as jptycho
from pyslice_tpu.analysis.haadf import HAADFData as JHAADF
from pyslice_tpu.analysis.tacaw import TACAWData as JTACAW
from pyslice_tpu.core.dtypes import DOUBLE as JDOUBLE
from pyslice_tpu.engine import smatrix as jsm
from pyslice_tpu.engine.calculator import MultisliceCalculator as JCalc
from pyslice_tpu.engine.streaming import (StreamingHAADF as JSHAADF,
                                          StreamingTACAW as JSTACAW)
from pyslice_tpu.parallel.mesh import make_mesh as jmake_mesh
from pyslice_tpu.physics.probe import Probe as JProbe

import pyslice_tpu_torch as tt
from pyslice_tpu_torch.parallel import dryrun
from pyslice_tpu_torch.parallel.mesh import make_mesh

from fixtures import hbn_thermal
from oracle import residual
from test_torch_ptychography import DZ, EV, MRAD, NZ, _problem

torch.set_num_threads(2)

LAUNCH_S = 240.0        # each launch of the ranks: its own time limit
MESHES = {"2x2": (2, 2), "4x1": (4, 1)}
PG = tt.probe_grid([1, 3], [1, 3], 2, 2)
SETUP = dict(aperture=20.0, voltage_eV=100e3, sampling=0.3,
             slice_thickness=0.8, probe_positions=PG.tolist())
MSP = dict(steps=2, batch=4, seed=3)


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.abs(got - want).max() / np.abs(want).max()


def _traj():
    return hbn_thermal(n_frames=8, sigma=0.05, nx=2, ny=2, seed=7)


def _config(out, precision="double", parts=None):
    dryrun.save_trajectory(out / "problem.npz", _traj())
    p = _problem()
    np.savez(out / "msp.npz", data=p["inten"], scan=p["scan"],
             probe=p["probe"], xs=p["xs"], ys=p["ys"], mrad=MRAD, eV=EV,
             n_slices=NZ, dz=DZ)
    cfg = {"precision": precision, "problem": "problem.npz",
           "setup": SETUP, "msp": {"file": "msp.npz", "kwargs": MSP}}
    if parts is not None:
        cfg["parts"] = parts
    return cfg


class Run:
    """The ranks' outputs: replicated values and sharded blocks put back
    together from the ranks' mesh coordinates."""

    def __init__(self, res):
        self.res = res

    def rep(self, key):
        return self.res[0][0][key]

    def whole(self, key, frame_dim, probe_dim):
        blocks = {}
        for arrays, rec in self.res:
            c = rec["coords"]
            if key in arrays:       # a block replicated over frames: row 0
                blocks[(c["frame"], c["probe"])] = arrays[key]
        nf = 1 + max(f for f, _ in blocks)
        npb = 1 + max(p for _, p in blocks)
        rows = []
        for p in range(npb):
            if frame_dim is None:
                rows.append(blocks[(0, p)])
            else:
                rows.append(np.concatenate([blocks[(f, p)]
                                            for f in range(nf)],
                                           axis=frame_dim))
        return np.concatenate(rows, axis=probe_dim)


SHARDED = {"wf": (1, 0), "tacaw_intensity": (2, 0),
           "fn_intensity_pad": (2, 0), "fn_intensity_crop": (2, 0),
           "stream_intensity": (None, 1)}


def _port_single(out, cfg):
    """The dry run's parts in this process, in a world of one (a 1 x 1
    mesh: every facade takes its unsharded path)."""
    import torch.distributed as dist
    mesh = make_mesh(device="cpu")
    try:
        r = dryrun.Rank(out, mesh, torch.device("cpu"), cfg)
        for part in cfg.get("parts", dryrun.PARTS):
            getattr(r, part)(dict(cfg, **cfg.get(part, {})))
        return r.arrays
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def single(tmp_path_factory):
    out = tmp_path_factory.mktemp("single")
    return _port_single(out, _config(out, parts=["stem", "stream",
                                                 "smatrix"]))


@pytest.fixture(scope="module", params=list(MESHES))
def ranks(request, tmp_path_factory):
    out = tmp_path_factory.mktemp(f"ranks{request.param}")
    f, p = MESHES[request.param]
    res = dryrun.launch(out, f * p, device="cpu", mesh=request.param,
                        config=_config(out), timeout=LAUNCH_S)
    run = Run(res)
    run.out = out
    return request.param, run


def _msp_inputs(run):
    """The msp problem as the ranks read it, from their own config's file:
    the references below start from the same bits as the ranks."""
    with np.load(run.out / "msp.npz") as z:
        return {k: z[k] for k in z.files}


def _jax_refs(shape, run):
    """The JAX package's results for the dry run's arguments: the facades
    on a mesh of the same shape, the streams and the S-matrix unsharded."""
    f, p = shape
    jm = jmake_mesh(f, p, jax.devices()[:f * p])
    traj = _traj()
    calc = JCalc(precision=JDOUBLE)
    calc.setup(traj, mesh=jm, use_cache=False, **SETUP)
    wf = calc.run()
    out = {"wf": np.asarray(wf.wavefunction_data)}
    tac = JTACAW(wf)
    f1 = float(run.rep("arg_f1"))
    mask, last = run.rep("arg_mask"), int(run.rep("arg_last"))
    kxp, kyp = run.rep("arg_kx_path"), run.rep("arg_ky_path")
    for name, val in (
            ("spectrum", tac.spectrum()),
            ("spectrum_p", tac.spectrum(last)),
            ("spectrum_image", tac.spectrum_image(f1)),
            ("diffraction", tac.diffraction()),
            ("diffraction_p", tac.diffraction(last)),
            ("spectral_diffraction", tac.spectral_diffraction(f1)),
            ("spectral_diffraction_p", tac.spectral_diffraction(f1, last)),
            ("masked_spectrum", tac.masked_spectrum(mask)),
            ("masked_spectrum_p", tac.masked_spectrum(mask, last)),
            ("dispersion", tac.dispersion(kxp, kyp)),
            ("dispersion_p", tac.dispersion(kxp, kyp, last)),
            ("intensity", tac.intensity)):
        out["tacaw_" + name] = np.asarray(val)
    h = JHAADF(wf)
    out["adf"] = h.calculateADF(45)
    out["adf_int"] = h.calculateADF(45, intensity=True)
    ring, segs = run.rep("arg_ring"), run.rep("arg_segs")
    out["virtual_image"] = jdet.virtual_image(wf, ring)
    out["virtual_segments"] = jdet.virtual_image(wf, segs)
    out["com"] = jdet.center_of_mass(wf)
    out["pacbed"] = jdet.pacbed(wf)
    out["pacbed_sub"] = jdet.pacbed(wf, probe_indices=[0, last])
    out["scan_grid"] = jptycho.scan_grid_data(wf)[2]

    spec, probes = calc.spec, calc._probes_array()
    st = JSTACAW(spec, probes, traj.n_frames, traj.timestep)
    for t in range(traj.n_frames):
        st.add_frame(t, traj.positions[t])
    out["stream_intensity"] = np.asarray(st.intensity())
    out["stream_spectrum"] = st.spectrum()
    for key, kw in (("stream_adf", {}),
                    ("stream_adf_smatrix",
                     dict(mrad=SETUP["aperture"], use_smatrix=True))):
        hs = JSHAADF(spec, probes, PG, collection_angle=45, **kw)
        for t in range(traj.n_frames):
            hs.add_frame(traj.positions[t])
        out[key] = hs.image()
    g = calc.grid
    beams = jsm.build_beams(g.xs, g.ys, SETUP["aperture"],
                            SETUP["voltage_eV"])
    sm = jsm.compute_smatrix(traj.positions[0], spec.plan, beams, xs=g.xs,
                             ys=g.ys, dz=spec.dz, precision=JDOUBLE,
                             kmax2=spec.kmax2)
    out["smatrix_reduce"] = jsm.smatrix_reduce(sm, PG, run.rep("arg_sm_mask"),
                                               precision=JDOUBLE)
    out["smatrix_exit"] = np.asarray(jsm.smatrix_exit_kspace(
        sm, PG[:4], precision=JDOUBLE))
    pm = _msp_inputs(run)
    jprobe = JProbe(pm["xs"], pm["ys"], MRAD, EV, array=pm["probe"],
                    precision=JDOUBLE)
    # unsharded: the JAX package's msp_reconstruct(mesh=) stops inside
    # shard_map on this JAX (its adjoint's custom VJP returns a cotangent
    # that varies over the mesh axes for a replicated input); the mean of
    # the ranks' local-mean gradients is the global-mean gradient anyway
    res = jptycho.msp_reconstruct(pm["data"], pm["scan"], jprobe,
                                  n_slices=NZ, dz=DZ, **MSP)
    for k, v in res.items():
        out["msp_" + k] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def refs(ranks):
    name, run = ranks
    return _jax_refs(MESHES[name], run)


def _port(run, key):
    if key in SHARDED:
        return run.whole(key, *SHARDED[key])
    return run.rep(key)


JAX_KEYS = (["wf", "adf", "adf_int", "virtual_image", "virtual_segments",
             "com", "pacbed", "pacbed_sub", "scan_grid", "stream_intensity",
             "stream_spectrum", "stream_adf", "stream_adf_smatrix",
             "smatrix_reduce", "smatrix_exit"]
            + ["tacaw_" + m for m in (
                "spectrum", "spectrum_p", "spectrum_image", "diffraction",
                "diffraction_p", "spectral_diffraction",
                "spectral_diffraction_p", "masked_spectrum",
                "masked_spectrum_p", "dispersion", "dispersion_p",
                "intensity")])


@pytest.mark.parametrize("key", JAX_KEYS)
def test_mesh_run_matches_jax(ranks, refs, key):
    _, run = ranks
    assert _rel(_port(run, key), refs[key]) <= 1e-10, key


@pytest.mark.parametrize("key", JAX_KEYS)
def test_mesh_run_matches_single_process_port(ranks, single, key):
    _, run = ranks
    assert _rel(_port(run, key), single[key]) <= 1e-10, key


@pytest.mark.parametrize("key", ["potential", "probe", "positions",
                                 "losses"])
def test_msp_reconstruct_mesh_matches_jax(ranks, refs, key):
    """Two Adam steps with every minibatch split over the ranks, held to
    the 1e-8 of the unsharded msp parity test; the parameters are the same
    bits on every rank."""
    _, run = ranks
    got = [a["msp_" + key] for a, _ in run.res]
    for g in got[1:]:
        np.testing.assert_array_equal(g, got[0])
    assert _rel(got[0], refs["msp_" + key]) <= 1e-8, key


def test_msp_minibatch_gradient_matches_single_process(ranks):
    """The mesh-averaged gradient of the first minibatch equals the
    single-process gradient of the whole minibatch."""
    from pyslice_tpu_torch.analysis import ptychography as tp
    _, run = ranks
    pm = _msp_inputs(run)
    probe = tt.Probe(pm["xs"], pm["ys"], MRAD, EV, array=pm["probe"],
                     precision="double", device="cpu")
    r, batches = tp._msp_setup(pm["data"], pm["scan"], probe, NZ, DZ,
                               **MSP)
    # each rank's own gradient of its block first, so that a mean that
    # misses names the rank that computed otherwise
    own = {}
    for arrays, rec in run.res:
        share = arrays["msp_share"]
        _, g = r.grads(share)
        own[rec["rank"]] = (share.tolist(), _rel(arrays["msp_grad_local_v"],
                                                 g["v"].numpy()))
    assert all(e <= 1e-10 for _, e in own.values()), own
    loss, grads = r.grads(batches[0])
    assert _rel(run.rep("msp_grad_v"), grads["v"].numpy()) <= 1e-10, own
    assert abs(float(run.rep("msp_grad_loss")) - float(loss)) <= \
        1e-12 * abs(float(loss))


@pytest.mark.parametrize("check", ["stream_resume_bitwise",
                                   "haadf_resume_bitwise"])
def test_stream_checkpoint_resume_on_mesh_bitwise(ranks, check):
    """A checkpoint halfway (one manifest and one set of files a rank),
    restored into a fresh stream on the same mesh and fed the rest, gives
    the uninterrupted stream's bits on every rank."""
    _, run = ranks
    assert all(rec["checks"][check] for _, rec in run.res)


def test_ranks_record_their_mesh(ranks):
    """Every rank of the mesh ran and recorded its coordinates, the Gloo
    backend and the all_to_all's seconds."""
    name, run = ranks
    f, p = MESHES[name]
    assert sorted(rec["rank"] for _, rec in run.res) == list(range(f * p))
    for _, rec in run.res:
        assert rec["mesh"] == [f, p] and rec["backend"] == "gloo"
        assert rec["stats"]["all_to_all_s"] > 0


def test_resume_refused_on_another_mesh(ranks):
    """The checkpoint key holds the mesh shape: the same ranks on a mesh of
    another shape refuse the checkpoint."""
    _, run = ranks
    assert all(rec["checks"]["resume_refused_on_other_mesh"]
               for _, rec in run.res)


def test_complex64_mesh_run_residual(tmp_path):
    """complex64 in 2 x 2 ranks against the single-process complex64 port:
    the exit waves and the TACAW spectrum to the 1e-6 residual."""
    cfg = _config(tmp_path, precision="single", parts=["stem"])
    cfg["stem"] = {"functions": False}
    run = Run(dryrun.launch(tmp_path, 4, device="cpu", mesh="2x2",
                            config=cfg, timeout=LAUNCH_S))
    calc = tt.MultisliceCalculator(device="cpu", precision="single")
    calc.setup(tt.Trajectory(**{k: getattr(_traj(), k) for k in (
        "atom_types", "positions", "velocities", "box_matrix", "timestep")}),
        device_output=True, use_cache=False, **dict(
            SETUP, probe_positions=[tuple(q) for q in PG]))
    wf = calc.run(progress=False)
    got = run.whole("wf", 1, 0)
    assert got.dtype == np.complex64
    assert residual(got, wf.wavefunction_data.numpy()) <= 1e-6
    assert residual(run.rep("tacaw_spectrum"),
                    tt.TACAWData(wf).spectrum()) <= 1e-6
