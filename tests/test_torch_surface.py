"""The port's direct-kernel surface against pyslice_tpu's: Potential ->
Propagate (float64 to 1e-10, complex64 to the 1e-6 residual, the
reference's squeeze semantics), set_default_precision, kirkland,
loadKirkland, getZfromElementName and the top-level exports; plus the
port's pins: WFData.load and kirkland run on the card by default, the
calculator's device_output memory warning points at the streaming engines,
and neither the port nor chip_smoke.py imports JAX."""

import logging
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import pyslice_tpu as jt
from pyslice_tpu.core.dtypes import DOUBLE as J_DOUBLE, SINGLE as J_SINGLE

import pyslice_tpu_torch as tt
from pyslice_tpu_torch.core import dtypes as tdtypes
from pyslice_tpu_torch.engine import calculator as tcalc

from fixtures import hbn_thermal
from oracle import residual

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent


def _frame():
    traj = hbn_thermal(n_frames=1, sigma=0.05, seed=2)
    g = jt.grid_from_trajectory(traj, sampling=0.2, slice_thickness=0.8)
    return traj, g


def _rel(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    return np.abs(got - want).max() / np.abs(want).max()


def _potentials(precision):
    traj, g = _frame()
    jprec = J_DOUBLE if precision == "double" else J_SINGLE
    jpot = jt.Potential(g.xs, g.ys, g.zs, traj.positions[0],
                        traj.atom_types, precision=jprec)
    tpot = tt.Potential(g.xs, g.ys, g.zs, traj.positions[0],
                        traj.atom_types, device="cpu", precision=precision)
    return g, jpot, tpot


@pytest.mark.parametrize("precision", ["double", "single"])
def test_potential_matches_jax(precision):
    g, jpot, tpot = _potentials(precision)
    assert tuple(tpot.array.shape) == (len(g.xs), len(g.ys), len(g.zs))
    assert tuple(tpot.array_szy.shape) == (len(g.zs), len(g.xs), len(g.ys))
    assert tpot.n_slices == jpot.n_slices
    np.testing.assert_array_equal(tpot.kxs, jpot.kxs)
    if precision == "double":
        assert _rel(tpot.array, jpot.array) <= 1e-10
    else:
        assert residual(tpot.array.numpy(), np.asarray(jpot.array)) <= 1e-6
    np.testing.assert_array_equal(tpot.to_cpu(), tpot.array.numpy())
    with pytest.raises(ValueError, match="debye_waller"):
        tt.Potential(g.xs, g.ys, g.zs, np.zeros((1, 3)), [5], device="cpu",
                     plan=tpot.plan, debye_waller={"B": 0.5})


@pytest.mark.parametrize("precision", ["double", "single"])
def test_propagate_matches_jax_and_multislice(precision):
    g, jpot, tpot = _potentials(precision)
    jprec = J_DOUBLE if precision == "double" else J_SINGLE
    jprobe = jt.Probe(g.xs, g.ys, 25, 100e3, precision=jprec)
    tprobe = tt.Probe(g.xs, g.ys, 25, 100e3, precision=precision,
                      device="cpu")
    before = tprobe.array.clone()
    out = tt.Propagate(tprobe, tpot)
    assert out.shape == tprobe.array.shape                 # 2-D in, 2-D out
    assert torch.equal(tprobe.array, before)               # not mutated
    jout = np.asarray(jt.Propagate(jprobe, jpot))
    if precision == "double":
        assert _rel(out, jout) <= 1e-10
    else:
        assert residual(out.numpy(), jout) <= 1e-6
    dz = float(g.zs[1] - g.zs[0])
    want = tt.multislice(tprobe.array[None], tpot.array_szy, tpot.kxs,
                         tpot.kys, eV=100e3, dz=dz, precision=precision)[0]
    assert torch.equal(out, want)
    pos = tt.probe_grid([1.0, 3.0], [1.0, 3.0], 2, 1)
    batch = tt.create_batched_probes(tprobe, pos)
    bout = tt.Propagate(batch, tpot)
    assert bout.shape == (2,) + tuple(tprobe.array.shape)
    jb = np.asarray(jt.Propagate(jt.create_batched_probes(jprobe, pos), jpot))
    if precision == "double":
        assert _rel(bout, jb) <= 1e-10
    else:
        assert residual(bout.numpy(), jb) <= 1e-6


def test_set_default_precision():
    assert tt.get_precision() is tt.SINGLE
    try:
        tt.set_default_precision("double")
        assert tt.get_precision() is tt.DOUBLE
        assert tt.get_precision(None) is tt.DOUBLE
        assert tt.get_precision("single") is tt.SINGLE
        _, g = _frame()
        probe = tt.Probe(g.xs, g.ys, 0, 100e3, device="cpu")
        assert probe.array.dtype == torch.complex128
    finally:
        tdtypes.set_default_precision(tt.SINGLE)
    assert tt.get_precision() is tt.SINGLE


def test_kirkland_entry_points_match_jax():
    qsq = np.linspace(0.0, 4.0, 7)
    for z in (5, "N", 14):
        got = tt.kirkland(qsq, z, device="cpu")
        assert isinstance(got, torch.Tensor)
        np.testing.assert_allclose(got.numpy(), np.asarray(jt.kirkland(qsq, z)),
                                   rtol=1e-12)
    np.testing.assert_array_equal(tt.loadKirkland(), jt.loadKirkland())
    for el in ("H", "B", "N", "Tl", "U"):
        assert tt.getZfromElementName(el) == jt.getZfromElementName(el)


def test_kirkland_runs_on_the_card_by_default():
    """An array goes to the card unless device="cpu" is given: without a
    card it raises rather than carrying on on the CPU. A tensor stays on
    its own device."""
    import inspect
    assert inspect.signature(tt.kirkland).parameters["device"].default \
        == "cuda"
    qsq = np.linspace(0.0, 4.0, 7)
    assert tt.kirkland(torch.as_tensor(qsq), 5).device == torch.device("cpu")
    if torch.cuda.is_available():
        assert tt.kirkland(qsq, 5).device.type == "cuda"
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            tt.kirkland(qsq, 5)


def test_top_level_exports():
    """The names the JAX package exports for this slice, exported here."""
    for name in ("Potential", "Propagate", "set_default_precision",
                 "kirkland", "loadKirkland", "getZfromElementName",
                 "TrajectoryStream", "BeamSet", "SMatrix", "build_beams",
                 "compute_smatrix", "smatrix_exit_kspace", "smatrix_reduce"):
        assert name in jt.__all__ or hasattr(jt, name), name
        assert name in tt.__all__ and hasattr(tt, name), name
    assert "StreamingTACAW" in tt.__all__ and "StreamingHAADF" in tt.__all__


def test_wfdata_load_builds_its_probe_on_the_card(tmp_path):
    """WFData.load's probe goes to the card unless device="cpu" is given:
    without a card it raises rather than carrying on on the CPU."""
    import inspect
    assert inspect.signature(tt.WFData.load).parameters["device"].default \
        == "cuda"
    traj = tt.Trajectory(**{k: getattr(hbn_thermal(n_frames=2), k) for k in (
        "atom_types", "positions", "velocities", "box_matrix", "timestep")})
    calc = tt.MultisliceCalculator(device="cpu")
    calc.setup(traj, sampling=0.25, slice_thickness=0.8, use_cache=False)
    calc.run(progress=False).save(tmp_path / "wf.npz")
    back = tt.WFData.load(tmp_path / "wf.npz", device="cpu")
    assert back.probe.device == torch.device("cpu")
    assert isinstance(back.wavefunction_data, np.ndarray)
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            tt.WFData.load(tmp_path / "wf.npz")


def test_device_output_memory_warning(caplog, monkeypatch):
    """Above half the device's free memory, device_output=True warns at
    set-up and points at the streaming engines."""
    traj = tt.Trajectory(**{k: getattr(hbn_thermal(n_frames=3), k) for k in (
        "atom_types", "positions", "velocities", "box_matrix", "timestep")})
    kw = dict(sampling=0.25, slice_thickness=0.8, use_cache=False,
              device_output=True)
    calc = tt.MultisliceCalculator(device="cpu")
    assert tcalc.device_memory_limit(calc.device) is None
    with caplog.at_level(logging.WARNING, logger=tcalc.__name__):
        calc.setup(traj, **kw)
    assert not caplog.records
    est = 3 * calc.nx * calc.ny * 8              # 1 probe x 3 frames, c64
    for limit, warns in ((2 * est + 8, False), (2 * est - 8, True)):
        caplog.clear()
        monkeypatch.setattr(tcalc, "device_memory_limit",
                            lambda device, _l=limit: _l)
        with caplog.at_level(logging.WARNING, logger=tcalc.__name__):
            calc.setup(traj, **kw)
        assert bool(caplog.records) == warns, limit
    assert "StreamingTACAW/StreamingHAADF" in caplog.text


IMAGING_NAMES = ["crystal", "orthogonal_supercell", "substitute", "vacancies",
                 "ssb_reconstruct", "icom_reconstruct", "epie_reconstruct",
                 "scan_grid_data", "iwfr_reconstruct", "hrtem_image",
                 "image_from_exit_wave", "objective_transfer", "focal_series",
                 "precession_diffraction", "precession_tilts"]
IMAGING_MODULES = ["pyslice_tpu_torch.data.crystals",
                   "pyslice_tpu_torch.engine.coherence",
                   "pyslice_tpu_torch.engine.ctem",
                   "pyslice_tpu_torch.engine.ped",
                   "pyslice_tpu_torch.analysis.ewr",
                   "pyslice_tpu_torch.analysis.ptychography"]
MEASURED_NAMES = ["load_4dstem", "center_datacube", "k_sampling_from_disk",
                  "scan_positions", "save_4dstem", "calibrate_datacube",
                  "com_field", "solve_rotation", "estimate_dose"]
MEASURED_MODULES = ["pyslice_tpu_torch.__main__",
                    "pyslice_tpu_torch.engine.config",
                    "pyslice_tpu_torch.parallel.mesh",
                    "pyslice_tpu_torch.io.vasp", "pyslice_tpu_torch.io.amber",
                    "pyslice_tpu_torch.io.gsd",
                    "pyslice_tpu_torch.io.native_loader",
                    "pyslice_tpu_torch.io.data4d",
                    "pyslice_tpu_torch.analysis.calibration",
                    "pyslice_tpu_torch.utils.profiling"]
PARALLEL_MODULES = ["pyslice_tpu_torch.parallel.mesh",
                    "pyslice_tpu_torch.parallel.sharded",
                    "pyslice_tpu_torch.parallel.dryrun"]
EXAMPLE_MODULES = ["pyslice_tpu_torch.examples." + n for n in (
    "_fixtures", "make_fixture", "tacaw_demo", "si_dumbbells",
    "realistic_stem", "diffraction_toolkit", "ptychography_demo",
    "inverse_potential", "calibration_demo", "experimental_calibration",
    "walkthrough", "make_notebook", "verify_e2e")]
# a percent-format notebook: importing it runs it, so the check reads its
# import statements instead (none of JAX's; the port's imported)
WALKTHROUGH = "pyslice_tpu_torch.examples.walkthrough"


def test_port_imports_no_jax():
    """Every module of the port (the imaging toolkit's, the measured-data
    and command-line modules, ``__main__`` included, the multi-GPU modules
    parallel.{mesh,sharded,dryrun} and the examples, by name), and
    chip_smoke.py, imports with jax, optax, pyslice_tpu and the tests'
    fixtures blocked (the walkthrough, whose import runs it, by its import
    statements: none names them, and the port's modules it names import),
    and the package root exports the imaging toolkit's and the
    measured-data names."""
    code = textwrap.dedent(f"""
        import ast, importlib, pkgutil, sys
        for blocked in ("jax", "optax", "pyslice_tpu", "tests",
                        "tests.fixtures"):
            sys.modules[blocked] = None
        sys.path.insert(0, {str(ROOT)!r})
        import pyslice_tpu_torch
        names = [m.name for m in pkgutil.walk_packages(
            pyslice_tpu_torch.__path__, "pyslice_tpu_torch.")]
        missing = set({IMAGING_MODULES + MEASURED_MODULES
                       + PARALLEL_MODULES + EXAMPLE_MODULES!r}) - set(names)
        assert not missing, missing
        for name in names:
            if name != {WALKTHROUGH!r}:
                importlib.import_module(name)
                continue
            spec = importlib.util.find_spec(name)
            for node in ast.walk(ast.parse(open(spec.origin).read())):
                mods = ([a.name for a in node.names]
                        if isinstance(node, ast.Import) else
                        [node.module] if isinstance(node, ast.ImportFrom)
                        else [])
                for mod in mods:
                    assert mod.split(".")[0] not in ("jax", "optax",
                                                     "pyslice_tpu",
                                                     "tests"), mod
                    if mod.startswith("pyslice_tpu_torch"):
                        importlib.import_module(mod)
        for name in {IMAGING_NAMES + MEASURED_NAMES!r}:
            assert name in pyslice_tpu_torch.__all__, name
            getattr(pyslice_tpu_torch, name)
        import chip_smoke
        for blocked in ("jax", "optax", "pyslice_tpu", "tests.fixtures"):
            assert blocked not in [k for k, v in sys.modules.items() if v]
        print(len(names))
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 56
