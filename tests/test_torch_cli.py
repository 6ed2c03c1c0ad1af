"""Port parity: the command line (``python -m pyslice_tpu_torch``) and
SimulationConfig against pyslice_tpu's: the config round trip and
config.json loading across the packages, ``run`` in tacaw and haadf mode
(``--device cpu --precision double``) against the JAX package's ``main`` on
tests/test_cli.py's dump (.npy outputs to 1e-10), ``info``'s lines,
``calibrate``'s report.json, and the device rule: without a card and
without ``--device cpu`` the command stops with a message."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from pyslice_tpu.__main__ import main as jmain
from pyslice_tpu.engine.config import SimulationConfig as JConfig
from pyslice_tpu_torch.__main__ import main as tmain
from pyslice_tpu_torch.engine.config import SimulationConfig as TConfig
from pyslice_tpu_torch.io import lammps as tlammps
from pyslice_tpu_torch.parallel.mesh import factor_mesh
from tests.fixtures import hbn_thermal

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parent.parent


@pytest.fixture()
def dump(tmp_path):
    traj = hbn_thermal(n_frames=3, sigma=0.05)
    path = tmp_path / "t.lammpstrj"
    tlammps.write_lammps_dump(path, np.where(traj.atom_types == 5, 1, 2),
                              traj.positions, traj.velocities,
                              traj.box_matrix)
    return path


@pytest.fixture()
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_config_roundtrip_and_cross_loading(tmp_path):
    kw = dict(trajectory="x.lammpstrj", timestep=0.005,
              atom_mapping={1: "B", 2: 7}, probe_grid=(0, 1, 0, 1, 2, 2),
              mode="haadf", tilt=(1.0, -2.0), aberrations={"C3": 1e7},
              probe_positions=[(0.5, 0.5), (1.0, 2.0)])
    port, jax_cfg = TConfig(**kw), JConfig(**kw)
    assert port.to_json() == jax_cfg.to_json()
    p = tmp_path / "c.json"
    port.save(p)
    assert TConfig.load(p) == port
    assert JConfig.load(p) == jax_cfg          # the port's file in JAX
    q = tmp_path / "j.json"
    jax_cfg.save(q)
    assert TConfig.load(q) == port             # JAX's file in the port
    cfg = TConfig(probe_grid=(0, 1, 0, 1, 2, 3))
    np.testing.assert_array_equal(
        cfg.resolve_probe_positions(),
        JConfig(probe_grid=(0, 1, 0, 1, 2, 3)).resolve_probe_positions())
    assert TConfig().resolve_probe_positions() is None
    with pytest.raises(ValueError, match="Unknown config keys"):
        TConfig.from_json(json.dumps({"device": "cuda"}))


def _run_both(dump, tmp_path, extra):
    args = ["run", "--trajectory", str(dump), "--timestep", "0.005",
            "--atom-mapping", "1=B,2=N", "--sampling", "0.3",
            "--slice-thickness", "0.8", "--precision", "double",
            "--no-cache", "--cache-root", str(tmp_path / "cache"), *extra]
    tout, jout = tmp_path / "port", tmp_path / "jax"
    assert tmain([*args, "--output-dir", str(tout), "--device", "cpu"]) == 0
    assert jmain([*args, "--output-dir", str(jout)]) == 0
    t_cfg = json.loads((tout / "config.json").read_text())
    j_cfg = json.loads((jout / "config.json").read_text())
    assert t_cfg.pop("output_dir") != j_cfg.pop("output_dir")
    assert t_cfg == j_cfg
    return tout, jout


@pytest.mark.parametrize("mode,files", [
    ("tacaw", ("frequencies.npy", "spectrum.npy", "diffraction.npy")),
    ("haadf", ("haadf_image.npy",)),
])
def test_run_matches_jax(mode, files, dump, tmp_path):
    extra = ["--mode", mode]
    if mode == "haadf":
        extra += ["--aperture", "30", "--probe-grid", "1,3,1,3,2,2"]
    tout, jout = _run_both(dump, tmp_path, extra)
    for name in files:
        got, want = np.load(tout / name), np.load(jout / name)
        assert got.shape == want.shape
        scale = np.abs(want).max()
        assert np.abs(got - want).max() <= 1e-10 * scale, name


def test_run_from_config_and_save_wf(dump, tmp_path):
    """``run --config`` replays a written config.json (flags override
    it); --save-wf writes wf_data.npz."""
    out = tmp_path / "a"
    base = ["--device", "cpu"]
    assert tmain(["run", "--trajectory", str(dump), "--sampling", "0.3",
                  "--slice-thickness", "0.8", "--mode", "wf", "--no-cache",
                  "--output-dir", str(out), *base]) == 0
    assert (out / "wf_data.npz").exists()
    again = tmp_path / "b"
    assert tmain(["run", "--config", str(out / "config.json"),
                  "--output-dir", str(again), *base]) == 0
    a = np.load(out / "wf_data.npz")
    b = np.load(again / "wf_data.npz")
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k])


def test_info_prints_jaxs_lines(dump, capsys):
    assert tmain(["info", str(dump), "--no-cache", "--device", "cpu"]) == 0
    got = capsys.readouterr().out
    assert jmain(["info", str(dump), "--no-cache"]) == 0
    want = capsys.readouterr().out
    assert got == want and "frames:     3" in got


def test_missing_trajectory_returns_2():
    assert tmain(["run", "--mode", "tacaw"]) == 2


def test_without_a_card_the_commands_stop(dump, tmp_path, no_card, capsys):
    out = tmp_path / "o"
    assert tmain(["run", "--trajectory", str(dump), "--output-dir",
                  str(out), "--no-cache"]) != 0
    assert not out.exists()
    assert tmain(["info", str(dump), "--no-cache"]) != 0
    assert tmain(["calibrate", str(tmp_path / "x.emd"), "--scan-step",
                  "0.5"]) != 0
    assert tmain(["devices"]) != 0
    err = capsys.readouterr().err
    assert err.count("--device cpu") == 3 and "no CUDA device" in err


def test_devices_prints_the_mesh(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda i: f"card {i}")
    assert tmain(["devices"]) == 0
    out = capsys.readouterr().out
    assert "4 CUDA device(s)" in out and "cuda:3 card 3" in out
    assert "default mesh: frame=4 x probe=1" in out


@pytest.mark.parametrize("n,frames,probes", [(4, None, None), (4, 2, None),
                                             (8, 3, 8), (6, 4, 9)])
def test_factor_mesh_matches_jax(n, frames, probes):
    from pyslice_tpu.parallel.mesh import factor_mesh as jfactor
    assert factor_mesh(n, frames, probes) == jfactor(n, frames, probes)


def test_calibrate_matches_jax_report(tmp_path, capsys):
    """tests/test_cli.py's calibration cube with a dark frame and a gain
    map: the port's report.json, com.npy and calibrated.emd against the
    JAX package's."""
    h5py = pytest.importorskip("h5py")
    from pyslice_tpu.io.data4d import save_4dstem
    rng = np.random.default_rng(0)
    nk = 24
    kx = np.arange(nk)[:, None]
    ky = np.arange(nk)[None, :]
    cube = np.empty((6, 6, nk, nk))
    for i in range(6):
        for j in range(6):
            cube[i, j] = 50.0 * np.exp(
                -((kx - nk / 2 - 0.2 * i) ** 2
                  + (ky - nk / 2 + 0.1 * j) ** 2) / (2 * 3.0 ** 2))
    cube += rng.random(cube.shape)
    cube[:, :, 3, 5] = 4000.0                    # hot pixel
    dark = rng.random((nk, nk)) * 0.1
    gain = 0.9 + 0.2 * rng.random((nk, nk))
    src = tmp_path / "raw.emd"
    save_4dstem(src, cube * gain + dark)
    np.save(tmp_path / "dark.npy", dark)
    np.save(tmp_path / "gain.npy", gain)
    args = ["calibrate", str(src), "--scan-step", "0.5", "--dark",
            str(tmp_path / "dark.npy"), "--gain", str(tmp_path / "gain.npy"),
            "--apply-ellipse", "--lattice", "0.35", "0", "0", "0.3",
            "--apply-affine"]
    assert tmain([*args, "--output-dir", str(tmp_path / "port"),
                  "--device", "cpu"]) == 0
    assert "descan removed" in capsys.readouterr().out
    assert jmain([*args, "--output-dir", str(tmp_path / "jax")]) == 0
    got = json.loads((tmp_path / "port/report.json").read_text())
    want = json.loads((tmp_path / "jax/report.json").read_text())
    assert got.keys() == want.keys()
    assert got["report"] == want["report"]
    assert got["bad_pixels"] == want["bad_pixels"] >= 1
    assert got["transpose"] == want["transpose"]
    assert got["beam_center_shift"] == want["beam_center_shift"]
    for k in ("rotation_rad", "rotation_skewness", "curl_rms",
              "ellipticity", "ellipse_angle_rad", "dose_e_per_A2"):
        assert got[k] == pytest.approx(want[k], rel=1e-10), k
    np.testing.assert_allclose(got["descan_coeffs"], want["descan_coeffs"],
                               rtol=1e-10, atol=1e-14)
    np.testing.assert_allclose(got["affine_A"], want["affine_A"],
                               rtol=1e-10)
    np.testing.assert_allclose(np.load(tmp_path / "port/com.npy"),
                               np.load(tmp_path / "jax/com.npy"),
                               rtol=1e-10, atol=1e-14)
    with h5py.File(tmp_path / "port/calibrated.emd") as f, \
            h5py.File(tmp_path / "jax/calibrated.emd") as g:
        np.testing.assert_allclose(f["4dstem/datacube"][()],
                                   g["4dstem/datacube"][()], rtol=1e-6)


def test_module_entry_point_runs(dump):
    """``python -m pyslice_tpu_torch`` in a fresh process, with jax and
    pyslice_tpu blocked."""
    code = ("import sys, runpy; sys.modules['jax'] = None; "
            "sys.modules['pyslice_tpu'] = None; "
            f"sys.argv = ['pyslice_tpu_torch', 'info', {str(dump)!r}, "
            "'--no-cache', '--device', 'cpu']; "
            "runpy.run_module('pyslice_tpu_torch', run_name='__main__')")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "frames:     3" in out.stdout
