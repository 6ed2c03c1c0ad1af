"""Port parity: 4D-STEM ingest (io/data4d.py) of pyslice_tpu_torch against
pyslice_tpu's: a file written by either package's save_4dstem loads in the
other, EMD discovery, crop and Poisson-preserving binning, the errors,
center_datacube, k_sampling_from_disk and scan_positions, and a loaded
cube feeding the port's calibration and iCoM."""

import numpy as np
import pytest
import torch

h5py = pytest.importorskip("h5py")

from pyslice_tpu.io import data4d as jd
from pyslice_tpu_torch.io import data4d as td

torch.set_num_threads(2)
CPU = "cpu"


def _write_emd(path, cube, tag=True, extra=False):
    with h5py.File(path, "w") as f:
        g = f.create_group("version_1/data/datacubes/cube0")
        if tag:
            g.attrs["emd_group_type"] = 1
        g.create_dataset("data", data=cube, chunks=(1,) + cube.shape[1:])
        if extra:
            f.create_dataset("unrelated/fourdee",
                             data=np.zeros((2, 2, 4, 4)))


def _same_load(path, **kw):
    got = td.load_4dstem(path, device=CPU, **kw)
    want = jd.load_4dstem(path, **kw)
    assert isinstance(got["data"], torch.Tensor)
    assert got["data"].dtype == torch.float64
    np.testing.assert_array_equal(got["data"].numpy(), want["data"])
    assert got["scan_shape"] == want["scan_shape"]
    assert got["dataset"] == want["dataset"]
    if "positions" in want:
        np.testing.assert_array_equal(got["positions"], want["positions"])
    return got


@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("flat", [False, True])
def test_save_load_across_packages(writer, flat, tmp_path):
    """save_4dstem of either package (a tensor or an array, 4-D or
    flattened with scan_shape) loads bit-equal through both loaders."""
    cube = np.random.default_rng(0).random((3, 4, 8, 6))
    p = tmp_path / "out.emd"
    data = cube.reshape(12, 8, 6) if flat else cube
    kw = dict(scan_shape=(3, 4)) if flat else {}
    if writer == "port":
        td.save_4dstem(p, torch.as_tensor(data), **kw)
    else:
        jd.save_4dstem(p, data, **kw)
    r = _same_load(p, scan_step=0.5)
    assert r["scan_shape"] == (3, 4)
    np.testing.assert_array_equal(r["data"].numpy().reshape(cube.shape),
                                  cube.astype(np.float32))
    with h5py.File(p) as f:
        assert f["4dstem"].attrs["emd_group_type"] == 1
        assert f["4dstem/datacube"].dtype == np.float32


def test_discovery_crop_bin_and_errors(tmp_path):
    rng = np.random.default_rng(1)
    cube = rng.poisson(20.0, (3, 4, 12, 12)).astype(np.float64)
    tagged = tmp_path / "cube.emd"
    _write_emd(tagged, cube, tag=True, extra=True)
    r = _same_load(tagged, scan_step=0.3)
    assert r["dataset"].endswith("cube0/data")
    np.testing.assert_array_equal(r["data"][1 * 4 + 2].numpy(), cube[1, 2])
    untagged = tmp_path / "cube.h5"
    _write_emd(untagged, cube, tag=False)      # falls back to first 4-D
    r = _same_load(untagged, crop_k=8, bin_k=2)
    manual = cube[0, 0, 2:10, 2:10].reshape(4, 2, 4, 2).sum(axis=(1, 3))
    np.testing.assert_array_equal(r["data"][0].numpy(), manual)
    _same_load(untagged, bin_k=3)
    r32 = td.load_4dstem(untagged, dtype=torch.float32, device=CPU)
    assert r32["data"].dtype == torch.float32
    for kw, match in ((dict(crop_k=9, bin_k=2), "does not divide"),
                      (dict(crop_k=20), "crop_k"),
                      (dict(dataset="/nope"), "no dataset"),
                      (dict(bin_k=0), "bin_k")):
        with pytest.raises(ValueError, match=match):
            td.load_4dstem(untagged, device=CPU, **kw)
    flat = tmp_path / "flat.h5"
    with h5py.File(flat, "w") as fh:
        fh.create_dataset("x", data=np.zeros((4, 4)))
    with pytest.raises(ValueError, match="no 4-D dataset"):
        td.load_4dstem(flat, device=CPU)
    with pytest.raises(ValueError, match="scan_shape"):
        td.save_4dstem(tmp_path / "x.emd", np.zeros((12, 8, 8)))


def test_scan_positions_match_jax():
    np.testing.assert_array_equal(td.scan_positions((3, 4), 0.3, 0.2),
                                  jd.scan_positions((3, 4), 0.3, 0.2))
    np.testing.assert_array_equal(td.scan_positions((2, 5), 0.7),
                                  jd.scan_positions((2, 5), 0.7))


@pytest.mark.parametrize("offset", [(5, -3), (0, 0), (-7, 2)])
def test_center_and_k_sampling_match_jax(offset):
    """tests/test_data4d.py's off-centre disk: the same integer shift,
    the same rolled cube and the same k sampling."""
    from pyslice_tpu_torch.core.constants import wavelength
    nk, dk_true, mrad, eV = 64, 0.02, 20.0, 100e3
    r_pix = (mrad * 1e-3) / wavelength(eV) / dk_true
    gx, gy = np.meshgrid(np.arange(nk), np.arange(nk), indexing="ij")
    disk = (((gx - (nk // 2 + offset[0])) ** 2
             + (gy - (nk // 2 + offset[1])) ** 2)
            <= r_pix ** 2).astype(np.float64)
    data = np.stack([disk, disk * 1.5])[None]          # (1, 2, nk, nk)
    got, gshift = td.center_datacube(data, return_shift=True, device=CPU)
    want, wshift = jd.center_datacube(data, return_shift=True)
    assert gshift == wshift == (-offset[0], -offset[1])
    np.testing.assert_array_equal(got.numpy(), want)
    dk = td.k_sampling_from_disk(got[0, 0], mrad, eV)
    assert dk == jd.k_sampling_from_disk(want[0, 0], mrad, eV)
    assert abs(dk - dk_true) / dk_true < 0.05
    with pytest.raises(ValueError, match="empty"):
        td.center_datacube(np.zeros((1, 4, 4)), device=CPU)
    with pytest.raises(ValueError, match="disk"):
        td.k_sampling_from_disk(np.ones((8, 8)) * 1e-12, mrad, eV,
                                threshold=2.0)


def test_loaded_cube_feeds_calibration_and_icom(tmp_path):
    """A drifting-disk cube written with save_4dstem, loaded, calibrated
    and reconstructed with iCoM from the calibrated CoM, all on tensors."""
    import pyslice_tpu_torch as pt
    rng = np.random.default_rng(2)
    nk, n_s = 24, 6
    kx = np.arange(nk)[:, None]
    ky = np.arange(nk)[None, :]
    cube = np.empty((n_s, n_s, nk, nk))
    for i in range(n_s):
        for j in range(n_s):
            cube[i, j] = 50.0 * np.exp(-((kx - nk / 2 - 0.2 * i) ** 2 + (
                ky - nk / 2 + 0.1 * j) ** 2) / (2 * 3.0 ** 2))
    cube += rng.random(cube.shape)
    p = tmp_path / "raw.emd"
    pt.save_4dstem(p, cube)
    r = pt.load_4dstem(p, scan_step=0.5, device=CPU)
    data = r["data"].reshape(n_s, n_s, nk, nk)
    xs = np.arange(n_s) * 0.5
    res = pt.calibrate_datacube(data, xs, xs, device=CPU)
    ks = np.fft.fftshift(np.fft.fftfreq(nk, 0.2))
    rec = pt.icom_reconstruct(None, xs, xs, ks, ks, com=res["com"].numpy(),
                              device=CPU)
    assert np.all(np.isfinite(rec["phase"])) and rec["phase"].std() > 0
