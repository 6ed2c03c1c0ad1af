"""Port parity: measured-data calibration (analysis/calibration.py) of
pyslice_tpu_torch against pyslice_tpu's on the same seeded NumPy inputs:
every public function in float64 to 1e-10 (boolean masks and integer
shifts equal), tests/test_calibration.py's end-to-end case at its own size
through the port's calculator on the CPU (float64, and float32 against it),
and one test for each place where a direct port would silently diverge
(np.median on an even count, a float32 stuck pixel, map_coordinates'
edges, half-to-even integer shifts, the ellipse angle's sign, the
rotation's 180-degree branch)."""

import math

import numpy as np
import pytest
import torch

from pyslice_tpu.analysis import calibration as jcal
from pyslice_tpu.io import data4d as jdata4d
from pyslice_tpu_torch.analysis import calibration as tcal
from pyslice_tpu_torch.io import data4d as tdata4d

torch.set_num_threads(2)

TOL = 1e-10
CPU = "cpu"


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, tol=TOL):
    got, want = _np(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(np.abs(want).max(), 1e-300)
    err = np.abs(got - want).max() / scale
    assert err <= tol, err


def _bumps_field(n=24, seed=0):
    """tests/test_calibration.py's conservative field, at 24^2."""
    rng = np.random.default_rng(seed)
    x = np.arange(n)[:, None]
    y = np.arange(n)[None, :]
    phi = np.zeros((n, n))
    for _ in range(4):
        cx, cy = rng.uniform(4, n - 4, 2)
        phi += np.exp(-((x - cx) ** 2 + (y - cy) ** 2) / (2 * 2.0 ** 2))
    gx, gy = np.gradient(phi, 1.0, 1.0)
    return -np.stack([gx, gy]) / (2 * np.pi)


def _disk_cube(n_s=6, nk=24, seed=0, hot=(3, 5)):
    """tests/test_cli.py's calibration cube: a drifting Gaussian disk, a
    little uniform noise and one hot pixel."""
    rng = np.random.default_rng(seed)
    kx = np.arange(nk)[:, None]
    ky = np.arange(nk)[None, :]
    cube = np.empty((n_s, n_s, nk, nk))
    for i in range(n_s):
        for j in range(n_s):
            cube[i, j] = 50.0 * np.exp(
                -((kx - nk / 2 - 0.2 * i) ** 2
                  + (ky - nk / 2 + 0.1 * j) ** 2) / (2 * 3.0 ** 2))
    cube += rng.random(cube.shape)
    if hot is not None:
        cube[:, :, hot[0], hot[1]] = 4000.0
    return cube


def _elliptic_disk(nk=40, center=(19.0, 21.5), a=9.0, b=7.0,
                   angle_deg=25.0, edge=0.4):
    x = np.arange(nk)[:, None] - center[0]
    y = np.arange(nk)[None, :] - center[1]
    th = np.radians(angle_deg)
    u = np.cos(th) * x + np.sin(th) * y
    v = -np.sin(th) * x + np.cos(th) * y
    r = np.sqrt((u / a) ** 2 + (v / b) ** 2)
    return 1.0 / (1.0 + np.exp((r - 1.0) / (edge / a)))


A_INJ = np.array([[1.020, 0.013], [-0.009, 0.985]])
G = np.array([[1 / 2.5, 0.0], [0.12, 1 / 3.1]])


def _lattice_image(A, n=64, dx=0.2):
    xs = np.arange(n) * dx
    gx, gy = np.meshgrid(xs, xs, indexing="ij")
    x = np.einsum("ij,j...->i...", A, np.stack([gx, gy]))
    img = 2.0
    for g in G:
        img = img + np.cos(2 * np.pi * (g[0] * x[0] + g[1] * x[1]))
    return img, xs


# --- every public function against the JAX package, float64 ---------------


@pytest.mark.parametrize("physical", [False, True])
def test_com_field_matches_jax(physical):
    cube = np.random.default_rng(1).random((5, 6, 16, 18))
    cube[0, 0] = 0.0                                 # an empty pattern
    kxs = np.fft.fftshift(np.fft.fftfreq(16, 0.2)) if physical else None
    kys = np.fft.fftshift(np.fft.fftfreq(18, 0.2)) if physical else None
    got = tcal.com_field(cube, kxs, kys, device=CPU)
    assert got.dtype == torch.float64 and got.device.type == "cpu"
    _close(got, jcal.com_field(cube, kxs, kys))


@pytest.mark.parametrize("theta_deg,transpose", [(0.0, False), (23.0, True),
                                                 (101.5, False),
                                                 (247.0, True)])
def test_solve_and_apply_rotation_match_jax(theta_deg, transpose):
    com = _bumps_field()
    meas = jcal.apply_rotation(com, -np.radians(theta_deg))
    if transpose:
        meas = np.stack([meas[1], meas[0]])
    got = tcal.solve_rotation(meas, 0.5, 0.7, device=CPU)
    want = jcal.solve_rotation(meas, 0.5, 0.7)
    assert got["transpose"] == want["transpose"] == transpose
    for k in ("theta", "skewness", "curl_rms", "curl_rms_raw"):
        assert got[k] == pytest.approx(want[k], rel=TOL, abs=1e-13), k
    for g, w in zip(got["candidates"], want["candidates"]):
        assert g["transpose"] == w["transpose"]
        assert g["theta"] == pytest.approx(w["theta"], rel=TOL, abs=1e-13)
        assert g["curl_rms"] == pytest.approx(w["curl_rms"], rel=TOL,
                                              abs=1e-13)
    raw = tcal.solve_rotation(meas, 0.5, 0.7, assume_attractive=False,
                              device=CPU)
    assert raw["skewness"] is None
    assert raw["theta"] == pytest.approx(
        jcal.solve_rotation(meas, 0.5, 0.7, assume_attractive=False)["theta"],
        rel=TOL, abs=1e-13)
    _close(tcal.apply_rotation(meas, got["theta"], got["transpose"],
                               device=CPU),
           jcal.apply_rotation(meas, want["theta"], want["transpose"]))


def test_fit_descan_matches_jax():
    com = _bumps_field()
    sx, sy = np.arange(24) * 0.2, np.arange(24) * 0.25
    gx, gy = np.meshgrid(sx, sy, indexing="ij")
    com = com + np.stack([0.03 + 0.011 * gx - 0.007 * gy,
                          -0.02 + 0.004 * gx + 0.009 * gy])
    got = tcal.fit_descan(com, sx, sy, device=CPU)
    want = jcal.fit_descan(com, sx, sy)
    _close(got["coeffs"], want["coeffs"])
    _close(got["corrected"], want["corrected"])
    assert got["drift_rms"] == pytest.approx(want["drift_rms"], rel=TOL)


@pytest.mark.parametrize("subpixel", [True, False])
@pytest.mark.parametrize("kpp", [1.0, (0.8, 1.3)])
def test_apply_descan_matches_jax(subpixel, kpp):
    cube = _disk_cube(hot=None)
    sx = np.arange(6) * 1.0
    coeffs = np.array([[0.4, 0.31, -0.17], [-0.3, -0.23, 0.28]])
    got = tcal.apply_descan(cube, coeffs, sx, sx, kpp, subpixel=subpixel,
                            device=CPU)
    want = jcal.apply_descan(cube, coeffs, sx, sx, kpp, subpixel=subpixel)
    if subpixel:
        _close(got, want)
    else:
        np.testing.assert_array_equal(_np(got), want)


def test_fit_bf_disk_ellipse_matches_jax():
    disk = _elliptic_disk()
    got = tcal.fit_bf_disk_ellipse(disk, device=CPU)
    want = jcal.fit_bf_disk_ellipse(disk)
    _close(got["center"], want["center"])
    _close(got["correction"], want["correction"])
    for k in ("angle", "ellipticity"):
        assert got[k] == pytest.approx(want[k], rel=TOL), k
    np.testing.assert_allclose(got["semi_axes"], want["semi_axes"], rtol=TOL)
    assert got["n_pixels"] == want["n_pixels"]
    with pytest.raises(ValueError, match="fewer than 9"):
        tcal.fit_bf_disk_ellipse(np.zeros((16, 16)), device=CPU)


def test_elliptic_and_com_corrections_match_jax():
    disk = _elliptic_disk()
    fit = jcal.fit_bf_disk_ellipse(disk)
    cube = disk[None, None] * (1.0 + np.random.default_rng(2).random(
        (3, 2, 1, 1)))
    _close(tcal.apply_elliptic_correction(cube, fit, device=CPU),
           jcal.apply_elliptic_correction(cube, fit))
    com = np.random.default_rng(0).standard_normal((2, 5, 7))
    _close(tcal.correct_com_ellipse(com, fit, device=CPU),
           jcal.correct_com_ellipse(com, fit))
    with pytest.raises(ValueError, match="order"):
        tcal.apply_elliptic_correction(cube, fit, order=3, device=CPU)


def test_fit_affine_scan_matches_jax():
    img, xs = _lattice_image(A_INJ)
    got = tcal.fit_affine_scan(img, xs, xs, G, device=CPU)
    want = jcal.fit_affine_scan(img, xs, xs, G)
    _close(got["A"], want["A"])
    _close(got["g_measured"], want["g_measured"])
    np.testing.assert_allclose(got["peak_snr"], want["peak_snr"], rtol=TOL)
    assert got["determinant"] == pytest.approx(want["determinant"], rel=TOL)
    with pytest.raises(ValueError, match="no Fourier samples"):
        tcal.fit_affine_scan(img[:16, :16], xs[:16], xs[:16],
                             [[40.0, 0.0], [0.0, 40.0]], device=CPU)


@pytest.mark.parametrize("cube", [False, True])
def test_apply_affine_scan_matches_jax(cube):
    img, xs = _lattice_image(A_INJ, n=24, dx=0.5)
    data = img
    if cube:
        rng = np.random.default_rng(4)
        data = img[:, :, None, None] * rng.random((1, 1, 3, 4))
    _close(tcal.apply_affine_scan(data, A_INJ, xs, xs, device=CPU),
           jcal.apply_affine_scan(data, A_INJ, xs, xs))


@pytest.mark.parametrize("kind", ["poisson", "cluster"])
def test_find_and_fix_pixels_match_jax(kind):
    rng = np.random.default_rng(1)
    data = rng.poisson(50.0, (4, 5, 20, 22)).astype(float)
    data[:, :, 5, 7] = 9000.0      # hot (stuck bright)
    data[:, :, 12, 3] = 0.0        # dead (stuck zero)
    data[:, :, 0, 21] = 7000.0     # hot in a corner
    bad = jcal.find_bad_pixels(data)
    got = tcal.find_bad_pixels(data, device=CPU)
    np.testing.assert_array_equal(_np(got), bad)
    assert bad.sum() == 3
    if kind == "cluster":         # a 3x3 block: its centre has no good
        bad = bad.copy()          # neighbour (the global-median branch)
        bad[9:12, 14:17] = True
    _close(tcal.fix_pixels(data, bad, device=CPU), jcal.fix_pixels(data, bad))


def test_dark_gain_and_dose_match_jax():
    rng = np.random.default_rng(3)
    data = rng.random((3, 4, 6, 5)) * 10
    dark = rng.random((6, 5))
    gain = 0.5 + rng.random((6, 5))
    gain[0, 0] = 0.0
    gain[1, 2] = -1.0
    for args in ((dark, gain), (dark, None), (None, gain), (None, None)):
        _close(tcal.apply_dark_gain(data, *args, device=CPU),
               jcal.apply_dark_gain(data, *args))
    got = tcal.estimate_dose(data, 0.5, 0.7, device=CPU)
    want = jcal.estimate_dose(data, 0.5, 0.7)
    assert got["dose"] == pytest.approx(want["dose"], rel=TOL)
    assert got["total"] == pytest.approx(want["total"], rel=TOL)
    _close(got["electrons_per_position"], want["electrons_per_position"])


def _same_result(got, want, tol=TOL):
    """Every entry of two calibrate_datacube results."""
    _close(got["data"], want["data"], tol)
    _close(got["com"], want["com"], tol)
    np.testing.assert_array_equal(_np(got["bad_pixels"]), want["bad_pixels"])
    assert got["beam_center_shift"] == want["beam_center_shift"]
    assert got["transpose"] == want["transpose"]
    assert got["rotation"] == pytest.approx(want["rotation"], rel=tol)
    _close(got["descan"]["coeffs"], want["descan"]["coeffs"], tol)
    assert got["dose"]["dose"] == pytest.approx(want["dose"]["dose"],
                                                rel=tol)
    assert got["report"] == want["report"]
    for k in ("ellipse", "affine"):
        assert (got[k] is None) == (want[k] is None), k
    if want["ellipse"] is not None:
        _close(got["ellipse"]["correction"], want["ellipse"]["correction"],
               tol)
    if want["affine"] is not None:
        _close(got["affine"]["A"], want["affine"]["A"], tol)


@pytest.mark.parametrize("options", [
    dict(),
    dict(subpixel_descan=True, k_per_pixel=(0.05, 0.07)),
    dict(apply_ellipse=True, g_expected=[[0.35, 0.0], [0.0, 0.3]],
         apply_affine=True),
])
def test_calibrate_datacube_matches_jax(options):
    cube = _disk_cube(n_s=8)
    rng = np.random.default_rng(5)
    dark = rng.random(cube.shape[-2:]) * 0.1
    gain = 0.9 + 0.2 * rng.random(cube.shape[-2:])
    raw = cube * gain + dark
    xs = np.arange(8) * 0.5
    got = tcal.calibrate_datacube(raw, xs, xs, dark=dark, gain=gain,
                                  device=CPU, **options)
    want = jcal.calibrate_datacube(raw, xs, xs, dark=dark, gain=gain,
                                   **options)
    _same_result(got, want)
    assert got["data"].dtype == torch.float64


# --- tests/test_calibration.py's end-to-end case through the port ----------


@pytest.fixture(scope="module")
def simulated():
    """tests/test_calibration.py's simulated cube (hBN 2 x 2, 24 x 24
    scan, 25 mrad, 100 kV) through the port's calculator on the CPU, with
    its PSF, descan and hot/dead pixels."""
    import pyslice_tpu_torch as pt
    from tests.fixtures import hbn_monolayer

    traj = hbn_monolayer(2, 2)
    box = np.asarray(traj.box_matrix)
    n_s = 24
    pg = pt.probe_grid([0.0, box[0, 0]], [0.0, box[1, 1]], n_s, n_s)
    calc = pt.MultisliceCalculator(device=CPU, precision="double")
    calc.setup(pt.Trajectory(atom_types=traj.atom_types,
                             positions=traj.positions,
                             velocities=traj.velocities,
                             box_matrix=traj.box_matrix,
                             timestep=traj.timestep),
               aperture=25, voltage_eV=100e3, sampling=0.25,
               slice_thickness=3.5, probe_positions=pg.tolist(),
               use_cache=False)
    wf = calc.run(progress=False)
    xs, ys, raw = pt.scan_grid_data(wf)
    nkx, nky = raw.shape[-2:]
    fx = np.fft.fftfreq(nkx)[:, None]
    fy = np.fft.fftfreq(nky)[None, :]
    psf_hat = np.exp(-2 * np.pi ** 2 * 1.2 ** 2 * (fx ** 2 + fy ** 2))
    clean = np.clip(np.real(np.fft.ifft2(np.fft.fft2(raw) * psf_hat)), 0,
                    None)
    inject = np.array([[0.1, -0.06, 0.04], [-0.08, 0.05, 0.06]])  # px
    cube = jcal.apply_descan(clean, inject, xs, ys, k_per_pixel=1.0,
                             subpixel=True)
    hot, dead = (nkx // 3, nky // 4), (2 * nkx // 3, nky // 2)
    cube[:, :, hot[0], hot[1]] = cube.max() * 50
    cube[:, :, dead[0], dead[1]] = 0.0
    return dict(wf=wf, xs=xs, ys=ys, clean=clean, cube=cube, hot=hot,
                dead=dead, inject=inject)


def _icom_error(res, s):
    from pyslice_tpu_torch.analysis.ptychography import icom_reconstruct
    wf, xs, ys = s["wf"], s["xs"], s["ys"]
    ref_cube = tcal.fix_pixels(s["clean"], res["bad_pixels"], device=CPU)
    ref_com = tcal.fit_descan(tcal.com_field(ref_cube, wf.kxs, wf.kys),
                              xs, ys, device=CPU)["corrected"]
    ref = icom_reconstruct(None, xs, ys, wf.kxs, wf.kys, probe=wf.probe,
                           com=ref_com.numpy(), device=CPU)
    got = icom_reconstruct(None, xs, ys, wf.kxs, wf.kys, probe=wf.probe,
                           com=res["com"].double().numpy(), device=CPU)
    scale = np.abs(ref["phase"]).max()
    return (np.abs(got["phase"] - ref["phase"]).max() / scale,
            got["curl_rms"], ref["curl_rms"])


def test_calibrate_end_to_end_icom(simulated):
    """tests/test_calibration.py's bars, met by the port (float64), and
    the port's result equal to the JAX package's on the same cube."""
    s = simulated
    wf = s["wf"]
    res = tcal.calibrate_datacube(s["cube"], s["xs"], s["ys"], kxs=wf.kxs,
                                  kys=wf.kys, subpixel_descan=True,
                                  device=CPU)
    bad = _np(res["bad_pixels"])
    assert bad.sum() == 2 and bad[s["hot"]] and bad[s["dead"]]
    rot_deg = np.degrees(res["rotation"]) % 360.0
    assert min(rot_deg, 360.0 - rot_deg) < 1.0, rot_deg
    assert not res["transpose"]
    assert res["rotation_diag"]["skewness"] < -0.1
    dk = float(wf.kxs[1] - wf.kxs[0])
    dky = float(wf.kys[1] - wf.kys[0])
    np.testing.assert_allclose(_np(res["descan"]["coeffs"])[:, 1:]
                               / np.array([[dk], [dky]]),
                               -s["inject"][:, 1:], atol=0.005)
    err, curl, ref_curl = _icom_error(res, s)
    assert err < 0.02, err
    assert curl < ref_curl * 1.2 + 0.02
    want = jcal.calibrate_datacube(s["cube"], s["xs"], s["ys"], kxs=wf.kxs,
                                   kys=wf.kys, subpixel_descan=True)
    _same_result(res, want)


def test_calibrate_end_to_end_float32(simulated):
    """The same cube in float32 against the port's float64 run: the same
    bad-pixel mask, branch and transpose, and the CoM field within 1e-4
    max|d|/max|ref| (float32 patterns, float64 moments)."""
    s = simulated
    wf = s["wf"]
    kw = dict(kxs=wf.kxs, kys=wf.kys, subpixel_descan=True, device=CPU)
    r64 = tcal.calibrate_datacube(s["cube"], s["xs"], s["ys"], **kw)
    r32 = tcal.calibrate_datacube(s["cube"].astype(np.float32), s["xs"],
                                  s["ys"], **kw)
    assert r32["data"].dtype == torch.float32
    assert r32["com"].dtype == torch.float64
    np.testing.assert_array_equal(_np(r32["bad_pixels"]),
                                  _np(r64["bad_pixels"]))
    assert r32["transpose"] == r64["transpose"]
    assert r32["beam_center_shift"] == r64["beam_center_shift"]
    _close(r32["com"], r64["com"], 1e-4)
    assert abs(r32["rotation"] - r64["rotation"]) < 1e-3
    assert _icom_error(r32, s)[0] < 0.02


# --- where a direct port would silently diverge ----------------------------


def test_even_count_median_is_numpys():
    """np.median averages the two middle values of an even count;
    torch.median returns the lower one. The MAD of find_bad_pixels runs
    over all nkx * nky residuals (even here), the neighbour median of
    fix_pixels over 2-8 values."""
    x = torch.tensor([[1.0, 4.0, 2.0, 10.0], [3.0, 3.0, 5.0, 8.0]],
                     dtype=torch.float64)
    np.testing.assert_array_equal(_np(tcal._median(x, 1)),
                                  np.median(x.numpy(), axis=1))
    assert float(x[0].median()) != float(np.median(x[0].numpy()))
    # a corner bad pixel has 3 good neighbours, an edge one 5, a pixel
    # next to another bad one an even count: all np.median
    rng = np.random.default_rng(7)
    data = rng.random((3, 2, 8, 8)) * 100
    bad = np.zeros((8, 8), bool)
    bad[0, 0] = bad[3, 3] = bad[3, 4] = True
    _close(tcal.fix_pixels(data, bad, device=CPU), jcal.fix_pixels(data, bad))


def test_mad_on_even_detector_matches_numpy():
    rng = np.random.default_rng(8)
    data = rng.random((2, 3, 8, 6))
    data[:, :, 2, 2] = 3.0                        # a stuck bright pixel
    got = tcal.find_bad_pixels(data, n_sigma=3.0, device=CPU)
    np.testing.assert_array_equal(_np(got),
                                  jcal.find_bad_pixels(data, n_sigma=3.0))


def test_float32_stuck_pixel_at_non_representable_count():
    """A stuck pixel at 50.3 in a float32 cube: float32 scan statistics
    would see rounding noise; the port's are float64, so the pixel is
    flagged exactly as in the float64 cube."""
    rng = np.random.default_rng(9)
    data = rng.poisson(50.0, (16, 16, 12, 12)).astype(np.float32)
    data[:, :, 4, 6] = np.float32(50.3)
    data[:, :, 9, 2] = np.float32(900.3)
    want = jcal.find_bad_pixels(data.astype(np.float64))
    got = tcal.find_bad_pixels(torch.as_tensor(data), device=CPU)
    np.testing.assert_array_equal(_np(got), want)
    assert want[4, 6] and want[9, 2]


@pytest.mark.parametrize("axis_len", [7, 8])
def test_bilinear_clamps_like_map_coordinates(axis_len):
    """map_coordinates(order=1, mode="nearest") past the last sample, on
    both edges, and inside: the port's clamped bilinear gather."""
    from scipy.ndimage import map_coordinates
    rng = np.random.default_rng(10)
    field = rng.random((axis_len, 5))
    coords = np.array([[-3.2, -1.0, -0.4, 0.0, 0.3, 2.5, axis_len - 1.0,
                        axis_len - 0.6, axis_len + 0.5, 12.0],
                       [1.5, -2.0, 4.7, 0.0, 4.0, 6.2, 3.3, -0.5, 2.0,
                        9.9]])
    want = map_coordinates(field, coords, order=1, mode="nearest")
    idx, w = tcal._bilinear(torch.as_tensor(coords), field.shape)
    got = tcal._resample(torch.as_tensor(field).reshape(1, -1), idx, w, 1)
    np.testing.assert_allclose(_np(got)[0], want, rtol=0, atol=1e-14)


@pytest.mark.parametrize("offset", [0.5, -0.5, 1.5, -1.5])
def test_half_integer_shifts_round_half_to_even(offset):
    """center_datacube's and apply_descan's integer shifts round half to
    even (Python's round), as the JAX package's int(round(x))."""
    nk = 16
    mean = np.zeros((nk, nk))
    # four equal spikes put the centre of mass exactly half a pixel off
    c = nk // 2 + offset
    lo, hi = int(np.floor(c)), int(np.ceil(c))
    mean[lo, lo] = mean[lo, hi] = mean[hi, lo] = mean[hi, hi] = 1.0
    cube = np.broadcast_to(mean, (2, 2, nk, nk)).copy()
    got, gshift = tdata4d.center_datacube(cube, return_shift=True,
                                          device=CPU)
    want, wshift = jdata4d.center_datacube(cube, return_shift=True)
    step = nk // 2 - round(c)           # half to even: 8.5 -> 8, 9.5 -> 10
    assert gshift == wshift == (step, step)
    assert step in (0, 2, -2)
    np.testing.assert_array_equal(_np(got), want)
    sx = np.arange(2) * 1.0
    coeffs = np.array([[offset, 1.0, 0.0], [-offset, 0.0, 1.0]])
    np.testing.assert_array_equal(
        _np(tcal.apply_descan(cube, coeffs, sx, sx, 1.0, subpixel=False,
                              device=CPU)),
        jcal.apply_descan(cube, coeffs, sx, sx, 1.0, subpixel=False))


@pytest.mark.parametrize("angle_deg", [25.0, 155.0])
def test_ellipse_angle_is_taken_mod_pi(angle_deg):
    """The major axis comes from an eigenvector whose sign is free: the
    angle lands in [0, pi) and agrees with the JAX package's."""
    disk = _elliptic_disk(angle_deg=angle_deg)
    got = tcal.fit_bf_disk_ellipse(disk, device=CPU)
    assert 0.0 <= got["angle"] < math.pi
    assert got["angle"] == pytest.approx(
        jcal.fit_bf_disk_ellipse(disk)["angle"], rel=TOL)
    assert math.degrees(got["angle"]) == pytest.approx(angle_deg, abs=2.0)


def test_rotation_branch_follows_skewness():
    """The 180-degree branch follows the sign of the integrated field's
    skewness; on a field with |skewness| > 0.1 both packages pick the same
    branch, and the negated field (theta + pi) gives the other one."""
    com = _bumps_field()
    a = tcal.solve_rotation(com, device=CPU)
    b = tcal.solve_rotation(-com, device=CPU)
    assert abs(a["skewness"]) > 0.1
    assert a["skewness"] == pytest.approx(
        jcal.solve_rotation(com)["skewness"], rel=TOL)
    d = (b["theta"] - a["theta"]) % (2 * math.pi)
    assert d == pytest.approx(math.pi, abs=1e-9)
