"""Port parity for the detectors (analysis/detectors.py): every function
of pyslice_tpu_torch's module against pyslice_tpu's on the same NumPy
inputs (one JAX float64 STEM run, handed to the port as a host array and
as a tensor), to 1e-10; the single-device tests of tests/test_detectors.py
mirrored on the port; shot noise held to JAX's in mean and variance (the
draws differ: torch.Generator against jax.random)."""

import numpy as np
import pytest
import torch

from pyslice_tpu.analysis import detectors as jd
from pyslice_tpu.core.dtypes import DOUBLE
from pyslice_tpu.engine.calculator import MultisliceCalculator

import pyslice_tpu_torch as tt
from pyslice_tpu_torch.analysis import detectors as td

from fixtures import hbn_thermal

torch.set_num_threads(2)

SAMPLING = 0.25
SLICE_T = 0.8


@pytest.fixture(scope="module")
def wfs():
    """The JAX WFData of a 6-probe, 2-frame float64 STEM run, and the port's
    WFData on the same waves as a host array and as a CPU tensor."""
    traj = hbn_thermal(n_frames=2, sigma=0.05, seed=5)
    pg = tt.probe_grid((1.0, 4.0), (1.0, 4.0), 3, 2)
    calc = MultisliceCalculator(precision=DOUBLE)
    calc.setup(traj, aperture=25, voltage_eV=100e3, sampling=SAMPLING,
               slice_thickness=SLICE_T, probe_positions=pg, use_cache=False)
    jwf = calc.run(progress=False)
    waves = np.asarray(jwf.wavefunction_data)
    probe = tt.Probe(np.asarray(jwf.probe.xs), np.asarray(jwf.probe.ys),
                     25, 100e3, precision="double", device="cpu")

    def port(w):
        return tt.WFData(probe_positions=np.asarray(jwf.probe_positions),
                         time=np.asarray(jwf.time), kxs=np.asarray(jwf.kxs),
                         kys=np.asarray(jwf.kys), layer=np.asarray(jwf.layer),
                         wavefunction_data=w, probe=probe)
    return jwf, {"host": port(waves), "tensor": port(torch.from_numpy(waves))}


def _rel(got, want):
    want = np.asarray(want)
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.fixture(params=["host", "tensor"])
def twf(request, wfs):
    return wfs[1][request.param]


class TestMasks:
    def test_annular_matches_haadf_mask_and_jax(self, wfs):
        jwf, _ = wfs
        lam = jwf.probe.wavelength
        m = td.annular_mask(jwf.kxs, jwf.kys, lam, inner_mrad=45.0)
        q = np.sqrt(np.add.outer(np.asarray(jwf.kxs) ** 2,
                                 np.asarray(jwf.kys) ** 2))
        np.testing.assert_array_equal(m, (q > 45e-3 / lam).astype(float))
        for inner, outer in ((45.0, None), (0.0, 10.0), (10.0, 40.0)):
            np.testing.assert_array_equal(
                td.annular_mask(jwf.kxs, jwf.kys, lam, inner, outer),
                jd.annular_mask(jwf.kxs, jwf.kys, lam, inner, outer))
        ksq = np.add.outer(np.asarray(jwf.kxs) ** 2,
                           np.asarray(jwf.kys) ** 2) * 1.1
        np.testing.assert_array_equal(
            td.annular_mask(jwf.kxs, jwf.kys, lam, 30.0, ksq=ksq),
            jd.annular_mask(jwf.kxs, jwf.kys, lam, 30.0, ksq=ksq))

    def test_bright_field_disk(self, wfs):
        jwf, _ = wfs
        lam = jwf.probe.wavelength
        bf = td.annular_mask(jwf.kxs, jwf.kys, lam, 0.0, 10.0)
        adf = td.annular_mask(jwf.kxs, jwf.kys, lam, inner_mrad=10.0)
        both = bf + adf
        assert np.all((both == 1.0) | (both == 0.0))
        assert bf[len(jwf.kxs) // 2, len(jwf.kys) // 2] == 1.0

    def test_segmented_sums_to_annulus_and_matches_jax(self, wfs):
        jwf, _ = wfs
        lam = jwf.probe.wavelength
        segs = td.segmented_mask(jwf.kxs, jwf.kys, lam, 10.0, 40.0,
                                 n_segments=4, rotation_deg=15.0)
        assert segs.shape[0] == 4
        np.testing.assert_allclose(
            segs.sum(axis=0), td.annular_mask(jwf.kxs, jwf.kys, lam, 10.0,
                                              40.0))
        np.testing.assert_array_equal(
            segs, jd.segmented_mask(jwf.kxs, jwf.kys, lam, 10.0, 40.0,
                                    n_segments=4, rotation_deg=15.0))


class TestVirtualImaging:
    @pytest.mark.parametrize("intensity", [False, True])
    def test_virtual_image_matches_jax_and_calculateADF(self, wfs, twf,
                                                        intensity):
        jwf, _ = wfs
        lam = jwf.probe.wavelength
        mask = td.annular_mask(jwf.kxs, jwf.kys, lam, inner_mrad=45.0)
        got = td.virtual_image(twf, mask, intensity=intensity)
        assert got.shape == (3, 2)
        assert _rel(got, jd.virtual_image(jwf, mask,
                                          intensity=intensity)) <= 1e-10
        if not intensity:
            np.testing.assert_allclose(
                got, tt.HAADFData(twf).calculateADF(45), rtol=1e-12)

    @pytest.mark.parametrize("oblique", [False, True])
    @pytest.mark.parametrize("theta", [20.0, 45.0])
    def test_calculateADF_is_virtual_image(self, twf, theta, oblique):
        """calculateADF is virtual_image with its own mask (q > theta /
        lambda, q from ksq_shifted on an oblique cell), bit for bit, for
        host and tensor wave data."""
        import dataclasses
        ksq = np.add.outer(np.asarray(twf.kxs) ** 2,
                           np.asarray(twf.kys) ** 2)
        if oblique:
            ksq = ksq * 1.1
            twf = dataclasses.replace(twf, ksq_shifted=ksq)
        mask = np.sqrt(ksq) > (theta * 1e-3) / twf.probe.wavelength
        assert 0 < mask.sum() < mask.size
        np.testing.assert_array_equal(
            tt.HAADFData(twf).calculateADF(theta),
            td.virtual_image(twf, mask, intensity=False))

    def test_segmented_virtual_images(self, wfs, twf):
        jwf, _ = wfs
        lam = jwf.probe.wavelength
        segs = td.segmented_mask(jwf.kxs, jwf.kys, lam, 5.0, 60.0,
                                 n_segments=4)
        imgs = td.virtual_image(twf, segs)
        assert imgs.shape == (4, 3, 2)
        ring = td.annular_mask(jwf.kxs, jwf.kys, lam, 5.0, 60.0)
        np.testing.assert_allclose(imgs.sum(axis=0),
                                   td.virtual_image(twf, ring), rtol=1e-10)
        assert _rel(imgs, jd.virtual_image(jwf, segs)) <= 1e-10

    def test_center_of_mass_matches_jax(self, wfs, twf):
        jwf, _ = wfs
        com = td.center_of_mass(twf)
        assert com.shape == (2, 3, 2)
        assert np.all(np.abs(com) <= np.abs(np.asarray(jwf.kxs)).max())
        assert _rel(com, jd.center_of_mass(jwf)) <= 1e-10

    def test_bin_k(self):
        a = np.arange(24, dtype=float).reshape(4, 6)
        b = td.bin_k(a, 2)
        assert b.shape == (2, 3)
        assert b[0, 0] == a[0, 0] + a[0, 1] + a[1, 0] + a[1, 1]
        c = td.bin_k(np.ones((5, 7)), 2)
        assert c.shape == (2, 3) and np.all(c == 4.0)
        r = np.random.default_rng(0).random((2, 9, 10))
        np.testing.assert_array_equal(td.bin_k(r, 3), jd.bin_k(r, 3))

    def test_scan_grid_matches_jax(self, wfs):
        pos = np.asarray(wfs[0].probe_positions)[::-1]
        for a, b in zip(td._scan_grid(pos), jd._scan_grid(pos)):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(td._scan_axes(pos), jd._scan_axes(pos)):
            np.testing.assert_array_equal(a, b)

    def test_sharded_wfdata_raises(self, wfs):
        """A sharded WFData (a DTensor) is taken: on a mesh of one rank
        every detector reads its local tensor, the unsharded result bit for
        bit (tests/test_torch_sharded.py holds real meshes)."""
        import dataclasses
        import torch.distributed as dist
        from torch.distributed.tensor import DTensor, Shard
        from pyslice_tpu_torch.parallel.mesh import make_mesh
        wf0 = wfs[1]["tensor"]
        mesh = make_mesh(device="cpu")
        try:
            wf = dataclasses.replace(wf0, wavefunction_data=DTensor.from_local(
                wf0.wavefunction_data, mesh, [Shard(1), Shard(0)],
                run_check=False))
            lam = wf0.probe.wavelength
            ring = td.annular_mask(wf0.kxs, wf0.kys, lam, 10.0, 40.0)
            np.testing.assert_array_equal(td.pacbed(wf), td.pacbed(wf0))
            np.testing.assert_array_equal(td.center_of_mass(wf),
                                          td.center_of_mass(wf0))
            np.testing.assert_array_equal(td.virtual_image(wf, ring),
                                          td.virtual_image(wf0, ring))
        finally:
            dist.destroy_process_group()


def test_apply_shot_noise():
    """Poisson dose model: integer counts >= 0 whose mean and variance
    track lam = image * dose * pixel_area as JAX's draws do; reproducible
    by generator seed."""
    rng = np.random.default_rng(0)
    image = rng.random((40, 40)) * 0.02
    dose, area = 5e3, 0.25
    gen = lambda seed: torch.Generator().manual_seed(seed)
    counts = td.apply_shot_noise(image, dose, area, generator=gen(1))
    assert counts.shape == image.shape and counts.dtype == np.float32
    assert np.all(counts >= 0) and np.allclose(counts, np.round(counts))
    lam = image * dose * area
    assert abs(counts.sum() - lam.sum()) / lam.sum() < 0.02
    np.testing.assert_array_equal(
        counts, td.apply_shot_noise(image, dose, area, generator=gen(1)))
    assert not np.array_equal(
        counts, td.apply_shot_noise(image, dose, area, generator=gen(2)))
    hi = td.apply_shot_noise(image, 1e8, area, generator=gen(1))
    assert np.median(np.abs(hi / (image * 1e8 * area) - 1.0)) < 1e-2

    # against JAX: a flat field of lam = 3 per pixel, 40,000 draws each
    flat = np.full((200, 200), 3.0 / (dose * area))
    got = td.apply_shot_noise(flat, dose, area, generator=gen(3))
    want = np.asarray(jd.apply_shot_noise(flat, dose, area, seed=3))
    for stat in (np.mean, np.var):
        a, b = float(stat(got)), float(stat(want))
        # each within ~4 sigma of 3 (sigma of the mean 0.009, of the
        # variance ~0.024), so within 0.2 of each other
        assert abs(a - 3.0) < 0.1 and abs(b - 3.0) < 0.1
        assert abs(a - b) < 0.2


class TestPACBEDAndRadial:
    def test_pacbed_is_probe_frame_mean(self, wfs, twf):
        jwf, _ = wfs
        wf = np.asarray(jwf.wavefunction_data)
        got = td.pacbed(twf)
        np.testing.assert_allclose(
            got, np.mean(np.abs(wf[..., -1]) ** 2, axis=(0, 1)), rtol=1e-12)
        assert _rel(got, jd.pacbed(jwf)) <= 1e-10
        got2 = td.pacbed(twf, probe_indices=[0, 2])
        np.testing.assert_allclose(
            got2, np.mean(np.abs(wf[[0, 2], ..., -1]) ** 2, axis=(0, 1)),
            rtol=1e-12)
        assert _rel(got2, jd.pacbed(jwf, probe_indices=[0, 2])) <= 1e-10

    def test_radial_profile_isotropic(self, wfs):
        jwf, _ = wfs
        kxs, kys = np.asarray(jwf.kxs), np.asarray(jwf.kys)
        pattern = np.exp(-np.add.outer(kxs ** 2, kys ** 2) / 0.5)
        centers, prof = td.radial_profile(pattern, kxs, kys, n_bins=16)
        assert np.max(np.abs(prof - np.exp(-centers ** 2 / 0.5))) < 0.05
        assert prof.shape == (16,)
        jc, jp = jd.radial_profile(pattern, kxs, kys, n_bins=16)
        np.testing.assert_array_equal(centers, jc)
        np.testing.assert_allclose(prof, jp, rtol=1e-12)

    def test_radial_profile_batched_and_validation(self, wfs):
        jwf, _ = wfs
        kxs, kys = np.asarray(jwf.kxs), np.asarray(jwf.kys)
        pats = np.random.default_rng(0).random((2, len(kxs), len(kys)))
        centers, prof = td.radial_profile(pats, kxs, kys, n_bins=16)
        assert prof.shape == (2, 16)
        np.testing.assert_allclose(
            prof[0], td.radial_profile(pats[0], kxs, kys, n_bins=16)[1])
        with pytest.raises(ValueError, match="kmax"):
            td.radial_profile(pats[0], kxs, kys, kmax=0.0)


def test_detector_mtf():
    """MTF blur: energy-conserving, identity at mtf=1, smoothing, a point
    keeps its centre as the maximum; the JAX package's values."""
    rng = np.random.default_rng(0)
    pat = rng.random((3, 32, 32))
    out = td.apply_detector_mtf(pat, a=0.1, c=0.4)
    np.testing.assert_allclose(out.sum(axis=(-2, -1)),
                               pat.sum(axis=(-2, -1)), rtol=1e-12)
    np.testing.assert_allclose(
        td.apply_detector_mtf(pat, mtf=lambda w: np.ones_like(w)), pat,
        atol=1e-12)
    assert out.std() < pat.std()
    np.testing.assert_allclose(out, jd.apply_detector_mtf(pat, a=0.1, c=0.4),
                               rtol=1e-12, atol=1e-14)
    point = np.zeros((16, 16))
    point[8, 8] = 1.0
    sp = td.apply_detector_mtf(point, a=0.05, c=0.3)
    assert sp[8, 8] == sp.max() and 0 < sp[8, 8] < 1
    with pytest.raises(ValueError, match="floor"):
        td.apply_detector_mtf(point, a=1.5)


@pytest.mark.parametrize("order", [0.0, -2.0])
def test_detector_mtf_order_validation(order):
    with pytest.raises(ValueError, match="order"):
        td.apply_detector_mtf(np.ones((8, 8)), order=order)
