"""Port parity for the S-matrix (engine/smatrix.py) and StreamingHAADF's
S-matrix route: pyslice_tpu_torch against pyslice_tpu on the same random
64^2 x 3-slice specimen (float64 to 1e-10, one complex64 case to the 1e-6
residual), and the single-device tests of tests/test_smatrix.py mirrored
on the port: f=1 synthesis equals the direct pipeline, detector
reductions, the PRISM f=2 approximation, the odd-grid window, the
automatic route."""

import numpy as np
import pytest
import torch

from pyslice_tpu.core.dtypes import DOUBLE as J_DOUBLE, SINGLE as J_SINGLE
from pyslice_tpu.engine import smatrix as js

import pyslice_tpu_torch as tt
from pyslice_tpu_torch.analysis import detectors as td
from pyslice_tpu_torch.core.constants import wavelength
from pyslice_tpu_torch.engine import smatrix as ts
from pyslice_tpu_torch.engine.pipeline import SimSpec, frame_exit_waves
from pyslice_tpu_torch.engine.streaming import StreamingHAADF
from pyslice_tpu_torch.physics.aberrations import Aberrations

from oracle import residual

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def problem():
    nx = ny = 64
    nz = 3
    lx, ly, lz = nx * 0.15, ny * 0.15, nz * 1.0
    xs = np.linspace(0, lx, nx, endpoint=False)
    ys = np.linspace(0, ly, ny, endpoint=False)
    zs = np.linspace(0, lz, nz, endpoint=False)
    rng = np.random.default_rng(2)
    pos = rng.random((1, 20, 3)) * np.array([lx, ly, lz - 0.05])
    types = rng.choice([5, 7, 14], 20).astype(np.int32)
    plan = tt.make_plan(xs, ys, zs, pos, types)
    scan = tt.probe_grid([lx * 0.3, lx * 0.7], [ly * 0.3, ly * 0.7], 3, 3)
    grid = tt.Grid(xs=xs, ys=ys, zs=zs, lx=lx, ly=ly, lz=lz,
                   sampling=0.15, slice_thickness=1.0)
    return dict(xs=xs, ys=ys, zs=zs, plan=plan, pos=pos[0], types=types,
                scan=scan, grid=grid, mrad=22.0, eV=100e3,
                dz=float(zs[1] - zs[0]))


def _jplan(problem):
    from pyslice_tpu.physics.potential import make_plan
    return make_plan(problem["xs"], problem["ys"], problem["zs"],
                     problem["pos"][None], problem["types"])


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _rel(got, want):
    return np.abs(_np(got) - _np(want)).max() / np.abs(_np(want)).max()


def _sm(problem, f=1, precision="double", **kw):
    beams = ts.build_beams(problem["xs"], problem["ys"], problem["mrad"],
                           problem["eV"], f=f)
    return ts.compute_smatrix(problem["pos"], problem["plan"], beams,
                              xs=problem["xs"], ys=problem["ys"],
                              dz=problem["dz"], precision=precision,
                              device="cpu", **kw)


def _jsm(problem, f=1, precision=J_DOUBLE, **kw):
    beams = js.build_beams(problem["xs"], problem["ys"], problem["mrad"],
                           problem["eV"], f=f)
    return js.compute_smatrix(problem["pos"], _jplan(problem), beams,
                              xs=problem["xs"], ys=problem["ys"],
                              dz=problem["dz"], precision=precision, **kw)


def _direct_exit_k(problem, precision="double", defocus=0.0, ab=None):
    base = tt.Probe(problem["xs"], problem["ys"], problem["mrad"],
                    problem["eV"], precision=precision, device="cpu")
    if defocus:
        base.defocus(defocus)
    if ab is not None:
        base.aberrate(ab)
    probes = tt.create_batched_probes(base, problem["scan"]).array
    spec = SimSpec.create(problem["grid"], problem["plan"], problem["eV"],
                          precision=precision)
    return frame_exit_waves(problem["pos"], probes, spec)[..., 0]


def test_beams_match_jax(problem):
    for f in (1, 2, 4):
        a = ts.build_beams(problem["xs"], problem["ys"], 22.0, 100e3, f=f)
        b = js.build_beams(problem["xs"], problem["ys"], 22.0, 100e3, f=f)
        np.testing.assert_array_equal(a.kxb, b.kxb)
        np.testing.assert_array_equal(a.kyb, b.kyb)
        assert (a.shift, a.f, a.n_beams) == (b.shift, b.f, b.n_beams)


def test_probe_synthesis_exact(problem):
    """C @ plane-wave basis reproduces probe_array + shift_probes, and the
    coefficients are JAX's."""
    xs, ys = problem["xs"], problem["ys"]
    beams = ts.build_beams(xs, ys, problem["mrad"], problem["eV"], f=1)
    base = tt.Probe(xs, ys, problem["mrad"], problem["eV"],
                    precision="double", device="cpu")
    want = _np(tt.create_batched_probes(base, problem["scan"]).array)
    coeffs = ts.probe_coefficients(beams, problem["scan"], len(xs) * len(ys),
                                   "double", device="cpu")
    waves = np.exp(2j * np.pi
                   * (beams.kxb[:, None, None] * xs[None, :, None]
                      + beams.kyb[:, None, None] * ys[None, None, :]))
    got = np.tensordot(_np(coeffs), waves, axes=(1, 0))
    assert _rel(got, want) < 1e-10
    jb = js.build_beams(xs, ys, problem["mrad"], problem["eV"], f=1)
    assert _rel(coeffs, js.probe_coefficients(
        jb, problem["scan"], len(xs) * len(ys), J_DOUBLE)) <= 1e-12


@pytest.mark.parametrize("beam_chunk", [32, 64, 1000])
def test_f1_exit_waves_match_direct_and_jax(problem, beam_chunk):
    """f=1 synthesis == the direct pipeline, whatever the beam chunks."""
    want = _direct_exit_k(problem)
    sm = _sm(problem, beam_chunk=beam_chunk)
    assert sm.s.shape == (sm.beams.n_beams, 64, 64)
    assert sm.s.dtype == torch.complex128
    got = ts.smatrix_exit_kspace(sm, problem["scan"], "double",
                                 probe_chunk=4)
    assert got.shape == want.shape
    assert _rel(got, want) < 1e-10
    jgot = js.smatrix_exit_kspace(_jsm(problem, beam_chunk=beam_chunk),
                                  problem["scan"], J_DOUBLE, probe_chunk=4)
    assert _rel(got, jgot) <= 1e-10


def test_reduce_matches_explicit_and_jax(problem):
    """smatrix_reduce == mask-weighted |exit| (amplitude, quirk 11), and
    intensity=True squares."""
    sm = _sm(problem)
    jsm = _jsm(problem)
    mask = td.annular_mask(sm.kxs, sm.kys, wavelength(problem["eV"]),
                           inner_mrad=40.0)
    exit_k = _np(ts.smatrix_exit_kspace(sm, problem["scan"], "double"))
    for intensity, power in ((False, 1), (True, 2)):
        want = ((np.abs(exit_k) ** power) * mask[None]).sum(axis=(1, 2))
        got = ts.smatrix_reduce(sm, problem["scan"], mask,
                                intensity=intensity, precision="double",
                                probe_chunk=4)
        np.testing.assert_allclose(got, want, rtol=1e-10)
        assert _rel(got, js.smatrix_reduce(
            jsm, problem["scan"], mask, intensity=intensity,
            precision=J_DOUBLE, probe_chunk=4)) <= 1e-10


def test_prism_f2_approximation(problem):
    """f=2 quarters the beam count; interior probes stay within the PRISM
    accuracy regime; the port's f=2 values are JAX's."""
    xs = problem["xs"]
    lx = xs[-1] + xs[1]
    scan = tt.probe_grid([lx * 0.35, lx * 0.65], [lx * 0.35, lx * 0.65], 3, 3)
    lam = wavelength(problem["eV"])
    vals = {}
    for f in (1, 2):
        sm = _sm(problem, f=f)
        assert len(sm.kxs) == len(xs) // f
        mask = td.annular_mask(sm.kxs, sm.kys, lam, inner_mrad=40.0)
        vals[f] = ts.smatrix_reduce(sm, scan, mask, intensity=True,
                                    precision="double")
        jv = js.smatrix_reduce(_jsm(problem, f=f), scan, mask,
                               intensity=True, precision=J_DOUBLE)
        assert _rel(vals[f], jv) <= 1e-10
        if f == 2:
            assert sm.beams.n_beams < _sm(problem).beams.n_beams / 2.5
            k = _np(ts.smatrix_exit_kspace(sm, scan, "double"))
            jk = np.asarray(js.smatrix_exit_kspace(_jsm(problem, f=2), scan,
                                                   J_DOUBLE))
            assert k.shape == (9, 32, 32) and _rel(k, jk) <= 1e-10
    rel = np.abs(vals[2] - vals[1]) / (np.abs(vals[1]).max() + 1e-30)
    assert rel.max() < 0.08 and rel.mean() < 0.04


def test_prism_f_must_divide_grid_and_beam_validation(problem):
    with pytest.raises(ValueError, match="must divide"):
        ts.build_beams(problem["xs"][:63], problem["ys"][:63], 20.0,
                       problem["eV"], f=2)
    with pytest.raises(ValueError, match="convergent"):
        ts.build_beams(problem["xs"], problem["ys"], 0.0, problem["eV"])


def test_f1_aberrated_probe_matches_direct(problem):
    """Defocus + aberrations imprint exactly on the k-diagonal basis."""
    ab = Aberrations(A1=80.0, phi_A1=0.4, C3=2e5)
    want = _direct_exit_k(problem, defocus=120.0, ab=ab)
    got = ts.smatrix_exit_kspace(_sm(problem, beam_chunk=32),
                                 problem["scan"], "double", probe_chunk=4,
                                 aberrations=ab, defocus=120.0)
    assert _rel(got, want) < 1e-10
    from pyslice_tpu.physics.aberrations import Aberrations as JAb
    jgot = js.smatrix_exit_kspace(
        _jsm(problem, beam_chunk=32), problem["scan"], J_DOUBLE,
        probe_chunk=4, aberrations=JAb(A1=80.0, phi_A1=0.4, C3=2e5),
        defocus=120.0)
    assert _rel(got, jgot) <= 1e-10


def test_prism_window_centering_odd_grid():
    """f>1 on an odd grid: the crop window centres the probe peak."""
    n = 63
    xs = np.linspace(0, n * 0.15, n, endpoint=False)
    plan = tt.make_plan(xs, xs, np.array([0.0]), np.zeros((1, 1, 3)),
                        np.array([1], np.int32))
    beams = ts.build_beams(xs, xs, 25.0, 100e3, f=3)
    sm = ts.compute_smatrix(np.zeros((1, 3)), plan, beams, xs=xs, ys=xs,
                            dz=0.5, precision="double", device="cpu")
    exit_k = _np(ts.smatrix_exit_kspace(sm, [(xs[12], xs[40])], "double"))[0]
    win = np.fft.ifft2(np.fft.ifftshift(exit_k))
    wx, wy = sm.window
    peak = np.unravel_index(np.argmax(np.abs(win)), win.shape)
    assert peak == (wx // 2, wy // 2)


def _haadf_spec(problem, precision="double"):
    return SimSpec.create(problem["grid"], problem["plan"], problem["eV"],
                          precision=precision)


def test_streaming_haadf_smatrix_parity(problem):
    """StreamingHAADF through the S-matrix (f=1) equals the direct stream,
    and the JAX S-matrix stream."""
    spec = _haadf_spec(problem)
    base = tt.Probe(problem["xs"], problem["ys"], problem["mrad"],
                    problem["eV"], precision="double", device="cpu")
    probes = tt.create_batched_probes(base, problem["scan"]).array
    imgs = {}
    for use in (False, True):
        st = StreamingHAADF(spec, probes, problem["scan"],
                            collection_angle=45, intensity=True,
                            mrad=problem["mrad"], use_smatrix=use,
                            beam_chunk=32, synth_chunk=4)
        assert st.use_smatrix == use
        for f in range(2):
            st.add_frame(problem["pos"], frame_index=f)
        imgs[use] = st.image()
    np.testing.assert_allclose(imgs[True], imgs[False], rtol=1e-10)
    from pyslice_tpu.core.grids import Grid as JGrid
    from pyslice_tpu.engine.pipeline import SimSpec as JSpec
    from pyslice_tpu.engine.streaming import StreamingHAADF as JHAADF
    g = problem["grid"]
    jspec = JSpec.create(JGrid(xs=g.xs, ys=g.ys, zs=g.zs, lx=g.lx, ly=g.ly,
                               lz=g.lz, sampling=g.sampling,
                               slice_thickness=g.slice_thickness),
                         _jplan(problem), problem["eV"], precision=J_DOUBLE)
    jst = JHAADF(jspec, None, problem["scan"], collection_angle=45,
                 intensity=True, mrad=problem["mrad"], use_smatrix=True)
    st = StreamingHAADF(spec, None, problem["scan"], collection_angle=45,
                        intensity=True, mrad=problem["mrad"],
                        use_smatrix=True, device="cpu")
    for f in range(2):
        jst.add_frame(problem["pos"], frame_index=f)
        st.add_frame(problem["pos"], frame_index=f)
    assert _rel(st.image(), jst.image()) <= 1e-10


def test_smatrix_auto_crossover(problem, monkeypatch):
    """use_smatrix=None routes above SMATRIX_MIN_PROBES, only with mrad."""
    spec = _haadf_spec(problem)
    probes = tt.create_batched_probes(
        tt.Probe(problem["xs"], problem["ys"], problem["mrad"],
                 problem["eV"], precision="double", device="cpu"),
        problem["scan"]).array
    assert ts.SMATRIX_MIN_PROBES == js.SMATRIX_MIN_PROBES == 2000
    st = StreamingHAADF(spec, probes, problem["scan"], mrad=problem["mrad"])
    assert not st.use_smatrix                       # 9 probes < crossover
    monkeypatch.setattr(ts, "SMATRIX_MIN_PROBES", 4)
    st = StreamingHAADF(spec, probes, problem["scan"], mrad=problem["mrad"])
    assert st.use_smatrix
    st = StreamingHAADF(spec, probes, problem["scan"])   # no mrad -> off
    assert not st.use_smatrix
    with pytest.raises(ValueError, match="probes=None"):
        StreamingHAADF(spec, None, problem["scan"])
    with pytest.raises(ValueError, match="mrad"):
        StreamingHAADF(spec, probes, problem["scan"], use_smatrix=True)


def test_compute_smatrix_mesh_raises(problem):
    beams = ts.build_beams(problem["xs"], problem["ys"], 22.0, 100e3)
    with pytest.raises(NotImplementedError, match="Multi-GPU"):
        ts.compute_smatrix(problem["pos"], problem["plan"], beams,
                           xs=problem["xs"], ys=problem["ys"],
                           dz=problem["dz"], mesh=object(), device="cpu")


def test_smatrix_virtual_image_matches_detectors(problem):
    """The S-matrix virtual image == detectors.virtual_image over a direct
    WFData (f=1), and JAX's."""
    sm = _sm(problem)
    mask = td.annular_mask(sm.kxs, sm.kys, wavelength(problem["eV"]),
                           inner_mrad=40.0)
    img, xs_s, ys_s = ts.smatrix_virtual_image(sm, problem["scan"], mask,
                                               intensity=True,
                                               precision="double")
    wf_k = _np(_direct_exit_k(problem))
    base = tt.Probe(problem["xs"], problem["ys"], problem["mrad"],
                    problem["eV"], precision="double", device="cpu")
    wf = tt.WFData(probe_positions=np.asarray(problem["scan"]),
                   time=np.array([0.0]), kxs=sm.kxs, kys=sm.kys,
                   layer=np.array([0]),
                   wavefunction_data=wf_k[:, None, :, :, None], probe=base)
    np.testing.assert_allclose(img, td.virtual_image(wf, mask,
                                                     intensity=True),
                               rtol=1e-10)
    jimg, jxs, jys = js.smatrix_virtual_image(_jsm(problem), problem["scan"],
                                              mask, intensity=True,
                                              precision=J_DOUBLE)
    assert _rel(img, jimg) <= 1e-10
    np.testing.assert_array_equal(xs_s, jxs)
    np.testing.assert_array_equal(ys_s, jys)


def test_complex64_smatrix_matches_jax(problem):
    """Single precision: the f=1 exit waves and the S-matrix stream's image
    against JAX's, residual <= 1e-6."""
    got = ts.smatrix_exit_kspace(_sm(problem, precision="single"),
                                 problem["scan"], "single")
    assert got.dtype == torch.complex64
    want = js.smatrix_exit_kspace(_jsm(problem, precision=J_SINGLE),
                                  problem["scan"], J_SINGLE)
    assert residual(_np(got), np.asarray(want)) <= 1e-6
    assert residual(_np(got), _np(_direct_exit_k(problem, "single"))) <= 1e-6
