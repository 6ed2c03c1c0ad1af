"""Port parity: the ptychography solvers of pyslice_tpu_torch.analysis.
ptychography against pyslice_tpu's on the same data (JAX x64 on the CPU):
msp_reconstruct and its Adam, scan_grid_data, SSB, iCoM and ePIE (float64
to 1e-10, the iterative solvers to 1e-8, complex64 to the 1e-6 residual),
plus the SSB, iCoM, ePIE and scan_grid_data tests of
tests/test_ptychography.py mirrored on the port."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import optax
from pyslice_tpu.analysis import ptychography as jptycho
from pyslice_tpu.analysis.wf_data import WFData as JWFData
from pyslice_tpu.core.dtypes import DOUBLE as JDOUBLE
from pyslice_tpu.core.dtypes import SINGLE as JSINGLE
from pyslice_tpu.physics.probe import Probe as JProbe
from pyslice_tpu_torch.analysis import ptychography as tptycho
from pyslice_tpu_torch.analysis.wf_data import WFData
from pyslice_tpu_torch.core.constants import interaction_parameter, wavelength
from pyslice_tpu_torch.core.dtypes import DOUBLE, SINGLE
from pyslice_tpu_torch.physics.potential import make_plan, rasterize
from pyslice_tpu_torch.physics.probe import Probe as TProbe, shift_probes
from pyslice_tpu_torch.physics.propagate import multislice

from oracle import residual

torch.set_num_threads(2)

NX = NY = 48
SAMPLING, EV, MRAD, DZ, NZ = 0.15, 100e3, 20.0, 1.0, 2


def _rel(got, want):
    return np.abs(np.asarray(got) - np.asarray(want)).max() / \
        np.abs(np.asarray(want)).max()


@pytest.fixture(scope="module")
def problem():
    return _problem()


def _problem():
    """A smooth random two-slice potential, a 4 x 4 scan, and the
    fftshifted intensities the port's plain multislice gives for it.

    The probe is soft: every k pixel is lit (amplitude 1/(1 + k^2/k0^2),
    random phases). A hard aperture leaves dark pixels whose model values
    are FFT roundoff, and the amplitude misfit's gradient there, (1 -
    a/|F|) F, is roundoff-dependent: the two packages (or JAX with and
    without jit) then differ by ~1e-4 relative in the gradient, which Adam
    passes on to the potential. With every pixel lit both agree to ~1e-15.
    """
    xs = np.linspace(0, NX * SAMPLING, NX, endpoint=False)
    ys = np.linspace(0, NY * SAMPLING, NY, endpoint=False)
    rng = np.random.default_rng(21)
    kx = np.fft.fftfreq(NX, SAMPLING)[:, None]
    ky = np.fft.fftfreq(NY, SAMPLING)[None, :]
    smooth = np.exp(-(kx ** 2 + ky ** 2) / 0.5)
    v = np.real(np.fft.ifft2(np.fft.fft2(rng.normal(size=(NZ, NX, NY)))
                             * smooth)) * 400.0
    pk = (np.exp(2j * np.pi * rng.random((NX, NY)))
          / (1.0 + (kx ** 2 + ky ** 2) / 0.6 ** 2))
    probe = np.fft.ifft2(pk)
    scan = np.array([(1.0 + 1.5 * i, 1.2 + 1.4 * j)
                     for i in range(4) for j in range(4)])
    base = TProbe(xs, ys, MRAD, EV, array=probe, precision=DOUBLE,
                  device="cpu")
    probes = shift_probes(base.array, base.kxs, base.kys, scan, DOUBLE)
    ew = multislice(probes, torch.from_numpy(v), base.kxs, base.kys, eV=EV,
                    dz=DZ, precision=DOUBLE)
    inten = np.abs(np.fft.fftshift(np.fft.fft2(ew.numpy()),
                                   axes=(-2, -1))) ** 2
    return dict(xs=xs, ys=ys, scan=scan, inten=inten, probe=probe,
                rng_pos=rng.normal(0, 0.05, scan.shape))


CASES = {
    "amplitude": {},
    "update_probe": dict(update_probe=True, lr_probe=2e-5),
    "update_positions": dict(update_positions=True, lr_pos=0.02),
    "n_modes": dict(n_modes=2, update_probe=True, lr_probe=2e-5),
    "poisson": dict(loss="poisson", lr=5.0),
    "reg_tv": dict(reg_tv=1e-7),
}


@pytest.mark.parametrize("case", list(CASES))
def test_msp_reconstruct_equals_jax_f64(problem, case):
    p = problem
    kw = dict(CASES[case], n_slices=NZ, dz=DZ, steps=5, batch=6, seed=3)
    data = p["inten"] * (50.0 if case == "poisson" else 1.0)
    scan = p["scan"] + (p["rng_pos"] if case == "update_positions" else 0.0)
    jprobe = JProbe(p["xs"], p["ys"], MRAD, EV, array=p["probe"],
                    precision=JDOUBLE)
    tprobe = TProbe(p["xs"], p["ys"], MRAD, EV, array=p["probe"],
                    precision=DOUBLE, device="cpu")
    want = jptycho.msp_reconstruct(data, scan, jprobe, **kw)
    got = tptycho.msp_reconstruct(data, scan, tprobe, **kw)
    assert got["losses"].shape == (5,) and np.isfinite(got["losses"]).all()
    assert got["losses"][-1] < got["losses"][0]
    for key in ("losses", "potential", "probe", "probe_modes", "positions"):
        assert got[key].shape == np.asarray(want[key]).shape, key
        assert got[key].dtype == np.asarray(want[key]).dtype, key
        assert _rel(got[key], want[key]) <= 1e-8, key
    if kw.get("update_probe"):
        assert _rel(got["probe"], p["probe"]) > 1e-4     # refined
    if kw.get("update_positions"):
        assert _rel(got["positions"], scan) > 1e-4


@pytest.mark.parametrize("is_complex", [False, True])
def test_adam_equals_optax(is_complex):
    rng = np.random.default_rng(4 + is_complex)

    def draw(shape=(5, 7)):
        x = rng.normal(size=shape)
        return x + 1j * rng.normal(size=shape) if is_complex else x

    p0 = draw()
    grads = [draw() * 10.0 ** rng.integers(-3, 3) for _ in range(10)]
    opt = optax.adam(0.03)
    jp = jnp.asarray(p0)
    state = opt.init(jp)
    step = tptycho._Adam(0.03)
    tp = torch.from_numpy(p0)
    for g in grads:
        upd, state = opt.update(jnp.asarray(g), state)
        jp = optax.apply_updates(jp, upd)
        tp = step(tp, torch.from_numpy(g))
        assert _rel(tp.numpy(), np.asarray(jp)) <= 1e-12


def test_helpers_equal_jax(problem):
    p = problem
    np.testing.assert_array_equal(tptycho._epoch_batches(37, 8, 12, 5),
                                  jptycho._epoch_batches(37, 8, 12, 5))
    np.testing.assert_array_equal(tptycho._detector_amplitudes(p["inten"]),
                                  jptycho._detector_amplitudes(p["inten"]))
    kx = np.fft.fftfreq(NX, SAMPLING)
    ky = np.fft.fftfreq(NY, SAMPLING)
    got = tptycho._shift_ramps(torch.from_numpy(kx), torch.from_numpy(ky),
                               torch.from_numpy(p["scan"]))
    want = jptycho._shift_ramps(jnp.asarray(kx), jnp.asarray(ky),
                                jnp.asarray(p["scan"]))
    assert _rel(got.numpy(), want) <= 1e-12
    for n in (48, 51):
        xs = np.linspace(0, n * 0.1, n, endpoint=False)
        assert (tptycho._probe_center(TProbe(xs, xs, 20.0, EV,
                                             device="cpu"))
                == jptycho._probe_center(JProbe(xs, xs, 20.0, EV)))
    assert tptycho._precision_of(torch.float64) is DOUBLE
    assert tptycho._precision_of(torch.float32).name == "single"


def test_msp_argument_errors(problem):
    p = problem
    tprobe = TProbe(p["xs"], p["ys"], MRAD, EV, device="cpu")

    class Mesh:
        def size(self):
            return 4

    with pytest.raises(ValueError, match="minibatch size 6 must divide by "
                       "the mesh's 4 devices"):
        tptycho.msp_reconstruct(p["inten"], p["scan"], tprobe, NZ, DZ,
                                batch=6, mesh=Mesh())
    with pytest.raises(ValueError, match="patterns"):
        tptycho.msp_reconstruct(p["inten"][:3], p["scan"], tprobe, NZ, DZ)
    with pytest.raises(ValueError, match="loss"):
        tptycho.msp_reconstruct(p["inten"], p["scan"], tprobe, NZ, DZ,
                                loss="l1")
    with pytest.raises(ValueError, match="v_init"):
        tptycho.msp_reconstruct(p["inten"], p["scan"], tprobe, NZ, DZ,
                                v_init=np.zeros((1, NX, NY)))


# --- SSB, iCoM, ePIE, scan_grid_data --------------------------------------

WN = 64             # tests/test_ptychography.py's problem: 64^2 at 0.15 A
WS = 32             # 32 x 32 scan at exact 2-pixel steps


def band_limit(img, kxs, kys, q_max):
    mask = (np.asarray(kxs)[:, None] ** 2
            + np.asarray(kys)[None, :] ** 2) < q_max ** 2
    return np.real(np.fft.ifft2(np.fft.fft2(img) * mask))


def pearson(a, b):
    a = np.asarray(a, np.float64) - np.mean(a)
    b = np.asarray(b, np.float64) - np.mean(b)
    return float((a * b).sum()
                 / np.sqrt((a ** 2).sum() * (b ** 2).sum() + 1e-30))


@pytest.fixture(scope="module")
def weak():
    """tests/test_ptychography.py's problem on the port, in float64: a
    weak-phase specimen (max phase 0.05 rad) of 10 random B/N atoms in
    two slices, a 32 x 32 scan at 0.3 A, the intensity-only CBED stack of
    the plain multislice (fftshifted)."""
    lx = WN * SAMPLING
    xs = np.linspace(0, lx, WN, endpoint=False)
    rng = np.random.default_rng(3)
    pos = rng.random((1, 10, 3)) * np.array([lx, lx, 2 * DZ - 0.1])
    types = rng.choice([5, 7], 10).astype(np.int32)
    plan = make_plan(xs, xs, np.array([0.0, DZ]), pos, types)
    v = rasterize(pos[0], plan, DOUBLE, device="cpu").numpy()
    sigma = interaction_parameter(EV)
    v = v * (0.05 / (sigma * np.abs(v).max()))
    scan = np.arange(WS) * (lx / WS)
    positions = np.array([(sx, sy) for sx in scan for sy in scan])
    base = TProbe(xs, xs, MRAD, EV, precision=DOUBLE, device="cpu")
    probes = shift_probes(base.array, base.kxs, base.kys, positions, DOUBLE)
    ew = multislice(probes, torch.from_numpy(v), base.kxs, base.kys, eV=EV,
                    dz=DZ, precision=DOUBLE, fused=False)
    inten = np.abs(np.fft.fftshift(np.fft.fft2(ew.numpy()),
                                   axes=(-2, -1))) ** 2
    return dict(xs=xs, base=base, positions=positions, scan=scan,
                inten=inten, phi_true=sigma * v.sum(axis=0),
                kxs=base.kxs, kxs_shift=np.fft.fftshift(base.kxs))


def _stack(w, dtype=np.float64):
    return w["inten"].reshape(WS, WS, WN, WN).astype(dtype)


def _jprobe(w, precision=JDOUBLE):
    return JProbe(w["xs"], w["xs"], MRAD, EV, array=w["base"].to_cpu(),
                  precision=precision)


@pytest.mark.parametrize("precision", ["double", "single"])
def test_ssb_equals_jax(weak, precision, monkeypatch):
    w = weak
    dt = np.float64 if precision == "double" else np.float32
    kw = dict(probe_center=(1.3, 2.9), mrad=MRAD, eV=EV, q_chunk=300)
    got = tptycho.ssb_reconstruct(_stack(w, dt), w["scan"], w["scan"],
                                  w["kxs_shift"], w["kxs_shift"],
                                  device="cpu", **kw)
    if precision == "double":
        # the JAX package runs the trotter sums in complex64 whatever the
        # data; in float64 both run them in complex128
        monkeypatch.setattr(jptycho, "get_precision", lambda *_: JDOUBLE)
    want = jptycho.ssb_reconstruct(_stack(w, dt), w["scan"], w["scan"],
                                   w["kxs_shift"], w["kxs_shift"], **kw)
    np.testing.assert_array_equal(got["trotter_pixels"],
                                  want["trotter_pixels"])
    np.testing.assert_array_equal(got["qxs"], want["qxs"])
    if precision == "double":
        assert _rel(got["phase"], want["phase"]) <= 1e-10
    else:
        assert residual(got["phase"], want["phase"]) <= 1e-6


def test_icom_equals_jax(weak):
    w = weak
    data = _stack(w)
    data[3, 5] = 0.0                        # a zero-count frame
    kw = dict(probe_center=(1.3, 2.9))
    got = tptycho.icom_reconstruct(data, w["scan"], w["scan"],
                                   w["kxs_shift"], w["kxs_shift"],
                                   device="cpu", **kw)
    want = jptycho.icom_reconstruct(data, w["scan"], w["scan"],
                                    w["kxs_shift"], w["kxs_shift"], **kw)
    for key in ("phase", "com"):
        assert got[key].shape == want[key].shape
        assert _rel(got[key], want[key]) <= 1e-10, key
    assert abs(got["curl_rms"] - want["curl_rms"]) <= 1e-10 * want["curl_rms"]
    com = np.random.default_rng(2).normal(size=(2, 8, 8)) * 1e-3
    axis = np.arange(8) * 0.4
    got = tptycho.icom_reconstruct(None, axis, axis, None, None, com=com)
    want = jptycho.icom_reconstruct(None, axis, axis, None, None, com=com)
    assert _rel(got["phase"], want["phase"]) <= 1e-10


@pytest.mark.parametrize("update_probe", [False, True])
@pytest.mark.parametrize("precision", ["double", "single"])
def test_epie_equals_jax(problem, update_probe, precision):
    """Three sweeps over the 16 positions of the soft-probe problem (every
    k pixel lit: with a hard aperture the modulus projection divides
    roundoff by roundoff at dark pixels, and two correct FFTs part there),
    from the probe defocused and a random object. float64 to 1e-8, and
    with update_probe=True this pins the update order (the probe's update
    uses the object from before the position's object update); complex64
    to the 1e-6 residual."""
    p = problem
    double = precision == "double"
    tprec, jprec = (DOUBLE, JDOUBLE) if double else (SINGLE, JSINGLE)
    guess = TProbe(p["xs"], p["ys"], MRAD, EV, array=p["probe"],
                   precision=tprec, device="cpu")
    guess.defocus(30.0)
    jguess = JProbe(p["xs"], p["ys"], MRAD, EV, array=guess.to_cpu(),
                    precision=jprec)
    obj0 = np.exp(0.1j * np.random.default_rng(5).random((NX, NY)))
    data = p["inten"].astype(np.float64 if double else np.float32)
    kw = dict(n_iters=3, alpha=0.5, beta=0.5, update_probe=update_probe,
              obj_init=obj0)
    got = tptycho.epie_reconstruct(data, p["scan"], guess, **kw)
    want = jptycho.epie_reconstruct(data, p["scan"], jguess, **kw)
    for key in ("object", "probe", "losses"):
        assert got[key].dtype == np.asarray(want[key]).dtype, key
        if double:
            assert _rel(got[key], want[key]) <= 1e-8, key
        else:
            assert residual(got[key], np.asarray(want[key])) <= 1e-6, key
    moved = _rel(got["probe"], guess.to_cpu())
    assert (moved > 1e-3) if update_probe else (moved == 0.0)
    assert got["losses"][-1] < got["losses"][0]


@pytest.mark.parametrize("precision", ["double", "single"])
def test_scan_grid_data_equals_jax(weak, precision):
    w = weak
    cdt = np.complex128 if precision == "double" else np.complex64
    perm = np.random.default_rng(0).permutation(len(w["positions"]))
    rng = np.random.default_rng(1)
    waves = (np.sqrt(w["inten"][perm])[:, None, :, :, None]
             * np.exp(1j * rng.random((1, 2, 1, 1, 1)))).astype(cdt)
    waves[:, 1] *= 0.7
    fields = dict(probe_positions=w["positions"][perm],
                  time=np.array([0.0, 1.0]), kxs=w["kxs_shift"],
                  kys=w["kxs_shift"], layer=np.array([0]))
    xs, ys, got = tptycho.scan_grid_data(WFData(
        wavefunction_data=torch.from_numpy(waves), probe=w["base"],
        **fields))
    jxs, jys, want = jptycho.scan_grid_data(JWFData(
        wavefunction_data=waves, probe=None, **fields))
    np.testing.assert_array_equal(xs, jxs)
    np.testing.assert_array_equal(ys, jys)
    assert got.shape == (WS, WS, WN, WN) and isinstance(got, np.ndarray)
    if precision == "double":
        assert _rel(got, want) <= 1e-10
    else:
        assert residual(got, want) <= 1e-6


def test_scan_grid_data_roundtrip(weak):
    """scan_grid_data reassembles the (sx, sy) stack from a WFData whose
    probe order is scrambled."""
    w = weak
    perm = np.random.default_rng(0).permutation(len(w["positions"]))
    wf = WFData(probe_positions=w["positions"][perm], time=np.array([0.0]),
                kxs=w["kxs_shift"], kys=w["kxs_shift"], layer=np.array([0]),
                wavefunction_data=np.sqrt(w["inten"][perm])
                [:, None, :, :, None].astype(np.complex64), probe=w["base"])
    xs, ys, data4d = tptycho.scan_grid_data(wf)
    np.testing.assert_allclose(xs, w["scan"], atol=1e-9)
    np.testing.assert_allclose(data4d, _stack(w), rtol=2e-5)


def test_scan_grid_data_sharded_raises(weak):
    """A sharded WFData (a DTensor) is taken: on a mesh of one rank it
    reads the local tensor, the unsharded stack bit for bit
    (tests/test_torch_sharded.py holds real meshes)."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Shard
    from pyslice_tpu_torch.parallel.mesh import make_mesh
    waves = torch.from_numpy(np.sqrt(weak["inten"])[:, None, :, :, None])
    kw = dict(probe_positions=weak["positions"], time=np.array([0.0]),
              kxs=weak["kxs_shift"], kys=weak["kxs_shift"],
              layer=np.array([0]), probe=weak["base"])
    mesh = make_mesh(device="cpu")
    try:
        wf = WFData(wavefunction_data=DTensor.from_local(
            waves, mesh, [Shard(1), Shard(0)], run_check=False), **kw)
        got = tptycho.scan_grid_data(wf)
    finally:
        dist.destroy_process_group()
    want = tptycho.scan_grid_data(WFData(wavefunction_data=waves, **kw))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_ssb_recovers_weak_phase(weak):
    w = weak
    rec = tptycho.ssb_reconstruct(_stack(w, np.float32), w["scan"],
                                  w["scan"], w["kxs_shift"], w["kxs_shift"],
                                  probe=w["base"], device="cpu")
    q_band = 2 * (MRAD * 1e-3) / wavelength(EV)
    truth = band_limit(w["phi_true"], w["kxs"], w["kxs"], q_band)[::2, ::2]
    assert pearson(rec["phase"], truth) > 0.9
    ratio = (np.linalg.norm(rec["phase"] - rec["phase"].mean())
             / np.linalg.norm(truth - truth.mean()))
    assert 0.9 < ratio < 1.1, ratio
    tp = rec["trotter_pixels"]
    assert tp[0, 0] == 0
    qx, qy = np.meshgrid(rec["qxs"], rec["qys"], indexing="ij")
    outside = (qx ** 2 + qy ** 2) >= (q_band * 1.05) ** 2
    assert tp[outside].max() == 0
    assert tp[~outside].sum() > 0


def _blurred_truth(w):
    a2 = np.fft.ifftshift(np.abs(w["base"].to_cpu()) ** 2)
    a2_hat = np.fft.fft2(a2)
    return np.real(np.fft.ifft2(np.fft.fft2(w["phi_true"]) * np.conj(a2_hat)
                                / a2_hat[0, 0].real))[::2, ::2]


def test_icom_recovers_blurred_phase(weak):
    w = weak
    rec = tptycho.icom_reconstruct(_stack(w, np.float32), w["scan"],
                                   w["scan"], w["kxs_shift"],
                                   w["kxs_shift"], probe=w["base"],
                                   device="cpu")
    truth = _blurred_truth(w)
    assert pearson(rec["phase"], truth) > 0.95
    ratio = (np.linalg.norm(rec["phase"] - rec["phase"].mean())
             / np.linalg.norm(truth - truth.mean()))
    assert 0.85 < ratio < 1.15, ratio
    assert rec["curl_rms"] < 0.2
    assert rec["com"].shape == (2, WS, WS)


def test_icom_agrees_with_ssb(weak):
    w = weak
    args = (_stack(w, np.float32), w["scan"], w["scan"], w["kxs_shift"],
            w["kxs_shift"])
    icom = tptycho.icom_reconstruct(*args, probe=w["base"], device="cpu")
    ssb = tptycho.ssb_reconstruct(*args, probe=w["base"], device="cpu")
    assert pearson(icom["phase"], ssb["phase"]) > 0.85


def test_ssb_rejects_nonuniform_scan(weak):
    w = weak
    bad = w["scan"].copy()
    bad[3] += 0.05
    with pytest.raises(ValueError, match="uniformly spaced"):
        tptycho.ssb_reconstruct(_stack(w), bad, w["scan"], w["kxs_shift"],
                                w["kxs_shift"], probe=w["base"],
                                device="cpu")
    with pytest.raises(ValueError, match="mrad and eV"):
        tptycho.ssb_reconstruct(_stack(w), w["scan"], w["scan"],
                                w["kxs_shift"], w["kxs_shift"], device="cpu")
    with pytest.raises(ValueError, match=">= 2 scan points"):
        tptycho.icom_reconstruct(_stack(w)[:1, :1], w["scan"][:1],
                                 w["scan"][:1], w["kxs_shift"],
                                 w["kxs_shift"], device="cpu")


def test_epie_recovers_phase_known_probe(weak):
    """PIE (probe frozen at the true illumination) fits the data and
    recovers the object phase within the aperture band."""
    w = weak
    idx = np.array([i * WS + j for i in range(0, WS, 2)
                    for j in range(0, WS, 2)])
    probe = TProbe(w["xs"], w["xs"], MRAD, EV, precision=SINGLE,
                   device="cpu")
    rec = tptycho.epie_reconstruct(w["inten"][idx].astype(np.float32),
                                   w["positions"][idx], probe, n_iters=40,
                                   alpha=0.9, update_probe=False)
    assert rec["losses"][-1] < rec["losses"][0] / 10
    q_band = 2 * (MRAD * 1e-3) / wavelength(EV)
    phase = band_limit(np.angle(rec["object"]), w["kxs"], w["kxs"], q_band)
    truth = band_limit(w["phi_true"], w["kxs"], w["kxs"], q_band)
    assert pearson(phase, truth) > 0.8


def test_epie_probe_update_converges(weak):
    w = weak
    idx = np.array([i * WS + j for i in range(0, WS, 4)
                    for j in range(0, WS, 4)])
    guess = TProbe(w["xs"], w["xs"], MRAD, EV, precision=SINGLE,
                   device="cpu")
    guess.defocus(30.0)
    rec = tptycho.epie_reconstruct(w["inten"][idx].astype(np.float32),
                                   w["positions"][idx], guess, n_iters=30,
                                   alpha=0.5, beta=0.5, update_probe=True)
    assert rec["losses"][-1] < rec["losses"][0] / 3
    assert np.isfinite(rec["losses"]).all()


def test_epie_argument_errors(weak):
    w = weak
    batch = TProbe(w["xs"], w["xs"], MRAD, EV, device="cpu").shifted_batch(
        w["positions"][:2])
    with pytest.raises(ValueError, match="not a batch"):
        tptycho.epie_reconstruct(w["inten"][:2], w["positions"][:2], batch)
    with pytest.raises(ValueError, match="patterns"):
        tptycho.epie_reconstruct(w["inten"][:3], w["positions"][:2],
                                 w["base"])


def test_icom_zero_count_frame_no_nan(weak):
    w = weak
    data4d = _stack(w)
    data4d[3, 5] = 0.0
    rec = tptycho.icom_reconstruct(data4d, w["scan"], w["scan"],
                                   w["kxs_shift"], w["kxs_shift"],
                                   probe=w["base"], device="cpu")
    assert np.all(np.isfinite(rec["phase"]))
    assert np.all(np.isfinite(rec["com"]))
    assert rec["com"][0, 3, 5] == 0.0 and rec["com"][1, 3, 5] == 0.0
