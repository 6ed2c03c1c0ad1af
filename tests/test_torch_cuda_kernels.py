"""The port's CUDA kernels (A, B, C; K4, K5 of the mixed-radix chain; K6,
the resident slice loop; K7, K8 of the adjoint's backward chain) against
their plain torch.fft versions, on the card. Every test needs a CUDA device and skips without
one. The machine with the card has no JAX, so run this file there without
the JAX-side conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_kernels.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from pyslice_tpu_torch.core.constants import interaction_parameter, wavelength
from pyslice_tpu_torch.ops import fused_step as fs
from pyslice_tpu_torch.ops import fused_step_odd as fo
from pyslice_tpu_torch.ops import fused_step_odd_resident as fodr
from pyslice_tpu_torch.ops import fused_step_resident as fr

pytestmark = pytest.mark.cuda

# float32 FFT passes against cuFFT: ~1e-6 relative per transform
# pair, far inside these bars.
MAX_REL = 1e-4
MAX_RESIDUAL = 1e-6
LAM = wavelength(100e3)
SIGMA = interaction_parameter(100e3)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    fs.build()
    return torch.device("cuda")


def _errors(got, want):
    d = (got - want).abs().max().item()
    rel = d / want.abs().max().item()
    f, r = got.abs().double(), want.abs().double()
    res = (((f - r) ** 2).sum() / (f ** 2).sum()).item()
    return rel, res


def _ok(got, want):
    torch.cuda.synchronize()
    rel, res = _errors(got, want)
    assert rel <= MAX_REL and res <= MAX_RESIDUAL, (rel, res)


def _wave(dev, P, nx, ny, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn((P, nx, ny), dtype=torch.complex64, device=dev,
                       generator=g)


def _phase(dev, nx, ny, seed=1, scale=20.0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn((nx, ny), device=dev, generator=g) * scale


# (16, 2048, 2048) and (64, 2048, 2048): config 5's probe chunk and its
# whole probe batch
SHAPES = [(2, 128, 128), (3, 256, 512), (16, 1024, 1024), (1, 2048, 2048),
          (2, 4096, 128), (1, 128, 4096), (16, 2048, 2048),
          (64, 2048, 2048)]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("mode", ["first", "mid", "last", "only"])
@pytest.mark.parametrize("phase", [False, True])
def test_row_pass_matches_plain(dev, shape, mode, phase):
    P, nx, ny = shape
    psi = _wave(dev, P, nx, ny)
    sv = _phase(dev, nx, ny)
    t = sv if phase else torch.complex(torch.cos(sv), torch.sin(sv))
    n0 = fs.launches["a"]
    got = fs.row_pass(mode, psi, t)
    assert fs.launches["a"] == n0 + 1
    _ok(got, fs._plain_row_pass(mode, psi, t))
    _grid_ok(fs.last_launch["a"])
    buf = psi.clone()
    assert fs.row_pass(mode, buf, t, out=buf) is buf       # in place
    _ok(buf, got)


@pytest.mark.parametrize("shape", SHAPES)
def test_col_pass_and_kconvert_match_plain(dev, shape):
    P, nx, ny = shape
    psi = _wave(dev, P, nx, ny)
    kxs = np.fft.fftfreq(nx, 0.1)
    kys = np.fft.fftfreq(ny, 0.1)
    prop = fs.fresnel_plane(kxs, kys, LAM, 0.4846, kmax2=16.0,
                            tantilt=(0.003, -0.001), device=dev)
    _ok(fs.col_pass(psi, prop), fs._plain_col_pass(psi, prop))
    _grid_ok(fs.last_launch["b"])
    _ok(fs.kconvert(psi), fs._plain_kconvert(psi))


def _t_form(dev, nx, ny, phase):
    sv = _phase(dev, nx, ny)
    return sv if phase else torch.complex(torch.cos(sv), torch.sin(sv))


@pytest.mark.parametrize("P", [16, 32])
def test_col_pass_in_place_at_1024(dev, P):
    """B at 16 x 1024^2 (the forward's) and 32 x 1024^2 (the adjoint's
    pair stream), a new buffer and in place."""
    psi = _wave(dev, P, 1024, 1024)
    prop = _prop(dev, 1024, 1024)
    got = fs.col_pass(psi, prop)
    _ok(got, fs._plain_col_pass(psi, prop))
    run = fs.last_launch["b"]
    _grid_ok(run)
    assert run["blocks_per_sm"] >= fs.COL_BOUND[1]
    buf = psi.clone()
    assert fs.col_pass(buf, prop, out=buf) is buf
    _ok(buf, got)


@pytest.mark.parametrize("mode", ["first", "mid", "last", "only"])
@pytest.mark.parametrize("phase", [False, True])
def test_row_pass_in_place_at_1024_is_bit_identical(dev, mode, phase):
    """A at 16 x 1024^2 in place in every mode and t form; two launches on
    the same inputs give the same bits."""
    psi = _wave(dev, 16, 1024, 1024)
    t = _t_form(dev, 1024, 1024, phase)
    first = fs.row_pass(mode, psi, t)
    second = fs.row_pass(mode, psi, t)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    _ok(first, fs._plain_row_pass(mode, psi, t))
    buf = psi.clone()
    assert fs.row_pass(mode, buf, t, out=buf) is buf
    torch.cuda.synchronize()
    assert torch.equal(buf, first)


def test_col_pass_is_bit_identical(dev):
    psi = _wave(dev, 16, 1024, 1024)
    prop = _prop(dev, 1024, 1024)
    first = fs.col_pass(psi, prop)
    second = fs.col_pass(psi, prop)
    buf = psi.clone()
    fs.col_pass(buf, prop, out=buf)
    torch.cuda.synchronize()
    assert torch.equal(first, second) and torch.equal(buf, first)


@pytest.mark.parametrize("shape", [(16, 1024, 1024), (3, 256, 512)])
def test_passes_on_a_view_off_16_byte_alignment(dev, shape):
    """A wave one complex64 element (8 bytes) past a 16-byte boundary: A
    and B, which load and store 8 bytes a value, agree with their plain
    versions, in place too."""
    P, nx, ny = shape
    store = torch.empty(P * nx * ny + 1, dtype=torch.complex64, device=dev)
    psi = store[1:].view(P, nx, ny)
    psi.copy_(_wave(dev, P, nx, ny))
    assert psi.data_ptr() % 16 == 8
    prop = _prop(dev, nx, ny)
    _ok(fs.col_pass(psi, prop), fs._plain_col_pass(psi, prop))
    t = _t_form(dev, nx, ny, False)
    _ok(fs.row_pass("mid", psi, t), fs._plain_row_pass("mid", psi, t))
    want = fs._plain_col_pass(psi, prop)
    assert fs.col_pass(psi, prop, out=psi) is psi
    _ok(psi, want)


@pytest.mark.parametrize("nz", [1, 2, 14])
def test_chains_match_plain(dev, nz):
    psi = _wave(dev, 4, 512, 256)
    g = torch.Generator(device=dev).manual_seed(2)
    v = torch.randn((nz, 512, 256), device=dev, generator=g) * 50
    kxs, kys = np.fft.fftfreq(512, 0.1), np.fft.fftfreq(256, 0.1)
    kw = dict(sigma=SIGMA, lam=LAM, dz=0.5)
    before = dict(fs.launches)
    got = fs.fused_multislice_kspace(psi, v, kxs, kys, **kw)
    assert (fs.launches["a"] - before["a"], fs.launches["b"] - before["b"],
            fs.launches["c"] - before["c"]) == (nz, nz - 1, 1)
    _ok(got, fs.fused_multislice_kspace_plain(psi, v, kxs, kys, **kw))
    _ok(fs.fused_multislice(psi, v, kxs, kys, **kw),
        fs.fused_multislice_plain(psi, v, kxs, kys, **kw))
    if nz == 14:
        _ok(fs.fused_multislice(psi, v, kxs, kys, record_layers=(3, 13), **kw),
            fs.fused_multislice_plain(psi, v, kxs, kys, record_layers=(3, 13),
                                      **kw))
    assert torch.equal(psi, _wave(dev, 4, 512, 256))   # input untouched


def test_wrappers_raise_on_ineligible_cuda_tensors(dev):
    with pytest.raises(ValueError, match="unsupported grid"):
        fs.row_pass("first", _wave(dev, 1, 384, 128),
                    torch.zeros((384, 128), device=dev))
    with pytest.raises(TypeError, match="complex64"):
        fs.kconvert(_wave(dev, 1, 128, 128).to(torch.complex128))
    with pytest.raises(ValueError, match="shape"):
        fs.col_pass(_wave(dev, 1, 128, 128),
                    torch.ones((128, 256), dtype=torch.complex64, device=dev))


# --- K4, K5 (mixed-radix chain) and K6 (resident loop) ----------------------

# 1280, 2304, 3968: K4's and K5's tiles of 4, 2 and 2 lanes; 1018: a
# direct-sum stage (509), which dispatch no longer sends here but the
# kernels still take
MR_SIZES = [258, 384, 387, 1018, 1023, 1152, 1280, 2304, 3968]


def _prop(dev, nx, ny):
    return fs.fresnel_plane(np.fft.fftfreq(nx, 0.1), np.fft.fftfreq(ny, 0.1),
                            LAM, 0.4846, kmax2=16.0, tantilt=(0.003, -0.001),
                            device=dev)


def _grid_ok(run):
    """A persistent launch's grid: at most its tiles and what the card
    holds at once."""
    assert 1 <= run["grid"] <= min(run["tiles"],
                                   run["blocks_per_sm"] * run["sms"])


@pytest.mark.parametrize("n", MR_SIZES)
@pytest.mark.parametrize("P", [1, 3, 16, 32])
@pytest.mark.parametrize("mode", ["first", "mid", "last", "only"])
def test_row_pass_mr_matches_plain(dev, n, P, mode):
    """K4 on P x nx x n (odd and even n among MR_SIZES; nx = 387, a ragged
    last tile, or 258), with the phase and the complex plane, in place
    too. P = 3 gives a tile count that is no multiple of the persistent
    grid; P = 32 several rounds of it."""
    psi = _wave(dev, P, 387 if n != 387 else 258, n)
    nx = psi.shape[1]
    sv = _phase(dev, nx, n)
    for t in (sv, torch.complex(torch.cos(sv), torch.sin(sv))):
        n0 = fs.launches["k4"]
        got = fo.row_pass_mr(mode, psi, t)
        assert fs.launches["k4"] == n0 + 1
        _ok(got, fs._plain_row_pass(mode, psi, t))
        _grid_ok(fo.last_launch["k4"])
        buf = psi.clone()
        assert fo.row_pass_mr(mode, buf, t, out=buf) is buf       # in place
        _ok(buf, got)


@pytest.mark.parametrize("n", MR_SIZES)
@pytest.mark.parametrize("P", [1, 3, 16, 32])
def test_col_pass_mr_matches_plain(dev, n, P):
    """K5 on P x n x 393 (odd ny: 8-byte copies) and P x n x 394 (even:
    16-byte), in place too. P = 3 gives a tile count that is no multiple of
    the persistent grid."""
    for ny in (393, 394):
        psi = _wave(dev, P, n, ny)
        prop = _prop(dev, n, ny)
        n0 = fs.launches["k5"]
        got = fo.col_pass_mr(psi, prop)
        assert fs.launches["k5"] == n0 + 1
        _ok(got, fs._plain_col_pass(psi, prop))
        _grid_ok(fo.last_launch["k5"])
        buf = psi.clone()
        assert fo.col_pass_mr(buf, prop, out=buf) is buf       # in place
        _ok(buf, got)


POW2_SIZES = [128, 256, 512, 1024, 2048, 4096]
# K4's and K5's register engine (fo.REG_MR_AXES): 1023 = 31 | 11 x 3,
# 513 = 19 | 3 x 3 x 3
REG_MR_SIZES = [1023, 513]


@pytest.mark.parametrize("n", REG_MR_SIZES)
@pytest.mark.parametrize("P", [1, 3, 16, 32])
@pytest.mark.parametrize("ny", [393, 394, 1023])
def test_col_pass_mr_regs_match_plain(dev, n, P, ny):
    """K5 on its register engine, P x n x ny (393: a ragged last tile of
    one column; 394 of two; 1023 of seven), against its plain version,
    and in place the same bits."""
    psi = _wave(dev, P, n, ny)
    prop = _prop(dev, n, ny)
    n0, r0 = fs.launches["k5"], fs.launches["k5_regs"]
    got = fo.col_pass_mr(psi, prop)
    assert (fs.launches["k5"], fs.launches["k5_regs"]) == (n0 + 1, r0 + 1)
    run = fo.last_launch["k5"]
    assert run["engine"] == "regs" and run["groups"] == fo.REG_MR_AXES[n]
    assert run["blocks_per_sm"] == 1
    _grid_ok(run)
    _ok(got, fs._plain_col_pass(psi, prop))
    buf = psi.clone()
    assert fo.col_pass_mr(buf, prop, out=buf) is buf       # in place
    torch.cuda.synchronize()
    assert torch.equal(buf, got)


@pytest.mark.parametrize("n", REG_MR_SIZES)
def test_col_pass_mr_regs_are_bit_identical(dev, n):
    psi = _wave(dev, 16, n, n)
    prop = _prop(dev, n, n)
    first = fo.col_pass_mr(psi, prop)
    second = fo.col_pass_mr(psi, prop)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.parametrize("n", [1023, 513, 1152, 387])
def test_col_pass_mr_engine_follows_the_plan(dev, n):
    """``launches["k5_regs"]`` advances and ``last_launch["k5"]["engine"]``
    reads "regs" on the axes of REG_MR_AXES only; "k5" counts both
    engines."""
    psi = _wave(dev, 2, n, 258)
    regs = n in fo.REG_MR_AXES
    n0, r0 = fs.launches["k5"], fs.launches["k5_regs"]
    fo.col_pass_mr(psi, _prop(dev, n, 258))
    assert fs.launches["k5"] == n0 + 1
    assert fs.launches["k5_regs"] == r0 + regs
    assert fo.last_launch["k5"]["engine"] == ("regs" if regs else "tiles")
    assert isinstance(fo.col_plan(n, 2, 258), fo.RegMrPlan) == regs


@pytest.mark.parametrize("n", REG_MR_SIZES)
@pytest.mark.parametrize("P", [1, 16, 32])
@pytest.mark.parametrize("mode", ["first", "mid", "last", "only"])
@pytest.mark.parametrize("phase", [False, True])
def test_row_pass_mr_regs_match_plain(dev, n, P, mode, phase):
    """K4 on its register engine, P x n x n (n rows: a ragged last tile,
    1023 = 127 * 8 + 7, 513 = 64 * 8 + 1), with the phase or the complex
    plane, against its plain version, and in place the same bits."""
    psi = _wave(dev, P, n, n)
    sv = _phase(dev, n, n)
    t = sv if phase else torch.complex(torch.cos(sv), torch.sin(sv))
    n0, r0 = fs.launches["k4"], fs.launches["k4_regs"]
    got = fo.row_pass_mr(mode, psi, t)
    assert (fs.launches["k4"], fs.launches["k4_regs"]) == (n0 + 1, r0 + 1)
    run = fo.last_launch["k4"]
    assert run["engine"] == "regs" and run["groups"] == fo.REG_MR_AXES[n]
    _grid_ok(run)
    _ok(got, fs._plain_row_pass(mode, psi, t))
    buf = psi.clone()
    assert fo.row_pass_mr(mode, buf, t, out=buf) is buf       # in place
    torch.cuda.synchronize()
    assert torch.equal(buf, got)


@pytest.mark.parametrize("n", REG_MR_SIZES)
@pytest.mark.parametrize("phase", [False, True])
def test_row_pass_mr_regs_are_bit_identical(dev, n, phase):
    psi = _wave(dev, 16, n, n)
    sv = _phase(dev, n, n)
    t = sv if phase else torch.complex(torch.cos(sv), torch.sin(sv))
    first = fo.row_pass_mr("mid", psi, t)
    second = fo.row_pass_mr("mid", psi, t)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.parametrize("n", [1023, 513, 1152, 387])
def test_row_pass_mr_engine_follows_the_plan(dev, n):
    """``launches["k4_regs"]`` advances and ``last_launch["k4"]["engine"]``
    reads "regs" on the axes of REG_MR_AXES only; "k4" counts both
    engines."""
    psi = _wave(dev, 2, 258, n)
    regs = n in fo.REG_MR_AXES
    n0, r0 = fs.launches["k4"], fs.launches["k4_regs"]
    fo.row_pass_mr("mid", psi, _phase(dev, 258, n))
    assert fs.launches["k4"] == n0 + 1
    assert fs.launches["k4_regs"] == r0 + regs
    assert fo.last_launch["k4"]["engine"] == ("regs" if regs else "tiles")
    assert isinstance(fo.row_plan(n, 2, 258), fo.RegMrPlan) == regs


def test_stem_chain_at_1023_runs_k5_on_registers(dev):
    """The STEM cell's chain, 16 probes at 1023^2 through 14 slices: every
    K4 and K5 launch on the register engine, and the exit wave against the
    plain chain."""
    psi = _wave(dev, 16, 1023, 1023)
    g = torch.Generator(device=dev).manual_seed(3)
    v = torch.randn((14, 1023, 1023), device=dev, generator=g) * 50
    ks = np.fft.fftfreq(1023, 0.1)
    kw = dict(sigma=SIGMA, lam=LAM, dz=0.4846)
    before = dict(fs.launches)
    got = fo.fused_multislice_odd(psi, v, ks, ks, **kw)
    k5 = fs.launches["k5"] - before["k5"]
    assert (fs.launches["k4"] - before["k4"], k5) == (14, 13)
    assert fs.launches["k5_regs"] - before["k5_regs"] == k5
    assert fs.launches["k4_regs"] - before["k4_regs"] == 14
    _ok(got, fs.fused_multislice_plain(psi, v, ks, ks, **kw))


# (nx, ny) of K6's cases: the mixed-radix instantiation on every MR_SIZES
# axis beside an even (258) or odd (387) one and on a power-of-two axis
# beside 258; the power-of-two instantiation on every axis from 128 to
# 4096 beside 256 (128 beside 256), each of which the dispatch sends to K6
# at one probe
RES_SHAPES = ([(258, n) for n in MR_SIZES if n != 258] + [(387, 258),
                                                          (258, 1024)]
              + [(256, n) for n in POW2_SIZES if n != 256] + [(128, 256)])


def _resident_plan_ok(psi, t):
    """K6's last launch: the plan of fr.resident_plan, and a grid the card
    holds at once."""
    run = fr.last_launch
    P, nx, ny = psi.shape
    plan = fr.resident_plan(P, nx, ny, run["sms"], run["blocks_per_sm"],
                            phase=not t.is_complex())
    assert run["engine"] == ("pow2" if fs.supported_size(nx)
                             and fs.supported_size(ny) else "mixed")
    for key in ("threads", "row_lanes", "col_lanes", "smem_bytes", "grid"):
        assert run[key] == getattr(plan, key), key
    assert 1 <= run["grid"] <= run["blocks_per_sm"] * run["sms"]


@pytest.mark.parametrize("shape", RES_SHAPES, ids=lambda s: "%dx%d" % s)
@pytest.mark.parametrize("P", [1, 16])
@pytest.mark.parametrize("kspace", [False, True])
def test_resident_loop_matches_plain(dev, shape, P, kspace):
    nx, n = shape
    psi = _wave(dev, P, nx, n)
    g = torch.Generator(device=dev).manual_seed(3)
    v = torch.randn((3, nx, n), device=dev, generator=g) * 20
    prop = _prop(dev, nx, n)
    for t in (v, torch.complex(torch.cos(v), torch.sin(v))):
        n0 = fs.launches["k6"]
        got = fr.resident_loop(psi, t, prop, kspace)
        assert fs.launches["k6"] == n0 + 1
        _ok(got, fr._plain_resident_loop(psi, t, prop, kspace))
        _resident_plan_ok(psi, t)


@pytest.mark.parametrize("kspace", [False, True])
def test_resident_loop_at_256_planes(dev, kspace):
    """K6 at 256 x 512^2 x 14, the direct route's probe chunks of a 2,304-
    probe scan (512^2 goes to K6 at any probe count), and at 64 planes,
    the S-matrix's beam chunks."""
    for P in (64, 256):
        psi = _wave(dev, P, 512, 512, seed=9)
        g = torch.Generator(device=dev).manual_seed(10)
        v = torch.randn((14, 512, 512), device=dev, generator=g) * 20
        prop = _prop(dev, 512, 512)
        for t in (v, torch.complex(torch.cos(v), torch.sin(v))):
            n0 = fs.launches["k6"]
            got = fr.resident_loop(psi, t, prop, kspace)
            assert fs.launches["k6"] == n0 + 1
            _ok(got, fr._plain_resident_loop(psi, t, prop, kspace))
            _resident_plan_ok(psi, t)


@pytest.mark.parametrize("n", [256, 1023, 1024, 1152])
@pytest.mark.parametrize("phase", [False, True])
@pytest.mark.parametrize("kspace", [False, True])
def test_resident_loop_fourteen_distinct_slices(dev, n, phase, kspace):
    """14 slices, each with its own t: a phase that read the state of an
    earlier phase (a stale line in L1) would put another slice's wave into
    the product."""
    psi = _wave(dev, 1, n, n, seed=5)
    g = torch.Generator(device=dev).manual_seed(6)
    v = torch.randn((14, n, n), device=dev, generator=g) * 20
    t = v if phase else torch.complex(torch.cos(v), torch.sin(v))
    prop = _prop(dev, n, n)
    _ok(fr.resident_loop(psi, t, prop, kspace),
        fr._plain_resident_loop(psi, t, prop, kspace))
    _resident_plan_ok(psi, t)


@pytest.mark.parametrize("n", [1023, 1024])
@pytest.mark.parametrize("kspace", [False, True])
def test_resident_loop_is_bit_identical(dev, n, kspace):
    """Two launches on the same inputs give the same bits (no atomics, no
    order that depends on the schedule)."""
    psi = _wave(dev, 1, n, n, seed=7)
    g = torch.Generator(device=dev).manual_seed(8)
    v = torch.randn((14, n, n), device=dev, generator=g) * 20
    t = torch.complex(torch.cos(v), torch.sin(v))
    prop = _prop(dev, n, n)
    first = fr.resident_loop(psi, t, prop, kspace)
    assert torch.equal(fr.resident_loop(psi, t, prop, kspace), first)


def test_resident_barrier_floor_launches_no_k6(dev):
    psi = _wave(dev, 1, 1023, 1023)
    v = torch.zeros((14, 1023, 1023), device=dev)
    fr.resident_loop(psi, v, _prop(dev, 1023, 1023), kspace=True)
    n0 = fs.launches["k6"]
    fr.barrier_floor()
    torch.cuda.synchronize()
    assert fs.launches["k6"] == n0


@pytest.mark.parametrize("n", [1023, 1024])
def test_resident_loop_square_grids(dev, n):
    psi = _wave(dev, 1, n, n)
    g = torch.Generator(device=dev).manual_seed(4)
    v = torch.randn((14, n, n), device=dev, generator=g) * 20
    prop = _prop(dev, n, n)
    for kspace in (False, True):
        _ok(fr.resident_loop(psi, v, prop, kspace),
            fr._plain_resident_loop(psi, v, prop, kspace))
    assert fr.last_launch["engine"] == ("pow2" if n == 1024 else "mixed")


@pytest.mark.parametrize("nz", [1, 2, 6])
def test_odd_entry_points_match_plain(dev, nz):
    psi = _wave(dev, 4, 387, 258)
    g = torch.Generator(device=dev).manual_seed(2)
    v = torch.randn((nz, 387, 258), device=dev, generator=g) * 50
    kxs, kys = np.fft.fftfreq(387, 0.1), np.fft.fftfreq(258, 0.1)
    kw = dict(sigma=SIGMA, lam=LAM, dz=0.5)
    before = dict(fs.launches)
    got = fo.fused_multislice_odd(psi, v, kxs, kys, **kw)
    assert (fs.launches["k4"] - before["k4"],
            fs.launches["k5"] - before["k5"]) == (nz, nz - 1)
    _ok(got, fs.fused_multislice_plain(psi, v, kxs, kys, **kw))
    _ok(fodr.fused_multislice_kspace_odd_resident(psi, v, kxs, kys, **kw),
        fs.fused_multislice_kspace_plain(psi, v, kxs, kys, **kw))
    if nz == 6:
        rl = dict(record_layers=(1, 5), **kw)
        want = fs.fused_multislice_plain(psi, v, kxs, kys, **rl)
        _ok(fo.fused_multislice_odd(psi, v, kxs, kys, **rl), want)
        _ok(fodr.fused_multislice_odd_resident(psi, v, kxs, kys, **rl), want)
    assert torch.equal(psi, _wave(dev, 4, 387, 258))   # input untouched


def test_resident_launch_too_large_raises(dev):
    psi = _wave(dev, 1, 387, 393)
    v = torch.zeros((2, 387, 393), device=dev)
    with pytest.raises(RuntimeError, match="cooperative launch too large"):
        fr.resident_loop(psi, v, _prop(dev, 387, 393), blocks=1 << 20)


def test_mr_wrappers_raise_on_ineligible_cuda_tensors(dev):
    with pytest.raises(ValueError, match="unsupported grid"):
        fo.row_pass_mr("first", _wave(dev, 1, 1009, 387),
                       torch.zeros((1009, 387), device=dev))
    with pytest.raises(ValueError, match="nz >= 2"):
        fr.resident_loop(_wave(dev, 1, 387, 387),
                         torch.zeros((1, 387, 387), device=dev),
                         _prop(dev, 387, 387))


# --- K7, K8 (the adjoint's backward row passes) and the adjoint chains -------

from pyslice_tpu_torch.ops import fused_step_adjoint as fa  # noqa: E402
from pyslice_tpu_torch.physics import adjoint as adj  # noqa: E402


def _bwd_ok(got, want):
    """The pair stream as every kernel output; vbar to max|d|/max|ref|."""
    (st, vb), (st_ref, vb_ref) = got, want
    _ok(st, st_ref)
    rel, _ = _errors(vb, vb_ref)
    assert rel <= MAX_REL, rel


def _check_bwd(dev, row_bwd, key, P, nx, ny, mode, phase):
    state = _wave(dev, 2 * P, nx, ny)
    sv = _phase(dev, nx, ny)
    t = None if mode == "last" else (
        sv if phase else torch.complex(torch.cos(sv), torch.sin(sv)))
    n0 = fs.launches[key]
    got = row_bwd(mode, state, t, SIGMA)
    assert fs.launches[key] == n0 + 1
    _bwd_ok(got, fa._plain_row_pass_bwd(mode, state, t, SIGMA))
    _grid_ok(fs.last_launch[key])
    buf = state.clone()
    vb = torch.empty((nx, ny), device=dev)
    out = row_bwd(mode, buf, t, SIGMA, out=buf, vbar=vb)     # in place
    assert out[0] is buf and out[1] is vb
    _bwd_ok(out, got)


BWD_SHAPES = [(128, 128), (256, 512), (1024, 1024), (4096, 128), (128, 4096)]


@pytest.mark.parametrize("shape", BWD_SHAPES)
@pytest.mark.parametrize("P", [1, 16])
@pytest.mark.parametrize("mode,phase", [("mid", False), ("mid", True),
                                        ("last", False)])
def test_row_pass_bwd_matches_plain(dev, shape, P, mode, phase):
    _check_bwd(dev, fa.row_pass_bwd, "k7", P, *shape, mode, phase)


# K7 off the main path: 2048 and 4096 rows (one row a block, 128 and 256
# threads; 16 pairs x 2048^2 and 4 x 4096^2 are 1 GiB pair streams), and
# pair counts that are no power of two at 1024^2.
K7_CASES = [(16, 2048, 2048), (4, 4096, 4096), (3, 1024, 1024),
            (5, 1024, 1024)]


@pytest.mark.parametrize("P,nx,ny", K7_CASES)
@pytest.mark.parametrize("mode,phase", [("mid", False), ("mid", True),
                                        ("last", False)])
def test_row_pass_bwd_large_rows_and_odd_pair_counts(dev, P, nx, ny, mode,
                                                     phase):
    _check_bwd(dev, fa.row_pass_bwd, "k7", P, nx, ny, mode, phase)
    run = fs.last_launch["k7"]
    plan = fs.pair_reg_plan(
        ny, nx, factors=mode == "mid",
        sms=torch.cuda.get_device_properties(dev).multi_processor_count)
    assert (run["lanes"], run["threads"], run["tiles"], run["smem_bytes"]) == (
        plan.lanes, plan.threads, plan.tiles, plan.smem_bytes)
    assert run["blocks_per_sm"] >= fs.PAIR_BOUND[1]


@pytest.mark.parametrize("shape", [(1024, 1024), (4096, 128), (128, 4096)])
@pytest.mark.parametrize("mode,phase", [("mid", False), ("mid", True),
                                        ("last", False)])
def test_row_pass_bwd_is_bit_identical(dev, shape, mode, phase):
    """Two launches of K7 on the same inputs give the same bits, the pair
    stream and vbar: each vbar element has one owner thread, which sums it
    in pair order without atomics."""
    state = _wave(dev, 2 * 16, *shape)
    t = None if mode == "last" else _t_form(dev, *shape, phase)
    first = fa.row_pass_bwd(mode, state, t, SIGMA)
    second = fa.row_pass_bwd(mode, state, t, SIGMA)
    torch.cuda.synchronize()
    assert torch.equal(first[0], second[0])
    assert torch.equal(first[1], second[1])


@pytest.mark.parametrize("n", MR_SIZES)
@pytest.mark.parametrize("P", [1, 16])
@pytest.mark.parametrize("mode,phase", [("mid", False), ("mid", True),
                                        ("last", False)])
def test_row_pass_mr_bwd_matches_plain(dev, n, P, mode, phase):
    _check_bwd(dev, fa.row_pass_mr_bwd, "k8", P, 387 if n != 387 else 258,
               n, mode, phase)


# K8 on nx = 1023 rows: a ragged last row tile at 8 lanes (ny 1023: 1023 =
# 255 * 4 + 3 rows, on the register engine) and, on the tiles, at 4 (1152:
# 511 * 2 + 1); 2 lanes at 2304, and at 3968 with the twiddle table in
# device memory (fused_step_odd pair_plan, pair_tile_plan). P = 3: a pair
# count that is no power of two.
K8_NY = [1023, 1152, 2304, 3968]


@pytest.mark.parametrize("ny", K8_NY)
@pytest.mark.parametrize("P", [1, 3, 16])
@pytest.mark.parametrize("mode,phase", [("mid", False), ("mid", True),
                                        ("last", False)])
def test_row_pass_mr_bwd_1023_rows_matches_plain(dev, ny, P, mode, phase):
    _check_bwd(dev, fa.row_pass_mr_bwd, "k8", P, 1023, ny, mode, phase)
    plan = fo.last_launch["k8"]
    if ny in fo.REG_MR_AXES:
        assert plan["engine"] == "regs" and plan["lanes"] == 8
        return
    assert plan["engine"] == "tiles"
    assert plan["lanes"] == {1152: 4}.get(ny, 2)
    assert plan["table"] == ("device" if ny == 3968 else "shared")


@pytest.mark.parametrize("ny", REG_MR_SIZES)
@pytest.mark.parametrize("P", [1, 3, 64])
@pytest.mark.parametrize("mode,phase", [("mid", False), ("mid", True),
                                        ("last", False)])
def test_row_pass_mr_bwd_regs_match_plain(dev, ny, P, mode, phase):
    """K8 on its register engine, P pairs of 1023 rows of ny (a ragged
    last row tile: 1023 = 255 * 4 + 3), against its plain version, in
    place too; a second launch gives the same bits, the pair stream and
    vbar. P = 64: the MEP cell's pair count."""
    n0, r0 = fs.launches["k8"], fs.launches["k8_regs"]
    _check_bwd(dev, fa.row_pass_mr_bwd, "k8", P, 1023, ny, mode, phase)
    assert (fs.launches["k8"], fs.launches["k8_regs"]) == (n0 + 2, r0 + 2)
    run = fo.last_launch["k8"]
    assert run["engine"] == "regs" and run["groups"] == fo.REG_MR_AXES[ny]
    plan = fo.pair_plan(ny, 1023)
    assert (run["lanes"], run["threads"], run["tiles"], run["smem_bytes"]) == (
        plan.lanes, plan.threads, plan.tiles, plan.smem_bytes)
    state = _wave(dev, 2 * P, 1023, ny, seed=4)
    t = None if mode == "last" else _t_form(dev, 1023, ny, phase)
    first = fa.row_pass_mr_bwd(mode, state, t, SIGMA)
    second = fa.row_pass_mr_bwd(mode, state, t, SIGMA)
    torch.cuda.synchronize()
    assert torch.equal(first[0], second[0])
    assert torch.equal(first[1], second[1])


@pytest.mark.parametrize("n", [1023, 513, 1152, 387])
def test_row_pass_mr_bwd_engine_follows_the_plan(dev, n):
    """``launches["k8_regs"]`` advances and ``last_launch["k8"]["engine"]``
    reads "regs" on the axes of REG_MR_AXES only; "k8" counts both
    engines."""
    state = _wave(dev, 4, 258, n)
    regs = n in fo.REG_MR_AXES
    n0, r0 = fs.launches["k8"], fs.launches["k8_regs"]
    fa.row_pass_mr_bwd("mid", state, _phase(dev, 258, n), SIGMA)
    assert fs.launches["k8"] == n0 + 1
    assert fs.launches["k8_regs"] == r0 + regs
    assert fo.last_launch["k8"]["engine"] == ("regs" if regs else "tiles")
    assert isinstance(fo.pair_plan(n, 258), fo.RegMrPlan) == regs


@pytest.mark.parametrize("ny", K8_NY)
@pytest.mark.parametrize("mode,phase", [("mid", False), ("mid", True),
                                        ("last", False)])
def test_row_pass_mr_bwd_is_bit_identical(dev, ny, mode, phase):
    """Two launches of K8 on the same inputs give the same bits, the pair
    stream and vbar: the sum over pairs is taken in pair order, without
    atomics."""
    state = _wave(dev, 2 * 16, 1023, ny)
    sv = _phase(dev, 1023, ny)
    t = None if mode == "last" else (
        sv if phase else torch.complex(torch.cos(sv), torch.sin(sv)))
    first = fa.row_pass_mr_bwd(mode, state, t, SIGMA)
    second = fa.row_pass_mr_bwd(mode, state, t, SIGMA)
    torch.cuda.synchronize()
    assert torch.equal(first[0], second[0])
    assert torch.equal(first[1], second[1])


@pytest.mark.parametrize("kind,n", [("aligned", 512), ("odd", 387),
                                    ("odd", 1023)])
@pytest.mark.parametrize("P", [1, 16])
@pytest.mark.parametrize("nz", [2, 14])
def test_adjoint_chains_match_plain(dev, kind, n, P, nz):
    a = _wave(dev, P, n, n, seed=5)
    g = _wave(dev, P, n, n, seed=6)
    gen = torch.Generator(device=dev).manual_seed(7)
    v = torch.randn((nz, n, n), device=dev, generator=gen) * 50
    ks = np.fft.fftfreq(n, 0.1)
    kw = dict(sigma=SIGMA, lam=LAM, dz=0.5, tantilt=(0.003, -0.001))
    chain = (fa.fused_adjoint_chain if kind == "aligned"
             else fa.fused_adjoint_chain_odd)
    keys = ("a", "b", "k7") if kind == "aligned" else ("k4", "k5", "k8")
    before = dict(fs.launches)
    got = chain(a, g, v, ks, ks, **kw)
    assert tuple(fs.launches[k] - before[k] for k in keys) == (1, nz - 1,
                                                               nz - 1)
    regs = n in fo.REG_MR_AXES          # K8 at 1023: the register engine
    assert fs.launches["k8_regs"] - before["k8_regs"] == regs * (nz - 1)
    want = fa.fused_adjoint_chain_plain(a, g, v, ks, ks, **kw)
    _bwd_ok(got, want)


@pytest.mark.parametrize("n,keys", [(1024, ("a", "b", "k7")),
                                    (1023, ("k4", "k5", "k8"))])
def test_multislice_diff_backward_runs_the_kernels(dev, n, keys):
    """Gradients of an intensity loss through the kernels (forward chain
    and adjoint chain) against the plain path's. Four probes at ~1024^2
    take the two-pass chains forward (above the resident crossover)."""
    from pyslice_tpu_torch.ops import config

    psi = _wave(dev, 4, n, n, seed=8)
    gen = torch.Generator(device=dev).manual_seed(9)
    v0 = torch.randn((6, n, n), device=dev, generator=gen) * 30
    w = torch.rand((n, n), device=dev, generator=gen)
    ks = np.fft.fftfreq(n, 0.1)

    def grads():
        p = psi.clone().requires_grad_()
        v = v0.clone().requires_grad_()
        out = adj.multislice_diff(p, v, ks, ks, eV=100e3, dz=0.5)
        loss = torch.sum(w * torch.abs(torch.fft.fft2(out)) ** 2)
        return torch.autograd.grad(loss, [p, v])

    before = dict(fs.launches)
    got = grads()
    nz = 6
    assert tuple(fs.launches[k] - before[k] for k in keys) == (
        nz + 1, 2 * (nz - 1), nz - 1)
    assert fs.launches["k8_regs"] - before["k8_regs"] == (
        nz - 1 if "k8" in keys else 0)
    config.fused_multislice = "off"
    try:
        want = grads()
    finally:
        config.fused_multislice = "auto"
    for x, r in zip(got, want):
        torch.cuda.synchronize()
        rel, _ = _errors(x, r)
        assert rel <= 1e-3, rel


def test_kernels_refuse_lazily_conjugated_views(dev):
    psi = _wave(dev, 2, 128, 128)
    prop = _prop(dev, 128, 128)
    with pytest.raises(ValueError, match="lazily conjugated"):
        fs.col_pass(psi, torch.conj(prop))
    with pytest.raises(ValueError, match="lazily conjugated"):
        fa.row_pass_bwd("mid", psi, torch.conj(prop), SIGMA)


def test_adjoint_launch_error_raises(dev, monkeypatch):
    """A launch that the runtime refuses raises, in the wrapper and in the
    backward that runs it: nothing falls back to the plain path."""
    class FailingLib:
        @staticmethod
        def fs_row_pass_bwd(*args):
            return 700

    real = fs.build()
    fake = dataclasses.replace(
        real, libs=dict(real.libs, fused_step_adjoint=FailingLib()))
    monkeypatch.setattr(fa, "build", lambda: fake)
    psi = _wave(dev, 2, 128, 128)
    with pytest.raises(RuntimeError, match="launch failed"):
        fa.row_pass_bwd("last", psi, None, SIGMA)
    v = torch.zeros((3, 128, 128), device=dev, requires_grad=True)
    ks = np.fft.fftfreq(128, 0.1)
    out = adj.multislice_diff(_wave(dev, 4, 128, 128), v, ks, ks, eV=100e3,
                              dz=0.5)
    with pytest.raises(RuntimeError, match="launch failed"):
        out.abs().sum().backward()


def test_build_error_raises(dev, monkeypatch, tmp_path):
    import shutil
    csrc = tmp_path / "csrc"
    shutil.copytree(fs._CSRC, csrc)
    (csrc / "fused_step_adjoint.cu").write_text("this is not C++\n")
    monkeypatch.setattr(fs, "_CSRC", csrc)
    monkeypatch.setattr(fs, "_BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(fs, "SOURCES", ("fused_step_adjoint",))
    monkeypatch.setattr(fs, "_build", None)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        fs.build()


def test_build_log_is_read_back_when_cached(dev, monkeypatch, tmp_path):
    """The -Xptxas -v output of a build is kept beside its library, so a
    second process that finds the library built reads the same log."""
    monkeypatch.setattr(fs, "_BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(fs, "SOURCES", ("time_fft",))
    monkeypatch.setattr(fs, "_build", None)
    first = fs.build().log
    assert "Compiling entry function" in first and "spill" in first
    monkeypatch.setattr(fs, "_build", None)
    assert fs.build().log == first


# --- the TACAW time FFT (analysis.time_fft, csrc/time_fft.cu) --------------


def _tf_waves(dev, shape, seed=0):
    """Exit waves: a mean of order one under smaller fluctuations."""
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(shape, dtype=torch.complex64, device=dev,
                       generator=g) * 0.1 + (0.6 + 0.3j)


def _tf_ok(got, x):
    """The kernel's intensity against the float64 chain, a probe at a
    time (benchmark/reference/plain.py's check)."""
    from pyslice_tpu_torch.analysis.tacaw import _time_fft_block
    for p in range(x.shape[0]):
        _ok(got[p], _time_fft_block(x[p:p + 1].to(torch.complex128))[0])


def _tf_counted(fn):
    n0 = (fs.launches["time_fft"], fs.launches["time_fft_plain"])
    out = fn()
    torch.cuda.synchronize()
    return out, (fs.launches["time_fft"] - n0[0],
                 fs.launches["time_fft_plain"] - n0[1])


@pytest.mark.parametrize("shape", [(16, 100, 1023, 1023),
                                   (1, 100, 1023, 1023),
                                   (1, 400, 256, 1023)],
                         ids=lambda s: "x".join(map(str, s)))
def test_time_fft_at_the_main_paths_shapes(dev, shape):
    from pyslice_tpu_torch.analysis import time_fft as tf
    x = _tf_waves(dev, shape)
    got, n = _tf_counted(lambda: tf.time_fft(x))
    assert n == (1, 0)
    _tf_ok(got, x)


@pytest.mark.parametrize("n_t", [2, 3, 93, 99, 100, 400, 1000])
def test_time_fft_frame_counts_on_a_ragged_plane(dev, n_t):
    """Each instantiation (largest radix 8: 2, 3, 100, 1000; 16: 99, 400;
    31: 93 = 31 x 3) on a 37 x 41 plane, whose last tile is ragged; two
    launches give the same bits."""
    from pyslice_tpu_torch.analysis import time_fft as tf
    x = _tf_waves(dev, (2, n_t, 37, 41), seed=n_t)
    got, n = _tf_counted(lambda: tf.time_fft(x))
    assert n == (1, 0)
    _tf_ok(got, x)
    again, _ = _tf_counted(lambda: tf.time_fft(x))
    assert torch.equal(got, again)


def test_time_fft_on_a_layer_view_into_an_output_slice(dev):
    """A [..., layer] view of a 3-layer block (ky stride 3) into rows 1:3
    of a larger output; the rows around it untouched."""
    from pyslice_tpu_torch.analysis import time_fft as tf
    w = _tf_waves(dev, (2, 100, 37, 41, 3), seed=7)
    x = w[..., 1]
    assert x.stride() == (100 * 37 * 41 * 3, 37 * 41 * 3, 41 * 3, 3)
    out = torch.full((4, 100, 37, 41), float("nan"), device=dev)
    got, n = _tf_counted(lambda: tf.time_fft(x, out[1:3]))
    assert n == (1, 0) and got.data_ptr() == out[1].data_ptr()
    assert torch.isnan(out[0]).all() and torch.isnan(out[3]).all()
    _tf_ok(out[1:3], x.contiguous())


def test_tacaw_routes_cuda_blocks_by_frame_count(dev):
    """time_fft_intensity: one kernel launch for a block the rule takes
    (whatever the chunk size), the plain chain for 97 frames and for
    complex128, each counted."""
    from pyslice_tpu_torch.analysis import tacaw
    x = _tf_waves(dev, (3, 100, 37, 41))
    got, n = _tf_counted(lambda: tacaw.time_fft_intensity(
        x, chunk_elems=100 * 37 * 41))
    assert n == (1, 0)
    _tf_ok(got, x)
    y = _tf_waves(dev, (3, 97, 37, 41))
    got, n = _tf_counted(lambda: tacaw.time_fft_intensity(
        y, chunk_elems=97 * 37 * 41))
    assert n == (0, 3)
    _tf_ok(got, y)
    z = x.to(torch.complex128)
    got, n = _tf_counted(lambda: tacaw.time_fft_intensity(z))
    assert n == (0, 1) and got.dtype == torch.float64
