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


SHAPES = [(2, 128, 128), (3, 256, 512), (16, 1024, 1024), (1, 2048, 2048),
          (2, 4096, 128), (1, 128, 4096)]


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
# 255 * 4 + 3 rows) and at 4 (1152: 511 * 2 + 1); 2 lanes at 2304, and at
# 3968 with the twiddle table in device memory (fused_step_odd
# pair_tile_plan). P = 3: a pair count that is no power of two.
K8_NY = [1023, 1152, 2304, 3968]


@pytest.mark.parametrize("ny", K8_NY)
@pytest.mark.parametrize("P", [1, 3, 16])
@pytest.mark.parametrize("mode,phase", [("mid", False), ("mid", True),
                                        ("last", False)])
def test_row_pass_mr_bwd_1023_rows_matches_plain(dev, ny, P, mode, phase):
    _check_bwd(dev, fa.row_pass_mr_bwd, "k8", P, 1023, ny, mode, phase)
    plan = fo.last_launch["k8"]
    assert plan["lanes"] == {1023: 8, 1152: 4}.get(ny, 2)
    assert plan["table"] == ("device" if ny == 3968 else "shared")


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
