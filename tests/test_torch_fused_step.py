"""Port parity: the fused slice-step chain (kernels A, B, C) of
pyslice_tpu_torch.ops.fused_step against pyslice_tpu.ops.fused_step.

On the CPU the port's wrappers run their plain torch.fft versions; the JAX
kernels run in Pallas interpret mode, as tests/test_fused.py runs them.
The kernels themselves are checked against the plain versions on the card
by tests/test_torch_cuda_kernels.py and chip_smoke.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from pyslice_tpu.core.constants import interaction_parameter, wavelength
from pyslice_tpu.ops import fused_step as jfs
from pyslice_tpu_torch.ops import fused_step as tfs

torch.set_num_threads(2)

# bf16x3 stage-2 dots in the JAX kernels (tests/test_fused.py:17).
TOL = 1e-4 if jfs._dot_mode() == "bf16x3" else 5e-6
EV = 100e3
LAM = wavelength(EV)
SIGMA = interaction_parameter(EV)


def _inputs(P, NX, NY, NZ, seed=0):
    rng = np.random.default_rng(seed)
    psi = (rng.standard_normal((P, NX, NY))
           + 1j * rng.standard_normal((P, NX, NY))).astype(np.complex64)
    v = (rng.standard_normal((NZ, NX, NY)) * 50).astype(np.float32)
    kxs = np.fft.fftfreq(NX, 0.1).astype(np.float32)
    kys = np.fft.fftfreq(NY, 0.1).astype(np.float32)
    return psi, v, kxs, kys


def _jax(fn, psi, v, kxs, kys, **kw):
    from jax.experimental.pallas import tpu as pltpu
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(fn(jnp.asarray(psi), jnp.asarray(v), kxs, kys,
                             sigma=SIGMA, lam=LAM, dz=0.5, **kw))


def _port(fn, psi, v, kxs, kys, **kw):
    return fn(torch.from_numpy(psi), torch.from_numpy(v), kxs, kys,
              sigma=SIGMA, lam=LAM, dz=0.5, **kw).numpy()


def _rel(got, want):
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("shape", [(2, 256, 128, 4), (1, 256, 256, 1)])
def test_exit_wave_and_kspace_match_jax_kernels(shape):
    psi, v, kxs, kys = _inputs(*shape)
    for name in ("fused_multislice", "fused_multislice_kspace"):
        want = _jax(getattr(jfs, name), psi, v, kxs, kys)
        got = _port(getattr(tfs, name), psi, v, kxs, kys)
        assert got.shape == want.shape == shape[:3]
        assert _rel(got, want) < TOL, name


def test_record_layers_match_jax_kernels():
    psi, v, kxs, kys = _inputs(1, 128, 128, 4, seed=3)
    want = _jax(jfs.fused_multislice, psi, v, kxs, kys, record_layers=(1, 3))
    got = _port(tfs.fused_multislice, psi, v, kxs, kys, record_layers=(1, 3))
    assert got.shape == want.shape == (2, 1, 128, 128)
    assert _rel(got, want) < TOL


def test_band_limit_and_tilt_match_jax_kernels():
    psi, v, kxs, kys = _inputs(1, 128, 128, 3, seed=4)
    kw = dict(kmax2=(2.0 / 3.0 * 5.0) ** 2, tantilt=(0.004, -0.002))
    want = _jax(jfs.fused_multislice_kspace, psi, v, kxs, kys, **kw)
    got = _port(tfs.fused_multislice_kspace, psi, v, kxs, kys, **kw)
    assert _rel(got, want) < TOL


def test_kspace_is_fftshift_fft2_of_exit_wave():
    psi, v, kxs, kys = _inputs(2, 128, 256, 3, seed=5)
    exitw = _port(tfs.fused_multislice, psi, v, kxs, kys)
    got = _port(tfs.fused_multislice_kspace, psi, v, kxs, kys)
    want = np.fft.fftshift(np.fft.fft2(exitw.astype(np.complex128)),
                           axes=(-2, -1))
    assert _rel(got, want) < 1e-5


def test_cpu_wrappers_are_the_plain_chain():
    psi, v, kxs, kys = _inputs(2, 128, 128, 4, seed=6)
    before = dict(tfs.launches)
    for fused, plain in ((tfs.fused_multislice, tfs.fused_multislice_plain),
                         (tfs.fused_multislice_kspace,
                          tfs.fused_multislice_kspace_plain)):
        a = _port(fused, psi, v, kxs, kys)
        b = _port(plain, psi, v, kxs, kys)
        np.testing.assert_array_equal(a, b)
    assert tfs.launches == before     # no kernel launched on the CPU


@pytest.mark.parametrize("mode", ["first", "mid", "last", "only"])
@pytest.mark.parametrize("phase", [False, True])
def test_plain_row_pass_formula(mode, phase):
    psi, v, _, _ = _inputs(2, 128, 256, 1, seed=7)
    sv = v[0] * np.float32(SIGMA)
    t = np.cos(sv) + 1j * np.sin(sv)
    arg = torch.from_numpy(sv if phase else t.astype(np.complex64))
    got = tfs.row_pass(mode, torch.from_numpy(psi), arg).numpy()
    x = psi.astype(np.complex128)
    if mode in ("mid", "last"):
        x = np.fft.ifft(x, axis=-1)
    x = x * t
    if mode in ("first", "mid"):
        x = np.fft.fft(x, axis=-1)
    assert _rel(got, x) < 1e-5


def test_plain_col_pass_and_kconvert_formulas():
    psi, v, kxs, kys = _inputs(2, 256, 128, 1, seed=8)
    prop = tfs.fresnel_plane(kxs, kys, LAM, 0.5, device="cpu")
    got = tfs.col_pass(torch.from_numpy(psi), prop).numpy()
    want = np.fft.ifft(prop.numpy() * np.fft.fft(psi, axis=-2), axis=-2)
    assert _rel(got, want) < 1e-5
    got = tfs.kconvert(torch.from_numpy(psi)).numpy()
    want = np.fft.fftshift(np.fft.fft(psi, axis=-2), axes=(-2, -1))
    assert _rel(got, want) < 1e-5
    buf = torch.from_numpy(psi.copy())
    assert tfs.col_pass(buf, prop, buf) is buf      # the in-place form


def test_fresnel_plane_is_unpermuted_jax_plane():
    kxs = np.fft.fftfreq(256, 0.1)
    kys = np.fft.fftfreq(128, 0.1)
    kw = dict(kmax2=20.0, tantilt=(0.003, 0.001))
    pr, pi = jfs.fresnel_permuted_t(256, 128, kxs, kys, LAM, 0.5, **kw)
    jplane = (np.asarray(pr) + 1j * np.asarray(pi)).T     # (kx~, ky~)
    ix = np.argsort(jfs.digit_perm(256))
    iy = np.argsort(jfs.digit_perm(128))
    want = jplane[ix][:, iy]
    got = tfs.fresnel_plane(kxs, kys, LAM, 0.5, device="cpu", **kw).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
    ksq = kxs[:, None] ** 2 + kys[None, :] ** 2
    got_ksq = tfs.fresnel_plane(None, None, LAM, 0.5, ksq=ksq,
                                device="cpu").numpy()
    plain = tfs.fresnel_plane(kxs, kys, LAM, 0.5, device="cpu").numpy()
    np.testing.assert_allclose(got_ksq, plain, atol=1e-5)


def test_phase_plane_mode_matches_precomputed(monkeypatch):
    psi, v, kxs, kys = _inputs(2, 128, 128, 4, seed=9)
    want = _port(tfs.fused_multislice, psi, v, kxs, kys)
    monkeypatch.setattr(tfs, "PRECOMPUTE_T_MAX_BYTES", 1)
    assert not tfs.transmission_stack(SIGMA, torch.from_numpy(v)).is_complex()
    got = _port(tfs.fused_multislice, psi, v, kxs, kys)
    assert _rel(got, want) < 1e-5


def test_supported_sizes():
    for n in (128, 256, 512, 1024, 2048, 4096):
        assert tfs.supported_size(n)
    for n in (64, 384, 1023, 1024 + 128, 8192):
        assert not tfs.supported_size(n)


def test_unsupported_grid_and_device_raise():
    psi = torch.zeros((1, 384, 128), dtype=torch.complex64)
    v = torch.zeros((2, 384, 128))
    with pytest.raises(ValueError, match="unsupported grid"):
        tfs.fused_multislice(psi, v, np.zeros(384), np.zeros(128),
                             sigma=1e-3, lam=0.037, dz=0.5)
    # Neither CPU nor CUDA: the wrappers raise instead of falling back.
    meta = torch.empty((1, 128, 128), dtype=torch.complex64, device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        tfs.row_pass("first", meta, torch.empty((128, 128), device="meta"))
    with pytest.raises(ValueError, match="mode"):
        tfs.row_pass("middle", psi[:, :128], v[0, :128])


POW2_AXES = [128, 256, 512, 1024, 2048, 4096]


@pytest.mark.parametrize("n", POW2_AXES)
@pytest.mark.parametrize("other", [128, 1024, 4096])
@pytest.mark.parametrize("kernel", ["b", "a", "a phase", "a only"])
def test_reg_tile_plan(n, other, kernel):
    """A's and B's plan at every pow2 axis (A: ny, B: nx) against every
    other, under each kernel's launch bound: lanes that divide the other
    axis, n / 32 threads a lane within the bound, the blocks the bound
    promises in an SM's shared memory (A `only` takes none), B's tiles at
    least four columns wide where the other axis has them (a warp's row
    segments fill 32-byte sectors), and the stages of reg_geo
    (csrc/fft_regs.cuh)."""
    bound = {"b": tfs.COL_BOUND, "a only": tfs.ONLY_BOUND}.get(
        kernel, tfs.ROW_BOUND)
    factors, transform = kernel == "a phase", kernel != "a only"
    plan = tfs.reg_tile_plan(n, 16, other, bound, factors, transform)
    assert other % plan.lanes == 0 and 1 <= plan.lanes <= 32
    assert plan.threads == (n // tfs.REG_VALUES) * plan.lanes
    assert plan.threads % 32 == 0 and plan.threads <= bound[0]
    assert plan.smem_bytes == (tfs.reg_smem(n, plan.logc, factors)
                               if transform else 0)
    assert (bound[1] * (plan.smem_bytes + tfs.SMEM_BLOCK_RESERVED)
            <= tfs.SMEM_SM)
    assert plan.tiles == 16 * other // plan.lanes
    assert plan.lanes >= 4 or kernel != "b"
    assert int(np.prod(plan.stages)) == n and plan.stages[0] == 32
    assert all(32 % r == 0 for r in plan.stages)


@pytest.mark.parametrize("n", POW2_AXES)
@pytest.mark.parametrize("rows", [128, 1024, 4096])
@pytest.mark.parametrize("mode", ["mid", "last"])
def test_pair_reg_plan(n, rows, mode):
    """K7's plan at every pow2 row length against every row count: 2^logr
    rows a block that divide the rows, both members of each on n / 32
    threads (whole warps, within PAIR_BOUND's threads), the blocks an SM
    that the bound promises within an SM's shared memory, a tile buffer for
    every member-row plus (mid) a complex64 factor an element of its rows,
    16 float32 vbar slots a thread, one tile a row group, at least as many
    tiles as an H100 has SMs where a block can lose rows, and the stages of
    reg_geo."""
    plan = tfs.pair_reg_plan(n, rows, factors=mode == "mid")
    r = plan.lanes // 2
    assert plan.lanes == 2 * r and rows % r == 0
    assert plan.threads == (n // tfs.REG_VALUES) * 2 * r
    assert plan.threads % 32 == 0 and plan.threads <= tfs.PAIR_BOUND[0]
    blocks = tfs.PAIR_BOUND[0] * tfs.PAIR_BOUND[1] // plan.threads
    assert blocks >= tfs.PAIR_BOUND[1]
    assert plan.smem_bytes == (tfs.reg_smem(n, plan.logc)
                               + (8 * n * r if mode == "mid" else 0)
                               + 4 * 16 * plan.threads)
    assert blocks * (plan.smem_bytes + tfs.SMEM_BLOCK_RESERVED) <= tfs.SMEM_SM
    assert plan.smem_bytes <= 227 * 1024
    assert plan.tiles == rows // r
    assert plan.tiles >= 132 or r == 1 or plan.threads == 32
    assert int(np.prod(plan.stages)) == n and plan.stages[0] == 32


def test_pair_reg_plan_at_1024():
    """The main path's K7 tile at 1024^2: 2 rows x 2 members, 128 threads,
    512 row tiles; 33,792 bytes of tile buffer, 16,384 of factors and 8,192
    of vbar slots, three blocks an SM; one row of 256 threads at 4096, 16
    rows at 128 (4 rows of 32 threads at 128^2, so that its 32 tiles
    spread over 32 SMs)."""
    plan = tfs.pair_reg_plan(1024, 1024)
    assert (plan.lanes, plan.threads, plan.smem_bytes, plan.tiles,
            plan.stages) == (4, 128, 33792 + 16384 + 8192, 512, (32, 32))
    assert tfs.pair_reg_plan(1024, 1024, factors=False).smem_bytes == (
        33792 + 8192)
    wide = tfs.pair_reg_plan(4096, 4096)
    assert (wide.lanes, wide.threads, wide.tiles) == (2, 256, 4096)
    narrow = tfs.pair_reg_plan(128, 4096)
    assert (narrow.lanes, narrow.threads, narrow.tiles) == (32, 128, 256)
    small = tfs.pair_reg_plan(128, 128)
    assert (small.lanes, small.threads, small.tiles) == (8, 32, 32)
    assert tfs.pair_reg_plan(128, 128, sms=8).tiles == 8


def test_reg_tile_plan_at_1024():
    """The main path's plans at 16 x 1024^2: B 16 lanes of 32 threads, a
    135,168-byte tile buffer, one block an SM; A 4 lanes, 33,792 bytes
    (66,560 with the phase's factor slots), three blocks; A `only` 8 lanes
    and no shared memory."""
    b = tfs.reg_tile_plan(1024, 16, 1024)
    assert (b.lanes, b.threads, b.smem_bytes, b.tiles,
            b.stages) == (16, 512, 135168, 1024, (32, 32))
    a = tfs.reg_tile_plan(1024, 16, 1024, tfs.ROW_BOUND)
    assert (a.lanes, a.threads, a.smem_bytes, a.tiles) == (
        4, 128, 33792, 4096)
    phase = tfs.reg_tile_plan(1024, 16, 1024, tfs.ROW_BOUND, factors=True)
    assert phase.smem_bytes == 66560
    only = tfs.reg_tile_plan(1024, 16, 1024, tfs.ONLY_BOUND, transform=False)
    assert (only.lanes, only.threads, only.smem_bytes) == (8, 256, 0)
    assert tfs.reg_stages(4096) == (32, 32, 4)
    assert tfs.reg_stages(128) == (32, 4)
