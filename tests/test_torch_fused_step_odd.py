"""Port parity: the mixed-radix chain (kernels K4 and K5) of
pyslice_tpu_torch.ops.fused_step_odd against pyslice_tpu's multislice on
odd and n1*128 grids.

On the CPU the port's wrappers run their plain torch.fft versions; the
JAX side is its plain XLA loop (multislice(fused=False)), whose Pallas odd
kernels tests/test_fused.py checks in interpret mode. The CUDA kernels are
held to the plain versions on the card by tests/test_torch_cuda_kernels.py
and chip_smoke.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from pyslice_tpu.core.constants import interaction_parameter, wavelength
from pyslice_tpu.core.dtypes import DOUBLE as JDOUBLE, SINGLE as JSINGLE
from pyslice_tpu.ops import fused_step_odd as jodd
from pyslice_tpu.ops import matfft as jmatfft
from pyslice_tpu.physics import propagate as jprop
from pyslice_tpu_torch.ops import fused_step as tfs
from pyslice_tpu_torch.ops import fused_step_odd as todd

from oracle import residual

torch.set_num_threads(2)

EV = 100e3
LAM = wavelength(EV)
SIGMA = interaction_parameter(EV)
DZ = 0.5


def _inputs(P, NX, NY, NZ, seed=0):
    rng = np.random.default_rng(seed)
    psi = (rng.standard_normal((P, NX, NY))
           + 1j * rng.standard_normal((P, NX, NY)))
    v = rng.standard_normal((NZ, NX, NY)) * 50
    kxs = np.fft.fftfreq(NX, 0.1)
    kys = np.fft.fftfreq(NY, 0.1)
    return psi, v, kxs, kys


def _jax(psi, v, kxs, kys, precision, **kw):
    return np.asarray(jprop.multislice(
        jnp.asarray(psi), jnp.asarray(v), kxs, kys, eV=EV, dz=DZ,
        precision=precision, fused=False, **kw))


def _port64(fn, psi, v, kxs, kys, **kw):
    """A port entry point in complex64 on the CPU (its kernels' precision)."""
    return fn(torch.from_numpy(psi.astype(np.complex64)),
              torch.from_numpy(v.astype(np.float32)), kxs, kys,
              sigma=SIGMA, lam=LAM, dz=DZ, **kw).numpy()


def planes64(v, kxs, kys, kmax2=None, tantilt=None):
    """complex128 transmission stack and natural-order Fresnel plane."""
    t = np.exp(1j * SIGMA * v)
    kx, ky = kxs[:, None], kys[None, :]
    k2 = kx ** 2 + ky ** 2
    pp = (-np.pi * LAM * DZ) * k2
    if tantilt is not None:
        pp = pp + (2.0 * np.pi * DZ) * (kx * tantilt[0] + ky * tantilt[1])
    prop = np.exp(1j * pp)
    if kmax2 is not None:
        prop = prop * (k2 <= kmax2)
    return torch.from_numpy(t), torch.from_numpy(prop)


CASES = {
    "exit": {},
    "band_limit": dict(kmax2=(2.0 / 3.0 * 4.0) ** 2),
    "tilt": dict(tantilt=(0.004, -0.002)),
    "record": dict(record_layers=(0, 2)),
}


@pytest.mark.parametrize("shape", [(1, 387, 393, 3), (4, 258, 387, 2),
                                   (2, 384, 387, 4)])
@pytest.mark.parametrize("case", list(CASES))
def test_chain_complex64_matches_jax(shape, case):
    kw = dict(CASES[case])
    if case == "record":
        kw["record_layers"] = (0, shape[3] - 1)
    psi, v, kxs, kys = _inputs(*shape)
    want = _jax(psi, v, kxs, kys, JSINGLE, **kw)
    got = _port64(todd.fused_multislice_odd, psi, v, kxs, kys, **kw)
    assert got.shape == want.shape and got.dtype == np.complex64
    assert residual(got, want) <= 1e-6


@pytest.mark.parametrize("kw", [{}, dict(kmax2=9.0, tantilt=(0.003, 0.001))])
def test_plain_passes_complex128_match_jax(kw):
    """The K4/K5 plain versions, chained by hand in complex128."""
    psi, v, kxs, kys = _inputs(2, 258, 387, 3, seed=1)
    t, prop = planes64(v, kxs, kys, **kw)
    state = todd.row_pass_mr("first", torch.from_numpy(psi), t[0])
    state = todd.row_pass_mr("mid", todd.col_pass_mr(state, prop), t[1])
    state = todd.row_pass_mr("last", todd.col_pass_mr(state, prop), t[2])
    want = _jax(psi, v, kxs, kys, JDOUBLE, **kw)
    assert residual(state.numpy(), want) <= 1e-10


def test_one_slice_is_transmission_only():
    psi, v, kxs, kys = _inputs(2, 387, 393, 1, seed=2)
    got = _port64(todd.fused_multislice_odd, psi, v, kxs, kys)
    want = psi * np.exp(1j * np.float32(SIGMA) * v[0].astype(np.float32))
    assert residual(got, want) <= 1e-12


def test_cpu_wrappers_are_the_plain_chain():
    psi, v, kxs, kys = _inputs(2, 258, 387, 3, seed=3)
    before = dict(tfs.launches)
    a = _port64(todd.fused_multislice_odd, psi, v, kxs, kys)
    b = _port64(todd.fused_multislice_odd_plain, psi, v, kxs, kys)
    np.testing.assert_array_equal(a, b)
    assert tfs.launches == before         # no kernel launched on the CPU


@pytest.mark.parametrize("n", [129, 255, 258, 384, 385, 387, 393, 640, 1009,
                               1018, 1023, 1024, 1152, 2046, 3069, 4095])
@pytest.mark.parametrize("n_probes", [None, 1, 2, 16])
def test_size_rules_equal_jax(n, n_probes):
    assert todd.scrambled_factors(n, n_probes) == \
        jmatfft.scrambled_factors(n, n_probes)
    assert todd.supported_size_odd(n, n_probes) == \
        jodd.supported_size_odd(n, n_probes)


def test_mixed_radix_sizes():
    for n in (384, 387, 393, 1018, 1023, 1152, 3840):
        assert todd.supported_size_mr(n) and todd.supported_size_mr(n, 16)
    for n in (385, 1009, 127, 5120):     # XLA's in the JAX package, > 4096
        assert not todd.supported_size_mr(n)
    assert todd.supported_size_mr(1023, 16)       # d = 11, m = 93


def test_unsupported_grid_and_mode_raise():
    psi = torch.zeros((1, 1009, 384), dtype=torch.complex64)
    v = torch.zeros((2, 1009, 384))
    with pytest.raises(ValueError, match="unsupported grid"):
        todd.fused_multislice_odd(psi, v, np.zeros(1009), np.zeros(384),
                                  sigma=1e-3, lam=0.037, dz=0.5)
    with pytest.raises(ValueError, match="mode"):
        todd.row_pass_mr("middle", psi, v[0])
    meta = torch.empty((1, 387, 387), dtype=torch.complex64, device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        todd.col_pass_mr(meta, torch.empty((387, 387), device="meta"))


# the CUDA tests' MR_SIZES: 4, 2 and 2 lanes a tile from 1280, 2304, 3968;
# 4096, the largest axis, takes 229,376 of the 232,448 bytes
PLAN_SIZES = [258, 384, 387, 1018, 1023, 1152, 1280, 2304, 3968, 4096]


def _check_plan(plan, n, lanes_total, n_probes):
    """A tile plan fits a block's shared memory and the kernels' thread
    cap in whole warps, is the widest tile that fits (up to 8 lanes), and
    its tiles cover every (probe, lane) exactly once (the kernels' walk:
    tile u is lanes (u % tpp) * lanes .. of probe u // tpp)."""
    assert plan.smem_bytes == 8 * (3 * n * plan.lanes + n) <= todd.SMEM_MAX
    wider = 8 * (3 * n * 2 * plan.lanes + n)
    assert plan.lanes == 8 or wider > todd.SMEM_MAX
    assert plan.lanes == {True: 8, False: 4 if n <= 2235 else 2}[n <= 1162]
    assert plan.threads % 32 == 0
    assert 32 <= plan.threads == todd.TILE_THREADS <= 384 - 96
    tpp = -(-lanes_total // plan.lanes)
    assert plan.tiles == n_probes * tpp
    seen = np.zeros((n_probes, lanes_total), int)
    for u in range(plan.tiles):
        x0 = (u % tpp) * plan.lanes
        seen[u // tpp, x0:min(x0 + plan.lanes, lanes_total)] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("n", PLAN_SIZES)
@pytest.mark.parametrize("n_probes", [1, 16, 32])
def test_col_tile_plan(n, n_probes):
    """K5's plan (``tile_plan``) on an axis of n (nx) for n or 393
    columns; >= 90% of the threads busy in the radix-31 stage at 1023."""
    f = todd.stage_radices(n)
    assert int(np.prod(f)) == n
    for ny in (n, 393):
        plan = todd.tile_plan(n, n_probes, ny)
        _check_plan(plan, n, ny, n_probes)
        if n == 1023:
            assert (plan.lanes, plan.threads) == (8, 288)
            assert plan.busy >= 0.9


@pytest.mark.parametrize("n", PLAN_SIZES)
@pytest.mark.parametrize("n_probes", [1, 16, 32])
def test_row_tile_plan(n, n_probes):
    """K4's plan (``tile_plan``) on an axis of n (ny) for n or 387 rows (a
    ragged last tile: 387 = 48 * 8 + 3)."""
    for nx in (n, 387):
        _check_plan(todd.tile_plan(n, n_probes, nx), n, nx, n_probes)


# (n, its largest stage radix): the kernels' registers take up to 31
PREFERRED = [(1023, 31), (1054, 31), (3968, 31), (1024, 16), (1152, 16),
             (384, 16), (513, 19), (520, 13), (999, 37), (1032, 43),
             (387, 43), (258, 43), (1005, 67), (1016, 127), (393, 131),
             (1006, 503), (1018, 509)]


@pytest.mark.parametrize("n,radix", PREFERRED)
def test_kernel_preferred_mr(n, radix):
    assert todd.supported_size_mr(n) and todd.supported_size_mr(n, 16)
    assert max(todd.stage_radices(n)) == radix
    assert todd.kernel_preferred_mr(n) == (radix <= todd.KERNEL_MAX_RADIX)
    assert todd.KERNEL_MAX_RADIX == 31


# --- K8's pair tile plan (the adjoint's backward row pass) --------------------


def _walk(n_units, per, grid):
    """The items of each block of the persistent walk of
    csrc/tile_async.cuh ``persistent_tiles``: units b + k grid, each
    unit's ``per`` items v = u per + s in order."""
    blocks = []
    for b in range(grid):
        n_items = per * ((n_units - 1 - b) // grid + 1)
        blocks.append([(b + (j // per) * grid) * per + j % per
                       for j in range(n_items)])
    return blocks


def _check_pair_plan(plan, n, nx, n_pairs=3):
    """K8's plan: an even lane count (a row's two pair members), the
    widest up to 8 lanes whose buffers, table and vbar rows fit, the table
    in device memory only where not even 2 lanes fit beside it, and a walk
    that takes every (pair, row) exactly once, each row tile through its
    pairs in order."""
    assert plan.lanes in (2, 4, 8)
    table = n if plan.shared_table else 0
    assert plan.smem_bytes == (8 * (3 * n * plan.lanes + table)
                               + 4 * n * plan.lanes // 2) <= todd.SMEM_MAX
    assert plan.shared_table == (n <= 3874)
    wider = 8 * (3 * n * 2 * plan.lanes + n) + 4 * n * plan.lanes
    assert plan.lanes == 8 or wider > todd.SMEM_MAX
    assert plan.lanes == (8 if n <= 1076 else 4 if n <= 2075 else 2)
    assert plan.threads == todd.TILE_THREADS
    rows = plan.lanes // 2
    assert plan.tiles == -(-nx // rows)
    for grid in sorted({1, min(7, plan.tiles), plan.tiles}):
        seen = np.zeros((n_pairs, nx), int)
        for items in _walk(plan.tiles, n_pairs, grid):
            for j, v in enumerate(items):
                assert v % n_pairs == j % n_pairs       # pairs in order
                x0 = (v // n_pairs) * rows
                seen[v % n_pairs, x0:min(x0 + rows, nx)] += 1
        assert (seen == 1).all()


@pytest.mark.parametrize("n", PLAN_SIZES)
def test_pair_tile_plan(n):
    """K8's plan (``pair_tile_plan``) on rows of n for n and 1023 rows (a
    ragged last row tile: 1023 = 255 * 4 + 3 = 511 * 2 + 1): 8 lanes (4
    rows) and 220,968 bytes at 1023, the table in device memory at 3968
    and 4096."""
    for nx in (n, 1023):
        plan = todd.pair_tile_plan(n, nx)
        _check_pair_plan(plan, n, nx)
        if n == 1023:
            assert (plan.lanes, plan.smem_bytes, plan.tiles) == (8, 220968,
                                                                  256)
            assert plan.busy >= 0.9
        assert plan.shared_table == (n < 3968)


def test_pair_tile_plan_every_kernel_size():
    """Every axis up to 4096 that dispatch gives K8 (``supported_size_mr``
    and ``kernel_preferred_mr``) has a plan that fits."""
    sizes = [n for n in range(2, 4097)
             if todd.supported_size_mr(n, 16) and todd.kernel_preferred_mr(n)]
    assert 1023 in sizes and 3968 in sizes and 4096 in sizes
    for n in sizes:
        plan = todd.pair_tile_plan(n, 387)
        assert plan.lanes % 2 == 0 and plan.smem_bytes <= todd.SMEM_MAX
        assert plan.shared_table == (n <= 3874)


@pytest.mark.parametrize("n_units,per,grid", [(256, 16, 132), (7, 3, 3),
                                              (2048, 1, 132), (5, 1, 5)])
def test_persistent_walk_covers_every_item_once(n_units, per, grid):
    """The shared walk: each item of every unit once; with per = 1 (K4,
    K5) block b takes b, b + grid, ... as before."""
    blocks = _walk(n_units, per, grid)
    assert sorted(v for items in blocks for v in items) == list(
        range(n_units * per))
    if per == 1:
        assert blocks == [list(range(b, n_units, grid)) for b in range(grid)]
