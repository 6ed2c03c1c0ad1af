"""K6's launch plan (ops.fused_step_resident.resident_plan), the pure-Python
mirror of the plan that csrc/resident.cu launches, on the CPU: every row
and every column of a phase in exactly one tile, a block that fits both
phases, a grid the card holds at once and shared memory within a block's
227 KB. On the card, tests/test_torch_cuda_kernels.py holds each launch to
this plan."""

import numpy as np
import pytest

from pyslice_tpu_torch.ops import fused_step_resident as fr
from pyslice_tpu_torch.ops.fused_step import REG_VALUES, supported_size

from test_torch_cuda_kernels import MR_SIZES, POW2_SIZES

SMS = 132                 # an H100 SXM
SMEM_BLOCK_MAX = 232448   # 227 KB, the most a block may opt in to


def _each_line_once(n_probes, lines, lanes, tiles):
    """Every line (row or column) of every probe lies in exactly one tile
    u = p * tpp + k, lines k * lanes .. of probe p."""
    tpp = tiles // n_probes
    assert tiles == n_probes * tpp
    seen = np.zeros((n_probes, lines), dtype=int)
    for u in range(tiles):
        p, k = divmod(u, tpp)
        seen[p, k * lanes:(k + 1) * lanes] += 1
    assert (seen == 1).all()


def _grids(n):
    """Square n x n, and n beside another axis of its engine."""
    other = (256 if n != 256 else 128) if supported_size(n) else (
        258 if n != 258 else 387)
    return [(n, n), (other, n), (n, other)]


@pytest.mark.parametrize("n", POW2_SIZES + MR_SIZES)
@pytest.mark.parametrize("P", [1, 2, 4, 16])
@pytest.mark.parametrize("phase", [False, True])
def test_resident_plan_tiles_each_line_once(n, P, phase):
    for nx, ny in _grids(n):
        for per_sm in (1, 3):
            plan = fr.resident_plan(P, nx, ny, SMS, per_sm, phase=phase)
            _each_line_once(P, nx, plan.row_lanes, plan.row_tiles)
            _each_line_once(P, ny, plan.col_lanes, plan.col_tiles)
            assert 1 <= plan.grid <= per_sm * SMS
            assert plan.grid <= max(plan.row_tiles, plan.col_tiles)
            assert 0 < plan.smem_bytes <= SMEM_BLOCK_MAX
            assert plan.threads % 32 == 0


@pytest.mark.parametrize("n", POW2_SIZES)
@pytest.mark.parametrize("P", [1, 2, 4, 16])
def test_resident_plan_register_engine_block(n, P):
    """One block for both phases: 2^logc lanes of n / 32 threads on each
    axis, 32 to 128 threads, narrowed only while a phase has fewer tiles
    than a quarter of the SMs."""
    for nx, ny in _grids(n):
        plan = fr.resident_plan(P, nx, ny, SMS)
        assert plan.engine == "pow2" and plan.producers == 0
        assert plan.threads == ny // REG_VALUES * plan.row_lanes
        assert plan.threads == nx // REG_VALUES * plan.col_lanes
        assert fr.RES_MIN_THREADS <= plan.threads <= fr.RES_MAX_THREADS
        assert 1 <= plan.row_lanes <= min(32, nx)
        assert 1 <= plan.col_lanes <= min(32, ny)
        least = max(fr.RES_MIN_THREADS, nx // REG_VALUES, ny // REG_VALUES)
        fewest = min(plan.row_tiles, plan.col_tiles)
        if plan.threads < fr.RES_MAX_THREADS:
            # the block twice as wide would leave a phase too few tiles
            assert 4 * (fewest // 2) < SMS
        if plan.threads > least:
            assert 4 * fewest >= SMS


@pytest.mark.parametrize("n", MR_SIZES)
@pytest.mark.parametrize("P", [1, 2, 4, 16])
def test_resident_plan_mixed_radix_tiles(n, P):
    """K4's and K5's block and tiles: as wide as shared memory allows, up
    to 8 lanes, narrowed only while the narrower tiling still gives each
    tile a block of its own."""
    for nx, ny in _grids(n):
        plan = fr.resident_plan(P, nx, ny, SMS)
        assert plan.engine == "mixed"
        assert (plan.threads, plan.producers) == (384, 96)
        for lanes, n_t, lines, tiles in (
                (plan.row_lanes, ny, nx, plan.row_tiles),
                (plan.col_lanes, nx, ny, plan.col_tiles)):
            widest = 8
            while widest > 1 and (8 * 3 * (n_t * widest) + 8 * (nx + ny)
                                  > SMEM_BLOCK_MAX):
                widest //= 2
            assert lanes in (1, 2, 4, 8) and lanes <= widest
            if lanes < widest:
                assert tiles <= SMS
            if lanes > 1:
                # the tiling half as wide would leave a block two tiles
                assert lanes == widest or P * -(-lines // (lanes // 2)) > SMS
        assert plan.smem_bytes == (8 * 3 * max(ny * plan.row_lanes,
                                               nx * plan.col_lanes)
                                   + 8 * (nx + ny))


@pytest.mark.parametrize("P,n,per_sm,want", [
    (1, 1024, 3, dict(engine="pow2", threads=128, row_lanes=4, col_lanes=4,
                      row_tiles=256, col_tiles=256, smem_bytes=33792,
                      grid=256)),
    (1, 1023, 1, dict(engine="mixed", threads=384, row_lanes=8, col_lanes=8,
                      row_tiles=128, col_tiles=128, smem_bytes=212784,
                      grid=128)),
    (1, 387, 1, dict(engine="mixed", threads=384, row_lanes=4, col_lanes=4,
                     row_tiles=97, col_tiles=97, smem_bytes=43344, grid=97)),
    (2, 1023, 1, dict(engine="mixed", threads=384, row_lanes=8, col_lanes=8,
                      row_tiles=256, col_tiles=256, smem_bytes=212784,
                      grid=132)),
    (1, 512, 3, dict(engine="pow2", threads=128, row_lanes=8, col_lanes=8,
                     row_tiles=64, col_tiles=64, smem_bytes=33792, grid=64)),
    (1, 256, 12, dict(engine="pow2", threads=32, row_lanes=4, col_lanes=4,
                      row_tiles=64, col_tiles=64, smem_bytes=8448,
                      grid=64)),
    (16, 512, 3, dict(engine="pow2", threads=128, row_lanes=8, col_lanes=8,
                      row_tiles=1024, col_tiles=1024, smem_bytes=33792,
                      grid=396)),
])
def test_resident_plan_main_path_shapes(P, n, per_sm, want):
    """The quick start's grids (1023^2, 1024^2 with fast_grid) and others
    that the dispatch sends to K6, with the blocks an SM the card gives
    each."""
    plan = fr.resident_plan(P, n, n, SMS, per_sm)
    for key, value in want.items():
        assert getattr(plan, key) == value, key
    # the phase form adds 32 factor slots a thread to the register engine
    extra = 8 * REG_VALUES * plan.threads if plan.engine == "pow2" else 0
    assert fr.resident_plan(P, n, n, SMS, per_sm,
                            phase=True).smem_bytes == plan.smem_bytes + extra
