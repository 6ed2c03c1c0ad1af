"""The work arithmetic against values worked by hand for the cells'
shapes (14 slices: 27 two-dimensional transforms and 27 products a
probe)."""

import math

import pytest

import roofline


def test_fft2_count():
    # 2048^2 = 2^22 points: 5 * 2^22 * 22
    assert roofline.fft2_flops(2048, 2048) == 5 * 4194304 * 22


@pytest.mark.parametrize("probes,n,flops,nbytes", [
    # 64 x 2048^2 (config 5): 27 * (461,373,440 + 25,165,824) a probe;
    # 2 * 64 * 2^22 * 8 B of waves + 14 * 2^22 * 4 B of potential
    (64, 2048, 840_739_848_192, 4_529_848_320),
    # 16 x 1023^2: 27 * 1,046,529 * (5 * 2 * log2(1023) + 6) a probe
    (16, 1023, 47_916_283_293.4, 326_517_048),
    # one plane wave at 1023^2
    (1, 1023, 2_994_767_705.8, 75_350_088),
])
def test_slice_loop_work(probes, n, flops, nbytes):
    f, b = roofline.slice_loop_work(probes, n, n, 14)
    assert f == pytest.approx(flops, rel=1e-10)
    assert b == nbytes


@pytest.mark.parametrize("probes,n,ms", [
    (64, 2048, 12.548356), (16, 1023, 0.715168), (1, 1023, 0.044698)])
def test_least_time_is_bound_by_operations(probes, n, ms):
    t, by = roofline.least_seconds(*roofline.slice_loop_work(probes, n, n,
                                                             14))
    assert by == "operations"
    assert 1e3 * t == pytest.approx(ms, rel=1e-6)


def test_bytes_bound_when_little_work():
    t, by = roofline.least_seconds(1.0, 3.35e12)
    assert by == "bytes" and t == pytest.approx(1.0)
    assert math.isclose(roofline.least_seconds(67e12, 1.0)[0], 1.0)
