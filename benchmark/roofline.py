"""Work arithmetic and the card's peaks.

Peaks of one NVIDIA H100 SXM (data sheet, at its 700 W power limit):
3.35 TB/s of HBM3 and 67 TFLOP/s of float32 outside the tensor cores.
The card's own power limit is printed beside every result that uses them.

The slice loop's least time is defined on the work, not on the kernels
that do it, so it reads the same whatever implements the loop: for each of
P probes, 2 nz - 1 two-dimensional transforms of 5 N log2 N operations
(N = nx ny; nz - 1 steps of a transform each way and the final transform
to k space) and 2 nz - 1 complex products of N points at 6 operations
each; the P probes and the float32 potential read once and the P k-space
exit waves written once.
"""

from __future__ import annotations

import math

HBM_BYTES_S = 3.35e12
FP32_FLOP_S = 67e12
POWER_W = 700
C64, F32 = 8, 4


def fft2_flops(nx: int, ny: int) -> float:
    """The conventional count of a complex 2-D FFT: 5 N log2 N."""
    n = nx * ny
    return 5.0 * n * math.log2(n)


def slice_loop_work(probes: int, nx: int, ny: int, nz: int):
    """(operations, bytes) of one frame's slice loop for ``probes``."""
    n = nx * ny
    steps = 2 * nz - 1
    flops = probes * steps * (fft2_flops(nx, ny) + 6.0 * n)
    nbytes = 2 * probes * n * C64 + nz * n * F32
    return flops, nbytes


def least_seconds(flops: float, nbytes: float):
    """(seconds, "operations" or "bytes"): the larger of the two bounds."""
    t_ops, t_bytes = flops / FP32_FLOP_S, nbytes / HBM_BYTES_S
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
