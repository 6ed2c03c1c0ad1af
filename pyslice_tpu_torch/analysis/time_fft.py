"""The TACAW time FFT as one CUDA kernel.

``time_fft(x, out)`` computes, for a (P, T, nx, ny) complex64 block of
exit waves on the card,

    out[p, (f + T//2) % T, kx, ky] = |sum_t (x[p, t, kx, ky]
        - mean_t x[p, :, kx, ky]) exp(-2 pi i f t / T)|^2

which is ``|fftshift_t(fft_t(x - mean_t x))|^2``, the intensity of
``analysis.tacaw``, in one pass over the waves (``ops/csrc/time_fft.cu``):
a block takes a tile of neighbouring k-points across all T frames into
shared memory, subtracts their time mean, runs the Stockham stages of the
mixed-radix engine (``ops/csrc/fft_mixed.cuh``, ``ops/csrc/
tile_async.cuh``) and stores the squared magnitude at the shifted
frequency row. It replaces no
Pallas kernel: the JAX package leaves this FFT to XLA.

The kernel is built with the slice kernels (``ops.fused_step.build``);
its wrapper sits here, beside its one
caller: the plain version is ``analysis.tacaw._time_fft_block``, and
``analysis.tacaw`` routes a block by its shape (``kernel_takes``): a CUDA
complex64 block whose T the engine takes in registers goes here, every
other block to the plain chain. This wrapper takes only CUDA tensors and
raises on anything else. ``launches["time_fft"]`` (``ops.fused_step``)
counts its launches and ``last_launch["time_fft"]`` holds the last one's
plan.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from ..ops.fused_step import (SMEM_BLOCK_RESERVED, SMEM_SM, _raise_on,
                              _twiddles, build, last_launch, launches)
from ..ops.fused_step_odd import MAX_AXIS, kernel_preferred_mr

# The kernel's block (csrc/time_fft.cu): 256 threads, tiles of at most
# 2^MAX_LOGC columns, and the shared memory a block may take so that two
# blocks share an SM.
THREADS = 256
MAX_LOGC = 5
BLOCK_SMEM = SMEM_SM // 2 - SMEM_BLOCK_RESERVED


def kernel_takes(n_t: int) -> bool:
    """Whether the kernel takes a time axis of n_t frames: 2 to MAX_AXIS
    (the engine's limit), every stage radix in registers
    (``fused_step_odd.kernel_preferred_mr``, the slice kernels' rule).
    100, 400, 99 and 1000 do; 97 and 1018 (primes 97 and 509 would run as
    direct sums) and 5000 do not."""
    return 2 <= n_t <= MAX_AXIS and kernel_preferred_mr(n_t)


@dataclasses.dataclass(frozen=True)
class TimeFftPlan:
    logc: int           # a tile is 2^logc neighbouring k-points
    smem_bytes: int     # twiddles, partial sums, means, the Stockham pair

    @property
    def cols(self) -> int:
        return 1 << self.logc


def smem(n_t: int, logc: int) -> int:
    """Shared memory of a block (``tf_smem`` of csrc/time_fft.cu): the
    n_t twiddles, a partial sum a thread, 2^logc column means and two
    tiles of n_t x 2^logc, complex64 each."""
    return 8 * (n_t + THREADS + (1 << logc) + 2 * (n_t << logc))


def plan(n_t: int) -> TimeFftPlan:
    """The widest tile, up to 2^MAX_LOGC columns, whose block fits
    BLOCK_SMEM (two blocks an SM); one column where none does. T = 100: 32
    columns, 54,304 bytes (four blocks fit); T = 400: 16 columns, 107,776
    bytes. Measured on an H100 (PERF.md): at T = 100, 32 columns four
    blocks an SM beat 64 columns two blocks by 2%; at T = 400, 16 columns
    two blocks beat 8 columns four blocks by 12% (a tile's stores are rows
    of 4 x 2^logc bytes, and short rows are slow)."""
    logc = MAX_LOGC
    while logc > 0 and smem(n_t, logc) > BLOCK_SMEM:
        logc -= 1
    return TimeFftPlan(logc=logc, smem_bytes=smem(n_t, logc))


def _check(x: torch.Tensor, out) -> None:
    """Shape and type first (so the CPU tests reach them), then the
    device."""
    if x.dtype != torch.complex64:
        raise TypeError(f"time_fft takes complex64 waves, got {x.dtype}")
    if x.dim() != 4:
        raise ValueError(f"time_fft takes (probes, time, kx, ky) waves, got "
                         f"shape {tuple(x.shape)}")
    p, n_t, nx, ny = x.shape
    if not kernel_takes(n_t):
        raise ValueError(f"time_fft does not take {n_t} frames "
                         "(kernel_takes)")
    if not 1 <= p <= 65535 or nx * ny >= 1 << 31:
        raise ValueError(f"time_fft: shape {tuple(x.shape)} out of range")
    if x.is_conj() or x.is_neg():
        raise ValueError("time_fft: resolve a lazily conjugated or negated "
                         "view first")
    if out is not None:
        if out.dtype != torch.float32:
            raise TypeError(f"out must be float32, got {out.dtype}")
        if tuple(out.shape) != tuple(x.shape):
            raise ValueError(f"out must have shape {tuple(x.shape)}, got "
                             f"{tuple(out.shape)}")
        if not out.is_contiguous():
            raise ValueError("out must be contiguous")
    if not x.is_cuda or (out is not None and out.device != x.device):
        raise ValueError("time_fft takes CUDA tensors on one card, got "
                         f"{x.device}"
                         + ("" if out is None else f" and {out.device}"))


def _launch(x: torch.Tensor, out: torch.Tensor, logc: int) -> tuple:
    """One launch at tile width 2^logc; returns the kernel's info (tiles a
    probe, blocks an SM, its largest radix, shared memory bytes)."""
    info = (ctypes.c_int * 4)()
    p, n_t, nx, ny = x.shape
    lib = build().libs["time_fft"]
    with torch.cuda.device(x.device):
        err = lib.tf_time_fft(
            out.data_ptr(), x.data_ptr(),
            _twiddles(n_t, x.device, full=True).data_ptr(), p, n_t, nx, ny,
            *x.stride(), logc, ctypes.addressof(info),
            torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "time_fft")
    return tuple(info)


def time_fft(x: torch.Tensor, out=None) -> torch.Tensor:
    """|fftshift_t(fft_t(x - mean_t x))|^2 along axis 1 of a CUDA
    (P, T, nx, ny) complex64 block of any strides, into ``out`` (a
    contiguous float32 tensor of the same shape, allocated if None)."""
    _check(x, out)
    if out is None:
        out = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    pl = plan(x.shape[1])
    info = _launch(x, out, pl.logc)
    rec = last_launch["time_fft"]
    rec.clear()
    rec.update(cols=pl.cols, smem_bytes=pl.smem_bytes)
    rec.update(zip(("tiles", "blocks_per_sm", "max_radix", "smem"), info))
    launches["time_fft"] += 1
    return out
