"""The TACAW time FFT's routing, chunk loop and kernel wrapper on the CPU
(analysis/tacaw.py, analysis/time_fft.py): the plain version gives today's
chain bit for bit and the kernel's formula; the rule by frame count; the
chunk loop's one output, each chunk handed its rows; the wrapper's
refusals; the plan; the C entry's argument types. The kernel itself runs
only on the card (tests/test_torch_cuda_kernels.py). Port-only: no JAX."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from pyslice_tpu_torch.analysis import tacaw
from pyslice_tpu_torch.ops import fused_step as fs
from pyslice_tpu_torch.analysis import time_fft as tf

CU = fs._CSRC / "time_fft.cu"


def _waves(shape, dtype=torch.complex64, seed=0):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    return torch.from_numpy(w).to(dtype)


def _chain(blk):
    """The chain as it stood before the kernel, written out."""
    blk = blk - blk.mean(dim=1, keepdim=True)
    return torch.fft.fftshift(torch.fft.fft(blk, dim=1), dim=1).abs() ** 2


SHAPES = [(2, 8, 5, 6), (1, 7, 3, 4), (3, 100, 4, 3), (2, 99, 3, 5),
          (1, 2, 2, 2), (1, 3, 1, 4)]


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
def test_plain_version_is_the_chain_bit_for_bit(shape, dtype):
    x = _waves(shape, dtype)
    want = _chain(x)
    assert torch.equal(tacaw._time_fft_block(x), want)
    out = torch.full((shape[0] + 2,) + shape[1:], -1.0, dtype=want.dtype)
    got = tacaw._time_fft_block(x, out[1:1 + shape[0]])
    assert got.data_ptr() == out[1:].data_ptr()
    assert torch.equal(out[1:1 + shape[0]], want)
    assert (out[0] == -1).all() and (out[-1] == -1).all()


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_plain_version_is_the_kernels_formula(shape):
    """out[p, (f + T//2) % T] = |sum_t (x - mean_t x) exp(-2 pi i f t/T)|^2,
    the sum the kernel takes, as a float64 DFT matrix."""
    x = _waves(shape, torch.complex128, seed=1)
    T = shape[1]
    t = np.arange(T)
    dft = torch.from_numpy(np.exp(-2j * np.pi * np.outer(t, t) / T))
    y = torch.einsum("ft,ptxy->pfxy", dft, x - x.mean(dim=1, keepdim=True))
    want = torch.empty(shape, dtype=torch.float64)
    want[:, (t + T // 2) % T] = y.abs() ** 2
    got = tacaw._time_fft_block(x)
    assert (got - want).abs().max() <= 1e-12 * want.abs().max()


@pytest.mark.parametrize("n_t,takes", [
    (100, True), (400, True), (99, True), (1000, True), (2, True),
    (3, True), (4096, True), (97, False), (2 * 509, False), (5000, False),
    (1, False), (37 * 2, False)])
def test_the_kernel_takes_frame_counts_by_their_radices(n_t, takes):
    assert tf.kernel_takes(n_t) is takes


def test_a_cpu_block_takes_the_plain_chain_and_counts_nothing():
    x = _waves((2, 100, 3, 4))
    before = dict(fs.launches)
    assert not tacaw._kernel_route(x)
    assert torch.equal(tacaw.time_fft_block(x), _chain(x))
    assert fs.launches == before


class _FakeKernel:
    """Stands in for analysis.time_fft on the CPU: takes every frame count and
    records the block and output of each call, filling the output with the
    plain version."""

    def __init__(self):
        self.calls = []

    @staticmethod
    def kernel_takes(n_t):
        return True

    def time_fft(self, blk, out=None):
        assert out is not None
        self.calls.append((blk.shape[0], out.data_ptr(), tuple(out.shape)))
        return tacaw._time_fft_block(blk, out)


@pytest.fixture
def fake_kernel(monkeypatch):
    fake = _FakeKernel()
    monkeypatch.setattr(tacaw, "time_fft_kernel", fake)
    monkeypatch.setattr(tacaw, "_kernel_route", lambda blk: True)
    allocs = []
    new_empty = torch.Tensor.new_empty

    def counted(self, *args, **kwargs):
        allocs.append(tuple(args[0]))
        return new_empty(self, *args, **kwargs)

    monkeypatch.setattr(torch.Tensor, "new_empty", counted)
    return fake, allocs


@pytest.mark.parametrize("step", [1, 2, 3, 5])
def test_kernel_chunks_write_their_rows_of_one_output(fake_kernel, step):
    fake, allocs = fake_kernel
    P, T, NX, NY = 5, 6, 3, 4
    x = _waves((P, T, NX, NY))
    got = tacaw.time_fft_chunks(P, step, lambda i, j: x[i:j])
    assert allocs == [(P, T, NX, NY)]            # one output, nothing else
    assert got.dtype == torch.float32 and got.shape == x.shape
    row = T * NX * NY * 4
    want_calls = [(min(step, P - i), got.data_ptr() + i * row,
                   (min(step, P - i), T, NX, NY)) for i in range(0, P, step)]
    assert fake.calls == want_calls
    assert torch.equal(got, _chain(x))


def test_kernel_route_takes_the_whole_block_in_one_launch(fake_kernel):
    fake, allocs = fake_kernel
    x = _waves((4, 6, 3, 2))
    got = tacaw.time_fft_intensity(x, chunk_elems=6 * 3 * 2)
    assert fake.calls == [(4, got.data_ptr(), (4, 6, 3, 2))]
    assert allocs == [(4, 6, 3, 2)]
    assert torch.equal(got, _chain(x))


def test_the_wrapper_refuses_what_the_kernel_does_not_take():
    x = _waves((2, 100, 3, 4))
    with pytest.raises(ValueError, match="CUDA"):
        tf.time_fft(x)
    with pytest.raises(TypeError, match="complex64"):
        tf.time_fft(x.to(torch.complex128))
    with pytest.raises(ValueError, match="probes, time, kx, ky"):
        tf.time_fft(x[0])
    with pytest.raises(ValueError, match="97 frames"):
        tf.time_fft(_waves((1, 97, 2, 2)))
    with pytest.raises(ValueError, match="shape"):
        tf.time_fft(x, torch.empty((2, 100, 4, 3)))
    with pytest.raises(TypeError, match="float32"):
        tf.time_fft(x, torch.empty((2, 100, 3, 4), dtype=torch.float64))
    with pytest.raises(ValueError, match="contiguous"):
        tf.time_fft(x, torch.empty((2, 100, 4, 3)).transpose(2, 3))
    with pytest.raises(ValueError, match="conjugated"):
        tf.time_fft(x.conj())


@pytest.mark.parametrize("n_t,cols,smem", [
    (100, 32, 54304), (400, 16, 107776), (99, 32, 53784), (1000, 4, 74080),
    (4096, 1, 100360), (2, 32, 3344)])
def test_the_plan(n_t, cols, smem):
    """The widest tile up to 32 columns that lets two blocks share an SM;
    one column at 4096, where even that takes 100 KB."""
    pl = tf.plan(n_t)
    assert (pl.cols, pl.smem_bytes) == (cols, smem) == \
        (cols, tf.smem(n_t, pl.logc))
    if pl.logc > 0:
        assert pl.smem_bytes <= tf.BLOCK_SMEM
    if pl.logc < tf.MAX_LOGC:
        assert tf.smem(n_t, pl.logc + 1) > tf.BLOCK_SMEM


def test_the_c_entry_matches_its_argument_types():
    """tf_time_fft's parameters, read from csrc/time_fft.cu, against the
    ctypes signature the binding declares."""
    src = CU.read_text()
    m = re.search(r"int tf_time_fft\(([^)]*)\)", src)
    kinds = []
    for par in m.group(1).split(","):
        par = " ".join(par.split())
        kinds.append("p" if "*" in par else "l" if "long long" in par
                     else "i")
    assert "".join(kinds) == fs._ARGTYPES["tf_time_fft"]
    assert "time_fft" in fs.SOURCES
    assert {"time_fft", "time_fft_plain"} <= set(fs.launches)
    # the C side's limits are the plan's
    assert f"kTfThreads = {tf.THREADS}" in src
    assert f"kTfMaxLogc = {tf.MAX_LOGC}" in src
