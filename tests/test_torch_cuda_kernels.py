"""The port's CUDA kernels A, B and C against their plain torch.fft
versions, on the card. Every test needs a CUDA device and skips without
one. The machine with the card has no JAX, so run this file there without
the JAX-side conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_kernels.py
"""

import numpy as np
import pytest
import torch

from pyslice_tpu_torch.core.constants import interaction_parameter, wavelength
from pyslice_tpu_torch.ops import fused_step as fs

pytestmark = pytest.mark.cuda

# float32 radix-16 FFT passes against cuFFT: ~1e-6 relative per transform
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
    _ok(fs.kconvert(psi), fs._plain_kconvert(psi))


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
