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
