"""Port parity: the resident slice loop (K6) of
pyslice_tpu_torch.ops.fused_step_resident and fused_step_odd_resident
against pyslice_tpu, and the port's dispatch (physics.propagate.
fused_family) against the JAX package's predicates.

On the CPU, K6's wrapper runs its plain version (the same row and column
phases as plain torch.fft passes). The JAX side is its plain XLA loop,
plus one comparison with its odd resident Pallas kernel in interpret
mode."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from pyslice_tpu.core.dtypes import DOUBLE as JDOUBLE, SINGLE as JSINGLE
from pyslice_tpu.ops import fused_step as jfs
from pyslice_tpu.ops import fused_step_odd as jodd
from pyslice_tpu.ops import fused_step_odd_resident as jodr
from pyslice_tpu.ops import fused_step_resident as jres
from pyslice_tpu_torch.ops import config as tconfig
from pyslice_tpu_torch.ops import fused_step as tfs
from pyslice_tpu_torch.ops import fused_step_odd_resident as todr
from pyslice_tpu_torch.ops import fused_step_resident as tres
from pyslice_tpu_torch.physics import propagate as tprop

from oracle import residual
from test_torch_fused_step_odd import (DZ, LAM, SIGMA, _inputs, _jax, _port64,
                                       planes64)

torch.set_num_threads(2)


def _kspace(x):
    return np.fft.fftshift(np.fft.fft2(x), axes=(-2, -1))


# family -> (exit-wave function, k-space function, a shape it takes)
ENTRIES = {
    "pow2": (tres.fused_multislice_resident,
             tres.fused_multislice_kspace_resident, (2, 128, 256, 3)),
    "odd": (todr.fused_multislice_odd_resident,
            todr.fused_multislice_kspace_odd_resident, (1, 387, 393, 3)),
    "odd_even": (todr.fused_multislice_odd_resident,
                 todr.fused_multislice_kspace_odd_resident, (4, 258, 387, 2)),
    "n1x128": (todr.fused_multislice_odd_resident,
               todr.fused_multislice_kspace_odd_resident, (3, 384, 387, 4)),
}

CASES = {
    "plain": {},
    "band_and_tilt": dict(kmax2=(2.0 / 3.0 * 4.0) ** 2,
                          tantilt=(0.004, -0.002)),
}


@pytest.mark.parametrize("family", list(ENTRIES))
@pytest.mark.parametrize("case", list(CASES))
def test_exit_and_kspace_complex64_match_jax(family, case):
    exit_fn, kspace_fn, shape = ENTRIES[family]
    kw = CASES[case]
    psi, v, kxs, kys = _inputs(*shape)
    want = _jax(psi, v, kxs, kys, JSINGLE, **kw)
    got = _port64(exit_fn, psi, v, kxs, kys, **kw)
    assert got.shape == want.shape == shape[:3]
    assert residual(got, want) <= 1e-6
    # k space, odd and even axes: fftshift(fft2(.)) of the exit wave
    gotk = _port64(kspace_fn, psi, v, kxs, kys, **kw)
    assert residual(gotk, _kspace(want.astype(np.complex128))) <= 1e-6


@pytest.mark.parametrize("family", list(ENTRIES))
def test_record_layers_match_jax(family):
    exit_fn, _, shape = ENTRIES[family]
    psi, v, kxs, kys = _inputs(*shape[:3], 4, seed=1)
    for layers in ((0, 3), (1, 2, 3)):
        want = _jax(psi, v, kxs, kys, JSINGLE, record_layers=layers)
        got = _port64(exit_fn, psi, v, kxs, kys, record_layers=layers)
        assert got.shape == want.shape == (len(layers),) + shape[:3]
        assert residual(got, want) <= 1e-6


@pytest.mark.parametrize("kspace", [False, True])
@pytest.mark.parametrize("shape", [(2, 258, 387, 3), (1, 128, 256, 4)])
def test_plain_loop_complex128_matches_jax(kspace, shape):
    psi, v, kxs, kys = _inputs(*shape, seed=2)
    t, prop = planes64(v, kxs, kys, kmax2=9.0, tantilt=(0.003, 0.001))
    got = tres.resident_loop(torch.from_numpy(psi), t, prop, kspace).numpy()
    want = _jax(psi, v, kxs, kys, JDOUBLE, kmax2=9.0, tantilt=(0.003, 0.001))
    if kspace:
        want = _kspace(want)
    assert got.dtype == np.complex128
    assert residual(got, want) <= 1e-10


@pytest.mark.parametrize("fn,shape", [
    (todr.fused_multislice_odd_resident, (2, 387, 393)),
    (tres.fused_multislice_resident, (2, 128, 128))])
def test_one_slice_goes_to_the_chain(fn, shape):
    psi, v, kxs, kys = _inputs(*shape, 1, seed=3)
    want = psi * np.exp(1j * np.float32(SIGMA) * v[0].astype(np.float32))
    assert residual(_port64(fn, psi, v, kxs, kys), want) <= 1e-12
    k = _port64(todr.fused_multislice_kspace_odd_resident,
                *_inputs(1, 387, 393, 1, seed=3))
    assert k.shape == (1, 387, 393)


def test_cpu_wrapper_is_the_plain_loop():
    psi, v, kxs, kys = _inputs(2, 258, 387, 3, seed=4)
    before = dict(tfs.launches)
    t = tfs.transmission_stack(SIGMA, torch.from_numpy(v))
    prop = tfs.fresnel_plane(kxs, kys, LAM, DZ, device="cpu")
    p = torch.from_numpy(psi.astype(np.complex64))
    for kspace in (False, True):
        np.testing.assert_array_equal(
            tres.resident_loop(p, t, prop, kspace).numpy(),
            tres._plain_resident_loop(p, t, prop, kspace).numpy())
    chain = _port64(tfs.fused_multislice_plain, psi, v, kxs, kys)
    got = _port64(todr.fused_multislice_odd_resident, psi, v, kxs, kys)
    np.testing.assert_array_equal(got, chain)
    assert tfs.launches == before         # no kernel launched on the CPU


def test_unsupported_grids_raise():
    psi = torch.zeros((1, 1009, 387), dtype=torch.complex64)
    v = torch.zeros((3, 1009, 387))
    with pytest.raises(ValueError, match="odd resident"):
        todr.fused_multislice_odd_resident(psi, v, np.zeros(1009),
                                           np.zeros(387), sigma=1e-3,
                                           lam=0.037, dz=0.5)
    with pytest.raises(ValueError, match="resident path"):
        tres.fused_multislice_resident(psi[:, :384], v[:, :384],
                                       np.zeros(384), np.zeros(387),
                                       sigma=1e-3, lam=0.037, dz=0.5)


def test_odd_resident_matches_jax_pallas_kernel():
    """The one comparison with the JAX package's Pallas kernel (#8), in
    interpret mode, as tests/test_fused.py runs it."""
    from jax.experimental.pallas import tpu as pltpu
    psi, v, kxs, kys = _inputs(1, 387, 387, 2, seed=5)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jodr.fused_multislice_kspace_odd_resident(
            jnp.asarray(psi.astype(np.complex64)),
            jnp.asarray(v.astype(np.float32)), kxs, kys, sigma=SIGMA,
            lam=LAM, dz=DZ))
    got = _port64(todr.fused_multislice_kspace_odd_resident, psi, v, kxs, kys)
    # the Pallas kernel's stage-2 dots are bf16x3 (~2^-16 relative)
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-4


# --- dispatch --------------------------------------------------------------------


def jax_family(P, nx, ny, nz):
    """The JAX package's pick_fused order over its size predicates (its
    own pick_fused also needs a TPU backend)."""
    aligned = jfs.supported_size(nx) and jfs.supported_size(ny)
    if (aligned and jres.resident_supported(nx, ny, nz)
            and jres.resident_preferred(P, nx, ny)):
        return "resident"
    if aligned:
        return "aligned"
    odd = jodd.supported_size_odd(nx, P) and jodd.supported_size_odd(ny, P)
    if (odd and jodr.resident_odd_supported(nx, ny, nz, P)
            and jodr.resident_odd_preferred(P, nx, ny)):
        return "odd_resident"
    return "odd" if odd else None


N1X128 = "n1*128 sizes that are not powers of two take the mixed-radix kernels"
VMEM = "JAX VMEM gate (TPU limit, not ported)"
PRE_T = ("JAX prefers its odd resident kernel at any probe count where "
         "(cos, sin) planes fit its VMEM (_pre_t_choice, a TPU measurement); "
         "the port keeps the probe-pixel crossover")
CROSS = ("JAX's odd crossover is 3,000,000 probe-pixels; the port keeps the "
         "one crossover of resident_preferred, 3 * 2^20")
PRIME = ("a stage prime above 31 ({}) is a direct sum in the port's kernels "
         "(an MXU product in JAX's), which loses to the plain passes on the "
         "H100 (kernel_preferred_mr; PERF.md)").format

# (probes, nx, ny, nz, JAX family, port family, why they differ)
TABLE = [
    (1, 1023, 1023, 14, "odd_resident", "odd_resident", None),
    (16, 1023, 1023, 14, "odd", "odd", None),
    (2, 1023, 1023, 14, "odd_resident", "odd_resident", None),
    (3, 1023, 1023, 14, "odd", "odd_resident", CROSS),
    (1, 1023, 1023, 1, "odd", "odd", None),
    (1, 1024, 1024, 14, "resident", "resident", None),
    (16, 1024, 1024, 14, "aligned", "aligned", None),
    (1, 1024, 1024, 1, "aligned", "aligned", None),
    (1, 2048, 2048, 14, "aligned", "aligned", None),
    (1, 4096, 128, 14, "aligned", "resident", VMEM + ": axes <= 2048"),
    (1, 8192, 128, 4, "aligned", None, "the port's engines stop at 4096"),
    (1, 1152, 1152, 14, "aligned", "odd_resident",
     N1X128 + "; " + VMEM + ": <= 2^20 pixels"),
    (16, 1152, 1152, 14, "aligned", "odd", N1X128),
    (4, 384, 384, 14, "resident", "odd_resident", N1X128),
    (16, 384, 384, 14, "resident", "odd_resident", N1X128),
    (1, 640, 640, 14, "resident", "odd_resident", N1X128),
    (1, 1018, 1018, 14, "odd_resident", None, PRIME(509)),
    (16, 1018, 1018, 14, "odd_resident", None, PRIME(509)),
    (16, 1023, 1018, 14, "odd", None, PRIME("509 on y")),
    (1, 1016, 1016, 14, "odd_resident", None, PRIME(127)),
    (16, 1016, 1016, 14, "odd_resident", None, PRIME(127)),
    (1, 1032, 1032, 14, "odd_resident", None, PRIME(43)),
    (16, 1032, 1032, 14, "odd", None, PRIME(43)),
    (1, 387, 387, 14, "odd_resident", None, PRIME(43)),
    (16, 387, 387, 14, "odd_resident", None, PRIME(43)),
    (16, 999, 999, 14, "odd_resident", None, PRIME(37)),
    (64, 513, 513, 14, "odd_resident", "odd", PRE_T),
    (1, 513, 513, 14, "odd_resident", "odd_resident", None),
    (1, 1024, 1023, 14, "odd", "odd_resident", VMEM + ": _vmem_estimate"),
    (1, 387, 393, 3, "odd_resident", None, PRIME("43, 131")),
    (4, 258, 387, 2, "odd_resident", None, PRIME(43)),
    (16, 387, 393, 3, "odd_resident", None, PRIME("43, 131")),
    (1, 1009, 1009, 14, None, None, None),     # prime: XLA / plain
    (16, 1009, 1009, 14, None, None, None),
    (1, 385, 385, 14, None, None, None),       # 5 * 77: m < 128
    (4, 385, 385, 14, None, None, None),
    (1, 255, 255, 14, None, None, None),
]


@pytest.mark.parametrize("row", TABLE, ids=lambda r: "x".join(map(str, r[:4])))
def test_family_table_against_jax(row):
    P, nx, ny, nz, want_jax, want_port, why = row
    assert jax_family(P, nx, ny, nz) == want_jax
    assert tprop.fused_family(P, nx, ny, nz, "single") == want_port
    assert (want_jax == want_port) == (why is None)
    assert tprop.fused_family(P, nx, ny, nz, "double") is None
    off = tprop.fused_family(P, nx, ny, nz, "single", resident=False)
    assert off == {"resident": "aligned", "odd_resident": "odd"}.get(
        want_port, want_port)


def test_pick_fused_reads_flags_and_device(monkeypatch):
    meta = torch.empty((1, 1023, 1023), dtype=torch.complex64, device="meta")
    assert tprop.pick_fused(meta, tprop.get_precision("single"), 14) is None
    psi = torch.zeros((1, 384, 1023), dtype=torch.complex64)
    assert tprop.pick_fused(psi, tprop.get_precision("single"), 3) is None
    # on a CUDA tensor the family comes from fused_family and the flags
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda s: True))
    single = tprop.get_precision("single")
    assert tprop.pick_fused(psi, single, 3) == "odd_resident"
    monkeypatch.setattr(tconfig, "resident_multislice", "off")
    assert tprop.pick_fused(psi, single, 3) == "odd"
    monkeypatch.setattr(tconfig, "fused_multislice", "off")
    assert tprop.pick_fused(psi, single, 3) is None
