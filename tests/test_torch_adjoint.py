"""Port parity: the O(1)-memory adjoint (pyslice_tpu_torch.physics.adjoint)
and its backward chain (ops.fused_step_adjoint) against pyslice_tpu's.

Conventions pinned here (derived in physics/adjoint.py's docstring): for
the same real loss, PyTorch's grad of a complex tensor is the conjugate of
JAX's, so the port's psi grad is conj(JAX's) and the potential grads are
equal. On the CPU the chain's wrappers run their plain torch.fft versions;
the JAX chains run their Pallas kernels in interpret mode. The kernels are
held to the plain versions on the card by tests/test_torch_cuda_kernels.py
and chip_smoke.py."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from pyslice_tpu.core.constants import interaction_parameter, wavelength
from pyslice_tpu.core.dtypes import DOUBLE as JDOUBLE
from pyslice_tpu.ops import fused_step as jfs
from pyslice_tpu.ops import fused_step_adjoint as jadj
from pyslice_tpu.physics.adjoint import multislice_diff as jdiff
from pyslice_tpu_torch.ops import config as tconfig
from pyslice_tpu_torch.ops import fused_step as tfs
from pyslice_tpu_torch.ops import fused_step_adjoint as tadj
from pyslice_tpu_torch.physics import adjoint as tadjoint
from pyslice_tpu_torch.physics.adjoint import multislice_diff as tdiff
from pyslice_tpu_torch.physics.propagate import multislice as tms

torch.set_num_threads(2)

EV = 100e3
SIGMA = interaction_parameter(EV)
LAM = wavelength(EV)
# bf16x3 stage-2 dots in the JAX kernels, as tests/test_torch_fused_step.py.
TOL = 1e-4 if jfs._dot_mode() == "bf16x3" else 5e-6


def _problem(nb=3, nx=24, ny=20, nz=6, seed=0):
    rng = np.random.default_rng(seed)
    psi = rng.normal(size=(nb, nx, ny)) + 1j * rng.normal(size=(nb, nx, ny))
    v = rng.normal(size=(nz, nx, ny)) * 40.0
    kxs = np.fft.fftfreq(nx, d=0.12)
    kys = np.fft.fftfreq(ny, d=0.15)
    w = rng.random((nx, ny))
    c = rng.normal(size=(nx, ny)) + 1j * rng.normal(size=(nx, ny))
    return psi, v, kxs, kys, w, c


def _case_kw(case, kxs, kys):
    if case == "tilt":
        return dict(tilt=(4.0, -2.5))
    if case == "oblique":
        return dict(ksq=(kxs[:, None] ** 2 + kys[None, :] ** 2
                         + 0.4 * kxs[:, None] * kys[None, :]))
    return {}


def _loss_grads_jax(psi, v, kxs, kys, w, c, kw):
    """jax.grad of a real loss that weighs intensities and phases."""
    def loss(p, pot):
        out = jdiff(p, pot, kxs, kys, eV=EV, dz=0.9, precision=JDOUBLE, **kw)
        return (jnp.sum(w * jnp.abs(jnp.fft.fft2(out)) ** 2)
                + jnp.sum(jnp.real(c * out)))
    gp, gv = jax.grad(loss, argnums=(0, 1))(jnp.asarray(psi), jnp.asarray(v))
    return np.asarray(gp), np.asarray(gv)


def _loss_grads_torch(fn, psi, v, kxs, kys, w, c, kw):
    p = torch.from_numpy(psi).requires_grad_()
    pot = torch.from_numpy(v).requires_grad_()
    out = fn(p, pot, kxs, kys, eV=EV, dz=0.9, precision="double", **kw)
    loss = (torch.sum(torch.from_numpy(w) * torch.abs(torch.fft.fft2(out)) ** 2)
            + torch.sum(torch.real(torch.from_numpy(c) * out)))
    gp, gv = torch.autograd.grad(loss, [p, pot])
    return gp.numpy(), gv.numpy()


def _rel(got, want):
    return np.abs(got - want).max() / np.abs(want).max()


CASES = ["plain", "tilt", "oblique", "nz1", "psi2d"]


def _case_problem(case):
    psi, v, kxs, kys, w, c = _problem(nz=1 if case == "nz1" else 6,
                                      seed=CASES.index(case))
    if case == "psi2d":
        psi = psi[0]
    return psi, v, kxs, kys, w, c, _case_kw(case, kxs, kys)


@pytest.mark.parametrize("case", CASES)
def test_grads_equal_jax_f64(case):
    psi, v, kxs, kys, w, c, kw = _case_problem(case)
    jgp, jgv = _loss_grads_jax(psi, v, kxs, kys, w, c, kw)
    tgp, tgv = _loss_grads_torch(tdiff, psi, v, kxs, kys, w, c, kw)
    assert tgp.shape == psi.shape and tgv.shape == v.shape
    assert _rel(tgv, jgv) <= 1e-10                 # the same V grad
    assert _rel(tgp, np.conj(jgp)) <= 1e-10       # psi grad: conj of JAX's


@pytest.mark.parametrize("case", CASES)
def test_vjp_maps_cotangents_as_conjugates(case):
    """For a cotangent g of JAX's vjp, PyTorch's grad_output conj(g) gives
    V grads equal to JAX's and psi grads conj of JAX's."""
    psi, v, kxs, kys, _, _, kw = _case_problem(case)
    f = lambda p, pot: jdiff(p, pot, kxs, kys, eV=EV, dz=0.9,
                             precision=JDOUBLE, **kw)
    out, vjp = jax.vjp(f, jnp.asarray(psi), jnp.asarray(v))
    rng = np.random.default_rng(7)
    g = rng.normal(size=out.shape) + 1j * rng.normal(size=out.shape)
    jgp, jgv = (np.asarray(x) for x in vjp(jnp.asarray(g)))
    p = torch.from_numpy(psi).requires_grad_()
    pot = torch.from_numpy(v).requires_grad_()
    tout = tdiff(p, pot, kxs, kys, eV=EV, dz=0.9, precision="double", **kw)
    assert _rel(tout.detach().numpy(), np.asarray(out)) <= 1e-10
    tgp, tgv = torch.autograd.grad(tout, [p, pot],
                                   torch.from_numpy(np.conj(g)))
    assert _rel(tgv.numpy(), jgv) <= 1e-10
    assert _rel(tgp.numpy(), np.conj(jgp)) <= 1e-10


@pytest.mark.parametrize("case", CASES)
def test_grads_equal_autograd_through_plain_loop(case):
    psi, v, kxs, kys, w, c, kw = _case_problem(case)
    plain = lambda *a, **k: tms(*a, fused=False, **k)
    want = _loss_grads_torch(plain, psi, v, kxs, kys, w, c, kw)
    got = _loss_grads_torch(tdiff, psi, v, kxs, kys, w, c, kw)
    for g, r in zip(got, want):
        assert _rel(g, r) <= 1e-12


def test_unitarity_gradient_invariant():
    """d/dV sum |psi_exit|^2 == 0: the chain preserves the norm for any
    potential."""
    psi, v, kxs, kys, _, _ = _problem(nz=5, seed=5)
    pot = torch.from_numpy(v).requires_grad_()
    out = tdiff(torch.from_numpy(psi), pot, kxs, kys, eV=EV, dz=1.1,
                precision="double")
    g, = torch.autograd.grad(torch.sum(torch.abs(out) ** 2), pot)
    assert float(g.abs().max()) < 1e-9


def test_saved_state_is_o1():
    """The backward keeps the exit wave and the inputs, no per-slice
    wave."""
    psi, v, kxs, kys, _, _ = _problem(nb=2, nx=16, ny=16, nz=32)
    out = tdiff(torch.from_numpy(psi).requires_grad_(),
                torch.from_numpy(v).requires_grad_(), kxs, kys, eV=EV,
                dz=1.0, precision="double")
    saved = out.grad_fn.saved_tensors
    assert len(saved) == 2
    for t in saved:
        assert not t.is_complex() or t.numel() <= psi.size
    assert sum(t.numel() for t in saved if not t.is_complex()) == v.size


def _chain_inputs(P, nx, ny, nz, seed):
    rng = np.random.default_rng(seed)
    shape = (P, nx, ny)
    a = (rng.standard_normal(shape)
         + 1j * rng.standard_normal(shape)).astype(np.complex64)
    g = (rng.standard_normal(shape)
         + 1j * rng.standard_normal(shape)).astype(np.complex64)
    v = (rng.standard_normal((nz, nx, ny)) * 50).astype(np.float32)
    kxs = np.fft.fftfreq(nx, 0.1).astype(np.float32)
    kys = np.fft.fftfreq(ny, 0.1).astype(np.float32)
    return a, g, v, kxs, kys


@pytest.mark.parametrize("kind,shape", [("aligned", (2, 128, 128, 4)),
                                        ("odd", (2, 135, 135, 4))])
def test_chains_match_jax_pallas_chains(kind, shape):
    from jax.experimental.pallas import tpu as pltpu
    a, g, v, kxs, kys = _chain_inputs(*shape, seed=11)
    kw = dict(sigma=SIGMA, lam=LAM, dz=0.5)
    jchain, tchain = ((jadj.fused_adjoint_chain, tadj.fused_adjoint_chain)
                      if kind == "aligned" else
                      (jadj.fused_adjoint_chain_odd,
                       tadj.fused_adjoint_chain_odd))
    with pltpu.force_tpu_interpret_mode():
        jl, jv = jchain(jnp.asarray(a), jnp.asarray(np.conj(g)),
                        jnp.asarray(v), kxs, kys, **kw)
    tl, tv = tchain(torch.from_numpy(a), torch.from_numpy(g),
                    torch.from_numpy(v), kxs, kys, **kw)
    assert tl.shape == shape[:3] and tv.shape == (shape[3] - 1,) + shape[1:3]
    assert _rel(tl.numpy(), np.conj(np.asarray(jl))) < TOL
    assert _rel(tv.numpy(), np.asarray(jv)) < TOL


def test_cpu_chain_wrappers_are_the_plain_chain():
    a, g, v, kxs, kys = _chain_inputs(2, 128, 96, 5, seed=12)
    args = (torch.from_numpy(a), torch.from_numpy(g), torch.from_numpy(v),
            kxs, kys)
    kw = dict(sigma=SIGMA, lam=LAM, dz=0.5, tantilt=(0.003, -0.001))
    before = dict(tfs.launches)
    want = tadj.fused_adjoint_chain_plain(*args, **kw)
    for chain in (tadj.fused_adjoint_chain, tadj.fused_adjoint_chain_odd):
        for got, ref in zip(chain(*args, **kw), want):
            assert torch.equal(got, ref)
    assert tfs.launches == before          # no kernel launched on the CPU


@pytest.mark.parametrize("psi2d", [False, True])
def test_backward_through_chain_equals_plain_recurrence(monkeypatch, psi2d):
    """The chain branch of the backward (forced on the CPU, where it runs
    the plain passes) gives the plain recurrence's grads in complex64:
    the pair stream, conj(t), conj(P), the vbar order and the entrance
    transmission are wired as derived."""
    a, g, v, kxs, kys = _chain_inputs(2, 128, 128, 5, seed=13)
    psi = a[0] if psi2d else a
    gout = g[0] if psi2d else g

    def grads():
        p = torch.from_numpy(psi).requires_grad_()
        pot = torch.from_numpy(v).requires_grad_()
        out = tdiff(p, pot, kxs, kys, eV=EV, dz=0.5, tilt=(3.0, -1.0))
        return torch.autograd.grad(out, [p, pot], torch.from_numpy(gout))

    want = grads()
    monkeypatch.setattr(tadjoint, "_bwd_family", lambda *a: "aligned")
    got = grads()
    for x, r in zip(got, want):
        assert _rel(x.numpy(), r.numpy()) < 1e-5


def test_backward_does_not_fall_back(monkeypatch):
    """A chain that fails (a kernel that does not build or launch) fails
    the backward: nothing catches it."""
    def broken(*args, **kwargs):
        raise RuntimeError("row_pass_bwd (K7) kernel launch failed")

    monkeypatch.setattr(tadjoint, "_bwd_family", lambda *a: "aligned")
    monkeypatch.setitem(tadjoint.ADJOINT_CHAINS, "aligned", broken)
    a, g, v, kxs, kys = _chain_inputs(1, 128, 128, 3, seed=14)
    pot = torch.from_numpy(v).requires_grad_()
    out = tdiff(torch.from_numpy(a), pot, kxs, kys, eV=EV, dz=0.5)
    with pytest.raises(RuntimeError, match="launch failed"):
        out.backward(torch.from_numpy(g))


def test_backward_dispatch_flags():
    cfg = tadjoint._Config(EV, LAM, 0.5, tadjoint.get_precision("single"),
                           None, None)
    cpu = torch.zeros((2, 128, 128), dtype=torch.complex64)
    assert tadjoint._bwd_family(cfg, cpu, 4) is None     # CPU: plain
    old = tconfig.fused_multislice
    try:
        tconfig.fused_multislice = "off"
        assert tadjoint._bwd_family(cfg, cpu, 4) is None
    finally:
        tconfig.fused_multislice = old


def test_plain_row_pass_bwd_formula():
    rng = np.random.default_rng(15)
    st = (rng.standard_normal((4, 128, 96))
          + 1j * rng.standard_normal((4, 128, 96))).astype(np.complex64)
    sv = (rng.standard_normal((128, 96)) * 20).astype(np.float32)
    w = np.fft.ifft(st.astype(np.complex128), axis=-1)
    vb = -SIGMA * np.sum(np.imag(np.conj(w[1::2]) * w[0::2]), axis=0)
    for mode in tadj.BWD_MODES:
        got, gvb = tadj.row_pass_bwd(mode, torch.from_numpy(st),
                                     torch.from_numpy(sv), SIGMA)
        want = (np.fft.fft(w * np.exp(1j * sv), axis=-1) if mode == "mid"
                else w)
        assert _rel(got.numpy(), want) < 1e-5
        assert _rel(gvb.numpy(), vb) < 1e-5
    with pytest.raises(ValueError, match="mode"):
        tadj.row_pass_bwd("first", torch.from_numpy(st), None, SIGMA)
    with pytest.raises(ValueError, match="pair stream"):
        tadj.row_pass_bwd("last", torch.from_numpy(st[:3]), None, SIGMA)


def test_kernels_refuse_lazily_conjugated_views():
    """A lazily conjugated (or negated) plane keeps unconjugated data
    behind data_ptr(): the CUDA checks refuse it before anything else."""
    p = torch.ones((128, 128), dtype=torch.complex64)
    for view in (torch.conj(p), torch._neg_view(p)):
        with pytest.raises(ValueError, match="lazily conjugated"):
            tfs._check_cuda(view, "prop", (128, 128), torch.complex64)
    tfs_plane = torch.conj_physical(p)
    assert not tfs_plane.is_conj()


def test_adjoint_supported_sizes():
    assert tadj.adjoint_supported(1024, 1024)
    assert not tadj.adjoint_supported(1023, 1024)
    assert tadj.adjoint_supported_odd(1023, 1023, 16)
    assert tadj.adjoint_supported_odd(384, 1152)
    assert not tadj.adjoint_supported_odd(1009, 1023)
