"""The backward chain of the multislice adjoint: kernels K7 and K8 in CUDA.

Counterpart of ``pyslice_tpu/ops/fused_step_adjoint.py``. The O(1)-memory
adjoint (``physics.adjoint``) runs, backwards through the slice stack, one
recurrence on a stream of pairs w = (a, lambda): the post-transmission wave
a_z, rebuilt from the exit wave, and its cotangent lambda_z (PyTorch's
``grad``, see ``physics.adjoint`` for the conventions). Both obey

    w_z = ifft2(conj(P) * fft2(conj(t_{z+1}) * w_{z+1})),

a standard slice step with the conjugate transmission and the conjugate
Fresnel plane, so the forward chain's kernels serve it unchanged: the
entry is A (or K4) in ``first`` mode with conj(t_{nz-1}), every column pass
is B (or K5) with conj(P). The one new piece is the row pass after each
column pass, which holds the real-space pair between its IFFT_y and the
next transmission, exactly where the potential cotangent

    vbar_z = -sigma * sum_pairs Im(conj(w1) * w0)

is a product of values already on the chip:

    K7 ``row_pass_bwd``     (csrc/fused_step_adjoint.cu; power-of-two axes)
    K8 ``row_pass_mr_bwd``  (csrc/fused_step_adjoint_odd.cu; mixed radix)

each in ``mid`` mode (IFFT_y, vbar, x conj(t), FFT_y) or ``last`` mode
(IFFT_y, vbar, real-space store). The pair stream is (2 P, nx, ny)
complex64 with rows (2b, 2b + 1) = (a_b, lambda_b), in natural order at
every kernel boundary; a block sums vbar over the pairs in pair order, so
the result is deterministic (no atomics).

The conjugated planes are built physically (``torch.conj_physical``, or
the negated phase -sigma*V): the kernels read ``data_ptr()``, and
``fused_step._check_cuda`` refuses lazily conjugated views.

K7 runs on A's register-resident engine (``csrc/fft_regs.cuh``): a block
holds rows of both members, each thread 32 values of one member's row
from its load to its store; the two members of a row share a warp, whose
halves swap values by shuffle for the vbar sum, which each thread keeps
in its own shared-memory slots. Its tile plan is ``fused_step.pair_reg_plan``, and
``fused_step.last_launch["k7"]`` holds its last plan and grid.

K8 runs on the persistent producer/consumer tiles of K4 and K5
(``csrc/tile_async.cuh``): a block walks its row tiles, each through every
pair in order, while its producer warps copy the next pair of the same
rows; its tile plan is ``fused_step_odd.pair_tile_plan``, and
``fused_step_odd.last_launch["k8"]`` holds its last plan and grid.

Each wrapper takes its plain ``torch.fft`` version for a tensor on the CPU,
and for a CUDA tensor launches its kernel or raises; ``launches["k7"]`` /
``launches["k8"]`` count the launches. ``fused_adjoint_chain[_odd]`` run
the chain on the wrappers, ``fused_adjoint_chain_plain`` on the plain
versions (the reference both are held to).

Contract, as the JAX functions' except for the conjugation convention:
``lam_ct`` is PyTorch's exit-wave grad and the returned ``lam0`` is
PyTorch's grad of the entrance wave before the slice-0 transmission (JAX's
are their conjugates); ``vbar`` is the same in both.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .fused_step import (_check_cuda, _check_state, _into, _out_for,
                         _plain_col_pass, _plain_row_pass, _raise_on,
                         _record_reg_launch, _transmission, _twiddles, build,
                         col_pass, fresnel_plane, launches, pair_reg_plan,
                         row_pass, supported_size, transmission_stack)
from .fused_step_odd import (MR_SIZES, col_pass_mr, pair_tile_plan,
                             record_launch, row_pass_mr, supported_size_mr)

BWD_MODES = ("mid", "last")


def adjoint_supported(nx: int, ny: int) -> bool:
    """Grids K7's chain takes: power-of-two axes, 128..4096."""
    return supported_size(nx) and supported_size(ny)


def adjoint_supported_odd(nx: int, ny: int, n_probes: int = None) -> bool:
    """Grids K8's chain takes: the axes K4 and K5 take
    (``supported_size_mr``; the JAX package: ``supported_size_odd``)."""
    return (supported_size_mr(nx, n_probes)
            and supported_size_mr(ny, n_probes))


# --- plain version ---------------------------------------------------------------


def _plain_row_pass_bwd(mode: str, state, t, sigma: float, out=None,
                        vbar=None):
    """K7's and K8's plain version: IFFT_y of the pair stream, the pairs'
    vbar, then (``mid``) x t and FFT_y. Returns (state, vbar)."""
    w = torch.fft.ifft(state, dim=-1)
    pairs = w.reshape(w.shape[0] // 2, 2, *w.shape[1:])
    vb = (-sigma) * torch.sum(torch.imag(torch.conj(pairs[:, 1]) * pairs[:, 0]),
                              dim=0)
    if mode == "mid":
        w = torch.fft.fft(w * _transmission(t), dim=-1)
    return _into(w, out), _into(vb, vbar)


# --- wrappers --------------------------------------------------------------------


@functools.cache
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _row_pass_bwd(kernel: str, mode: str, state: torch.Tensor, t,
                  sigma: float, out, vbar):
    """Launch K7 (``kernel`` "k7") or K8 ("k8") on a CUDA pair stream, or
    run the plain version on a CPU one."""
    if mode not in BWD_MODES:
        raise ValueError(f"backward row pass mode must be one of "
                         f"{list(BWD_MODES)}")
    if state.dim() != 3 or state.shape[0] % 2:
        raise ValueError(f"state must be a (2 pairs, nx, ny) pair stream, "
                         f"got {tuple(state.shape)}")
    if mode == "mid" and t is None:
        raise ValueError("mid mode needs the transmission t")
    if state.device.type == "cpu":
        return _plain_row_pass_bwd(mode, state, t, sigma, out, vbar)
    two_p, nx, ny = state.shape
    info = (ctypes.c_int * 4)()
    if kernel == "k7":
        _check_state(state)
        lib, fn, full = (build().libs["fused_step_adjoint"],
                         "fs_row_pass_bwd", False)
        plan = pair_reg_plan(ny, nx, factors=mode == "mid",
                             sms=_sm_count(state.device))
        plan_args = (plan.logc, ctypes.addressof(info))
    else:
        _check_state(state, lambda n: supported_size_mr(n, state.shape[0]),
                     MR_SIZES)
        lib, fn, full = (build().libs["fused_step_adjoint_odd"],
                         "fs_row_pass_bwd_mr", True)
        plan = pair_tile_plan(ny, nx)
        plan_args = (plan.logc, plan.threads, int(plan.shared_table),
                     ctypes.addressof(info))
    phase = False
    if mode == "mid":
        phase = not t.is_complex()
        _check_cuda(t, "t", (nx, ny),
                    torch.float32 if phase else torch.complex64, state.device)
    out = _out_for(state, out)
    if vbar is None:
        vbar = torch.empty((nx, ny), dtype=torch.float32, device=state.device)
    else:
        _check_cuda(vbar, "vbar", (nx, ny), torch.float32, state.device)
    with torch.cuda.device(state.device):
        err = getattr(lib, fn)(
            out.data_ptr(), state.data_ptr(),
            t.data_ptr() if mode == "mid" and not phase else None,
            t.data_ptr() if phase else None, vbar.data_ptr(),
            _twiddles(ny, state.device, full=full).data_ptr(), two_p // 2,
            nx, ny, int(mode == "last"), -float(sigma), *plan_args,
            torch.cuda.current_stream().cuda_stream)
    if kernel == "k7":
        _record_reg_launch("k7", plan, info)
    else:
        record_launch("k8", plan, info)
    _raise_on(err, f"{fn} ({kernel.upper()})")
    launches[kernel] += 1
    return out, vbar


def row_pass_bwd(mode: str, state: torch.Tensor, t, sigma: float, out=None,
                 vbar=None):
    """K7 on a (2P, nx, ny) complex64 pair stream (power-of-two axes):
    IFFT_y, vbar = -sigma * sum_pairs Im(conj(w1) w0), then (``mid``) x t
    and FFT_y, or (``last``) the real-space store. ``t``: the (nx, ny)
    complex64 plane or the float32 phase (conjugated by the caller); None
    for ``last``. ``out`` may be ``state``; ``vbar`` an (nx, ny) float32
    destination. Returns (state, vbar)."""
    return _row_pass_bwd("k7", mode, state, t, sigma, out, vbar)


def row_pass_mr_bwd(mode: str, state: torch.Tensor, t, sigma: float,
                    out=None, vbar=None):
    """K8: ``row_pass_bwd`` with the mixed-radix engine, on the axes K4
    takes."""
    return _row_pass_bwd("k8", mode, state, t, sigma, out, vbar)


# --- the chain -------------------------------------------------------------------


def _conj_t(t: torch.Tensor) -> torch.Tensor:
    """conj(t) of a transmission stack: the conjugated planes, or the
    negated phase."""
    return torch.conj_physical(t) if t.is_complex() else -t


def _adjoint_chain(passes, a_exit, lam_ct, potential_szy, kxs, kys, sigma,
                   lam, dz, ksq, tantilt):
    """The backward chain on ``passes`` = (row, col, row_bwd). Slices are
    consumed in the order V_{nz-1} .. V_1; vbar_z lands at index z."""
    row, col, row_bwd = passes
    n_probes, nx, ny = a_exit.shape
    nz = potential_szy.shape[0]
    if nz < 2:
        raise ValueError("the adjoint chain needs nz >= 2")
    w = torch.stack([a_exit, lam_ct], dim=1).to(torch.complex64)
    w = w.reshape(2 * n_probes, nx, ny).contiguous()
    t = _conj_t(transmission_stack(sigma, potential_szy[1:].flip(0)))
    prop = torch.conj_physical(fresnel_plane(kxs, kys, lam, dz, ksq, None,
                                             tantilt, device=w.device))
    vbar = torch.empty((nz - 1, nx, ny), dtype=torch.float32, device=w.device)
    w = row("first", w, t[0], w)
    for s in range(1, nz - 1):
        w = col(w, prop, w)
        w, _ = row_bwd("mid", w, t[s], sigma, w, vbar[nz - 1 - s])
    w = col(w, prop, w)
    w, _ = row_bwd("last", w, None, sigma, w, vbar[0])
    return w.reshape(n_probes, 2, nx, ny)[:, 1], vbar


_KERNEL_PASSES = (row_pass, col_pass, row_pass_bwd)
_KERNEL_PASSES_ODD = (row_pass_mr, col_pass_mr, row_pass_mr_bwd)
_PLAIN_PASSES = (_plain_row_pass, _plain_col_pass, _plain_row_pass_bwd)


def fused_adjoint_chain(a_exit, lam_ct, potential_szy, kxs, kys, *,
                        sigma: float, lam: float, dz: float, ksq=None,
                        tantilt=None):
    """The backward chain on A, B and K7.

    a_exit: (P, nx, ny) complex64 exit wave; lam_ct: (P, nx, ny) its grad;
    potential_szy: (nz, nx, ny) forward-ordered potential, nz >= 2.
    Returns (lam0, vbar): the grad of the wave entering slice 0's
    transmission ((P, nx, ny) complex64; the caller applies conj(t_0)), and
    vbar_z for z = 0 .. nz-2 ((nz-1, nx, ny) float32; the caller appends
    vbar_{nz-1} from the exit pair)."""
    return _adjoint_chain(_KERNEL_PASSES, a_exit, lam_ct, potential_szy,
                          kxs, kys, sigma, lam, dz, ksq, tantilt)


def fused_adjoint_chain_odd(a_exit, lam_ct, potential_szy, kxs, kys, *,
                            sigma: float, lam: float, dz: float, ksq=None,
                            tantilt=None):
    """``fused_adjoint_chain`` on K4, K5 and K8 (mixed-radix grids)."""
    return _adjoint_chain(_KERNEL_PASSES_ODD, a_exit, lam_ct, potential_szy,
                          kxs, kys, sigma, lam, dz, ksq, tantilt)


def fused_adjoint_chain_plain(a_exit, lam_ct, potential_szy, kxs, kys, *,
                              sigma: float, lam: float, dz: float, ksq=None,
                              tantilt=None):
    """``fused_adjoint_chain`` through the plain versions on any device:
    the reference both chains are held to (K4, K5 and K8 have the plain
    versions of A, B and K7)."""
    return _adjoint_chain(_PLAIN_PASSES, a_exit, lam_ct, potential_szy, kxs,
                          kys, sigma, lam, dz, ksq, tantilt)
