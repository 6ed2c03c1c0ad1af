"""The resident slice loop: every slice of a frame in one CUDA launch (K6).

Counterpart of ``pyslice_tpu/ops/fused_step_resident.py`` (power-of-two
grids) and, through ``ops.fused_step_odd_resident``, of
``pyslice_tpu/ops/fused_step_odd_resident.py`` (odd and mixed-radix
grids). The chain (``ops.fused_step`` / ``ops.fused_step_odd``) costs two
launches a slice; with one probe the work per launch is small and the
launches dominate. K6 (``csrc/resident.cu``) runs the whole loop in one
persistent cooperative launch per frame: row phase, grid barrier, column
phase, grid barrier, per slice, with the k-space conversion (FFT_x and the
fftshift) optionally in the same launch. The wave lives in a device
buffer the wrapper allocates, which stays in the 50 MB L2 at the sizes
the dispatch sends here. The kernel is templated on the FFT engine: the
radix-16 engine of kernel C for power-of-two grids (the JAX kernel
#5) and the Stockham engine of K4/K5 otherwise (the JAX kernel #8).

``resident_loop`` takes its plain version (the same phases as plain
torch.fft passes) for a tensor on the CPU, and for a CUDA tensor launches
K6 or raises; ``launches["k6"]`` counts its launches and ``last_launch``
holds the grid of the latest one.

Limits. The JAX kernels are gated by VMEM estimates (``MAX_PIXELS``,
``MAX_AXIS`` 2048, ``_vmem_estimate``, ``KSPACE_BUDGET``): TPU limits, not
ported. K6's own limits are the engines' axis sizes (powers of two 128 to
4096; the K4/K5 sizes up to 4096), ``nz >= 2`` (shorter stacks go to the
chain, as in the JAX package) and a tile within shared memory, which holds
at every size the engines take. The cooperative grid is at most the
occupancy-limited number of resident blocks; a launch asked for more
raises. Above ~50 MB of wave the state no longer fits L2 and K6 is still
right but slower: ``resident_preferred`` keeps the dispatch below that.
"""

from __future__ import annotations

import ctypes

import torch

from .fused_step import (_check_cuda, _check_state, _out_for,
                         _plain_col_pass, _plain_kconvert, _plain_row_pass,
                         _twiddles, build, fresnel_plane, fused_multislice,
                         fused_multislice_kspace, launches,
                         record_layers_chain, supported_size,
                         transmission_stack)
from .fused_step_odd import MR_SIZES, supported_size_mr

# The grid of the latest K6 launch: blocks, blocks per SM the occupancy
# query allowed, SMs, dynamic shared memory bytes, row and column tile
# widths.
last_launch = {}

_COOPERATIVE_LAUNCH_TOO_LARGE = 720   # cudaErrorCooperativeLaunchTooLarge


def resident_supported(nx: int, ny: int, nz: int) -> bool:
    """Power-of-two grids K6 takes (its radix-16 instantiation)."""
    return supported_size(nx) and supported_size(ny) and nz >= 2


def resident_preferred(n_probes: int, nx: int, ny: int) -> bool:
    """The JAX package's crossover against the chain
    (``fused_step_resident.resident_preferred``, measured on a TPU):
    resident at <= 2^18-pixel grids or below ~3M probe-pixels. Kept as it
    is until the card's own crossover is measured."""
    px = nx * ny
    return px <= (1 << 18) or n_probes * px < 3 * (1 << 20)


# --- K6 and its plain version ----------------------------------------------------


def _plain_resident_loop(psi, t, prop, kspace: bool = False) -> torch.Tensor:
    """K6's plain version: the same phases as plain torch.fft passes."""
    nz = t.shape[0]
    state = _plain_row_pass("first", psi, t[0])
    for s in range(1, nz):
        state = _plain_col_pass(state, prop)
        last = s == nz - 1 and not kspace
        state = _plain_row_pass("last" if last else "mid", state, t[s])
    return _plain_kconvert(state) if kspace else state


def resident_loop(psi: torch.Tensor, t: torch.Tensor, prop: torch.Tensor,
                  kspace: bool = False, blocks=None) -> torch.Tensor:
    """K6: the whole slice loop of one frame in one cooperative launch.

    psi: (P, nx, ny) complex64 probes (not overwritten); t: the
    (nz >= 2, nx, ny) complex64 transmission stack or float32 phase stack
    sigma*V; prop: the natural-order (nx, ny) complex64 Fresnel plane.
    Returns the exit wave, or with ``kspace`` fftshift(fft2(exit wave)).
    ``blocks`` overrides the grid size (the occupancy-limited maximum by
    default; more raises)."""
    if psi.device.type == "cpu":
        return _plain_resident_loop(psi, t, prop, kspace)
    _check_state(psi, lambda n: supported_size_mr(n, psi.shape[0]),
                 MR_SIZES)
    n_probes, nx, ny = psi.shape
    pow2 = supported_size(nx) and supported_size(ny)
    nz = t.shape[0] if t.dim() == 3 else 0
    if nz < 2:
        raise ValueError(f"resident_loop needs a (nz >= 2, {nx}, {ny}) "
                         f"stack, got {tuple(t.shape)}")
    phase = not t.is_complex()
    _check_cuda(t, "t", (nz, nx, ny),
                torch.float32 if phase else torch.complex64, psi.device)
    _check_cuda(prop, "prop", (nx, ny), torch.complex64, psi.device)
    out = _out_for(psi, None)
    state = torch.empty_like(psi)
    info = (ctypes.c_int * 6)()
    lib = build().libs["resident"]
    with torch.cuda.device(psi.device):
        err = lib.fs_resident_loop(
            out.data_ptr(), state.data_ptr(), psi.data_ptr(),
            None if phase else t.data_ptr(), t.data_ptr() if phase else None,
            prop.data_ptr(),
            _twiddles(nx, psi.device, full=not pow2).data_ptr(),
            _twiddles(ny, psi.device, full=not pow2).data_ptr(),
            n_probes, nx, ny, nz, int(pow2), int(kspace), int(blocks or 0),
            ctypes.addressof(info), torch.cuda.current_stream().cuda_stream)
    last_launch.clear()
    last_launch.update(zip(("grid", "blocks_per_sm", "sms", "smem_bytes",
                            "row_tile", "col_tile"), info))
    last_launch["engine"] = "pow2" if pow2 else "mixed"
    if err == _COOPERATIVE_LAUNCH_TOO_LARGE:
        raise RuntimeError(
            f"resident_loop (K6): cooperative launch too large: grid "
            f"{info[0]} > {info[1]} blocks/SM x {info[2]} SMs")
    if err != 0:
        raise RuntimeError(f"resident_loop (K6) kernel launch failed: CUDA "
                           f"error {err}")
    launches["k6"] += 1
    return out


# --- entry points --------------------------------------------------------------


def resident_multislice(psi, potential_szy, kxs, kys, *, sigma, lam, dz,
                        ksq=None, kmax2=None, tantilt=None,
                        kspace=False) -> torch.Tensor:
    """One frame through ``resident_loop``: the per-frame transmission
    stack and Fresnel plane, then the loop."""
    psi = psi.to(torch.complex64).contiguous()
    t = transmission_stack(sigma, potential_szy)
    prop = fresnel_plane(kxs, kys, lam, dz, ksq, kmax2, tantilt,
                         device=psi.device)
    return resident_loop(psi, t, prop, kspace)


def _check_grid(psi, nz) -> None:
    nx, ny = psi.shape[-2:]
    if not resident_supported(nx, ny, nz):
        raise ValueError(f"unsupported grid {nx}x{ny} for resident path")


def fused_multislice_resident(psi, potential_szy, kxs, kys, *, sigma: float,
                              lam: float, dz: float, record_layers=None,
                              ksq=None, kmax2=None, tantilt=None
                              ) -> torch.Tensor:
    """Resident counterpart of ``fused_step.fused_multislice`` on
    power-of-two grids: the exit wave, or (n_layers, n_probes, nx, ny)
    snapshots with ``record_layers`` (segment chaining). Stacks of one
    slice go to the chain."""
    if record_layers is not None:
        return record_layers_chain(fused_multislice_resident, psi,
                                   potential_szy, kxs, kys, sigma, lam, dz,
                                   ksq, record_layers, kmax2=kmax2,
                                   tantilt=tantilt)
    kw = dict(sigma=sigma, lam=lam, dz=dz, ksq=ksq, kmax2=kmax2,
              tantilt=tantilt)
    if potential_szy.shape[0] < 2:
        return fused_multislice(psi, potential_szy, kxs, kys, **kw)
    _check_grid(psi, potential_szy.shape[0])
    return resident_multislice(psi, potential_szy, kxs, kys, **kw)


def fused_multislice_kspace_resident(psi, potential_szy, kxs, kys, *,
                                     sigma: float, lam: float, dz: float,
                                     ksq=None, kmax2=None, tantilt=None
                                     ) -> torch.Tensor:
    """fftshift(fft2(fused_multislice_resident(...))) with the conversion
    in the same launch. Stacks of one slice go to the chain."""
    kw = dict(sigma=sigma, lam=lam, dz=dz, ksq=ksq, kmax2=kmax2,
              tantilt=tantilt)
    if potential_szy.shape[0] < 2:
        return fused_multislice_kspace(psi, potential_szy, kxs, kys, **kw)
    _check_grid(psi, potential_szy.shape[0])
    return resident_multislice(psi, potential_szy, kxs, kys, kspace=True,
                               **kw)
