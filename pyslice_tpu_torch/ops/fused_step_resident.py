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
the dispatch sends here. Each phase runs the engine of the chain's own
passes: on power-of-two grids (the JAX kernel #5) the register engine of
kernels A and B, on other grids (the JAX kernel #8) the persistent
mixed-radix tiles of K4 and K5. ``resident_plan`` sizes the launch.

``resident_loop`` takes its plain version (the same phases as plain
torch.fft passes) for a tensor on the CPU, and for a CUDA tensor launches
K6 or raises; ``launches["k6"]`` counts its launches and ``last_launch``
holds the plan and grid of the latest one.

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
import dataclasses

import torch

from .fused_step import (_check_cuda, _check_state, _out_for,
                         _plain_col_pass, _plain_kconvert, _plain_row_pass,
                         _twiddles, build, fresnel_plane, fused_multislice,
                         fused_multislice_kspace, launches,
                         record_layers_chain, reg_smem, supported_size,
                         transmission_stack, REG_VALUES, ROW_BOUND)
from .fused_step_odd import (MR_SIZES, SMEM_MAX, TILE_BUFFERS, TILE_MAX_LOGC,
                             TILE_THREADS, supported_size_mr)

# The plan and grid of the latest K6 launch: the ResidentPlan's fields, and
# the grid, blocks per SM the occupancy query allowed, SMs and dynamic
# shared memory bytes of the launch itself.
last_launch = {}

_COOPERATIVE_LAUNCH_TOO_LARGE = 720   # cudaErrorCooperativeLaunchTooLarge

# K6's block (csrc/resident.cu). Power-of-two grids: at most A's launch
# bound of 128 threads (three blocks an SM at 168 registers), at least one
# warp. Other grids: K4's and K5's, TILE_THREADS consumers and three
# producer warps.
RES_MAX_THREADS = ROW_BOUND[0]
RES_MIN_THREADS = 32
RES_PRODUCERS = 96


@dataclasses.dataclass(frozen=True)
class ResidentPlan:
    engine: str         # "pow2" (the register engine) or "mixed" (the tiles)
    threads: int        # a block, producers included
    producers: int      # of them, the producer threads ("mixed")
    row_lanes: int      # rows a row tile
    col_lanes: int      # columns a column tile
    row_tiles: int      # (probe, row tile) pairs of a row phase
    col_tiles: int      # (probe, column tile) pairs of a column phase
    smem_bytes: int     # dynamic shared memory of a block
    grid: int           # blocks: at most blocks_per_sm x SMs, and no more
                        # than the larger phase's tiles


def _tiles(n_probes: int, lines: int, lanes: int) -> int:
    """(probe, tile) pairs of a phase: tiles of ``lanes`` of its ``lines``
    rows or columns a probe, the last one ragged."""
    return n_probes * -(-lines // lanes)


def resident_plan(n_probes: int, nx: int, ny: int, sms: int = 132,
                  blocks_per_sm: int = 1, phase: bool = False
                  ) -> ResidentPlan:
    """K6's launch for n_probes x nx x ny on a card of ``sms`` SMs, of
    which each holds ``blocks_per_sm`` blocks (the occupancy query's
    answer on the card; it sets only ``grid``). ``phase``: the t stack is
    the float32 phase sigma*V.

    Power-of-two grids (both axes 128 to 4096): one block of 2^logc lanes
    of n / 32 threads serves both phases, a row tile 2^logc_r rows of
    ny / 32 threads each and a column tile 2^logc_c columns of nx / 32, at
    most RES_MAX_THREADS; it halves, down to one warp or one lane of the
    longer axis, only while a phase would have fewer tiles than a quarter
    of the SMs (measured on an H100, PERF.md: at 1 x 512^2 the 128-thread
    block, 64 tiles a phase, beat 64 and 32 threads; at 1 x 256^2 one
    warp, 64 tiles, beat 16 tiles of 128 threads). Shared memory: the exchange
    buffer (the same on both axes) and, with the phase, 32 factor slots a
    thread. At 1 x 1024^2: 128 threads, 4 rows, 4 columns, 256 tiles a
    phase, 33,792 bytes.

    Other grids: K4's and K5's block (TILE_THREADS consumers and
    RES_PRODUCERS producers), TILE_BUFFERS buffers of the larger tile and
    both twiddle tables within SMEM_MAX; each tile as wide as that allows,
    up to 2^TILE_MAX_LOGC lanes, narrowed only while the narrower tiling
    still has no more tiles than SMs, so that each tile keeps a block of
    its own (measured on an H100, PERF.md: at 1 x 1023^2 8 lanes, one tile
    a block, were faster than 4 lanes, two tiles a block, and than 2; at
    1 x 387^2 4 lanes, one tile a block, beat 8 and 2). At
    1 x 1023^2: 8 rows and 8 columns, 128 tiles a phase, 212,784 bytes."""
    if supported_size(nx) and supported_size(ny):
        tx, ty = nx // REG_VALUES, ny // REG_VALUES
        least = max(RES_MIN_THREADS, tx, ty)
        threads = max(RES_MAX_THREADS, least)
        while (threads > least
               and 4 * n_probes * min(nx * ty, ny * tx) // threads < sms):
            threads //= 2
        rl, cl = threads // ty, threads // tx
        smem = reg_smem(ny, rl.bit_length() - 1, factors=phase)
        return _plan("pow2", threads, 0, rl, cl, n_probes, nx, ny, smem,
                     sms, blocks_per_sm)
    table = 8 * (nx + ny)

    def widest(n, lines):
        logc = TILE_MAX_LOGC
        while logc > 0 and 8 * TILE_BUFFERS * (n << logc) + table > SMEM_MAX:
            logc -= 1
        while (logc > 0
               and _tiles(n_probes, lines, 1 << (logc - 1)) <= sms):
            logc -= 1
        return 1 << logc

    rl, cl = widest(ny, nx), widest(nx, ny)
    smem = 8 * TILE_BUFFERS * max(ny * rl, nx * cl) + table
    return _plan("mixed", TILE_THREADS + RES_PRODUCERS, RES_PRODUCERS, rl,
                 cl, n_probes, nx, ny, smem, sms, blocks_per_sm)


def _plan(engine, threads, producers, rl, cl, n_probes, nx, ny, smem, sms,
          blocks_per_sm) -> ResidentPlan:
    rt = _tiles(n_probes, nx, rl)
    ct = _tiles(n_probes, ny, cl)
    return ResidentPlan(engine=engine, threads=threads, producers=producers,
                        row_lanes=rl, col_lanes=cl, row_tiles=rt,
                        col_tiles=ct, smem_bytes=smem,
                        grid=min(blocks_per_sm * sms, max(rt, ct)))


_sms_cache = {}


def _sms(device: torch.device) -> int:
    if device not in _sms_cache:
        _sms_cache[device] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return _sms_cache[device]


def resident_supported(nx: int, ny: int, nz: int) -> bool:
    """Power-of-two grids K6 takes (its register-engine instantiation)."""
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
    plan = resident_plan(n_probes, nx, ny, _sms(psi.device), phase=phase)
    info = (ctypes.c_int * 4)()
    lib = build().libs["resident"]
    with torch.cuda.device(psi.device):
        err = lib.fs_resident_loop(
            out.data_ptr(), state.data_ptr(), psi.data_ptr(),
            None if phase else t.data_ptr(), t.data_ptr() if phase else None,
            prop.data_ptr(),
            _twiddles(nx, psi.device, full=not pow2).data_ptr(),
            _twiddles(ny, psi.device, full=not pow2).data_ptr(),
            n_probes, nx, ny, nz, int(pow2), int(kspace), plan.threads,
            plan.row_lanes.bit_length() - 1, plan.col_lanes.bit_length() - 1,
            int(blocks or 0), ctypes.addressof(info),
            torch.cuda.current_stream().cuda_stream)
    last_launch.clear()
    last_launch.update(dataclasses.asdict(plan))
    last_launch.update(zip(("grid", "blocks_per_sm", "sms", "smem_bytes"),
                           info))
    last_launch.update(nz=nz, kspace=bool(kspace))
    if err == _COOPERATIVE_LAUNCH_TOO_LARGE:
        raise RuntimeError(
            f"resident_loop (K6): cooperative launch too large: grid "
            f"{info[0]} > {info[1]} blocks/SM x {info[2]} SMs")
    if err != 0:
        raise RuntimeError(f"resident_loop (K6) kernel launch failed: CUDA "
                           f"error {err}")
    launches["k6"] += 1
    return out


def barrier_floor() -> None:
    """The grid barriers of the latest K6 launch alone (its grid, block and
    shared memory; 2 nz - 2 barriers, one more with k space), launched on
    the current stream: K6's floor for timing. Counts no K6 launch."""
    ll = last_launch
    syncs = 2 * ll["nz"] - 2 + int(ll["kspace"])
    err = build().libs["resident"].fs_resident_barriers(
        ll["grid"], ll["threads"], ll["smem_bytes"], syncs,
        torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"K6 barrier floor launch failed: CUDA error "
                           f"{err}")


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
