"""The mixed-radix slice-step chain: kernels K4 and K5 in CUDA C++.

Counterpart of ``pyslice_tpu/ops/fused_step_odd.py``. The same two-pass
chain as ``ops.fused_step`` (A first / B / A mid ... / A last), on grids
whose axes are not powers of two: the reference-natural ``int(l/s) + 1``
grids (odd composite, e.g. 1023 = 3 * 11 * 31) and the n1*128 sizes
(384, 1152, ...) that the JAX package gives to its aligned kernels.

    K4 ``row_pass_mr``: kernel A's four modes (first / mid / last / only)
    K5 ``col_pass_mr``: kernel B, IFFT_x(P * FFT_x(.))

The kernels (``csrc/fused_step_odd.cu``) run a mixed-radix Stockham FFT in
shared memory (``csrc/fft_mixed.cuh``): natural order in and out, so the
wave, the transmission planes and the Fresnel plane all stay in natural
order and nothing is permuted. Both run as persistent blocks whose
producer warps store the previous tile and copy the next one into shared
memory (``cp.async``) while the consumer warps transform the current one
(``csrc/tile_async.cuh``): K4 on tiles of rows, K5 on tiles of columns.
Their tile widths and consumer counts are the host's plan, ``tile_plan``.
The JAX kernels' digit-split layouts and scrambled frequency order were
limits of Pallas on the TPU and are not ported. There is no fused k-space
conversion on this chain (the JAX package has none either):
``engine.pipeline`` converts its exit wave with ``torch.fft``.

Each wrapper takes its plain ``torch.fft`` version (kernel A's and B's) for
a tensor on the CPU, and for a CUDA tensor launches its kernel or raises.
``launches["k4"]`` / ``launches["k5"]`` count the kernel launches;
``last_launch["k4"]`` / ``last_launch["k5"]`` hold each one's last plan and
persistent grid.

Sizes (``supported_size_mr``): every axis the JAX package gives a kernel,
up to 4096 (the engine's shared-memory limit): the JAX odd kernels' rule
(``supported_size_odd``, with the divisor rule of its
``matfft.scrambled_factors``), and the JAX aligned kernels' n1*128 rule.
Primes such as 1009, which the JAX package sends to XLA, are left to the
plain path. Of these sizes, dispatch gives the kernels only those whose
stages all run in registers (``kernel_preferred_mr``): a larger prime runs
as a direct sum, which loses to the plain passes.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from .fused_step import (_check_cuda, _check_state, _chain, _out_for,
                         _plain_col_pass, _plain_row_pass, _raise_on,
                         _twiddles, build, last_launch, launches,
                         record_layers_chain, ROW_MODES)

# The engine's limit: one row of 4096 in two shared-memory buffers, 64 KB.
MAX_AXIS = 4096


# --- eligibility (the JAX package's size rules, as plain functions) -----------


def _fused_split_cost(d: int, m: int) -> float:
    """The JAX package's per-point cost model of a (d, m) split
    (``matfft._fused_split_cost``); here it only decides eligibility."""
    tiles = -(-m // 128)
    mxu = tiles * tiles * 16384.0 / m
    pad = (-(-m // 8) * 8) * (tiles * 128.0) / (m * m)
    return mxu + 15.0 * d * pad


def scrambled_factors(n: int, n_probes: int = None):
    """(d, m), n = d * m, as ``matfft.scrambled_factors`` picks it: the
    smallest divisor 2 <= d <= 16 of n, or for ``n_probes >= 2`` the split
    the cost model prefers by at least 10%; (n, 1) when n has none."""
    divisors = [d for d in range(2, 17) if n % d == 0]
    if not divisors:
        return (n, 1)
    d0 = divisors[0]
    if n_probes is not None and n_probes >= 2:
        fused = [d for d in divisors
                 if n // d >= 64
                 and n * (n // d) * 4 * 17 < 60 * 1024 * 1024]
        if d0 in fused and len(fused) > 1:
            best = min(fused, key=lambda d: _fused_split_cost(d, n // d))
            if _fused_split_cost(best, n // best) < \
                    0.9 * _fused_split_cost(d0, n // d0):
                d0 = best
    return (d0, n // d0)


def supported_size_odd(n: int, n_probes: int = None) -> bool:
    """The JAX odd kernels' size rule (``fused_step_odd.supported_size_odd``,
    without its measurement-only ``scrambled_d`` override): a divisor split
    d <= 16 with m >= 128, or m >= 64 where the multi-probe cost model
    picks a split other than the smallest divisor."""
    d, m = scrambled_factors(n, n_probes)
    footprint = n * m * 4 * (5 + 12)
    if n_probes is not None and n_probes >= 2 and d != scrambled_factors(n)[0]:
        min_m = 64
    else:
        min_m = 128
    return 1 < d <= 16 and m >= min_m and footprint < 60 * 1024 * 1024


def supported_size_mr(n: int, n_probes: int = None) -> bool:
    """Axis lengths K4 and K5 take: what the JAX package gives its odd or
    aligned kernels, up to MAX_AXIS."""
    return 2 <= n <= MAX_AXIS and (n % 128 == 0
                                   or supported_size_odd(n, n_probes))


MR_SIZES = "the JAX kernels' sizes up to 4096"


# --- the tile plans of K4 and K5, and the routing rule ---------------------------

# The limits of K4 and K5 (csrc/fused_step_odd.cu): consumer threads a
# block (their __launch_bounds__ of 384, less three producer warps), tile
# buffers, the widest tile (2^3 lanes), and the shared memory a block may
# opt in to on an H100 (227 KB).
TILE_THREADS = 288
TILE_BUFFERS = 3
TILE_MAX_LOGC = 3
SMEM_MAX = 232448

# The largest stage radix of an axis that dispatch gives the mixed-radix
# kernels: every stage in registers. Every larger prime runs as a direct
# sum, and at each one measured the kernels lost to their plain versions
# (scripts/time_col_pass_mr.py --plain, H100 at 700 W, PERF.md: at
# 16 x 999^2, prime 37, K4 1.47 ms against 0.51 plain and K5 1.84 against
# 0.88; at 16 x 1018^2, prime 509, 14.3 against 0.80 and 19.6 against 1.18).
KERNEL_MAX_RADIX = 31

# The last launch of each kernel is kept in ``last_launch`` (shared with A
# and B, ops.fused_step; K8's: ops.fused_step_adjoint): the plan (lanes,
# threads, busy, tiles, table) and the grid the occupancy query gave (grid,
# blocks_per_sm, sms, smem_bytes).


def stage_radices(n: int) -> list:
    """The Stockham stages of an axis of n, in order (``make_plan`` of
    ``csrc/fft_mixed.cuh``): 16s, then one each of 8, 4, 2, then the odd
    primes 31 down to 3, then any larger prime."""
    f, m = [], n
    while m % 16 == 0:
        f.append(16)
        m //= 16
    for r in (8, 4, 2):
        if m % r == 0:
            f.append(r)
            m //= r
    for r in (31, 29, 23, 19, 17, 13, 11, 7, 5, 3):
        while m % r == 0:
            f.append(r)
            m //= r
    r = 37
    while m > 1:
        while m % r == 0:
            f.append(r)
            m //= r
        r += 2
    return f


def kernel_preferred_mr(n: int) -> bool:
    """Whether dispatch gives an axis of n (one ``supported_size_mr``
    admits) to the mixed-radix kernels K4, K5, K6 and K8: its largest stage
    radix is at most KERNEL_MAX_RADIX, so no stage is a direct sum. The
    threshold is the measurement of ``scripts/time_col_pass_mr.py
    --plain`` (each kernel against its plain version at primes 37 to 509;
    PERF.md)."""
    return max(stage_radices(n)) <= KERNEL_MAX_RADIX


@dataclasses.dataclass(frozen=True)
class TilePlan:
    logc: int           # the tile is 2^logc lanes: columns (K5), rows (K4),
                        # row r's pair members at 2r, 2r + 1 (K8)
    threads: int        # a block's consumer threads (and three producer warps)
    smem_bytes: int     # TILE_BUFFERS tile buffers, the twiddle table (K8:
                        # where shared_table) and K8's vbar rows
    tiles: int          # (probe, tile) pairs; K8: row tiles, each walked
                        # through every pair
    busy: float         # share of the threads busy in the fewest-item stage
    shared_table: bool = True   # the twiddle table in shared memory, else
                                # device memory (K8 above n = 3874)

    @property
    def lanes(self) -> int:
        return 1 << self.logc


def _tile_smem(n: int, logc: int) -> int:
    """The shared memory of K4 and K5: the tile buffers and the twiddle
    table."""
    return 8 * (TILE_BUFFERS * (n << logc) + n)


def _busy(n: int, logc: int) -> float:
    """The share of TILE_THREADS consumers busy in the stage with the
    fewest items (a radix-R stage in registers has n/R items a lane, a
    larger prime n)."""
    items = min((n // r if r <= 31 else n) << logc for r in stage_radices(n))
    return items / (TILE_THREADS * -(-items // TILE_THREADS))


def tile_plan(n: int, n_probes: int, lanes: int) -> TilePlan:
    """The tile of K4 or K5 on transforms of length n (K4: ny, K5: nx) for
    n_probes x ``lanes`` of them (K4: nx rows, K5: ny columns): the widest,
    up to 2^TILE_MAX_LOGC lanes, whose TILE_BUFFERS buffers fit SMEM_MAX
    beside the n-entry twiddle table, and TILE_THREADS consumer threads.
    ``busy`` is their share that works in the stage with the fewest items
    (a radix-R stage in registers has n/R items a lane, a larger prime n).
    At 1023 = 3 * 11 * 31: 8 lanes, 264 radix-31 items on 288 threads, 92%
    busy."""
    logc = TILE_MAX_LOGC
    while logc > 0 and _tile_smem(n, logc) > SMEM_MAX:
        logc -= 1
    return TilePlan(logc=logc, threads=TILE_THREADS,
                    smem_bytes=_tile_smem(n, logc),
                    tiles=n_probes * -(-lanes // (1 << logc)),
                    busy=_busy(n, logc))


def _pair_smem(n: int, logc: int, shared_table: bool = True) -> int:
    """The shared memory of K8 (csrc/fused_step_adjoint_odd.cu): the tile
    buffers, the twiddle table where it sits there, and 2^(logc-1) vbar
    rows of n float32."""
    return (8 * (TILE_BUFFERS * (n << logc) + (n if shared_table else 0))
            + 4 * (n << (logc - 1)))


def pair_tile_plan(n: int, nx: int) -> TilePlan:
    """K8's tile on pair rows of n (ny), nx rows a plane: 2^logc lanes,
    row r's members (a, lambda) at lanes 2r and 2r + 1, so at least 2. The
    widest, up to 2^TILE_MAX_LOGC lanes, whose TILE_BUFFERS buffers, n-entry
    twiddle table and 2^(logc-1) vbar rows fit SMEM_MAX: 8 lanes (4 rows)
    up to n = 1076 (220,968 bytes at 1023), 4 up to 2075, 2 up to 3874
    (60 n bytes). Above that not even 2 lanes fit beside the table, and it
    stays in device memory (``shared_table`` False; 52 n bytes, 212,992 at
    4096). ``tiles`` counts row tiles, the units of the
    persistent walk: a block takes each of its row tiles through every pair
    in order."""
    logc = TILE_MAX_LOGC
    while logc > 1 and _pair_smem(n, logc) > SMEM_MAX:
        logc -= 1
    shared = _pair_smem(n, logc) <= SMEM_MAX
    return TilePlan(logc=logc, threads=TILE_THREADS,
                    smem_bytes=_pair_smem(n, logc, shared),
                    tiles=-(-nx // (1 << (logc - 1))), busy=_busy(n, logc),
                    shared_table=shared)


def record_launch(kernel: str, plan: TilePlan, info) -> None:
    """Keep a launch's plan and grid (``info``: grid, blocks per SM, SMs,
    shared memory bytes) in ``last_launch[kernel]``."""
    rec = last_launch[kernel]
    rec.clear()
    rec.update(lanes=plan.lanes, threads=plan.threads, busy=plan.busy,
               tiles=plan.tiles,
               table="shared" if plan.shared_table else "device")
    rec.update(zip(("grid", "blocks_per_sm", "sms", "smem_bytes"), info))


# --- wrappers ------------------------------------------------------------------


def row_pass_mr(mode: str, state: torch.Tensor, t: torch.Tensor,
                out=None) -> torch.Tensor:
    """K4 on a (P, nx, ny) complex64 wave: kernel A's ``mode`` with the
    mixed-radix engine. ``t``: the (nx, ny) complex64 transmission plane,
    or the float32 phase sigma*V. ``out`` may be ``state`` (in place)."""
    if mode not in ROW_MODES:
        raise ValueError(f"row_pass_mr mode must be one of {list(ROW_MODES)}")
    if state.device.type == "cpu":
        return _plain_row_pass(mode, state, t, out)
    _check_state(state, lambda n: supported_size_mr(n, state.shape[0]),
                 MR_SIZES)
    n_probes, nx, ny = state.shape
    phase = not t.is_complex()
    _check_cuda(t, "t", (nx, ny), torch.float32 if phase else torch.complex64,
                state.device)
    out = _out_for(state, out)
    plan = tile_plan(ny, n_probes, nx)
    info = (ctypes.c_int * 4)()
    lib = build().libs["fused_step_odd"]
    with torch.cuda.device(state.device):
        err = lib.fs_row_pass_mr(
            out.data_ptr(), state.data_ptr(),
            None if phase else t.data_ptr(), t.data_ptr() if phase else None,
            _twiddles(ny, state.device, full=True).data_ptr(), n_probes, nx,
            ny, ROW_MODES[mode], plan.logc, plan.threads,
            ctypes.addressof(info), torch.cuda.current_stream().cuda_stream)
    record_launch("k4", plan, info)
    _raise_on(err, "row_pass_mr (K4)")
    launches["k4"] += 1
    return out


def col_pass_mr(state: torch.Tensor, prop: torch.Tensor,
                out=None) -> torch.Tensor:
    """K5: IFFT_x(prop * FFT_x(state)) with the mixed-radix engine; ``prop``
    the natural-order (nx, ny) complex64 Fresnel plane. ``out`` may be
    ``state``."""
    if state.device.type == "cpu":
        return _plain_col_pass(state, prop, out)
    _check_state(state, lambda n: supported_size_mr(n, state.shape[0]),
                 MR_SIZES)
    n_probes, nx, ny = state.shape
    _check_cuda(prop, "prop", (nx, ny), torch.complex64, state.device)
    out = _out_for(state, out)
    plan = tile_plan(nx, n_probes, ny)
    info = (ctypes.c_int * 4)()
    lib = build().libs["fused_step_odd"]
    with torch.cuda.device(state.device):
        err = lib.fs_col_pass_mr(
            out.data_ptr(), state.data_ptr(), prop.data_ptr(),
            _twiddles(nx, state.device, full=True).data_ptr(), n_probes, nx,
            ny, plan.logc, plan.threads, ctypes.addressof(info),
            torch.cuda.current_stream().cuda_stream)
    record_launch("k5", plan, info)
    _raise_on(err, "col_pass_mr (K5)")
    launches["k5"] += 1
    return out


# --- the chain -------------------------------------------------------------------

_KERNEL_PASSES = (row_pass_mr, col_pass_mr, None)
_PLAIN_PASSES = (_plain_row_pass, _plain_col_pass, None)


def _run(passes, fn, psi, potential_szy, kxs, kys, sigma, lam, dz,
         record_layers, ksq, kmax2, tantilt):
    if record_layers is not None:
        return record_layers_chain(fn, psi, potential_szy, kxs, kys, sigma,
                                   lam, dz, ksq, record_layers, kmax2=kmax2,
                                   tantilt=tantilt)
    return _chain(passes, psi, potential_szy, kxs, kys, sigma, lam, dz, ksq,
                  kmax2, tantilt, kspace=False)


def fused_multislice_odd(psi, potential_szy, kxs, kys, *, sigma: float,
                         lam: float, dz: float, record_layers=None, ksq=None,
                         kmax2=None, tantilt=None) -> torch.Tensor:
    """The K4/K5 chain, same contract as ``fused_step.fused_multislice``
    (depth recording by segment chaining included): the exit wave, or
    (n_layers, n_probes, nx, ny) snapshots with ``record_layers``."""
    n_probes, nx, ny = psi.shape
    if not (supported_size_mr(nx, n_probes) and supported_size_mr(ny, n_probes)):
        raise ValueError(f"unsupported grid {nx}x{ny} for fused odd path")
    return _run(_KERNEL_PASSES, fused_multislice_odd, psi, potential_szy,
                kxs, kys, sigma, lam, dz, record_layers, ksq, kmax2, tantilt)


def fused_multislice_odd_plain(psi, potential_szy, kxs, kys, *, sigma: float,
                               lam: float, dz: float, record_layers=None,
                               ksq=None, kmax2=None, tantilt=None
                               ) -> torch.Tensor:
    """``fused_multislice_odd`` through the plain versions of K4 and K5 on
    any device (the reference the kernels are held to)."""
    return _run(_PLAIN_PASSES, fused_multislice_odd_plain, psi,
                potential_szy, kxs, kys, sigma, lam, dz, record_layers, ksq,
                kmax2, tantilt)

