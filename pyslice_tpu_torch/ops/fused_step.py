"""The fused multislice slice step: kernels A, B and C in CUDA C++.

Counterpart of ``pyslice_tpu/ops/fused_step.py``. The slice step
psi <- ifft2(P * fft2(t_s * psi)) runs as a chain of two passes per slice
over the (P, nx, ny) wave, each reading and writing it once:

    A first :  x t_1, FFT_y               (row pass)
    B       :  FFT_x, x P, IFFT_x         (column pass)
    A mid   :  IFFT_y, x t_s, FFT_y
    A last  :  IFFT_y, x t_nz             -> exit wave
    A only  :  x t_1                      (nz == 1)

and, for k-space exit waves, the last A runs as ``mid`` and C adds FFT_x
with the fftshift of both axes folded into its store.

The kernels (``csrc/fused_step.cu``) are float32 FFTs. A and B keep each
transform in registers (``csrc/fft_regs.cuh``: 32 values a thread,
radix-32 Stockham stages, one exchange through shared memory between two
stages), so their products read the transmission and the Fresnel plane at
natural elements; C runs radix-16 passes in shared memory and folds the
bit reversal of its forward into its store. The wave stays in its natural
order, complex64 interleaved, at every kernel boundary. This replaces the
TPU kernels' digit-permuted order and split re/im planes, which were
limits of Pallas on the TPU. A and B update the wave in place (the first A
writes a new buffer, so the caller's probes are never overwritten).
``reg_tile_plan`` sizes their tiles; ``last_launch["a"]`` and ``["b"]``
hold each one's last plan and grid.

Each of ``row_pass``, ``col_pass`` and ``kconvert`` takes its plain
``torch.fft`` version for a tensor on the CPU, and for a CUDA tensor
launches its kernel or raises. ``launches`` counts the kernel launches.

Sizes: power-of-two axes from 128 to 4096 (``supported_size``). Every
other axis the JAX kernels take (the n1*128 sizes that are not powers of
two, and odd composite grids) goes to the mixed-radix kernels of
``ops.fused_step_odd`` and ``ops.fused_step_odd_resident`` through
``physics.propagate``'s dispatch.

``build()`` compiles every ``csrc/*.cu`` (one shared library each, all
``nvcc`` processes started together) under one content hash of the
sources and headers.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

from ..core.dtypes import SINGLE, as_real

# Launches of each kernel since the last reset (the wrappers add one per
# launch; nothing else touches them): A, B, C here, K4 and K5 in
# ops.fused_step_odd, K6 in ops.fused_step_resident, K7 and K8 in
# ops.fused_step_adjoint, the time FFT in analysis.time_fft. "k4", "k5" and
# "k8" count every K4, K5 and K8 launch, "k4_regs", "k5_regs" and "k8_regs"
# those of them on the register engine. "time_fft_plain" is no launch: it
# counts the CUDA blocks that analysis.tacaw's rule sent to the plain
# torch.fft chain.
launches = {"a": 0, "b": 0, "c": 0, "k4": 0, "k4_regs": 0, "k5": 0,
            "k5_regs": 0, "k6": 0, "k7": 0, "k8": 0, "k8_regs": 0,
            "time_fft": 0, "time_fft_plain": 0}

# Above this many bytes for the (nz, nx, ny) complex64 transmission stack,
# kernel A takes sigma*V and evaluates cos/sin itself: half the memory, at
# the cost of the transcendentals once per probe (as in the JAX package).
PRECOMPUTE_T_MAX_BYTES = 2 << 30

ROW_MODES = {"first": 0, "mid": 1, "last": 2, "only": 3}

_CSRC = Path(__file__).parent / "csrc"
SOURCES = ("fused_step", "fused_step_odd", "resident", "fused_step_adjoint",
           "fused_step_adjoint_odd", "time_fft")
_BUILD_DIR = Path(__file__).parent / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def supported_size(n: int) -> bool:
    """Axis lengths the CUDA kernels take: powers of two, 128..4096."""
    return 128 <= n <= 4096 and n & (n - 1) == 0


# --- build and bind ----------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Build:
    libs: dict          # source stem -> ctypes.CDLL
    paths: dict         # source stem -> shared library path
    seconds: float      # compile + load time of this process's build()
    log: str            # nvcc's output (-Xptxas -v resource usage), kept
                        # beside each library and read back when cached


_build = None


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME")
    candidates = [Path(cuda_home) / "bin" / "nvcc"] if cuda_home else []
    found = shutil.which("nvcc")
    if found:
        candidates.append(Path(found))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _sources_digest() -> str:
    h = hashlib.sha256()
    for f in sorted(_CSRC.glob("*.cu*")):
        h.update(f.name.encode() + b"\0" + f.read_bytes())
    return h.hexdigest()[:16]


def build() -> Build:
    """Compile every ``csrc/<stem>.cu`` of ``SOURCES`` with nvcc for sm_90a
    (once per content hash, into ``ops/build/``, nvcc's output beside each
    library as ``<stem>_<hash>.ptxas.txt``; one nvcc process per source, all
    started together) and load them. Raises if nvcc fails."""
    global _build
    if _build is not None:
        return _build
    t0 = time.perf_counter()
    digest = _sources_digest()
    paths = {stem: _BUILD_DIR / f"{stem}_{digest}.so" for stem in SOURCES}
    todo = {stem: so for stem, so in paths.items() if not so.exists()}
    logs = {stem: so.with_suffix(".ptxas.txt") for stem, so in paths.items()}
    if todo:
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        procs = {}
        for stem, so in todo.items():
            tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
            procs[stem] = (tmp, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(_CSRC / f"{stem}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        outs = {stem: p.communicate()[0] for stem, (_, p) in procs.items()}
        failed = [stem for stem, (_, p) in procs.items() if p.returncode != 0]
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(
                f"{stem}.cu (exit {procs[stem][1].returncode}):\n{outs[stem]}"
                for stem in failed))
        for stem, (tmp, _) in procs.items():
            logs[stem].write_text(outs[stem])
            os.replace(tmp, todo[stem])
    log = "".join(f"--- {stem}.cu\n{logs[stem].read_text()}"
                  for stem in SOURCES if logs[stem].exists())
    libs = {stem: _bind(ctypes.CDLL(str(so))) for stem, so in paths.items()}
    _build = Build(libs=libs, paths=paths, seconds=time.perf_counter() - t0,
                   log=log)
    return _build


_ARGTYPES = {
    "fs_row_pass": "pppppiiiiipp",
    "fs_col_pass": "ppppiiiipp",
    "fs_kconvert": "pppiiip",
    "fs_row_pass_mr": "pppppiiiiiipp",
    "fs_row_pass_mr_reg": "pppppiiiiiipp",
    "fs_col_pass_mr": "ppppiiiiipp",
    "fs_col_pass_mr_reg": "ppppiiiiipp",
    "fs_resident_loop": "ppppppppiiiiiiiiiipp",
    "fs_resident_barriers": "iiiip",
    "fs_row_pass_bwd": "ppppppiiiifipp",
    "fs_row_pass_bwd_mr": "ppppppiiiifiiipp",
    "fs_row_pass_bwd_mr_reg": "ppppppiiiifiipp",
    "tf_time_fft": "pppiiiillllipp",
}


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the argument and result types of the C functions the
    library exports ('p' a pointer, 'i' an int, 'l' a long long, 'f' a
    float)."""
    kinds = {"p": ctypes.c_void_p, "i": ctypes.c_int,
             "l": ctypes.c_longlong, "f": ctypes.c_float}
    for name, sig in _ARGTYPES.items():
        fn = getattr(lib, name, None)
        if fn is not None:
            fn.argtypes = [kinds[k] for k in sig]
            fn.restype = ctypes.c_int
    return lib


_twiddle_cache = {}


def _twiddles(n: int, device: torch.device, full: bool = False
              ) -> torch.Tensor:
    """exp(-2 pi i m / n) for m < n/2 (the pow2 engine) or, with ``full``,
    m < n (the mixed-radix engine); computed in float64, stored
    complex64."""
    key = (n, device, full)
    if key not in _twiddle_cache:
        m = np.arange(n if full else n // 2)
        w = np.exp(-2j * np.pi * m / n).astype(np.complex64)
        _twiddle_cache[key] = torch.from_numpy(w).to(device)
    return _twiddle_cache[key]


def _check_cuda(x: torch.Tensor, name: str, shape, dtype,
                device=None) -> None:
    # A lazily conjugated or negated view keeps its data unconjugated and
    # only sets a bit; a kernel reading data_ptr() would miss it.
    if x.is_conj() or x.is_neg():
        raise ValueError(f"{name} is a lazily conjugated or negated view: "
                         "pass torch.conj_physical(...) or resolve it first "
                         "(.resolve_conj() / .resolve_neg())")
    if not x.is_cuda or (device is not None and x.device != device):
        raise ValueError(f"{name} must be a CUDA tensor on "
                         f"{device or 'the card'}, got {x.device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, "
                         f"got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_state(state: torch.Tensor, supported=None,
                 sizes: str = "powers of two from 128 to 4096") -> None:
    """A CUDA complex64 (probes, nx, ny) wave whose axes ``supported``
    (default: ``supported_size``) takes; raises otherwise."""
    if state.device.type != "cuda":
        raise ValueError(f"fused_step kernels need a CUDA or CPU tensor, "
                         f"got {state.device}")
    if state.dim() != 3:
        raise ValueError(f"state must be (probes, nx, ny), got "
                         f"{tuple(state.shape)}")
    n_probes, nx, ny = state.shape
    supported = supported or supported_size
    if not (supported(nx) and supported(ny)):
        raise ValueError(f"unsupported grid {nx}x{ny} for the CUDA kernels "
                         f"({sizes})")
    if not 1 <= n_probes <= 65535:
        raise ValueError(f"probe count {n_probes} outside [1, 65535]")
    _check_cuda(state, "state", state.shape, torch.complex64)


def _out_for(state: torch.Tensor, out) -> torch.Tensor:
    if out is None:
        return torch.empty_like(state)
    _check_cuda(out, "out", state.shape, torch.complex64, state.device)
    return out


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")


# --- the tile plans of A and B --------------------------------------------------

# A's and B's tiles (csrc/fft_regs.cuh): a thread holds REG_VALUES values of
# one transform in registers, so a transform of n takes n / REG_VALUES
# threads and a tile 2^logc of them side by side (A: rows, B: columns), at
# most REG_MAX_LOGC. The kernels' launch bounds (csrc/fused_step.cu),
# threads and blocks an SM: B 512 and 1 (so a thread may take 128
# registers, and the tile is as wide as 512 threads allow: wider row
# segments measured faster); A in its transform modes 128 and 3 (168 registers: its
# transforms beside the product's loads need no spills); A `only`, which
# takes few registers, 256 and 1. SMEM_SM: an SM's shared memory (228 KB),
# less 1 KB the runtime keeps for each block.
REG_VALUES = 32
REG_MAX_LOGC = 5
COL_BOUND = (512, 1)
ROW_BOUND = (128, 3)
ONLY_BOUND = (256, 1)
SMEM_SM = 233472
SMEM_BLOCK_RESERVED = 1024


@dataclasses.dataclass(frozen=True)
class RegPlan:
    logc: int           # 2^logc lanes a tile: columns (B) or rows (A)
    threads: int        # a block: n / REG_VALUES threads a lane
    smem_bytes: int     # the tile buffer, padded (none for A `only`), and
                        # A's phase factor slots
    tiles: int          # (probe, tile) pairs the persistent grid walks
    stages: tuple       # the radices of a transform

    @property
    def lanes(self) -> int:
        return 1 << self.logc


def reg_stages(n: int) -> tuple:
    """The stages of a transform of n (``reg_geo`` of csrc/fft_regs.cuh):
    radix 32 while it divides, then the rest."""
    f, m = [], n
    while m >= REG_VALUES:
        f.append(REG_VALUES)
        m //= REG_VALUES
    if m > 1:
        f.append(m)
    return tuple(f)


def reg_smem(n: int, logc: int, factors: bool = False) -> int:
    """Shared memory of a block: the tile buffer, 2^logc lanes of n with
    one pad slot every 32 elements, and with ``factors`` (A's phase form)
    REG_VALUES factor slots a thread."""
    slots = REG_VALUES * (n // REG_VALUES << logc) if factors else 0
    return 8 * (((n + n // 32) << logc) + slots)


def reg_tile_plan(n: int, n_probes: int, lanes: int, bound=COL_BOUND,
                  factors: bool = False, transform: bool = True) -> RegPlan:
    """The tile of A or B on transforms of length n (A: ny, B: nx), for
    n_probes x ``lanes`` of them (A: nx rows, B: ny columns), both powers
    of two from 128 to 4096, under a kernel's launch ``bound`` (threads,
    blocks an SM): as many lanes as fill its threads (at most
    2^REG_MAX_LOGC and ``lanes``), fewer where its blocks would not fit an
    SM's shared memory. B at 1024: 16 lanes of 32 threads and a
    135,168-byte tile buffer, one block an SM; A: 4 lanes, 33,792 bytes,
    three blocks.
    Without ``transform`` (A `only`) the block takes no shared memory."""
    threads, blocks = bound
    per = n // REG_VALUES
    logc = min(REG_MAX_LOGC, max(0, (threads // per).bit_length() - 1),
               lanes.bit_length() - 1)
    smem = (lambda c: reg_smem(n, c, factors) if transform else 0)
    while logc > 0 and blocks * (smem(logc) + SMEM_BLOCK_RESERVED) > SMEM_SM:
        logc -= 1
    return RegPlan(logc=logc, threads=per << logc, smem_bytes=smem(logc),
                   tiles=n_probes * (lanes >> logc), stages=reg_stages(n))


# K7's tiles (csrc/fused_step_adjoint.cu): rows of the pair stream, both
# members of each, on the same engine; lane 2r + c is member c of row r.
# Its launch bound, threads and blocks an SM: 384 and 1 (A's 168 registers
# a thread, blocks of up to 384 threads). PAIR_TILE_THREADS: the block a
# tile fills where one row's two members take fewer threads (at 1024: 2
# rows, three blocks an SM). PAIR_VBAR_SLOTS: the float32 vbar
# accumulators a thread keeps in shared memory.
PAIR_BOUND = (384, 1)
PAIR_TILE_THREADS = 128
PAIR_VBAR_SLOTS = REG_VALUES // 2


def pair_reg_plan(n: int, rows: int, factors: bool = True,
                  sms: int = 132) -> RegPlan:
    """K7's tile on the (2 pairs, rows, n) pair stream (n = ny, rows = nx,
    both powers of two from 128 to 4096): 2^logr rows a block, each row's
    two members on n / REG_VALUES threads apiece, as many rows as fill
    PAIR_TILE_THREADS (one row above 2048: 256 threads), at most ``rows``;
    fewer, down to one warp a block, while there would be fewer tiles than
    the card's ``sms`` (128^2: 4 rows of 32 threads, 32 tiles, not 8 of 16
    rows). ``logc`` = logr + 1 counts the lanes, member-rows. Shared
    memory: the tile buffer of the lanes, with ``factors`` (mid mode) the
    rows' transmission factors, one complex64 an element, and the threads'
    vbar slots. ``tiles`` is the row tiles the persistent grid walks, each
    through every pair in order."""
    per = n // REG_VALUES
    logr = min(max(0, (PAIR_TILE_THREADS // (2 * per)).bit_length() - 1),
               rows.bit_length() - 1)
    while logr > 0 and rows >> logr < sms and 2 * per << logr > 32:
        logr -= 1
    threads = 2 * per << logr
    smem = (reg_smem(n, logr + 1) + (8 * (n << logr) if factors else 0)
            + 4 * PAIR_VBAR_SLOTS * threads)
    return RegPlan(logc=logr + 1, threads=threads, smem_bytes=smem,
                   tiles=rows >> logr, stages=reg_stages(n))


# The last launch of each persistent kernel (A, B here; K4, K5 in
# ops.fused_step_odd; K7, K8 in ops.fused_step_adjoint): its plan and the
# grid the occupancy query gave (grid, blocks_per_sm, sms, smem_bytes);
# and of the time FFT (analysis.time_fft): its plan and grid.
last_launch = {"a": {}, "b": {}, "k4": {}, "k5": {}, "k7": {}, "k8": {},
               "time_fft": {}}


def _record_reg_launch(kernel: str, plan: RegPlan, info) -> None:
    rec = last_launch[kernel]
    rec.clear()
    rec.update(lanes=plan.lanes, threads=plan.threads, tiles=plan.tiles,
               stages=plan.stages)
    rec.update(zip(("grid", "blocks_per_sm", "sms", "smem_bytes"), info))


# --- plain versions ----------------------------------------------------------


def _transmission(t: torch.Tensor) -> torch.Tensor:
    return t if t.is_complex() else torch.complex(torch.cos(t), torch.sin(t))


def _into(res: torch.Tensor, out) -> torch.Tensor:
    return res if out is None else out.copy_(res)


def _plain_row_pass(mode: str, state, t, out=None) -> torch.Tensor:
    """Kernel A's plain version: [IFFT_y] x t [FFT_y] per ``mode``; ``t``
    is the complex plane or the real phase sigma*V."""
    if mode in ("mid", "last"):
        state = torch.fft.ifft(state, dim=-1)
    state = state * _transmission(t)
    if mode in ("first", "mid"):
        state = torch.fft.fft(state, dim=-1)
    return _into(state, out)


def _plain_col_pass(state, prop, out=None) -> torch.Tensor:
    """Kernel B's plain version: IFFT_x(P * FFT_x(state))."""
    return _into(torch.fft.ifft(prop * torch.fft.fft(state, dim=-2), dim=-2),
                 out)


def _plain_kconvert(state) -> torch.Tensor:
    """Kernel C's plain version: fftshift over both axes of FFT_x(state)."""
    return torch.fft.fftshift(torch.fft.fft(state, dim=-2), dim=(-2, -1))


# --- wrappers ------------------------------------------------------------------


def row_pass(mode: str, state: torch.Tensor, t: torch.Tensor,
             out=None) -> torch.Tensor:
    """Kernel A on a (P, nx, ny) complex64 wave. ``t``: the (nx, ny)
    complex64 transmission plane, or the float32 phase sigma*V (cos/sin
    taken in the kernel). ``out`` may be ``state`` itself (in place)."""
    if mode not in ROW_MODES:
        raise ValueError(f"row_pass mode must be one of {list(ROW_MODES)}")
    if state.device.type == "cpu":
        return _plain_row_pass(mode, state, t, out)
    _check_state(state)
    n_probes, nx, ny = state.shape
    phase = not t.is_complex()
    _check_cuda(t, "t", (nx, ny), torch.float32 if phase else torch.complex64,
                state.device)
    out = _out_for(state, out)
    plan = (reg_tile_plan(ny, n_probes, nx, ONLY_BOUND, transform=False)
            if mode == "only" else
            reg_tile_plan(ny, n_probes, nx, ROW_BOUND, factors=phase))
    info = (ctypes.c_int * 4)()
    lib = build().libs["fused_step"]
    with torch.cuda.device(state.device):
        err = lib.fs_row_pass(
            out.data_ptr(), state.data_ptr(),
            None if phase else t.data_ptr(), t.data_ptr() if phase else None,
            _twiddles(ny, state.device).data_ptr(), n_probes, nx, ny,
            ROW_MODES[mode], plan.logc, ctypes.addressof(info),
            torch.cuda.current_stream().cuda_stream)
    _record_reg_launch("a", plan, info)
    _raise_on(err, "row_pass (A)")
    launches["a"] += 1
    return out


def col_pass(state: torch.Tensor, prop: torch.Tensor,
             out=None) -> torch.Tensor:
    """Kernel B: IFFT_x(prop * FFT_x(state)); ``prop`` the natural-order
    (nx, ny) complex64 Fresnel plane. ``out`` may be ``state``."""
    if state.device.type == "cpu":
        return _plain_col_pass(state, prop, out)
    _check_state(state)
    n_probes, nx, ny = state.shape
    _check_cuda(prop, "prop", (nx, ny), torch.complex64, state.device)
    out = _out_for(state, out)
    plan = reg_tile_plan(nx, n_probes, ny)
    info = (ctypes.c_int * 4)()
    lib = build().libs["fused_step"]
    with torch.cuda.device(state.device):
        err = lib.fs_col_pass(
            out.data_ptr(), state.data_ptr(), prop.data_ptr(),
            _twiddles(nx, state.device).data_ptr(), n_probes, nx, ny,
            plan.logc, ctypes.addressof(info),
            torch.cuda.current_stream().cuda_stream)
    _record_reg_launch("b", plan, info)
    _raise_on(err, "col_pass (B)")
    launches["b"] += 1
    return out


def kconvert(state: torch.Tensor) -> torch.Tensor:
    """Kernel C: fftshift over both axes of FFT_x(state), a new tensor."""
    if state.device.type == "cpu":
        return _plain_kconvert(state)
    _check_state(state)
    n_probes, nx, ny = state.shape
    out = torch.empty_like(state)
    lib = build().libs["fused_step"]
    with torch.cuda.device(state.device):
        err = lib.fs_kconvert(
            out.data_ptr(), state.data_ptr(),
            _twiddles(nx, state.device).data_ptr(), n_probes, nx, ny,
            torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "kconvert (C)")
    launches["c"] += 1
    return out


# --- per-frame planes ----------------------------------------------------------


def transmission_stack(sigma: float, potential_szy: torch.Tensor
                       ) -> torch.Tensor:
    """t = exp(i sigma V) for every slice as one (nz, nx, ny) complex64
    stack, computed once per frame and shared by all probes — or, above
    PRECOMPUTE_T_MAX_BYTES, the float32 phase stack sigma*V itself."""
    phase = potential_szy.to(torch.float32) * float(np.float32(sigma))
    if 8 * phase.numel() > PRECOMPUTE_T_MAX_BYTES:
        return phase
    return torch.complex(torch.cos(phase), torch.sin(phase))


def _f32(a, device) -> torch.Tensor:
    return as_real(a, SINGLE, device)


def fresnel_plane(kxs, kys, lam: float, dz: float, ksq=None, kmax2=None,
                  tantilt=None, *, device) -> torch.Tensor:
    """The (nx, ny) complex64 Fresnel multiplier in natural order, with the
    band limit (``kmax2``) and the beam-tilt phase (``tantilt``) folded in,
    in the JAX package's float32 steps (``fresnel_permuted_t``).
    ``ksq`` (oblique cells) replaces kx^2 + ky^2."""
    if ksq is not None:
        if tantilt is not None:
            raise ValueError("beam tilt needs an orthogonal cell")
        k2 = _f32(ksq, device)
        pp = (-np.pi * lam * dz) * k2
    else:
        kx = _f32(kxs, device)[:, None]
        ky = _f32(kys, device)[None, :]
        k2 = kx ** 2 + ky ** 2
        pp = (-np.pi * lam * dz) * k2
        if tantilt is not None:
            pp = pp + (2.0 * np.pi * dz) * (kx * tantilt[0]
                                            + ky * tantilt[1])
    cosp, sinp = torch.cos(pp), torch.sin(pp)
    if kmax2 is not None:
        m = (k2 <= kmax2).to(torch.float32)
        cosp, sinp = cosp * m, sinp * m
    return torch.complex(cosp, sinp)


# --- the slice chain -----------------------------------------------------------


def _chain(passes, psi, potential_szy, kxs, kys, sigma, lam, dz, ksq,
           kmax2, tantilt, kspace: bool) -> torch.Tensor:
    """The slice loop as A/B(/C) passes; ``passes`` is (row, col, kconv),
    the wrappers or the plain versions. Skip-last-propagation: no B after
    the last transmission; in k space the last A runs as ``mid`` (its
    FFT_y is the conversion's y transform)."""
    row, col, kconv = passes
    n_probes, nx, ny = psi.shape
    nz = potential_szy.shape[0]
    psi = psi.to(torch.complex64).contiguous()
    t = transmission_stack(sigma, potential_szy)
    prop = fresnel_plane(kxs, kys, lam, dz, ksq, kmax2, tantilt,
                         device=psi.device)
    if nz == 1 and not kspace:
        return row("only", psi, t[0])
    state = row("first", psi, t[0])
    for s in range(1, nz - 1):
        state = col(state, prop, state)
        state = row("mid", state, t[s], state)
    if nz > 1:
        state = col(state, prop, state)
        state = row("mid" if kspace else "last", state, t[nz - 1], state)
    return kconv(state) if kspace else state


_KERNEL_PASSES = (row_pass, col_pass, kconvert)
_PLAIN_PASSES = (_plain_row_pass, _plain_col_pass, _plain_kconvert)


def record_layers_chain(fn, psi, potential_szy, kxs, kys, sigma, lam, dz,
                        ksq, record_layers, kmax2=None, tantilt=None):
    """Depth recording by segment chaining: the slice stack splits at each
    recorded layer, ``fn`` runs per segment, and every resumed segment is
    prepended a zero potential slice (t = 1), so its first step is exactly
    the pending Fresnel propagation. Returns (n_layers, n_probes, nx, ny)
    post-transmission snapshots."""
    layers = tuple(int(l) for l in record_layers)
    zero = torch.zeros_like(potential_szy[:1])
    snaps = []
    cur = psi
    z = 0
    for li, layer in enumerate(layers):
        seg = potential_szy[z:layer + 1]
        if li > 0:
            seg = torch.cat([zero, seg], dim=0)
        cur = fn(cur, seg, kxs, kys, sigma=sigma, lam=lam, dz=dz, ksq=ksq,
                 kmax2=kmax2, tantilt=tantilt)
        snaps.append(cur)
        z = layer + 1
    return torch.stack(snaps, dim=0)


def _check_grid(psi) -> None:
    nx, ny = psi.shape[-2:]
    if not (supported_size(nx) and supported_size(ny)):
        raise ValueError(f"unsupported grid {nx}x{ny} for fused path")


def fused_multislice(psi, potential_szy, kxs, kys, *, sigma: float,
                     lam: float, dz: float, record_layers=None, ksq=None,
                     kmax2=None, tantilt=None) -> torch.Tensor:
    """Fused counterpart of ``physics.propagate.multislice``.

    psi: (n_probes, nx, ny) complex64; potential_szy: (nz, nx, ny) real.
    Returns the exit wave, or (n_layers, n_probes, nx, ny) snapshots when
    ``record_layers`` is given.
    """
    if record_layers is not None:
        return record_layers_chain(fused_multislice, psi, potential_szy,
                                   kxs, kys, sigma, lam, dz, ksq,
                                   record_layers, kmax2=kmax2,
                                   tantilt=tantilt)
    _check_grid(psi)
    return _chain(_KERNEL_PASSES, psi, potential_szy, kxs, kys, sigma, lam,
                  dz, ksq, kmax2, tantilt, kspace=False)


def fused_multislice_kspace(psi, potential_szy, kxs, kys, *, sigma: float,
                            lam: float, dz: float, ksq=None, kmax2=None,
                            tantilt=None) -> torch.Tensor:
    """fftshift(fft2(fused_multislice(...))) with the conversion fused into
    the chain: the last A runs as ``mid`` and C adds FFT_x and the shift.
    Returns (n_probes, nx, ny) complex64 k-space exit waves."""
    _check_grid(psi)
    return _chain(_KERNEL_PASSES, psi, potential_szy, kxs, kys, sigma, lam,
                  dz, ksq, kmax2, tantilt, kspace=True)


def fused_multislice_plain(psi, potential_szy, kxs, kys, *, sigma: float,
                           lam: float, dz: float, record_layers=None,
                           ksq=None, kmax2=None, tantilt=None
                           ) -> torch.Tensor:
    """``fused_multislice`` through the plain versions of A and B on any
    device (the reference the kernels are held to)."""
    if record_layers is not None:
        return record_layers_chain(fused_multislice_plain, psi,
                                   potential_szy, kxs, kys, sigma, lam, dz,
                                   ksq, record_layers, kmax2=kmax2,
                                   tantilt=tantilt)
    return _chain(_PLAIN_PASSES, psi, potential_szy, kxs, kys, sigma, lam,
                  dz, ksq, kmax2, tantilt, kspace=False)


def fused_multislice_kspace_plain(psi, potential_szy, kxs, kys, *,
                                  sigma: float, lam: float, dz: float,
                                  ksq=None, kmax2=None, tantilt=None
                                  ) -> torch.Tensor:
    """``fused_multislice_kspace`` through the plain versions of A, B, C."""
    return _chain(_PLAIN_PASSES, psi, potential_szy, kxs, kys, sigma, lam,
                  dz, ksq, kmax2, tantilt, kspace=True)
