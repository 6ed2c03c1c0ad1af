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

The kernels (``csrc/fused_step.cu``) are FFTs in shared memory, in float32,
run as radix-16 passes in registers. The wave stays in its natural order,
complex64 interleaved, at every kernel boundary; inside a kernel the
forward transform leaves bit-reversed order and the inverse consumes it,
so the Fresnel plane is read at bit-reversed rows and never permuted in
memory. This replaces the TPU kernels' digit-permuted order and split
re/im planes, which were limits of Pallas on the TPU. A and B update the
wave in place (the first A writes a new buffer, so the caller's probes are
never overwritten).

Each of ``row_pass``, ``col_pass`` and ``kconvert`` takes its plain
``torch.fft`` version for a tensor on the CPU, and for a CUDA tensor
launches its kernel or raises. ``launches`` counts the kernel launches.

Sizes: power-of-two axes from 128 to 4096 (``supported_size``). The
n1*128 non-power-of-two sizes the JAX kernels take, and odd grids, go to
the plain path through ``physics.propagate``'s dispatch.
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
# launch; nothing else touches them).
launches = {"a": 0, "b": 0, "c": 0}

# Above this many bytes for the (nz, nx, ny) complex64 transmission stack,
# kernel A takes sigma*V and evaluates cos/sin itself: half the memory, at
# the cost of the transcendentals once per probe (as in the JAX package).
PRECOMPUTE_T_MAX_BYTES = 2 << 30

ROW_MODES = {"first": 0, "mid": 1, "last": 2, "only": 3}

_SRC = Path(__file__).parent / "csrc" / "fused_step.cu"
_BUILD_DIR = Path(__file__).parent / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def supported_size(n: int) -> bool:
    """Axis lengths the CUDA kernels take: powers of two, 128..4096."""
    return 128 <= n <= 4096 and n & (n - 1) == 0


# --- build and bind ----------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Build:
    lib: ctypes.CDLL
    path: Path
    seconds: float      # compile + load time of this process's build()
    log: str            # nvcc's output (-Xptxas -v resource usage)


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


def build() -> Build:
    """Compile ``csrc/fused_step.cu`` with nvcc for sm_90a (once per source
    version, into ``ops/build/``) and load it. Raises if nvcc fails."""
    global _build
    if _build is not None:
        return _build
    t0 = time.perf_counter()
    digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    so = _BUILD_DIR / f"fused_step_{digest}.so"
    log = ""
    if not so.exists():
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                               str(_SRC)], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed (exit {proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        log = proc.stdout + proc.stderr
        os.replace(tmp, so)
    _build = Build(lib=_bind(ctypes.CDLL(str(so))), path=so,
                   seconds=time.perf_counter() - t0, log=log)
    return _build


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface's argument and result types."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.fs_row_pass.argtypes = [p, p, p, p, p, i, i, i, i, p]
    lib.fs_col_pass.argtypes = [p, p, p, p, i, i, i, p]
    lib.fs_kconvert.argtypes = [p, p, p, i, i, i, p]
    for fn in (lib.fs_row_pass, lib.fs_col_pass, lib.fs_kconvert):
        fn.restype = i
    return lib


_twiddle_cache = {}


def _twiddles(n: int, device: torch.device) -> torch.Tensor:
    """exp(-2 pi i m / n), m < n/2, computed in float64, stored complex64."""
    key = (n, device)
    if key not in _twiddle_cache:
        w = np.exp(-2j * np.pi * np.arange(n // 2) / n).astype(np.complex64)
        _twiddle_cache[key] = torch.from_numpy(w).to(device)
    return _twiddle_cache[key]


def _check_cuda(x: torch.Tensor, name: str, shape, dtype,
                device=None) -> None:
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


def _check_state(state: torch.Tensor) -> None:
    if state.device.type != "cuda":
        raise ValueError(f"fused_step kernels need a CUDA or CPU tensor, "
                         f"got {state.device}")
    if state.dim() != 3:
        raise ValueError(f"state must be (probes, nx, ny), got "
                         f"{tuple(state.shape)}")
    n_probes, nx, ny = state.shape
    if not (supported_size(nx) and supported_size(ny)):
        raise ValueError(f"unsupported grid {nx}x{ny} for the CUDA kernels "
                         "(powers of two from 128 to 4096)")
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
    lib = build().lib
    with torch.cuda.device(state.device):
        err = lib.fs_row_pass(
            out.data_ptr(), state.data_ptr(),
            None if phase else t.data_ptr(), t.data_ptr() if phase else None,
            _twiddles(ny, state.device).data_ptr(), n_probes, nx, ny,
            ROW_MODES[mode], torch.cuda.current_stream().cuda_stream)
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
    lib = build().lib
    with torch.cuda.device(state.device):
        err = lib.fs_col_pass(
            out.data_ptr(), state.data_ptr(), prop.data_ptr(),
            _twiddles(nx, state.device).data_ptr(), n_probes, nx, ny,
            torch.cuda.current_stream().cuda_stream)
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
    lib = build().lib
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
