"""Tracing and profiling utilities.

Counterpart of ``pyslice_tpu/utils/profiling.py``:

* ``phase(name)`` — nestable wall-clock span timer accumulating into a
  process-global report (``report()`` / ``reset()``).
* ``trace(log_dir)`` — context manager around ``torch.profiler`` (CPU and
  CUDA activities) that writes a Chrome trace into ``log_dir``.
* ``device_timer`` — seconds a call of a thunk: CUDA events around the
  calls, then a synchronize, when the thunk's result lies on a CUDA
  device; the host clock on the CPU.
* ``slice_step_rate`` — probe-frame slice-steps a second for a measured
  propagation time.
"""

from __future__ import annotations

import collections
import contextlib
import time
from pathlib import Path
from typing import Dict

import torch

_SPANS: Dict[str, float] = collections.defaultdict(float)
_COUNTS: Dict[str, int] = collections.defaultdict(int)


@contextlib.contextmanager
def phase(name: str):
    """Accumulating wall-clock span."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _SPANS[name] += time.perf_counter() - t0
        _COUNTS[name] += 1


def report() -> Dict[str, dict]:
    return {k: {"total_s": round(v, 4), "count": _COUNTS[k],
                "mean_s": round(v / max(_COUNTS[k], 1), 4)}
            for k, v in sorted(_SPANS.items())}


def reset() -> None:
    _SPANS.clear()
    _COUNTS.clear()


@contextlib.contextmanager
def trace(log_dir: str = "pyslice_trace"):
    """torch.profiler trace of the block (CPU, and CUDA where a card is
    present), written as ``<log_dir>/trace.json`` (Chrome trace format).
    Yields the profiler, whose ``key_averages()`` sums by operation."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    with prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(out / "trace.json"))


def device_timer(thunk, iters: int = 3, warmup: int = 1) -> float:
    """Seconds per call of ``thunk`` (which returns a tensor or a tuple
    whose first element is one). On a CUDA tensor: CUDA events around the
    ``iters`` calls and a synchronize; on the CPU: the host clock."""
    out = None
    for _ in range(max(warmup, 1)):
        out = thunk()
    first = out[0] if isinstance(out, (tuple, list)) else out
    if isinstance(first, torch.Tensor) and first.is_cuda:
        torch.cuda.synchronize(first.device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            thunk()
        end.record()
        end.synchronize()
        return 1e-3 * start.elapsed_time(end) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        thunk()
    return (time.perf_counter() - t0) / iters


def slice_step_rate(seconds_per_frame: float, n_probes: int, nz: int) -> float:
    """Probe-frame slice-steps a second."""
    return n_probes * nz / seconds_per_frame
