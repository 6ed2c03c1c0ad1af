"""Tracing: named spans on the profiler's clock.

Counterpart of ``pyslice_tpu/utils/profiling.py``, whose host-clock
``phase`` store the spans replace.

* ``span(name)`` — a context manager around one piece of the program's
  work. While a ``torch.profiler`` records it is
  ``torch.profiler.record_function("pyslice." + name)``: the span lands in
  the profiler's trace, on the same clock as the kernels, copies and
  memsets launched inside it, so each device operation can be followed to
  the innermost span that launched it. Otherwise it is one shared no-op
  context, and the span costs one check of the profiler's state: no clock
  is read and nothing is allocated. Entered with ``as``, it gives the
  profiler's range while one records and None otherwise, for work that
  only a traced run should do.
* ``trace(log_dir)`` — records the block with ``torch.profiler`` (CPU,
  and CUDA where a card is present), which turns the spans on, and writes
  ``<log_dir>/trace.json`` (Chrome trace format).

The spans, nested as the calls nest (``pyslice.`` + the name):

    setup, setup.plan, setup.probe     MultisliceCalculator.setup; make_plan
    run                                MultisliceCalculator.run (the frame loop)
    rasterize                          one frame's potential
    slice_loop                         the slice kernels and the k-space step
    slice_loop.kspace                  the k-space step where it is a launch
                                       of its own (kernel C; the odd and
                                       plain loops' fftshift(fft2))
    stream.block, stream.fold,         the streaming engines' feeds, their
    stream.readout                     folds and read-outs
    analysis.time_fft, analysis.reduce, TACAWData's time FFT and reductions;
    analysis.adf                       HAADFData.calculateADF
    collective.all_to_all,             the collectives of parallel.sharded
    collective.all_reduce,
    collective.all_gather
    msp.setup, msp.step,               msp_reconstruct: the ingest and the
    msp.forward, msp.backward,         state; each Adam step, its shift
    msp.update                         through the misfit, its gradients,
                                       its update
    adjoint                            multislice_diff's backward (on
                                       autograd's thread on the card)

Device time a span: ``trace`` yields the profiler, whose
``key_averages()`` has a row per span name (``pyslice.*``) with the device
time of what ran inside it.
"""

from __future__ import annotations

import contextlib
from pathlib import Path

import torch

_OFF = contextlib.nullcontext()


def span(name: str):
    """``record_function("pyslice." + name)`` while a profiler records,
    else the shared no-op context."""
    if not torch._C._autograd._profiler_enabled():
        return _OFF
    return torch.profiler.record_function("pyslice." + name)


@contextlib.contextmanager
def trace(log_dir: str = "pyslice_trace"):
    """torch.profiler trace of the block (CPU, and CUDA where a card is
    present), written as ``<log_dir>/trace.json`` (Chrome trace format).
    Yields the profiler, whose ``key_averages()`` sums by operation and by
    span."""
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
