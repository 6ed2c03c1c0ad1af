"""Mesh extents for the (frame, probe) parallel axes.

Counterpart of ``pyslice_tpu/parallel/mesh.py``. MD frames and probe
positions are independent until the time-FFT and probe-averaging
reductions, so they are the axes a run spreads over several cards. Only
``factor_mesh`` is ported so far (the ``devices`` command prints its
default mesh); the device mesh itself, the multi-host set-up and
``parallel/sharded.py`` come with multi-GPU runs (ROADMAP queue 1,
item 8).
"""

from __future__ import annotations

from typing import Optional, Tuple

FRAME_AXIS = "frame"
PROBE_AXIS = "probe"


def factor_mesh(n_devices: int, n_frames: Optional[int] = None,
                n_probes: Optional[int] = None) -> Tuple[int, int]:
    """Pick (frame, probe) mesh extents for n_devices.

    Prefers sharding frames (the long axis in production TACAW runs); the
    probe extent only grows when the frame count can't absorb all devices or
    when probes are plentiful and frames are not.
    """
    best = (n_devices, 1)
    for f in range(n_devices, 0, -1):
        if n_devices % f:
            continue
        p = n_devices // f
        if n_frames is not None and n_frames % f:
            continue
        if n_probes is not None and n_probes % p:
            continue
        best = (f, p)
        break
    return best
