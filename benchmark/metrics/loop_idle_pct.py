"""Device idle of the traced window while the main thread was in the frame
loop (``run``, ``rasterize``, ``slice_loop`` and theirs), as a share of
the window, averaged over the cards: the host's dispatch trailing the
device."""

import program_spans


def read(r):
    if r.busy_s <= 0:
        return None
    return program_spans.loop_idle_pct(program_spans.of_readings(r))
