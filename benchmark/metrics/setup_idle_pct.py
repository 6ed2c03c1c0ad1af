"""Device idle of the traced window (no Python tracer) while the main thread
was in ``setup`` or ``setup.*``, as a share of the window, averaged over
the cards: the job's host set-up with nothing queued on the device."""

import program_spans


def read(r):
    if r.busy_s <= 0:
        return None
    return program_spans.setup_idle_pct(program_spans.of_readings(r))
