"""Device idle of the traced window while the main thread was in no
program span, as a share of the window, averaged over the cards: the
program's code that opens none (``Trajectory``, the calculator's
constructor) and the benchmark's own work. In a job cell it and the
three other idle readers (``setup_idle_pct``, ``loop_idle_pct``,
``analysis_idle_pct``) partition ``device_idle_pct``."""

import program_spans


def read(r):
    if r.busy_s <= 0:
        return None
    return program_spans.unspanned_idle_pct(program_spans.of_readings(r))
