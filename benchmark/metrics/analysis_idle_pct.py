"""Device idle of the traced window while the main thread was in
``analysis.*`` or ``collective.*``, as a share of the window, averaged
over the cards: the analysis's read-backs and waits."""

import program_spans


def read(r):
    if r.busy_s <= 0:
        return None
    return program_spans.analysis_idle_pct(program_spans.of_readings(r))
