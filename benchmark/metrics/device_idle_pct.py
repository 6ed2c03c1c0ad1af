"""Share of the traced window (no Python tracer) with no kernel, copy or
memset on the device, averaged over the cards of the cell."""


def read(r):
    if r.busy_s <= 0 or r.window_s <= 0:
        return None
    return 100.0 * (1.0 - r.busy_s / r.window_s)
