"""``parallel.sharded.STATS["all_to_all_s"]`` over the traced window, the
largest over the ranks, a job: the frame-to-kx all_to_all between two
synchronizes."""


def read(r):
    s = r.counters.get("all_to_all_s", 0.0)
    return 1e3 * s / r.steps if s > 0 else None
